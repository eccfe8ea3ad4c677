"""Host-side neighbour sampler of the sampled tier: the port of
``sgformer_tpu/sample/neighbor.py`` (the role of PyG's ``NeighborLoader`` in
the SGFormer reference's ``100M/nb-sample.py``, fanouts [15, 10, 5]).

What it computes, as the JAX package's numpy path (``_sample_numpy``) does,
draw for draw from the same numpy generator:

- layer-wise expansion from the seeds: each frontier node takes
  ``min(deg, fanout)`` in-neighbours, all of them where ``deg <= fanout``,
  else ``fanout`` offsets drawn with replacement as ``rng.random(total) *
  deg`` and deduplicated (``np.unique`` of the (dst, src) pairs);
- the next frontier is the sources not yet visited (``np.setdiff1d``); the
  batch's nodes are the seeds first, then each hop's new nodes in order;
- sampled edges run child -> parent, relabelled to the nodes' places in the
  batch; one self-loop is added on every node, and the edges are stably
  sorted by destination.

Where it differs, and why. The JAX sampler pads every batch to static
caps (``node_cap``, ``edge_cap``) so that one compiled XLA step serves the
epoch, and the caps also truncate: a batch that reaches ``node_cap`` stops
expanding and drops the edges to the nodes beyond it (its default cap, 160
seeds' worth of nodes, truncates papers100M-sized batches). The reference's
``NeighborLoader`` does not truncate, and PyTorch on the card compiles no
shapes, so this sampler has no caps, no padding and no node mask: each batch
has its real size. The JAX sampler also computes the GCN weights on the host;
here the trainer computes them on the card
(:func:`sgformer_tpu_torch.train.sampled_trainer.build_sampled_graph`). Its
C++ sampler (``use_native``) draws from another seed stream and is not
ported; nor is ``epoch(workers > 0)``: off the C++ path, the JAX ``sample``
ignores its per-batch seed, so its threads would share one generator.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Sequence

import numpy as np
import torch

from sgformer_tpu_torch.graph import check_int32_counts


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """In-neighbour CSR on the host (dst -> its in-neighbours), int64."""

    indptr: np.ndarray  # [N+1] int64
    indices: np.ndarray  # [E] int64, the source of each in-edge

    @classmethod
    def from_edge_index(cls, edge_index, num_nodes: int) -> "CSRGraph":
        """The CSR of a [2, E] (src, dst) edge list: the edges stably sorted
        by destination. ``edge_index`` is a numpy array or a tensor, sorted
        on its own device (the card's, for a tensor there) and copied to the
        host."""
        if not isinstance(edge_index, torch.Tensor):
            edge_index = torch.from_numpy(np.asarray(edge_index))
        src, dst = edge_index.long()
        order = torch.sort(dst, stable=True).indices
        indptr = torch.zeros(num_nodes + 1, dtype=torch.int64, device=dst.device)
        torch.cumsum(torch.bincount(dst, minlength=num_nodes), 0, out=indptr[1:])
        return cls(indptr=indptr.cpu().numpy(), indices=src[order].cpu().numpy())

    @property
    def num_nodes(self) -> int:
        return len(self.indptr) - 1


@dataclasses.dataclass
class SampledBatch:
    """One sampled subgraph at its real size; the seeds are rows
    ``[0, num_seeds)``."""

    node_ids: np.ndarray  # [num_nodes] int64 global ids
    edge_src: np.ndarray  # [E] int32 local, sorted by edge_dst
    edge_dst: np.ndarray  # [E] int32 local, non-decreasing
    num_seeds: int
    num_nodes: int


def _sample_neighbors(csr: CSRGraph, frontier: np.ndarray, fanout: int,
                      rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """For each frontier node ``min(deg, fanout)`` in-neighbours: all of them
    where ``deg <= fanout``, else ``fanout`` offsets drawn with replacement
    (the caller deduplicates). One ``rng.random`` draw covers every taken
    slot, those of the take-all nodes too. Returns (src, dst) global ids."""
    # the JAX function draws its C++ sampler's seed first, whether or not
    # that sampler runs; the same draw keeps the floats below in step
    rng.integers(2 ** 62)
    deg = csr.indptr[frontier + 1] - csr.indptr[frontier]
    k = np.minimum(deg, fanout)
    total = int(k.sum())
    if total == 0:
        return (np.empty(0, dtype=np.int64),) * 2
    rep_node = np.repeat(frontier, k)
    rep_start = np.repeat(csr.indptr[frontier], k)
    rep_deg = np.repeat(deg, k)
    enum = np.arange(total) - np.repeat(np.cumsum(k) - k, k)
    rand = (rng.random(total) * rep_deg).astype(np.int64)
    offset = np.where(np.repeat(deg <= fanout, k), enum, rand)
    return csr.indices[rep_start + offset], rep_node


class NeighborSampler:
    """Layer-wise neighbour sampling over ``graph`` (a [2, E] edge list,
    numpy or a tensor, or a prebuilt :class:`CSRGraph`), ``batch_size``
    seeds a batch, draws from ``rng`` (``np.random.default_rng(seed)``)."""

    def __init__(self, graph, num_nodes: int, fanouts: Sequence[int] = (15, 10, 5),
                 batch_size: int = 1000, *, seed: int = 0):
        if isinstance(graph, CSRGraph):
            if graph.num_nodes != num_nodes:
                raise ValueError(f"the CSR has {graph.num_nodes} nodes, not {num_nodes}")
            self.csr = graph
        else:
            self.csr = CSRGraph.from_edge_index(graph, num_nodes)
        self.fanouts = list(fanouts)
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)

    def sample(self, seeds) -> SampledBatch:
        """The batch of ``seeds`` (global ids, distinct)."""
        seeds = np.asarray(seeds, dtype=np.int64)
        n_all = self.csr.num_nodes
        all_src, all_dst = [], []
        nodes = frontier = seeds
        for fanout in self.fanouts:
            src, dst = _sample_neighbors(self.csr, frontier, fanout, self.rng)
            if len(src) == 0:
                break
            _, uniq = np.unique(dst * n_all + src, return_index=True)
            src, dst = src[uniq], dst[uniq]
            all_src.append(src)
            all_dst.append(dst)
            frontier = np.setdiff1d(src, nodes)
            nodes = np.concatenate([nodes, frontier])
        n = len(nodes)
        if all_src:
            # every end is a node of the batch: relabel by a sorted lookup
            sorter = np.argsort(nodes)
            sorted_ids = nodes[sorter]
            src = sorter[np.searchsorted(sorted_ids, np.concatenate(all_src))]
            dst = sorter[np.searchsorted(sorted_ids, np.concatenate(all_dst))]
        else:
            src = dst = np.empty(0, dtype=np.int64)
        # a self-loop on every node (the reference adds them to the whole
        # graph, nb-sample.py:80), then the stable sort by destination
        loop = np.arange(n, dtype=np.int64)
        src = np.concatenate([src, loop])
        dst = np.concatenate([dst, loop])
        order = np.argsort(dst, kind="stable")
        check_int32_counts(n, len(src))
        return SampledBatch(node_ids=nodes, edge_src=src[order].astype(np.int32),
                            edge_dst=dst[order].astype(np.int32), num_seeds=len(seeds),
                            num_nodes=n)

    def epoch(self, seed_pool, shuffle: bool = True, workers: int = 0) -> Iterator[SampledBatch]:
        """The batches of ``seed_pool`` (permuted first when ``shuffle``), in
        order, the remainder batch too (the reference's ``NeighborLoader``
        has no ``drop_last``; the JAX option of that name has no caller and
        is not ported). Batches are sampled one after the other: ``workers >
        0`` is refused."""
        if workers > 0:
            raise ValueError(
                "workers > 0 is not ported: batches are sampled in order from one numpy "
                "generator, which threads cannot share")
        pool = np.asarray(seed_pool)
        if shuffle:
            pool = pool[self.rng.permutation(len(pool))]
        for i in range(0, len(pool), self.batch_size):
            yield self.sample(pool[i:i + self.batch_size])


class _ProducerError:
    """An exception of the prefetch thread, re-raised to the consumer."""

    def __init__(self, error: BaseException):
        self.error = error


class PrefetchIterator:
    """Runs ``iterator`` in a background thread ahead of the consumer, at
    most ``depth`` items queued: the host samples batch k+1 while the card
    runs batch k. The producer's exceptions are re-raised by ``__next__``;
    :meth:`close` (or leaving a ``with`` block) stops the producer early."""

    def __init__(self, iterator, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._fill, args=(iterator,), daemon=True)
        self.thread.start()

    def _fill(self, iterator) -> None:
        try:
            for item in iterator:
                if self._stop.is_set():
                    return
                self.q.put(item)
        except BaseException as e:  # noqa: BLE001 - handed to the consumer
            # without this an error of the host side (an unservable batch)
            # would end the epoch early as a StopIteration
            self.q.put(_ProducerError(e))
        finally:
            self.q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is self._done:
            self.q.put(item)  # later calls stop too
            raise StopIteration
        if isinstance(item, _ProducerError):
            raise item.error
        return item

    def close(self) -> None:
        """Stop the producer after its current item and wait for it."""
        self._stop.set()
        while self.thread.is_alive():
            try:
                self.q.get(timeout=0.1)
            except queue.Empty:
                pass
        self.thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()
