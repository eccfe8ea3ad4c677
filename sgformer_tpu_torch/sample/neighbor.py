"""Host-side neighbour sampler of the sampled tier: the port of
``sgformer_tpu/sample/neighbor.py`` (the role of PyG's ``NeighborLoader`` in
the SGFormer reference's ``100M/nb-sample.py``, fanouts [15, 10, 5]).

Two paths, as in the JAX package, with the same default:

- **the C++ sampler** (``use_native=True``, the default): one
  GIL-releasing call a batch (:func:`sgformer_tpu_torch.native.
  sample_batch_native`, the port's copy of the JAX package's
  ``csrc/graph_kernels.cpp::sample_batch``), bit for bit the JAX batch of
  the same seed. Each frontier node takes ``min(deg, fanout)`` distinct
  in-neighbours (Floyd's draws from a per-batch xorshift seed, the fanout
  clamped at 64); nodes are numbered as first met, seeds first; a self-loop
  on every node; the edges stably sorted by destination with their f32 GCN
  weights (``SampledBatch.edge_weight``). Each batch's seed is one
  ``rng.integers(2**62)`` draw, so ``epoch(workers > 0)`` draws every
  batch's seed first and samples in a thread pool, batches delivered in
  order and bitwise those of ``workers=0``.
- **the hop path** (``use_native=False``), the JAX package's
  ``_sample_numpy`` loop: each hop samples through the C++ hop sampler
  (:func:`sgformer_tpu_torch.native.sample_neighbors_native`, the port's
  copy of the JAX package's ``sample_neighbors``, seeded with one
  ``rng.integers(2**62)`` draw a hop), the sampled edges are deduplicated,
  the next frontier is the sources not yet visited (``np.setdiff1d``); the
  trainer computes the GCN weights on the card. Its batches are bitwise the
  JAX sampler's with its C++ library loaded (which its hop sampler calls
  even with ``use_native=False``). ``_sample_neighbors_plain`` is the plain
  version of a hop, the JAX numpy body draw for draw. One generator draws
  every batch, so ``workers > 0`` is refused on this path.

Where it differs, and why. The JAX sampler pads every batch to static caps
(``node_cap``, ``edge_cap``) so that one compiled XLA step serves the epoch,
and the caps also truncate (its default cap, 160 seeds' worth of nodes,
truncates papers100M-sized batches). PyTorch on the card compiles no shapes,
so batches here have their real size and no node mask; the C++ path sizes
its buffers from the worst case (:func:`worst_case_caps`), so nothing
truncates, and a truncated batch would raise. Where the JAX sampler finds
no library it quietly samples with numpy; here a failed build raises.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from sgformer_tpu_torch.graph import check_int32_counts
from sgformer_tpu_torch.native.api import sample_batch_native, sample_neighbors_native

# the C++ sampler takes at most this many in-neighbours a node and hop
FANOUT_LIMIT = 64


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
    # [E] f32 GCN weights from the C++ full-batch sampler; None on the hop
    # path, whose weights the trainer computes on its device
    edge_weight: Optional[np.ndarray] = None


def worst_case_caps(num_seeds: int, fanouts: Sequence[int], num_nodes: int) -> tuple[int, int]:
    """Node and edge caps that no batch of ``num_seeds`` seeds can reach
    on the C++ path: hop h expands at most ``num_seeds * f_1 ... f_(h-1)``
    frontier nodes by ``f_h`` each (each fanout clamped to [0, 64]), and
    the batch holds at most ``num_nodes`` nodes, every frontier node among
    them once; one self-loop a node. Returns (node_cap, edge_cap)."""
    fan = [min(max(int(f), 0), FANOUT_LIMIT) for f in fanouts]
    frontier = nodes = num_seeds
    edges = 0
    for f in fan:
        edges += frontier * f
        frontier *= f
        nodes += frontier
    node_cap = min(nodes, num_nodes)
    return node_cap, min(edges, max(fan, default=0) * node_cap) + node_cap


def _sample_neighbors(csr: CSRGraph, frontier: np.ndarray, fanout: int,
                      rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """One hop: for each frontier node all its in-neighbours where ``deg <=
    fanout``, else ``fanout`` offsets drawn with replacement (the caller
    deduplicates), by the C++ hop sampler seeded with one
    ``rng.integers(2**62)`` draw, as the JAX hop sampler runs whenever its
    library loads. Returns (src, dst) global ids."""
    return sample_neighbors_native(csr.indptr, csr.indices, frontier, fanout,
                                   int(rng.integers(2 ** 62)))


def _sample_neighbors_plain(csr: CSRGraph, frontier: np.ndarray, fanout: int,
                            rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """The plain version of :func:`_sample_neighbors`: the JAX hop
    sampler's numpy body, which it runs where it finds no library, draw for
    draw (the C++ seed's draw, unused, then one ``rng.random`` draw covering
    every taken slot, those of the take-all nodes too). Nothing on the
    sampler's path calls it; the tests hold it to the JAX numpy path."""
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
    seeds a batch, draws from ``rng`` (``np.random.default_rng(seed)``),
    through the C++ sampler unless ``use_native`` is False."""

    def __init__(self, graph, num_nodes: int, fanouts: Sequence[int] = (15, 10, 5),
                 batch_size: int = 1000, *, seed: int = 0, use_native: bool = True):
        if isinstance(graph, CSRGraph):
            if graph.num_nodes != num_nodes:
                raise ValueError(f"the CSR has {graph.num_nodes} nodes, not {num_nodes}")
            self.csr = graph
        else:
            self.csr = CSRGraph.from_edge_index(graph, num_nodes)
        self.fanouts = list(fanouts)
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.use_native = use_native

    def sample(self, seeds, rng_seed: Optional[int] = None) -> SampledBatch:
        """The batch of ``seeds`` (global ids, distinct). On the full-batch
        C++ path its draws come from ``rng_seed``, by default one
        ``rng.integers(2**62)`` draw; the hop path draws from ``rng`` and
        takes no ``rng_seed``."""
        seeds = np.asarray(seeds, dtype=np.int64)
        if self.use_native:
            if rng_seed is None:
                rng_seed = int(self.rng.integers(2 ** 62))
            return self._sample_native(seeds, int(rng_seed))
        if rng_seed is not None:
            raise ValueError("rng_seed seeds the C++ full-batch sampler; the hop path draws "
                             "from the sampler's generator")
        return self._sample_numpy(seeds)

    def _sample_native(self, seeds: np.ndarray, rng_seed: int) -> SampledBatch:
        node_cap, edge_cap = worst_case_caps(len(seeds), self.fanouts, self.csr.num_nodes)
        nodes, src, dst, weight, truncated = sample_batch_native(
            self.csr.indptr, self.csr.indices, seeds, self.fanouts, node_cap, edge_cap, rng_seed)
        if any(truncated):
            raise RuntimeError(f"the C++ sampler truncated a batch of {len(seeds)} seeds at "
                               f"node_cap {node_cap}, edge_cap {edge_cap} (node, edge: "
                               f"{truncated})")
        check_int32_counts(len(nodes), len(src))
        return SampledBatch(node_ids=nodes, edge_src=src, edge_dst=dst, num_seeds=len(seeds),
                            num_nodes=len(nodes), edge_weight=weight)

    def _sample_numpy(self, seeds: np.ndarray) -> SampledBatch:
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
        is not ported).

        ``workers > 0`` (the C++ path only) samples in a pool of that many
        threads: every batch's seed is drawn first, at most ``max(2 *
        workers, 2)`` batches are in flight or waiting, and they are yielded
        in order, bitwise those of ``workers=0``. A worker's exception is
        raised here; closing the iterator early cancels what has not started
        and waits for what has."""
        if workers > 0 and not self.use_native:
            raise ValueError(
                "workers > 0 needs the C++ full-batch sampler: the hop path draws every batch "
                "from one numpy generator, which threads cannot share")
        pool = np.asarray(seed_pool)
        if shuffle:
            pool = pool[self.rng.permutation(len(pool))]
        starts = range(0, len(pool), self.batch_size)
        if workers <= 0:
            for i in starts:
                yield self.sample(pool[i:i + self.batch_size])
            return
        # numpy generators are not thread-safe: each batch's seed is drawn
        # here, in the order workers=0 draws them
        work = iter([(i, int(self.rng.integers(2 ** 62))) for i in starts])
        ex = ThreadPoolExecutor(max_workers=workers)
        futures: deque = deque()

        def submit_next() -> None:
            job = next(work, None)
            if job is not None:
                i, rng_seed = job
                futures.append(ex.submit(self.sample, pool[i:i + self.batch_size], rng_seed))

        try:
            for _ in range(max(2 * workers, 2)):
                submit_next()
            while futures:
                batch = futures.popleft().result()
                submit_next()
                yield batch
        finally:
            ex.shutdown(wait=True, cancel_futures=True)


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
            # a generator stopped early releases what it holds (a sampler's
            # thread pool) in this thread, before close() returns
            close = getattr(iterator, "close", None)
            if close is not None:
                close()
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
