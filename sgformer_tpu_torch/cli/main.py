"""CLI entry point: the port of ``sgformer_tpu/cli/main.py``, the reference's
three ``main*.py`` scripts in one trainer-mode switch:

    python -m sgformer_tpu_torch.cli.main --dataset ogbn-arxiv --method sgformer \\
        --trainer full --hidden_channels 256 --epochs 1000

Trainer modes: ``full`` (full-graph, ``train.Trainer``), ``sharded``
(full-graph on node shards, ``parallel.ShardedTrainer``), ``batch``
(random-partition mini-batches, ``main-batch.py``'s loop) and ``sampled``
(neighbour-sampled, ``nb-sample.py``'s loop); ``--time_test`` times the
full-graph and sharded trainers. Training runs on ``--device`` (default
``cuda``: the CLI raises without a card; ``--device cpu`` runs every
kernel's plain version). :func:`build` does the set-up (dataset, splits,
graph, model, trainer) and :func:`main` runs it.

``--trainer sharded`` runs one process per card, each holding one
contiguous block of nodes:

    torchrun --nproc_per_node S -m sgformer_tpu_torch.cli.main --trainer sharded \
        [--use_halo] ...

(NCCL; a process started without ``torchrun`` is a group of one). Every rank
reads the dataset and builds the graph; only rank 0 prints and writes
results. The JAX CLI runs one process over all its devices instead.
``--use_halo`` exchanges only the boundary rows of the GCN edges.

The flags are the JAX CLI's. How the ones that name the TPU's layout map
onto the card:

- ``--use_pallas``, ``--spmm_mode``, ``--hub_rows`` (the slab geometry) and
  ``--attention_impl`` are accepted and ignored, with one printed note: the
  port's CSR and attention kernels run on the card whatever they say, and
  its hub plans split long rows themselves. The recipes thus run unchanged.
- ``--chunk_dtype``: the port's ``chunk_dtype`` is the type of GAT's
  per-edge-value messages. The JAX CLI never builds the chunk plans that
  GAT reads that type from (``with_chunks=--use_pallas`` without
  ``chunk_perm``), so its GAT sends f32 messages on every run, and the port
  passes ``'f32'``; ``'bf16'`` only where the int8 aggregation needs it.
- ``--slab_int8`` and ``--slab_dtype int8`` give ``slab_dtype='int8'`` (with
  ``chunk_dtype='bf16'``) to the full-graph trainer's graph;
  ``--slab_dtype bf16`` and ``auto`` give ``'compute'``. The JAX package's
  ``auto`` may choose int8 by its VMEM policy; the card has no such policy,
  so ``auto`` never does here. With ``--use_pallas`` the JAX graph's
  fixed-weight aggregation also sends ``--chunk_dtype`` messages; the
  port's keeps x's type.
- ``--sampler_workers N`` samples the sampled trainer's batches in N
  threads through the C++ sampler, as in the JAX CLI; the batches and
  losses are those of 0 workers.

NodeFormer's adjacency powers (``build_nodeformer_graphs``) and
Graphormer's inputs (``graphormer_inputs`` of the features' ``x > 0``) are
built from the dataset's edges as the JAX CLI builds them, and placed on
the device once.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

from sgformer_tpu_torch.cli.parse import parse_method, parser_add_main_args
from sgformer_tpu_torch.data import load_dataset
from sgformer_tpu_torch.data.splits import class_rand_splits
from sgformer_tpu_torch.device import resolve_device
from sgformer_tpu_torch.graph import (
    Graph,
    add_self_loops,
    build_h2_graphs,
    preprocess_graph,
    remove_self_loops,
    to_undirected,
)
from sgformer_tpu_torch.nn import build_nodeformer_graphs, graphormer_inputs, inputs_to
from sgformer_tpu_torch.parallel import ShardedTrainer, init_distributed
from sgformer_tpu_torch.train import (
    BatchTrainConfig,
    BatchTrainer,
    SampledTrainConfig,
    SampledTrainer,
    TrainConfig,
    Trainer,
    time_test,
)

# Datasets the reference keeps directed (large/main.py:74-76 skips
# to_undirected for deezer-europe/ogbn-proteins; directed heterophily sets)
DIRECTED = {"deezer-europe", "ogbn-proteins", "arxiv-year", "snap-patents"}
BCE_DATASETS = {"deezer-europe", "ogbn-proteins", "twitch-e", "fb100", "yelp-chi"}


def get_splits(ds, args) -> list:
    rng = np.random.default_rng(args.seed)
    if args.rand_split_class:
        return [
            class_rand_splits(
                ds.label, args.label_num_per_class,
                valid_num=args.valid_num, test_num=args.test_num, rng=rng,
            )
            for _ in range(args.runs)
        ]
    if args.rand_split or ds.load_fixed_splits is None:
        return [
            ds.get_idx_split("random", train_prop=args.train_prop,
                             valid_prop=args.valid_prop, rng=rng)
            for _ in range(args.runs)
        ]
    # fixed splits: rotate through the committed masks per run (the
    # geom-gcn/heterophilous 10-mask protocol, large/main.py:107-112)
    try:
        return [ds.load_fixed_splits(i) for i in range(args.runs)]
    except TypeError:
        splits = ds.load_fixed_splits()
        return splits if isinstance(splits, list) else [splits]


def layout_note(args) -> Optional[str]:
    """The one note on the TPU layout flags this run set, or None."""
    ignored = []
    if args.use_pallas:
        ignored.append("--use_pallas")
    if args.spmm_mode != "chunks":
        ignored.append(f"--spmm_mode {args.spmm_mode}")
    if args.hub_rows:
        ignored.append(f"--hub_rows {args.hub_rows}")
    if args.attention_impl != "auto":
        ignored.append(f"--attention_impl {args.attention_impl}")
    if args.slab_dtype in ("auto", "bf16") and not args.slab_int8:
        ignored.append(f"--slab_dtype {args.slab_dtype} (runs 'compute': no VMEM policy "
                       "on the card)")
    if not ignored:
        return None
    return ("sgformer_tpu_torch: TPU layout flags ignored on the card: " + ", ".join(ignored)
            + "; the CSR and attention kernels run whatever they say")


def graph_types(args) -> dict:
    """``chunk_dtype`` and ``slab_dtype`` of the full-graph trainer's graph
    (the module's docstring says why)."""
    if args.slab_int8 or args.slab_dtype == "int8":
        return dict(chunk_dtype="bf16", slab_dtype="int8")
    return dict(chunk_dtype="f32", slab_dtype="compute")


def trainer_edges(edge_index: np.ndarray, num_nodes: int, undirected: bool,
                  device: torch.device) -> torch.Tensor:
    """The edge list the batch and sampled trainers take: symmetrised (when
    ``undirected``), self-loops replaced, on ``device``."""
    e = torch.from_numpy(np.asarray(edge_index)).to(device)
    if undirected:
        e = to_undirected(e)
    return add_self_loops(remove_self_loops(e), num_nodes)


@dataclasses.dataclass
class Built:
    """What :func:`build` set up: the dataset (its node features on the
    host), the splits, the graph (the full graph of the ``full`` and
    ``batch`` trainers; None for ``sampled``), the edge list the ``batch``
    and ``sampled`` trainers take (None for ``full``), the model and the
    trainer."""

    ds: object
    splits: list
    graph: Optional[Graph]
    edges: Optional[torch.Tensor]
    model: torch.nn.Module
    trainer: object


def build(args) -> Built:
    # a sharded rank joins its group first, so that "cuda" is its own card
    dev = (init_distributed(args.device) if args.trainer == "sharded"
           else resolve_device(args.device))
    note = layout_note(args)
    if note:
        print(note, file=sys.stderr)

    # the features stay on the host through the host transforms; the
    # full-graph and batch trainers move them to the device, the sampled
    # trainer keeps them on the host and ships each batch's rows
    ds = load_dataset(args.data_dir, args.dataset, args.sub_dataset, device="cpu")
    if args.dataset in ("cora", "citeseer", "pubmed") and not args.no_feat_norm:
        from sgformer_tpu_torch.data.transforms import normalize_features

        feat = normalize_features(ds.graph["node_feat"].numpy())
        ds.graph["node_feat"] = torch.from_numpy(feat)
    n = ds.num_nodes
    c = ds.num_classes
    x = ds.graph["node_feat"]
    d = x.shape[1]
    undirected = not (args.no_undirected or args.dataset in DIRECTED)
    loss = "bce" if args.dataset in BCE_DATASETS else "nll"
    metric = (
        "rocauc"
        if args.dataset in ("ogbn-proteins", "twitch-e", "yelp-chi")
        and args.metric == "acc"
        else args.metric
    )

    model = parse_method(args, n, c, d)
    splits = get_splits(ds, args)
    ours = args.method in ("sgformer", "ours")
    common = dict(
        lr=args.lr,
        trans_weight_decay=args.trans_weight_decay if ours else args.weight_decay,
        gnn_weight_decay=args.gnn_weight_decay if ours else args.weight_decay,
        epochs=args.epochs,
        eval_step=args.eval_step,
        patience=args.patience,
        metric=metric,
        mode=args.model_selection,
        loss=loss,
        runs=args.runs,
        seed=args.seed,
        display_step=args.display_step,
    )
    needs_pyg = (args.method in ("gcn", "gcnjk", "graphtrans", "graphgps")
                 or (ours and args.backbone == "gcn"))
    edge_index = ds.graph["edge_index"]
    edges = graph = None

    if args.trainer == "sharded":
        graph = preprocess_graph(edge_index, n, undirected=undirected, with_pyg_norm=needs_pyg,
                                 device=dev, **graph_types(args))
        trainer = ShardedTrainer(model, graph, x, ds.label, TrainConfig(**common),
                                 use_halo=args.use_halo, device=dev)
    elif args.trainer == "full":
        common["lamda"] = args.lamda
        graph = preprocess_graph(edge_index, n, undirected=undirected, with_pyg_norm=needs_pyg,
                                 device=dev, **graph_types(args))
        model_kwargs = {}
        if args.method == "h2gcn":
            model_kwargs["h2_graphs"] = build_h2_graphs(edge_index, n, device=dev)
        elif args.method == "nodeformer":
            model_kwargs["adjs"] = build_nodeformer_graphs(edge_index, n, rb_order=2,
                                                           device=dev)
        elif args.method == "graphormer":
            atoms = (x > 0).numpy().astype(np.int64)
            model_kwargs["inputs"] = inputs_to(graphormer_inputs(edge_index, atoms, n), dev)
        trainer = Trainer(model, graph, x, ds.label, TrainConfig(**common),
                          model_kwargs=model_kwargs, device=dev)
    elif args.trainer == "batch":
        edges = trainer_edges(edge_index, n, undirected, dev)
        graph = preprocess_graph(edge_index, n, undirected=undirected, with_pyg_norm=needs_pyg,
                                 device=dev)
        trainer = BatchTrainer(
            model, edges, x, ds.label,
            BatchTrainConfig(**common, batch_size=args.batch_size),
            full_graph=graph, with_pyg_norm=needs_pyg, device=dev,
        )
    else:
        edges = trainer_edges(edge_index, n, undirected, dev)
        trainer = SampledTrainer(
            model, edges, x, ds.label,
            SampledTrainConfig(
                **common,
                batch_size=args.batch_size,
                fanouts=tuple(args.fanouts),
                save_model=args.save_model,
                use_pretrained=args.use_pretrained,
                model_dir=args.model_dir,
                eval_train=args.eval_train,
                transfer_dtype=args.transfer_dtype,
                sampler_workers=args.sampler_workers,
            ),
            device=dev,
        )
    return Built(ds, splits, graph, edges, model, trainer)


def main(argv=None):
    parser = argparse.ArgumentParser("sgformer-tpu-torch")
    parser_add_main_args(parser)
    args = parser.parse_args(argv)
    if args.time_test and args.trainer not in ("full", "sharded"):
        raise ValueError("--time_test times the full-graph trainers: pass --trainer full or "
                         "sharded")
    if args.save_attn and args.trainer == "sharded":
        raise ValueError("--save_attn: the attention maps are the whole graph's, which no "
                         "rank of --trainer sharded holds")
    built = build(args)
    trainer = built.trainer
    # in a node-sharded group only rank 0 prints and writes
    writes = getattr(trainer, "writes_logs", True)

    if args.time_test:
        # medium/time_test.py semantics: timed epochs, fwd latency, memory
        res = time_test(trainer, built.splits[0], epochs=args.epochs, trace_dir=args.trace_dir)
        if writes:
            print(json.dumps(res.as_dict()))
        return res

    logger = trainer.fit(built.splits)
    stats = logger.print_statistics() if writes else None

    if args.save_attn:
        # materialised [L, N, N] maps (SGFormer.get_attentions); O(N^2), so
        # small graphs only
        if not hasattr(trainer.model, "get_attentions"):
            raise ValueError(f"--save_attn: --method {args.method} has no attention maps")
        trainer.model.eval()
        with torch.no_grad():
            attn = trainer.model.get_attentions(trainer.x.to(next(trainer.model.parameters())
                                                             .device))
        os.makedirs(args.attn_dir, exist_ok=True)
        attn_path = os.path.join(args.attn_dir, f"{args.dataset}_{args.method}_attn.npy")
        np.save(attn_path, attn.float().cpu().numpy())
        print(f"attention maps -> {attn_path}")

    if args.save_result and stats:
        os.makedirs(args.result_dir, exist_ok=True)
        name = f"{args.dataset}_{args.method}"
        if args.method in ("sgformer", "ours"):
            name += f"_{args.backbone}"
        path = os.path.join(args.result_dir, name + ".txt")
        with open(path, "a") as f:
            mean, std = stats["final_test"]
            f.write(
                f"runs={args.runs} lr={args.lr} hidden={args.hidden_channels} "
                f"epochs={args.epochs} test_acc={mean:.2f}±{std:.2f}\n"
            )
    return logger


if __name__ == "__main__":
    main()
