"""Scaling harness: edges/s of the node-sharded train step at 1..N ranks, the
port of ``sgformer_tpu/parallel/scaling.py``.

    python -m sgformer_tpu_torch.parallel.scaling --devices 1 2 4 \\
        --nodes 100000 --edges 800000 [--halo] [--reorder] [--platform cpu]

For each device count it spawns one group of that many ranks
(:func:`.launch.run_group`): one card each under NCCL (more ranks than cards
are refused), or CPU ranks under gloo with ``--platform cpu``. Each rank
builds the same synthetic graph (128 features, 16 classes, seed 0) and the
model ``SGFormerConfig.large(hidden, 16, axis_name="sp")``, and times 10
steps after one. It prints one JSON line per count with the JAX harness's
keys, then the scaling efficiency of each count against the first. A
scaling number needs as many cards as ranks: on one card only
``--devices 1`` measures anything.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch


def _measure_rank(rank: int, n_devices: int, num_nodes: int, num_edges: int, hidden: int,
                  steps: int, powerlaw: float, use_halo: bool, reorder: bool,
                  out_path: str) -> None:
    from sgformer_tpu_torch.data import synthetic_dataset
    from sgformer_tpu_torch.graph import preprocess_graph
    from sgformer_tpu_torch.nn import SGFormer, SGFormerConfig
    from sgformer_tpu_torch.parallel import ShardedTrainer, make_mesh
    from sgformer_tpu_torch.train import TrainConfig

    mesh = make_mesh("sp")
    dev = mesh.device
    ds = synthetic_dataset(num_nodes=num_nodes, num_edges=num_edges, num_features=128,
                           num_classes=16, seed=0, powerlaw=powerlaw, device="cpu")
    graph = preprocess_graph(ds.graph["edge_index"], num_nodes, reorder=reorder, device=dev)
    model = SGFormer(SGFormerConfig.large(hidden, 16, axis_name="sp"), 128, device=dev)
    trainer = ShardedTrainer(model, graph, ds.graph["node_feat"], ds.label,
                             TrainConfig(lr=1e-3, trans_weight_decay=0.0, gnn_weight_decay=0.0),
                             mesh=mesh, use_halo=use_halo)
    trainer.init_state(0)
    mask = trainer.prepare_train_idx({"train": np.arange(0, num_nodes, 2)})

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    trainer.train_step(mask)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        trainer.train_step(mask)
    sync()
    dt = (time.perf_counter() - t0) / steps
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump({
                "devices": n_devices,
                "step_ms": round(dt * 1e3, 2),
                "edges_per_sec": round(graph.num_edges / dt, 1),
                "edges_per_sec_per_device": round(graph.num_edges / dt / n_devices, 1),
            }, f)


def measure(n_devices: int, num_nodes: int, num_edges: int, hidden: int, steps: int = 10,
            powerlaw: float = 0.0, use_halo: bool = False, reorder: bool = False,
            device: str = "cuda") -> dict:
    """One group of ``n_devices`` ranks on ``device`` ("cuda": one card a
    rank, NCCL; "cpu": gloo); returns rank 0's numbers."""
    from sgformer_tpu_torch.parallel.launch import run_group

    if device == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"{n_devices} ranks need {n_devices} cards under NCCL, this host has "
                         f"{torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.json")
        run_group(_measure_rank, n_devices, n_devices, num_nodes, num_edges, hidden, steps,
                  powerlaw, use_halo, reorder, out, device=device)
        with open(out) as f:
            return json.load(f)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--devices", type=int, nargs="+", default=[1])
    p.add_argument("--nodes", type=int, default=100_000)
    p.add_argument("--edges", type=int, default=800_000)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--platform", type=str, default=None,
                   help="'cpu': CPU ranks under gloo; default the cards (NCCL)")
    p.add_argument("--powerlaw", type=float, default=0.0)
    p.add_argument("--halo", action="store_true")
    p.add_argument("--reorder", action="store_true")
    args = p.parse_args(argv)
    device = "cpu" if args.platform == "cpu" else "cuda"
    results = []
    for n in args.devices:
        r = measure(n, args.nodes, args.edges, args.hidden, powerlaw=args.powerlaw,
                    use_halo=args.halo, reorder=args.reorder, device=device)
        results.append(r)
        print(json.dumps(r), flush=True)
    if len(results) > 1:
        base = results[0]["edges_per_sec_per_device"]
        for r in results[1:]:
            eff = r["edges_per_sec_per_device"] / base
            print(json.dumps({"devices": r["devices"], "scaling_efficiency": round(eff, 3)}))
    return results


if __name__ == "__main__":
    main()
