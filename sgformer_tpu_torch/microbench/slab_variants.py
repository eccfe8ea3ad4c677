"""Where the CSR SpMM's time goes: the port of
``scripts/microbench_slab_variants.py``.

The TPU probe isolates the slab kernel's per-step cost with three variants
of its body (``make_variant(mode)``, called at the script's line 145):
``prod`` (the production kernel), ``static_sub`` (every chunk reads the
first ``block_rows`` rows of the slab: wrong results, timing only) and
``no_src_matmul`` (no source selector matmul). On the card the same question
is how much of ``csr_spmm``'s time is the source gather and how much the
row walk. :func:`slab_variant` runs ``csr_spmm``'s own row walk of the whole
warp (``csrc/spmm_walk.cuh``, which ``csrc/spmm.cu`` runs; the probe's entry
is ``slab_variant_kernel`` in ``csrc/microbench.cu``, at ``csr_spmm``'s
launch bounds) on x [N, F] bf16 with an f32 result, as the TPU variants
write, in the graph's walk order where it is given (``Graph.schedule``, as
``csr_spmm`` walks), else in node order; the result is the same bit for bit
in either:

- ``prod``: ``out[i] = sum_e w_e * x[src_e]``, ``A_norm @ x``, bitwise
  ``csr_spmm`` of x (bf16 to f32 is exact) on a graph without hub rows
  (none above ``kernels.spmm.HUB_EDGES`` in-edges, as on the arxiv graph)
  wherever ``csr_spmm`` walks a row with the whole warp (F > 128, as at the
  model's F = 256; narrower rows it takes in lane groups, which add the
  same products in another order). The probe walks every row with one
  warp, so on a graph with hub rows, which ``csr_spmm`` cuts into segments,
  prod is held to its plain version and not to ``csr_spmm``;
- ``static_sub``: ``out[i] = sum_e w_e * x[src_e % 128]``, 128 the TPU's
  block_rows: the gather hits 128 rows that stay cached;
- ``no_src_matmul``: ``out[i] = sum_e (1.0001 * w_e) * x[i]``: no gather, the
  row walk alone.

On the card, on the arxiv-shaped graph, each mode in the walk order and in
node order beside ``csr_spmm`` in the same order:

    python -m sgformer_tpu_torch.microbench.slab_variants
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from sgformer_tpu_torch import kernels
from sgformer_tpu_torch.kernels import _build, spmm
from sgformer_tpu_torch.utils import measure

MODES = ("prod", "static_sub", "no_src_matmul")
BLOCK_ROWS = 128  # the TPU plan's block_rows, static_sub's source window
F = 256
# kernel against plain, as a share of the largest magnitude: f32 sums of at
# most a few tens of terms in another order, and no_src_matmul's fused
# multiply-add against the plain product and add
REL_TOL = 1e-5


def slab_variant_plain(x: torch.Tensor, edge_src: torch.Tensor, edge_dst: torch.Tensor,
                       weight: torch.Tensor, mode: str) -> torch.Tensor:
    """The three formulas in plain PyTorch, f32 [N, F]."""
    src, dst = edge_src.long(), edge_dst.long()
    xf = x.float()
    w = weight.float()
    if mode == "prod":
        msgs = xf.index_select(0, src) * w[:, None]
    elif mode == "static_sub":
        msgs = xf.index_select(0, src % BLOCK_ROWS) * w[:, None]
    elif mode == "no_src_matmul":
        msgs = xf.index_select(0, dst) * (w * 1.0001)[:, None]
    else:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return torch.zeros(x.shape, dtype=torch.float32, device=x.device).index_add_(0, dst, msgs)


def slab_variant(x: torch.Tensor, indptr: torch.Tensor, edge_src: torch.Tensor,
                 edge_dst: torch.Tensor, weight: torch.Tensor, mode: str,
                 schedule: torch.Tensor | None = None) -> torch.Tensor:
    """One mode of the row kernel on the dst-sorted CSR (indptr [N+1],
    edge_src and edge_dst [E] int32, weight [E] float32). x: [N, F] bfloat16
    (F % 8 == 0 on the card); returns [N, F] float32. ``schedule``: the CSR's
    walk order (``Graph.schedule``), checked as ``csr_spmm`` checks it, or
    None for node order; the result is the same bit for bit. ``edge_dst``
    is read only by the plain version, ``schedule`` only by the kernel."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    spmm._check_schedule(schedule, indptr)
    n = indptr.shape[0] - 1
    if x.dim() != 2 or x.shape[0] != n or x.dtype != torch.bfloat16:
        raise TypeError(f"x must be [{n}, F] bfloat16, got {tuple(x.shape)} {x.dtype}")
    if mode == "static_sub" and n < BLOCK_ROWS:
        raise ValueError(f"static_sub reads the first {BLOCK_ROWS} rows: N must reach it")
    if len({t.device for t in (x, indptr, edge_src, edge_dst, weight)}) != 1:
        raise ValueError("all inputs must be on one device")
    if x.device.type == "cpu":
        return slab_variant_plain(x, edge_src, edge_dst, weight, mode)
    for name, t, dt in (("indptr", indptr, torch.int32), ("edge_src", edge_src, torch.int32),
                        ("weight", weight, torch.float32)):
        if t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous 1-d {dt} tensor")
    f = x.shape[1]
    x = x.contiguous()
    if f % 8 or x.data_ptr() % 16:
        raise ValueError("the kernel takes F % 8 == 0 and 16-byte aligned rows")
    out = torch.empty(n, f, dtype=torch.float32, device=x.device)
    if n and f:
        err = _build.library("microbench").sgf_slab_variant(
            indptr.data_ptr(), edge_src.data_ptr(), weight.data_ptr(), x.data_ptr(),
            out.data_ptr(), n, f, MODES.index(mode),
            schedule.data_ptr() if schedule is not None else None,
            torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(err, "slab_variant")
        kernels.probe_launches["slab_variant"] += 1
    return out


def make_x(num_nodes: int, device, f: int = F, seed: int = 0) -> torch.Tensor:
    """x [N, f] bf16 from ``default_rng(seed).standard_normal``, as the
    script draws it."""
    x = np.random.default_rng(seed).standard_normal((num_nodes, f))
    return torch.from_numpy(x).to(device=device, dtype=torch.bfloat16)


def run(graph, x: torch.Tensor, iters: int = 20, walk: bool = True) -> dict:
    """Time each mode and its plain version on ``graph``'s CSR, in the
    graph's walk order (``walk``, node order where the graph has none) or in
    node order; per mode ms, ns an edge and the bound (prod: x read once,
    the f32 result written once, the CSR arrays read once; static_sub reads
    128 rows of x; no_src reads x once)."""
    csr = (graph.indptr, graph.edge_src, graph.edge_dst, graph.gcn_weight)
    schedule = graph.schedule if walk else None
    n, e, f = graph.num_nodes, graph.num_edges, x.shape[1]
    out = {}
    for mode in MODES:
        ms = measure.time_ms(lambda: slab_variant(x, *csr, mode, schedule), iters)
        plain_ms = measure.time_ms(
            lambda: slab_variant_plain(x, graph.edge_src, graph.edge_dst, graph.gcn_weight,
                                       mode), iters)
        rows_read = BLOCK_ROWS if mode == "static_sub" else n
        nbytes = rows_read * f * 2 + n * f * 4 + e * 8 + (n + 1) * 4
        b_ms, b_by = measure.bound_ms(nbytes, 2 * e * f)
        out[mode] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         ns_per_edge=ms / e * 1e6)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("slab_variants: CUDA is not available; this probe needs a GPU", file=sys.stderr)
        return 1
    from sgformer_tpu_torch import preprocess_graph
    from sgformer_tpu_torch.data import synthetic_dataset
    from sgformer_tpu_torch.kernels.spmm import csr_spmm

    print(measure.card_line(), flush=True)
    ds = synthetic_dataset("synth-arxiv", seed=0)
    graph = preprocess_graph(ds.graph["edge_index"], ds.num_nodes)
    x = make_x(graph.num_nodes, "cuda")
    csr = (graph.indptr, graph.edge_src, graph.edge_dst, graph.gcn_weight)
    plan = (graph.hub_segments, graph.hub_edges)
    for mode in MODES:
        got = slab_variant(x, *csr, mode, graph.schedule)
        err, scale = measure.rel_err(got, slab_variant_plain(
            x, graph.edge_src, graph.edge_dst, graph.gcn_weight, mode))
        print(f"{mode} vs plain: max |diff| {err:.3e} (largest magnitude {scale:.3e})")
        if err > REL_TOL * scale:
            print(f"{mode} disagrees with its plain version", file=sys.stderr)
            return 1
        if not torch.equal(got, slab_variant(x, *csr, mode)):
            print(f"{mode} differs between the walk order and node order", file=sys.stderr)
            return 1
        if mode == "prod" and not torch.equal(got, csr_spmm(x.float(), *csr, *plan)):
            print("prod is not bitwise csr_spmm", file=sys.stderr)
            return 1
    spmm_ms = {}
    for order, walk in (("walk order", True), ("node order", False)):
        results = run(graph, x, walk=walk)
        spmm_ms[order] = measure.time_ms(lambda: csr_spmm(
            x, *csr, *plan, schedule=graph.schedule if walk else None))
        for mode, r in results.items():
            print(f"{order} {mode}: {r['ms']:7.4f} ms ({r['ns_per_edge']:.4f} ns/edge; plain "
                  f"{r['plain_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms by {r['bound_by']})",
                  flush=True)
        print(f"{order} csr_spmm bf16 (bf16 result): {spmm_ms[order]:7.4f} ms; gather share "
              f"of prod {1 - results['no_src_matmul']['ms'] / results['prod']['ms']:.3f}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
