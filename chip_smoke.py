#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sgformer_tpu_torch``) on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and the CUDA toolkit (``nvcc``); it imports nothing of JAX or of the
JAX package. Phases, each failing loudly:

1. the card's name and power limit (``nvidia-smi``);
2. the build of every kernel from ``sgformer_tpu_torch/csrc`` (all ``nvcc``
   runs at once), timed as set-up;
3. each kernel against its plain PyTorch version on the card, at the shapes
   of the serving path (the arxiv-shaped graph, N = 169,343 nodes, width
   256), in bf16 and f32, with its median time beside its bound;
4. the serving path: ``synthetic_dataset("synth-arxiv")``, ``preprocess_graph``
   and the bench model ``SGFormerConfig.large(256, 40, trans_num_layers=1,
   gnn_num_layers=3, graph_weight=0.5, compute_dtype="bf16")`` from a seeded
   generator behind ``Predictor(...).compile()``, answering several requests.
   The launch counts must show every kernel ran on that path; the logits must
   be finite, bitwise repeatable, and agree with the same forward run through
   the plain versions on the card.

The second-to-last line is a JSON object of per-kernel numbers; the last is
``{"ok": true, "device": {...}}``. Exits non-zero, with no result line, when
CUDA is absent or any check fails.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import warnings
from unittest import mock

import torch

T0 = time.perf_counter()

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s; dense FLOP/s
# of the type the inputs have (bf16 on tensor cores, f32 on CUDA cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# tolerances of kernel against plain version on the same inputs:
# f32: the kernels and the plain versions differ only in summation order
# (TF32 is off for the plain products); bf16: only the rounding of the
# output to bf16 may differ, one bf16 ulp is 2^-8 relative
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
# the reduce's f32 sums over N rows, as a share of their largest magnitude
REDUCE_REL_TOL = 1e-5
# serving path against the plain forward, both bf16 (summation order and
# one-ulp bf16 roundings propagate through 3 GCN layers and the head)
LOGITS_ATOL = 5e-2
ARGMAX_AGREEMENT = 0.99
# rounds of the five request kinds on the serving path
REQUEST_ROUNDS = 5

DTYPE_NAME = {torch.bfloat16: "bf16", torch.float32: "f32"}


def log(msg: str) -> None:
    print(f"[chip_smoke +{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def time_ms(fn, iters: int = 20) -> float:
    """Median device time of one call, from CUDA events around each call."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def bound(nbytes: float, ops: float, dtype) -> tuple[float, str]:
    """Least time in ms for the work, and what sets it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(what: str, got, want, rtol: float, atol: float) -> float:
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: kernel output is not finite")
    err = (got - want).abs()
    max_err = err.max().item()
    if not (err <= atol + rtol * want.abs()).all():
        raise AssertionError(f"{what}: max |kernel - plain| = {max_err:.3e} "
                             f"over rtol {rtol} / atol {atol}")
    log(f"{what}: max |kernel - plain| = {max_err:.3e} (rtol {rtol}, atol {atol})")
    return max_err


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def spmm_phase(graph, results: dict, dev: str) -> None:
    from sgformer_tpu_torch.kernels.spmm import csr_spmm
    from sgformer_tpu_torch.ops.spmm import spmm as spmm_plain

    n, e, f = graph.num_nodes, graph.num_edges, 256
    gen = torch.Generator(device=dev).manual_seed(1)
    args = (graph.indptr, graph.edge_src, graph.edge_dst, graph.gcn_weight)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(n, f, generator=gen, device=dev).to(dtype)
        got = csr_spmm(x, *args)
        want = spmm_plain(x, graph.edge_src, graph.edge_dst, graph.gcn_weight, n)
        torch.cuda.synchronize()
        name = DTYPE_NAME[dtype]
        err = check_close(f"csr_spmm {name} F={f}", got, want, **TOL[dtype])
        if not torch.equal(got, csr_spmm(x, *args)):
            raise AssertionError("csr_spmm is not bitwise repeatable")
        ms = time_ms(lambda: csr_spmm(x, *args))
        plain_ms = time_ms(lambda: spmm_plain(
            x, graph.edge_src, graph.edge_dst, graph.gcn_weight, n))
        library_ms = None
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                a = torch.sparse_csr_tensor(graph.indptr, graph.edge_src,
                                            graph.gcn_weight.to(dtype), size=(n, n))
            library_ms = time_ms(lambda: torch.sparse.mm(a, x))
        except RuntimeError as exc:  # the yardstick only; the port never calls it
            log(f"torch.sparse.mm {name}: not available ({str(exc).splitlines()[0]})")
        elt = x.element_size()
        nbytes = 2 * n * f * elt + e * (4 + 4) + (n + 1) * 4
        b_ms, b_by = bound(nbytes, 2 * e * f, dtype)
        log(f"csr_spmm {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
            f"torch.sparse.mm {library_ms} ms, bound {b_ms:.4f} ms by {b_by})")
        results[("csr_spmm", name)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=library_ms)


def attention_phase(n: int, results: dict, dev: str) -> None:
    from sgformer_tpu_torch.kernels import attention as attn
    from sgformer_tpu_torch.ops.attention import linear_attention

    m = d = 256
    gen = torch.Generator(device=dev).manual_seed(2)
    for dtype in (torch.bfloat16, torch.float32):
        name = DTYPE_NAME[dtype]
        qs, ks, vs = (torch.randn(n, 1, m, generator=gen, device=dev).to(dtype)
                      for _ in range(3))
        got = attn.fused_linear_attention(qs, ks, vs)
        want = linear_attention(qs, ks, vs)
        check_close(f"fused_linear_attention {name}", got, want, **TOL[dtype])
        if not torch.equal(got, attn.fused_linear_attention(qs, ks, vs)):
            raise AssertionError("fused_linear_attention is not bitwise repeatable")

        q, k, v = qs[:, 0], ks[:, 0], vs[:, 0]
        kvs, ksum, scal = attn.reduce(q, k, v)
        want_r = attn.reduce_plain(q, k, v, False)
        torch.cuda.synchronize()
        errs = {}
        for part, g_, w_ in zip(("kvs", "ksum", "qsq", "ksq"),
                                (kvs, ksum, scal[0], scal[1]),
                                (want_r[0], want_r[1], want_r[2][0], want_r[2][1])):
            err = (g_ - w_).abs().max().item()
            scale = w_.abs().max().item()
            log(f"reduce {name} {part}: max |kernel - plain| = {err:.3e}, "
                f"{err / scale:.2e} of its largest magnitude {scale:.3e} "
                f"(tolerance {REDUCE_REL_TOL})")
            if not err <= REDUCE_REL_TOL * scale:
                raise AssertionError(f"reduce {name} {part} disagrees with plain")
            errs[part] = err
        red_err = errs["kvs"]

        # apply alone with n = 1 and positive q, k so that the q @ kvs product,
        # not n * v, carries the output (at n = N it is a small correction)
        qp, kp, vp = (torch.rand(n, m, generator=gen, device=dev).to(dtype)
                      for _ in range(3))
        kvs_p, ksum_p, scal_p = attn.reduce_plain(qp, kp, vp, False)
        one = torch.ones((), device=dev)
        got_a = attn.apply(qp, vp, kvs_p, ksum_p, scal_p, one)
        want_a = attn.apply_plain(qp, vp, kvs_p, ksum_p, scal_p, one, False)
        app_err = check_close(f"apply {name} (n = 1)", got_a, want_a, **TOL[dtype])

        n_t = torch.full((), float(n), device=dev)
        r_ms = time_ms(lambda: attn.reduce(q, k, v))
        r_plain = time_ms(lambda: attn.reduce_plain(q, k, v, False))
        a_ms = time_ms(lambda: attn.apply(q, v, kvs, ksum, scal, n_t))
        a_plain = time_ms(lambda: attn.apply_plain(q, v, kvs, ksum, scal, n_t, False))
        elt = q.element_size()
        rb_ms, rb_by = bound(3 * n * m * elt + (m * d + m + 4) * 4,
                             2 * n * m * d + 3 * n * m, dtype)
        ab_ms, ab_by = bound(3 * n * m * elt + (m * d + m + 4) * 4,
                             2 * n * m * d + 2 * n * m + 4 * n * d, dtype)
        log(f"reduce {name}: {r_ms:.4f} ms (plain {r_plain:.4f} ms, bound "
            f"{rb_ms:.4f} ms by {rb_by}); apply {name}: {a_ms:.4f} ms (plain "
            f"{a_plain:.4f} ms, bound {ab_ms:.4f} ms by {ab_by})")
        results[("linear_attention_reduce", name)] = dict(
            max_abs_err=red_err, ms=r_ms, plain_ms=r_plain, bound_ms=rb_ms,
            bound_by=rb_by, library_ms=None)
        results[("linear_attention_apply", name)] = dict(
            max_abs_err=app_err, ms=a_ms, plain_ms=a_plain, bound_ms=ab_ms,
            bound_by=ab_by, library_ms=None)

    # an all-masked group: zero norms must give finite zeros, as the plain
    # (guarded) path does
    qs, ks, vs = (torch.randn(n, 1, m, generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(3))
    mask = torch.zeros(n, device=dev)
    got = attn.fused_linear_attention(qs, ks, vs, node_mask=mask)
    want = linear_attention(qs, ks, vs, node_mask=mask)
    check_close("fused_linear_attention all-masked bf16", got, want,
                **TOL[torch.bfloat16])


def serve_phase(ds, graph, dev: str) -> tuple[dict, int]:
    import numpy as np

    from sgformer_tpu_torch import Predictor, SGFormer, SGFormerConfig
    from sgformer_tpu_torch import kernels
    from sgformer_tpu_torch.kernels import attention as attn_kernel
    from sgformer_tpu_torch.kernels import spmm as spmm_kernel
    from sgformer_tpu_torch.ops.attention import linear_attention
    from sgformer_tpu_torch.ops.spmm import spmm as spmm_plain

    cfg = SGFormerConfig.large(256, 40, trans_num_layers=1, gnn_num_layers=3,
                               graph_weight=0.5, compute_dtype="bf16")
    model = SGFormer(cfg, ds.graph["node_feat"].shape[1],
                     generator=torch.Generator().manual_seed(0), device=dev)
    t = time.perf_counter()
    pred = Predictor(model, graph, ds.graph["node_feat"], device=dev).compile()
    log(f"Predictor.compile: {(time.perf_counter() - t) * 1e3:.1f} ms")

    rng = np.random.default_rng(0)
    n = graph.num_nodes
    requests = [
        ("logits", lambda: pred.logits()),
        ("predict 1 node", lambda: pred.predict(np.array([7]))),
        ("predict 1000 nodes", lambda: pred.predict(rng.choice(n, 1000, replace=False))),
        ("predict all nodes", lambda: pred.predict()),
        ("predict_proba 64 nodes", lambda: pred.predict_proba(rng.choice(n, 64, replace=False))),
    ]
    kernels.reset_launch_counts()
    answers = {what: [] for what, _ in requests}
    times = {what: [] for what, _ in requests}
    for _ in range(REQUEST_ROUNDS):
        for what, fn in requests:
            t = time.perf_counter()
            answers[what].append(fn())
            times[what].append((time.perf_counter() - t) * 1e3)
    counts = kernels.launch_counts()
    forwards = len(requests) * REQUEST_ROUNDS
    log(f"launches over {forwards} forwards: {counts}")
    want = {"csr_spmm": cfg.gnn_num_layers * forwards,
            "linear_attention_reduce": forwards,
            "linear_attention_apply": forwards}
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    for what, ts in times.items():
        log(f"request {what}: median {statistics.median(ts):.3f} ms over {len(ts)} "
            f"(min {min(ts):.3f}, max {max(ts):.3f})")
    every = [t for ts in times.values() for t in ts]
    log(f"median request: {statistics.median(every):.3f} ms over {len(every)} requests")

    logits = answers["logits"][0]
    if logits.shape != (n, cfg.out_channels) or logits.dtype != np.float32:
        raise AssertionError(f"logits {logits.shape} {logits.dtype}")
    if not np.isfinite(logits).all():
        raise AssertionError("logits are not finite")
    if not all(np.array_equal(logits, again) for again in answers["logits"][1:]):
        raise AssertionError("repeated logits() requests differ")
    if not (answers["predict all nodes"][0] == logits.argmax(axis=-1)).all():
        raise AssertionError("predict() disagrees with logits()")
    proba = np.concatenate(answers["predict_proba 64 nodes"])
    if not np.allclose(proba.sum(axis=-1), 1.0, atol=1e-5):
        raise AssertionError("predict_proba rows do not sum to 1")

    def plain_csr(x, indptr, edge_src, edge_dst, weight):
        return spmm_plain(x, edge_src, edge_dst, weight, indptr.shape[0] - 1)

    with mock.patch.object(spmm_kernel, "csr_spmm", plain_csr), \
            mock.patch.object(attn_kernel, "fused_linear_attention", linear_attention):
        ref = pred.logits()
    diff = float(np.abs(logits - ref).max())
    agree = float((logits.argmax(-1) == ref.argmax(-1)).mean())
    log(f"serving vs plain forward on the card: max |diff| {diff:.3e} "
        f"(atol {LOGITS_ATOL}), argmax agreement {agree:.5f} (>= {ARGMAX_AGREEMENT})")
    if diff > LOGITS_ATOL or agree < ARGMAX_AGREEMENT:
        raise AssertionError("serving path disagrees with the plain forward")
    profile_forward(pred)
    return counts, forwards


def profile_forward(pred, forwards: int = 5) -> None:
    """Device time per kernel over a few forwards, and the device's busy
    share of the forward's wall time (torch.profiler, CUPTI)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(forwards):
            pred._forward()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / forwards
    rows = []
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / forwards / 1e3, e.count / forwards, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"profile: forward {wall:.3f} ms wall, device busy {busy:.3f} ms "
        f"({busy / wall:.1%}) over {forwards} forwards")
    for ms, cnt, key in rows[:16]:
        log(f"  {ms:8.4f} ms x{cnt:g}  {key[:100]}")
    x = torch.empty(pred.x.shape[0], 40, device=pred.x.device)
    log(f"copy of [N, 40] f32 logits to the host: "
        f"{time_ms(lambda: x.cpu(), iters=10):.3f} ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    from sgformer_tpu_torch import preprocess_graph
    from sgformer_tpu_torch.data import synthetic_dataset
    from sgformer_tpu_torch.kernels import _build

    t = time.perf_counter()
    reports = _build.build_all()
    log(f"kernel build: {time.perf_counter() - t:.1f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    t = time.perf_counter()
    ds = synthetic_dataset("synth-arxiv", seed=0)
    graph = preprocess_graph(ds.graph["edge_index"], ds.num_nodes)
    log(f"dataset + preprocess_graph: {time.perf_counter() - t:.1f} s "
        f"(N = {graph.num_nodes}, E = {graph.num_edges})")
    if (graph.num_nodes, graph.num_edges) != (169_343, 2_499_039):
        raise AssertionError("unexpected arxiv-shape graph size")

    results: dict = {}
    spmm_phase(graph, results, "cuda")
    attention_phase(graph.num_nodes, results, "cuda")
    counts, forwards = serve_phase(ds, graph, "cuda")

    sources = {
        "csr_spmm": ("sgformer_tpu_torch/csrc/spmm.cu",
                     "sgformer_tpu/kernels/slab_spmm.py:131, sgformer_tpu/kernels/spmm.py:34"),
        "linear_attention_reduce": ("sgformer_tpu_torch/csrc/linear_attention.cu",
                                    "sgformer_tpu/kernels/attention.py:47"),
        "linear_attention_apply": ("sgformer_tpu_torch/csrc/linear_attention.cu",
                                   "sgformer_tpu/kernels/attention.py:76"),
    }
    line = {"kernels": []}
    for name, (source, replaces) in sources.items():
        r = results[(name, "bf16")]  # the serving path's type
        line["kernels"].append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name], **r,
        })
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
