#!/usr/bin/env python3
"""Measure another checkout's package with ``chip_smoke.py``'s phases on one
GPU: a change's parent, or a copy with one design change, on the same card
in the same call as the change.

    python3 chip_compare.py gat ROOT
    python3 chip_compare.py edge-values ROOT
    python3 chip_compare.py batch-build ROOT
    python3 chip_compare.py smoke ROOT
    python3 chip_compare.py gat-repeat ROOT [RUNS]
    python3 chip_compare.py host ROOT
    python3 chip_compare.py narrow ROOT
    python3 chip_compare.py tf32-bwd ROOT
    python3 chip_compare.py busy ROOT

ROOT holds ``chip_smoke.py`` and ``sgformer_tpu_torch/`` of that checkout
(for example ``git archive <commit> chip_smoke.py sgformer_tpu_torch``
unpacked into a git-ignored directory); its kernels build into
``ROOT/build/``. Imports nothing of JAX.

``gat``: for a package whose GAT backward is ``csr_spmm_ev`` on the
transposed CSR plus ``sddmm`` (before ``csr_spmm_ev_bwd``): on the
power-law bench graph, that ``sddmm`` (called as that backward calls it,
without a hub plan) and that dx (``csr_spmm_ev`` of g in bf16 with the
values gathered into the transposed order) at GAT's two layer shapes, then
this checkout's powerlaw-gat-train path (``chip_smoke.gat_train_phase``)
with that package's launch counts (4 ``csr_spmm_ev`` + 2 ``sddmm`` a
step). ``edge-values``: ROOT's own ``chip_smoke.edge_value_phase`` on the
arxiv graph. ``batch-build``: ROOT's ``train.build_subgraph_batch`` on this
checkout's amazon2m-batch-train graph (``chip_smoke.AMAZON2M``, symmetrised
with self-loops on the card) over one epoch's batches of 100,000: the
median and range of each build's ms by CUDA events, the host clock over the
epoch, and a profile of five builds by kernel. ``smoke``: ROOT's own
``chip_smoke.py`` run whole with this checkout's ``profile_device`` in place
of its own, so that a parent's device-busy ms and this checkout's are read
by one definition (this checkout's leaves user-annotation ranges out).
``gat-repeat``: this checkout's arxiv-gat-train and powerlaw-gat-train
paths (``chip_smoke.gat_train_phase``) RUNS times each (10 by default) on
ROOT's package, recording each run's eval-logit reading (max |kernels -
plain| over the largest plain logit, held to ``GAT_LOGITS_RTOL``) and a
digest of both logit tensors' bytes; a reading over the tolerance is
counted, not raised. Prints one JSON line of the readings. ``host``: the
host's cost of ROOT's forward kernel wrappers, ``csr_spmm``, the attention
``reduce`` and ``apply``, in µs a call (3,000 calls after 100, one sync) at
Cora's size (N = 2,708, width 64), then this checkout's zoo phase
(``chip_smoke.zoo_phase``) on ROOT's package for three host-bound runs
(ablation-simple, squirrel-difformer, nodeformer); run it in turns
(parent, change, change, parent) to compare two checkouts' host cost.
``narrow``: this checkout's width sweep of the row walk
(``chip_smoke.width_sweep``: ``csr_spmm`` and ``csr_spmm_ev`` at narrow and
full widths on the arxiv graph, ``csr_spmm`` at F = 40 on the power-law
graph) on ROOT's kernels, then ROOT's ``csr_spmm`` at F = 256, f32 and
bf16, on the batch tiers' subgraphs (``train.build_subgraph_batch``): a
full batch and the tail of a seeded permutation of the arxiv graph in
batches of ``ARXIV_BATCH`` and of the amazon2m graph (``AMAZON2M``,
symmetrised with self-loops on the card) in batches of ``AMAZON2M_BATCH``;
run it in turns to compare two checkouts' kernels.
``tf32-bwd``: the attention backward's kernels of ROOT and of this
checkout, each turn a process of its own (``tf32-bwd-turn ROOT``), in
turns ROOT, this checkout, this checkout, ROOT. A turn times its package's f32 ``bwd_apply`` and
``bwd_reduce`` (CUDA events, median of 20) at M = D = 256 on the arxiv
(N = 169,343), amazon2m full-batch (100,000) and papers-sampled (621,432)
shapes, with the launches of each apart by the profiler (``kernel_ms``: the
rows pass, the P pass, the splits and the finish kernels), holds each f32
output to the plain version in f64 (the ratio printed), times the bf16
backward at the arxiv shape, prints sha256 digests of the bf16 backward's
outputs (``bwd_reduce``, then ``bwd_apply`` on the plain reduce's outputs)
at four shapes, and counts the ``HGMMA`` and ``HMMA`` instructions of each
backward kernel in ``cuobjdump -sass`` of its built library. The mode
prints each turn's JSON line, then one line that sets the turns side by
side and says whether the bf16 digests of the two packages are equal.
``busy``: ROOT's own amazon2m-batch-train, papers-sampled-train and
arxiv-cli-train phases (``chip_smoke.amazon2m_batch_phase``,
``papers_sampled_phase``, ``cli_phase``) with this checkout's
``profile_device``, so that both checkouts' device-busy ms a step or batch
are read by one definition; run it in turns (parent, change, change,
parent) to compare them.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def load_phases(path: str):
    """chip_smoke.py at ``path`` as a module (its imports of the package
    resolve to the first ``sgformer_tpu_torch`` on ``sys.path``)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_phases", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    modes = ("gat", "edge-values", "batch-build", "smoke", "gat-repeat", "host", "narrow",
             "tf32-bwd", "tf32-bwd-turn", "busy")
    if not (len(sys.argv) == 3 or len(sys.argv) == 4 and sys.argv[1] == "gat-repeat") or (
            sys.argv[1] not in modes):
        print(__doc__, file=sys.stderr)
        return 2
    mode, root = sys.argv[1], os.path.abspath(sys.argv[2])
    if mode == "tf32-bwd":
        return tf32_bwd(root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("chip_compare: CUDA is not available; this script needs a GPU", file=sys.stderr)
        return 1
    from sgformer_tpu_torch import kernels, preprocess_graph
    from sgformer_tpu_torch.data import synthetic_dataset
    from sgformer_tpu_torch.kernels import _build
    from sgformer_tpu_torch.kernels import spmm as k

    if not kernels.__file__.startswith(root):
        raise AssertionError(f"the package came from {kernels.__file__}, not {root}")
    if mode == "smoke":
        cs = load_phases(os.path.join(root, "chip_smoke.py"))
        cs.profile_device = load_phases(os.path.join(HERE, "chip_smoke.py")).profile_device
        return cs.main()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if mode == "busy":
        return busy(root)
    cs = load_phases(os.path.join(root if mode == "edge-values" else HERE, "chip_smoke.py"))
    print(cs.card_line(), flush=True)
    if mode == "batch-build":
        return batch_build(cs)
    if mode == "host":
        return host_cost(cs, root)
    if mode == "tf32-bwd-turn":
        return tf32_bwd_turn(cs, root)
    _build.build_all(("spmm",))  # GAT's kernels
    if mode == "gat-repeat":
        return gat_repeat(cs, int(sys.argv[3]) if len(sys.argv) == 4 else 10)
    if mode == "narrow":
        return narrow(cs, k)

    if mode == "edge-values":
        ds = synthetic_dataset("synth-arxiv", seed=0)
        graph = preprocess_graph(ds.graph["edge_index"], ds.num_nodes, chunk_dtype="bf16")
        cs.edge_value_phase(graph, {}, "cuda")
        return 0

    keys = kernels.launch_counts().keys()
    if "csr_spmm_ev_bwd" in keys:
        raise ValueError("this package has csr_spmm_ev_bwd: its chip_smoke.py measures it")
    cs.GAT_STEP_LAUNCHES = dict(dict.fromkeys(keys, 0), csr_spmm_ev=4, sddmm=2)
    cs.GAT_FORWARD_LAUNCHES = dict(dict.fromkeys(keys, 0), csr_spmm_ev=2)
    pl = synthetic_dataset(**cs.POWERLAW_GRAPH)
    g = preprocess_graph(pl.graph["edge_index"], pl.num_nodes)
    csr = (g.indptr, g.edge_src, g.edge_dst)
    gen = torch.Generator(device="cuda").manual_seed(6)
    for heads, d in cs.GAT_LAYERS:
        x = torch.randn(g.num_nodes, heads, d, generator=gen, device="cuda")
        gg = torch.randn(g.num_nodes, heads, d, generator=gen, device="cuda")
        v = torch.rand(g.num_edges, heads, generator=gen, device="cuda")
        sddmm_ms = cs.time_ms(lambda: k.sddmm(gg, x, *csr))
        dx_ms = cs.time_ms(lambda: k.csr_spmm_ev(
            gg.to(torch.bfloat16), g.t_indptr, g.t_edge_src, g.t_edge_dst,
            v.index_select(0, g.t_perm.long()), torch.float32, g.t_hub_segments, g.hub_edges))
        cs.log(f"power-law H={heads} D={d}: sddmm {sddmm_ms:.4f} ms (no hub plan), csr_spmm_ev dx "
               f"with its cast and gather of v {dx_ms:.4f} ms, both {sddmm_ms + dx_ms:.4f} ms")
        del x, gg, v
        torch.cuda.empty_cache()
    cs.gat_train_phase(pl, dataclasses.replace(g, chunk_dtype="bf16"), "cuda", "powerlaw-gat")
    return 0


def narrow(cs, k) -> int:
    """The ``narrow`` mode (see the module's docstring); ``k`` is ROOT's
    ``kernels.spmm``, whose walk has no lane groups if it has no
    ``walk_design``."""
    import torch

    from sgformer_tpu_torch import preprocess_graph
    from sgformer_tpu_torch.data import synthetic_dataset
    from sgformer_tpu_torch.graph import add_self_loops, remove_self_loops, to_undirected

    design = getattr(k, "walk_design", lambda d: "1 group of 32 lanes, 8 columns a lane")
    ds = synthetic_dataset("synth-arxiv", seed=0)
    graph = preprocess_graph(ds.graph["edge_index"], ds.num_nodes, chunk_dtype="bf16")
    cs.width_sweep(graph, {}, "cuda", "arxiv", cs.SWEEP_WIDTHS, cs.SWEEP_EV_SHAPES, design)
    pl = synthetic_dataset(**cs.POWERLAW_GRAPH)
    pl_graph = preprocess_graph(pl.graph["edge_index"], pl.num_nodes)
    cs.width_sweep(pl_graph, {}, "cuda", "powerlaw", cs.SWEEP_POWERLAW_WIDTHS, (), design)
    del pl, pl_graph
    edges = torch.stack([graph.edge_src, graph.edge_dst])
    batch_spmm(cs, k, "arxiv-batch", edges, graph.num_nodes, cs.ARXIV_BATCH)
    del ds, graph, edges
    torch.cuda.empty_cache()
    am = synthetic_dataset(**cs.AMAZON2M, device="cuda")
    ei = torch.from_numpy(am.graph["edge_index"]).cuda()
    ei = add_self_loops(remove_self_loops(to_undirected(ei)), am.num_nodes).int()
    batch_spmm(cs, k, "amazon2m-batch", ei, am.num_nodes, cs.AMAZON2M_BATCH)
    return 0


def batch_spmm(cs, k, what: str, edges, n: int, b: int) -> None:
    """csr_spmm at F = 256, f32 and bf16, on the subgraphs of a full batch
    and the tail of a seeded permutation of n nodes in batches of b: ms by
    CUDA events around a call (``time_ms``) and its kernels' device ms by
    the profiler (``kernel_ms``: the row walk and the hub rows' pass), which
    leaves out the host's share of a call this short."""
    import numpy as np
    import torch

    from sgformer_tpu_torch.train import build_subgraph_batch

    perm = torch.from_numpy(np.random.default_rng(0).permutation(n)).cuda()
    for idx in (perm[:b], perm[n // b * b:]):
        g = build_subgraph_batch(edges, idx, n)
        csr = (g.indptr, g.edge_src, g.edge_dst, g.gcn_weight, g.hub_segments, g.hub_edges)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(g.num_nodes, 256, device="cuda").to(dtype)
            ms = cs.time_ms(lambda: k.csr_spmm(x, *csr))
            dev = cs.kernel_ms(lambda: k.csr_spmm(x, *csr),
                               ("csr_spmm_kernel", "csr_spmm_hub_kernel"))
            cs.log(f"{what} csr_spmm {cs.DTYPE_NAME[dtype]} F=256 n={g.num_nodes} "
                   f"(E = {g.num_edges}): {ms:.4f} ms; device {sum(dev.values()):.4f} ms "
                   f"(row walk {dev['csr_spmm_kernel']:.4f}, hub rows "
                   f"{dev['csr_spmm_hub_kernel']:.4f})")
        del g, x
        torch.cuda.empty_cache()


def host_cost(cs, root: str) -> int:
    """The ``host`` mode (see the module's docstring)."""
    import time

    import torch

    from sgformer_tpu_torch import preprocess_graph
    from sgformer_tpu_torch.data import synthetic_dataset
    from sgformer_tpu_torch.kernels import _build
    from sgformer_tpu_torch.kernels import attention as attn
    from sgformer_tpu_torch.kernels.spmm import csr_spmm

    _build.build_all()
    ds = synthetic_dataset(num_nodes=2708, num_edges=10556, num_features=64, num_classes=7,
                           seed=0)
    g = preprocess_graph(ds.graph["edge_index"], ds.num_nodes)
    x = torch.randn(g.num_nodes, 64, device="cuda")
    q = torch.randn(g.num_nodes, 64, device="cuda")
    sums = attn.reduce(q, q, x)
    n_total = torch.tensor(float(g.num_nodes), device="cuda")
    csr = (g.indptr, g.edge_src, g.edge_dst, g.gcn_weight, g.hub_segments, g.hub_edges)

    def per_call_us(fn, calls=3000):
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / calls * 1e6

    for what, fn in (("csr_spmm", lambda: csr_spmm(x, *csr)),
                     ("reduce", lambda: attn.reduce(q, q, x)),
                     ("apply", lambda: attn.apply(q, x, *sums, n_total))):
        cs.log(f"host {root}: {what} {per_call_us(fn):.2f} us a call (N = {g.num_nodes})")
    cs.ZOO_RUNS = {k: v for k, v in cs.ZOO_RUNS.items()
                   if k in ("ablation-simple", "squirrel-difformer", "nodeformer")}
    cs.zoo_phase({}, "cuda")
    return 0


def gat_repeat(cs, runs: int) -> int:
    import hashlib
    import json

    import torch

    from sgformer_tpu_torch import preprocess_graph
    from sgformer_tpu_torch.data import synthetic_dataset

    ds = synthetic_dataset("synth-arxiv", seed=0)
    graph = preprocess_graph(ds.graph["edge_index"], ds.num_nodes, chunk_dtype="bf16")
    pl = synthetic_dataset(**cs.POWERLAW_GRAPH)
    pl_graph = preprocess_graph(pl.graph["edge_index"], pl.num_nodes, chunk_dtype="bf16")
    readings: dict = {"arxiv-gat": [], "powerlaw-gat": []}
    check_logits = cs.check_logits

    def record(what, logits, ref, shape, logits_tol):
        digest = [hashlib.sha256(t.float().cpu().numpy().tobytes()).hexdigest()[:16]
                  for t in (logits, ref)]
        rel = ((logits - ref).abs().max() / ref.abs().max()).item()
        readings[what.removesuffix(" eval")].append(
            dict(reading=rel, kernels_sha=digest[0], plain_sha=digest[1]))
        try:
            check_logits(what, logits, ref, shape, logits_tol)
        except AssertionError as exc:
            cs.log(f"gat-repeat: {exc} (counted)")

    cs.check_logits = record
    for i in range(runs):
        cs.gat_train_phase(ds, graph, "cuda", "arxiv-gat")
        cs.gat_train_phase(pl, pl_graph, "cuda", "powerlaw-gat")
        torch.cuda.empty_cache()
    summary = {what: dict(readings=[r["reading"] for r in rs],
                          over_tolerance=sum(r["reading"] > cs.GAT_LOGITS_RTOL for r in rs),
                          distinct_kernel_logits=len({r["kernels_sha"] for r in rs}),
                          distinct_plain_logits=len({r["plain_sha"] for r in rs}))
               for what, rs in readings.items()}
    print(json.dumps({"gat_repeat": summary, "tolerance": cs.GAT_LOGITS_RTOL}), flush=True)
    return 0


def batch_build(cs) -> int:
    import statistics
    import time

    import numpy as np
    import torch

    from sgformer_tpu_torch.data import synthetic_dataset
    from sgformer_tpu_torch.graph import add_self_loops, remove_self_loops, to_undirected
    from sgformer_tpu_torch.train import build_subgraph_batch

    ds = synthetic_dataset(**cs.AMAZON2M)
    ei = torch.from_numpy(ds.graph["edge_index"]).cuda()
    ei = add_self_loops(remove_self_loops(to_undirected(ei)), ds.num_nodes).int()
    n, b = ds.num_nodes, cs.AMAZON2M_BATCH
    perm = torch.from_numpy(np.random.default_rng(0).permutation(n)).cuda()
    batches = [perm[i:i + b] for i in range(0, n, b)]
    build_subgraph_batch(ei, batches[0], n)  # warm-up
    ms = [cs.cuda_ms(lambda: build_subgraph_batch(ei, idx, n))[1] for idx in batches]
    torch.cuda.synchronize()
    t = time.perf_counter()
    for idx in batches:
        build_subgraph_batch(ei, idx, n)
    torch.cuda.synchronize()
    host = (time.perf_counter() - t) * 1e3 / len(batches)
    cs.log(f"batch-build: {len(batches)} batches of {n} nodes, {ei.shape[1]} edges: median "
           f"{statistics.median(ms):.3f} ms (min {min(ms):.3f}, max {max(ms):.3f}) by CUDA "
           f"events; host clock {host:.3f} ms a build")
    cs.profile_device("batch-build, 5 builds",
                      lambda it=iter(batches): build_subgraph_batch(ei, next(it), n), 5)
    return 0


# the shapes of the tf32-bwd mode's bf16 digests, (N, M, D); its f32 shapes
# are chip_smoke.BWD_PASS_SHAPES
BF16_DIGEST_SHAPES = ((169_343, 256, 256), (100_000, 256, 256), (777, 37, 19), (777, 130, 200))


def tf32_bwd(root: str) -> int:
    """The ``tf32-bwd`` mode: four turns, each ``tf32-bwd-turn`` in a
    process of its own, then the turns side by side."""
    import json
    import subprocess

    turns = []
    for which in (root, HERE, HERE, root):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "tf32-bwd-turn", which],
                             capture_output=True, text=True, timeout=900)
        sys.stdout.write(out.stdout)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode != 0:
            print(f"chip_compare: the turn on {which} failed ({out.returncode})", file=sys.stderr)
            return 1
        turns.append(json.loads(out.stdout.strip().splitlines()[-1]))
    digests = {t["root"]: t["bf16_digests"] for t in turns}
    side = {f"turn {i} ({'ROOT' if t['root'] == root else 'this checkout'})": t["f32"]
            for i, t in enumerate(turns)}
    print(json.dumps({"tf32_bwd_turns": side,
                      "bf16_bitwise_equal": len({json.dumps(d) for d in digests.values()}) == 1}),
          flush=True)
    return 0


def tf32_bwd_turn(cs, root: str) -> int:
    """One turn of the ``tf32-bwd`` mode on ROOT's package; its last line
    of output is a JSON object of its numbers."""
    import hashlib
    import json
    import re

    import torch

    from sgformer_tpu_torch.kernels import _build
    from sgformer_tpu_torch.kernels import attention as attn

    report = _build.build_all(("linear_attention_bwd",)).get("linear_attention_bwd", "")
    for line in report.splitlines():  # the entry, registers, spills and wgmma notes
        if re.search(r"la_bwd_(apply|rows)_(tc|wg)|Used|spill|wgmma|Performance", line):
            cs.log(f"ptxas {root}: {line.strip()}")
    sass = subprocess_out(["cuobjdump", "-sass", _build._target("linear_attention_bwd")[1]])
    counts = {}
    for func, body in re.findall(r"Function : (\S+)(.*?)(?=Function : |\Z)", sass, re.S):
        if "la_bwd" in func:
            counts[func] = dict(HGMMA=len(re.findall(r"\bHGMMA\b", body)),
                                HMMA=len(re.findall(r"\bHMMA\b", body)))
    for func, c in counts.items():
        cs.log(f"sass {root}: {func}: HGMMA {c['HGMMA']}, HMMA {c['HMMA']}")

    dev = "cuda"
    out = dict(root=root, sass=counts, f32={}, bf16_digests=[])
    # the f32 rows pass and apply by either package's kernel name
    passes = ("la_bwd_rows_tc_kernel", "la_bwd_rows_wg_kernel", "la_bwd_reduce_tf32_kernel",
              "split_t_kernel", "la_bwd_finish_kernel", "la_bwd_dinv_kernel")
    applies = ("la_bwd_apply_tc_kernel", "la_bwd_apply_wg_kernel", "la_bwd_split_kernel")
    m = d = 256
    for name, n in cs.BWD_PASS_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(21)
        q, k, v, g = (torch.randn(n, m, generator=gen, device=dev) for _ in range(4))
        n_t = torch.full((), float(n), device=dev)
        sums = attn.reduce_plain(q, k, v, False)
        red = attn.bwd_reduce_plain(q, v, g, *sums, n_t, False)
        got_r = attn.bwd_reduce(q, v, g, *sums, n_t)
        exact = attn.bwd_reduce_plain(*(t.double() for t in (q, v, g, *sums, n_t)), False)
        errs = {part: rel(a, b) for part, a, b in zip(("P", "ds", "dinv", "rows"), got_r, exact)}
        del got_r, exact
        got_a = attn.bwd_apply(q, k, v, g, *sums, n_t, *red)
        exact = attn.bwd_apply_plain(*(t.double() for t in (q, k, v, g, *sums, n_t, *red)), False)
        errs.update({part: rel(a, b) for part, a, b in zip(("dq", "dk", "dv"), got_a, exact)})
        del got_a, exact
        a_ms = cs.time_ms(lambda: attn.bwd_apply(q, k, v, g, *sums, n_t, *red))
        r_ms = cs.time_ms(lambda: attn.bwd_reduce(q, v, g, *sums, n_t))
        r_dev = cs.kernel_ms(lambda: attn.bwd_reduce(q, v, g, *sums, n_t), passes)
        a_dev = cs.kernel_ms(lambda: attn.bwd_apply(q, k, v, g, *sums, n_t, *red), applies)
        rows_ms, p_ms = r_dev[passes[0]] + r_dev[passes[1]], r_dev[passes[2]]
        apply_ms = a_dev[applies[0]] + a_dev[applies[1]]
        out["f32"][name] = dict(n=n, bwd_apply_ms=a_ms, bwd_reduce_ms=r_ms, rows_ms=rows_ms,
                                p_pass_ms=p_ms, reduce_others_ms=sum(r_dev[p] for p in passes[3:]),
                                apply_kernel_ms=apply_ms, apply_split_ms=a_dev[applies[2]],
                                rel_err=errs)
        cs.log(f"tf32-bwd {root} {name} n={n}: bwd_apply {a_ms:.4f} ms (kernel {apply_ms:.4f}), "
               f"bwd_reduce {r_ms:.4f} ms (rows pass {rows_ms:.4f}, P pass {p_ms:.4f}); "
               f"|kernel - plain in f64| / scale: "
               + ", ".join(f"{p} {e:.2e}" for p, e in errs.items()))
        del q, k, v, g, sums, red
        torch.cuda.empty_cache()
    for n, m_, d_ in BF16_DIGEST_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(n + m_ + d_)
        q, k = (torch.randn(n, m_, generator=gen, device=dev).bfloat16() for _ in range(2))
        v, g = (torch.randn(n, d_, generator=gen, device=dev).bfloat16() for _ in range(2))
        n_t = torch.full((), float(n), device=dev)
        sums = attn.reduce_plain(q, k, v, False)
        red = attn.bwd_reduce_plain(q, v, g, *sums, n_t, False)
        outs = (*attn.bwd_reduce(q, v, g, *sums, n_t), *attn.bwd_apply(q, k, v, g, *sums, n_t, *red))
        digest = hashlib.sha256(b"".join(t.reshape(-1).cpu().view(torch.uint8).numpy().tobytes()
                                         for t in outs)).hexdigest()[:16]
        if (n, m_, d_) == (169_343, 256, 256):
            out["bf16_arxiv_ms"] = dict(
                bwd_apply=cs.time_ms(lambda: attn.bwd_apply(q, k, v, g, *sums, n_t, *red)),
                bwd_reduce=cs.time_ms(lambda: attn.bwd_reduce(q, v, g, *sums, n_t)))
        out["bf16_digests"].append(dict(shape=[n, m_, d_], sha256=digest))
        cs.log(f"tf32-bwd {root} bf16 n={n} m={m_} d={d_}: outputs sha256 {digest}")
        del q, k, v, g, sums, red, outs
    print(json.dumps(out), flush=True)
    return 0


def busy(root: str) -> int:
    """The ``busy`` mode (see the module's docstring)."""
    from sgformer_tpu_torch.data import synthetic_dataset
    from sgformer_tpu_torch.kernels import _build
    from sgformer_tpu_torch.native import build as native_build

    cs = load_phases(os.path.join(root, "chip_smoke.py"))
    cs.profile_device = load_phases(os.path.join(HERE, "chip_smoke.py")).profile_device
    print(cs.card_line(), flush=True)
    _build.build_all()
    native_build.library()
    results: dict = {}
    cs.amazon2m_batch_phase(results, "cuda")
    cs.papers_sampled_phase(results, "cuda")
    cs.cli_phase(synthetic_dataset("synth-arxiv", seed=0), results, "cuda")
    return 0


def rel(got, want) -> float:
    """max |got - want| over max |want|, in f64."""
    err = (got.double() - want.double()).abs().max().item()
    return err / max(want.double().abs().max().item(), 1e-300)


def subprocess_out(cmd: list) -> str:
    import subprocess

    return subprocess.run(cmd, capture_output=True, text=True, check=True, timeout=300).stdout


if __name__ == "__main__":
    sys.exit(main())
