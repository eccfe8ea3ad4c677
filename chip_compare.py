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
    python3 chip_compare.py bf16-bwd ROOT [ROOT ...]
    python3 chip_compare.py busy ROOT
    python3 chip_compare.py busy-f32 ROOT
    python3 chip_compare.py schedule ROOT
    python3 chip_compare.py designs ROOT [ROOT ...]
    python3 chip_compare.py rows ROOT [ROOT ...]
    python3 chip_compare.py bf16-passes ROOT [ROOT ...]
    python3 chip_compare.py bf16-apply ROOT [ROOT ...]
    python3 chip_compare.py bf16-apply-trace ROOT
    python3 chip_compare.py q8-f32-apply ROOT [ROOT ...] [--only q8|f32]
    python3 chip_compare.py reduce ROOT [ROOT ...]
    python3 chip_compare.py probes ROOT [ROOT ...]
    python3 chip_compare.py slab ROOT [ROOT ...]
    python3 chip_compare.py reuse

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
``tf32-bwd``: the f32 attention backward's kernels of each ROOT and of
this checkout, each turn a process of its own (``tf32-bwd-turn ROOT``), in
turns ROOT1 ... ROOTk, this checkout, this checkout, ROOTk ... ROOT1 (with
one ROOT: ROOT, this checkout, this checkout, ROOT). A turn times its
package's f32 ``bwd_apply`` and ``bwd_reduce`` (CUDA events, median of 20)
at M = D = 256 on the arxiv (N = 169,343), amazon2m full-batch (100,000),
papers-sampled (621,432) and amazon2m tail (49,029) shapes, with the
launches of each apart by the profiler (``kernel_ms``: the rows pass, the P
pass and the apply by any of the packages' kernel names, the splits and the
finish kernels), the rows pass beside its bound and ``torch.matmul(q,
kvs)`` in f32 (``rows_matmul_ms``, TF32 off), the P pass beside its bound
and ``torch.matmul(q.t(), gd)`` in f32 (gd = g / den made beforehand), the
apply beside its bound and its three products in ``torch.matmul`` (gd @
kvs^T, v @ P^T, k @ P, f32); prints sha256 digests of the f32
``bwd_reduce``'s outputs on host-made inputs (numpy, seed 27, N = 2,000 and
60,000, M = D = 256: ``tests/test_torch_cuda.py``'s
``EARLIER_ROWS_DIGESTS``); holds each
f32 output to the plain version in f64 on randn
inputs and the reduce's also on ``bwd_reduce_product_inputs`` (where a
dropped tf32 lo piece of q or g/den misses the tolerance): P, ds, den and
gden within REDUCE_REL_TOL of their scale, dinv of its sums' magnitude, dq,
dk and dv within the f32 BWD_REL_TOL, each reduce and apply bitwise
repeatable;
times the bf16 backward at the arxiv shape, prints sha256 digests of the
bf16 backward's outputs (``bwd_reduce``, then ``bwd_apply`` on the plain
reduce's outputs) at four shapes, and counts the ``HGMMA`` and ``HMMA``
instructions of every kernel of both attention libraries in ``cuobjdump
-sass``. The mode prints each turn's JSON line, then one line that sets the
turns side by side, and fails unless every turn's f32 outputs are within
tolerance and repeatable and the bf16 digests are the same in every turn
(Step 0 of a redesign runs it on copies of the parent with one part
removed each, which fail the check by design).
``bf16-passes``: the bf16 backward reduce's passes of each ROOT in the
order given (write the turns out: ROOT1 ROOT2 ROOT2 ROOT1), each turn a
process of its own (``bf16-passes-turn ROOT``): the rows pass's and the P
pass's device ms by the profiler (either package's kernel names) and the
whole ``bwd_reduce`` by CUDA events at M = D = 256 on the arxiv and
large-400K rows, and the reduce's digests on ``host_bf16_inputs`` (the
design A/Bs of a bf16 reduce redesign, on copies with one change each).
``bf16-apply``: the bf16 backward apply of each ROOT in the order given
(write the turns out: ROOT1 ROOT2 ROOT2 ROOT1), each turn a process of its
own (``bf16-apply-turn ROOT``): its kernels' ``ptxas`` registers and
spills, the kernel's device ms by the profiler at M = D = 256 on the
arxiv, large-400K and amazon2m tail rows, and digests of dq, dk and dv on
randn rows (``BF16_APPLY_VIEWS``) and of the outputs on host-made inputs,
each against the first turn's (the design A/Bs of a bf16 apply redesign,
on copies with one change each). ``bf16-apply-trace``: ROOT's
``la_bwd_apply_ws16_kernel`` in a copy stamped with the SM's clock at its
phases (``APPLY_TRACE_STAMPS``), one arxiv-shaped call, and each consumer
warpgroup's cycles by phase (blocks 0 and 2).
``rows``: the f32 backward rows pass of each ROOT in the order given
(write the turns out: ROOT1 ROOT2 ROOT2 ROOT1), each turn a process of
its own (``rows-turn ROOT``): its ``ptxas`` registers and spills, its
device ms by the profiler at M = D = 256 on the arxiv, amazon2m batch,
papers-sampled and amazon2m tail rows, and the digests of the f32
``bwd_reduce`` on host-made inputs (the design A/Bs of a rows-pass
redesign, on copies with one change each).
``bf16-bwd``: the bf16 attention backward's kernels of each ROOT and of
this checkout, each turn a process of its own (``bf16-bwd-turn ROOT``), in
turns ROOT1 ... ROOTk, this checkout, this checkout, ROOTk ... ROOT1 (with
one ROOT: ROOT, this checkout, this checkout, ROOT). A turn prints the
designs at M = D = 256, the backward kernels' ``ptxas`` registers and
spills, counts the ``HGMMA`` and ``HMMA`` instructions of each backward
kernel, then at M = D = 256 on the arxiv (N = 169,343), amazon2m
full-batch and tail (100,000, 49,029), large-400K (400,000) and
arxiv-batch full-batch and tail (50,000, 19,343) shapes times its
package's bf16 ``bwd_reduce`` and ``bwd_apply`` (CUDA events, median of
20) and their launches apart by the profiler (the rows pass and the P pass
by either package's kernel names, the split, finish and dinv; the apply
by any package's kernel name, and its split), prints each pass beside its
bound (the bytes it must move and the operations of its split products:
three for the rows pass, two for the P pass, six for the apply) and beside
its own products, each in one bf16 ``torch.matmul`` (``torch.matmul(q,
kvs)``, ``torch.matmul(q.t(), gd)``, and the apply's gd @ kvs^T, v @ P^T
and k @ P, gd = g / den made beforehand; never called by the port), holds
each output to the plain version in f64 (random inputs at n = N, and the
apply on ``bwd_product_inputs``; the ratios printed), checks that both are
bitwise repeatable, and digests the bf16 ``bwd_reduce`` and ``bwd_apply`` at
``BF16_DIGEST_SHAPES``, the bf16 ``bwd_reduce`` on host-made inputs
(``host_bf16_inputs``, N = 2,000 and 60,000: ``tests/test_torch_cuda.py``'s
``EARLIER_BF16_REDUCE_DIGESTS``), the bf16 ``bwd_apply`` on host-made
inputs (``host_attention_inputs`` in bf16, N = 2,000 and 60,000: the bf16
backward apply's rows of ``EARLIER_APPLY_DIGESTS``) and the f32 backward's
outputs at three shapes. The mode prints each turn's JSON line, then the
turns side by side, and fails unless the bf16 and f32 digests are equal in
every turn
(Step 0 of a redesign runs it on copies of the parent with one part
removed each, which fail the check by design).
``busy``: ROOT's own arxiv-train, large-400K-int8-train,
amazon2m-batch-train and arxiv-cli-train phases (``chip_smoke.train_phase``,
``q8_train_phase``, ``amazon2m_batch_phase``, ``cli_phase``) on graphs that
ROOT's ``preprocess_graph`` builds, with this checkout's ``profile_device``,
so that both checkouts' device-busy ms a step or batch are read by one
definition; run it in turns (parent, change, change, parent) to compare
them. ``busy-f32``: the same for the cells whose attention runs in f32,
ROOT's amazon2m-batch-train, papers-sampled-train and arxiv-cli-train
phases (``amazon2m_batch_phase``, ``papers_sampled_phase``, ``cli_phase``).
``schedule``: the CSR row walk of ROOT and of this checkout, each turn a
process of its own (``schedule-turn ROOT``), in turns ROOT, this checkout,
this checkout, ROOT. A turn builds synth-arxiv with its package's
``preprocess_graph`` (seconds and peak device MiB; with a walk order, the
clustering's seconds alone) and with
``reorder=True``, the power-law bench graph both ways, the batch tiers'
subgraphs (a full batch and the tail of arxiv-batch and amazon2m-batch) and
one papers-sampled batch graph (C++ sampler, seed 0), then times each call
(CUDA events, median of 20, and its kernels' device ms by the profiler)
beside ``torch.sparse.mm`` (one call a head) with its gathered rate and a
sha256 digest of its output: ``csr_spmm`` at
every width of ``SWEEP_WIDTHS`` and ``csr_spmm_ev`` at every shape of
``SWEEP_EV_SHAPES`` (messages in bf16 and f32, f32 out) on the arxiv graph,
``csr_spmm_ev_bwd`` at GAT's two layer shapes there (bf16 messages of f32 x
and g; dx and dv), ``csr_spmm`` at F = 40 and 256 on the reordered arxiv
graph and on the power-law graph both ways, at F = 256 on the batch
subgraphs and on the sampled batch's A and A^T, bf16 and f32 (the sampled
batch f32); each held to its plain version (but ``csr_spmm_ev_bwd``) and
bitwise repeatable. A package with walk orders runs each call as the model
path does (the graph's order) and again without one. The mode prints each
turn's JSON line, then each call's turns side by side, and fails unless
every output is bitwise the same in every turn, with and without a walk
order.
``designs``: the CSR row walk of each ROOT (copies of the package, each
with one design change), each turn a process of its own
(``designs-turn ROOT``), in turns ROOT1 ... ROOTk and back: each turn
prints its ``csr_spmm_kernel`` instances' registers and spills from
``ptxas`` and times ``csr_spmm`` at every width of ``SWEEP_WIDTHS`` on
synth-arxiv and at ``SCHEDULE_WIDTHS`` on the power-law graph, bf16 and
f32, in the graph's walk order and without, and ``csr_spmm_ev`` at (H, D)
= (2, 40) f32 and (2, 256) bf16; then the turns side by side, and whether
each output is bitwise the same in every turn.
``q8-f32-apply``: the int8 aggregation (``csr_spmm_q8_apply``) and the f32
forward apply of each ROOT and of this checkout, each turn a process of its
own (``q8-f32-apply-turn ROOT``), in turns ROOT1 ... ROOTk, this checkout,
this checkout, ROOTk ... ROOT1 (with one ROOT: ROOT, this checkout, this
checkout, ROOT). A turn prints its kernels' registers and spills from
``ptxas`` and the ``HGMMA`` and ``HMMA`` instructions of each forward apply
kernel in ``cuobjdump -sass``; times ``csr_spmm_q8_apply`` at F = 256 (bf16
rows and out, on rows quantised by the plain quantiser) on large-400K,
synth-arxiv and the power-law bench graph (its hub plan), in node order and,
where its package takes one, in the graph's walk order (CUDA events, median
of 20, and the profiler's device ms a launch), each output against the
plain version (bitwise equal or not) and its sha256 digest; then the f32
forward apply at M = D = 256 on N = 169,343 (arxiv), 100,000 and 49,029
(the amazon2m batch and its tail), 50,000 and 19,343 (arxiv-batch) and
621,432 (a papers-sampled batch): CUDA events, the profiler's device ms of
the apply kernel and of its split, the host's microseconds a call at the
19,343 tail (200 calls enqueued, no sync between), the output against the
plain version in f64 and bitwise repeatable; the bf16 forward apply at
the same shapes: CUDA events, the profiler's device ms of its kernel (either
package's) and of its split, ``torch.matmul(q, kvs)`` in bf16 as a
yardstick and the bound, its output where q @ kvs carries it (with and
without cancelling kvs terms) against the plain version in f64 over the
bf16 tolerance, bitwise repeatable, and a digest of it on randn rows; and
digests of the bf16 apply and the f32 backward at a few shapes. The mode
prints each turn's JSON line, then the turns side by side, and fails
unless every ``csr_spmm_q8`` output, the bf16 apply's and the f32
backward's digests are the same in every turn and the bf16 apply is within
its tolerance and repeatable in every turn. ``--only q8`` or ``--only
f32`` runs the int8 aggregation's part or the applies' (the digests of the
other checks only with ``f32``).
``reduce``: the forward attention reduce of each ROOT and of this checkout,
each turn a process of its own (``reduce-turn ROOT``), in turns ROOT1 ...
ROOTk, this checkout, this checkout, ROOTk ... ROOT1. A turn prints the
reduce kernels' registers, spills and warnings from ``ptxas``, their
``HGMMA`` and ``HMMA`` instructions in ``cuobjdump -sass`` and the designs;
then at M = D = 256 on N = 169,343 (arxiv), 100,000 and 49,029 (the
amazon2m batch and its tail), 50,000 and 19,343 (arxiv-batch) and 621,432 (a
papers-sampled batch), bf16 and f32: the reduce's CUDA-event ms (median of
20), the profiler's device ms of its main kernel and of its two finishing
kernels, ``torch.matmul(k.t(), v)`` in the inputs' type (TF32 off) as a
yardstick, and the bound; every output (kvs, ksum, the norms)
against its sums in f64 on randn, positive and ``reduce_product_inputs``
inputs (where a dropped tf32 lo piece misses the tolerance), over
REDUCE_REL_TOL, whether each is bitwise repeatable, and a sha256 digest of
the outputs of each input kind. The mode prints each turn's JSON line, then
the turns side by side and whether each digest is the same in every turn,
and fails unless every turn's outputs are within the tolerance and
repeatable.
``probes``: the timing probes' two gather kernels, ``gather_rows`` and
``gather_tiles``, of ROOT and of this checkout, each turn a process of its
own (``python3 chip_compare.py turn probes ROOT``, from ``TURNS``), in
turns ROOT, this checkout, this checkout, ROOT, or on the ROOTs in the order
given (write the turns out: ROOT1 ROOT2 ROOT2 ROOT1). A turn prints the two
kernels' registers and spills from ``ptxas`` and their designs, then at the
probes' own sizes (``dma_gather.make_inputs``, ``dma_tile.make_inputs``)
and at every S they run (rows 4, 8, 16, 32; tiles 8, 32) each kernel's
CUDA-event ms (median of 20) and rates, its error against the plain
version over its ``REL_TOL``, whether it is bitwise repeatable, whether it
is bitwise the sums taken on the host in the kernels' order
(``chip_smoke.rows_in_order``, ``tiles_in_order``), and sha256 digests of
its outputs there and at the card tests' shapes (``PROBE_DIGEST_SHAPES``);
and ``gather_rows``' rate at S = 4 and 16 on the probe's random rows over x
of 20.5 MB, within L2, and of 1.02 GB, from HBM (``PROBE_CEILING_ROWS``).
The mode prints each turn's JSON line, then the turns side by side and
whether each digest is the same in every turn, and fails unless every turn
is within tolerance and repeatable (Step 0 of a redesign runs it on copies
of the parent with one part changed each, whose digests may differ by
design).
``slab``: the ``slab_variant`` probe and ``csr_spmm``'s walk, of the ROOTs
and of this checkout, each turn a process of its own (``python3
chip_compare.py turn slab ROOT``, from ``TURNS``), in turns ROOT1 ... ROOTk,
this checkout, this checkout, ROOTk ... ROOT1. A turn prints the registers,
stack and local bytes of ``csr_spmm_kernel``'s and the probe's instances
(``cuobjdump --dump-resource-usage``) and digests of ``csr_spmm_kernel``'s
SASS (``cuobjdump -sass``), each by its name without the anonymous
namespace's hash; on synth-arxiv at F = 256 (x from
``slab_variants.make_x``) each of the probe's three modes in the walk order
(where ROOT's wrapper takes one) and in node order: CUDA-event ms (median
of 20), its error over ``REL_TOL``, bitwise repeatability, the two orders
bitwise equal, prod bitwise
``csr_spmm`` of the f32 x, sha256 digests of the outputs; ``csr_spmm`` bf16
timed in both orders, and its outputs of the bf16 and the f32 x digested
in both orders. The mode prints each turn's JSON line, then the turns side
by side, whether each digest, ``csr_spmm_kernel``'s resources and its SASS
are the same in every turn, and fails unless every turn passes its checks
and ``csr_spmm``'s digests are the same in every turn (~1 min a turn).
``reuse`` (no ROOT; on the CPU, no card): this checkout's
``preprocess_graph`` of synth-arxiv, and for windows of 64, 256, 1,024 and
8,448 consecutive rows of the walk order and of node order, the edges the
windows gather over the distinct source rows among them, the distinct rows
a window and their bytes, and the share of the gathered rows that staging
each window's distinct rows once would save (~10 s).
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
             "tf32-bwd", "tf32-bwd-turn", "bf16-bwd", "bf16-bwd-turn", "busy", "busy-f32",
             "schedule",
             "schedule-turn", "designs", "designs-turn", "q8-f32-apply", "q8-f32-apply-turn",
             "rows", "rows-turn", "bf16-passes", "bf16-passes-turn", "bf16-apply",
             "bf16-apply-turn", "bf16-apply-trace", "bf16-apply-trace-turn",
             "reduce", "reduce-turn", "probes", "slab", "reuse", "turn")
    if sys.argv[1:] == ["reuse"]:
        return reuse()
    only = None
    if len(sys.argv) > 4 and sys.argv[1].startswith("q8-f32-apply") and sys.argv[-2] == "--only":
        only = sys.argv[-1]
        del sys.argv[-2:]
    if not (len(sys.argv) == 3 and sys.argv[1] != "turn"
            or len(sys.argv) == 4 and sys.argv[1] in ("gat-repeat", "turn")
            or len(sys.argv) > 3 and sys.argv[1] in ("designs", "q8-f32-apply", "reduce",
                                                     "tf32-bwd", "bf16-bwd", "rows",
                                                     "bf16-passes", "bf16-apply", "probes",
                                                     "slab")) \
            or sys.argv[1] not in modes or sys.argv[1] == "turn" and sys.argv[2] not in TURNS:
        print(__doc__, file=sys.stderr)
        return 2
    mode, root = sys.argv[1], os.path.abspath(sys.argv[-1 if sys.argv[1] == "turn" else 2])
    if mode == "tf32-bwd":
        return tf32_bwd([os.path.abspath(r) for r in sys.argv[2:]])
    if mode == "bf16-bwd":
        return bf16_bwd([os.path.abspath(r) for r in sys.argv[2:]])
    if mode == "schedule":
        return schedule(root)
    if mode == "designs":
        return designs([os.path.abspath(r) for r in sys.argv[2:]])
    if mode in ("rows", "bf16-passes"):
        turns = run_turns(f"{mode}-turn", root, [os.path.abspath(r) for r in sys.argv[2:]])
        return 0 if turns is not None else 1
    if mode == "bf16-apply":
        return bf16_apply([os.path.abspath(r) for r in sys.argv[2:]])
    if mode == "bf16-apply-trace":
        return apply_trace(root)
    if mode == "q8-f32-apply":
        return q8_f32_apply([os.path.abspath(r) for r in sys.argv[2:]], only)
    if mode == "reduce":
        return reduce([os.path.abspath(r) for r in sys.argv[2:]])
    if mode == "probes":
        return probes([os.path.abspath(r) for r in sys.argv[2:]])
    if mode == "slab":
        return slab([os.path.abspath(r) for r in sys.argv[2:]])
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
    if mode in ("busy", "busy-f32"):
        return busy(root, mode == "busy-f32")
    cs = load_phases(os.path.join(root if mode == "edge-values" else HERE, "chip_smoke.py"))
    print(cs.card_line(), flush=True)
    if mode == "batch-build":
        return batch_build(cs)
    if mode == "host":
        return host_cost(cs, root)
    if mode == "tf32-bwd-turn":
        return tf32_bwd_turn(cs, root)
    if mode == "bf16-bwd-turn":
        return bf16_bwd_turn(cs, root)
    if mode == "schedule-turn":
        return schedule_turn(cs, root)
    if mode == "designs-turn":
        return designs_turn(cs, root)
    if mode == "rows-turn":
        return rows_turn(cs, root)
    if mode == "bf16-passes-turn":
        return bf16_passes_turn(cs, root)
    if mode == "bf16-apply-turn":
        return bf16_apply_turn(cs, root)
    if mode == "bf16-apply-trace-turn":
        return apply_trace_turn(root)
    if mode == "q8-f32-apply-turn":
        return q8_f32_apply_turn(cs, root, only)
    if mode == "reduce-turn":
        return reduce_turn(cs, root)
    if mode == "turn":
        return TURNS[sys.argv[2]](cs, root)
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


def run_turns(mode: str, root: str, order=None, extra=()):
    """``mode`` on ROOT, this checkout, this checkout and ROOT (or on the
    roots of ``order``), each turn a process of its own (``extra`` added to
    its arguments); the last line of each turn's output (a JSON object)
    parsed, or None if a turn failed."""
    import json
    import subprocess

    turns = []
    for which in order or (root, HERE, HERE, root):
        args = ["turn", mode] if mode in TURNS else [mode]
        out = subprocess.run([sys.executable, os.path.abspath(__file__), *args, which, *extra],
                             capture_output=True, text=True, timeout=900)
        sys.stdout.write(out.stdout)
        sys.stderr.write(out.stderr[-4000:])
        if out.returncode != 0:
            print(f"chip_compare: the turn on {which} failed ({out.returncode})", file=sys.stderr)
            return None
        turns.append(json.loads(out.stdout.strip().splitlines()[-1]))
    return turns


def tf32_bwd(roots: list) -> int:
    """The ``tf32-bwd`` mode: the turns, each ``tf32-bwd-turn`` in a process
    of its own, then the turns side by side; fails unless every turn's f32
    outputs are within tolerance and repeatable and the bf16 digests are
    the same in every turn."""
    import json

    order = roots + [HERE, HERE] + roots[::-1]
    turns = run_turns("tf32-bwd-turn", roots[0], order)
    if turns is None:
        return 1
    names = {r: f"ROOT{i + 1}" for i, r in enumerate(roots)}
    names[HERE] = "this checkout"
    side = {f"turn {i} ({names[t['root']]})": dict(f32=t["f32"], sass=t["sass"],
                                                    f32_reduce_digests=t["f32_reduce_digests"])
            for i, t in enumerate(turns)}
    ok = {names[t["root"]]: t["ok"] for t in turns}
    bf16_equal = len({json.dumps(t["bf16_digests"]) for t in turns}) == 1
    print(json.dumps({"tf32_bwd_turns": side, "within_tolerance_and_repeatable": ok,
                      "bf16_bitwise_equal": bf16_equal}), flush=True)
    return 0 if all(ok.values()) and bf16_equal else 1


def bf16_bwd(roots: list) -> int:
    """The ``bf16-bwd`` mode: the turns, each ``bf16-bwd-turn`` in a process
    of its own, then the turns side by side; fails unless the bf16 and the
    f32 digests are the same in every turn."""
    import json

    order = roots + [HERE, HERE] + roots[::-1]
    turns = run_turns("bf16-bwd-turn", roots[0], order)
    if turns is None:
        return 1
    names = {r: f"ROOT{i + 1}" for i, r in enumerate(roots)}
    names[HERE] = "this checkout"
    side = {f"turn {i} ({names[t['root']]})": t["bf16"] for i, t in enumerate(turns)}
    equal = {key: len({json.dumps(t[key]) for t in turns}) == 1
             for key in ("bf16_digests", "bf16_reduce_digests", "bf16_apply_digests",
                         "f32_digests")}
    print(json.dumps({"bf16_bwd_turns": side, "bitwise_equal": equal}), flush=True)
    return 0 if all(equal.values()) else 1


# the bf16 backward's launches by kernel name, either package's: the rows
# pass, the P pass, the reduce's other launches (the split of kvs^T, the
# P finish, the dinv sum), the apply and the apply's split
BF16_ROWS = ("la_bwd_rows_tc_kernel", "la_bwd_rows_wgmma_kernel", "la_bwd_rows_ws16_kernel")
BF16_P_PASS = ("la_bwd_reduce_tc_kernel", "la_bwd_reduce_wgmma_kernel",
               "la_bwd_reduce_ws16_kernel")
BF16_REDUCE_OTHERS = ("split_t_kernel", "la_bwd_split_rows_kernel", "la_bwd_finish_kernel",
                      "la_bwd_dinv_kernel")
BF16_APPLY = ("la_bwd_apply_tc_kernel", "la_bwd_apply_wgmma_kernel", "la_bwd_apply_ws16_kernel")
# the f32 backward reduce's launches by kernel name, any package's: the
# rows pass (mma.sync, warpgroup MMAs, warp-specialised), the P pass
# (mma.sync, then warpgroup MMAs), the reduce's other launches (the split
# of kvs^T, by either name); the apply and its split
F32_ROWS = ("la_bwd_rows_tc_kernel", "la_bwd_rows_wg_kernel", "la_bwd_rows_ws_kernel")
F32_P_PASS = ("la_bwd_reduce_tf32_kernel", "la_bwd_reduce_wg_kernel")
F32_REDUCE_OTHERS = ("split_t_kernel", "split_kvs_kernel", "la_bwd_finish_kernel",
                     "la_bwd_dinv_kernel")
F32_APPLY = ("la_bwd_apply_tc_kernel", "la_bwd_apply_wg_kernel", "la_bwd_apply_ws_kernel")
# the f32 backward apply's split of kvs, P and P^T, either package's
F32_APPLY_SPLIT = ("la_bwd_split_kernel", "la_bwd_split_atoms_kernel")
# the f32 backward's outputs digested in every turn (bitwise the parent's)
F32_DIGEST_SHAPES = ((20_000, 256, 256), (777, 37, 19), (777, 130, 200))
# the bf16 backward reduce's outputs on host-made inputs digested in every
# turn of the bf16-bwd mode (the rows of tests/test_torch_cuda.py's
# EARLIER_BF16_REDUCE_DIGESTS)
BF16_REDUCE_DIGEST_ROWS = (2000, 60_000)
# the bf16-bwd mode's shapes, (name, N) at M = D = 256: arxiv, the amazon2m
# batch and its tail, large-400K, the arxiv batch and its tail
BF16_BWD_SHAPES = (("arxiv", 169_343), ("amazon2m-batch", 100_000), ("amazon2m-batch tail", 49_029),
                   ("large-400K", 400_000), ("arxiv-batch", 50_000), ("arxiv-batch tail", 19_343))
# the bf16 backward apply's outputs on host-made inputs digested in every
# turn of the bf16-bwd mode (the rows of tests/test_torch_cuda.py's
# EARLIER_APPLY_DIGESTS for the bf16 backward apply)
BF16_APPLY_DIGEST_ROWS = (2000, 60_000)
# the f32 backward reduce's outputs on host-made inputs digested in every
# turn of the tf32-bwd mode (the rows of tests/test_torch_cuda.py's
# EARLIER_ROWS_DIGESTS)
F32_REDUCE_DIGEST_ROWS = (2000, 60_000)


def host_attention_inputs(n: int, dtype=None):
    """q, k, v, g [n, 256] of ``dtype`` (f32 by default) from numpy (seed
    27), as ``tests/test_torch_cuda.py::_host_apply_inputs`` makes them, and
    the plain forward reduce's outputs, all made on the host."""
    import numpy as np
    import torch

    from sgformer_tpu_torch.kernels import attention as attn

    rng = np.random.default_rng(27)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((n, 256)).astype(np.float32))
                  .to(dtype or torch.float32) for _ in range(4))
    return q, k, v, g, attn.reduce_plain(q, k, v, False), torch.tensor(float(n))


def host_bf16_inputs(n: int):
    """q, v, g [n, 256] bf16 from numpy (seed 28) and kvs, ksum, scal and
    n_total as the forward gives them, the sums taken in f64 and rounded to
    f32 once, all made on the host: the arguments of ``bwd_reduce``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(28)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((n, 256)).astype(np.float32))
                  .to(torch.bfloat16) for _ in range(4))
    qd, kd, vd = q.double(), k.double(), v.double()
    q_sq, k_sq = qd.square().sum(), kd.square().sum()
    scal = torch.stack([q_sq, k_sq, 1.0 / (q_sq.sqrt() * k_sq.sqrt()),
                        torch.zeros((), dtype=torch.float64)]).float()
    return q, v, g, (kd.T @ vd).float(), kd.sum(0).float(), scal, torch.tensor(float(n))


def sass_counts(cs, root: str, library: str = "linear_attention_bwd",
                kernels: str = "la_bwd") -> dict:
    """``HGMMA`` and ``HMMA`` instructions of each kernel whose name holds
    ``kernels`` (the backward's by default; ``la_reduce`` for the forward
    reduce's) in ``cuobjdump -sass`` of ROOT's built ``library``, logged."""
    import re

    from sgformer_tpu_torch.kernels import _build

    sass = subprocess_out(["cuobjdump", "-sass", _build._target(library)[1]])
    counts = {}
    for func, body in re.findall(r"Function : (\S+)(.*?)(?=Function : |\Z)", sass, re.S):
        if kernels in func:
            counts[func] = dict(HGMMA=len(re.findall(r"\bHGMMA\b", body)),
                                HMMA=len(re.findall(r"\bHMMA\b", body)))
    for func, c in counts.items():
        cs.log(f"sass {root}: {func}: HGMMA {c['HGMMA']}, HMMA {c['HMMA']}")
    return counts


def bf16_bwd_turn(cs, root: str) -> int:
    """One turn of the ``bf16-bwd`` mode on ROOT's package; its last line
    of output is a JSON object of its numbers."""
    import json
    import re

    import torch

    from sgformer_tpu_torch.kernels import _build
    from sgformer_tpu_torch.kernels import attention as attn
    from sgformer_tpu_torch.utils.measure import bwd_product_inputs

    report = _build.build_all(("linear_attention_bwd",)).get("linear_attention_bwd", "")
    entry = False
    for line in report.splitlines():  # the bf16 kernels' registers, spills and warnings
        if "entry function" in line:
            entry = bool(re.search(r"la_bwd_(apply|rows|reduce)_(tc|wgmma|ws16)_", line))
        if entry or "warning" in line:
            cs.log(f"ptxas {root}: {line.strip()}")
    dev, m = "cuda", 256
    out = dict(root=root, sass=sass_counts(cs, root), bf16={}, bf16_digests=[],
               bf16_reduce_digests={}, bf16_apply_digests={}, f32_digests=[],
               designs=dict(reduce=attn.bwd_reduce_design(torch.bfloat16, m, m),
                            apply=attn.bwd_apply_design(torch.bfloat16, m, m)))
    cs.log(f"bf16-bwd {root} designs at M = D = 256: {out['designs']}")
    passes = BF16_ROWS + BF16_P_PASS + BF16_REDUCE_OTHERS
    applies = BF16_APPLY + ("la_bwd_split_kernel", "la_bwd_split_tiles_kernel")
    for name, n in BF16_BWD_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(23)
        q, k, v, g = (torch.randn(n, m, generator=gen, device=dev).bfloat16() for _ in range(4))
        n_t = torch.full((), float(n), device=dev)
        sums = attn.reduce_plain(q, k, v, False)
        red = attn.bwd_reduce_plain(q, v, g, *sums, n_t, False)
        got_r = attn.bwd_reduce(q, v, g, *sums, n_t)
        exact = attn.bwd_reduce_plain(*(t.double() for t in (q, v, g, *sums, n_t)), False)
        errs = {part: rel(a, b) for part, a, b in zip(("P", "ds", "dinv", "rows"), got_r, exact)}
        repeat = all(torch.equal(a, b) for a, b in zip(got_r, attn.bwd_reduce(q, v, g, *sums, n_t)))
        gd = (g.float() / got_r[3][0][:, None]).bfloat16()
        del got_r, exact
        got_a = attn.bwd_apply(q, k, v, g, *sums, n_t, *red)
        exact = attn.bwd_apply_plain(*(t.double() for t in (q, k, v, g, *sums, n_t, *red)), False)
        errs.update({part: rel(a, b) for part, a, b in zip(("dq", "dk", "dv"), got_a, exact)})
        repeat = repeat and all(torch.equal(a, b) for a, b in
                                zip(got_a, attn.bwd_apply(q, k, v, g, *sums, n_t, *red)))
        del got_a, exact
        # the apply where its products carry dq, dk and dv (n = inv = 1)
        gen_p = torch.Generator(device=dev).manual_seed(8)
        ins = bwd_product_inputs(n, m, m, torch.bfloat16, gen_p)
        exact = attn.bwd_apply_plain(*(t.double() for t in ins), False)
        errs.update({f"{part} (products carry it)": rel(a, b)
                     for part, a, b in zip(("dq", "dk", "dv"), attn.bwd_apply(*ins), exact)})
        del ins, exact
        a_ms = cs.time_ms(lambda: attn.bwd_apply(q, k, v, g, *sums, n_t, *red))
        r_ms = cs.time_ms(lambda: attn.bwd_reduce(q, v, g, *sums, n_t))
        r_dev = cs.kernel_ms(lambda: attn.bwd_reduce(q, v, g, *sums, n_t), passes)
        a_dev = cs.kernel_ms(lambda: attn.bwd_apply(q, k, v, g, *sums, n_t, *red), applies)
        rows_ms = sum(r_dev[p] for p in BF16_ROWS)
        p_ms = sum(r_dev[p] for p in BF16_P_PASS)
        others_ms = sum(r_dev[p] for p in BF16_REDUCE_OTHERS)
        apply_ms = sum(a_dev[p] for p in BF16_APPLY)
        split_ms = a_dev["la_bwd_split_kernel"] + a_dev["la_bwd_split_tiles_kernel"]
        # yardsticks: each pass's own product in one bf16 torch.matmul (never
        # called by the port): a = q @ kvs, and P = q^T gd
        kvs_b = sums[0].bfloat16()
        rows_matmul_ms = cs.time_ms(lambda: torch.matmul(q, kvs_b))
        p_matmul_ms = cs.time_ms(lambda: torch.matmul(q.t(), gd))
        # and the apply's three products, each in one bf16 torch.matmul: gd @
        # kvs^T, v @ P^T, k @ P
        P_b = red[0].bfloat16()
        apply_matmul_ms = dict(gd_kvsT=cs.time_ms(lambda: torch.matmul(gd, kvs_b.t())),
                               v_PT=cs.time_ms(lambda: torch.matmul(v, P_b.t())),
                               k_P=cs.time_ms(lambda: torch.matmul(k, P_b)))
        # the bounds: the rows pass reads q, v, g, kvs and ksum and writes
        # den and gden, and runs three bf16 products (kvs^T as hi + mid + lo);
        # the P pass reads q, g, den and gden, writes P and ds, and runs two
        # (g/den as hi + lo); the whole reduce is both
        small = (m * m + m) * 4
        rows_bound = cs.bound_ms(3 * n * m * 2 + small + 2 * n * 4, 3 * 2 * n * m * m,
                                 torch.bfloat16)
        p_bound = cs.bound_ms(2 * n * m * 2 + 2 * n * 4 + small, 2 * 2 * n * m * m, torch.bfloat16)
        r_bound = cs.bound_ms(3 * n * m * 2 + 2 * small + 2 * n * 4 + 4,
                              5 * 2 * n * m * m + 6 * n * m + 2 * n * m, torch.bfloat16)
        # the apply reads q, k, v, g, den, gden, kvs, ksum, P and ds and
        # writes dq, dk and dv, and runs six bf16 products (kvs and P as hi +
        # lo)
        a_bound = cs.bound_ms(7 * n * m * 2 + 2 * n * 4 + 2 * small, 6 * 2 * n * m * m,
                              torch.bfloat16)
        out["bf16"][name] = dict(n=n, bwd_apply_ms=a_ms, bwd_reduce_ms=r_ms,
                                 bwd_reduce_bound_ms=r_bound[0], bwd_reduce_bound_by=r_bound[1],
                                 rows_ms=rows_ms, rows_bound_ms=rows_bound[0],
                                 rows_bound_by=rows_bound[1], rows_matmul_ms=rows_matmul_ms,
                                 p_pass_ms=p_ms, p_pass_bound_ms=p_bound[0],
                                 p_pass_bound_by=p_bound[1], p_pass_matmul_ms=p_matmul_ms,
                                 reduce_others_ms=others_ms, apply_kernel_ms=apply_ms,
                                 apply_split_ms=split_ms, apply_bound_ms=a_bound[0],
                                 apply_bound_by=a_bound[1],
                                 apply_bound_bytes_ms=cs.bound_ms(
                                     7 * n * m * 2 + 2 * n * 4 + 2 * small, 0)[0],
                                 apply_matmul_ms=apply_matmul_ms, rel_err=errs,
                                 bitwise_repeatable=repeat)
        cs.log(f"bf16-bwd {root} {name} n={n}: bwd_apply {a_ms:.4f} ms (kernel {apply_ms:.4f}, "
               f"split {split_ms:.4f}; bound {a_bound[0]:.4f} by {a_bound[1]}, its six split "
               f"products at the bf16 peak {cs.bound_ms(0, 6 * 2 * n * m * m)[0]:.4f}; "
               "torch.matmul gd @ kvs^T, v @ P^T, k @ P "
               + ", ".join(f"{t:.4f}" for t in apply_matmul_ms.values())
               + f", together {sum(apply_matmul_ms.values()):.4f}), "
               f"bwd_reduce {r_ms:.4f} ms (bound {r_bound[0]:.4f} by "
               f"{r_bound[1]}; rows pass {rows_ms:.4f}, bound {rows_bound[0]:.4f} by "
               f"{rows_bound[1]}, torch.matmul q @ kvs {rows_matmul_ms:.4f}; P pass {p_ms:.4f}, "
               f"bound {p_bound[0]:.4f} by {p_bound[1]}, torch.matmul q^T gd {p_matmul_ms:.4f}; "
               f"split, finish and dinv {others_ms:.4f}); bitwise repeatable {repeat}; "
               "|kernel - plain in f64| / scale: "
               + ", ".join(f"{p} {e:.2e}" for p, e in errs.items()))
        del q, k, v, g, sums, red, gd, kvs_b, P_b
        torch.cuda.empty_cache()
    for n, m_, d_ in BF16_DIGEST_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(n + m_ + d_)
        q, k = (torch.randn(n, m_, generator=gen, device=dev).bfloat16() for _ in range(2))
        v, g = (torch.randn(n, d_, generator=gen, device=dev).bfloat16() for _ in range(2))
        n_t = torch.full((), float(n), device=dev)
        sums = attn.reduce_plain(q, k, v, False)
        red = attn.bwd_reduce_plain(q, v, g, *sums, n_t, False)
        sha = digest((*attn.bwd_reduce(q, v, g, *sums, n_t),
                      *attn.bwd_apply(q, k, v, g, *sums, n_t, *red)))
        out["bf16_digests"].append(dict(shape=[n, m_, d_], sha256=sha))
        cs.log(f"bf16-bwd {root} bf16 n={n} m={m_} d={d_}: bwd_reduce and bwd_apply outputs "
               f"sha256 {sha}")
        del q, k, v, g, sums, red
    for n in BF16_REDUCE_DIGEST_ROWS:
        sha = digest(attn.bwd_reduce(*(t.to(dev) for t in host_bf16_inputs(n))))
        out["bf16_reduce_digests"][str(n)] = sha
        cs.log(f"bf16-bwd {root} bf16 bwd_reduce n={n} (host-made inputs): outputs sha256 {sha}")
    for n in BF16_APPLY_DIGEST_ROWS:
        q, k, v, g, sums, n_t = host_attention_inputs(n, torch.bfloat16)
        red = attn.bwd_reduce_plain(q, v, g, *sums, n_t, False)
        sha = digest(attn.bwd_apply(*(t.to(dev) for t in (q, k, v, g, *sums, n_t, *red[:3])),
                                    red[3].to(dev)))
        out["bf16_apply_digests"][str(n)] = sha
        cs.log(f"bf16-bwd {root} bf16 bwd_apply n={n} (host-made inputs): outputs sha256 {sha}")
    for n, m_, d_ in F32_DIGEST_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(n + m_ + d_)
        q, k = (torch.randn(n, m_, generator=gen, device=dev) for _ in range(2))
        v, g = (torch.randn(n, d_, generator=gen, device=dev) for _ in range(2))
        n_t = torch.full((), float(n), device=dev)
        sums = attn.reduce_plain(q, k, v, False)
        red = attn.bwd_reduce_plain(q, v, g, *sums, n_t, False)
        sha = digest((*attn.bwd_reduce(q, v, g, *sums, n_t),
                      *attn.bwd_apply(q, k, v, g, *sums, n_t, *red)))
        out["f32_digests"].append(dict(shape=[n, m_, d_], sha256=sha))
        cs.log(f"bf16-bwd {root} f32 n={n} m={m_} d={d_}: outputs sha256 {sha}")
        del q, k, v, g, sums, red
    print(json.dumps(out), flush=True)
    return 0


def bwd_reduce_errors(cs, attn, got, ins) -> dict:
    """The f32 backward reduce's outputs ``got`` on ``ins`` (its arguments)
    against its plain version in f64, each over its tolerance: P, ds, den
    and gden over REDUCE_REL_TOL of their scale, dinv over REDUCE_REL_TOL
    of its two sums' magnitude."""
    ind = [t.double() for t in ins]
    exact = attn.bwd_reduce_plain(*ind, False)
    errs = {part: rel(a, b) / cs.REDUCE_REL_TOL
            for part, a, b in zip(("P", "ds"), got[:2], exact[:2])}
    errs["rows"] = rel(got[3], exact[3]) / cs.REDUCE_REL_TOL
    qd, _, gd_, kvs, ksum = ind[:5]
    den, gden = exact[3]
    sums = ((gd_ / den[:, None] * (qd @ kvs)).abs().sum()
            + (gden * (qd @ ksum)).abs().sum()).item()
    errs["dinv"] = abs(got[2].item() - exact[2].item()) / sums / cs.REDUCE_REL_TOL
    return errs


def tf32_bwd_turn(cs, root: str) -> int:
    """One turn of the ``tf32-bwd`` mode on ROOT's package; its last line
    of output is a JSON object of its numbers."""
    import json
    import re

    import torch

    from sgformer_tpu_torch.kernels import _build
    from sgformer_tpu_torch.kernels import attention as attn

    # this checkout's inputs whatever ROOT's package holds
    inputs = load_phases(os.path.join(HERE, "sgformer_tpu_torch", "utils", "measure.py"))
    report = _build.build_all(("linear_attention_bwd", "linear_attention")).get(
        "linear_attention_bwd", "")
    entry = False
    for line in report.splitlines():  # the f32 kernels' registers, spills and warnings
        if "entry function" in line or "Function properties" in line:
            entry = bool(re.search(r"la_bwd_(apply|rows|reduce)_(tc|wg|ws|tf32)_", line)) \
                if "entry function" in line else entry
        if entry or "warning" in line:
            cs.log(f"ptxas {root}: {line.strip()}")
    dev = "cuda"
    sass = {lib: sass_counts(cs, root, lib, "") for lib in ("linear_attention_bwd",
                                                          "linear_attention")}
    out = dict(root=root, sass=sass, f32={}, bf16_digests=[], ok=True,
               design=attn.bwd_reduce_design(torch.float32, 256, 256),
               apply_design=attn.bwd_apply_design(torch.float32, 256, 256))
    cs.log(f"tf32-bwd {root} designs at M = D = 256: reduce {out['design']}; apply "
           f"{out['apply_design']}")
    passes = F32_ROWS + F32_P_PASS + F32_REDUCE_OTHERS
    applies = F32_APPLY + F32_APPLY_SPLIT
    m = d = 256
    tail = ("amazon2m-batch tail", cs.AMAZON2M["num_nodes"] % cs.AMAZON2M_BATCH)
    for name, n in cs.BWD_PASS_SHAPES + (tail,):
        gen = torch.Generator(device=dev).manual_seed(21)
        q, k, v, g = (torch.randn(n, m, generator=gen, device=dev) for _ in range(4))
        n_t = torch.full((), float(n), device=dev)
        sums = attn.reduce_plain(q, k, v, False)
        red = attn.bwd_reduce_plain(q, v, g, *sums, n_t, False)
        got_r = attn.bwd_reduce(q, v, g, *sums, n_t)
        errs = bwd_reduce_errors(cs, attn, got_r, (q, v, g, *sums, n_t))
        repeat = all(torch.equal(a, b) for a, b in zip(got_r, attn.bwd_reduce(q, v, g, *sums, n_t)))
        gd = g / got_r[3][0][:, None]
        del got_r
        got_a = attn.bwd_apply(q, k, v, g, *sums, n_t, *red)
        exact = attn.bwd_apply_plain(*(t.double() for t in (q, k, v, g, *sums, n_t, *red)), False)
        errs.update({part: rel(a, b) / cs.BWD_REL_TOL[torch.float32]
                     for part, a, b in zip(("dq", "dk", "dv"), got_a, exact)})
        repeat = repeat and all(torch.equal(a, b) for a, b in
                                zip(got_a, attn.bwd_apply(q, k, v, g, *sums, n_t, *red)))
        del got_a, exact
        # the reduce where P's products carry it (a dropped tf32 lo piece
        # of q or of g/den misses the tolerance)
        ins = inputs.bwd_reduce_product_inputs(n, m, d, torch.float32,
                                               torch.Generator(device=dev).manual_seed(9))
        got_p = attn.bwd_reduce(*ins)
        errs.update({f"{part} (products carry P)": e for part, e in
                     bwd_reduce_errors(cs, attn, got_p, ins).items()})
        repeat = repeat and all(torch.equal(a, b) for a, b in zip(got_p, attn.bwd_reduce(*ins)))
        del ins, got_p
        if not (max(errs.values()) <= 1.0 and repeat):
            out["ok"] = False
            cs.log(f"tf32-bwd {root} {name}: OUT OF TOLERANCE OR NOT REPEATABLE")
        a_ms = cs.time_ms(lambda: attn.bwd_apply(q, k, v, g, *sums, n_t, *red))
        r_ms = cs.time_ms(lambda: attn.bwd_reduce(q, v, g, *sums, n_t))
        r_dev = cs.kernel_ms(lambda: attn.bwd_reduce(q, v, g, *sums, n_t), passes)
        a_dev = cs.kernel_ms(lambda: attn.bwd_apply(q, k, v, g, *sums, n_t, *red), applies)
        rows_ms = sum(r_dev[p] for p in F32_ROWS)
        p_ms = sum(r_dev[p] for p in F32_P_PASS)
        apply_ms = sum(a_dev[p] for p in F32_APPLY)
        # yardstick: P's product in one torch.matmul, f32, TF32 off (never
        # called by the port); and the P pass's bound
        p_matmul_ms = cs.time_ms(lambda: torch.matmul(q.t(), gd))
        p_bound_ms, p_bound_by = cs.bound_ms((n * m + n * d) * 4 + 2 * n * 4 + (m * d + m) * 4,
                                             2 * n * m * d, torch.float32)
        # yardstick: the apply's three products gd @ kvs^T, v @ P^T and k @ P,
        # each one torch.matmul in f32 (TF32 off); and the apply's bound (as
        # chip_smoke.attention_bwd_phase counts it)
        kvs_t, P_t = sums[0], red[0]
        gd_a = g / red[3][0][:, None]
        a_matmul_ms = cs.time_ms(lambda: (torch.matmul(gd_a, kvs_t.t()),
                                          torch.matmul(v, P_t.t()), torch.matmul(k, P_t)))
        small = (2 * m * d + 2 * m + 6) * 4
        a_bound_ms, a_bound_by = cs.bound_ms(7 * n * m * 4 + 2 * small + 2 * n * 4,
                                             6 * n * m * d + 8 * n * m + 3 * n * d, torch.float32)
        del kvs_t, P_t, gd_a
        # the rows pass's own bound: a = q @ kvs (3xTF32) reading q, v, g and
        # writing den and gden
        rows_bound_ms, rows_bound_by = cs.bound_ms(3 * n * m * 4 + 2 * n * 4 + (m * d + m) * 4,
                                                   2 * n * m * d, torch.float32)
        # yardstick: the rows pass's product a = q @ kvs in one torch.matmul,
        # f32, TF32 off (never called by the port)
        rows_matmul_ms = cs.time_ms(lambda: torch.matmul(q, sums[0]))
        out["f32"][name] = dict(n=n, bwd_apply_ms=a_ms, bwd_reduce_ms=r_ms, rows_ms=rows_ms,
                                rows_bound_ms=rows_bound_ms, rows_bound_by=rows_bound_by,
                                rows_matmul_ms=rows_matmul_ms,
                                p_pass_ms=p_ms, p_pass_matmul_ms=p_matmul_ms,
                                p_pass_bound_ms=p_bound_ms, p_pass_bound_by=p_bound_by,
                                reduce_others_ms=sum(r_dev[p] for p in F32_REDUCE_OTHERS),
                                apply_kernel_ms=apply_ms,
                                apply_split_ms=sum(a_dev[p] for p in F32_APPLY_SPLIT),
                                apply_matmul_ms=a_matmul_ms, apply_bound_ms=a_bound_ms,
                                apply_bound_by=a_bound_by, err_over_tol=errs,
                                bitwise_repeatable=repeat)
        cs.log(f"tf32-bwd {root} {name} n={n}: bwd_apply {a_ms:.4f} ms (kernel {apply_ms:.4f}; "
               f"torch.matmul gd @ kvs^T + v @ P^T + k @ P {a_matmul_ms:.4f}, bound "
               f"{a_bound_ms:.4f} by {a_bound_by}), "
               f"bwd_reduce {r_ms:.4f} ms (rows pass {rows_ms:.4f}, bound {rows_bound_ms:.4f} by "
               f"{rows_bound_by}, torch.matmul q @ kvs {rows_matmul_ms:.4f}; P pass {p_ms:.4f}; "
               f"torch.matmul q^T gd {p_matmul_ms:.4f}, P pass bound {p_bound_ms:.4f} by "
               f"{p_bound_by}); bitwise repeatable {repeat}; errors over the tolerance: "
               + ", ".join(f"{p} {e:.3f}" for p, e in errs.items()))
        del q, k, v, g, sums, red, gd
        torch.cuda.empty_cache()
    out["f32_reduce_digests"] = {}
    for n in F32_REDUCE_DIGEST_ROWS:
        q, _, v, g, sums, n_t = host_attention_inputs(n)
        sha = digest(attn.bwd_reduce(*(t.to(dev) for t in (q, v, g, *sums, n_t))))
        out["f32_reduce_digests"][str(n)] = sha
        cs.log(f"tf32-bwd {root} f32 bwd_reduce n={n} (host-made inputs): outputs sha256 {sha}")
    for n, m_, d_ in BF16_DIGEST_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(n + m_ + d_)
        q, k = (torch.randn(n, m_, generator=gen, device=dev).bfloat16() for _ in range(2))
        v, g = (torch.randn(n, d_, generator=gen, device=dev).bfloat16() for _ in range(2))
        n_t = torch.full((), float(n), device=dev)
        sums = attn.reduce_plain(q, k, v, False)
        red = attn.bwd_reduce_plain(q, v, g, *sums, n_t, False)
        sha = digest((*attn.bwd_reduce(q, v, g, *sums, n_t),
                      *attn.bwd_apply(q, k, v, g, *sums, n_t, *red)))
        if (n, m_, d_) == (169_343, 256, 256):
            out["bf16_arxiv_ms"] = dict(
                bwd_apply=cs.time_ms(lambda: attn.bwd_apply(q, k, v, g, *sums, n_t, *red)),
                bwd_reduce=cs.time_ms(lambda: attn.bwd_reduce(q, v, g, *sums, n_t)))
        out["bf16_digests"].append(dict(shape=[n, m_, d_], sha256=sha))
        cs.log(f"tf32-bwd {root} bf16 n={n} m={m_} d={d_}: outputs sha256 {sha}")
        del q, k, v, g, sums, red
    print(json.dumps(out), flush=True)
    return 0


# the schedule mode's widths beside SWEEP_WIDTHS: on the reordered arxiv
# graph and on the power-law graph both ways
SCHEDULE_WIDTHS = (40, 256)
# the kernels of a csr_spmm or csr_spmm_ev call, whose device ms the mode
# reads from the profiler beside the call's CUDA-event ms
WALK_KERNELS = ("csr_spmm_kernel", "csr_spmm_hub_kernel")


def schedule(root: str) -> int:
    """The ``schedule`` mode: four turns, each ``schedule-turn`` in a
    process of its own, then each call's turns side by side; fails unless
    every output is bitwise the same in every turn."""
    import json

    turns = run_turns("schedule-turn", root)
    if turns is None:
        return 1
    names = ["ROOT" if t["root"] == root else "this checkout" for t in turns]
    side, same = {}, True
    for key in turns[1]["calls"]:
        base = key.removesuffix(" [no walk order]")
        rows = [t["calls"].get(key) or t["calls"].get(base) for t in turns]
        if any(r is None for r in rows):
            continue
        equal = len({r["sha256"] for r in rows}) == 1
        same &= equal
        side[key] = dict(ms=[r["ms"] for r in rows], device_ms=[r["device_ms"] for r in rows],
                         library_ms=rows[0]["library_ms"],
                         gather_tb_per_s=[r["gather_tb_per_s"] for r in rows],
                         bitwise_equal=equal)
        print(f"schedule {key}: " + ", ".join(f"{n} {r['ms']:.4f}" for n, r in zip(names, rows))
              + " ms (device " + ", ".join(f"{r['device_ms']:.4f}" for r in rows)
              + f"); torch.sparse.mm {rows[0]['library_ms']}; "
              + ("bitwise equal" if equal else "OUTPUTS DIFFER"), flush=True)
    for i, t in enumerate(turns):
        print(f"schedule set-up, turn {i} ({names[i]}): {json.dumps(t['setup'])}", flush=True)
    print(json.dumps({"schedule_turns": side, "turns": names, "all_bitwise_equal": same}),
          flush=True)
    return 0 if same else 1


def schedule_turn(cs, root: str, dev: str = "cuda") -> int:
    """One turn of the ``schedule`` mode on ROOT's package; its last line
    of output is a JSON object of its numbers."""
    import hashlib
    import inspect
    import json
    import time
    import warnings

    import numpy as np
    import torch

    from sgformer_tpu_torch import preprocess_graph
    from sgformer_tpu_torch.data import synthetic_dataset
    from sgformer_tpu_torch.graph import add_self_loops, remove_self_loops, to_undirected
    from sgformer_tpu_torch.kernels import _build
    from sgformer_tpu_torch.kernels import spmm as k
    from sgformer_tpu_torch.ops.spmm import spmm as spmm_plain
    from sgformer_tpu_torch.ops.spmm import spmm_edge_values
    from sgformer_tpu_torch.sample import CSRGraph, NeighborSampler
    from sgformer_tpu_torch.train import build_sampled_graph, build_subgraph_batch

    if dev == "cuda":
        _build.build_all(("spmm",))
    ordered = "schedule" in inspect.signature(k.csr_spmm).parameters
    out = dict(root=root, walk_orders=ordered, calls={}, setup={})

    def digest(t) -> str:
        return hashlib.sha256(t.contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
                              .tobytes()).hexdigest()[:16]

    def orders(order):
        """(key suffix, keyword arguments) of each walk a call is timed in."""
        if not ordered:
            return [("", {})]
        return [("", {"schedule": order})] + (
            [(" [no walk order]", {"schedule": None})] if order is not None else [])

    def timed(key, run, plain, tol, gathered, library, kernels=WALK_KERNELS):
        got = run()
        err = None
        if plain is not None:
            want = plain()
            torch.cuda.synchronize()
            err = cs.check_close(key, got, want, **tol)
            del want
        again = run()
        if not all(torch.equal(a, b) for a, b in zip(
                got if isinstance(got, tuple) else (got,),
                again if isinstance(again, tuple) else (again,))):
            raise AssertionError(f"{key} is not bitwise repeatable")
        sha = digest(torch.cat([t.reshape(-1).float() for t in got])
                     if isinstance(got, tuple) else got)
        del got, again
        ms = cs.time_ms(run)
        device_ms = sum(cs.kernel_ms(run, kernels).values())
        lib_ms = cs.library_time(f"torch.sparse.mm {key}", library) if library else None
        out["calls"][key] = dict(ms=ms, device_ms=device_ms, library_ms=lib_ms, sha256=sha,
                                 max_abs_err=err, gather_tb_per_s=gathered / ms / 1e9)
        cs.log(f"schedule {root} {key}: {ms:.4f} ms ({device_ms:.4f} ms on the device), "
               f"gathers {gathered / 1e6:.1f} MB of rows at {gathered / ms / 1e9:.2f} TB/s; "
               f"torch.sparse.mm {lib_ms} ms; sha256 {sha}")

    def sparse(indptr, src, w, n_rows, n_cols):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            return torch.sparse_csr_tensor(indptr, src, w, size=(n_rows, n_cols))

    def spmm_calls(where, g, widths, dtypes=(torch.bfloat16, torch.float32), transposed=False):
        if transposed:
            csr = (g.t_indptr, g.t_edge_src, g.t_edge_dst, g.t_weight)
            plan, order = g.t_hub_segments, getattr(g, "t_schedule", None)
            if order is None and g.symmetric:
                order = getattr(g, "schedule", None)
        else:
            csr = (g.indptr, g.edge_src, g.edge_dst, g.gcn_weight)
            plan, order = g.hub_segments, getattr(g, "schedule", None)
        n, e = g.num_nodes, g.num_edges
        gen = torch.Generator(device=dev).manual_seed(22)
        for f in widths:
            x32 = torch.randn(n, f, generator=gen, device=dev)
            for dtype in dtypes:
                x, name = x32.to(dtype), cs.DTYPE_NAME[dtype]
                a = sparse(csr[0], csr[1], csr[3].to(dtype), n, n)
                for suffix, kw in orders(order):
                    timed(f"{where} csr_spmm {name} F={f}{suffix}",
                          lambda: k.csr_spmm(x, *csr, plan, g.hub_edges, **kw),
                          lambda: spmm_plain(x, *csr[1:], n), cs.TOL[dtype],
                          e * f * x.element_size(), lambda: torch.sparse.mm(a, x))
                del x, a
            del x32
            torch.cuda.empty_cache()

    def setup_graph(what, data, **kw):
        ds = synthetic_dataset(**data)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        g = preprocess_graph(ds.graph["edge_index"], ds.num_nodes, **kw)
        torch.cuda.synchronize()
        out["setup"][f"{what} preprocess_graph s"] = time.perf_counter() - t
        out["setup"][f"{what} preprocess_graph peak MiB"] = (
            (torch.cuda.max_memory_allocated() - base) / 2 ** 20)
        if ordered and "reorder" not in kw:
            from sgformer_tpu_torch.native.reorder import reorder_for_clusters

            edges = torch.stack([g.edge_src, g.edge_dst]).cpu().numpy()
            t = time.perf_counter()
            reorder_for_clusters(edges, g.num_nodes)
            out["setup"][f"{what} walk order (clustering) s"] = time.perf_counter() - t
        cs.log(f"schedule {root} set-up {what}: "
               + ", ".join(f"{k_}: {v:.3f}" for k_, v in out["setup"].items()
                           if k_.startswith(what + " ")))
        return ds, g

    # step 0's measured case and the sweep: synth-arxiv as it comes and
    # reordered; the power-law bench graph both ways
    ds, graph = setup_graph("arxiv", dict(name="synth-arxiv", seed=0), chunk_dtype="bf16")
    spmm_calls("arxiv", graph, cs.SWEEP_WIDTHS)
    n, e = graph.num_nodes, graph.num_edges
    csr = (graph.indptr, graph.edge_src, graph.edge_dst)
    gen = torch.Generator(device=dev).manual_seed(23)
    for heads, d in cs.SWEEP_EV_SHAPES:
        x32 = torch.randn(n, heads, d, generator=gen, device=dev)
        v = torch.rand(e, heads, generator=gen, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            x, name = x32.to(dtype), cs.DTYPE_NAME[dtype]
            mats = [sparse(graph.indptr, graph.edge_src, v[:, h].to(dtype), n, n)
                    for h in range(heads)]
            cols = [x[:, h].contiguous() for h in range(heads)]
            for suffix, kw in orders(getattr(graph, "schedule", None)):
                timed(f"arxiv csr_spmm_ev {name} H={heads} D={d}{suffix}",
                      lambda: k.csr_spmm_ev(x, *csr, v, torch.float32, graph.hub_segments,
                                            graph.hub_edges, **kw),
                      lambda: spmm_edge_values(x, *csr[1:], v, n, torch.float32),
                      cs.TOL[torch.float32], e * heads * d * x.element_size(),
                      lambda: [torch.sparse.mm(a, c) for a, c in zip(mats, cols)])
            del x, mats, cols
        del x32, v
        torch.cuda.empty_cache()
    t_csr = (graph.t_indptr, graph.t_edge_src, graph.t_edge_dst, graph.t_perm)
    for heads, d in cs.GAT_LAYERS:
        x = torch.randn(n, heads, d, generator=gen, device=dev)
        g_ = torch.randn(n, heads, d, generator=gen, device=dev)
        v = torch.rand(e, heads, generator=gen, device=dev)
        t_order = getattr(graph, "t_schedule", None)
        if t_order is None:
            t_order = getattr(graph, "schedule", None)
        for suffix, kw in orders(t_order):
            kw = {"t_schedule": kw["schedule"]} if kw else {}
            timed(f"arxiv csr_spmm_ev_bwd bf16 messages H={heads} D={d}{suffix}",
                  lambda: k.csr_spmm_ev_bwd(g_, x, v, *t_csr, torch.bfloat16,
                                            graph.t_hub_segments, graph.hub_edges, **kw),
                  None, None, e * heads * d * 4, None, ("ev_bwd_kernel", "csr_spmm_hub_kernel"))
        del x, g_, v
        torch.cuda.empty_cache()
    edges = torch.stack([graph.edge_src, graph.edge_dst])
    del graph
    torch.cuda.empty_cache()
    _, rgraph = setup_graph("arxiv reordered", dict(name="synth-arxiv", seed=0),
                            chunk_dtype="bf16", reorder=True)
    spmm_calls("arxiv reordered", rgraph, SCHEDULE_WIDTHS)
    del rgraph, ds
    for what, kw in (("power-law", {}), ("power-law reordered", {"reorder": True})):
        pl, pl_graph = setup_graph(what, cs.POWERLAW_GRAPH, **kw)
        spmm_calls(what, pl_graph, SCHEDULE_WIDTHS)
        del pl, pl_graph
        torch.cuda.empty_cache()

    # the batch tiers' subgraphs (no walk order) and one sampled batch
    am = synthetic_dataset(**cs.AMAZON2M, device=dev)
    ei = torch.from_numpy(am.graph["edge_index"]).to(dev)
    ei = add_self_loops(remove_self_loops(to_undirected(ei)), am.num_nodes).int()
    for what, ed, nodes, b in (("arxiv-batch", edges, n, cs.ARXIV_BATCH),
                               ("amazon2m-batch", ei, am.num_nodes, cs.AMAZON2M_BATCH)):
        perm = torch.from_numpy(np.random.default_rng(0).permutation(nodes)).to(dev)
        for idx in (perm[:b], perm[nodes // b * b:]):
            spmm_calls(f"{what} n={idx.numel()}", build_subgraph_batch(ed, idx, nodes), (256,))
    del am, ei, edges
    torch.cuda.empty_cache()
    pd = synthetic_dataset(**cs.PAPERS, device=dev)
    ei = torch.from_numpy(pd.graph["edge_index"]).to(dev)
    ei = add_self_loops(remove_self_loops(to_undirected(ei)), pd.num_nodes)
    papers = CSRGraph.from_edge_index(ei, pd.num_nodes)
    del ei
    torch.cuda.empty_cache()
    seeds = np.random.default_rng(0).permutation(pd.num_nodes)[:cs.PAPERS_TRAIN["batch_size"]]
    sampler = NeighborSampler(papers, pd.num_nodes, cs.PAPERS_TRAIN["fanouts"],
                              cs.PAPERS_TRAIN["batch_size"], seed=0)
    graph_b = build_sampled_graph(sampler.sample(seeds), dev)
    for transposed in (False, True):
        spmm_calls(f"papers-sampled{' A^T' if transposed else ' A'}", graph_b, (256,),
                   (torch.float32,), transposed)
    print(json.dumps(out), flush=True)
    return 0


def rows_turn(cs, root: str) -> int:
    """One turn of the ``rows`` mode on ROOT's package: the f32 rows pass's
    ``ptxas`` registers and spills, its device ms by the profiler at M = D
    = 256 on the arxiv, amazon2m batch, papers-sampled and amazon2m tail
    rows (``bwd_reduce`` on randn, 20 calls), and the f32 reduce's digests
    on host-made inputs; its last line of output is a JSON object."""
    import json

    import torch

    from sgformer_tpu_torch.kernels import _build
    from sgformer_tpu_torch.kernels import attention as attn

    report = _build.build_all(("linear_attention_bwd",)).get("linear_attention_bwd", "")
    out = dict(root=root, ptxas=[], ms={}, digests={})
    entry = False
    for line in report.splitlines():
        if "entry function" in line:
            entry = "la_bwd_rows_w" in line
        if (entry and ("spill" in line or "Used" in line or "C75" in line)) or "warning" in line:
            out["ptxas"].append(line.strip())
    tail = ("amazon2m-batch tail", cs.AMAZON2M["num_nodes"] % cs.AMAZON2M_BATCH)
    for name, n in cs.BWD_PASS_SHAPES + (tail,):
        gen = torch.Generator(device="cuda").manual_seed(21)
        q, k, v, g = (torch.randn(n, 256, generator=gen, device="cuda") for _ in range(4))
        n_t = torch.full((), float(n), device="cuda")
        sums = attn.reduce_plain(q, k, v, False)
        dev_ms = cs.kernel_ms(lambda: attn.bwd_reduce(q, v, g, *sums, n_t), F32_ROWS)
        out["ms"][name] = sum(dev_ms.values())
        del q, k, v, g, sums
        torch.cuda.empty_cache()
    for n in F32_REDUCE_DIGEST_ROWS:
        q, _, v, g, sums, n_t = host_attention_inputs(n)
        out["digests"][str(n)] = digest(attn.bwd_reduce(*(t.cuda() for t in (q, v, g, *sums,
                                                                               n_t))))
    print(json.dumps(out), flush=True)
    return 0


def bf16_apply(roots: list) -> int:
    """The ``bf16-apply`` mode: ``bf16-apply-turn`` on each ROOT in the
    order given, each a process of its own; each turn's device ms, and
    whether each of its digests equals the first turn's."""
    turns = run_turns("bf16-apply-turn", roots[0], roots)
    if turns is None:
        return 1
    for t in turns:
        same = {key: (all(a == b for a, b in zip(v, turns[0]["digests"][key]))
                      if isinstance(v, list) else v == turns[0]["digests"][key])
                for key, v in t["digests"].items()}
        print(f"bf16-apply {t['root']}: device ms {t['ms']}; digests equal to the first turn's: "
              f"{same}", flush=True)
    return 0


# the bf16-apply mode's digested inputs: (N, M, D, view) on randn rows
BF16_APPLY_VIEWS = ((777, 256, 256, "contiguous"), (60_000, 200, 37, "aligned head"),
                    (60_000, 64, 64, "strided"), (777, 130, 200, "contiguous"))


def bf16_apply_turn(cs, root: str) -> int:
    """One turn of the ``bf16-apply`` mode on ROOT's package: the bf16
    backward apply's ``ptxas`` registers and spills, its kernel's device ms
    by the profiler (20 calls) at M = D = 256 on the arxiv, large-400K and
    amazon2m tail rows (randn), and sha256 digests of dq, dk and dv on
    randn rows at ``BF16_APPLY_VIEWS`` and of the outputs on host-made
    inputs (``host_attention_inputs``, N = 2,000 and 60,000); its last line
    of output is a JSON object (the design A/Bs of a bf16 apply redesign, on
    copies with one change each)."""
    import json

    import torch

    from sgformer_tpu_torch.kernels import _build
    from sgformer_tpu_torch.kernels import attention as attn

    report = _build.build_all(("linear_attention_bwd",)).get("linear_attention_bwd", "")
    out = dict(root=root, ptxas=[], digests={}, ms={})
    entry = False
    for line in report.splitlines():
        if "entry function" in line:
            entry = "la_bwd_apply_w" in line
        elif entry and ("Used" in line or "spill" in line) or "warning" in line:
            out["ptxas"].append(line.strip())
    for n, m, d, view in BF16_APPLY_VIEWS:
        gen = torch.Generator(device="cuda").manual_seed(n + m + d)
        q, k, v, g = (torch.randn(n, w, generator=gen, device="cuda").bfloat16()
                      for w in (m, m, d, d))
        sums = attn.reduce_plain(q, k, v, False)
        n_t = torch.full((), float(n), device="cuda")
        red = attn.bwd_reduce_plain(q, v, g, *sums, n_t, False)
        if view != "contiguous":  # head 1 of [N, 2, w + pad]
            pad = 8 if view == "aligned head" else 3
            q, k, v, g = (torch.empty(n, 2, t.shape[1] + pad, dtype=t.dtype, device="cuda")
                          [:, 1, :t.shape[1]].copy_(t) for t in (q, k, v, g))
        out["digests"][f"{n}x{m}x{d} {view}"] = [
            digest((t,)) for t in attn.bwd_apply(q, k, v, g, *sums, n_t, *red)]
    for n in BF16_APPLY_DIGEST_ROWS:
        q, k, v, g, sums, n_t = host_attention_inputs(n, torch.bfloat16)
        red = attn.bwd_reduce_plain(q, v, g, *sums, n_t, False)
        out["digests"][f"host {n}"] = digest(attn.bwd_apply(
            *(t.cuda() for t in (q, k, v, g, *sums, n_t, *red[:3])), red[3].cuda()))
    for name, n in (("arxiv", 169_343), ("large-400K", 400_000), ("amazon2m tail", 49_029)):
        gen = torch.Generator(device="cuda").manual_seed(23)
        q, k, v, g = (torch.randn(n, 256, generator=gen, device="cuda").bfloat16()
                      for _ in range(4))
        n_t = torch.full((), float(n), device="cuda")
        sums = attn.reduce_plain(q, k, v, False)
        red = attn.bwd_reduce_plain(q, v, g, *sums, n_t, False)
        dev_ms = cs.kernel_ms(lambda: attn.bwd_apply(q, k, v, g, *sums, n_t, *red), BF16_APPLY)
        out["ms"][name] = sum(dev_ms.values())
        del q, k, v, g, sums, red
        torch.cuda.empty_cache()
    cs.log(f"bf16-apply {root}: ptxas {out['ptxas']}; device ms {out['ms']}")
    print(json.dumps(out), flush=True)
    return 0


# The bf16-apply-trace mode's stamps in la_bwd_apply_ws16_kernel: each a
# line of its source (unique in the kernel), the tag written at it, and
# whether the stamp goes before the line; roles: 0 and 1 the consumer
# warpgroups' first threads, 2 the producer's ring lane, 3 its A lane
APPLY_TRACE_STAMPS = (
    ("            if (e >= kAsStages) mbar_wait(empty + st, (e / kAsStages - 1) & 1);",
     "if (lane == 0) TRACE(2, c < kch ? 1 : 2);", True),
    ("            if (e >= kAsStages) mbar_wait(empty + st, (e / kAsStages - 1) & 1);",
     "if (lane == 0) TRACE(2, 3);", False),
    ("          if (i > 0) mbar_wait(aempty + j, (i - 1) & 1);", "if (lane == 0) TRACE(3, 4);", True),
    ("          if (i > 0) mbar_wait(aempty + j, (i - 1) & 1);", "if (lane == 0) TRACE(3, 5);", False),
    ("    const int tiles = at.tiles(w);", "if (leader) TRACE(wg, 10);", False),
    ("        mbar_wait(full + st, (e / kAsStages) & 1);", "if (leader) TRACE(wg, 11);", True),
    ("        if (t == 0) mbar_wait(afull + kc, i & 1);", "if (leader) TRACE(wg, 12);", False),
    ("      mbar_wait(full + st0, (e / kAsStages) & 1);", "if (leader) TRACE(wg, 13);", True),
    ("      mbar_wait(full + st0, (e / kAsStages) & 1);", "if (leader) TRACE(wg, 14);", False),
    ("      fin(H0{}, H0{}, X0);", "if (leader) TRACE(wg, 15);", True),
    ("      fin(H0{}, H0{}, X0);", "if (leader) TRACE(wg, 16);", False),
    ("      fin(H0{}, H1{}, X0);", "if (leader) TRACE(wg, 17);", True),
    ("      store(0, st0, X0);", "if (leader) TRACE(wg, 18);", False),
    ("        store(1, st1, X1);", "if (leader) TRACE(wg, 19);", False),
)
# the spans between consecutive stamps of a consumer warpgroup
APPLY_TRACE_SPANS = {
    (10, 11): "an item's set-up", (11, 12): "waiting for a chunk's B (and, tile 0, A slot)",
    (12, 11): "a chunk's MMAs, issued and drained", (12, 13): "the tile's last chunk issued",
    (13, 14): "waiting for the operand's first half", (14, 15): "waiting for sum 0's MMAs",
    (15, 16): "epilogue, sum 0, first half", (16, 17): "waiting for sum 1's MMAs",
    (17, 18): "epilogue, sum 1, first half, its store",
    (18, 19): "second half: its wait, both sums, its store", (19, 11): "to the next tile",
    (19, 10): "to the next item"}
APPLY_TRACE_HELPER = r"""
__device__ long long g_apply_trace[2][4][4096];
#define TRACE(role, tag)                                                                    \
  do {                                                                                      \
    const int sel_ = blockIdx.x == 0 ? 0 : (blockIdx.x == 2 ? 1 : -1);                      \
    if (sel_ >= 0 && trace_n_ < 4096) {                                                     \
      g_apply_trace[sel_][role][trace_n_++] =                                               \
          (static_cast<long long>(tag) << 48) | (clock64() & 0xFFFFFFFFFFFFLL);             \
    }                                                                                       \
  } while (0)
"""
APPLY_TRACE_COPY = r"""
extern "C" int sgf_apply_trace_copy(void* dst) {
  cudaError_t e = cudaMemcpyFromSymbol(dst, g_apply_trace, sizeof(g_apply_trace));
  if (e != cudaSuccess) return e;
  void* p = nullptr;
  e = cudaGetSymbolAddress(&p, g_apply_trace);
  return e != cudaSuccess ? e : cudaMemset(p, 0, sizeof(g_apply_trace));
}
"""


def apply_trace(root: str) -> int:
    """The ``bf16-apply-trace`` mode: ROOT's package copied into this
    checkout's ``build/apply-trace/``, its ``la_bwd_apply_ws16_kernel``
    stamped with the SM's clock (clock64) at ``APPLY_TRACE_STAMPS`` (blocks
    0 and 2: the consumer warpgroups' first threads, the producer's two
    issuing lanes; one global store a stamp, the count in a register), one
    arxiv-shaped call (M = D = 256, N = 169,343) traced in a process of its
    own, then each consumer warpgroup's cycles by span
    (``APPLY_TRACE_SPANS``) and share of its time. The stamps move the
    kernel's time by a few per cent."""
    import json
    import shutil
    import subprocess

    src = os.path.join(root, "sgformer_tpu_torch")
    dst = os.path.join(HERE, "build", "apply-trace")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, os.path.join(dst, "sgformer_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    path = os.path.join(dst, "sgformer_tpu_torch", "csrc", "linear_attention_bwd.cu")
    code = open(path).read()
    a = code.index("la_bwd_apply_ws16_kernel(const bf16")
    b = code.index("\n}\n", a)
    kernel = code[a:b].replace("  const int warp = tid >> 5;\n",
                               "  const int warp = tid >> 5;\n  int trace_n_ = 0;\n", 1)
    for line, stamp, before in APPLY_TRACE_STAMPS:
        if kernel.count(line + "\n") != 1:
            print(f"chip_compare: the trace's line is not once in the kernel: {line!r}",
                  file=sys.stderr)
            return 1
        kernel = kernel.replace(line + "\n", f"{stamp}\n{line}\n" if before else f"{line}\n{stamp}\n")
    head = code.rindex("__global__", 0, a)
    code = code[:head] + APPLY_TRACE_HELPER + code[head:a] + kernel + code[b:] + APPLY_TRACE_COPY
    open(path, "w").write(code)
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "bf16-apply-trace-turn", dst],
                         capture_output=True, text=True, timeout=900)
    sys.stderr.write(out.stderr[-4000:])
    if out.returncode != 0:
        return 1
    stamps = json.loads(out.stdout.strip().splitlines()[-1])
    for sel, block in enumerate((0, 2)):
        for wg in (0, 1):
            ev = stamps[sel][wg]
            total = ev[-1][1] - ev[0][1]
            spans: dict = {}
            for (ta, ca), (tb, cb) in zip(ev, ev[1:]):
                name = APPLY_TRACE_SPANS.get((ta, tb), f"{ta} to {tb}")
                n, c = spans.get(name, (0, 0))
                spans[name] = (n + 1, c + cb - ca)
            print(f"bf16-apply-trace {root} arxiv block {block} warpgroup {wg}: {total} cycles, "
                  f"{sum(1 for t, _ in ev if t == 10)} items", flush=True)
            for name, (n, c) in sorted(spans.items(), key=lambda kv: -kv[1][1]):
                print(f"  {name}: {c} cycles ({100 * c / total:.1f} %), {n} times, "
                      f"{c / n:.0f} a time", flush=True)
    return 0


def apply_trace_turn(root: str) -> int:
    """The traced call of the ``bf16-apply-trace`` mode (in ROOT, the
    stamped copy): three arxiv-shaped calls, the last one's stamps printed
    as a JSON list [block][role] of (tag, clock) pairs."""
    import ctypes
    import json

    import numpy as np
    import torch

    from sgformer_tpu_torch.kernels import _build
    from sgformer_tpu_torch.kernels import attention as attn

    _build.build_all(("linear_attention_bwd",))
    lib = _build.library("linear_attention_bwd")
    lib.sgf_apply_trace_copy.argtypes = [ctypes.c_void_p]
    n = 169_343
    gen = torch.Generator(device="cuda").manual_seed(23)
    q, k, v, g = (torch.randn(n, 256, generator=gen, device="cuda").bfloat16() for _ in range(4))
    n_t = torch.full((), float(n), device="cuda")
    sums = attn.reduce_plain(q, k, v, False)
    red = attn.bwd_reduce_plain(q, v, g, *sums, n_t, False)
    buf = np.zeros((2, 4, 4096), dtype=np.int64)
    for _ in range(3):
        attn.bwd_apply(q, k, v, g, *sums, n_t, *red)
        torch.cuda.synchronize()
        if lib.sgf_apply_trace_copy(buf.ctypes.data) != 0:
            return 1
    print(json.dumps([[[[int(x >> 48), int(x & 0xFFFFFFFFFFFF)] for x in buf[s, r] if x]
                       for r in range(4)] for s in range(2)]), flush=True)
    return 0



def bf16_passes_turn(cs, root: str) -> int:
    """One turn of the ``bf16-passes`` mode on ROOT's package: the bf16
    rows pass's and P pass's device ms by the profiler and the whole
    ``bwd_reduce`` by CUDA events at M = D = 256 on the arxiv and large-400K
    rows (randn, 20 calls), the backward library's ``ptxas`` spill lines,
    and the reduce's digests on ``host_bf16_inputs``; its last line of
    output is a JSON object."""
    import json

    import torch

    from sgformer_tpu_torch.kernels import _build
    from sgformer_tpu_torch.kernels import attention as attn

    report = _build.build_all(("linear_attention_bwd",)).get("linear_attention_bwd", "")
    out = dict(root=root, spills=[line.strip() for line in report.splitlines() if "spill" in line],
               ms={}, digests={})
    for name, n in (("arxiv", 169_343), ("large-400K", 400_000)):
        gen = torch.Generator(device="cuda").manual_seed(23)
        q, k, v, g = (torch.randn(n, 256, generator=gen, device="cuda").bfloat16()
                      for _ in range(4))
        n_t = torch.full((), float(n), device="cuda")
        sums = attn.reduce_plain(q, k, v, False)
        dev_ms = cs.kernel_ms(lambda: attn.bwd_reduce(q, v, g, *sums, n_t),
                              BF16_ROWS + BF16_P_PASS)
        out["ms"][name] = dict(rows=sum(dev_ms[p] for p in BF16_ROWS),
                               p_pass=sum(dev_ms[p] for p in BF16_P_PASS),
                               whole=cs.time_ms(lambda: attn.bwd_reduce(q, v, g, *sums, n_t)))
        cs.log(f"bf16-passes {root} {name}: rows pass {out['ms'][name]['rows']:.4f} ms, P pass "
               f"{out['ms'][name]['p_pass']:.4f} ms, bwd_reduce {out['ms'][name]['whole']:.4f} ms")
        del q, k, v, g, sums
        torch.cuda.empty_cache()
    for n in BF16_REDUCE_DIGEST_ROWS:
        out["digests"][str(n)] = digest(attn.bwd_reduce(*(t.cuda() for t in host_bf16_inputs(n))))
    print(json.dumps(out), flush=True)
    return 0


def designs(roots: list) -> int:
    """The ``designs`` mode: ``designs-turn`` on each root, then back."""
    import json

    turns = run_turns("designs-turn", roots[0], roots + roots[::-1])
    if turns is None:
        return 1
    names = [os.path.relpath(t["root"], HERE) for t in turns]
    keys = []
    for t in turns:
        keys += [k for k in t["ms"] if k not in keys]
    print("designs: " + " | ".join(names), flush=True)
    for key in keys:
        print(f"designs {key}: "
              + ", ".join(f"{t['ms'].get(key, float('nan')):.4f}" for t in turns) + " ms",
              flush=True)
    same = all(len({t["sha256"][key] for t in turns}) == 1 for key in turns[0]["sha256"])
    print(json.dumps({"designs": names, "ms": {k: [t["ms"].get(k) for t in turns] for k in keys},
                      "registers": {n: t["registers"] for n, t in zip(names, turns)
                                    if t["registers"]},
                      "all_bitwise_equal": same}), flush=True)
    return 0 if same else 1


def designs_turn(cs, root: str, dev: str = "cuda") -> int:
    """One turn of the ``designs`` mode on ROOT's package."""
    import hashlib
    import inspect
    import json
    import re

    import torch

    from sgformer_tpu_torch import preprocess_graph
    from sgformer_tpu_torch.data import synthetic_dataset
    from sgformer_tpu_torch.kernels import _build
    from sgformer_tpu_torch.kernels import spmm as k

    report = _build.build_all(("spmm",)).get("spmm", "") if dev == "cuda" else ""
    registers, entry = [], None
    for line in report.splitlines():
        found = re.search(r"Compiling entry function '(\S*csr_spmm_kernel\S*)'", line)
        entry = found.group(1) if found else entry
        spill = re.search(r"(\d+) bytes spill stores", line)
        if entry and spill:
            stores = int(spill.group(1))
        used = re.search(r"Used (\d+) registers", line)
        if entry and used:
            registers.append(dict(kernel=entry, registers=int(used.group(1)),
                                  spill_stores=stores))
            entry = None
    ordered = "schedule" in inspect.signature(k.csr_spmm).parameters
    out = dict(root=root, registers=registers, ms={}, sha256={})
    ds = synthetic_dataset("synth-arxiv", seed=0)
    arxiv = preprocess_graph(ds.graph["edge_index"], ds.num_nodes)
    pl = synthetic_dataset(**cs.POWERLAW_GRAPH)
    graphs = {"arxiv": (arxiv, cs.SWEEP_WIDTHS),
              "power-law": (preprocess_graph(pl.graph["edge_index"], pl.num_nodes),
                            SCHEDULE_WIDTHS)}
    gen = torch.Generator(device=dev).manual_seed(9)

    def record(key, run, order):
        got = run(order)
        out["sha256"][key] = hashlib.sha256(got.contiguous().view(torch.uint8).cpu().numpy()
                                            .tobytes()).hexdigest()[:16]
        out["ms"][key] = cs.time_ms(lambda: run(order))
        if order:
            out["ms"][key + " [no walk order]"] = cs.time_ms(lambda: run({}))

    for where, (g, widths) in graphs.items():
        order = {"schedule": g.schedule} if ordered else {}
        csr = (g.indptr, g.edge_src, g.edge_dst, g.gcn_weight, g.hub_segments, g.hub_edges)
        for f in widths:
            x32 = torch.randn(g.num_nodes, f, generator=gen, device=dev)
            for dtype in (torch.bfloat16, torch.float32):
                x = x32.to(dtype)
                record(f"{where} csr_spmm {cs.DTYPE_NAME[dtype]} F={f}",
                       lambda kw, x=x: k.csr_spmm(x, *csr, **kw), order)
    order = {"schedule": arxiv.schedule} if ordered else {}
    for heads, d, dtype in ((2, 40, torch.float32), (2, 256, torch.bfloat16)):
        x = torch.randn(arxiv.num_nodes, heads, d, generator=gen, device=dev).to(dtype)
        v = torch.rand(arxiv.num_edges, heads, generator=gen, device=dev)
        record(f"arxiv csr_spmm_ev {cs.DTYPE_NAME[dtype]} H={heads} D={d}",
               lambda kw, x=x, v=v: k.csr_spmm_ev(x, arxiv.indptr, arxiv.edge_src,
                                                  arxiv.edge_dst, v, torch.float32,
                                                  arxiv.hub_segments, arxiv.hub_edges, **kw),
               order)
    print(json.dumps(out), flush=True)
    return 0


def busy(root: str, f32: bool = False) -> int:
    """The ``busy`` and ``busy-f32`` modes (see the module's docstring)."""
    import time

    import torch

    from sgformer_tpu_torch import preprocess_graph
    from sgformer_tpu_torch.data import synthetic_dataset
    from sgformer_tpu_torch.kernels import _build
    from sgformer_tpu_torch.native import build as native_build

    cs = load_phases(os.path.join(root, "chip_smoke.py"))
    cs.profile_device = load_phases(os.path.join(HERE, "chip_smoke.py")).profile_device
    print(cs.card_line(), flush=True)
    _build.build_all()
    native_build.library()
    results: dict = {}
    ds = synthetic_dataset("synth-arxiv", seed=0)
    if f32:  # the f32 cells: their attention runs the f32 backward
        cs.amazon2m_batch_phase(results, "cuda")
        cs.papers_sampled_phase(results, "cuda")
        cs.cli_phase(ds, results, "cuda")
        return 0
    t = time.perf_counter()
    graph = preprocess_graph(ds.graph["edge_index"], ds.num_nodes, chunk_dtype="bf16")
    torch.cuda.synchronize()
    cs.log(f"busy {root}: arxiv preprocess_graph {time.perf_counter() - t:.2f} s")
    cs.train_phase(ds, graph, "cuda")
    del graph
    torch.cuda.empty_cache()
    cs.q8_train_phase(results, "cuda")
    cs.amazon2m_batch_phase(results, "cuda")
    cs.cli_phase(ds, results, "cuda")
    return 0


def q8_f32_apply(roots: list, only=None) -> int:
    """The ``q8-f32-apply`` mode: the turns, each ``q8-f32-apply-turn`` in a
    process of its own, then the turns side by side; fails unless the
    outputs that must not change are the same in every turn."""
    import json

    order = roots + [HERE, HERE] + roots[::-1]
    turns = run_turns("q8-f32-apply-turn", roots[0], order,
                      extra=[] if only is None else ["--only", only])
    if turns is None:
        return 1
    names = {r: f"ROOT{i + 1}" for i, r in enumerate(roots)}
    names[HERE] = "this checkout"
    side = {f"turn {i} ({names[t['root']]})": dict(q8=t["q8"], f32_apply=t["f32_apply"],
                                                    bf16_apply=t["bf16_apply"], sass=t["sass"])
            for i, t in enumerate(turns)}
    equal = {key: len({json.dumps(t[key]) for t in turns}) == 1
             for key in ("bf16_apply_digests", "f32_bwd_digests")}
    # every walk of a graph, in every turn, gives one output
    graphs = {k.split(" ", 1)[0] for t in turns for k in t["q8_digests"]}
    equal["q8_digests"] = all(
        len({d for t in turns for k, d in t["q8_digests"].items() if k.split(" ", 1)[0] == g})
        == 1 for g in graphs)
    ok = {names[t["root"]]: t["ok"] for t in turns}
    print(json.dumps({"q8_f32_apply_turns": side, "bitwise_equal": equal,
                      "bf16_apply_within_tolerance_and_repeatable": ok}), flush=True)
    return 0 if all(equal.values()) and all(ok.values()) else 1


# the bf16 forward apply's kernel, either package's
BF16_FWD_APPLY = ("la_apply_tc_kernel", "la_apply_wgmma_kernel")
# the f32 forward apply's shapes, N at M = D = 256: arxiv, the amazon2m batch
# and its tail, arxiv-batch's batch and tail, a papers-sampled batch
F32_APPLY_SHAPES = (169_343, 100_000, 49_029, 50_000, 19_343, 621_432)
HOST_CALLS = 200


def q8_f32_apply_turn(cs, root: str, only=None) -> int:
    """One turn of the ``q8-f32-apply`` mode on ROOT's package; its last
    line of output is a JSON object of its numbers."""
    import dataclasses
    import hashlib
    import inspect
    import json
    import re
    import time

    import torch

    from sgformer_tpu_torch import preprocess_graph
    from sgformer_tpu_torch.data import synthetic_dataset
    from sgformer_tpu_torch.graph import gcn_norm_rs
    from sgformer_tpu_torch.kernels import _build
    from sgformer_tpu_torch.kernels import attention as attn
    from sgformer_tpu_torch.kernels import spmm as k
    from sgformer_tpu_torch.ops.spmm import quantize_absmax, spmm_q8_apply
    from sgformer_tpu_torch.utils.measure import apply_product_inputs

    reports = _build.build_all(("spmm", "linear_attention") if only == "q8" else
                               ("spmm", "linear_attention", "linear_attention_bwd"))
    for name in ("spmm", "linear_attention"):
        for line in reports.get(name, "").splitlines():
            if re.search(r"q8|la_apply|Used|spill", line):
                cs.log(f"ptxas {root} {name}: {line.strip()}")
    counts = sass_counts(cs, root, "linear_attention", "la_apply")
    dev = "cuda"

    def digest(*ts) -> str:
        return hashlib.sha256(b"".join(t.reshape(-1).cpu().view(torch.uint8).numpy().tobytes()
                                       for t in ts)).hexdigest()[:16]

    out = dict(root=root, sass=counts, q8={}, q8_digests={}, f32_apply={}, bf16_apply={},
               bf16_apply_digests=[], f32_bwd_digests=[], ok=True)
    ordered = "schedule" in inspect.signature(k.csr_spmm_q8_apply).parameters
    pl = dict(cs.POWERLAW_GRAPH)
    for what, data in (("large-400K", cs.LARGE_400K), ("arxiv", dict(name="synth-arxiv", seed=0)),
                       ("power-law", pl)) if only in (None, "q8") else ():
        ds = synthetic_dataset(**data, device=dev)
        t = time.perf_counter()
        graph = preprocess_graph(ds.graph["edge_index"], ds.num_nodes, chunk_dtype="bf16",
                                 device=dev)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t
        graph = dataclasses.replace(graph, rs=gcn_norm_rs(graph.edge_dst, graph.num_nodes))
        del ds
        n, f = graph.num_nodes, 256
        csr = (graph.indptr, graph.edge_src, graph.edge_dst, graph.gcn_weight)
        plan = (graph.hub_segments, graph.hub_edges)
        gen = torch.Generator(device=dev).manual_seed(24)
        x = torch.randn(n, f, generator=gen, device=dev).bfloat16()
        q, s = quantize_absmax(x, graph.rs)
        want = spmm_q8_apply(q, s, x, graph.edge_src, graph.edge_dst, graph.gcn_weight,
                             graph.rs, n, torch.bfloat16)
        walks = {"node order": {}}
        if ordered:
            walks["walk order"] = dict(schedule=graph.schedule)
        res = dict(n=n, e=graph.num_edges, hub_segments=plan[0].shape[0], prep_s=prep_s)
        for walk, kw in walks.items():
            def run():
                return k.csr_spmm_q8_apply(q, s, x, *csr, graph.rs, torch.bfloat16, *plan, **kw)
            got = run()
            torch.cuda.synchronize()
            same = torch.equal(got, want)
            repeat = torch.equal(got, run())
            out["q8_digests"][f"{what} {walk}"] = digest(got)
            ms = cs.time_ms(run)
            dev_ms = cs.kernel_ms(run, ("csr_spmm_q8",))["csr_spmm_q8"]
            rows = graph.num_edges - n  # the gathered rows (one self edge a row)
            res[walk] = dict(ms=ms, device_ms=dev_ms, bitwise_plain=same,
                             bitwise_repeatable=repeat, grows_per_s=rows / ms / 1e6)
            cs.log(f"q8 {root} {what} {walk}: {ms:.4f} ms (device {dev_ms:.4f}), "
                   f"{rows / ms / 1e6:.2f} G rows/s; bitwise the plain version {same}, "
                   f"repeatable {repeat}")
            if not (same and repeat):
                raise AssertionError(f"csr_spmm_q8 {what} {walk} is not bitwise the plain version")
            del got
        out["q8"][what] = res
        del graph, x, q, s, want, csr, plan
        torch.cuda.empty_cache()

    m = 256
    for n in F32_APPLY_SHAPES if only in (None, "f32") else ():
        gen = torch.Generator(device=dev).manual_seed(n)
        q, k_, v = (torch.randn(n, m, generator=gen, device=dev) for _ in range(3))
        sums = attn.reduce_plain(q, k_, v, False)
        del k_
        n_t = torch.full((), float(n), device=dev)
        got = attn.apply(q, v, *sums, n_t)
        exact = attn.apply_plain(*(t.double() for t in (q, v, *sums, n_t)), False)
        err = rel(got, exact)
        del exact
        # where q @ kvs carries the output (in f64, the largest error over
        # the tolerance's scale)
        ins = apply_product_inputs(n, m, m, torch.float32,
                                   torch.Generator(device=dev).manual_seed(7))
        exact = attn.apply_plain(*(t.double() for t in ins), False)
        prod_err = ((attn.apply(*ins).double() - exact).abs()
                    / (1e-5 + 1e-5 * exact.abs())).max().item()
        del ins, exact
        repeat = torch.equal(got, attn.apply(q, v, *sums, n_t))
        del got
        ms = cs.time_ms(lambda: attn.apply(q, v, *sums, n_t))
        dev_ms = cs.kernel_ms(lambda: attn.apply(q, v, *sums, n_t),
                              ("la_apply_tf32_kernel", "la_apply_wg_kernel", "split"))
        host_us = None
        if n == 19_343:
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(HOST_CALLS):
                attn.apply(q, v, *sums, n_t)
            host_us = (time.perf_counter() - t) / HOST_CALLS * 1e6
            torch.cuda.synchronize()
        kernel = dev_ms["la_apply_tf32_kernel"] + dev_ms["la_apply_wg_kernel"]
        out["f32_apply"][str(n)] = dict(ms=ms, kernel_ms=kernel, split_ms=dev_ms["split"],
                                        rel_err=err, product_err_over_tol=prod_err,
                                        bitwise_repeatable=repeat, host_us=host_us)
        cs.log(f"f32 apply {root} n={n}: {ms:.4f} ms (kernel {kernel:.4f}, split "
               f"{dev_ms['split']:.4f}); |kernel - plain in f64| / scale {err:.2e}, where "
               f"q @ kvs carries it {prod_err:.3f} of the f32 tolerance; bitwise "
               f"repeatable {repeat}" + (f"; host {host_us:.1f} us a call" if host_us else ""))
        if not repeat:
            raise AssertionError(f"the f32 apply at n = {n} is not bitwise repeatable")
        del q, v, sums
        torch.cuda.empty_cache()
    # the bf16 forward apply at the same shapes: CUDA events, the profiler's
    # device ms of the apply kernel and of its split, torch.matmul(q, kvs) in
    # bf16 as a yardstick (never called by the port) and the bound; the
    # output against the plain version in f64 where q @ kvs carries it (with
    # and without cancelling kvs terms, over the bf16 tolerance), bitwise
    # repeatable, and a digest of it on randn rows (bitwise the parent's)
    for n in F32_APPLY_SHAPES if only in (None, "f32") else ():
        gen = torch.Generator(device=dev).manual_seed(n + 1)
        q, k_, v = (torch.randn(n, m, generator=gen, device=dev).bfloat16() for _ in range(3))
        sums = attn.reduce_plain(q, k_, v, False)
        del k_
        n_t = torch.full((), float(n), device=dev)
        got = attn.apply(q, v, *sums, n_t)
        sha = digest(got)
        repeat = torch.equal(got, attn.apply(q, v, *sums, n_t))
        del got
        errs = {}
        for cancel in (False, True):
            ins = apply_product_inputs(n, m, m, torch.bfloat16,
                                       torch.Generator(device=dev).manual_seed(7), cancel)
            exact = attn.apply_plain(*(t.double() for t in ins), False)
            errs["cancel" if cancel else "products"] = (
                (attn.apply(*ins).double() - exact).abs() / (1e-2 + 1e-2 * exact.abs())
            ).max().item()
            del ins, exact
        ms = cs.time_ms(lambda: attn.apply(q, v, *sums, n_t))
        dev_ms = cs.kernel_ms(lambda: attn.apply(q, v, *sums, n_t), BF16_FWD_APPLY + ("split",))
        kernel = sum(dev_ms[p] for p in BF16_FWD_APPLY)
        kvs_b = sums[0].bfloat16()
        gemm_ms = cs.time_ms(lambda: torch.matmul(q, kvs_b))
        bound, bound_by = cs.bound_ms(3 * n * m * 2 + (m * m + m + 4) * 4,
                                      2 * n * m * m + 2 * n * m + 4 * n * m, torch.bfloat16)
        ok = repeat and max(errs.values()) <= 1.0
        out["ok"] = out["ok"] and ok
        out["bf16_apply"][str(n)] = dict(ms=ms, kernel_ms=kernel, split_ms=dev_ms["split"],
                                         gemm_ms=gemm_ms, bound_ms=bound, bound_by=bound_by,
                                         err_over_tol=errs, bitwise_repeatable=repeat,
                                         sha256=sha)
        out["bf16_apply_digests"].append(sha)
        cs.log(f"bf16 apply {root} n={n}: {ms:.4f} ms (kernel {kernel:.4f}, split "
               f"{dev_ms['split']:.4f}; torch.matmul q @ kvs {gemm_ms:.4f}, bound {bound:.4f} "
               f"by {bound_by}); where q @ kvs carries it {errs['products']:.3f}, kvs terms "
               f"cancelling {errs['cancel']:.3f} of the bf16 tolerance; bitwise repeatable "
               f"{repeat}; sha256 {sha}" + ("" if ok else "; OUT OF TOLERANCE OR NOT REPEATABLE"))
        del q, v, sums, kvs_b
        torch.cuda.empty_cache()
    for n, m_, d_ in F32_DIGEST_SHAPES if only in (None, "f32") else ():
        gen = torch.Generator(device=dev).manual_seed(n + m_ + d_)
        q, k_ = (torch.randn(n, m_, generator=gen, device=dev) for _ in range(2))
        v, g = (torch.randn(n, d_, generator=gen, device=dev) for _ in range(2))
        n_t = torch.full((), float(n), device=dev)
        sums = attn.reduce_plain(q, k_, v, False)
        red = attn.bwd_reduce_plain(q, v, g, *sums, n_t, False)
        out["f32_bwd_digests"].append(digest(*attn.bwd_reduce(q, v, g, *sums, n_t),
                                             *attn.bwd_apply(q, k_, v, g, *sums, n_t, *red)))
        qb, vb = q.bfloat16(), v.bfloat16()
        out["bf16_apply_digests"].append(digest(attn.apply(qb, vb, *sums, n_t)))
        del q, k_, v, g, sums, red, qb, vb
    cs.log(f"q8-f32-apply {root}: f32 backward digests {out['f32_bwd_digests']}, bf16 apply "
           f"digests {out['bf16_apply_digests']}")
    print(json.dumps(out), flush=True)
    return 0


def reduce(roots: list) -> int:
    """The ``reduce`` mode: the turns, each ``reduce-turn`` in a process of
    its own, then the turns side by side; fails unless every turn's outputs
    are within REDUCE_REL_TOL of f64 and bitwise repeatable."""
    import json

    order = roots + [HERE, HERE] + roots[::-1]
    turns = run_turns("reduce-turn", roots[0], order)
    if turns is None:
        return 1
    names = {r: f"ROOT{i + 1}" for i, r in enumerate(roots)}
    names[HERE] = "this checkout"
    side = {f"turn {i} ({names[t['root']]})": dict(reduce=t["reduce"], sass=t["sass"])
            for i, t in enumerate(turns)}
    ok = {names[t["root"]]: t["ok"] for t in turns}
    digests_equal = {f"{call} {key}": len({t["reduce"][call][key] for t in turns}) == 1
                     for call, res in turns[0]["reduce"].items() for key in res
                     if key.endswith("sha256")}
    print(json.dumps({"reduce_turns": side, "within_tolerance_and_repeatable": ok,
                      "digests_equal_in_every_turn": digests_equal,
                      "all_digests_equal": all(digests_equal.values())}), flush=True)
    return 0 if all(ok.values()) else 1


def reduce_turn(cs, root: str, dev: str = "cuda") -> int:
    """One turn of the ``reduce`` mode on ROOT's package; its last line of
    output is a JSON object of its numbers."""
    import json
    import re

    import torch

    from sgformer_tpu_torch.kernels import _build
    from sgformer_tpu_torch.kernels import attention as attn

    # this checkout's inputs whatever ROOT's package holds
    inputs = load_phases(os.path.join(HERE, "sgformer_tpu_torch", "utils", "measure.py"))
    report = _build.build_all(("linear_attention",)).get("linear_attention", "")
    entry = False
    for line in report.splitlines():  # the reduce kernels' registers, spills and warnings
        if "entry function" in line or "Function properties" in line:
            entry = "la_reduce" in line if "entry function" in line else entry
        if entry or "la_reduce" in line or "warning" in line:
            cs.log(f"ptxas {root}: {line.strip()}")
    m = 256
    out = dict(root=root, sass=sass_counts(cs, root, "linear_attention", "la_reduce"),
               reduce={}, ok=True,
               designs={cs.DTYPE_NAME[t]: attn.reduce_design(t, m, m)
                        for t in (torch.bfloat16, torch.float32)})
    cs.log(f"reduce {root} designs at M = D = 256: {out['designs']}")
    for n in F32_APPLY_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            name = cs.DTYPE_NAME[dtype]
            gen = torch.Generator(device=dev).manual_seed(n)
            res = {}
            for kind in ("randn", "positive", "products"):
                if kind == "products":
                    q, k, v = inputs.reduce_product_inputs(n, m, m, dtype, gen)
                else:
                    draw = torch.randn if kind == "randn" else torch.rand
                    q, k, v = (draw(n, m, generator=gen, device=dev).to(dtype) for _ in range(3))
                got = attn.reduce(q, k, v)
                res[f"{kind} sha256"] = digest(got)
                exact = cs.reduce_f64(q, k, v)
                errs = {part: rel(a, b) / cs.REDUCE_REL_TOL for part, a, b in
                        (("kvs", got[0], exact[0]), ("ksum", got[1], exact[1]),
                         ("qsq, ksq", got[2][:2], exact[2]))}
                repeat = all(torch.equal(a, b) for a, b in zip(got, attn.reduce(q, k, v)))
                res[f"{kind} err_over_tol"] = errs
                res[f"{kind} bitwise_repeatable"] = repeat
                if not (max(errs.values()) <= 1.0 and repeat):
                    out["ok"] = False
                    cs.log(f"reduce {root} {name} n={n} {kind}: OUT OF TOLERANCE OR NOT "
                           f"REPEATABLE {errs} {repeat}")
                if kind != "randn":
                    del q, k, v
                del got, exact
            q, k, v = (torch.randn(n, m, generator=gen, device=dev).to(dtype) for _ in range(3))
            res["ms"] = cs.time_ms(lambda: attn.reduce(q, k, v))
            dev_ms = cs.kernel_ms(lambda: attn.reduce(q, k, v),
                                  ("la_reduce", "la_finish_kernel", "la_scalars_kernel"))
            res["kernel_ms"] = dev_ms["la_reduce"]
            res["finish_ms"] = dev_ms["la_finish_kernel"] + dev_ms["la_scalars_kernel"]
            # yardstick: the core product k^T v in one torch.matmul, the
            # inputs' type, TF32 off (never called by the port)
            res["gemm_ms"] = cs.time_ms(lambda: torch.matmul(k.t(), v))
            res["bound_ms"], res["bound_by"] = cs.bound_ms(
                3 * n * m * q.element_size() + (m * m + m + 4) * 4, 2 * n * m * m + 3 * n * m,
                dtype)
            out["reduce"][f"{name} {n}"] = res
            cs.log(f"reduce {root} {name} n={n}: {res['ms']:.4f} ms (kernel "
                   f"{res['kernel_ms']:.4f}, finish + scalars {res['finish_ms']:.4f}; "
                   f"torch.matmul k^T v {res['gemm_ms']:.4f}; bound {res['bound_ms']:.4f} by "
                   f"{res['bound_by']}); errors over the tolerance "
                   + ", ".join(f"{kd}: " + ", ".join(f"{p} {e:.3f}" for p, e in
                                                     res[f"{kd} err_over_tol"].items())
                               for kd in ("randn", "positive", "products")))
            del q, k, v
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


def probes(roots: list) -> int:
    """The ``probes`` mode: the turns, each ``probes_turn`` in a process of
    its own, then the turns side by side; fails unless every turn's kernels
    are within their tolerance of the plain versions and repeatable."""
    import json

    turns = run_turns("probes", roots[0], roots if len(roots) > 1 else None)
    if turns is None:
        return 1
    side = {f"turn {i} ({t['root']})": {kind: {s: r["ms"] for s, r in t[kind].items()}
                                         for kind in ("rows", "tiles")}
            for i, t in enumerate(turns)}
    same = {key: len({t["digests"][key] for t in turns}) == 1 for key in turns[0]["digests"]}
    print(json.dumps({"probes_turns": side, "ok": {t["root"]: t["ok"] for t in turns},
                      "digests_equal_in_every_turn": same}), flush=True)
    return 0 if all(t["ok"] for t in turns) else 1


# the card tests' probe inputs, digested in every turn of the probes mode
# (tests/test_torch_cuda.py): (kind, n, e, f, chunk, stages)
PROBE_DIGEST_SHAPES = (("rows", 5000, 8192, 256, 512, 16), ("rows", 5000, 8192, 64, 512, 16),
                       ("tiles", 4096, 2048, 256, 256, 8), ("tiles", 4096, 2048, 64, 64, 8))
# the probes mode's x sizes for gather_rows' ceilings: 20.5 MB (within the
# 50 MB L2) and 1.02 GB (from HBM) of 512-byte rows
PROBE_CEILING_ROWS = (40_000, 2_000_000)


def probes_turn(cs, root: str) -> int:
    """One turn of the ``probes`` mode on ROOT's package; its last line of
    output is a JSON object of its numbers."""
    import json

    import torch

    from sgformer_tpu_torch.kernels import _build
    from sgformer_tpu_torch.microbench import dma_gather, dma_tile

    report = _build.build_all(("microbench",)).get("microbench", "")
    out = dict(root=root, ptxas=[], rows={}, tiles={}, digests={}, ok=True, designs={})
    entry = False
    for line in report.splitlines():
        if "entry function" in line:
            entry = "gather" in line
        if (entry and ("spill" in line or "Used" in line)) or "warning" in line:
            out["ptxas"].append(line.strip())
    probes = (("rows", dma_gather, dma_gather.gather_rows, dma_gather.gather_rows_plain,
               cs.rows_in_order, (4, 8, 16, 32), dma_gather.C, 1),
              ("tiles", dma_tile, dma_tile.gather_tiles, dma_tile.gather_tiles_plain,
               cs.tiles_in_order, (8, 32), dma_tile.C, 8))
    for kind, mod, kernel, plain, in_order, stages, chunk, rows_a_copy in probes:
        design = getattr(mod, "design", None)
        for s in stages:
            out["designs"][f"{kind} S={s}"] = (design(stages=s) if design else
                                               "no design(): one block a chunk or a step")
        x, idx = mod.make_inputs("cuda")
        for s in stages:
            ids = idx[s] if isinstance(idx, dict) else idx
            got = kernel(x, ids, chunk, s)
            err, scale = cs.rel_err(got, plain(x, ids, chunk))
            res = dict(err_over_tol=err / scale / mod.REL_TOL,
                       repeatable=torch.equal(got, kernel(x, ids, chunk, s)),
                       in_order=torch.equal(got.cpu(), in_order(x, ids, chunk)),
                       ms=cs.time_ms(lambda: kernel(x, ids, chunk, s)))
            e = ids.numel()
            res["g_rows_per_s"] = e * rows_a_copy / res["ms"] / 1e6
            res["gb_per_s"] = e * rows_a_copy * x.shape[1] * 2 / res["ms"] / 1e6
            out["digests"][f"{kind} S={s}"] = digest([got])
            if not (res["err_over_tol"] <= 1.0 and res["repeatable"]):
                out["ok"] = False
            out[kind][str(s)] = res
            cs.log(f"probes {root} {kind} S={s}: {res['ms']:.4f} ms, {res['g_rows_per_s']:.3f} "
                   f"G rows/s, {res['gb_per_s']:.1f} GB/s; error {res['err_over_tol']:.3f} of "
                   f"the tolerance, repeatable {res['repeatable']}, in the kernels' order "
                   f"{res['in_order']}; {out['designs'][f'{kind} S={s}']}")
            del got
        del x, idx
        torch.cuda.empty_cache()
    # the random-row rate where x lies in L2 and where it lies in HBM: the
    # probe's rows (E of 512 bytes, C = 512) drawn over x of 20.5 MB and of
    # 1.02 GB (randn on the card, seed 31)
    gen = torch.Generator(device="cuda").manual_seed(31)
    for n in PROBE_CEILING_ROWS:
        x = torch.randn(n, dma_gather.F, generator=gen, device="cuda").to(torch.bfloat16)
        ids = torch.randint(0, n, (dma_gather.E,), generator=gen, device="cuda",
                            dtype=torch.int32)
        for s in (4, dma_gather.S):
            ms = cs.time_ms(lambda: dma_gather.gather_rows(x, ids, dma_gather.C, s))
            out["rows"][f"x of {n} rows, S={s}"] = dict(
                ms=ms, g_rows_per_s=dma_gather.E / ms / 1e6,
                gb_per_s=dma_gather.E * dma_gather.F * 2 / ms / 1e6)
            cs.log(f"probes {root} rows over x of {n} rows ({n * dma_gather.F * 2 / 1e6:.1f} MB)"
                   f", S={s}: {ms:.4f} ms, {dma_gather.E / ms / 1e6:.3f} G rows/s, "
                   f"{dma_gather.E * dma_gather.F * 2 / ms / 1e6:.1f} GB/s")
        del x, ids
        torch.cuda.empty_cache()
    for kind, n, e, f, chunk, s in PROBE_DIGEST_SHAPES:
        if kind == "rows":
            x, ids = dma_gather.make_inputs("cuda", n=n, e=e, f=f)
            got = dma_gather.gather_rows(x, ids, chunk, s)
            in_order = cs.rows_in_order(x, ids, chunk)
        else:
            x, idx = dma_tile.make_inputs("cuda", n=n, f=f, e=e, chunk=chunk, stages=(8,))
            got = dma_tile.gather_tiles(x, idx[8], chunk, s)
            in_order = cs.tiles_in_order(x, idx[8], chunk)
        key = f"{kind} n={n} e={e} f={f} chunk={chunk}"
        out["digests"][key] = digest([got])
        cs.log(f"probes {root} {key}: sha256 {out['digests'][key]}, in the kernels' order "
               f"{torch.equal(got.cpu(), in_order)}")
    print(json.dumps(out), flush=True)
    return 0


def kernel_key(name: str) -> str:
    """A mangled kernel name without its anonymous namespace's hash, which
    differs from one build to the next."""
    import re

    return re.sub(r"_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}", "(anon)", name)


def resource_usage(library: str, mark: str) -> dict:
    """Registers, stack bytes and local bytes of each kernel whose name
    holds ``mark``, in ``cuobjdump --dump-resource-usage`` of the built
    ``library``, by :func:`kernel_key`."""
    import re

    from sgformer_tpu_torch.kernels import _build

    text = subprocess_out(["cuobjdump", "--dump-resource-usage", _build._target(library)[1]])
    return {kernel_key(func): dict(registers=int(reg), stack=int(stack), local=int(local))
            for func, reg, stack, local in re.findall(
                r"Function (\S+?):?\s*\n\s*REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)", text)
            if mark in func}


def sass_digests(library: str, mark: str) -> dict:
    """sha256 (16 hex digits) of each kernel's SASS whose name holds
    ``mark``, in ``cuobjdump -sass`` of the built ``library``: the
    instructions alone (addresses and encodings dropped, branch labels
    numbered within the kernel), so a kernel compiled to the same code
    gives the same digest in any library; by :func:`kernel_key`."""
    import hashlib
    import re

    from sgformer_tpu_torch.kernels import _build

    sass = subprocess_out(["cuobjdump", "-sass", _build._target(library)[1]])
    out = {}
    for func, body in re.findall(r"Function : (\S+)(.*?)(?=Function : |\Z)", sass, re.S):
        if mark not in func:
            continue
        body = re.sub(r"/\*.*?\*/", "", body)
        labels = {}
        body = re.sub(r"\.L_x_\d+", lambda m: labels.setdefault(m.group(0), f"L{len(labels)}"),
                      body)
        lines = [" ".join(line.split()) for line in body.splitlines() if line.strip()]
        out[kernel_key(func)] = hashlib.sha256("\n".join(lines).encode()).hexdigest()[:16]
    return out


def slab(roots: list) -> int:
    """The ``slab`` mode: the turns ROOT1 ... ROOTk, this checkout, this
    checkout, ROOTk ... ROOT1, each ``slab_turn`` in a process of its own,
    then the turns side by side; fails unless every turn is within
    tolerance, repeatable and bitwise the same in both orders, and
    ``csr_spmm``'s digests are the same in every turn."""
    import json

    order = roots + [HERE, HERE] + roots[::-1]
    turns = run_turns("slab", roots[0], order)
    if turns is None:
        return 1
    side = {f"turn {i} ({t['root']})": dict(ms=t["ms"], csr_spmm_ms=t["csr_spmm_ms"])
            for i, t in enumerate(turns)}
    same = {key: len({t["digests"].get(key) for t in turns}) == 1
            for key in turns[0]["digests"]}
    resources = {name: sorted({json.dumps(t["resources"].get(name)) for t in turns})
                 for name in turns[0]["resources"] if "csr_spmm_kernel" in name}
    sass = {name: len({t["sass"].get(name) for t in turns}) == 1
            for name in turns[0]["sass"]}
    spmm_same = all(v for k, v in same.items() if k.startswith("csr_spmm"))
    print(json.dumps({"slab_turns": side, "ok": {t["root"]: t["ok"] for t in turns},
                      "digests_equal_in_every_turn": same,
                      "csr_spmm_resources_in_every_turn": resources,
                      "csr_spmm_sass_equal_in_every_turn": sass}), flush=True)
    return 0 if all(t["ok"] for t in turns) and spmm_same else 1


def slab_turn(cs, root: str) -> int:
    """One turn of the ``slab`` mode on ROOT's package; its last line of
    output is a JSON object of its numbers: the registers, stack and local
    bytes of the probe's and ``csr_spmm``'s row-walk kernels (``cuobjdump
    --dump-resource-usage``) and digests of ``csr_spmm_kernel``'s SASS; on
    synth-arxiv at F = 256 with x from ``slab_variants.make_x``, each of
    the probe's modes in the walk order
    (where ROOT's ``slab_variant`` takes one) and in node order: its
    CUDA-event ms (median of 20), its error against the plain version over
    ``REL_TOL``, whether it is bitwise repeatable and the same in both
    orders, prod bitwise ``csr_spmm`` of the f32 x, and a digest of its
    output; ``csr_spmm`` bf16 in both orders timed, and its outputs of the
    bf16 and the f32 x in both orders digested."""
    import inspect
    import json

    import torch

    from sgformer_tpu_torch import preprocess_graph
    from sgformer_tpu_torch.data import synthetic_dataset
    from sgformer_tpu_torch.kernels import _build
    from sgformer_tpu_torch.kernels.spmm import csr_spmm
    from sgformer_tpu_torch.microbench import slab_variants as sv

    _build.build_all(("spmm", "microbench"))
    out = dict(root=root, resources={**resource_usage("spmm", "csr_spmm_kernel"),
                                     **resource_usage("microbench", "slab_variant")},
               sass=sass_digests("spmm", "csr_spmm_kernel"), ms={}, csr_spmm_ms={}, digests={},
               errors={}, ok=True)
    for name, r in out["resources"].items():
        cs.log(f"slab {root} {name}: {r}")
    ds = synthetic_dataset("synth-arxiv", seed=0)
    graph = preprocess_graph(ds.graph["edge_index"], ds.num_nodes, chunk_dtype="bf16")
    x = sv.make_x(graph.num_nodes, "cuda")
    csr = (graph.indptr, graph.edge_src, graph.edge_dst, graph.gcn_weight)
    plan = (graph.hub_segments, graph.hub_edges)
    orders = {"node": None}
    if "schedule" in inspect.signature(sv.slab_variant).parameters:
        orders = {"walk": graph.schedule, "node": None}
    for mode in sv.MODES:
        plain = sv.slab_variant_plain(x, graph.edge_src, graph.edge_dst, graph.gcn_weight, mode)
        outs = {}
        for order, schedule in orders.items():
            kw = {"schedule": schedule} if schedule is not None else {}
            got = sv.slab_variant(x, *csr, mode, **kw)
            err, scale = cs.rel_err(got, plain)
            key = f"{mode} {order}"
            out["errors"][key] = err / scale / sv.REL_TOL
            out["digests"][key] = digest([got])
            checks = dict(repeatable=torch.equal(got, sv.slab_variant(x, *csr, mode, **kw)))
            if mode == "prod":
                checks["csr_spmm"] = torch.equal(got, csr_spmm(x.float(), *csr, *plan, **kw))
            out["ms"][key] = cs.time_ms(lambda: sv.slab_variant(x, *csr, mode, **kw))
            if not (out["errors"][key] <= 1.0 and all(checks.values())):
                out["ok"] = False
            cs.log(f"slab {root} {key}: {out['ms'][key]:.4f} ms, error "
                   f"{out['errors'][key]:.3f} of the tolerance, {checks}, sha256 "
                   f"{out['digests'][key]}")
            outs[order] = got
        if len(outs) == 2 and not torch.equal(outs["walk"], outs["node"]):
            out["ok"] = False
            cs.log(f"slab {root} {mode}: the two orders differ")
        del outs, plain
    for order, schedule in (("walk", graph.schedule), ("node", None)):
        for name, xi in (("bf16", x), ("f32", x.float())):
            key = f"csr_spmm {name} {order}"
            out["digests"][key] = digest([csr_spmm(xi, *csr, *plan, schedule=schedule)])
        out["csr_spmm_ms"][order] = cs.time_ms(lambda: csr_spmm(x, *csr, *plan,
                                                                schedule=schedule))
        cs.log(f"slab {root} csr_spmm bf16 F = 256 {order} order: "
               f"{out['csr_spmm_ms'][order]:.4f} ms")
    print(json.dumps(out), flush=True)
    return 0


# the row windows of the reuse table: one SM's 64 warps, 256 and 1,024
# rows, and the warps the H100 holds at once (132 SMs x 64 warps)
REUSE_WINDOWS = (64, 256, 1024, 132 * 64)


def reuse() -> int:
    """The ``reuse`` mode, on the CPU: the port's ``preprocess_graph`` of
    synth-arxiv; for windows of consecutive positions of the walk order and
    of node order, the rows the windows gather (their edges) over the
    distinct source rows among them, the mean distinct rows a window and
    their bf16 bytes at F = 256, and the share of the gathered rows that a
    window's distinct rows staged once would save."""
    import json

    import numpy as np

    from sgformer_tpu_torch import preprocess_graph
    from sgformer_tpu_torch.data import synthetic_dataset

    ds = synthetic_dataset("synth-arxiv", seed=0, device="cpu")
    graph = preprocess_graph(ds.graph["edge_index"], ds.num_nodes, device="cpu")
    n, e = graph.num_nodes, graph.num_edges
    src, dst = graph.edge_src.numpy().astype(np.int64), graph.edge_dst.numpy().astype(np.int64)
    table = {}
    for order, rows in (("walk", graph.schedule.numpy()), ("node", np.arange(n))):
        position = np.empty(n, np.int64)
        position[rows] = np.arange(n)
        for w in REUSE_WINDOWS:
            window = position[dst] // w
            distinct = np.unique(window * n + src).size
            table[f"{order} {w}"] = dict(
                edges_over_distinct=e / distinct, distinct_a_window=distinct / -(-n // w),
                mb_a_window=distinct / -(-n // w) * 256 * 2 / 1e6,
                staging_saves=1 - distinct / e)
            print(f"reuse {order} order, windows of {w} rows: edges / distinct sources "
                  f"{e / distinct:.3f}, {distinct / -(-n // w):.0f} distinct rows a window "
                  f"({distinct / -(-n // w) * 512 / 1e6:.3f} MB bf16 at F = 256), staging "
                  f"them saves {1 - distinct / e:.3f} of the gathered rows", flush=True)
    print(json.dumps({"n": n, "e": e, "reuse": table}), flush=True)
    return 0


# the turns run by ``run_turns`` through ``python3 chip_compare.py turn MODE
# ROOT``, by mode
TURNS = {"probes": probes_turn, "slab": slab_turn}


def digest(outs) -> str:
    """sha256 (16 hex digits) of the bytes of the tensors ``outs``."""
    import hashlib

    import torch

    return hashlib.sha256(b"".join(t.reshape(-1).cpu().view(torch.uint8).numpy().tobytes()
                                   for t in outs)).hexdigest()[:16]


def rel(got, want) -> float:
    """max |got - want| over max |want|, in f64."""
    err = (got.double() - want.double()).abs().max().item()
    return err / max(want.double().abs().max().item(), 1e-300)


def subprocess_out(cmd: list) -> str:
    import subprocess

    return subprocess.run(cmd, capture_output=True, text=True, check=True, timeout=300).stdout


if __name__ == "__main__":
    sys.exit(main())
