#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``sgformer_tpu_torch``) on one GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and the CUDA toolkit (``nvcc``); it imports nothing of JAX or of the
JAX package. Phases, each failing loudly:

1. the card's name and power limit (``nvidia-smi``);
2. the build of every kernel from ``sgformer_tpu_torch/csrc`` (all ``nvcc``
   runs at once), then of the sampled tier's host sampler
   (``csrc/graph_kernels.cpp``, g++), each timed as set-up;
3. each kernel against its plain PyTorch version on the card, at the shapes
   of the serving path (the arxiv-shaped graph, N = 169,343 nodes, width
   256), in bf16 and f32, with its median time beside its bound; the
   reduce also on positive inputs and on inputs where its products carry
   kvs (``reduce_product_inputs``) against its sums in f64, the
   apply alone at n = N (bitwise repeatable), at n = 1 and, against its
   plain version in f64, on inputs where q @ kvs carries the output (in
   bf16 also where kvs terms cancel, so that a dropped lo piece shows), each
   with the design it runs (tensor cores in both types, f32 in 3xTF32, the
   reduce in both types and the f32 apply on ``wgmma`` fed by TMA) and
   one ``torch.matmul`` of its core product (k^T v, q @ kvs) as a yardstick;
4. the backward attention kernels against their plain versions and against
   torch autograd of the plain forward, at the same shapes, in bf16 and f32
   (both on the tensor cores by ``wgmma``: bf16 in all three kernels, f32
   in 3xTF32 in all three too); both also with n = 1 and positive
   inputs (the reduce to 2^-14 of scale, f32's P to 1e-5, the apply against
   its plain version in f64) and on inputs where their products carry the
   outputs (``bwd_product_inputs``; for the f32 reduce's P pass also
   ``bwd_reduce_product_inputs``), with their designs and ``torch.matmul``
   of q @ kvs and q^T (g/den) as a yardstick; bitwise repeatable, finite
   zeros for an all-masked group; the reduce's rows pass and P pass timed
   apart in both types at the arxiv, amazon2m-batch and papers-sampled
   shapes, the P pass beside its bound and ``torch.matmul(q.t(), gd)``;
5. the serving path: ``synthetic_dataset("synth-arxiv")``, ``preprocess_graph``
   and the bench model ``SGFormerConfig.large(256, 40, trans_num_layers=1,
   gnn_num_layers=3, graph_weight=0.5, compute_dtype="bf16")`` from a seeded
   generator behind ``Predictor(...).compile()``, answering several requests.
   The launch counts must show every forward kernel ran on that path and no
   backward kernel; the logits must be finite, bitwise repeatable, and agree
   with the same forward run through the plain versions on the card;
6. the training path: the same model behind ``Trainer`` with the JAX bench's
   ``TrainConfig(lr=1e-3, trans_weight_decay=0.0, gnn_weight_decay=0.0)`` and
   ``train_idx = arange(0, N, 2)``: one step's loss and gradients against the
   same step through the plain versions (same weights, same dropout masks),
   the launches of one step, ``time_test`` over 20 steps (the loss must
   fall) and a profile of one step;
7. the per-edge-value SpMM, its dv alone (``sddmm``, through the hub plan)
   and its whole gradient (``csr_spmm_ev_bwd``: dx and dv from one walk of
   the transposed CSR) against their plain versions at the shapes of GAT's
   two layers (H = 2, D = 256 and H = 1, D = 40): the first two in bf16
   and f32; the gradient on f32 x and g with bf16 messages (as GAT runs)
   and f32 messages, its dv bitwise ``sddmm``'s, its dx bitwise the parent
   formulation's (``csr_spmm_ev`` on the transposed CSR) at every width,
   bitwise repeatable, with time, read-once bound, plain, unfused-pair and
   library time and gather rate; then the row walk's width sweep on the
   arxiv graph (``width_sweep``): ``csr_spmm`` at F = 32, 40, 64, 128 and
   256 and ``csr_spmm_ev`` at (H, D) = (1, 40), (2, 40) and (2, 256), bf16
   and f32, each with its lane groups, time, gathered bytes and gather
   rate, read-once bound, ``torch.sparse.mm``'s time, max |kernel - plain|
   and bitwise repeatability, and H = 1 ``csr_spmm_ev`` bitwise
   ``csr_spmm``; every SpMM call in the graph's walk order
   (``Graph.schedule``, the kernels' path in the models), the width sweep's
   and 3's and 8's ``csr_spmm`` also in node order, bitwise the same, with
   both times and gather rates;
8. the CSR SpMM on the JAX package's power-law bench graph (169,343 nodes,
   powerlaw 1.1), width 256, bf16 and f32, through the graph's hub plan (rows
   of more than ``HUB_EDGES`` in-edges split over several warps), with the
   segment length swept for the record, and at F = 40 (the width sweep); ``csr_spmm_q8`` (bf16, as in 10) on
   the same graph with and without its hub plan; then powerlaw-train, the
   bench model on that graph behind ``Trainer`` as in 6 (6 ``csr_spmm`` a
   step); ``csr_spmm_ev_bwd`` and ``sddmm`` there at GAT's two layer shapes
   with and without the hub plans, and ``sddmm``'s own counted run; then
   powerlaw-gat-train, 9's GAT on that graph through the same checks;
9. arxiv-gat-train: ``GAT(hidden 256, 2 layers, 2 heads, dropout 0.5, BN)``
   with bf16 messages behind ``Trainer`` with the CLI's baseline optimiser
   (lr 0.01, weight decay 5e-3): one step's loss and gradients against the
   plain step, the launches of one step (2 ``csr_spmm_ev``, 2
   ``csr_spmm_ev_bwd``, no ``sddmm``) and of one ``eval_step``, the eval
   logits against the plain forward, ``time_test`` over 20 steps (the loss
   must fall) and a profile of one step;
10. the int8 aggregation at the arxiv shape, x bf16 and f32: the quantiser
   kernel ``quantize_absmax`` bitwise against its plain version (q and s),
   with its time beside its two-pass bound and the plain time;
   ``csr_spmm_q8`` through the graph's hub plan in the graph's walk order
   against its plain version on the same quantised rows (one ulp of the
   output type) and bitwise against its node-order walk (timed beside it),
   the whole against the plain whole, bitwise repeatable, with its walk's
   design,
   time, bound, plain time, gather rate and ``csr_spmm``'s time beside it;
   the same at the shape of 11 (bf16), which the kernels line reports
   first, and the gather rate beside the ``gather_rows`` probe's after 14;
11. large-400K-int8-train: the bench model on the JAX package's large-400K
   shape (``synthetic_dataset(num_nodes=400_000, num_edges=4_800_000,
   num_features=128, num_classes=40, seed=0)``, E = 9,991,628 after
   symmetrising and self-loops) with ``preprocess_graph(chunk_dtype="bf16",
   slab_dtype="int8")``, behind ``Trainer`` as in 6: the step against the
   plain step, launches (6 ``csr_spmm_q8``, 6 ``quantize_absmax`` and no
   ``csr_spmm`` a step, 3 and 3 a forward), eval logits against the plain
   forward, ``time_test`` and a profile; then the same graph with ``slab_dtype="compute"`` for one
   ``time_test``, with the int8-vs-bf16 logit difference printed;
12. arxiv-batch-train (after 6): the bench model behind ``BatchTrainer`` on
   the arxiv graph's edge list, batches of 50,000 (3 and a tail of 19,343),
   one epoch with a full-graph eval; amazon2m-batch-train (after 11): the
   repo's amazon2m recipe (``configs/large.sh``: ``SGFormerConfig.large(256,
   47, trans_num_layers=1, gnn_num_layers=3, graph_weight=0.5, dropout 0,
   gnn_use_init=True)``, f32, lr 0.01, no weight decay) on
   ``synthetic_dataset`` at the ogbn-products graph's size (2,449,029 nodes,
   61,859,140 edges, 100 features, 47 classes), its edge list symmetrised
   with self-loops on the card, the 50/25/25 random split, batches of
   100,000 (24 and a tail of 49,029), one epoch with the streaming eval,
   then the step with bf16 activations for one timing and
   ``preprocess_graph`` of the full graph on the card, timed. For each: one
   batch's subgraph built on the card (CUDA events) and on CPU tensors
   (amazon2m: bitwise equal, every field), the kernels alone in f32 and in
   bf16 (the type of arxiv-batch's model and of amazon2m's bf16 step) at a
   full batch's and the tail's shapes (the reduce's three launches, its
   main kernel, ``la_finish_kernel`` and ``la_scalars_kernel``, also timed
   apart by the profiler), one step's loss and gradients
   against the plain step (amazon2m f32: 1e-5 and 1e-4; arxiv bf16 as in 6),
   the launches of one step (6 ``csr_spmm`` and each attention kernel once)
   and of one batch forward (3 and the reduce and apply), a batch's logits
   against the plain forward, ``fit``'s launches, losses (the last 3 below
   the first), accuracies and peak memory, each batch's build and step ms,
   a streaming eval's wall time and a profile of three consecutive batches,
   build included;
13. papers-sampled-train (after 12): the repo's papers100M recipe
   (``configs/100m.sh``: ``SGFormerConfig.papers100m(256, 172,
   trans_num_layers=1, gnn_num_layers=3, graph_weight=0.8, gnn_dropout=0.2,
   trans_dropout=0.5, gnn_use_init=True)``, f32, lr 1e-3, weight decay
   1e-3 / 1e-5) behind ``SampledTrainer`` on ``synthetic_dataset`` at
   papers100M's shape cut to 2,000,000 nodes (29,100,000 directed edges, 128
   features, 172 classes; symmetrised with self-loops and sorted into the
   host's int64 CSR on the card), papers100M's split shares (21,739 /
   2,256 / 3,860 seeds), batches of 1,000 seeds, fanouts (15, 10, 5),
   uncapped, sampled by the C++ sampler (the JAX default): host-sampled
   batches with their sizes and sample ms, each batch's row gather on its
   own line, the ``use_native=False`` batches of the same seeds beside them
   (the C++ hop sampler's ms, and its numpy plain version's), one
   batch's graph built on the card and on CPU tensors (bitwise equal), the
   kernels alone in f32 at that batch's shape (``csr_spmm`` on A and on A^T), one
   step against the plain step (1e-5 loss, 1e-4 gradients), the launches of
   a step (6 ``csr_spmm`` and each attention kernel once) and of a forward,
   a forward's logits against the plain forward's, ``fit`` for one epoch
   with its valid and test sweeps (launches, losses, accuracies, peak
   memory, the best state saved) with ``sampler_workers`` 0 and then
   ``min(8, os.cpu_count())``, bitwise the same losses, each fit's wall time
   a batch and busy share beside the host's core count (``profile_device``
   over the whole fit), the checkpoint reloaded whole (bitwise
   eval logits) and with ``use_pretrained`` (saved parameters, fresh
   BatchNorm statistics), each batch's build and step ms, a streaming
   sweep's wall time and a profile of three batches with their sampling;
14. the timing probes (``sgformer_tpu_torch.microbench``): each kernel
   against its plain version (``slab_variant``'s prod bitwise ``csr_spmm``;
   ``gather_rows`` and ``gather_tiles`` at every S of their runs, each
   bitwise repeatable and bitwise its replaced kernel's output,
   ``PROBE_DIGESTS``), then each probe's own run, whose launches are
   counted, each gather kernel's time beside its design. Their launches
   share one count with every other kernel's, so each path's launch check
   also shows that no path of 5, 6, 8, 9, 11, 12, 13, 15, 16, 17 and 18 launched a probe;
   then K3's case: ``gather_rows`` on the rows ``csr_spmm`` gathers on the
   arxiv graph, in its walk order and in node order, beside ``csr_spmm``
   bf16 at F = 256 in each order and ``slab_variant``'s no_src_matmul;
   the gather rates of 8, 10 and 7 beside the ``gather_rows`` probe's;
15. the CLI (after 13, before 14): ``sgformer_tpu_torch.cli.main.main`` on
   the repo's recipes, their flags read verbatim from the port's recipe
   files (the TPU layout flags included) and cut in epochs and runs only:
   arxiv-cli-train, the ogbn-arxiv recipe (f32, hidden 256, 3 GraphConv
   layers, 1 attention layer) on 5's arrays written in OGB's on-disk layout
   (``ogbn_arxiv/processed.npz`` and ``split/time/*.csv.gz``, a seeded
   50/25/25 split), 18 epochs with an eval every 9: its launches (epochs x
   a step's + evals x a forward's), losses (the last 3 below the first) and
   statistics, its set-up alone and a profile of one step, then
   ``--time_test`` on the same flags;
   the amazon2m run's flags on the same files through the batch trainer
   (batches of 50,000, 2 epochs); the papers100M pretrain run's flags
   through the sampled trainer on ``synth-n20000-e120000-f128-c16`` (1
   epoch, the best state saved, ``--sampler_workers 2``); H2GCN (hidden
   64, 2 rounds) on that graph through the CLI's set-up: its step against
   the plain step (f32: loss 1e-5, gradients 1e-4), 8 ``csr_spmm`` a step
   and 4 a forward, its eval logits against the plain forward, and a
   ``--time_test``;
16. the zoo (after 15, before 14): the attention ablations and the
   graph-transformer zoo through ``cli.main`` on seeded data of Cora's
   sizes (2,708 nodes, 10,556 directed edges, 1,433 binary features, 7
   classes; Planetoid npz) and the filtered squirrel's (2,223 nodes, 46,998
   edges, 2,089 features, 5 classes, 10 split masks; wiki_new npz):
   ablation-cli-train, ``recipes/ablation.sh``'s flags verbatim for each of
   simple, softmax, gat and performer; squirrel-difformer-train,
   ``recipes/medium.sh``'s squirrel DIFFormer run; NodeFormer, GraphGPS,
   GraphTrans and Graphormer with the JAX CLI's defaults. 20 epochs and 1
   run each, width uncut. For each: one step against the plain step (f32:
   loss 1e-5, gradients 1e-4), exact launches of a step and a forward (each
   ``propagate`` one ``csr_spmm`` forward and one backward; the attention
   kernels once each for ``simple`` only), the eval logits against the
   plain forward (1e-5 of the largest), the run's launches and losses (the
   last 3 below the first), ``--time_test`` and a profile of one step;
17. serve-export (after 5): the hand-off of a trained forward at the bench
   width on the arxiv graph, for the bench model, the bench model on an
   int8 graph (``slab_dtype="int8"``) and GAT (9's config): 3 ``Trainer``
   steps, ``save_checkpoint``, ``load_predictor`` into a fresh model (its
   logits bitwise ``eval_step``'s); then ``export_artifact(...,
   include_inputs=True)`` and ``load_exported``: the program's op nodes one
   a launch of the forward, its call with ``export_leaves()`` and with the
   bundle's leaves on the card (mapped by ``inv_perm``) bitwise
   ``Predictor.logits()``, the launches of 25 exported requests exactly 25
   forwards' and no backward kernel's; the export's and load's seconds, the
   artifact's and bundle's bytes and the median request beside the
   ``Predictor``'s, printed with no limit. Then NodeFormer (a tuple out),
   H2GCN and Graphormer through the CLI's set-up on 16's Cora-sized files
   behind ``Predictor(..., model_kwargs=)``: logits bitwise ``eval_step``'s
   after 3 steps, with a forward's launches;
18. arxiv-sharded-train (after 16, before 14): the bench model with
   ``axis_name="sp"`` behind ``parallel.ShardedTrainer`` on synth-arxiv
   after ``preprocess_graph(reorder=True)``, in spawned groups
   (``parallel.launch.run_group``) of one rank on NCCL and of two ranks
   sharing the card under gloo (NCCL refuses two ranks on one card), with
   the all-gather and with the halo exchange. Each rank: the sharded step
   (dropout 0) against the one-device ``Trainer``'s on the same weights
   (bf16: loss 1e-2, gradients 2e-2), bitwise repeatable; exact launches of
   a step and a forward (3 GraphConv layers x 1 ``csr_spmm`` over the
   gathered rows, or 3 for the halo's send gather, local and remote CSR,
   forward and on the transposes backward; each attention kernel once; the
   probes and ``csr_spmm_q8`` 0); the eval logits against the plain
   forward; ``time_test`` (the loss must fall) with step and forward ms and
   peak MiB, the one-device ``Trainer``'s beside it in the group of one; a
   profiled step (the collectives' kernels and host copies as groups); B,
   H and the rows exchanged a layer; each collective the rank ran, by
   backend and tensor device (all on the group's backend and the card, or
   the phase fails); the edge cut at 2 shards with and
   without the reorder and the reorder's seconds. Then the ogbn-arxiv
   recipe's flags with ``--trainer sharded --use_halo`` through
   ``cli.main`` in this process (a group of one on NCCL): exact launches,
   falling losses; then ``python -m sgformer_tpu_torch.parallel.scaling
   --devices 1 --halo --reorder`` once (one card: no scaling efficiency).
19. arxiv-dp-batch-train (after 18): the bench model with
   ``axis_name="sp"`` behind ``parallel.DPBatchTrainer`` on synth-arxiv's
   batch-tier edge list in batches of 50,000, in spawned groups of one rank
   on NCCL (dp = sp = 1) and of four ranks sharing the card under gloo
   (dp = 2 x sp = 2), the kernels built before the spawn. The first step
   (dropout 0) on every rank's rectangular, padded shard against the same
   step through the plain versions, every rank joining both, and against
   the mean over every group's batch through the one-device model (with
   dp = 1 ``BatchTrainer``'s loss on that batch; bf16: loss 1e-2,
   gradients 2e-2); exact launches of a step (6 ``csr_spmm``, each
   attention kernel once) and of an eval batch's forward a rank, its logits
   (the unsharded twin) against the plain forward's; every rank's state
   after the step bitwise rank 0's; step and
   forward ms and peak MiB; an epoch's wall time with the remainder step;
   ``fit`` for one epoch (launches, finite losses, the accuracies equal on
   every rank); each collective by axis, all on the card; with dp = 2 the
   tail at small width (n = 241, B = 120, f32: a full step and the
   remainder step against the plain versions, loss 1e-5 and gradients
   1e-4; a remainder group of 0 real nodes runs a full step's launches, the
   state stays finite).

The second-to-last line is a JSON object of per-kernel numbers (with each
forward kernel's custom op and its launches in one exported forward, and
arxiv-sharded-train's and arxiv-dp-batch-train's launches on rank 0 of
each group); the last is
``{"ok": true, "device": {...}}``. Exits non-zero, with no result line, when
CUDA is absent or any check fails.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
import warnings
from unittest import mock

import torch

from sgformer_tpu_torch.utils.measure import (PEAK_OPS, apply_product_inputs, bound_ms,
                                              card_line, rel_err, time_ms)

T0 = time.perf_counter()

# tolerances of kernel against plain version on the same inputs:
# f32: the kernels and the plain versions differ only in summation order
# (TF32 is off for the plain products); bf16: only the rounding of the
# output to bf16 may differ, one bf16 ulp is 2^-8 relative
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}
# the reduce's f32 sums over N rows, as a share of their largest magnitude
REDUCE_REL_TOL = 1e-5
# the backward reduce with n = 1 and positive inputs, where q @ kvs carries
# den and gden: kvs and g/den enter the tensor cores as bf16 hi + lo (~16
# significant bits, 2^-17 of each term), so 2^-14 of each output's scale
N1_REL_TOL = 2.0 ** -14
# the backward kernels' outputs against their plain versions, as a share
# of each output's largest magnitude: the forward's tolerances (f32: order
# of the sums only; bf16: one-ulp output rounding), taken relative to the
# output's scale because the gradients at N = 169,343 are as small as 1e-9
BWD_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# serving path against the plain forward, both bf16 (summation order and
# one-ulp bf16 roundings propagate through 3 GCN layers and the head)
LOGITS_ATOL = 5e-2
ARGMAX_AGREEMENT = 0.99
# rounds of the five request kinds on the serving path
REQUEST_ROUNDS = 5
# one train step through the kernels against the same step through the plain
# versions, both bf16: summation order and one-ulp roundings differ
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GRAD_RTOL = 2e-2
TRAIN_EPOCHS, TRAIN_WARMUP = 20, 3
# the timing probes' kernels: no model path launches them
PROBES = ("gather_rows", "gather_tiles", "slab_variant")
# sha256 (16 hex digits) of the gather probes' outputs at the probes' own
# sizes (dma_gather.make_inputs, dma_tile.make_inputs: host-made) from the
# kernels the persistent ones replaced (one block a chunk or a step), by
# (kernel, S); both keep each group's order of terms, so the outputs stay
# bitwise the same
PROBE_DIGESTS = {("gather_rows", 4): "0637cfba966424c1", ("gather_rows", 8): "0637cfba966424c1",
                 ("gather_rows", 16): "0637cfba966424c1", ("gather_rows", 32): "0637cfba966424c1",
                 ("gather_tiles", 8): "ee9d6f038ab452cb", ("gather_tiles", 32): "8f92d192ff3fba5c"}
# launches of one train step of the bench model (3 GraphConv layers)
STEP_LAUNCHES = {"csr_spmm": 6, "linear_attention_reduce": 1,
                 "linear_attention_apply": 1, "linear_attention_bwd_reduce": 1,
                 "linear_attention_bwd_apply": 1, "csr_spmm_ev": 0, "csr_spmm_ev_bwd": 0,
                 "sddmm": 0, "csr_spmm_q8": 0, "quantize_absmax": 0,
                 **dict.fromkeys(PROBES, 0)}
# launches of one forward of the bench model (serving, evaluation)
FORWARD_LAUNCHES = dict(STEP_LAUNCHES, csr_spmm=3, linear_attention_bwd_reduce=0,
                        linear_attention_bwd_apply=0)
# arxiv-gat-train: GAT at the bench model's width, the CLI's baseline
# optimiser (cli/parse.py, cli/main.py of the JAX package)
GAT_CONFIG = dict(hidden_channels=256, out_channels=40, num_layers=2, heads=2,
                  out_heads=1, dropout=0.5, use_bn=True)
GAT_TRAIN = dict(lr=0.01, trans_weight_decay=5e-3, gnn_weight_decay=5e-3)
# (heads, D) of GAT_CONFIG's two aggregations
GAT_LAYERS = ((2, 256), (1, 40))
# launches of one GAT train step (2 aggregations forward, 2 backward walks
# of the transposed order, each giving dx and dv) and of one eval forward
GAT_STEP_LAUNCHES = dict(STEP_LAUNCHES, csr_spmm=0, linear_attention_reduce=0,
                         linear_attention_apply=0, linear_attention_bwd_reduce=0,
                         linear_attention_bwd_apply=0, csr_spmm_ev=2, csr_spmm_ev_bwd=2)
GAT_FORWARD_LAUNCHES = dict(GAT_STEP_LAUNCHES, csr_spmm_ev_bwd=0)
# one GAT train step through the kernels against the same step through the
# plain versions: the forward sends the same bf16 messages and sums them in
# f32 in another order (loss 1e-4); the plain backward (torch autograd of
# the plain forward) rounds dx's sums to bf16 where the kernel rounds g, and
# reads the rounded x for dv where the kernel reads x: one bf16 rounding,
# 2^-8, of the terms (gradients 2e-2, as TRAIN_GRAD_RTOL)
GAT_LOSS_RTOL = 1e-4
GAT_GRAD_RTOL = 2e-2
# eval logits through the kernels against the plain forward, as a share of
# their largest magnitude: the same roundings, another summation order,
# amplified through two layers of attention softmax
GAT_LOGITS_RTOL = 1e-3
# large-400K-int8-train: the JAX package's large-400K shape
# (scripts/bench_shapes.py:34), the graph on which it picks int8 itself
LARGE_400K = dict(num_nodes=400_000, num_edges=4_800_000, num_features=128, num_classes=40,
                  seed=0)
LARGE_400K_GRAPH = (400_000, 9_991_628)  # N and E after symmetrising and self-loops
# launches of one train step and one forward on an int8 graph: every GCN
# aggregation (3 forward, 3 on the transpose) is the quantiser kernel (on x
# or on g) and then the int8 kernel
Q8_STEP_LAUNCHES = dict(STEP_LAUNCHES, csr_spmm=0, csr_spmm_q8=6, quantize_absmax=6)
Q8_FORWARD_LAUNCHES = dict(FORWARD_LAUNCHES, csr_spmm=0, csr_spmm_q8=3, quantize_absmax=3)
# csr_spmm_q8 against its plain version on the same quantised rows: the
# integer sums are exact and the epilogue is the same f32 operations in the
# same order, so at most the last rounding may differ: one ulp of the output
# type, relative (bf16 keeps 8 significant bits, f32 24)
Q8_ULP = {torch.bfloat16: 2.0 ** -7, torch.float32: 2.0 ** -23}
# the JAX package's power-law bench graph (BENCH.md, scripts/microbench_hub.py)
POWERLAW_GRAPH = dict(num_nodes=169_343, num_edges=1_166_243, num_features=128,
                      num_classes=40, powerlaw=1.1, seed=0)
# hub segment lengths timed beside the one the kernel uses (log only)
HUB_SWEEP = (64, 128, 256, 512, 1024)
# the row walk's width sweep: csr_spmm at these F and csr_spmm_ev at these
# (H, D) on the arxiv graph; csr_spmm at F = 40 on the power-law graph
SWEEP_WIDTHS = (32, 40, 64, 128, 256)
SWEEP_EV_SHAPES = ((1, 40), (2, 40), (2, 256))
SWEEP_POWERLAW_WIDTHS = (40,)
# device kernels by group in the profile summary, by a mark in their names
PROFILE_GROUPS = (
    ("port kernels", ("la_", "csr_spmm", "ev_bwd", "absmax_partial", "quantize_kernel",
                      "split_kvs_kernel", "split_t_kernel")),
    ("collectives (NCCL)", ("nccl",)),
    ("host copies", ("Memcpy",)),
    ("GEMMs", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
    ("reductions", ("reduce_kernel",)),
    ("dtype copies", ("copy_kernel",)),
    ("norm kernels", ("layer_norm", "batch_norm")),
)
BENCH_CONFIG = dict(trans_num_layers=1, gnn_num_layers=3, graph_weight=0.5,
                    compute_dtype="bf16")
# amazon2m-batch-train: the repo's amazon2m recipe (configs/large.sh, f32,
# the CLI's default) at the ogbn-products graph's size (the SGFormer
# reference's large/dataset.py amazon2m loader; the JAX package's
# data/loaders.py), 100,000 nodes a batch
AMAZON2M = dict(num_nodes=2_449_029, num_edges=61_859_140, num_features=100, num_classes=47,
                seed=0)
AMAZON2M_CONFIG = dict(trans_num_layers=1, gnn_num_layers=3, graph_weight=0.5, gnn_dropout=0.0,
                       trans_dropout=0.0, gnn_use_init=True)
AMAZON2M_TRAIN = dict(lr=0.01, trans_weight_decay=0.0, gnn_weight_decay=0.0)
AMAZON2M_BATCH = 100_000
# the backward reduce's rows pass and P pass timed apart at M = D = 256
# on the rows of the arxiv graph, of a full amazon2m batch and of a
# papers-sampled batch (~621,000 nodes at PAPERS' fanouts)
BWD_PASS_SHAPES = (("arxiv", 169_343), ("amazon2m-batch", AMAZON2M_BATCH),
                   ("papers-sampled", 621_432))
# arxiv-batch-train: the bench model, 50,000 nodes a batch
ARXIV_BATCH = 50_000
# a batch step through the kernels against the plain versions, f32 (TF32
# off): the loss relative, the gradients' norms relative, the logits as a
# share of the largest; summation order only
BATCH_LOSS_RTOL = 1e-5
BATCH_GRAD_RTOL = 1e-4
BATCH_LOGITS_RTOL = 1e-4
# batches of the bf16 timing of the amazon2m step (the first is not counted)
BF16_BATCHES = 6
# the kernels a batch step runs
BATCH_KERNELS = ("csr_spmm", "linear_attention_reduce", "linear_attention_apply",
                 "linear_attention_bwd_reduce", "linear_attention_bwd_apply")
# the JAX bench's optimiser (scripts/bench_shapes.py:68)
BENCH_TRAIN = dict(lr=1e-3, trans_weight_decay=0.0, gnn_weight_decay=0.0)
# papers-sampled-train: the repo's papers100M recipe (configs/100m.sh:9-14;
# f32, the CLI's default; the CLI's trans_weight_decay) behind
# SampledTrainer, on a synthetic graph of ogbn-papers100M's shape: its
# directed edges a node (1.6B / 111M, ~14.55), 128 features and 172
# classes, cut from 111M nodes to 2M
PAPERS = dict(num_nodes=2_000_000, num_edges=29_100_000, num_features=128, num_classes=172,
              seed=0)
PAPERS_CONFIG = dict(trans_num_layers=1, gnn_num_layers=3, graph_weight=0.8, gnn_dropout=0.2,
                     trans_dropout=0.5, gnn_use_init=True)
PAPERS_TRAIN = dict(lr=1e-3, trans_weight_decay=1e-3, gnn_weight_decay=1e-5, batch_size=1000,
                    fanouts=(15, 10, 5))
# ogbn-papers100M's labelled nodes in each split, and its node count: the
# synthetic graph's splits take the same shares
PAPERS_SPLIT = dict(train=1_207_179, valid=125_265, test=214_338)
PAPERS_NODES = 111_059_956
# train batches sampled and timed one by one beside the fit
PAPERS_SAMPLES = 5

# the cli phase: the port's CLI (python -m sgformer_tpu_torch.cli.main)
# running the repo's recipes, their flags read from the port's recipe files
# (the counterparts of configs/large.sh and configs/100m.sh), cut in epochs
# and runs only
CLI_ARXIV_CUT = ["--runs", "1", "--epochs", "18", "--eval_step", "9"]
CLI_BATCH_CUT = ["--dataset", "ogbn-arxiv", "--runs", "1", "--batch_size", "50000",
                 "--epochs", "2"]
CLI_SAMPLED_DATASET = "synth-n20000-e120000-f128-c16"
CLI_H2GCN = ["--method", "h2gcn", "--dataset", CLI_SAMPLED_DATASET, "--trainer", "full",
             "--hidden_channels", "64", "--num_layers", "2", "--rand_split", "--runs", "1",
             "--display_step", "-1"]
# H2GCN, 2 rounds: each round aggregates on A1 and on A2 (4 csr_spmm a
# forward), and the gradient walks both again
H2GCN_STEP_LAUNCHES = dict(STEP_LAUNCHES, csr_spmm=8, linear_attention_reduce=0,
                           linear_attention_apply=0, linear_attention_bwd_reduce=0,
                           linear_attention_bwd_apply=0)
H2GCN_FORWARD_LAUNCHES = dict(H2GCN_STEP_LAUNCHES, csr_spmm=4)
# H2GCN's step through the kernels against the plain step: f32, summation
# order only
H2GCN_LOSS_RTOL = 1e-5
H2GCN_GRAD_RTOL = 1e-4

# the zoo phase: the attention ablations and the graph-transformer zoo
# through the CLI, on seeded data of the shapes the repo's recipes name,
# written in the layouts the port's loaders read: Cora (Planetoid npz) and
# the filtered squirrel (wiki_new npz with its 10 split masks)
ZOO_CORA = dict(num_nodes=2708, num_edges=10556, num_features=1433, num_classes=7)
ZOO_SQUIRREL = dict(num_nodes=2223, num_edges=46998, num_features=2089, num_classes=5)
# the recipes' 500 epochs and 5 or 10 runs, cut to 20 epochs and 1 run
ZOO_EPOCHS = 20
ZOO_CUT = ["--runs", "1", "--epochs", str(ZOO_EPOCHS), "--display_step", "-1"]
ZERO_LAUNCHES = dict.fromkeys(STEP_LAUNCHES, 0)
SIMPLE_ATTENTION = {"linear_attention_reduce": 1, "linear_attention_apply": 1,
                    "linear_attention_bwd_reduce": 1, "linear_attention_bwd_apply": 1}
# run -> (flags after the recipe's, csr_spmm a train step, attention kernels
# a step (the 'simple' control only), parameters whose exact gradient is 0 ->
# the parameter whose gradient they are held to, as in bench_model): each
# propagate is one csr_spmm forward and one on the transpose in the backward
ZOO_RUNS = {
    # the ablations: the GCN biases before a train-mode BatchNorm; and the
    # key bias, which shifts every score of a row alike (gat: a softmax over
    # the sources does not see it, its exact gradient is 0; softmax and
    # performer: nearly so), held to the key weight's
    **{f"ablation-{k}": (["ablation.sh", k], 8, SIMPLE_ATTENTION if k == "simple" else {}, {
        **{f"gcn.conv_{i}.bias": f"gcn.bn_{i}.bias" for i in range(3)},
        **({} if k == "simple" else
           {"trans_conv.conv_0.Wk.bias": "trans_conv.conv_0.Wk.weight"})})
       for k in ("simple", "softmax", "gat", "performer")},
    # 8 DIFFormer layers, one value GCN each; a key bias's exact gradient
    # nearly cancels over the rows (a shift of every key moves the globally
    # normalised attention little: ~1e-2 of the key weight's gradient), so
    # it is held to the key weight's
    "squirrel-difformer": (["medium.sh", "difformer"], 16, {},
                           {f"conv_{i}.Wk.bias": f"conv_{i}.Wk.weight" for i in range(8)}),
    # the JAX CLI's defaults (hidden 32, 2 layers, 1 head, dropout 0.5):
    # NodeFormer's 2 layers aggregate on A+I and (A+I)^2, GraphGPS's and
    # GraphTrans's 2 GCN layers once each, Graphormer none
    "nodeformer": (["--method", "nodeformer"], 8, {}, {}),
    # GraphGPS: the local GCN's bias feeds a train-mode BatchNorm, whose
    # own shift feeds the layer's last BatchNorm, so both gradients are
    # near 0: the bias is held to the GCN kernel's; q and k enter FAVOR+ only
    # through ratios of their random features, whose common factors cancel
    # (their gradients ~1e-1 to 1e-2 of v's), so they are held to v's
    "graphgps": (["--method", "graphgps"], 4, {}, {
        **{f"layer_{i}.local.bias": f"layer_{i}.local.kernel" for i in range(2)},
        **{f"layer_{i}.self_attn.to_{w}.weight": f"layer_{i}.self_attn.to_v.weight"
           for i in range(2) for w in "qk"}}),
    # GraphTrans and Graphormer: a key bias adds the same q.b to every score
    # of a row, which a softmax over the keys does not see (exact gradient
    # 0), held to the key kernel's; GraphTrans's first GCN bias feeds a
    # train-mode BatchNorm
    "graphtrans": (["--method", "graphtrans"], 4, {}, {
        "gnn.conv_0.bias": "gnn.bn_0.bias",
        **{f"layer_{i}.self_attn.key.bias": f"layer_{i}.self_attn.key.kernel"
           for i in range(3)}}),
    "graphormer": (["--method", "graphormer"], 0, {},
                   {f"layer_{i}.k.bias": f"layer_{i}.k.kernel" for i in range(2)}),
}
# one step through the kernels against the plain step, and the eval logits
# against the plain forward: f32, summation order only
ZOO_LOSS_RTOL = 1e-5
ZOO_GRAD_RTOL = 1e-4
ZOO_LOGITS_RTOL = 1e-5

# serve-export: Trainer steps before a checkpoint, and timed requests
# through the exported forward and through Predictor.logits()
CHECKPOINT_STEPS = 3
EXPORT_REQUESTS = 25
# the zoo models that need model_kwargs behind a Predictor (NodeFormer also
# returns a tuple): csr_spmm launches of one forward (NodeFormer's 2 layers
# on A+I and (A+I)^2, H2GCN's 2 rounds on A1 and A2, Graphormer none)
SERVE_ZOO = {"nodeformer": 4, "h2gcn": 4, "graphormer": 0}

DTYPE_NAME = {torch.bfloat16: "bf16", torch.float32: "f32"}

# arxiv-sharded-train: the bench model with axis_name="sp" behind
# ShardedTrainer on synth-arxiv with the clustering reorder, a group of one
# rank on NCCL and two ranks sharing the card under gloo. Each rank runs
# every GraphConv layer's aggregation on its shard: one csr_spmm over the
# all-gathered rows forward and one on the transpose backward, or with the
# halo three each way (the send gather, the local and the remote CSR)
SHARDED_GCN_LAYERS = BENCH_CONFIG["gnn_num_layers"]
SHARDED_FORMS = {False: 1, True: 3}  # csr_spmm a propagate: all-gather, halo
SHARDED_RUNS = (("nccl", 1), ("gloo", 2))
SHARDED_CLI_EPOCHS = 18
# arxiv-dp-batch-train: the bench model behind DPBatchTrainer on the arxiv
# batch-tier edge list, batches of ARXIV_BATCH: (backend, dp, sp) of each
# spawned group (NCCL refuses two ranks on one card, so the 2 x 2 grid runs
# under gloo)
DP_RUNS = (("nccl", 1, 1), ("gloo", 2, 2))
# the tail at small width (the JAX test's graph): with dp = 2 and batches of
# 120, the remainder step's groups hold 1 and 0 real nodes
DP_TAIL = dict(num_nodes=241, num_edges=2000, num_features=12, num_classes=4, seed=3)
DP_TAIL_BATCH = 120


def log(msg: str) -> None:
    print(f"[chip_smoke +{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


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


def check_rel(what: str, got, want, rel: float) -> float:
    """max |got - want| <= rel * max |want|, and got finite."""
    err, scale = rel_err(got, want)
    log(f"{what}: max |kernel - plain| = {err:.3e}, {err / max(scale, 1e-30):.2e} of "
        f"its largest magnitude {scale:.3e} (tolerance {rel})")
    if not err <= rel * scale:
        raise AssertionError(f"{what} disagrees with plain")
    return err


def library_time(what: str, fn):
    """ms of a PyTorch yardstick call, or None where the card's build does
    not offer it for these inputs (the port never calls it)."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            return time_ms(fn)
    except RuntimeError as exc:
        log(f"{what}: not available ({str(exc).splitlines()[0]})")
        return None


def walk_orders(graph) -> tuple[dict, str]:
    """The keyword arguments that give ``csr_spmm`` and ``csr_spmm_ev`` the
    walk order of ``graph``'s A (none for a package or graph without one),
    and its name for the log."""
    order = getattr(graph, "schedule", None)
    if order is None:
        return {}, "node order"
    return {"schedule": order}, "the graph's walk order"


def spmm_phase(graph, results: dict, dev: str, key: str = "csr_spmm",
               sweep: bool = False) -> None:
    """csr_spmm on ``graph`` at F = 256 through the graph's hub plan in its
    walk order (``Graph.schedule``), bf16 and f32: against its plain
    version, bitwise repeatable and bitwise the walk in node order, with
    time (and node order's), gathered rate, bound, plain and library time.
    ``sweep`` also times the kernel with the hub segment lengths of
    ``HUB_SWEEP``, each plan passed with its length (bf16, each against
    plain)."""
    from sgformer_tpu_torch.kernels.spmm import csr_spmm, hub_plan
    from sgformer_tpu_torch.ops.spmm import spmm as spmm_plain

    n, e, f = graph.num_nodes, graph.num_edges, 256
    gen = torch.Generator(device=dev).manual_seed(1)
    segs = graph.hub_segments
    args = (graph.indptr, graph.edge_src, graph.edge_dst, graph.gcn_weight, segs,
            graph.hub_edges)
    order, order_name = walk_orders(graph)
    hub_rows = torch.unique(segs[:, 0]).numel()
    log(f"{key}: {segs.shape[0]} hub segments of at most {graph.hub_edges} edges over "
        f"{hub_rows} rows, {int((segs[:, 2] - segs[:, 1]).sum().item())} edges; rows walked "
        f"in {order_name}")
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(n, f, generator=gen, device=dev).to(dtype)
        got = csr_spmm(x, *args, **order)
        want = spmm_plain(x, graph.edge_src, graph.edge_dst, graph.gcn_weight, n)
        torch.cuda.synchronize()
        name = DTYPE_NAME[dtype]
        err = check_close(f"{key} {name} F={f}", got, want, **TOL[dtype])
        if not torch.equal(got, csr_spmm(x, *args, **order)):
            raise AssertionError("csr_spmm is not bitwise repeatable")
        if not torch.equal(got, csr_spmm(x, *args)):
            raise AssertionError("csr_spmm in the walk order is not bitwise node order's")
        ms = time_ms(lambda: csr_spmm(x, *args, **order))
        node_ms = time_ms(lambda: csr_spmm(x, *args)) if order else ms
        plain_ms = time_ms(lambda: spmm_plain(
            x, graph.edge_src, graph.edge_dst, graph.gcn_weight, n))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            a = torch.sparse_csr_tensor(graph.indptr, graph.edge_src,
                                        graph.gcn_weight.to(dtype), size=(n, n))
        library_ms = library_time(f"torch.sparse.mm {name}", lambda: torch.sparse.mm(a, x))
        elt = x.element_size()
        nbytes = 2 * n * f * elt + e * (4 + 4) + (n + 1) * 4
        b_ms, b_by = bound_ms(nbytes, 2 * e * f, dtype)
        gathered = e * f * elt
        log(f"{key} {name}: {ms:.4f} ms in {order_name}, gathers {gathered / 1e6:.1f} MB of "
            f"rows at {gathered / ms / 1e9:.2f} TB/s (node order {node_ms:.4f} ms, "
            f"{gathered / node_ms / 1e9:.2f} TB/s; bitwise the same) (plain {plain_ms:.4f} ms, "
            f"torch.sparse.mm {library_ms} ms, bound {b_ms:.4f} ms by {b_by})")
        results[(key, name)] = dict(
            max_abs_err=err, ms=ms, node_order_ms=node_ms, gather_tb_per_s=gathered / ms / 1e9,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
            hub_segments=segs.shape[0])
        if sweep and dtype == torch.bfloat16:
            for t in HUB_SWEEP:
                plan = hub_plan(graph.indptr, t)
                check_close(f"{key} {name} segments of {t}",
                            csr_spmm(x, *args[:4], plan, t, **order), want, **TOL[dtype])
                t_ms = time_ms(lambda: csr_spmm(x, *args[:4], plan, t, **order))
                log(f"{key} {name} segments of at most {t} edges: {plan.shape[0]} segments, "
                    f"{t_ms:.4f} ms")
                results[(key, name)][f"seg{t}_ms"] = t_ms


def bound_name(by: str, dtype) -> str:
    """A bound's name for the log: bytes, or operations at the peak
    ``PEAK_OPS`` takes for ``dtype`` (f32: the 3xTF32 rate, three TF32
    tensor-core products at 495 TFLOP/s for each f32 one)."""
    if by == "bytes":
        return by
    rate = f"{PEAK_OPS[dtype] / 1e12:g} TFLOP/s"
    return f"operations (3xTF32, {rate})" if dtype == torch.float32 else f"operations ({rate})"


# the forward and backward applies' kernels at the model's width, by input
# type: each design string names its kernel
APPLY_KERNELS = {torch.float32: "la_apply_wg_kernel", torch.bfloat16: "la_apply_wgmma_kernel"}
BWD_APPLY_KERNELS = {torch.float32: "la_bwd_apply_ws_kernel",
                     torch.bfloat16: "la_bwd_apply_ws16_kernel"}


def fwd_designs(attn, dtype, m: int, d: int, where: str) -> tuple[str, str]:
    """The forward reduce's and apply's designs for these widths, logged; at
    the model's width both take the tensor cores (f32 in 3xTF32), the apply
    its kernel of ``APPLY_KERNELS``."""
    red_design, design = attn.reduce_design(dtype, m, d), attn.apply_design(dtype, m, d)
    name = DTYPE_NAME[dtype]
    log(f"reduce {name} design at {where}: {red_design}")
    log(f"apply {name} design at {where}: {design}")
    want = (("tensor cores (wgmma 3xTF32", "tensor cores (wgmma 3xTF32")
            if dtype == torch.float32 else ("tensor cores (wgmma bf16", "tensor cores (wgmma"))
    if (m, d) == (256, 256) and not (red_design.startswith(want[0])
                                     and design.startswith(want[1])
                                     and APPLY_KERNELS[dtype] in design):
        raise AssertionError(f"the {name} forward kernels at M = D = 256 are not the "
                             f"tensor-core design")
    return red_design, design


def reduce_f64(q, k, v) -> tuple:
    """The reduce's sums evaluated in f64: kvs, ksum and (||q||^2, ||k||^2)
    (``reduce_plain`` sums in f32 whatever its inputs' type)."""
    qd, kd, vd = q.double(), k.double(), v.double()
    return kd.T @ vd, kd.sum(0), torch.stack([qd.square().sum(), kd.square().sum()])


def kernel_ms(run, names: tuple, reps: int = 20) -> dict:
    """Device ms a call of each kernel of ``names`` that ``run`` launches,
    from torch.profiler (CUPTI) over ``reps`` calls after one warm-up."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        for name in names:
            if name in e.key:
                out[name] += device_us(e) / reps / 1e3
    return out


def bwd_designs(attn, dtype, m: int, d: int, where: str) -> tuple[str, str]:
    """The backward apply's and reduce's designs for these widths, logged;
    at the model's width both take the tensor cores on warpgroup MMAs (f32
    in 3xTF32; bf16), the apply its kernel of ``BWD_APPLY_KERNELS`` and the
    reduce its rows pass and P pass of ``BWD_REDUCE_KERNELS``."""
    design, red_design = attn.bwd_apply_design(dtype, m, d), attn.bwd_reduce_design(dtype, m, d)
    name = DTYPE_NAME[dtype]
    log(f"bwd_apply {name} design at {where}: {design}")
    log(f"bwd_reduce {name} design at {where}: {red_design}")
    want = (("tensor cores (wgmma 3xTF32", "tensor cores (wgmma 3xTF32, f32 sums: rows pass")
            if dtype == torch.float32 else ("tensor cores (wgmma bf16", "tensor cores (wgmma bf16"))
    rows_pass, p_pass = BWD_REDUCE_KERNELS[dtype][:2]
    if (m, d) == (256, 256) and not (design.startswith(want[0]) and red_design.startswith(want[1])
                                     and rows_pass in red_design and p_pass in red_design
                                     and BWD_APPLY_KERNELS[dtype] in design):
        raise AssertionError(f"the {name} backward kernels at M = D = 256 are not the "
                             f"tensor-core design")
    return design, red_design


# the backward reduce's launches by kernel name, by input type: its rows
# pass, its P pass, and the split of kvs, the P finish and the dinv sum
BWD_REDUCE_KERNELS = {
    torch.float32: ("la_bwd_rows_ws_kernel", "la_bwd_reduce_wg_kernel", "split_kvs_kernel",
                    "la_bwd_finish_kernel", "la_bwd_dinv_kernel"),
    torch.bfloat16: ("la_bwd_rows_ws16_kernel", "la_bwd_reduce_ws16_kernel",
                     "la_bwd_split_rows_kernel", "la_bwd_finish_kernel", "la_bwd_dinv_kernel"),
}


def bwd_reduce_ops(n: int, m: int, d: int, dtype) -> int:
    """The backward reduce's operations on n rows: its products at the
    precision its tolerance needs (f32: q @ kvs and q^T gd, each three TF32
    products at the 3xTF32 rate; bf16: five bf16 products, kvs as hi + mid
    + lo and g/den as hi + lo) and its row and column sums."""
    return (4 if dtype == torch.float32 else 10) * n * m * d + 6 * n * d + 2 * n * m


def bwd_passes_ms(attn, n: int, dev: str, dtype=torch.float32) -> dict:
    """The backward reduce's launches apart (``kernel_ms``) at M = D = 256
    on n random rows of ``dtype``: rows pass, P pass and the rest, device ms
    a call; beside the P pass its bound (its products at the type's peak:
    one f32 product in 3xTF32, or two bf16 ones, g/den's hi and lo; or the
    bytes of q, g, den, gden, P and ds) and the yardstick of
    its product, ``torch.matmul(q.t(), gd)`` in the inputs' type (TF32 off)
    with gd = g / den made beforehand (never called by the port)."""
    gen = torch.Generator(device=dev).manual_seed(11)
    m = d = 256
    q, v, g = (torch.randn(n, m, generator=gen, device=dev).to(dtype) for _ in range(3))
    sums = attn.reduce_plain(q, q, v, False)
    n_t = torch.full((), float(n), device=dev)
    names = BWD_REDUCE_KERNELS[dtype]
    dev_ms = kernel_ms(lambda: attn.bwd_reduce(q, v, g, *sums, n_t), names)
    gd = (g.float() / attn.bwd_reduce(q, v, g, *sums, n_t)[3][0][:, None]).to(dtype)
    p_matmul_ms = time_ms(lambda: torch.matmul(q.t(), gd))
    p_bound_ms, p_bound_by = bound_ms((n * m + n * d) * q.element_size() + 2 * n * 4
                                      + (m * d + m) * 4,
                                      (2 if dtype == torch.float32 else 4) * n * m * d, dtype)
    return dict(rows_ms=dev_ms[names[0]], p_pass_ms=dev_ms[names[1]],
                others_ms=sum(dev_ms[k] for k in names[2:]), p_pass_bound_ms=p_bound_ms,
                p_pass_bound_by=p_bound_by, p_pass_matmul_ms=p_matmul_ms)


def attention_phase(n: int, results: dict, dev: str) -> None:
    from sgformer_tpu_torch.kernels import attention as attn
    from sgformer_tpu_torch.ops.attention import linear_attention
    from sgformer_tpu_torch.utils.measure import reduce_product_inputs

    m = d = 256
    gen = torch.Generator(device=dev).manual_seed(2)
    for dtype in (torch.bfloat16, torch.float32):
        name = DTYPE_NAME[dtype]
        design, apply_design = fwd_designs(attn, dtype, m, d, f"n={n}")
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

        # apply alone at n = N on the plain reduce's outputs, bitwise repeatable
        n_t = torch.full((), float(n), device=dev)
        got_a = attn.apply(q, v, *want_r, n_t)
        check_close(f"apply {name} (n = N)", got_a, attn.apply_plain(q, v, *want_r, n_t, False),
                    **TOL[dtype])
        if not torch.equal(got_a, attn.apply(q, v, *want_r, n_t)):
            raise AssertionError("apply is not bitwise repeatable")
        del got_a
        # apply alone on inputs where q @ kvs carries the output and every
        # (m, d) pairing of kvs moves it, against the plain version in f64;
        # for bf16 also where large kvs terms cancel, so that kvs rounded to
        # bf16 (the tensor cores' lo piece dropped) would miss the tolerance
        # (drawn from a generator of their own, so the other checks' inputs
        # stay as they were)
        gen_p = torch.Generator(device=dev).manual_seed(7)
        for cancel in (False, True) if dtype == torch.bfloat16 else (False,):
            ins = apply_product_inputs(n, m, d, dtype, gen_p, cancel)
            check_close(f"apply {name} (q @ kvs carries it{', kvs terms cancel' if cancel else ''}"
                        f", plain in f64)", attn.apply(*ins),
                        attn.apply_plain(*(t.double() for t in ins), False), **TOL[dtype])
            del ins
        # apply alone with n = 1 and positive q, k, v, kvs from the plain reduce
        qp, kp, vp = (torch.rand(n, m, generator=gen, device=dev).to(dtype)
                      for _ in range(3))
        kvs_p, ksum_p, scal_p = attn.reduce_plain(qp, kp, vp, False)
        one = torch.ones((), device=dev)
        got_a = attn.apply(qp, vp, kvs_p, ksum_p, scal_p, one)
        want_a = attn.apply_plain(qp, vp, kvs_p, ksum_p, scal_p, one, False)
        app_err = check_close(f"apply {name} (n = 1)", got_a, want_a, **TOL[dtype])
        # the reduce on the same positive inputs, where no sum cancels,
        # against its sums evaluated in f64
        exact = reduce_f64(qp, kp, vp)
        got_p = attn.reduce(qp, kp, vp)
        for part, g_, w_ in (("kvs", got_p[0], exact[0]), ("ksum", got_p[1], exact[1]),
                             ("qsq, ksq", got_p[2][:2], exact[2])):
            check_rel(f"reduce {name} {part} (positive inputs, sums in f64)", g_, w_,
                      REDUCE_REL_TOL)
        del exact, got_p
        # the reduce where its products carry kvs (positive values a fraction
        # of a tf32 step above tf32 values: a dropped tf32 lo piece would
        # miss the tolerance), against its sums in f64, bitwise repeatable
        qr, kr, vr = reduce_product_inputs(n, m, d, dtype, gen_p)
        exact, got_p = reduce_f64(qr, kr, vr), attn.reduce(qr, kr, vr)
        for part, g_, w_ in (("kvs", got_p[0], exact[0]), ("ksum", got_p[1], exact[1]),
                             ("qsq, ksq", got_p[2][:2], exact[2])):
            check_rel(f"reduce {name} {part} (products carry it, sums in f64)", g_, w_,
                      REDUCE_REL_TOL)
        if not all(torch.equal(a, b) for a, b in zip(got_p, attn.reduce(qr, kr, vr))):
            raise AssertionError(f"reduce {name} is not bitwise repeatable")
        del qr, kr, vr, exact, got_p

        r_ms = time_ms(lambda: attn.reduce(q, k, v))
        r_plain = time_ms(lambda: attn.reduce_plain(q, k, v, False))
        # yardstick: the core product k^T v alone in one torch.matmul, in the
        # inputs' type (never called by the port)
        gemm_ms = time_ms(lambda: torch.matmul(k.t(), v))
        a_ms = time_ms(lambda: attn.apply(q, v, kvs, ksum, scal, n_t))
        a_plain = time_ms(lambda: attn.apply_plain(q, v, kvs, ksum, scal, n_t, False))
        # yardstick: the apply's core product q @ kvs alone in one
        # torch.matmul, in the inputs' type (never called by the port)
        kvs_t = kvs.to(dtype)
        a_gemm_ms = time_ms(lambda: torch.matmul(q, kvs_t))
        del kvs_t
        elt = q.element_size()
        rb_ms, rb_by = bound_ms(3 * n * m * elt + (m * d + m + 4) * 4,
                             2 * n * m * d + 3 * n * m, dtype)
        ab_ms, ab_by = bound_ms(3 * n * m * elt + (m * d + m + 4) * 4,
                             2 * n * m * d + 2 * n * m + 4 * n * d, dtype)
        log(f"reduce {name}: {r_ms:.4f} ms (plain {r_plain:.4f} ms, torch.matmul k^T v "
            f"{gemm_ms:.4f} ms, bound {rb_ms:.4f} ms by {bound_name(rb_by, dtype)}); apply "
            f"{name}: {a_ms:.4f} ms (plain {a_plain:.4f} ms, torch.matmul q @ kvs "
            f"{a_gemm_ms:.4f} ms, bound {ab_ms:.4f} ms by {bound_name(ab_by, dtype)})")
        results[("linear_attention_reduce", name)] = dict(
            max_abs_err=red_err, ms=r_ms, plain_ms=r_plain, bound_ms=rb_ms,
            bound_by=rb_by, library_ms=None, gemm_ms=gemm_ms, design=design)
        results[("linear_attention_apply", name)] = dict(
            max_abs_err=app_err, ms=a_ms, plain_ms=a_plain, bound_ms=ab_ms,
            bound_by=ab_by, library_ms=None, gemm_ms=a_gemm_ms, design=apply_design)

    # an all-masked group: zero norms must give finite zeros, as the plain
    # (guarded) path does
    qs, ks, vs = (torch.randn(n, 1, m, generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(3))
    mask = torch.zeros(n, device=dev)
    got = attn.fused_linear_attention(qs, ks, vs, node_mask=mask)
    want = linear_attention(qs, ks, vs, node_mask=mask)
    check_close("fused_linear_attention all-masked bf16", got, want,
                **TOL[torch.bfloat16])


def check_bwd_reduce_f64(attn, what: str, ins) -> None:
    """The backward reduce on ``ins`` (its arguments) against its plain
    version in f64: P, ds, den and gden within REDUCE_REL_TOL of their
    scale, dinv of its two sums' magnitude; bitwise repeatable."""
    got = attn.bwd_reduce(*ins)
    ind = [t.double() for t in ins]
    exact = attn.bwd_reduce_plain(*ind, False)
    for part, a, b in (("P", got[0], exact[0]), ("ds", got[1], exact[1]),
                       ("den, gden", got[3], exact[3])):
        check_rel(f"{what} {part} (plain in f64)", a, b, REDUCE_REL_TOL)
    qd, _, gd_, kvs_d, ksum_d = ind[:5]
    den, gden = exact[3]
    dinv_scale = ((gd_ / den[:, None] * (qd @ kvs_d)).abs().sum()
                  + (gden * (qd @ ksum_d)).abs().sum()).item()
    dinv_err = abs(got[2].item() - exact[2].item())
    log(f"{what} dinv: {dinv_err / dinv_scale:.2e} of its sums' magnitude (tolerance "
        f"{REDUCE_REL_TOL})")
    if not dinv_err <= REDUCE_REL_TOL * dinv_scale:
        raise AssertionError(f"{what} dinv disagrees with plain")
    if not all(torch.equal(a, b) for a, b in zip(got, attn.bwd_reduce(*ins))):
        raise AssertionError(f"{what} is not bitwise repeatable")


def bwd_product_check(attn, n: int, m: int, d: int, dev: str, dtype=torch.float32) -> None:
    """The backward kernels on ``bwd_product_inputs`` of ``dtype`` (their
    products carry the outputs, so that a faulty product, index mapping,
    swizzle or descriptor misses the tolerance, and in the reduce a dropped
    piece of kvs or g/den too): the reduce against its plain version in f64
    (``check_bwd_reduce_f64``) and the apply against its plain version in
    f64 (BWD_REL_TOL of the type), each bitwise repeatable; in f32 the
    reduce also on ``bwd_reduce_product_inputs`` (positive q and g/den a
    fraction of a tf32 step above tf32 values: a P pass that drops a tf32 lo
    piece of q or of g/den misses the tolerance), in bf16 on the ``cancel``
    form of ``bwd_product_inputs`` (kvs's terms cancel in q @ kvs: a rows
    pass that drops kvs's lo piece misses gden's tolerance)."""
    from sgformer_tpu_torch.utils.measure import bwd_product_inputs, bwd_reduce_product_inputs

    name = DTYPE_NAME[dtype]
    gen = torch.Generator(device=dev).manual_seed(8)
    ins = bwd_product_inputs(n, m, d, dtype, gen)
    q, k, v, g, kvs, ksum, scal, n_t = ins[:8]
    check_bwd_reduce_f64(attn, f"bwd_reduce {name} (products carry it)",
                         (q, v, g, kvs, ksum, scal, n_t))
    got_a = attn.bwd_apply(*ins)
    exact = attn.bwd_apply_plain(*(t.double() for t in ins), False)
    for part, a, b in zip(("dq", "dk", "dv"), got_a, exact):
        check_rel(f"bwd_apply {name} (products carry it) {part} (plain in f64)", a, b,
                  BWD_REL_TOL[dtype])
    if not all(torch.equal(a, b) for a, b in zip(got_a, attn.bwd_apply(*ins))):
        raise AssertionError(f"bwd_apply {name} is not bitwise repeatable")
    del ins, got_a, exact
    if dtype == torch.float32:
        check_bwd_reduce_f64(attn, "bwd_reduce f32 (P's products carry it)",
                             bwd_reduce_product_inputs(n, m, d, dtype, torch.Generator(
                                 device=dev).manual_seed(9)))
    else:
        ins = bwd_product_inputs(n, m, d, dtype, torch.Generator(device=dev).manual_seed(10),
                                 cancel=True)
        check_bwd_reduce_f64(attn, f"bwd_reduce {name} (kvs's terms cancel in q @ kvs)",
                             (ins[0], *ins[2:8]))


def attention_bwd_phase(n: int, results: dict, dev: str) -> None:
    from sgformer_tpu_torch.kernels import attention as attn
    from sgformer_tpu_torch.ops.attention import linear_attention

    m = d = 256
    gen = torch.Generator(device=dev).manual_seed(3)
    n_t = torch.full((), float(n), device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        name = DTYPE_NAME[dtype]
        rel = BWD_REL_TOL[dtype]
        design, red_design = bwd_designs(attn, dtype, m, d, f"n={n}")
        q, k, v, g = (torch.randn(n, m, generator=gen, device=dev).to(dtype)
                      for _ in range(4))
        kvs, ksum, scal = attn.reduce_plain(q, k, v, False)
        got_r = attn.bwd_reduce(q, v, g, kvs, ksum, scal, n_t)
        # the reduce's sums against the plain version evaluated in f64 on the
        # same inputs: dinv's two sums can cancel, and an f32 evaluation of
        # the plain version is then itself off by more than the tolerance
        exact = attn.bwd_reduce_plain(*(t.double() for t in (q, v, g, kvs, ksum, scal, n_t)),
                                      False)
        torch.cuda.synchronize()
        red_errs = [check_rel(f"bwd_reduce {name} {part} (plain in f64)", a, b, REDUCE_REL_TOL)
                    for part, a, b in zip(("P", "ds", "dinv", "den, gden"), got_r, exact)]
        del exact
        want_r = attn.bwd_reduce_plain(q, v, g, kvs, ksum, scal, n_t, False)
        again = attn.bwd_reduce(q, v, g, kvs, ksum, scal, n_t)
        if not all(torch.equal(a, b) for a, b in zip(got_r, again)):
            raise AssertionError("bwd_reduce is not bitwise repeatable")

        # apply alone, on the plain reduce's outputs
        got_a = attn.bwd_apply(q, k, v, g, kvs, ksum, scal, n_t, *want_r)
        want_a = attn.bwd_apply_plain(q, k, v, g, kvs, ksum, scal, n_t, *want_r, False)
        torch.cuda.synchronize()
        app_errs = [check_rel(f"bwd_apply {name} {part}", a, b, rel)
                    for part, a, b in zip(("dq", "dk", "dv"), got_a, want_a)]
        again = attn.bwd_apply(q, k, v, g, kvs, ksum, scal, n_t, *want_r)
        if not all(torch.equal(a, b) for a, b in zip(got_a, again)):
            raise AssertionError("bwd_apply is not bitwise repeatable")
        bwd_product_check(attn, n, m, d, dev, dtype)
        # with n = 1 and positive inputs the attention products, not n * gd,
        # carry the gradients; against the plain version evaluated in f64 on
        # the same inputs: the epilogue's terms cancel there, and an f32
        # evaluation of it, the plain version's included, is then itself up
        # to ~1e-5 of the scale off (logged beside it)
        qp, kp, vp = (torch.rand(n, m, generator=gen, device=dev).to(dtype)
                      for _ in range(3))
        one = torch.ones((), device=dev)
        sums_p = attn.reduce_plain(qp, kp, vp, False)
        red_p = attn.bwd_reduce_plain(qp, vp, g, *sums_p, one, False)
        ins_p = (qp, kp, vp, g, *sums_p, one, *red_p)
        exact = attn.bwd_apply_plain(*(t.double() for t in ins_p), False)
        for part, a, b, c in zip(("dq", "dk", "dv"), attn.bwd_apply(*ins_p),
                                 attn.bwd_apply_plain(*ins_p, False), exact):
            check_rel(f"bwd_apply {name} (n = 1) {part} (plain in f64)", a, c, rel)
            err, scale = rel_err(b, c)
            log(f"  the plain version in {name} against it: {err / scale:.2e} of its scale")
        del exact
        # the reduce with n = 1 and positive q, v, g, so that q @ kvs, not
        # n * v, carries den and gden: each output within 2^-14 of its scale
        # of the plain version in f64 (dinv within 2^-14 of the magnitudes of
        # its two sums, which cancel), the precision of kvs and g/den as bf16
        # hi + lo; f32's P within REDUCE_REL_TOL
        gp = torch.rand(n, d, generator=gen, device=dev).to(dtype)
        got_p = attn.bwd_reduce(qp, vp, gp, *sums_p, one)
        qd, vd, gd_, kvs_d, ksum_d = (t.double() for t in (qp, vp, gp, *sums_p[:2]))
        exact = attn.bwd_reduce_plain(qd, vd, gd_, kvs_d, ksum_d, sums_p[2].double(),
                                      one.double(), False)
        torch.cuda.synchronize()
        for part, a, b in (("P", got_p[0], exact[0]), ("ds", got_p[1], exact[1]),
                           ("den", got_p[3][0], exact[3][0]),
                           ("gden", got_p[3][1], exact[3][1])):
            tol = REDUCE_REL_TOL if (dtype, part) == (torch.float32, "P") else N1_REL_TOL
            check_rel(f"bwd_reduce {name} (n = 1) {part} (plain in f64)", a, b, tol)
        den, gden = exact[3]
        dinv_scale = ((gd_ / den[:, None] * (qd @ kvs_d)).abs().sum()
                      + (gden * (qd @ ksum_d)).abs().sum()).item()
        dinv_err = abs(got_p[2].item() - exact[2].item())
        log(f"bwd_reduce {name} (n = 1) dinv: |kernel - plain| = {dinv_err:.3e}, "
            f"{dinv_err / dinv_scale:.2e} of its sums' magnitude {dinv_scale:.3e} "
            f"(tolerance {N1_REL_TOL})")
        if not dinv_err <= N1_REL_TOL * dinv_scale:
            raise AssertionError(f"bwd_reduce {name} (n = 1) dinv disagrees with plain")
        del got_p, qd, vd, gd_, kvs_d, ksum_d, exact, den, gden

        # the whole autograd Function against torch autograd of the plain
        # forward, on the same inputs
        qs, ks, vs = (t[:, None].clone().requires_grad_() for t in (q, k, v))
        got_g = torch.autograd.grad(attn.fused_linear_attention(qs, ks, vs), (qs, ks, vs),
                                    g[:, None])
        want_g = torch.autograd.grad(linear_attention(qs, ks, vs), (qs, ks, vs), g[:, None])
        for part, a, b in zip(("dq", "dk", "dv"), got_g, want_g):
            check_rel(f"attention gradient {name} {part} vs autograd of the plain forward",
                      a, b, rel)

        r_ms = time_ms(lambda: attn.bwd_reduce(q, v, g, kvs, ksum, scal, n_t))
        r_plain = time_ms(lambda: attn.bwd_reduce_plain(q, v, g, kvs, ksum, scal, n_t, False))
        # yardstick: the two core products, q @ kvs and q^T (g / den), each one
        # torch.matmul in the inputs' type (never called by the port)
        kvs_t, gd_t = kvs.to(dtype), (g.float() / want_r[3][0][:, None]).to(dtype)
        gemm_ms = time_ms(lambda: (torch.matmul(q, kvs_t), torch.matmul(q.t(), gd_t)))
        del kvs_t, gd_t
        a_ms = time_ms(lambda: attn.bwd_apply(q, k, v, g, kvs, ksum, scal, n_t, *want_r))
        a_plain = time_ms(lambda: attn.bwd_apply_plain(q, k, v, g, kvs, ksum, scal, n_t,
                                                       *want_r, False))
        # yardstick: the apply's three core products, gd @ kvs^T, v @ P^T and
        # k @ P, each one torch.matmul in the inputs' type (never called by
        # the port)
        kvs_t, P_t = kvs.to(dtype), want_r[0].to(dtype)
        gd_t = (g.float() / want_r[3][0][:, None]).to(dtype)
        a_gemm_ms = time_ms(lambda: (torch.matmul(gd_t, kvs_t.t()), torch.matmul(v, P_t.t()),
                                     torch.matmul(k, P_t)))
        a_gemm_each = dict(gd_kvsT=time_ms(lambda: torch.matmul(gd_t, kvs_t.t())),
                           v_PT=time_ms(lambda: torch.matmul(v, P_t.t())),
                           k_P=time_ms(lambda: torch.matmul(k, P_t)))
        del kvs_t, P_t, gd_t
        # the apply's own kernel (and its split of kvs and P) by the profiler
        a_dev = kernel_ms(lambda: attn.bwd_apply(q, k, v, g, kvs, ksum, scal, n_t, *want_r),
                          (BWD_APPLY_KERNELS[dtype],))[BWD_APPLY_KERNELS[dtype]]
        elt = q.element_size()
        small = (2 * m * d + 2 * m + 6) * 4  # kvs or P, ksum or ds, scalars
        # reduce: q @ kvs and q^T gd; reads q, v, g, writes P, ds, dinv, den, gden
        rb_ms, rb_by = bound_ms(3 * n * m * elt + small + 2 * n * 4,
                             bwd_reduce_ops(n, m, d, dtype), dtype)
        # apply: gd @ kvs^T, v @ P^T, k @ P (in bf16 six products: kvs and P
        # as hi + lo); reads q, k, v, g, den, gden, writes dq, dk, dv
        products = 12 if dtype == torch.bfloat16 else 6
        ab_ms, ab_by = bound_ms(7 * n * m * elt + 2 * small + 2 * n * 4,
                             products * n * m * d + 8 * n * m + 3 * n * d, dtype)
        log(f"bwd_reduce {name}: {r_ms:.4f} ms (plain {r_plain:.4f} ms, torch.matmul q @ kvs "
            f"+ q^T gd {gemm_ms:.4f} ms, bound {rb_ms:.4f} ms by {bound_name(rb_by, dtype)}); "
            f"bwd_apply {name}: {a_ms:.4f} ms (kernel {a_dev:.4f} ms by the profiler; plain "
            f"{a_plain:.4f} ms, torch.matmul gd @ kvs^T + v @ P^T + k @ P {a_gemm_ms:.4f} ms ("
            + ", ".join(f"{t:.4f}" for t in a_gemm_each.values())
            + f" apart), bound {ab_ms:.4f} ms by {bound_name(ab_by, dtype)})")
        results[("linear_attention_bwd_reduce", name)] = dict(
            max_abs_err=max(red_errs), ms=r_ms, plain_ms=r_plain, bound_ms=rb_ms,
            bound_by=rb_by, library_ms=None, gemm_ms=gemm_ms, design=red_design)
        # the reduce's passes apart at the three shapes the paths give it
        for what, n_ in BWD_PASS_SHAPES:
            passes = bwd_passes_ms(attn, n_, dev, dtype)
            log(f"bwd_reduce {name} {what} n={n_} by launch: rows pass "
                f"{passes['rows_ms']:.4f} ms, P pass {passes['p_pass_ms']:.4f} ms (bound "
                f"{passes['p_pass_bound_ms']:.4f} ms by "
                f"{bound_name(passes['p_pass_bound_by'], dtype)}, torch.matmul q^T gd "
                f"{passes['p_pass_matmul_ms']:.4f} ms), split, finish and dinv "
                f"{passes['others_ms']:.4f} ms")
            if n_ == n:
                results[("linear_attention_bwd_reduce", name)].update(passes)
            torch.cuda.empty_cache()
        results[("linear_attention_bwd_apply", name)] = dict(
            max_abs_err=max(app_errs), ms=a_ms, plain_ms=a_plain, bound_ms=ab_ms,
            bound_by=ab_by, library_ms=None, gemm_ms=a_gemm_ms, gemm_each_ms=a_gemm_each,
            kernel_ms=a_dev, design=design)

    # an all-masked group: finite zero gradients
    qs, ks, vs = (torch.randn(n, 1, m, generator=gen, device=dev).to(torch.bfloat16)
                  .requires_grad_() for _ in range(3))
    out = attn.fused_linear_attention(qs, ks, vs, node_mask=torch.zeros(n, device=dev))
    grads = torch.autograd.grad(out, (qs, ks, vs), torch.randn_like(out))
    if not all(torch.isfinite(t).all() and not t.any() for t in grads):
        raise AssertionError("all-masked attention gradients are not finite zeros")
    log("attention gradient all-masked bf16: finite zeros")


def edge_value_phase(graph, results: dict, dev: str) -> None:
    """csr_spmm_ev, sddmm and csr_spmm_ev_bwd at the shapes of GAT's two
    layers on the arxiv graph, against their plain versions, with time and
    bound; the library yardsticks compute one head per call
    (``torch.sparse.mm`` on a CSR tensor of that head's values,
    ``torch.sparse.sampled_addmm`` on A's pattern), so at H = 2 they are
    timed as one call per head."""
    from sgformer_tpu_torch.kernels.spmm import csr_spmm_ev, sddmm
    from sgformer_tpu_torch.ops.sddmm import sddmm as sddmm_plain
    from sgformer_tpu_torch.ops.spmm import spmm_edge_values

    n, e = graph.num_nodes, graph.num_edges
    src, dst = graph.edge_src, graph.edge_dst
    csr = (graph.indptr, src, dst)
    segs = (graph.hub_segments, graph.hub_edges)
    order, _ = walk_orders(graph)
    gen = torch.Generator(device=dev).manual_seed(4)
    for layer, (heads, d) in enumerate(GAT_LAYERS):
        x32 = torch.randn(n, heads, d, generator=gen, device=dev)
        g32 = torch.randn(n, heads, d, generator=gen, device=dev)
        v = torch.rand(e, heads, generator=gen, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            name = DTYPE_NAME[dtype]
            tag = f"{name} H={heads} D={d}"
            x, g = x32.to(dtype), g32.to(dtype)
            elt = x.element_size()
            # the aggregation as GAT sends it: messages in dtype, f32 result
            got = csr_spmm_ev(x, *csr, v, torch.float32, *segs, **order)
            want = spmm_edge_values(x, src, dst, v, n, torch.float32)
            torch.cuda.synchronize()
            err = check_close(f"csr_spmm_ev {tag}", got, want, **TOL[torch.float32])
            if not torch.equal(got, csr_spmm_ev(x, *csr, v, torch.float32, *segs, **order)):
                raise AssertionError("csr_spmm_ev is not bitwise repeatable")
            del got, want
            ms = time_ms(lambda: csr_spmm_ev(x, *csr, v, torch.float32, *segs, **order))
            plain_ms = time_ms(lambda: spmm_edge_values(x, src, dst, v, n, torch.float32))
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                mats = [torch.sparse_csr_tensor(graph.indptr, src, v[:, h].to(dtype),
                                                size=(n, n)) for h in range(heads)]
            cols = [x[:, h].contiguous() for h in range(heads)]
            library_ms = library_time(
                f"torch.sparse.mm {tag}",
                lambda: [torch.sparse.mm(a, c) for a, c in zip(mats, cols)])
            nbytes = n * heads * d * (elt + 4) + e * (4 + 4 * heads) + (n + 1) * 4
            b_ms, b_by = bound_ms(nbytes, 2 * e * heads * d, dtype)
            log(f"csr_spmm_ev {tag}: {ms:.4f} ms (plain {plain_ms:.4f} ms, torch.sparse.mm "
                f"x{heads} {library_ms} ms, bound {b_ms:.4f} ms by {b_by})")
            results[("csr_spmm_ev", name, layer)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)

            # the values' gradient alone (the dv mode of the backward walk):
            # g and x as the forward received them
            dv = sddmm(g, x, *csr, *segs)
            want = sddmm_plain(g.float(), x.float(), src, dst)
            torch.cuda.synchronize()
            err = check_rel(f"sddmm {tag}", dv, want, REDUCE_REL_TOL)
            if not torch.equal(dv, sddmm(g, x, *csr, *segs)):
                raise AssertionError("sddmm is not bitwise repeatable")
            del dv, want
            ms = time_ms(lambda: sddmm(g, x, *csr, *segs))
            plain_ms = time_ms(lambda: sddmm_plain(g.float(), x.float(), src, dst), iters=5)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                pattern = torch.sparse_csr_tensor(graph.indptr, src,
                                                  torch.zeros(e, device=dev), size=(n, n))
            gf = [g[:, h].float().contiguous() for h in range(heads)]
            xt = [x[:, h].float().t() for h in range(heads)]
            library_ms = library_time(
                f"torch.sparse.sampled_addmm {tag}",
                lambda: [torch.sparse.sampled_addmm(pattern, a, b, beta=0.0)
                         for a, b in zip(gf, xt)])
            nbytes = 2 * n * heads * d * elt + e * (4 + 4 * heads) + (n + 1) * 4
            b_ms, b_by = bound_ms(nbytes, 2 * e * heads * d, dtype)
            log(f"sddmm {tag}: {ms:.4f} ms (plain {plain_ms:.4f} ms, sampled_addmm "
                f"x{heads} {library_ms} ms, bound {b_ms:.4f} ms by {b_by})")
            results[("sddmm", name, layer)] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)
            del x, g, mats, cols, gf, xt, pattern
        # the whole gradient as GAT runs it: f32 x and g, bf16 messages; and
        # with f32 messages
        for msg in (torch.bfloat16, torch.float32):
            edge_value_bwd(graph, results, "csr_spmm_ev_bwd", layer, g32, x32, v, msg)
        del x32, g32, v
        torch.cuda.empty_cache()


def edge_value_bwd(graph, results: dict, key: str, layer: int, g, x, v, msg,
                   no_plan: bool = False) -> None:
    """csr_spmm_ev_bwd through the transposed CSR's hub plan on the
    cotangent g, x and the values v: dx and dv against the plain backward
    (1e-5 of each one's scale), dv bitwise sddmm's (the dv mode, through the
    dst-sorted CSR's plan), dx bitwise the parent formulation's (csr_spmm_ev
    of g in the message type on the transposed order with v[t_perm]; the
    same walk in the same lane groups), each bitwise repeatable; its time beside
    its read-once bound, the plain version's, the unfused pair's (that
    csr_spmm_ev with its cast and gather of v, then sddmm), the library's
    (``torch.sparse.mm`` on A^T and ``sampled_addmm``, per head), and its
    gather rate. ``no_plan``: also both modes without their plans (one warp
    a row), their results checked against the planned ones."""
    from sgformer_tpu_torch.kernels.spmm import csr_spmm_ev, csr_spmm_ev_bwd, sddmm, walk_design
    from sgformer_tpu_torch.ops.spmm import spmm_edge_values_backward

    n, e = graph.num_nodes, graph.num_edges
    heads, d = x.shape[1], x.shape[2]
    csr = (graph.indptr, graph.edge_src, graph.edge_dst)
    csr_t = (graph.t_indptr, graph.t_edge_src, graph.t_edge_dst, graph.t_perm)
    plan = (graph.hub_segments, graph.hub_edges)
    t_plan = (graph.t_hub_segments, graph.hub_edges)
    name, elt = DTYPE_NAME[msg], x.element_size()
    tag = f"{key} {DTYPE_NAME[x.dtype]} x, {name} messages, H={heads} D={d}"
    t_order = {"t_schedule": graph.walk_orders[1]}
    run = lambda: csr_spmm_ev_bwd(g, x, v, *csr_t, msg, *t_plan, **t_order)  # noqa: E731

    def pair():
        dx = csr_spmm_ev(g.to(msg), *csr_t[:3], v.index_select(0, graph.t_perm.long()), x.dtype,
                         *t_plan)
        return dx, sddmm(g, x, *csr, *plan)

    dx, dv = run()
    want_dx, want_dv = spmm_edge_values_backward(g, x, v, graph.t_edge_src, graph.t_edge_dst,
                                                 graph.t_perm, msg)
    torch.cuda.synchronize()
    err = max(check_rel(f"{tag} dx", dx, want_dx, REDUCE_REL_TOL),
              check_rel(f"{tag} dv", dv, want_dv, REDUCE_REL_TOL))
    del want_dx, want_dv
    pair_dx, pair_dv = pair()
    if not torch.equal(dv, pair_dv):
        raise AssertionError(f"{tag}: dv is not bitwise the dv-mode sddmm's")
    if not torch.equal(dx, pair_dx):
        raise AssertionError(f"{tag}: dx is not bitwise the parent formulation's")
    log(f"{tag}: dv bitwise sddmm's; dx bitwise the parent formulation's ({walk_design(d)})")
    del pair_dx, pair_dv
    again = run()
    if not (torch.equal(again[0], dx) and torch.equal(again[1], dv)):
        raise AssertionError(f"{tag} is not bitwise repeatable")
    del again
    ms = time_ms(run)
    pair_ms = time_ms(pair)
    plain_ms = time_ms(lambda: spmm_edge_values_backward(
        g, x, v, graph.t_edge_src, graph.t_edge_dst, graph.t_perm, msg), iters=5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        v_t = v.index_select(0, graph.t_perm.long())
        mats = [torch.sparse_csr_tensor(graph.t_indptr, graph.t_edge_src, v_t[:, h].to(msg),
                                        size=(n, n)) for h in range(heads)]
        pattern = torch.sparse_csr_tensor(graph.indptr, graph.edge_src,
                                          torch.zeros(e, device=x.device), size=(n, n))
    gm = [g[:, h].to(msg).contiguous() for h in range(heads)]
    gf = [g[:, h].float().contiguous() for h in range(heads)]
    xt = [x[:, h].float().t() for h in range(heads)]
    library_ms = library_time(
        f"torch.sparse.mm on A^T + sampled_addmm {tag}",
        lambda: ([torch.sparse.mm(a, c) for a, c in zip(mats, gm)],
                 [torch.sparse.sampled_addmm(pattern, a, b, beta=0.0) for a, b in zip(gf, xt)]))
    del v_t, mats, pattern, gm, gf, xt
    # x and g read once, dx written once, v read and dv written once, the
    # transposed CSR's columns, perm and indptr; a dot and a weighted sum
    # of D columns per edge and head
    nbytes = 3 * n * heads * d * elt + 2 * e * heads * 4 + 2 * e * 4 + (n + 1) * 4
    b_ms, b_by = bound_ms(nbytes, 4 * e * heads * d, torch.float32)
    rate = e * heads / ms * 1e3  # rows of g gathered a second, D * elt bytes each
    log(f"{tag}: {ms:.4f} ms (unfused pair {pair_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"sparse.mm + sampled_addmm x{heads} {library_ms} ms, bound {b_ms:.4f} ms by {b_by}); "
        f"gathers {rate / 1e9:.3f} G rows/s of {d * elt} bytes, {rate * d * elt / 1e9:.1f} GB/s")
    r = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
             library_ms=library_ms, pair_ms=pair_ms, grows_per_s=rate / 1e9,
             gather_gb_per_s=rate * d * elt / 1e9)
    if no_plan:
        one_warp = torch.empty(0, 3, dtype=torch.int32, device=x.device)
        deg = int(torch.diff(graph.indptr).max().item())
        t_deg = int(torch.diff(graph.t_indptr).max().item())
        got = csr_spmm_ev_bwd(g, x, v, *csr_t, msg, one_warp, t_deg)
        if not torch.equal(got[1], dv):
            raise AssertionError(f"{tag}: dv without the hub plan differs")
        check_rel(f"{tag} dx without the hub plan", got[0], dx, REDUCE_REL_TOL)
        if not torch.equal(sddmm(g, x, *csr, one_warp, deg), dv):
            raise AssertionError(f"{tag}: sddmm without the hub plan differs")
        del got
        r["no_plan_ms"] = time_ms(lambda: csr_spmm_ev_bwd(g, x, v, *csr_t, msg, one_warp, t_deg))
        r["sddmm_ms"] = time_ms(lambda: sddmm(g, x, *csr, *plan))
        r["sddmm_no_plan_ms"] = time_ms(lambda: sddmm(g, x, *csr, one_warp, deg))
        log(f"{tag} without the hub plans (one warp a row; in-degree up to {deg}, out-degree "
            f"up to {t_deg}): {r['no_plan_ms']:.4f} ms; sddmm {r['sddmm_ms']:.4f} ms with the "
            f"plan, {r['sddmm_no_plan_ms']:.4f} ms without")
    results[(key, name, layer)] = r
    del dx, dv


def powerlaw_edge_value_phase(graph, results: dict, dev: str) -> None:
    """csr_spmm_ev_bwd and sddmm on the power-law graph at GAT's two layer
    shapes (f32 x and g, bf16 messages), with and without the hub plans."""
    gen = torch.Generator(device=dev).manual_seed(6)
    for layer, (heads, d) in enumerate(GAT_LAYERS):
        x = torch.randn(graph.num_nodes, heads, d, generator=gen, device=dev)
        g = torch.randn(graph.num_nodes, heads, d, generator=gen, device=dev)
        v = torch.rand(graph.num_edges, heads, generator=gen, device=dev)
        edge_value_bwd(graph, results, "csr_spmm_ev_bwd_powerlaw", layer, g, x, v,
                       torch.bfloat16, no_plan=True)
        del x, g, v
        torch.cuda.empty_cache()


def width_sweep(graph, results: dict, dev: str, key: str, widths: tuple,
                ev_shapes: tuple = (), design=None) -> None:
    """The row walk on ``graph`` through its hub plan at narrow and full
    widths, bf16 and f32: ``csr_spmm`` at F in ``widths`` and
    ``csr_spmm_ev`` at (H, D) in ``ev_shapes`` (messages in the type, the
    result f32, as GAT sends them). Each against its plain version with the
    tolerances of the checks above and bitwise repeatable; H = 1
    ``csr_spmm_ev`` bitwise ``csr_spmm`` of the same values; with its lane
    groups (``design(d)``, ``kernels.spmm.walk_design`` when None), time,
    gathered bytes (a row of a head per edge and head) and their rate,
    read-once bound, the plain version's time and ``torch.sparse.mm``'s
    (one call a head); in the graph's walk order, and bitwise and timed in
    node order beside it. Results under ``("sweep", key, op, heads, d,
    dtype)``."""
    from sgformer_tpu_torch.kernels import spmm as spmm_kernel
    from sgformer_tpu_torch.ops.spmm import spmm as spmm_plain
    from sgformer_tpu_torch.ops.spmm import spmm_edge_values

    design = design or spmm_kernel.walk_design
    n, e = graph.num_nodes, graph.num_edges
    csr = (graph.indptr, graph.edge_src, graph.edge_dst)
    plan = (graph.hub_segments, graph.hub_edges)
    order, order_name = walk_orders(graph)
    gen = torch.Generator(device=dev).manual_seed(12)
    cases = [("csr_spmm", 1, f) for f in widths] + [("csr_spmm_ev", h, d) for h, d in ev_shapes]
    for op, heads, d in cases:
        x32 = torch.randn(n, heads, d, generator=gen, device=dev)
        v = (torch.rand(e, heads, generator=gen, device=dev) if op == "csr_spmm_ev"
             else graph.gcn_weight[:, None].contiguous())
        for dtype in (torch.bfloat16, torch.float32):
            name, x = DTYPE_NAME[dtype], x32.to(dtype)
            elt = x.element_size()
            if op == "csr_spmm":
                x = x[:, 0]

                def run(order=order):
                    return spmm_kernel.csr_spmm(x, *csr, graph.gcn_weight, *plan, **order)

                def plain():
                    return spmm_plain(x, *csr[1:], graph.gcn_weight, n)
                tol = TOL[dtype]
                nbytes = 2 * n * d * elt + e * 8 + (n + 1) * 4
                tag = f"{key} csr_spmm {name} F={d}"
            else:
                def run(order=order):
                    return spmm_kernel.csr_spmm_ev(x, *csr, v, torch.float32, *plan, **order)

                def plain():
                    return spmm_edge_values(x, *csr[1:], v, n, torch.float32)
                tol = TOL[torch.float32]
                nbytes = n * heads * d * (elt + 4) + e * (4 + 4 * heads) + (n + 1) * 4
                tag = f"{key} csr_spmm_ev {name} H={heads} D={d}"
            got, want = run(), plain()
            torch.cuda.synchronize()
            err = check_close(tag, got, want, **tol)
            if not torch.equal(got, run()):
                raise AssertionError(f"{tag} is not bitwise repeatable")
            if not torch.equal(got, run({})):
                raise AssertionError(f"{tag} in the walk order is not bitwise node order's")
            del got, want
            if op == "csr_spmm_ev" and heads == 1:
                one = spmm_kernel.csr_spmm_ev(x, *csr, v, dtype, *plan)
                if not torch.equal(one[:, 0], spmm_kernel.csr_spmm(x[:, 0], *csr, v[:, 0], *plan)):
                    raise AssertionError(f"{tag}: one head is not bitwise csr_spmm")
                del one
            ms, plain_ms = time_ms(run), time_ms(plain, iters=5)
            node_ms = time_ms(lambda: run({})) if order else ms
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                mats = [torch.sparse_csr_tensor(graph.indptr, graph.edge_src,
                                                v[:, h].to(dtype), size=(n, n))
                        for h in range(heads)]
            cols = [x.view(n, heads, d)[:, h].contiguous() for h in range(heads)]
            library_ms = library_time(f"torch.sparse.mm {tag}",
                                      lambda: [torch.sparse.mm(a, c) for a, c in zip(mats, cols)])
            gathered = e * heads * d * elt
            b_ms, b_by = bound_ms(nbytes, 2 * e * heads * d, dtype)
            walk = design(d)
            slower = library_ms is not None and ms > library_ms
            log(f"{tag}: {ms:.4f} ms in {order_name} ({walk}); gathers "
                f"{gathered / 1e6:.1f} MB of rows at {gathered / ms / 1e9:.2f} TB/s (node "
                f"order {node_ms:.4f} ms, {gathered / node_ms / 1e9:.2f} TB/s, bitwise the "
                f"same); read-once bound {b_ms:.4f} ms by {b_by}; plain {plain_ms:.4f} ms; "
                f"torch.sparse.mm x{heads} {library_ms} ms"
                f"{' (the kernel is slower)' if slower else ''}; bitwise repeatable")
            results[("sweep", key, op, heads, d, name)] = dict(
                ms=ms, node_order_ms=node_ms, plain_ms=plain_ms, design=walk,
                gathered_mb=gathered / 1e6, gather_tb_per_s=gathered / ms / 1e9,
                node_order_gather_tb_per_s=gathered / node_ms / 1e9, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms, max_abs_err=err)
            del x, mats, cols
        del x32, v
        torch.cuda.empty_cache()


def sweep_fields(results: dict, op: str) -> dict:
    """The width sweep's numbers of ``op`` for the kernels line, by graph,
    shape and type."""
    out = {}
    for key, r in results.items():
        if isinstance(key, tuple) and key[0] == "sweep" and key[2] == op:
            _, where, _, heads, d, name = key
            shape = f"F={d}" if op == "csr_spmm" else f"H={heads} D={d}"
            out[f"{where} {shape} {name}"] = {k: r[k] for k in (
                "ms", "node_order_ms", "plain_ms", "library_ms", "bound_ms", "gather_tb_per_s",
                "node_order_gather_tb_per_s", "design", "max_abs_err")}
    return out


def sddmm_run(graph, dev: str) -> int:
    """sddmm's own counted run (no model path launches it): one call per
    GAT layer shape through the graph's hub plan. Returns its launches."""
    from sgformer_tpu_torch import kernels
    from sgformer_tpu_torch.kernels.spmm import sddmm

    kernels.reset_launch_counts()
    for heads, d in GAT_LAYERS:
        x = torch.randn(graph.num_nodes, heads, d, device=dev)
        sddmm(x, x, graph.indptr, graph.edge_src, graph.edge_dst, graph.hub_segments,
              graph.hub_edges)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    if counts["sddmm"] != len(GAT_LAYERS) or sum(counts.values()) != counts["sddmm"]:
        raise AssertionError(f"sddmm's run: launch counts {counts}")
    return counts["sddmm"]


def serve_phase(ds, graph, dev: str) -> tuple[dict, int]:
    import numpy as np

    from sgformer_tpu_torch import Predictor, SGFormer, SGFormerConfig
    from sgformer_tpu_torch import kernels

    cfg = SGFormerConfig.large(256, 40, **BENCH_CONFIG)
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
    want = {k: c * forwards for k, c in FORWARD_LAUNCHES.items()}
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

    with plain_versions():
        ref = pred.logits()
    diff = float(np.abs(logits - ref).max())
    agree = float((logits.argmax(-1) == ref.argmax(-1)).mean())
    log(f"serving vs plain forward on the card: max |diff| {diff:.3e} "
        f"(atol {LOGITS_ATOL}), argmax agreement {agree:.5f} (>= {ARGMAX_AGREEMENT})")
    if diff > LOGITS_ATOL or agree < ARGMAX_AGREEMENT:
        raise AssertionError("serving path disagrees with the plain forward")
    profile_device("forward", pred._forward, 5)
    x = torch.empty(pred.x.shape[0], 40, device=pred.x.device)
    log(f"copy of [N, 40] f32 logits to the host: "
        f"{time_ms(lambda: x.cpu(), iters=10):.3f} ms")
    return counts, forwards


def checkpoint_round_trip(what: str, make_model, ds, graph, tc: dict, root: str, dev: str):
    """A model behind ``Trainer`` for 3 steps (``train_idx = arange(0, N, 2)``),
    ``save_checkpoint``, then ``load_predictor`` into a fresh model of the
    same config: its logits must be ``eval_step``'s bit for bit. Returns the
    compiled ``Predictor``."""
    import os

    import numpy as np

    from sgformer_tpu_torch import load_predictor
    from sgformer_tpu_torch.train import TrainConfig, Trainer, save_checkpoint

    trainer = Trainer(make_model(), graph, ds.graph["node_feat"], ds.label, TrainConfig(**tc),
                      device=dev)
    idx = trainer.prepare_train_idx({"train": np.arange(0, graph.num_nodes, 2)})
    trainer.init_state(0)
    for _ in range(CHECKPOINT_STEPS):
        trainer.train_step(idx)
    want = trainer.eval_step().cpu().numpy()
    path = os.path.join(root, f"{what}.ckpt")
    save_checkpoint(path, trainer.model, trainer.optimizer, CHECKPOINT_STEPS, trainer.generator)
    del trainer
    t = time.perf_counter()
    pred = load_predictor(path, make_model(), graph, ds.graph["node_feat"], device=dev)
    load_s = time.perf_counter() - t
    got = pred.logits()
    log(f"serve-export {what}: {CHECKPOINT_STEPS} Trainer steps, save_checkpoint "
        f"({os.path.getsize(path)} bytes), load_predictor {load_s:.2f} s (compile included): "
        f"logits {got.shape} bitwise eval_step's: {np.array_equal(got, want)}")
    if got.shape != want.shape or not np.isfinite(got).all() or not np.array_equal(got, want):
        raise AssertionError(f"serve-export {what}: load_predictor's logits are not eval_step's")
    return pred


def export_round_trip(what: str, pred, forward_launches: dict, root: str, dev: str) -> dict:
    """``export_artifact(include_inputs=True)`` and ``load_exported`` of a
    compiled ``Predictor``: the program's op nodes (one for each kernel
    launch of a forward), its call with ``export_leaves()`` and with the
    bundle's leaves moved to the card (then ``out[inv_perm]``), each bitwise
    ``Predictor.logits()``; the launches of ``EXPORT_REQUESTS`` exported
    requests, exactly that many forwards' (no backward kernel); the
    export's and the load's seconds, the artifact's and the bundle's bytes,
    and the median ms of the exported requests beside ``Predictor.logits()``'s
    (logits to the host in both). Returns the numbers and the launches of
    one exported forward."""
    import os

    import numpy as np

    from sgformer_tpu_torch import kernels, load_exported
    from sgformer_tpu_torch.kernels import ops

    want = pred.logits()
    path = os.path.join(root, f"{what}.pt2")
    t = time.perf_counter()
    pred.export_artifact(path, include_inputs=True)
    export_s = time.perf_counter() - t
    t = time.perf_counter()
    program = load_exported(path)
    load_s = time.perf_counter() - t
    calls = ops.op_calls(program)
    by_count = {ops.LAUNCH_COUNT[name]: c for name, c in calls.items()}
    sizes = os.path.getsize(path), os.path.getsize(path + ".inputs.npz")
    log(f"serve-export {what}: export {export_s:.2f} s, load {load_s:.2f} s, artifact "
        f"{sizes[0]} bytes, bundle {sizes[1]} bytes; op nodes {calls}")
    if by_count != {k: forward_launches[k] for k in by_count}:
        raise AssertionError(f"serve-export {what}: op nodes {calls} are not one a launch of "
                             f"the forward {forward_launches}")
    module = program.module()
    leaves = pred.export_leaves()
    bundle = np.load(path + ".inputs.npz")
    moved = []
    for i, leaf in enumerate(leaves):
        arr = torch.from_numpy(bundle[f"arr_{i}"])
        moved.append((arr.view(torch.bfloat16) if leaf.dtype == torch.bfloat16 else arr).to(dev))
    with torch.no_grad():
        got = module(*leaves).cpu().numpy()
        got_bundle = module(*moved).cpu().numpy()[bundle["inv_perm"]]
    del moved, bundle
    same, same_bundle = np.array_equal(got, want), np.array_equal(got_bundle, want)
    log(f"serve-export {what}: the exported call bitwise Predictor.logits(): with "
        f"export_leaves() {same}, with the bundle's leaves on the card {same_bundle}")
    if not (same and same_bundle):
        raise AssertionError(f"serve-export {what}: the exported forward is not the Predictor's")

    def exported():
        with torch.no_grad():
            return module(*leaves).cpu().numpy()

    times = {"exported": [], "Predictor.logits": []}
    kernels.reset_launch_counts()
    for _ in range(EXPORT_REQUESTS):
        t = time.perf_counter()
        exported()
        times["exported"].append((time.perf_counter() - t) * 1e3)
    counts = kernels.launch_counts()
    want_counts = {k: c * EXPORT_REQUESTS for k, c in forward_launches.items()}
    log(f"serve-export {what}: launches over {EXPORT_REQUESTS} exported requests: {counts}")
    if counts != want_counts:
        raise AssertionError(f"launch counts {counts}, expected {want_counts}")
    for _ in range(EXPORT_REQUESTS):
        t = time.perf_counter()
        pred.logits()
        times["Predictor.logits"].append((time.perf_counter() - t) * 1e3)
    med = {k: statistics.median(v) for k, v in times.items()}
    log(f"serve-export {what}: median request over {EXPORT_REQUESTS}: exported "
        f"{med['exported']:.3f} ms (min {min(times['exported']):.3f}), Predictor.logits() "
        f"{med['Predictor.logits']:.3f} ms (min {min(times['Predictor.logits']):.3f}), logits to "
        f"the host in both ({card_line()})")
    os.remove(path)
    os.remove(path + ".inputs.npz")
    return dict(export_s=export_s, load_s=load_s, artifact_bytes=sizes[0],
                bundle_bytes=sizes[1], op_calls=calls,
                exported_ms=med["exported"], predictor_ms=med["Predictor.logits"],
                per_forward={k: c // EXPORT_REQUESTS for k, c in counts.items()})


def serve_export_phase(ds, graph, results: dict, dev: str) -> dict:
    """serve-export: the hand-off of a trained forward to another process,
    at the bench width on the arxiv graph: for the bench model (bf16), the
    bench model on the int8 graph and GAT (``GAT_CONFIG``), a checkpoint
    round trip (``checkpoint_round_trip``) and an export round trip
    (``export_round_trip``); then the zoo models that take ``model_kwargs``
    (NodeFormer, which returns a tuple, H2GCN and Graphormer, the JAX CLI's
    defaults on the Cora-sized files of the zoo phase) behind ``Predictor``:
    their logits bitwise their trainer's ``eval_step`` after 3 steps, with
    the forward's launches. Returns the launches of one exported forward of
    each kernel (the largest over the three models)."""
    import argparse
    import os
    import shutil

    import numpy as np

    from sgformer_tpu_torch import Predictor, preprocess_graph
    from sgformer_tpu_torch.cli import main as cli
    from sgformer_tpu_torch.nn import GAT

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "serve-export")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)

    def gat():
        cfg = GAT_CONFIG
        return GAT(ds.graph["node_feat"].shape[1], cfg["hidden_channels"], cfg["out_channels"],
                   **{k: v for k, v in cfg.items() if k not in ("hidden_channels", "out_channels")},
                   generator=torch.Generator().manual_seed(0), device=dev)

    graph_q8 = preprocess_graph(ds.graph["edge_index"], ds.num_nodes, chunk_dtype="bf16",
                                slab_dtype="int8", device=dev)
    results["serve-export"] = {}
    exported_forward = dict.fromkeys(FORWARD_LAUNCHES, 0)
    for what, make_model, g, tc, forward in (
            ("bench", lambda: bench_model(ds, dev)[0], graph, BENCH_TRAIN, FORWARD_LAUNCHES),
            ("bench-int8", lambda: bench_model(ds, dev)[0], graph_q8, BENCH_TRAIN,
             Q8_FORWARD_LAUNCHES),
            ("gat", gat, graph, GAT_TRAIN, GAT_FORWARD_LAUNCHES)):
        pred = checkpoint_round_trip(what, make_model, ds, g, tc, root, dev)
        r = export_round_trip(what, pred, forward, root, dev)
        results["serve-export"][what] = r
        exported_forward = {k: max(c, r["per_forward"][k]) for k, c in exported_forward.items()}
        del pred
        torch.cuda.empty_cache()
    del graph_q8

    write_zoo_data(root)
    parser = cli.parser_add_main_args(argparse.ArgumentParser())
    for name, forward in SERVE_ZOO.items():
        argv = ["--trainer", "full", "--dataset", "cora", "--method", name, "--data_dir",
                root] + ZOO_CUT
        built = cli.build(parser.parse_args(argv))
        trainer = built.trainer
        idx = trainer.prepare_train_idx(built.splits[0])
        trainer.init_state(0)
        for _ in range(CHECKPOINT_STEPS):
            trainer.train_step(idx)
        want = trainer.eval_step().cpu().numpy()
        pred = Predictor(trainer.model, trainer.graph, trainer.x,
                         model_kwargs=trainer.model_kwargs, device=dev).compile()
        got, _ = counted(f"serve-export {name} Predictor.logits()", pred.logits,
                         dict(ZERO_LAUNCHES, csr_spmm=forward))
        log(f"serve-export {name}: Predictor(model_kwargs={sorted(trainer.model_kwargs)}) "
            f"logits {got.shape} bitwise eval_step's: {np.array_equal(got, want)}")
        if not np.array_equal(got, want):
            raise AssertionError(f"serve-export {name}: the Predictor's logits are not "
                                 f"eval_step's")
        del built, trainer, pred
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return exported_forward


def plain_versions():
    """Patch the kernels out of the model's path: the GCN aggregation, the
    per-edge-value aggregation and the attention run through their plain
    versions, with torch autograd for the gradients; the int8 aggregation
    runs its plain version inside its own autograd Function (its gradient
    quantises g, which autograd of the plain forward would not)."""
    import contextlib

    from sgformer_tpu_torch.kernels import attention as attn_kernel
    from sgformer_tpu_torch.kernels import spmm as spmm_kernel
    from sgformer_tpu_torch.ops.attention import linear_attention
    from sgformer_tpu_torch.ops.spmm import spmm as spmm_plain
    from sgformer_tpu_torch.ops.spmm import spmm_edge_values, spmm_q8

    def plain_csr(x, csr, csr_t, segments=None, t_segments=None, segment_edges=None,
                  schedule=None, t_schedule=None):
        indptr, edge_src, edge_dst, weight = csr
        return spmm_plain(x, edge_src, edge_dst, weight, indptr.shape[0] - 1)

    def plain_ev(x, values, csr, csr_t, msg_dtype, segments=None, t_segments=None,
                 segment_edges=None, schedule=None, t_schedule=None):
        indptr, edge_src, edge_dst = csr
        return spmm_edge_values(x.to(msg_dtype), edge_src, edge_dst, values,
                                indptr.shape[0] - 1, x.dtype)

    def plain_q8(x, indptr, edge_src, edge_dst, weight, rs, segments=None, segment_edges=None,
                 schedule=None):
        return spmm_q8(x, edge_src, edge_dst, weight, rs, indptr.shape[0] - 1)

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(spmm_kernel, "csr_spmm_autograd", plain_csr))
    # a node shard's CSRs (parallel/partition.py) call it by their own name
    partition = sys.modules.get("sgformer_tpu_torch.parallel.partition")
    if partition is not None:
        stack.enter_context(mock.patch.object(partition, "csr_spmm_autograd", plain_csr))
    # the int8 Function's forward and backward call csr_spmm_q8 by name
    stack.enter_context(mock.patch.object(spmm_kernel, "csr_spmm_q8", plain_q8))
    stack.enter_context(mock.patch.object(spmm_kernel, "csr_spmm_ev_autograd", plain_ev))
    stack.enter_context(mock.patch.object(attn_kernel, "fused_linear_attention",
                                          linear_attention))
    return stack


def bench_model(ds, dev: str):
    """The bench model from a seeded generator, and the gradient each
    parameter's is held to: a bias that feeds a train-mode BatchNorm has an
    exact gradient of 0 (the batch mean takes any shift out); what both paths
    compute for it is rounding noise, so it is held to the gradient of the
    BatchNorm shift after it."""
    from sgformer_tpu_torch import SGFormer, SGFormerConfig

    cfg = SGFormerConfig.large(256, 40, **BENCH_CONFIG)
    model = SGFormer(cfg, ds.graph["node_feat"].shape[1],
                     generator=torch.Generator().manual_seed(0), device=dev)
    return model, bench_scale_of()


def bench_scale_of(layers: int = BENCH_CONFIG["gnn_num_layers"]) -> dict:
    """Each bias of an SGFormer with ``layers`` GraphConv layers (the bench
    model's by default) that feeds a train-mode BatchNorm, and the
    BatchNorm shift whose gradient it is held to (``bench_model``)."""
    scale_of = {"graph_conv.fc_in.bias": "graph_conv.bn_in.bias"}
    scale_of.update({f"graph_conv.conv_{i}.W.bias": f"graph_conv.bn_{i}.bias"
                     for i in range(layers)})
    return scale_of


def train_phase(ds, graph, dev: str) -> tuple:
    """arxiv-train: the bench model behind ``Trainer``."""
    model, scale_of = bench_model(ds, dev)
    return train_path("train", model, ds, graph, BENCH_TRAIN, STEP_LAUNCHES, FORWARD_LAUNCHES,
                      TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, (LOGITS_ATOL, 0.0), scale_of, dev)


def powerlaw_train_phase(ds, graph, dev: str) -> tuple:
    """powerlaw-train: the bench model on the power-law bench graph behind
    ``Trainer``, its six aggregations a step through the hub plans."""
    model, scale_of = bench_model(ds, dev)
    return train_path("powerlaw", model, ds, graph, BENCH_TRAIN, STEP_LAUNCHES,
                      FORWARD_LAUNCHES, TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, (LOGITS_ATOL, 0.0),
                      scale_of, dev)


def gat_train_phase(ds, graph, dev: str, what: str = "gat") -> tuple:
    """arxiv-gat-train (powerlaw-gat-train on the power-law graph): GAT at
    the bench width behind ``Trainer``."""
    from sgformer_tpu_torch.nn import GAT

    cfg = GAT_CONFIG
    model = GAT(ds.graph["node_feat"].shape[1], cfg["hidden_channels"], cfg["out_channels"],
                **{k: v for k, v in cfg.items() if k not in ("hidden_channels", "out_channels")},
                generator=torch.Generator().manual_seed(0), device=dev)
    scale_of = {f"conv_{i}.bias": f"bn_{i}.bias" for i in range(cfg["num_layers"] - 1)}
    return train_path(what, model, ds, graph, GAT_TRAIN, GAT_STEP_LAUNCHES,
                      GAT_FORWARD_LAUNCHES, GAT_LOSS_RTOL, GAT_GRAD_RTOL,
                      (0.0, GAT_LOGITS_RTOL), scale_of, dev)


def check_step(what: str, model, generator, loss_fn, loss_rtol: float, grad_rtol: float,
               scale_of: dict, reduce_grads=None, whole: bool = False) -> tuple:
    """One train step's loss and gradients through the kernels against the
    same step through the plain versions, from the model's weights now and
    the same dropout masks (``generator`` seeded 1 for each); the weights
    and statistics are restored after. ``loss_fn()`` runs the forward in
    train mode and returns the loss; ``reduce_grads()``, when given, runs
    after each backward (a sharded step's gradient all-reduce: every rank of
    the group must call this alike). With ``whole`` the gradients are held
    as one vector, ||g_kernel - g_plain|| / ||g_plain|| over every
    parameter: for a step in which some parameters' exact gradient is 0, so
    that both paths give them rounding noise (a group of one real node: its
    attention output is v whatever q and k are, and the BatchNorm over one
    row takes every shift out). Returns the kernels' loss and gradients and
    (loss, gradient) relative differences."""
    from sgformer_tpu_torch import kernels

    snapshot = {k: v.clone() for k, v in model.state_dict().items()}

    def loss_and_grads():
        model.load_state_dict(snapshot)
        model.zero_grad(set_to_none=True)
        generator.manual_seed(1)
        loss = loss_fn()
        loss.backward()
        if reduce_grads is not None:
            reduce_grads()
        torch.cuda.synchronize()
        return loss.item(), {k: p.grad.float().clone() for k, p in model.named_parameters()}

    loss_k, grads_k = loss_and_grads()
    kernels.reset_launch_counts()
    with plain_versions():
        loss_p, grads_p = loss_and_grads()
    if any(kernels.launch_counts().values()):
        raise AssertionError("the plain step launched a kernel")
    torch.cuda.empty_cache()
    rel_loss = abs(loss_k - loss_p) / abs(loss_p)
    log(f"{what} step loss: kernels {loss_k:.7f}, plain {loss_p:.7f}, relative "
        f"difference {rel_loss:.2e} (tolerance {loss_rtol})")
    if not rel_loss <= loss_rtol:
        raise AssertionError(f"{what} step loss disagrees with the plain step")
    worst = (0.0, "")
    if whole:
        diff = sum(((gk - grads_p[k]).double().norm() ** 2 for k, gk in grads_k.items()))
        norm = sum((gp.double().norm() ** 2 for gp in grads_p.values()))
        worst = ((diff / norm).sqrt().item(), "all parameters as one vector")
        if not all(bool(torch.isfinite(gk).all()) for gk in grads_k.values()) \
                or not worst[0] <= grad_rtol:
            raise AssertionError(f"{what} gradients: |g_kernel - g_plain| / |g_plain| = "
                                 f"{worst[0]:.3e} > {grad_rtol}, or not finite")
    for name, gk in ({} if whole else grads_k).items():
        if not torch.isfinite(gk).all():
            raise AssertionError(f"gradient of {name} is not finite")
        gp = grads_p[name]
        rel = ((gk - gp).norm() / grads_p[scale_of.get(name, name)].norm()).item()
        worst = max(worst, (rel, name))
        if not rel <= grad_rtol:
            raise AssertionError(f"gradient of {name}: |g_kernel - g_plain| / |g_plain| "
                                 f"= {rel:.3e} > {grad_rtol}")
    log(f"{what} step gradients: {len(grads_k)} parameters finite, largest "
        f"|g_kernel - g_plain| / |g_plain| = {worst[0]:.3e} ({worst[1]}, "
        f"tolerance {grad_rtol})")
    model.load_state_dict(snapshot)
    return loss_k, grads_k, rel_loss, worst[0]


def counted(what: str, fn, want: dict):
    """``fn()`` from launch counts of 0; its counts must be ``want``.
    Returns fn's result and the counts."""
    from sgformer_tpu_torch import kernels

    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    log(f"launches of {what}: {counts}")
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    return out, counts


def check_logits(what: str, logits, ref, shape: tuple, logits_tol: tuple) -> None:
    """Logits through the kernels against the plain forward's:
    ``logits_tol`` is (absolute, share of the largest logit); the argmax
    must agree on ``ARGMAX_AGREEMENT`` of the rows."""
    diff = (logits - ref).abs().max().item()
    scale = ref.abs().max().item()
    agree = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"{what} logits {tuple(logits.shape)} vs the plain forward: max |diff| "
        f"{diff:.3e}, {diff / scale:.2e} of the largest logit {scale:.3e} (tolerance "
        f"{logits_tol[0]} + {logits_tol[1]} of it), argmax agreement {agree:.5f}")
    if (tuple(logits.shape) != shape or not torch.isfinite(logits).all()
            or diff > logits_tol[0] + logits_tol[1] * scale or agree < ARGMAX_AGREEMENT):
        raise AssertionError(f"{what} logits disagree with the plain forward")


def train_path(what, model, ds, graph, tc: dict, step_launches: dict, forward_launches: dict,
               loss_rtol: float, grad_rtol: float, logits_tol: tuple, scale_of: dict,
               dev: str) -> tuple:
    """One model behind ``Trainer`` with ``train_idx = arange(0, N, 2)``:
    (a) one step's loss and gradients through the kernels against the same
    step through the plain versions, from the same weights and dropout
    masks; (b) the launches of one step and of one ``eval_step``, and the
    eval logits against the plain forward; (c) ``time_test``, the path's
    run; (d) a profile of one step. ``logits_tol`` is (absolute, share of
    the largest logit). Returns the launches of (b) and (c), and (c)'s
    result."""
    import numpy as np

    from sgformer_tpu_torch import kernels
    from sgformer_tpu_torch.train import TrainConfig, Trainer, time_test

    trainer = Trainer(model, graph, ds.graph["node_feat"], ds.label, TrainConfig(**tc),
                      device=dev)
    n = graph.num_nodes
    split = {"train": np.arange(0, n, 2), "valid": np.arange(1, n, 4),
             "test": np.arange(3, n, 4)}
    train_idx = trainer.prepare_train_idx(split)
    trainer.init_state(0)

    # (a) one step's loss and gradients through the kernels and through the
    # plain versions, from the same weights and the same dropout masks
    check_step(what, model, trainer.generator, lambda: trainer.loss(train_idx), loss_rtol,
               grad_rtol, scale_of)

    # (b) the launches of one train step and of one eval forward; the eval
    # logits against the same forward through the plain versions
    _, per_step = counted(f"one {what} step", lambda: trainer.train_step(train_idx),
                          step_launches)
    logits, per_forward = counted(f"one {what} eval_step", trainer.eval_step, forward_launches)
    with plain_versions():
        ref = trainer.eval_step()
    check_logits(f"{what} eval", logits, ref, (n, 40), logits_tol)
    del logits, ref

    # (c) time_test: the path's run
    kernels.reset_launch_counts()
    res = time_test(trainer, split, epochs=TRAIN_EPOCHS, warmup=TRAIN_WARMUP)
    run_counts = kernels.launch_counts()
    steps = TRAIN_EPOCHS + TRAIN_WARMUP
    log(f"launches over {what} time_test ({steps} train steps, 2 forwards): {run_counts}")
    want = {k: c * steps + 2 * forward_launches[k] for k, c in step_launches.items()}
    if run_counts != want:
        raise AssertionError(f"launch counts {run_counts}, expected {want}")
    losses = res.losses
    log(f"{what} time_test: {res.per_epoch_ms:.3f} ms per train step over {TRAIN_EPOCHS} "
        f"steps, forward {res.forward_ms:.3f} ms, {res.edges_per_sec:.4e} edges/s, "
        f"peak memory {res.peak_memory_mb:.1f} MiB on {res.device}")
    log(f"{what} losses: first {losses[0]:.6f}, last 3 {[round(x, 6) for x in losses[-3:]]}")
    if not all(np.isfinite(losses)) or not sum(losses[-3:]) / 3 < losses[0]:
        raise AssertionError(f"the {what} loss did not fall over the train steps")

    # (d) where one train step's device time goes
    profile_device(f"{what} step", lambda: trainer.train_step(train_idx), 3)
    return per_step, per_forward, run_counts, res


def q8_phase(graph, results: dict, dev: str, key: str = "csr_spmm_q8",
             dtypes=(torch.bfloat16, torch.float32), no_plan: bool = False) -> None:
    """csr_spmm_q8 on ``graph`` at F = 256 (the bench model's width), for
    each x type: the quantiser kernel bitwise against its plain version (q
    and s), with its time beside its two-pass bound and the plain time; the
    aggregation kernel on the quantised rows through the graph's hub plan
    against the plain version on the same rows (one ulp of the output type;
    whether they are bitwise equal is logged), the whole (quantiser +
    kernel) against the plain whole, bitwise repeatable; the walk's design,
    its time beside its bound, the plain version's and ``csr_spmm``'s on the
    same x, and its gather rate, in the graph's walk order (as the model
    path runs it), which holds it bitwise to the node-order walk, timed
    beside it. ``no_plan``: also without the hub plan (every row one warp's
    walk)."""
    from sgformer_tpu_torch.kernels import spmm as k
    from sgformer_tpu_torch.kernels.spmm import Q8_WALK
    from sgformer_tpu_torch.ops.spmm import quantize_absmax, spmm_q8, spmm_q8_apply

    n, e, f = graph.num_nodes, graph.num_edges, 256
    src, dst, w, rs = graph.edge_src, graph.edge_dst, graph.gcn_weight, graph.rs
    csr = (graph.indptr, src, dst, w)
    plan = (graph.hub_segments, graph.hub_edges)
    order = graph.schedule
    if order is None:
        raise AssertionError(f"{key}: the graph has no walk order")
    n_self = int((src == dst).sum().item())
    gen = torch.Generator(device=dev).manual_seed(5)
    for dtype in dtypes:
        name = DTYPE_NAME[dtype]
        x = torch.randn(n, f, generator=gen, device=dev).to(dtype)
        q, s = quantize_absmax(x, rs)
        q_k, s_k = k.quantize_absmax(x, rs)
        torch.cuda.synchronize()
        if not (torch.equal(q_k, q) and torch.equal(s_k, s)):
            raise AssertionError(f"quantize_absmax {key} {name} is not bitwise its plain version")
        del q_k, s_k
        log(f"quantize_absmax {key} {name}: q and s bitwise the plain version's (s = "
            f"{s.item():.6e})")
        quant_plain = time_ms(lambda: quantize_absmax(x, rs), iters=5)
        ms_q = time_ms(lambda: k.quantize_absmax(x, rs))
        # x read by each pass, rs read, q written; a multiply, a comparison
        # and a multiply an element
        qb_ms, qb_by = bound_ms(2 * n * f * x.element_size() + n * 4 + n * f + 4, 3 * n * f,
                                torch.float32)
        log(f"quantize_absmax {key} {name}: {ms_q:.4f} ms (plain {quant_plain:.4f} ms, bound "
            f"{qb_ms:.4f} ms by {qb_by})")
        results[(key.replace("csr_spmm_q8", "quantize_absmax"), name)] = dict(
            max_abs_err=0.0, ms=ms_q, plain_ms=quant_plain, bound_ms=qb_ms, bound_by=qb_by,
            library_ms=None)

        xb = x.to(torch.bfloat16)
        design = f"{Q8_WALK}; hub rows in {plan[0].shape[0]} segments of at most {plan[1]} edges"
        log(f"{key} {name} walk: {design}")
        got = k.csr_spmm_q8_apply(q, s, xb, *csr, rs, dtype, *plan, schedule=order)
        want = spmm_q8_apply(q, s, xb, src, dst, w, rs, n, dtype)
        node_order = k.csr_spmm_q8_apply(q, s, xb, *csr, rs, dtype, *plan)
        torch.cuda.synchronize()
        err = check_close(f"{key} {name} F={f} (same quantised rows; bitwise equal: "
                          f"{torch.equal(got, want)})", got, want,
                          rtol=Q8_ULP[dtype], atol=0.0)
        if not torch.equal(got, node_order):
            raise AssertionError(f"{key} {name}: the walk order is not the node-order walk "
                                 f"bitwise")
        log(f"{key} {name}: the walk in the graph's order is bitwise the node-order walk")
        del node_order
        if not torch.equal(got, k.csr_spmm_q8_apply(q, s, xb, *csr, rs, dtype, *plan,
                                                    schedule=order)):
            raise AssertionError("csr_spmm_q8 is not bitwise repeatable")
        check_close(f"{key} {name} F={f} (quantiser + kernel vs plain spmm_q8)",
                    k.csr_spmm_q8(x, *csr, rs, *plan, schedule=order),
                    spmm_q8(x, src, dst, w, rs, n), rtol=Q8_ULP[dtype], atol=0.0)
        torch.cuda.empty_cache()
        # the plain version first: on the H100 the first timing after
        # empty_cache reads the kernel high at large-400K
        plain_ms = time_ms(lambda: spmm_q8_apply(q, s, xb, src, dst, w, rs, n, dtype), iters=5)
        ms = time_ms(lambda: k.csr_spmm_q8_apply(q, s, xb, *csr, rs, dtype, *plan,
                                                 schedule=order))
        node_ms = time_ms(lambda: k.csr_spmm_q8_apply(q, s, xb, *csr, rs, dtype, *plan))
        whole_ms = time_ms(lambda: k.csr_spmm_q8(x, *csr, rs, *plan, schedule=order))
        spmm_ms = time_ms(lambda: k.csr_spmm(x, *csr, *plan, schedule=order))
        # q, the bf16 x of the self term, rs, src, indptr and the absmax read
        # once, the weights of the self edges only, the result written once
        nbytes = (n * f * (1 + 2 + x.element_size()) + n * 4 + e * 4 + (n + 1) * 4
                  + n_self * 4 + 4)
        b_ms, b_by = bound_ms(nbytes, e * f, torch.int8)
        rows = e - n_self  # the rows of q gathered
        rate = rows / ms * 1e3
        log(f"{key} {name}: {ms:.4f} ms in the walk order, {node_ms:.4f} ms in node order "
            f"(plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}); gathers "
            f"{rate / 1e9:.3f} G rows/s, {rate * f / 1e9:.1f} GB/s; quantiser + kernel "
            f"{whole_ms:.4f} ms; csr_spmm {name} on the same x {spmm_ms:.4f} ms")
        r = dict(max_abs_err=err, ms=ms, node_order_ms=node_ms, plain_ms=plain_ms,
                 bound_ms=b_ms, bound_by=b_by, library_ms=None, design=design, quantize_ms=ms_q,
                 quantize_and_kernel_ms=whole_ms, csr_spmm_ms=spmm_ms,
                 grows_per_s=rate / 1e9, gather_gb_per_s=rate * f / 1e9)
        if no_plan:
            one_warp = (torch.empty(0, 3, dtype=torch.int32, device=dev),
                        int(torch.diff(graph.indptr).max().item()))
            run = lambda: k.csr_spmm_q8_apply(q, s, xb, *csr, rs, dtype,  # noqa: E731
                                              *one_warp, schedule=order)
            if not torch.equal(run(), got):
                raise AssertionError(f"{key} {name} without the hub plan differs")
            r["no_plan_ms"] = time_ms(run)
            log(f"{key} {name} without the hub plan (one warp a row, {plan[0].shape[0]} "
                f"segments of at most {plan[1]} edges unused): {r['no_plan_ms']:.4f} ms, "
                f"bitwise the planned walk's")
        results[(key, name)] = r
        del x, q, s, xb, got, want
    torch.cuda.empty_cache()


def q8_train_phase(results: dict, dev: str) -> tuple[dict, dict, dict]:
    """large-400K-int8-train: ``csr_spmm_q8`` alone on the large-400K graph
    (``q8_phase``, bf16); the bench model on that graph with int8
    aggregation behind ``Trainer``, through ``train_path``; then the
    same graph with the bf16 aggregation for one ``time_test``, and the two
    graphs' eval logits at the trained weights side by side."""
    import numpy as np

    from sgformer_tpu_torch import kernels, preprocess_graph
    from sgformer_tpu_torch.data import synthetic_dataset
    from sgformer_tpu_torch.train import TrainConfig, Trainer, time_test

    t = time.perf_counter()
    ds = synthetic_dataset(**LARGE_400K, device=dev)
    graph = preprocess_graph(ds.graph["edge_index"], ds.num_nodes, chunk_dtype="bf16",
                             slab_dtype="int8", device=dev)
    log(f"large-400K dataset + preprocess_graph: {time.perf_counter() - t:.1f} s "
        f"(N = {graph.num_nodes}, E = {graph.num_edges})")
    if (graph.num_nodes, graph.num_edges) != LARGE_400K_GRAPH:
        raise AssertionError("unexpected large-400K graph size")
    # the kernel alone at the shape this path gives it: the first GCN
    # layer's [N, 256] bf16 on the large-400K graph
    q8_phase(graph, results, dev, key="csr_spmm_q8_large400k", dtypes=(torch.bfloat16,))
    model, scale_of = bench_model(ds, dev)
    tc = BENCH_TRAIN
    per_step, per_forward, run_counts, res_q8 = train_path(
        "large-400K-int8", model, ds, graph, tc, Q8_STEP_LAUNCHES, Q8_FORWARD_LAUNCHES,
        TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, (LOGITS_ATOL, 0.0), scale_of, dev)

    # the same graph aggregated in bf16: the logits at the trained weights,
    # then one time_test of its own
    graph_bf16 = dataclasses.replace(graph, slab_dtype="compute", rs=None)
    feats, label = ds.graph["node_feat"], ds.label
    logits_q8 = Trainer(model, graph, feats, label, TrainConfig(**tc), device=dev).eval_step()
    trainer = Trainer(model, graph_bf16, feats, label, TrainConfig(**tc), device=dev)
    logits_bf16 = trainer.eval_step()
    diff = (logits_q8 - logits_bf16).abs().max().item()
    scale = logits_bf16.abs().max().item()
    agree = (logits_q8.argmax(-1) == logits_bf16.argmax(-1)).float().mean().item()
    log(f"large-400K eval logits, int8 vs bf16 aggregation at the trained weights: max "
        f"|diff| {diff:.3e} ({diff / scale:.2e} of the largest logit {scale:.3e}), argmax "
        f"agreement {agree:.5f} (printed, no limit)")
    del logits_q8, logits_bf16
    n = graph.num_nodes
    split = {"train": np.arange(0, n, 2), "valid": np.arange(1, n, 4),
             "test": np.arange(3, n, 4)}
    kernels.reset_launch_counts()
    res_bf16 = time_test(trainer, split, epochs=TRAIN_EPOCHS, warmup=TRAIN_WARMUP)
    counts = kernels.launch_counts()
    steps = TRAIN_EPOCHS + TRAIN_WARMUP
    want = {k: c * steps + 2 * FORWARD_LAUNCHES[k] for k, c in STEP_LAUNCHES.items()}
    log(f"launches over large-400K-bf16 time_test: {counts}")
    if counts != want:
        raise AssertionError(f"launch counts {counts}, expected {want}")
    log(f"large-400K-bf16 time_test: {res_bf16.per_epoch_ms:.3f} ms per train step, forward "
        f"{res_bf16.forward_ms:.3f} ms, peak memory {res_bf16.peak_memory_mb:.1f} MiB; "
        f"losses first {res_bf16.losses[0]:.6f}, last {res_bf16.losses[-1]:.6f}")
    log(f"large-400K train step: int8 {res_q8.per_epoch_ms:.3f} ms, bf16 "
        f"{res_bf16.per_epoch_ms:.3f} ms ({res_bf16.per_epoch_ms / res_q8.per_epoch_ms:.3f}x); "
        f"forward int8 {res_q8.forward_ms:.3f} ms, bf16 {res_bf16.forward_ms:.3f} ms")
    del trainer, graph, graph_bf16, model, ds
    torch.cuda.empty_cache()
    return per_step, per_forward, run_counts


def cuda_ms(fn) -> tuple:
    """(fn's result, its device ms from CUDA events around it)."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def batch_kernel_phase(graph_b, results: dict, key: str, dev: str, dtype) -> None:
    """The kernels of a batch step in ``dtype`` at one batch's shapes: the
    four attention kernels at n = the batch's nodes (M = D = 256, one head)
    and ``csr_spmm`` at F = 256 on the batch's subgraph through its hub
    plan, each against its plain version (the backward reduce against its
    plain version in f64, whose sums can cancel: P, ds, dinv, den and gden)
    with the tolerances of the arxiv-shape checks, with time and bound; the
    reduce's three launches (its main kernel, ``la_finish_kernel`` adding
    the slices' partials, ``la_scalars_kernel``) also timed apart, with the
    slices. Every attention kernel runs its tensor-core design in both
    types (f32 in 3xTF32), logged at each shape: each at the shapes a batch
    path gives it; ``csr_spmm`` also beside ``torch.sparse.mm``."""
    from sgformer_tpu_torch.kernels import attention as attn
    from sgformer_tpu_torch.kernels.spmm import csr_spmm
    from sgformer_tpu_torch.ops.spmm import spmm as spmm_plain

    n, e, m = graph_b.num_nodes, graph_b.num_edges, 256
    name_t = DTYPE_NAME[dtype]
    designs = dict(zip(("linear_attention_bwd_apply", "linear_attention_bwd_reduce"),
                       bwd_designs(attn, dtype, m, m, f"{key} n={n}")))
    designs.update(zip(("linear_attention_reduce", "linear_attention_apply"),
                       fwd_designs(attn, dtype, m, m, f"{key} n={n}")))
    gen = torch.Generator(device=dev).manual_seed(9)
    q, k, v, g = (torch.randn(n, m, generator=gen, device=dev).to(dtype) for _ in range(4))
    elt = q.element_size()
    n_t = torch.full((), float(n), device=dev)
    sums = attn.reduce_plain(q, k, v, False)
    red = attn.bwd_reduce_plain(q, v, g, *sums, n_t, False)
    errs = {
        "linear_attention_reduce": max(
            check_rel(f"{key} reduce {name_t} n={n} {part}", a, b, REDUCE_REL_TOL)
            for part, a, b in zip(("kvs", "ksum"), attn.reduce(q, k, v), sums)),
        "linear_attention_apply": check_close(
            f"{key} apply {name_t} n={n}", attn.apply(q, v, *sums, n_t),
            attn.apply_plain(q, v, *sums, n_t, False), **TOL[dtype]),
        # every output checked, P's and ds's error reported
        "linear_attention_bwd_reduce": max([
            check_rel(f"{key} bwd_reduce {name_t} n={n} {part} (plain in f64)", a, b, REDUCE_REL_TOL)
            for part, a, b in zip(("P", "ds", "dinv", "den, gden"),
                                  attn.bwd_reduce(q, v, g, *sums, n_t),
                                  attn.bwd_reduce_plain(*(t.double() for t in (q, v, g)),
                                                        *(t.double() for t in sums[:2]),
                                                        sums[2].double(), n_t.double(), False))][:2]),
        "linear_attention_bwd_apply": max(
            check_rel(f"{key} bwd_apply {name_t} n={n} {part}", a, b, BWD_REL_TOL[dtype])
            for part, a, b in zip(("dq", "dk", "dv"), attn.bwd_apply(q, k, v, g, *sums, n_t, *red),
                                  attn.bwd_apply_plain(q, k, v, g, *sums, n_t, *red, False))),
    }
    small = (2 * m * m + 2 * m + 6) * 4
    runs = {
        "linear_attention_reduce": (
            lambda: attn.reduce(q, k, v), lambda: attn.reduce_plain(q, k, v, False),
            3 * n * m * elt + (m * m + m + 4) * 4, 2 * n * m * m + 3 * n * m),
        "linear_attention_apply": (
            lambda: attn.apply(q, v, *sums, n_t),
            lambda: attn.apply_plain(q, v, *sums, n_t, False),
            3 * n * m * elt + (m * m + m + 4) * 4, 2 * n * m * m + 2 * n * m + 4 * n * m),
        "linear_attention_bwd_reduce": (
            lambda: attn.bwd_reduce(q, v, g, *sums, n_t),
            lambda: attn.bwd_reduce_plain(q, v, g, *sums, n_t, False),
            3 * n * m * elt + small + 2 * n * 4, bwd_reduce_ops(n, m, m, dtype)),
        "linear_attention_bwd_apply": (
            lambda: attn.bwd_apply(q, k, v, g, *sums, n_t, *red),
            lambda: attn.bwd_apply_plain(q, k, v, g, *sums, n_t, *red, False),
            7 * n * m * elt + 2 * small + 2 * n * 4, 6 * n * m * m + 8 * n * m + 3 * n * m),
    }
    csr = (graph_b.indptr, graph_b.edge_src, graph_b.edge_dst, graph_b.gcn_weight,
           graph_b.hub_segments, graph_b.hub_edges)
    errs["csr_spmm"] = check_close(
        f"{key} csr_spmm {name_t} F={m} (E = {e})", csr_spmm(q, *csr),
        spmm_plain(q, graph_b.edge_src, graph_b.edge_dst, graph_b.gcn_weight, n), **TOL[dtype])
    runs["csr_spmm"] = (lambda: csr_spmm(q, *csr),
                        lambda: spmm_plain(q, graph_b.edge_src, graph_b.edge_dst,
                                           graph_b.gcn_weight, n),
                        2 * n * m * elt + e * 8 + (n + 1) * 4, 2 * e * m)
    for name, (run, plain, nbytes, ops) in runs.items():
        ms, plain_ms = time_ms(run), time_ms(plain, iters=5)
        b_ms, b_by = bound_ms(nbytes, ops, dtype)
        bytes_ms = bound_ms(nbytes, 0, dtype)[0]
        log(f"{key} {name} {name_t} n={n}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"by {bound_name(b_by, dtype)}; bytes alone {bytes_ms:.4f} ms)")
        results[(key, name, name_t, n)] = dict(max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                                               bound_ms=b_ms, bound_by=b_by,
                                               bytes_bound_ms=bytes_ms)
        if name in designs:
            results[(key, name, name_t, n)]["design"] = designs[name]
    # the reduce's launches apart: the slices' partials are written and
    # added whatever a slice's length
    first = "la_reduce_wg_kernel" if dtype == torch.float32 else "la_reduce_wgmma_kernel"
    passes = kernel_ms(lambda: attn.reduce(q, k, v), (first, "la_finish_kernel",
                                                      "la_scalars_kernel"))
    slices, rows = attn._slices(n, m, m, q.device, True)
    log(f"{key} reduce {name_t} n={n} by launch: {first} {passes[first]:.4f} ms, "
        f"la_finish_kernel {passes['la_finish_kernel']:.4f} ms, la_scalars_kernel "
        f"{passes['la_scalars_kernel']:.4f} ms ({slices} slices of {rows} rows)")
    results[(key, "linear_attention_reduce", name_t, n)].update(
        main_ms=passes[first], finish_ms=passes["la_finish_kernel"],
        scalars_ms=passes["la_scalars_kernel"], slices=slices)
    # csr_spmm's library yardstick at the batch's shape: torch.sparse.mm
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_csr_tensor(graph_b.indptr, graph_b.edge_src,
                                    graph_b.gcn_weight.to(dtype), size=(n, n))
    library_ms = library_time(f"{key} torch.sparse.mm {name_t} n={n}",
                              lambda: torch.sparse.mm(a, q))
    log(f"{key} csr_spmm {name_t} n={n}: torch.sparse.mm {library_ms} ms")
    results[(key, "csr_spmm", name_t, n)].update(edges=e, library_ms=library_ms)
    del q, k, v, g, sums, red, a
    torch.cuda.empty_cache()


def check_same_graph(what: str, graph_b, graph_c) -> None:
    """A batch's graph built on the card against the same function on CPU
    tensors: every field bitwise equal."""
    for f in dataclasses.fields(graph_c):
        a, c = getattr(graph_b, f.name), getattr(graph_c, f.name)
        same = (a.dtype == c.dtype and torch.equal(a.cpu(), c)) if isinstance(
            c, torch.Tensor) else a == c
        if not same:
            raise AssertionError(f"{what}: the card's batch graph differs from the CPU "
                                 f"build in {f.name}")
    log(f"{what} batch graph: bitwise the CPU build (every field, the transposed CSR "
        f"and both hub plans included)")


def batch_train_path(what: str, trainer, split: dict, results: dict, tols: tuple,
                     scale_of: dict, bitwise_build: bool, dev: str) -> dict:
    """One model behind ``BatchTrainer`` (one epoch's batches from a
    permutation of ``np.random.default_rng(0)``):
    (a) one batch's subgraph built on the card (CUDA events) and the same
    function on CPU tensors (host clock), bitwise equal when
    ``bitwise_build``; the kernels alone in f32 and in bf16 at the shapes
    of a full batch and of the tail (``batch_kernel_phase``);
    (b) one batch step's loss and gradients through the kernels against the
    plain versions, from the same weights; the launches of one step and of
    one eval forward of a batch, whose logits are held to the plain
    forward's; ``tols`` = (loss, gradient, logits as a share of the largest,
    logits absolute);
    (c) the path's run: ``fit`` for one epoch, with the config's eval, its
    launches, losses (the last 3 below the first), results and peak memory;
    (d) each batch's build and step ms (CUDA events) over a new permutation,
    a streaming eval's wall time, and a profile of three consecutive batches,
    build included. Returns the launch counts of (b) and (c) and the run's
    numbers."""
    import numpy as np

    from sgformer_tpu_torch.train import build_subgraph_batch

    cfg, model = trainer.config, trainer.model
    n, b = trainer.num_nodes, cfg.batch_size
    nb = trainer.num_batches()
    train_set = torch.zeros(n, dtype=torch.bool, device=dev)
    train_set[torch.from_numpy(split["train"]).to(dev)] = True
    perm = torch.from_numpy(np.random.default_rng(0).permutation(n)).to(dev)
    tail = perm[(nb - 1) * b:]
    log(f"{what}: {n} nodes, {trainer.edge_index.shape[1]} edges, {nb} batches of {b} "
        f"(tail {tail.numel()})")

    # (a) one batch built on the card and on the CPU; the kernels alone in
    # both types at the full batch's and the tail's shapes
    bidx = perm[:b]
    graph_b, build_ms = cuda_ms(lambda: build_subgraph_batch(trainer.edge_index, bidx, n))
    ei_cpu, bidx_cpu = trainer.edge_index.cpu(), bidx.cpu()
    t = time.perf_counter()
    graph_c = build_subgraph_batch(ei_cpu, bidx_cpu, n)
    cpu_ms = (time.perf_counter() - t) * 1e3
    log(f"{what} batch subgraph: {graph_b.num_edges} edges, {graph_b.hub_segments.shape[0]} + "
        f"{graph_b.t_hub_segments.shape[0]} hub segments; built in {build_ms:.3f} ms on the "
        f"card (first build), {cpu_ms:.1f} ms on CPU tensors")
    if bitwise_build:
        check_same_graph(what, graph_b, graph_c)
    del ei_cpu, graph_c
    graph_t = build_subgraph_batch(trainer.edge_index, tail, n)
    for dtype in (torch.float32, torch.bfloat16):
        for gb in (graph_b, graph_t):
            batch_kernel_phase(gb, results, what, dev, dtype)
    del graph_t

    # (b) one step through the kernels and through the plain versions, from
    # the same weights; the launches of one step and of one eval forward
    trainer.init_state(0)
    batch = trainer.build_batch(bidx, train_set)
    check_step(f"{what} batch", model, trainer.generator, lambda: trainer.loss(batch), tols[0],
               tols[1], scale_of)
    _, per_step = counted(f"one {what} batch step", lambda: trainer.train_step(batch),
                          STEP_LAUNCHES)
    logits, per_forward = counted(f"one {what} batch forward", lambda: trainer.forward(batch),
                                  FORWARD_LAUNCHES)
    with plain_versions():
        ref = trainer.forward(batch)
    check_logits(f"{what} batch", logits, ref, (b, model.config.out_channels),
                 (tols[3], tols[2]))
    del logits, ref, batch, graph_b
    torch.cuda.empty_cache()

    # (c) the path's run: fit, one epoch and its eval
    torch.cuda.reset_peak_memory_stats()
    trainer.record_losses = True
    forwards = nb if cfg.eval_mode == "batch" else 1
    want = {k: c * nb + forwards * FORWARD_LAUNCHES[k] for k, c in STEP_LAUNCHES.items()}
    t = time.perf_counter()
    logger, run_counts = counted(f"{what} fit ({nb} batch steps, {forwards} eval forwards)",
                                 lambda: trainer.fit([split]), want)
    fit_s = time.perf_counter() - t
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    losses = trainer.train_losses
    result = logger.results[0][-1]
    log(f"{what} fit: {fit_s:.3f} s for one epoch ({nb} steps) and its {cfg.eval_mode} eval; "
        f"peak device memory {peak_mib:.1f} MiB")
    log(f"{what} losses: {[round(x, 6) for x in losses]}")
    log(f"{what} accuracies after one epoch: train {result[0]:.4f}, valid {result[1]:.4f}, "
        f"test {result[2]:.4f}")
    if len(losses) != nb or not all(np.isfinite(losses)) or not sum(losses[-3:]) / 3 < losses[0]:
        raise AssertionError(f"the {what} loss did not fall over the epoch")

    # (d) each batch's build and step on the card over a new permutation, a
    # streaming eval's wall time, a profile of three batches, build included
    perm = torch.from_numpy(np.random.default_rng(1).permutation(n)).to(dev)
    builds, steps = [], []
    for i in range(nb):
        bb, ms = cuda_ms(lambda: trainer.build_batch(perm[i * b:(i + 1) * b], train_set))
        builds.append(ms)
        steps.append(cuda_ms(lambda: trainer.train_step(bb))[1])
    t = time.perf_counter()
    trainer.evaluate_streaming(split, np.random.default_rng(2))
    eval_s = time.perf_counter() - t
    log(f"{what} batch build on the card: median {statistics.median(builds):.3f} ms over {nb} "
        f"(min {min(builds):.3f}, max {max(builds):.3f}); batch step: median "
        f"{statistics.median(steps[:-1]):.3f} ms over {nb - 1} full batches, tail "
        f"{steps[-1]:.3f} ms; a streaming eval of all nodes: {eval_s * 1e3:.1f} ms wall")
    it = iter(range(3))
    wall, busy = profile_device(
        f"{what} 3 batches (build + step)",
        lambda: trainer.train_step(trainer.build_batch(perm[next(it) * b:][:b], train_set)), 3)
    numbers = dict(build_ms=statistics.median(builds), cpu_build_ms=cpu_ms,
                   step_ms=statistics.median(steps[:-1]), tail_step_ms=steps[-1],
                   fit_s=fit_s, eval_s=eval_s, peak_mib=peak_mib, busy_share=busy / wall,
                   losses=losses, result=result)
    return per_step, per_forward, run_counts, numbers


def arxiv_batch_phase(ds, graph, results: dict, dev: str) -> tuple:
    """arxiv-batch-train: the bench model behind ``BatchTrainer`` on the
    arxiv graph's batch-tier edge list (the graph's own, symmetrised with
    self-loops), batches of 50,000, full-graph eval on that graph."""
    import numpy as np

    from sgformer_tpu_torch.train import BatchTrainConfig, BatchTrainer

    model, scale_of = bench_model(ds, dev)
    edges = torch.stack([graph.edge_src, graph.edge_dst])
    trainer = BatchTrainer(model, edges, ds.graph["node_feat"], ds.label,
                           BatchTrainConfig(**BENCH_TRAIN, epochs=1, batch_size=ARXIV_BATCH,
                                            eval_mode="full"),
                           full_graph=graph, device=dev)
    n = graph.num_nodes
    split = {"train": np.arange(0, n, 2), "valid": np.arange(1, n, 4),
             "test": np.arange(3, n, 4)}
    out = batch_train_path("arxiv-batch", trainer, split, results,
                           (TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, 0.0, LOGITS_ATOL), scale_of,
                           False, dev)
    del trainer, model, edges
    torch.cuda.empty_cache()
    return out


def amazon2m_batch_phase(results: dict, dev: str) -> tuple:
    """amazon2m-batch-train: the repo's amazon2m recipe (``configs/large.sh``,
    f32) at the ogbn-products graph's size behind ``BatchTrainer``, batches
    of 100,000, streaming eval; then the step with bf16 activations for one
    timing (printed, no limit), and ``preprocess_graph`` of the full graph
    on the card, timed."""
    import numpy as np

    from sgformer_tpu_torch import SGFormer, SGFormerConfig, preprocess_graph
    from sgformer_tpu_torch.data import synthetic_dataset
    from sgformer_tpu_torch.data.splits import rand_train_test_idx
    from sgformer_tpu_torch.graph import add_self_loops, remove_self_loops, to_undirected
    from sgformer_tpu_torch.train import BatchTrainConfig, BatchTrainer

    t = time.perf_counter()
    ds = synthetic_dataset(**AMAZON2M, device=dev)
    gen_s = time.perf_counter() - t
    t = time.perf_counter()
    ei = torch.from_numpy(ds.graph["edge_index"]).to(dev)
    ei = add_self_loops(remove_self_loops(to_undirected(ei)), ds.num_nodes).int()
    torch.cuda.synchronize()
    log(f"amazon2m dataset: {gen_s:.1f} s on the host; edge list symmetrised with self-loops "
        f"on the card in {time.perf_counter() - t:.2f} s: N = {ds.num_nodes}, E = {ei.shape[1]}")
    split = rand_train_test_idx(ds.label, rng=np.random.default_rng(0))
    cfg = SGFormerConfig.large(256, AMAZON2M["num_classes"], **AMAZON2M_CONFIG)
    model = SGFormer(cfg, AMAZON2M["num_features"], generator=torch.Generator().manual_seed(0),
                     device=dev)
    trainer = BatchTrainer(model, ei, ds.graph["node_feat"], ds.label,
                           BatchTrainConfig(**AMAZON2M_TRAIN, epochs=1,
                                            batch_size=AMAZON2M_BATCH, eval_mode="batch"),
                           device=dev)
    del ei
    scale_of = {"graph_conv.fc_in.bias": "graph_conv.bn_in.bias"}
    scale_of.update({f"graph_conv.conv_{i}.W.bias": f"graph_conv.bn_{i}.bias"
                     for i in range(cfg.gnn_num_layers)})
    out = batch_train_path("amazon2m-batch", trainer, split, results,
                           (BATCH_LOSS_RTOL, BATCH_GRAD_RTOL, BATCH_LOGITS_RTOL, 0.0), scale_of,
                           True, dev)

    # the same step with bf16 activations: its time, printed with no limit
    bf16 = SGFormer(dataclasses.replace(cfg, compute_dtype="bf16"), AMAZON2M["num_features"],
                    generator=torch.Generator().manual_seed(0), device=dev)
    trainer_b = BatchTrainer(bf16, trainer.edge_index, trainer.x, ds.label,
                             trainer.config, device=dev)
    trainer_b.init_state(0)
    train_set = torch.zeros(trainer.num_nodes, dtype=torch.bool, device=dev)
    train_set[torch.from_numpy(split["train"]).to(dev)] = True
    perm = torch.from_numpy(np.random.default_rng(3).permutation(trainer.num_nodes)).to(dev)
    b = AMAZON2M_BATCH
    steps = []
    for i in range(BF16_BATCHES):
        batch = trainer_b.build_batch(perm[i * b:(i + 1) * b], train_set)
        steps.append(cuda_ms(lambda: trainer_b.train_step(batch))[1])
    out[3]["bf16_step_ms"] = statistics.median(steps[1:])
    log(f"amazon2m-batch step with bf16 activations: median {out[3]['bf16_step_ms']:.3f} ms over "
        f"{BF16_BATCHES - 1} batches (f32: {out[3]['step_ms']:.3f} ms; printed, no limit)")
    edges = trainer.edge_index.shape[1]
    del trainer, trainer_b, model, bf16, batch
    torch.cuda.empty_cache()

    # preprocess_graph of the full graph on the card: the set-up a
    # full-graph eval at this size needs (that eval is not run: the plain
    # forward it would be held to gathers [E, 256] f32 messages, 129 GB)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    full = preprocess_graph(ds.graph["edge_index"], ds.num_nodes, device=dev)
    torch.cuda.synchronize()
    out[3]["preprocess_s"] = time.perf_counter() - t
    log(f"amazon2m preprocess_graph of the full graph on the card: {out[3]['preprocess_s']:.2f} s "
        f"(E = {full.num_edges}, {full.hub_segments.shape[0]} hub segments; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 20:.1f} MiB)")
    if full.num_edges != edges:
        raise AssertionError("preprocess_graph's edges differ from the batch tier's edge list")
    del full, ds
    torch.cuda.empty_cache()
    return out


def spmm_transposed_check(graph_b, results: dict, key: str, dev: str) -> None:
    """csr_spmm in f32 at F = 256 on a batch graph's transposed CSR (A^T,
    the gradient's walk) through its hub plan: against its plain version,
    bitwise repeatable, with time, bound, plain and library time."""
    from sgformer_tpu_torch.kernels.spmm import csr_spmm
    from sgformer_tpu_torch.ops.spmm import spmm as spmm_plain

    n, e, f = graph_b.num_nodes, graph_b.num_edges, 256
    x = torch.randn(n, f, generator=torch.Generator(device=dev).manual_seed(10), device=dev)
    csr = (graph_b.t_indptr, graph_b.t_edge_src, graph_b.t_edge_dst, graph_b.t_weight,
           graph_b.t_hub_segments, graph_b.hub_edges)
    got = csr_spmm(x, *csr)
    err = check_close(f"{key} csr_spmm f32 F={f} on A^T (E = {e}, "
                      f"{graph_b.t_hub_segments.shape[0]} hub segments)", got,
                      spmm_plain(x, *csr[1:4], n), **TOL[torch.float32])
    if not torch.equal(got, csr_spmm(x, *csr)):
        raise AssertionError("csr_spmm on A^T is not bitwise repeatable")
    ms = time_ms(lambda: csr_spmm(x, *csr))
    plain_ms = time_ms(lambda: spmm_plain(x, *csr[1:4], n), iters=5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_csr_tensor(graph_b.t_indptr, graph_b.t_edge_src, graph_b.t_weight,
                                    size=(n, n))
    library_ms = library_time("torch.sparse.mm f32 on A^T", lambda: torch.sparse.mm(a, x))
    b_ms, b_by = bound_ms(2 * n * f * 4 + e * 8 + (n + 1) * 4, 2 * e * f, torch.float32)
    log(f"{key} csr_spmm f32 n={n} on A^T: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
        f"torch.sparse.mm {library_ms} ms, bound {b_ms:.4f} ms by {b_by})")
    results[(key, "csr_spmm_t", "f32", n)] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=library_ms, edges=e, hub_segments=graph_b.t_hub_segments.shape[0])
    del x, got, a
    torch.cuda.empty_cache()


def papers_sampled_phase(results: dict, dev: str) -> tuple:
    """papers-sampled-train: the papers100M recipe (``PAPERS_CONFIG``, f32,
    hidden 256, 172 classes) behind ``SampledTrainer`` on a synthetic graph
    of papers100M's shape (``PAPERS``), its edge list symmetrised with
    self-loops on the card and its int64 CSR sorted there and kept on the
    host, papers100M's split shares, batches of 1,000 seeds, fanouts
    (15, 10, 5), uncapped, through the C++ sampler: (a) ``PAPERS_SAMPLES``
    batches sampled on the host (each timed, with its nodes, edges and
    longest rows of A and A^T; its rows' gather, cast and pin timed apart;
    the numpy path timed on the same seeds) and one batch's graph built on
    the card and on CPU tensors, bitwise equal; the kernels alone at that batch's shape in f32
    (``batch_kernel_phase``, and ``csr_spmm`` on A^T); (b) one step against
    the plain step (1e-5 loss, 1e-4 gradients), the launches of a step and
    of a forward, a forward's logits against the plain forward's; (c)
    ``fit`` for one epoch with its valid and test sweeps: launches, losses
    (the last 3 below the first), accuracies, peak memory and the best state
    saved, run with ``sampler_workers`` 0 and ``min(8, os.cpu_count())``
    (bitwise the same losses and accuracies; each run's wall time a batch
    and device-busy share, profiled whole); (d) the checkpoint: the whole
    state loaded into a fresh model gives the saved state's eval logits
    bitwise, and ``use_pretrained`` gives the saved parameters beside fresh
    BatchNorm statistics; (e) each sampled batch's build and step ms, a
    streaming sweep's wall time and a profile of three batches with their
    sampling, gathers and builds.
    Returns the launches of (b) and (c) and the run's numbers."""
    import math
    import os
    import shutil

    import numpy as np

    from sgformer_tpu_torch import SGFormer, SGFormerConfig
    from sgformer_tpu_torch.data import synthetic_dataset
    from sgformer_tpu_torch.graph import add_self_loops, remove_self_loops, to_undirected
    from sgformer_tpu_torch.sample import CSRGraph, NeighborSampler, neighbor
    from sgformer_tpu_torch.train import SampledTrainConfig, SampledTrainer, build_sampled_graph
    from sgformer_tpu_torch.train.checkpoint import read_state

    what = "papers-sampled"
    t = time.perf_counter()
    ds = synthetic_dataset(**PAPERS, device=dev)
    gen_s = time.perf_counter() - t
    t = time.perf_counter()
    ei = torch.from_numpy(ds.graph["edge_index"]).to(dev)
    ei = add_self_loops(remove_self_loops(to_undirected(ei)), ds.num_nodes)
    csr = CSRGraph.from_edge_index(ei, ds.num_nodes)
    del ei
    torch.cuda.empty_cache()
    n = ds.num_nodes
    log(f"{what} dataset: {gen_s:.1f} s on the host; edge list symmetrised with self-loops and "
        f"its int64 CSR sorted on the card, copied to the host, in "
        f"{time.perf_counter() - t:.2f} s: N = {n}, E = {len(csr.indices)}")
    perm = np.random.default_rng(0).permutation(n)
    sizes = [round(n * PAPERS_SPLIT[s] / PAPERS_NODES) for s in ("train", "valid", "test")]
    split = {"train": perm[:sizes[0]], "valid": perm[sizes[0]:sizes[0] + sizes[1]],
             "test": perm[sizes[0] + sizes[1]:sum(sizes)]}
    cfg = SGFormerConfig.papers100m(256, PAPERS["num_classes"], **PAPERS_CONFIG)
    model = SGFormer(cfg, PAPERS["num_features"], generator=torch.Generator().manual_seed(0),
                     device=dev)
    model_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", what)
    shutil.rmtree(model_dir, ignore_errors=True)
    tc = SampledTrainConfig(**PAPERS_TRAIN, epochs=1, save_model=True, model_dir=model_dir)
    trainer = SampledTrainer(model, csr, ds.graph["node_feat"], ds.label, tc, device=dev)
    del ds
    torch.cuda.empty_cache()
    b = tc.batch_size
    log(f"{what}: splits of {sizes} seeds, batches of {b}, fanouts {tc.fanouts}")

    # (a) batches sampled on the host; one built on the card and on the CPU;
    # the kernels alone at its shape
    batches, sample_ms, gather_ms, hop_ms, numpy_ms = [], [], [], [], []
    hop_sampler = NeighborSampler(csr, n, tc.fanouts, b, seed=0, use_native=False)
    numpy_sampler = NeighborSampler(csr, n, tc.fanouts, b, seed=0, use_native=False)
    if not trainer.sampler.use_native:
        raise AssertionError(f"{what}: the trainer's sampler is not the C++ sampler")
    for i in range(PAPERS_SAMPLES):
        seeds = split["train"][i * b:(i + 1) * b]
        t = time.perf_counter()
        batch = trainer.sampler.sample(seeds)
        sample_ms.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        batches.append((batch, trainer.gather_x(batch.node_ids)))
        gather_ms.append((time.perf_counter() - t) * 1e3)
        log(f"{what} batch {i} (C++ sampler): {batch.num_nodes} nodes, {len(batch.edge_src)} "
            f"edges, longest row of A {np.bincount(batch.edge_dst).max()}, of A^T "
            f"{np.bincount(batch.edge_src).max()}; sampled in {sample_ms[-1]:.1f} ms on the host")
        log(f"{what} batch {i} rows: {batch.num_nodes} x {PAPERS['num_features']} gathered, cast "
            f"to {trainer.transfer_dtype} and pinned in {gather_ms[-1]:.1f} ms on the host "
            f"({batches[-1][1].nbytes / 2 ** 20:.1f} MiB)")
        t = time.perf_counter()
        other = hop_sampler.sample(seeds)
        hop_ms.append((time.perf_counter() - t) * 1e3)
        with mock.patch.object(neighbor, "_sample_neighbors", neighbor._sample_neighbors_plain):
            t = time.perf_counter()
            plain = numpy_sampler.sample(seeds)
            numpy_ms.append((time.perf_counter() - t) * 1e3)
        log(f"{what} batch {i} (use_native=False, same seeds): the C++ hop sampler "
            f"{other.num_nodes} nodes, {len(other.edge_src)} edges, sampled in "
            f"{hop_ms[-1]:.1f} ms on the host; its numpy plain version {plain.num_nodes} nodes, "
            f"{len(plain.edge_src)} edges, {numpy_ms[-1]:.1f} ms")
    del hop_sampler, numpy_sampler, other, plain
    batch, rows = batches[0]
    graph_b, build_ms = cuda_ms(lambda: build_sampled_graph(batch, dev))
    t = time.perf_counter()
    graph_c = build_sampled_graph(batch, "cpu")
    cpu_ms = (time.perf_counter() - t) * 1e3
    log(f"{what} batch graph: built in {build_ms:.3f} ms on the card (first build), "
        f"{cpu_ms:.1f} ms on CPU tensors; {graph_b.hub_segments.shape[0]} + "
        f"{graph_b.t_hub_segments.shape[0]} hub segments")
    check_same_graph(what, graph_b, graph_c)
    del graph_c
    batch_kernel_phase(graph_b, results, what, dev, torch.float32)
    spmm_transposed_check(graph_b, results, what, dev)

    # (b) one step through the kernels and through the plain versions, from
    # the same weights and dropout masks; the launches of a step and of a
    # forward
    trainer.init_state(0)
    db = trainer.to_device(batch, rows)
    scale_of = {"graph_conv.fc_in.bias": "graph_conv.bn_in.bias"}
    scale_of.update({f"graph_conv.conv_{i}.W.bias": f"graph_conv.bn_{i}.bias"
                     for i in range(cfg.gnn_num_layers)})
    check_step(f"{what} batch", model, trainer.generator, lambda: trainer.loss(db),
               BATCH_LOSS_RTOL, BATCH_GRAD_RTOL, scale_of)
    _, per_step = counted(f"one {what} batch step", lambda: trainer.train_step(db), STEP_LAUNCHES)
    logits, per_forward = counted(f"one {what} batch forward", lambda: trainer.forward(db),
                                  FORWARD_LAUNCHES)
    with plain_versions():
        ref = trainer.forward(db)
    check_logits(f"{what} batch", logits, ref, (batch.num_nodes, PAPERS["num_classes"]),
                 (0.0, BATCH_LOGITS_RTOL))
    del logits, ref
    torch.cuda.empty_cache()

    # (c) the path's run: fit, one epoch and its valid and test sweeps, its
    # batches sampled in the prefetch thread and then by a pool of threads;
    # each fit profiled whole for its device-busy share
    trainer.record_losses = True
    nb = math.ceil(sizes[0] / b)
    forwards = math.ceil(sizes[1] / b) + math.ceil(sizes[2] / b)
    want = {k: c * nb + forwards * FORWARD_LAUNCHES[k] for k, c in STEP_LAUNCHES.items()}
    cores = os.cpu_count()
    fits = {}
    for workers in (0, min(8, cores or 1)):
        trainer.config = dataclasses.replace(tc, sampler_workers=workers)
        torch.cuda.reset_peak_memory_stats()
        box = {}

        def run():
            box["logger"] = trainer.fit([split], np_rng=np.random.default_rng(1))

        label = f"{what} fit, sampler_workers={workers}"
        (wall, busy), run_counts = counted(
            f"{label} ({nb} batch steps, {forwards} eval forwards)",
            lambda: profile_device(label, run, 1), want)
        fit = dict(wall_ms=wall, busy_ms=busy, losses=list(trainer.train_losses),
                   peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20,
                   results=box["logger"].results)
        fits[workers] = fit
        log(f"{label}: {wall / 1e3:.3f} s for one epoch ({nb} steps) and its valid and test "
            f"sweeps, {wall / (nb + forwards):.1f} ms wall a batch, the card busy "
            f"{busy / wall:.1%}; host cores {cores}; peak device memory "
            f"{fit['peak_mib']:.1f} MiB")
    (w0, serial), (wn, threaded) = fits.items()
    losses, result = serial["losses"], serial["results"][0][-1]
    log(f"{what} losses: {[round(x, 6) for x in losses]}")
    log(f"{what} accuracies after one epoch: valid {result[1]:.4f}, test {result[2]:.4f}")
    if len(losses) != nb or not all(np.isfinite(losses)) or not sum(losses[-3:]) / 3 < losses[0]:
        raise AssertionError(f"the {what} loss did not fall over the epoch")
    if threaded["losses"] != losses or threaded["results"] != serial["results"]:
        raise AssertionError(f"{what}: sampler_workers={wn} gave other losses or accuracies than "
                             f"{w0}: {threaded['losses']}, {threaded['results']}")
    log(f"{what}: sampler_workers={wn} gives bitwise the losses and accuracies of {w0}; epoch "
        f"wall a batch {serial['wall_ms'] / (nb + forwards):.1f} -> "
        f"{threaded['wall_ms'] / (nb + forwards):.1f} ms, busy "
        f"{serial['busy_ms'] / serial['wall_ms']:.1%} -> "
        f"{threaded['busy_ms'] / threaded['wall_ms']:.1%} on {cores} host cores")
    fit_s, peak_mib = serial["wall_ms"] / 1e3, serial["peak_mib"]

    # (d) the saved best state: whole into a fresh model, then as
    # use_pretrained restores it
    saved = read_state(trainer.checkpoint_path)
    if saved.keys() != trainer.best_state.keys() or not all(
            torch.equal(v, trainer.best_state[k].cpu()) for k, v in saved.items()):
        raise AssertionError(f"{what}: the checkpoint is not the best-on-valid state")
    model.load_state_dict(trainer.best_state)
    want_logits = trainer.forward(db)
    fresh = SGFormer(cfg, PAPERS["num_features"], generator=torch.Generator().manual_seed(1),
                     device=dev)
    fresh.load_state_dict(saved)
    fresh.eval()
    with torch.no_grad():
        if not torch.equal(fresh(db.x, db.graph), want_logits):
            raise AssertionError(f"{what}: the reloaded state's eval logits differ")
    pretrained = SampledTrainer(fresh, csr, trainer.x, trainer.label,
                                dataclasses.replace(tc, epochs=0, save_model=False,
                                                    use_pretrained=True), device=dev)
    pretrained.fit([split])
    params = dict(fresh.named_parameters())
    for k, v in pretrained.final_state.items():
        fresh_stat = torch.zeros_like(v) if k.endswith("running_mean") else torch.ones_like(v)
        if not torch.equal(v, saved[k].to(v.device) if k in params else fresh_stat):
            raise AssertionError(f"{what}: use_pretrained gave another {k}")
    moved = (pretrained.forward(db) - want_logits).abs().max().item()
    log(f"{what} checkpoint: the best-on-valid state, reloaded whole, gives its eval logits "
        f"bitwise; with use_pretrained the saved parameters beside fresh BatchNorm statistics "
        f"(eval logits then move by up to {moved:.3e}, printed, no limit)")
    del fresh, pretrained, want_logits
    shutil.rmtree(model_dir, ignore_errors=True)

    # (e) each sampled batch's build and step on the card, a streaming
    # sweep's wall time, a profile of three batches with their sampling
    builds, steps = [], []
    for batch, rows in batches:
        graph, ms = cuda_ms(lambda: build_sampled_graph(batch, dev))
        builds.append(ms)
        db = trainer.to_device(batch, rows)
        steps.append(cuda_ms(lambda: trainer.train_step(db))[1])
    t = time.perf_counter()
    trainer.accuracy(split["valid"])
    eval_s = time.perf_counter() - t
    log(f"{what} on the host: C++ sample median {statistics.median(sample_ms):.1f} ms a batch "
        f"(min {min(sample_ms):.1f}, max {max(sample_ms):.1f}; use_native=False through the "
        f"C++ hop sampler {statistics.median(hop_ms):.1f}, its numpy plain version "
        f"{statistics.median(numpy_ms):.1f}), gather + cast + pin "
        f"{statistics.median(gather_ms):.1f} ms; on the card: build median "
        f"{statistics.median(builds):.3f} ms, step median {statistics.median(steps):.3f} ms "
        f"over {len(steps)} batches; a streaming sweep of the {sizes[1]} valid seeds: "
        f"{eval_s * 1e3:.1f} ms wall; the epoch {fit_s * 1e3 / (nb + forwards):.1f} ms wall a "
        f"batch")
    seeds = iter(range(PAPERS_SAMPLES, PAPERS_SAMPLES + 3))

    def sampled_step():
        batch = trainer.sampler.sample(split["train"][next(seeds) * b:][:b])
        return trainer.train_step(trainer.to_device(batch, trainer.gather_x(batch.node_ids)))

    wall, busy = profile_device(f"{what} 3 batches (sample + gather + build + step)",
                                sampled_step, 3)
    numbers = dict(sample_ms=statistics.median(sample_ms), gather_ms=statistics.median(gather_ms),
                   hop_sample_ms=statistics.median(hop_ms),
                   numpy_sample_ms=statistics.median(numpy_ms),
                   build_ms=statistics.median(builds), cpu_build_ms=cpu_ms,
                   step_ms=statistics.median(steps), fit_s=fit_s, eval_s=eval_s,
                   peak_mib=peak_mib, busy_share=busy / wall, losses=losses, result=result)
    del trainer, model, batches, db, graph_b, graph
    torch.cuda.empty_cache()
    return per_step, per_forward, run_counts, numbers


def recipe_flags(recipe: str, block: str) -> list:
    """The flags of one run of a port recipe (``sgformer_tpu_torch/recipes/
    <recipe>``), the lines of the run that starts with ``block`` without
    ``"$@"``: after the recipe's ``RUN=`` prefix without the interpreter
    when the run starts with ``$RUN``, else after its own ``python -m
    sgformer_tpu_torch.cli.main``."""
    import os
    import shlex

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "sgformer_tpu_torch",
                        "recipes", recipe)
    with open(path) as f:
        text = f.read().replace("\\\n", " ")
    lines = text.splitlines()
    module = ["python", "-m", "sgformer_tpu_torch.cli.main"]
    body = shlex.split(next(ln for ln in lines if ln.startswith(block)))
    if body[:3] == module:
        return [a for a in body[3:] if a != "$@"]
    run = next(ln for ln in lines if ln.startswith("RUN="))
    prefix = shlex.split(run[len("RUN="):].strip().strip('"'))
    assert prefix[:3] == module, prefix
    return prefix[3:] + [a for a in body[1:] if a != "$@"]


def write_ogb_arxiv(ds, root: str) -> dict:
    """``ds``'s arrays in OGB's on-disk layout under ``root``:
    ``ogbn_arxiv/processed.npz`` (the loaders' cache) and
    ``split/time/{train,valid,test}.csv.gz`` from a seeded 50/25/25 split.
    Returns the split."""
    import gzip
    import os

    import numpy as np

    from sgformer_tpu_torch.data.splits import rand_train_test_idx

    base = os.path.join(root, "ogbn_arxiv")
    os.makedirs(os.path.join(base, "split", "time"), exist_ok=True)
    np.savez(os.path.join(base, "processed.npz"), edge_index=ds.graph["edge_index"],
             node_feat=ds.graph["node_feat"].cpu().numpy(), label=ds.label,
             num_nodes=ds.num_nodes)
    split = rand_train_test_idx(ds.label, rng=np.random.default_rng(0))
    for name, idx in split.items():
        with gzip.open(os.path.join(base, "split", "time", f"{name}.csv.gz"), "wt") as f:
            np.savetxt(f, idx, fmt="%d")
    return split


def cli_phase(ds, results: dict, dev: str) -> dict:
    """The port's CLI on the card (``sgformer_tpu_torch.cli.main.main``):
    (a) arxiv-cli-train: the ogbn-arxiv recipe's flags verbatim (the port's
    ``recipes/large.sh``: its ``$RUN`` and the ogbn-arxiv run, the TPU layout
    flags included; hidden 256, 3 GCN layers, 1 attention layer, f32) on
    ``ds``'s arrays written in OGB's layout, cut to 18 epochs (eval every 9)
    and 1 run: the launches over the run (epochs x a step's + evals x a
    forward's), the losses (the last 3 below the first), the logger's
    statistics; the set-up alone (warm) and a profile of one step; (b)
    ``--time_test`` on the same flags: per-step and forward ms, peak memory,
    launches; (c) the batch trainer: the amazon2m run's
    flags on the same files, batches of 50,000, 2 epochs; (d) the sampled
    trainer: the papers100M pretrain run's flags (``recipes/100m.sh``) on
    ``synth-n20000-e120000-f128-c16``, 1 epoch, the best state saved, its
    batches sampled by 2 threads (``--sampler_workers 2``); (e)
    H2GCN (hidden 64, 2 rounds) on that graph through the CLI's set-up: its
    step through the kernels against the plain step (f32: loss 1e-5,
    gradients 1e-4), the launches of a step and a forward, and a
    ``--time_test``. Returns each run's launch counts."""
    import argparse
    import math
    import os
    import shutil

    import numpy as np

    from sgformer_tpu_torch import kernels
    from sgformer_tpu_torch.cli import main as cli
    from sgformer_tpu_torch.train import trainer as trainer_module

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "cli-data")
    shutil.rmtree(root, ignore_errors=True)
    t = time.perf_counter()
    split = write_ogb_arxiv(ds, root)
    log(f"cli: synth-arxiv written in OGB's layout in {time.perf_counter() - t:.1f} s "
        f"(processed.npz, split/time: {len(split['train'])} / {len(split['valid'])} / "
        f"{len(split['test'])})")
    out = {}

    # (a) the ogbn-arxiv recipe through main(), every step's loss recorded
    arxiv = recipe_flags("large.sh", "$RUN --trainer full --dataset ogbn-arxiv")
    argv = arxiv + ["--data_dir", root] + CLI_ARXIV_CUT
    log(f"cli: python -m sgformer_tpu_torch.cli.main {' '.join(argv)}")
    losses = []
    step = trainer_module.Trainer.train_step

    def recording(self, train_idx):
        loss = step(self, train_idx)
        losses.append(loss)
        return loss

    kernels.reset_launch_counts()
    t = time.perf_counter()
    with mock.patch.object(trainer_module.Trainer, "train_step", recording):
        logger = cli.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    counts = kernels.launch_counts()
    epochs, evals = 18, len(logger.results[0])
    log(f"cli: arxiv recipe: {run_s:.2f} s for {epochs} epochs and {evals} evals (the dataset's "
        f"load and the graph's build included); launches {counts}")
    want = {k: c * epochs + evals * FORWARD_LAUNCHES[k] for k, c in STEP_LAUNCHES.items()}
    if evals != 2 or counts != want:
        raise AssertionError(f"cli arxiv recipe: {evals} evals, launch counts {counts}, "
                             f"expected 2 and {want}")
    losses = torch.stack(losses).tolist()
    log(f"cli: arxiv recipe losses: first {losses[0]:.6f}, last 3 "
        f"{[round(x, 6) for x in losses[-3:]]} ({len(losses)} steps)")
    if len(losses) != epochs or not all(np.isfinite(losses)) \
            or not sum(losses[-3:]) / 3 < losses[0]:
        raise AssertionError("the cli arxiv recipe's loss did not fall")
    stats = logger.statistics()
    log(f"cli: arxiv recipe statistics: {stats}")
    out["arxiv"] = counts
    # the run's set-up alone, a second time (warm): the dataset's load, the
    # graph's build on the card, the model and the trainer
    t = time.perf_counter()
    built = cli.build(cli.parser_add_main_args(argparse.ArgumentParser()).parse_args(argv))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    log(f"cli: arxiv recipe set-up (warm): {setup_s:.2f} s (N = {built.graph.num_nodes}, "
        f"E = {built.graph.num_edges})")
    # where one of the recipe's train steps spends its device time
    built.trainer.init_state(0)
    train_idx = built.trainer.prepare_train_idx(built.splits[0])
    wall, busy = profile_device("arxiv-cli step", lambda: built.trainer.train_step(train_idx), 3)
    del built

    # (b) --time_test on the same flags
    kernels.reset_launch_counts()
    res = cli.main(argv + ["--time_test"])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    steps = epochs + 3
    want = {k: c * steps + 2 * FORWARD_LAUNCHES[k] for k, c in STEP_LAUNCHES.items()}
    log(f"cli: arxiv recipe --time_test: {res.per_epoch_ms:.3f} ms per train step over "
        f"{epochs} steps, forward {res.forward_ms:.3f} ms, peak memory "
        f"{res.peak_memory_mb:.1f} MiB on {res.device} ({card_line()}); launches {counts}")
    if counts != want or not sum(res.losses[-3:]) / 3 < res.losses[0]:
        raise AssertionError(f"cli --time_test: launch counts {counts}, expected {want}, or "
                             f"the loss did not fall ({res.losses})")
    results["cli"] = dict(step_ms=res.per_epoch_ms, forward_ms=res.forward_ms,
                          peak_mib=res.peak_memory_mb, run_s=run_s, setup_s=setup_s,
                          busy_share=busy / wall, losses=losses,
                          final_test=stats["final_test"])
    out["time_test"] = counts

    # (c) the batch trainer: the amazon2m run's flags on the arxiv files
    argv = (recipe_flags("large.sh", "$RUN --trainer batch --dataset amazon2m")
            + ["--data_dir", root] + CLI_BATCH_CUT)
    log(f"cli: python -m sgformer_tpu_torch.cli.main {' '.join(argv)}")
    kernels.reset_launch_counts()
    t = time.perf_counter()
    logger = cli.main(argv)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t
    counts = kernels.launch_counts()
    nb, evals = math.ceil(ds.num_nodes / 50_000), len(logger.results[0])
    want = {k: c * 2 * nb + evals * FORWARD_LAUNCHES[k] for k, c in STEP_LAUNCHES.items()}
    log(f"cli: batch run {batch_s:.2f} s for 2 epochs of {nb} batches and {evals} full-graph "
        f"evals; results {logger.results[0]}; launches {counts}")
    if evals != 1 or counts != want:
        raise AssertionError(f"cli batch run: launch counts {counts}, expected {want}")
    results["cli"]["batch_s"] = batch_s
    out["batch"] = counts

    # (d) the sampled trainer: the papers100M pretrain run's flags
    model_dir = os.path.join(root, "papers100m_sgformer")
    argv = (recipe_flags("100m.sh", "$RUN --dataset ogbn-papers100M")
            + ["--dataset", CLI_SAMPLED_DATASET, "--epochs", "1", "--model_dir", model_dir,
               "--sampler_workers", "2"])
    log(f"cli: python -m sgformer_tpu_torch.cli.main {' '.join(argv)}")
    kernels.reset_launch_counts()
    t = time.perf_counter()
    logger = cli.main(argv)
    torch.cuda.synchronize()
    sampled_s = time.perf_counter() - t
    counts = kernels.launch_counts()
    parser = cli.parser_add_main_args(argparse.ArgumentParser())
    built_split = cli.get_splits(cli.load_dataset("", CLI_SAMPLED_DATASET, device="cpu"),
                                 parser.parse_args(argv))[0]
    n_steps = math.ceil(len(built_split["train"]) / 1000)
    forwards = sum(math.ceil(len(built_split[s]) / 1000) for s in ("valid", "test"))
    want = {k: c * n_steps + forwards * FORWARD_LAUNCHES[k] for k, c in STEP_LAUNCHES.items()}
    log(f"cli: sampled run {sampled_s:.2f} s for 1 epoch ({n_steps} steps, {forwards} sweep "
        f"batches); results {logger.results[0]}; launches {counts}")
    if counts != want or not os.path.exists(os.path.join(model_dir, "model.pt")):
        raise AssertionError(f"cli sampled run: launch counts {counts}, expected {want}, or "
                             "no checkpoint")
    results["cli"]["sampled_s"] = sampled_s
    out["sampled"] = counts

    # (e) H2GCN through the CLI's set-up: the step against the plain step,
    # the launches of a step and a forward, then --time_test
    args = parser.parse_args(CLI_H2GCN + ["--epochs", "10"])
    built = cli.build(args)
    trainer = built.trainer
    train_idx = trainer.prepare_train_idx(built.splits[0])
    trainer.init_state(0)
    a1, a2 = trainer.model_kwargs["h2_graphs"]
    log(f"cli: h2gcn on {CLI_SAMPLED_DATASET}: A1 {a1.num_edges} edges, A2 {a2.num_edges} "
        f"edges (the exact 2-hop set), z width {trainer.model.w_classify.shape[0]}")
    check_step("h2gcn", trainer.model, trainer.generator, lambda: trainer.loss(train_idx),
               H2GCN_LOSS_RTOL, H2GCN_GRAD_RTOL, {})
    _, per_step = counted("one h2gcn step", lambda: trainer.train_step(train_idx),
                          H2GCN_STEP_LAUNCHES)
    logits, per_forward = counted("one h2gcn eval_step", trainer.eval_step,
                                  H2GCN_FORWARD_LAUNCHES)
    with plain_versions():
        ref = trainer.eval_step()
    check_logits("h2gcn eval", logits, ref, (trainer.graph.num_nodes, 16),
                 (0.0, H2GCN_LOSS_RTOL))
    del built, trainer, logits, ref
    kernels.reset_launch_counts()
    res = cli.main(CLI_H2GCN + ["--epochs", "20", "--time_test"])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = {k: c * 23 + 2 * H2GCN_FORWARD_LAUNCHES[k] for k, c in H2GCN_STEP_LAUNCHES.items()}
    log(f"cli: h2gcn --time_test: {res.per_epoch_ms:.3f} ms per train step over 20 steps, "
        f"forward {res.forward_ms:.3f} ms, peak memory {res.peak_memory_mb:.1f} MiB on "
        f"{res.device}; launches {counts}")
    if counts != want or not all(np.isfinite(res.losses)):
        raise AssertionError(f"cli h2gcn --time_test: launch counts {counts}, expected {want}")
    results["cli"].update(h2gcn_step_ms=res.per_epoch_ms, h2gcn_forward_ms=res.forward_ms)
    out["h2gcn"], out["h2gcn_step"], out["h2gcn_forward"] = counts, per_step, per_forward
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


def write_zoo_data(root: str) -> None:
    """Seeded data of Cora's and the filtered squirrel's sizes in the
    layouts the port's loaders read: ``cora.npz`` (Planetoid: binary
    bag-of-words features, each undirected edge listed both ways, labels)
    and ``wiki_new/squirrel/squirrel_filtered.npz`` (binary features, its
    directed edges, labels and 10 masks of a 48/32/20 split). Labels are
    uniform; three quarters of the edges join nodes of one class, and each
    class has its own 60 frequent words."""
    import os

    import numpy as np

    def graph(n, e, f, c, rng):
        label = rng.integers(0, c, n)
        src = rng.integers(0, n, e)
        order = np.argsort(label, kind="stable")
        starts = np.searchsorted(label[order], np.arange(c))
        sizes = np.bincount(label, minlength=c)
        pick = order[starts[label[src]] + (rng.random(e) * sizes[label[src]]).astype(np.int64)]
        dst = np.where(rng.random(e) < 0.75, pick, rng.integers(0, n, e))
        words = np.zeros((c, f), dtype=bool)
        for k in range(c):
            words[k, rng.choice(f, 60, replace=False)] = True
        feat = rng.random((n, f)) < np.where(words[label], 0.15, 0.008)
        return label, np.stack([src, dst]), feat.astype(np.float32)

    rng = np.random.default_rng(0)
    cora = ZOO_CORA
    label, pairs, feat = graph(cora["num_nodes"], cora["num_edges"] // 2,
                               cora["num_features"], cora["num_classes"], rng)
    edges = np.concatenate([pairs, pairs[::-1]], axis=1)
    os.makedirs(root, exist_ok=True)
    np.savez(os.path.join(root, "cora.npz"), node_features=feat, edges=edges,
             node_labels=label)
    sq = ZOO_SQUIRREL
    label, edges, feat = graph(sq["num_nodes"], sq["num_edges"], sq["num_features"],
                               sq["num_classes"], rng)
    n = sq["num_nodes"]
    masks = np.zeros((3, 10, n), dtype=bool)
    for i in range(10):
        for j, part in enumerate(np.split(rng.permutation(n), (int(0.48 * n), int(0.8 * n)))):
            masks[j, i, part] = True
    base = os.path.join(root, "wiki_new", "squirrel")
    os.makedirs(base, exist_ok=True)
    np.savez(os.path.join(base, "squirrel_filtered.npz"), node_features=feat, edges=edges,
             node_labels=label, train_masks=masks[0], val_masks=masks[1], test_masks=masks[2])


def zoo_argv(name: str, root: str) -> list:
    """The CLI flags of a zoo run: the recipe's verbatim (the ablation's
    with its kernel for ``$KERNEL``, the squirrel DIFFormer run's) or the
    JAX CLI's defaults with the method, on the files under ``root``, cut by
    ``ZOO_CUT``."""
    flags = ZOO_RUNS[name][0]
    if flags[0] == "ablation.sh":
        argv = [flags[1] if a == "$KERNEL" else a
                for a in recipe_flags("ablation.sh", "$RUN --backbone gcn --dataset cora")]
    elif flags[0] == "medium.sh":
        argv = recipe_flags("medium.sh", "python -m sgformer_tpu_torch.cli.main --trainer full "
                                         "--method difformer")
    else:
        argv = ["--trainer", "full", "--dataset", "cora"] + flags
    return argv + ["--data_dir", root] + ZOO_CUT


def zoo_phase(results: dict, dev: str) -> dict:
    """The attention ablations and the graph-transformer zoo through the
    port's CLI (``cli.main``) on the card: ablation-cli-train, the
    ``recipes/ablation.sh`` flags verbatim for each of simple, softmax, gat
    and performer on Cora's sizes; squirrel-difformer-train,
    ``recipes/medium.sh``'s squirrel DIFFormer run on the filtered
    squirrel's; NodeFormer, GraphGPS, GraphTrans and Graphormer with the JAX
    CLI's defaults on Cora's (no recipe names them). 20 epochs and 1 run of
    each (the recipes' 500 and 5 or 10), width uncut. For each: (a) one
    train step through the kernels against the plain step, same weights and
    dropout masks (and NodeFormer's draws), f32: loss 1e-5, gradients 1e-4;
    (b) the launches of one step and one forward, exact; the eval logits
    against the plain forward's within 1e-5 of the largest, argmax 99 %;
    (c) the run through ``main``: launches (epochs x a step's + evals x a
    forward's), every step's loss (the last 3 below the first), the
    statistics; (d) ``--time_test``: step and forward ms, peak MiB, and a
    profile of one step (device busy). Returns each run's launches."""
    import argparse
    import os
    import shutil

    import numpy as np

    from sgformer_tpu_torch import kernels
    from sgformer_tpu_torch.cli import main as cli
    from sgformer_tpu_torch.train import trainer as trainer_module

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "zoo-data")
    shutil.rmtree(root, ignore_errors=True)
    t = time.perf_counter()
    write_zoo_data(root)
    log(f"zoo: Cora-sized and squirrel-sized files written in {time.perf_counter() - t:.1f} s")
    parser = cli.parser_add_main_args(argparse.ArgumentParser())
    out = {}
    results["zoo"] = {}
    for name, (_, spmm_step, attention_step, scale_of) in ZOO_RUNS.items():
        t_run = time.perf_counter()
        argv = zoo_argv(name, root)
        log(f"zoo {name}: python -m sgformer_tpu_torch.cli.main {' '.join(argv)}")
        step_want = dict(ZERO_LAUNCHES, csr_spmm=spmm_step, **attention_step)
        forward_want = dict(step_want, csr_spmm=spmm_step // 2, linear_attention_bwd_reduce=0,
                            linear_attention_bwd_apply=0)

        # (a), (b) through the CLI's set-up
        t = time.perf_counter()
        built = cli.build(parser.parse_args(argv))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t
        trainer = built.trainer
        n, c = built.ds.num_nodes, built.ds.num_classes
        train_idx = trainer.prepare_train_idx(built.splits[0])
        trainer.init_state(0)
        params = sum(p.numel() for p in trainer.model.parameters())
        log(f"zoo {name}: {type(trainer.model).__name__}, {params} parameters, N = {n}, "
            f"E = {trainer.graph.num_edges}, set-up {setup_s:.2f} s")
        check_step(f"zoo {name}", trainer.model, trainer.generator,
                   lambda: trainer.loss(train_idx), ZOO_LOSS_RTOL, ZOO_GRAD_RTOL, scale_of)
        counted(f"one zoo {name} step", lambda: trainer.train_step(train_idx), step_want)
        logits, _ = counted(f"one zoo {name} eval_step", trainer.eval_step, forward_want)
        with plain_versions():
            ref = trainer.eval_step()
        check_logits(f"zoo {name} eval", logits, ref, (n, c), (0.0, ZOO_LOGITS_RTOL))
        del built, trainer, logits, ref

        # (c) the run through main(), every step's loss recorded
        losses = []
        step = trainer_module.Trainer.train_step

        def recording(self, idx):
            loss = step(self, idx)
            losses.append(loss)
            return loss

        kernels.reset_launch_counts()
        t = time.perf_counter()
        with mock.patch.object(trainer_module.Trainer, "train_step", recording):
            logger = cli.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        counts = kernels.launch_counts()
        evals = len(logger.results[0])
        want = {k: v * ZOO_EPOCHS + evals * forward_want[k] for k, v in step_want.items()}
        losses = torch.stack(losses).tolist()
        stats = logger.statistics()
        log(f"zoo {name}: {run_s:.2f} s for {ZOO_EPOCHS} epochs and {evals} evals (set-up "
            f"included); launches {counts}; losses first {losses[0]:.6f}, last 3 "
            f"{[round(x, 6) for x in losses[-3:]]}; statistics {stats}")
        if counts != want:
            raise AssertionError(f"zoo {name}: launch counts {counts}, expected {want}")
        if len(losses) != ZOO_EPOCHS or not all(np.isfinite(losses)) \
                or not sum(losses[-3:]) / 3 < losses[0]:
            raise AssertionError(f"zoo {name}: the loss did not fall ({losses})")

        # (d) --time_test on the same flags, and a profile of one step
        res = cli.main(argv + ["--time_test"])
        torch.cuda.synchronize()
        log(f"zoo {name} --time_test: {res.per_epoch_ms:.3f} ms per train step over "
            f"{ZOO_EPOCHS} steps, forward {res.forward_ms:.3f} ms, peak memory "
            f"{res.peak_memory_mb:.1f} MiB on {res.device} ({card_line()})")
        built = cli.build(parser.parse_args(argv))
        built.trainer.init_state(0)
        idx = built.trainer.prepare_train_idx(built.splits[0])
        wall, busy = profile_device(f"zoo {name} step", lambda: built.trainer.train_step(idx), 3)
        del built
        results["zoo"][name] = dict(step_ms=res.per_epoch_ms, forward_ms=res.forward_ms,
                                    peak_mib=res.peak_memory_mb, busy_share=busy / wall,
                                    run_s=run_s, setup_s=setup_s, losses=losses,
                                    final_test=stats["final_test"])
        out[name] = counts
        torch.cuda.empty_cache()
        log(f"zoo {name}: {time.perf_counter() - t_run:.1f} s in all")
    shutil.rmtree(root, ignore_errors=True)
    return out


def rows_in_order(x: torch.Tensor, idx: torch.Tensor, chunk: int) -> torch.Tensor:
    """``gather_rows``' sums taken on the host in its kernel's order: each
    group's rows added one at a time in index order, in f32 (numpy);
    [E/chunk, 8, F] on the CPU."""
    import numpy as np

    xf = x.float().cpu().numpy()
    ids = idx.cpu().numpy().reshape(-1, 8, chunk // 8)
    acc = np.zeros((ids.shape[0], 8, xf.shape[1]), np.float32)
    for j in range(ids.shape[2]):
        acc += xf[ids[:, :, j]]
    return torch.from_numpy(acc)


def tiles_in_order(x: torch.Tensor, idx: torch.Tensor, chunk: int) -> torch.Tensor:
    """``gather_tiles``' sums taken on the host in its kernel's order: for
    each column, a group's tiles in index order and rows 0-7 of each tile,
    added one at a time in f32 (numpy); [E/chunk, 8, F] on the CPU."""
    import numpy as np

    f = x.shape[1]
    xf = x.float().cpu().numpy().reshape(-1, 8, f)
    ids = idx.cpu().numpy().reshape(-1, 8, chunk // 8)
    acc = np.zeros((ids.shape[0], 8, f), np.float32)
    for j in range(ids.shape[2]):
        tiles = xf[ids[:, :, j]]  # [E/chunk, 8 groups, 8 rows, F]
        for i in range(8):
            acc += tiles[:, :, i]
    return torch.from_numpy(acc)


def csr_gather_stream(graph, chunk: int, walk: bool) -> tuple[torch.Tensor, int]:
    """The rows ``csr_spmm`` gathers on ``graph``, as ``gather_rows``' ids:
    ``edge_src`` taken row by row in ``Graph.schedule``'s walk order
    (``walk``; node order where the graph has none) or in node order, cut to
    a multiple of ``chunk``; and the number of ids cut."""
    src = graph.edge_src
    if walk and graph.schedule is not None:
        indptr, order = graph.indptr.long(), graph.schedule.long()
        starts = indptr[order]
        counts = indptr[order + 1] - starts
        offsets = torch.repeat_interleave(starts - (torch.cumsum(counts, 0) - counts), counts)
        src = src[torch.arange(src.numel(), device=src.device) + offsets]
    keep = src.numel() // chunk * chunk
    return src[:keep].contiguous(), src.numel() - keep


def check_probe(name: str, kernel, plain, rel_tol: float, digest: str) -> float:
    """One probe kernel's output (``kernel()``) against its plain version
    within ``rel_tol`` of the largest sum, bitwise repeatable, and bitwise
    the output whose sha256 (16 hex digits) is ``digest``: the replaced
    kernel's on the same host-made inputs. Returns max |kernel - plain|."""
    import hashlib

    got = kernel()
    err = check_rel(name, got, plain(), rel_tol)
    if not torch.equal(got, kernel()):
        raise AssertionError(f"{name} is not bitwise repeatable")
    sha = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16]
    if sha != digest:
        raise AssertionError(f"{name}: sha256 {sha}, the replaced kernel's {digest}")
    log(f"{name}: bitwise repeatable and the replaced kernel's output (sha256 {sha})")
    return err


def probe_phase(graph, results: dict, dev: str) -> dict:
    """The timing probes: each kernel at every S of its run against its
    plain version, bitwise repeatable and bitwise the replaced kernel's
    output (``PROBE_DIGESTS``; these launches are not counted), then each
    probe's own run from counts of 0 (dma_gather at every S, dma_tile at S
    = 8 and 32, slab_variants' three modes on the arxiv graph), each gather
    kernel's time beside its design; then K3's case: ``gather_rows`` on the
    rows ``csr_spmm`` gathers on the arxiv graph, in its walk order and in
    node order (``csr_gather_stream``), beside ``csr_spmm`` bf16 at F = 256
    in each order and ``slab_variant``'s no_src_matmul. Returns the run's
    launch counts."""
    from sgformer_tpu_torch import kernels
    from sgformer_tpu_torch.kernels.spmm import csr_spmm
    from sgformer_tpu_torch.microbench import dma_gather, dma_tile, slab_variants

    x, idx = dma_gather.make_inputs(dev)
    err_rows = {s: check_probe(f"gather_rows (S={s})",
                               lambda: dma_gather.gather_rows(x, idx, stages=s),
                               lambda: dma_gather.gather_rows_plain(x, idx),
                               dma_gather.REL_TOL, PROBE_DIGESTS["gather_rows", s])
                for s in dma_gather.STAGES}
    xt, tidx = dma_tile.make_inputs(dev)
    err_tiles = {s: check_probe(f"gather_tiles (S={s})",
                                lambda: dma_tile.gather_tiles(xt, tidx[s], stages=s),
                                lambda: dma_tile.gather_tiles_plain(xt, tidx[s]),
                                dma_tile.REL_TOL, PROBE_DIGESTS["gather_tiles", s])
                 for s in dma_tile.STAGES}
    xs = slab_variants.make_x(graph.num_nodes, dev)
    csr = (graph.indptr, graph.edge_src, graph.edge_dst, graph.gcn_weight)
    err_modes = {}
    for mode in slab_variants.MODES:
        got = slab_variants.slab_variant(xs, *csr, mode)
        err_modes[mode] = check_rel(f"slab_variant {mode}", got, slab_variants.slab_variant_plain(
            xs, graph.edge_src, graph.edge_dst, graph.gcn_weight, mode), slab_variants.REL_TOL)
        if mode == "prod" and not torch.equal(got, csr_spmm(xs.float(), *csr, graph.hub_segments,
                                                            graph.hub_edges)):
            raise AssertionError("slab_variant prod is not bitwise csr_spmm")
        del got
    log("slab_variant prod: bitwise csr_spmm of the same x")
    torch.cuda.empty_cache()

    kernels.reset_launch_counts()
    rows = {s: dma_gather.run(x, idx, stages=s) for s in dma_gather.STAGES}
    tiles = {s: dma_tile.run(xt, tidx[s], stages=s) for s in dma_tile.STAGES}
    modes = slab_variants.run(graph, xs)
    counts = kernels.launch_counts()
    log(f"launches over the probes' runs: {counts}")
    if not all(counts[p] for p in PROBES):
        raise AssertionError(f"a probe kernel was not launched in its run: {counts}")

    rows_design = {s: dma_gather.design(s) for s in rows}
    tiles_design = {s: dma_tile.design(s) for s in tiles}
    for s, r in rows.items():
        log(f"dma_gather S={s}: {r['ms']:.4f} ms for {dma_gather.E} rows, "
            f"{r['mrows_per_s']:.1f} Mrows/s, {r['ns_per_row']:.4f} ns/row, "
            f"{r['gb_per_s']:.1f} GB/s (bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
            f"{r['distinct_rows']} distinct rows; index_select + sums {r['library_ms']:.4f} ms, "
            f"plain {r['plain_ms']:.4f} ms); design: {rows_design[s]}")
    for s, r in tiles.items():
        log(f"dma_tile S={s}: {r['ms']:.4f} ms for {dma_tile.E} tiles, "
            f"{r['mtiles_per_s']:.1f} Mtiles/s, {r['ns_per_tile']:.4f} ns/tile, "
            f"{r['gb_per_s']:.1f} GB/s (bound {r['bound_ms']:.4f} ms by {r['bound_by']}; "
            f"index_select + sums {r['library_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms); "
            f"design: {tiles_design[s]}")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_csr_tensor(graph.indptr, graph.edge_src,
                                    graph.gcn_weight.to(torch.bfloat16),
                                    size=(graph.num_nodes, graph.num_nodes))
    library_ms = library_time("torch.sparse.mm bf16 (slab_variant prod)",
                              lambda: torch.sparse.mm(a, xs))
    spmm_ms = time_ms(lambda: csr_spmm(xs, *csr, graph.hub_segments, graph.hub_edges))
    for mode, r in modes.items():
        log(f"slab_variant {mode}: {r['ms']:.4f} ms, {r['ns_per_edge']:.5f} ns/edge "
            f"(plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']})")
    log(f"slab_variant beside: csr_spmm bf16 {spmm_ms:.4f} ms, torch.sparse.mm {library_ms} ms; "
        f"gather share of prod {1 - modes['no_src_matmul']['ms'] / modes['prod']['ms']:.3f}")

    # K3: the probe on csr_spmm's own gather stream, each order beside
    # csr_spmm bf16 at F = 256 walking in that order
    k3 = {}
    for order, walk in (("walk", True), ("node", False)):
        ids, cut = csr_gather_stream(graph, dma_gather.C, walk)
        ms = time_ms(lambda: dma_gather.gather_rows(xs, ids))
        spmm_order_ms = time_ms(lambda: csr_spmm(xs, *csr, graph.hub_segments, graph.hub_edges,
                                                 schedule=graph.schedule if walk else None))
        rate, gb = ids.numel() / ms / 1e6, ids.numel() * xs.shape[1] * 2 / ms / 1e6
        k3.update({f"k3_{order}_order_ms": ms, f"k3_{order}_order_grows_per_s": rate,
                   f"k3_{order}_order_gb_per_s": gb,
                   f"k3_{order}_order_csr_spmm_ms": spmm_order_ms})
        log(f"K3: gather_rows (S={dma_gather.S}) on csr_spmm's gather stream in {order} order, "
            f"{ids.numel()} rows of the graph's {graph.num_edges} edges ({cut} cut to a multiple "
            f"of C = {dma_gather.C}): {ms:.4f} ms, {rate:.3f} G rows/s, {gb:.1f} GB/s; beside "
            f"csr_spmm bf16 F = {xs.shape[1]} in {order} order {spmm_order_ms:.4f} ms and "
            f"slab_variant no_src_matmul {modes['no_src_matmul']['ms']:.4f} ms (the walk with "
            f"no gathers)")
        del ids

    main_rows, main_tiles = rows[dma_gather.S], tiles[8]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    results["gather_rows"] = dict(
        {k: main_rows[k] for k in keys}, max_abs_err=err_rows[dma_gather.S], stages=dma_gather.S,
        mrows_per_s=main_rows["mrows_per_s"], ns_per_row=main_rows["ns_per_row"],
        gb_per_s=main_rows["gb_per_s"], design=rows_design[dma_gather.S],
        **{f"s{s}_ms": r["ms"] for s, r in rows.items() if s != dma_gather.S},
        **{f"s{s}_max_abs_err": e for s, e in err_rows.items() if s != dma_gather.S}, **k3)
    results["gather_tiles"] = dict(
        {k: main_tiles[k] for k in keys}, max_abs_err=err_tiles[8], stages=8,
        mtiles_per_s=main_tiles["mtiles_per_s"], ns_per_tile=main_tiles["ns_per_tile"],
        gb_per_s=main_tiles["gb_per_s"], design=tiles_design[8], s32_ms=tiles[32]["ms"],
        s32_gb_per_s=tiles[32]["gb_per_s"], s32_max_abs_err=err_tiles[32],
        s32_design=tiles_design[32])
    prod = modes["prod"]
    results["slab_variant"] = dict(
        max_abs_err=err_modes["prod"], ms=prod["ms"], plain_ms=prod["plain_ms"],
        bound_ms=prod["bound_ms"], bound_by=prod["bound_by"], library_ms=library_ms,
        ns_per_edge=prod["ns_per_edge"], csr_spmm_ms=spmm_ms,
        **{f"{m}_{k}": modes[m][k] for m in ("static_sub", "no_src_matmul")
           for k in ("ms", "plain_ms", "bound_ms", "ns_per_edge")})
    del x, idx, xt, tidx, xs, a
    torch.cuda.empty_cache()
    return counts


def sharded_launches(halo: bool) -> tuple[dict, dict]:
    """A rank's launches of one arxiv-sharded-train step and one forward:
    every GraphConv layer's propagate is SHARDED_FORMS[halo] csr_spmm
    forward and as many on the transposes backward; the attention kernels
    once each, as on one card."""
    per = SHARDED_FORMS[halo] * SHARDED_GCN_LAYERS
    return dict(STEP_LAUNCHES, csr_spmm=2 * per), dict(FORWARD_LAUNCHES, csr_spmm=per)


def collectives_by_key(calls) -> dict:
    """``parallel.comm.calls`` as "name axis backend device" -> calls, in
    order; a pair of axes is written "dp*sp"."""
    return dict(sorted(
        (f"{name} {axis if isinstance(axis, str) else '*'.join(axis)} {backend} {dev}", c)
        for (name, axis, backend, dev), c in calls.items()))


def check_collectives(what: str, calls: dict, backend: str) -> None:
    """Every collective of ``calls`` (``collectives_by_key``) ran on the
    group's backend on the card's tensors."""
    wrong = [k for k in calls if k.split()[2:] != [backend, "cuda"]]
    if not calls or wrong:
        raise AssertionError(f"{what}: collectives not on the group's backend and the card: "
                             f"{wrong}")


def sharded_worker(rank: int, backend: str, out_dir: str) -> None:
    """One rank of arxiv-sharded-train (its process spawned by
    ``sharded_phase``, its group joined by ``parallel.launch.run_group``):
    the bench model (dropout 0 for the checks) with ``axis_name="sp"`` behind
    ``ShardedTrainer`` on synth-arxiv after ``preprocess_graph(reorder=True)``,
    with the all-gather and with the halo. For each: the sharded step's loss
    and gradients against the one-device Trainer's on the same weights (rank
    0; bf16 tolerances), bitwise repeatable, the launches of a step and a
    forward, the eval logits against the plain forward, ``time_test`` with
    the losses falling, a profiled step; the one-device Trainer's
    ``time_test`` beside it on the group of one. Writes its numbers to
    ``out_dir/rank{rank}.json``."""
    import numpy as np

    from sgformer_tpu_torch import SGFormer, SGFormerConfig, preprocess_graph
    from sgformer_tpu_torch import kernels
    from sgformer_tpu_torch.data import synthetic_dataset
    from sgformer_tpu_torch.parallel import ShardedTrainer, comm, edge_cut, make_mesh
    from sgformer_tpu_torch.parallel.sharded import average_gradients
    from sgformer_tpu_torch.train import TrainConfig, Trainer, time_test

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh("sp")
    size, what = mesh.size, f"arxiv-sharded-train[{backend} world {mesh.size} rank {rank}]"
    out = {"rank": rank, "backend": mesh.backend, "device": str(mesh.device)}
    comm.calls.clear()
    ds = synthetic_dataset("synth-arxiv", seed=0, device=mesh.device)
    n = ds.num_nodes
    t = time.perf_counter()
    graph = preprocess_graph(ds.graph["edge_index"], n, reorder=True, device=mesh.device)
    out["reorder_preprocess_s"] = time.perf_counter() - t
    plain = preprocess_graph(ds.graph["edge_index"], n, device=mesh.device)
    out["edge_cut"] = {"plain": edge_cut(plain, max(size, 2)),
                       "reordered": edge_cut(graph, max(size, 2))}
    del plain
    split = {"train": np.arange(0, n, 2), "valid": np.arange(1, n, 4),
             "test": np.arange(3, n, 4)}
    tc = TrainConfig(**BENCH_TRAIN)
    checked = dict(BENCH_CONFIG, trans_dropout=0.0, gnn_dropout=0.0)

    def model(axis_name):
        cfg = SGFormerConfig.large(256, 40, axis_name=axis_name, **checked)
        return SGFormer(cfg, ds.graph["node_feat"].shape[1],
                        generator=torch.Generator().manual_seed(0), device=mesh.device)

    def loss_and_grads(tr, idx):
        tr.model.zero_grad(set_to_none=True)
        loss = tr.loss(idx)
        loss.backward()
        if isinstance(tr, ShardedTrainer):
            average_gradients(tr.model, "sp")
        torch.cuda.synchronize()
        return loss.detach(), {k: p.grad.float().clone() for k, p in tr.model.named_parameters()}

    reference = None
    if rank == 0:
        one = Trainer(model(None), graph, ds.graph["node_feat"], ds.label, tc,
                      device=mesh.device)
        one.init_state(0)
        reference = loss_and_grads(one, one.prepare_train_idx(split))
        if size == 1:
            kernels.reset_launch_counts()
            res = time_test(one, split, epochs=TRAIN_EPOCHS, warmup=TRAIN_WARMUP)
            out["one_device_time_test"] = dict(step_ms=res.per_epoch_ms,
                                               forward_ms=res.forward_ms,
                                               peak_mib=res.peak_memory_mb)
        del one
        torch.cuda.empty_cache()
    scale_of = bench_scale_of()
    for halo in (False, True):
        key = "halo" if halo else "allgather"
        r = out[key] = {}
        step_want, forward_want = sharded_launches(halo)
        form = "the send gather, the local and the remote CSR" if halo else "the all-gathered rows"
        log(f"{what} {key}: a step's launches, expected {SHARDED_GCN_LAYERS} GraphConv layers x "
            f"{SHARDED_FORMS[halo]} csr_spmm ({form}) x 2 (forward, backward on the "
            f"transposes) = {step_want['csr_spmm']}, a forward {forward_want['csr_spmm']}; "
            f"each attention kernel once")
        t = time.perf_counter()
        tr = ShardedTrainer(model("sp"), graph, ds.graph["node_feat"], ds.label, tc, mesh=mesh,
                            use_halo=halo)
        r["build_s"] = time.perf_counter() - t
        g = tr.graph
        h = g.halo_rows
        r.update(block=g.num_nodes, halo_rows=h,
                 edges=g.gcn.num_edges if not halo else (g.halo.local.num_edges
                                                         + g.halo.remote.num_edges))
        # the rows a rank exchanges per GraphConv layer and pass, bf16 width 256
        r["exchange_mib"] = (size * (h if halo else g.num_nodes) * 256 * 2) / 2 ** 20
        tr.init_state(0)
        idx = tr.prepare_train_idx(split)
        loss, grads = loss_and_grads(tr, idx)
        loss2, grads2 = loss_and_grads(tr, idx)
        if not (torch.equal(loss, loss2) and all(torch.equal(grads[k], grads2[k])
                                                 for k in grads)):
            raise AssertionError(f"{what} {key}: the sharded step does not repeat bit for bit")
        if reference is not None:
            loss_t, grads_t = reference
            rel = abs(loss.item() - loss_t.item()) / abs(loss_t.item())
            worst = max((((grads[k] - gt).norm() / grads_t[scale_of.get(k, k)].norm()).item(), k)
                        for k, gt in grads_t.items())
            log(f"{what} {key}: step loss {loss.item():.7f} against the one-device Trainer's "
                f"{loss_t.item():.7f} ({rel:.2e}, tolerance {TRAIN_LOSS_RTOL}); largest "
                f"|g_sharded - g| / |g| {worst[0]:.3e} ({worst[1]}, tolerance "
                f"{TRAIN_GRAD_RTOL}); bitwise repeatable")
            if not (rel <= TRAIN_LOSS_RTOL and worst[0] <= TRAIN_GRAD_RTOL):
                raise AssertionError(f"{what} {key}: the sharded step disagrees with Trainer's")
            r.update(loss_rel=rel, grad_rel=worst[0])
        del grads, grads2
        _, r["step_launches"] = counted(f"one {what} {key} step", lambda: tr.train_step(idx),
                                        step_want)
        logits, r["forward_launches"] = counted(f"one {what} {key} eval_step", tr.eval_step,
                                                forward_want)
        with plain_versions():
            ref = tr.eval_step()
        check_logits(f"{what} {key} eval", logits, ref, (n, 40), (LOGITS_ATOL, 0.0))
        del logits, ref
        kernels.reset_launch_counts()
        res = time_test(tr, split, epochs=TRAIN_EPOCHS, warmup=TRAIN_WARMUP)
        r["run_launches"] = kernels.launch_counts()
        steps = TRAIN_EPOCHS + TRAIN_WARMUP
        want = {k: c * steps + 2 * forward_want[k] for k, c in step_want.items()}
        if r["run_launches"] != want:
            raise AssertionError(f"{what} {key} time_test launches {r['run_launches']}, "
                                 f"expected {want}")
        losses = res.losses
        if not all(np.isfinite(losses)) or not sum(losses[-3:]) / 3 < losses[0]:
            raise AssertionError(f"{what} {key}: the loss did not fall ({losses})")
        r.update(step_ms=res.per_epoch_ms, forward_ms=res.forward_ms,
                 peak_mib=res.peak_memory_mb, losses=[losses[0]] + losses[-3:])
        log(f"{what} {key} time_test: {res.per_epoch_ms:.3f} ms a step over {TRAIN_EPOCHS} "
            f"steps, forward {res.forward_ms:.3f} ms, peak {res.peak_memory_mb:.1f} MiB; "
            f"losses first {losses[0]:.6f}, last 3 {[round(x, 6) for x in losses[-3:]]}")
        r["profile_wall_ms"], r["profile_busy_ms"] = profile_device(
            f"{what} {key} step", lambda: tr.train_step(idx), 3)
        del tr
        torch.cuda.empty_cache()
    out["collectives"] = collectives_by_key(comm.calls)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def sharded_phase(ds, results: dict) -> dict:
    """arxiv-sharded-train: ``sharded_worker`` in a spawned group of one
    rank on NCCL and in one of two ranks sharing the card under gloo (NCCL
    refuses two ranks on one card); then the CLI's ogbn-arxiv recipe with
    ``--trainer sharded --use_halo`` in this process (a group of one on
    NCCL): exact launches, falling losses; then ``parallel.scaling
    --devices 1``. No scaling number: one card. Returns each run's launch
    counts."""
    import math
    import shutil
    import tempfile

    import numpy as np

    from sgformer_tpu_torch import kernels
    from sgformer_tpu_torch.cli import main as cli
    from sgformer_tpu_torch.parallel import sharded
    from sgformer_tpu_torch.parallel.launch import run_group

    out = {}
    for backend, size in SHARDED_RUNS:
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            run_group(sharded_worker, size, backend, d, device="cuda", backend=backend)
            per_rank = []
            for r in range(size):
                with open(os.path.join(d, f"rank{r}.json")) as f:
                    per_rank.append(json.load(f))
        wall = time.perf_counter() - t
        name = f"{backend}{size}"
        r0 = per_rank[0]
        log(f"arxiv-sharded-train {backend} world {size}: {wall:.1f} s wall (spawn, data, "
            f"graphs, checks); preprocess_graph(reorder=True) {r0['reorder_preprocess_s']:.2f} "
            f"s on the host and card; edge cut at 2 shards {r0['edge_cut']['plain']:,} edges "
            f"without the reorder, {r0['edge_cut']['reordered']:,} with it")
        for key in ("allgather", "halo"):
            for pr in per_rank:
                r = pr[key]
                log(f"arxiv-sharded-train {backend} world {size} rank {pr['rank']} {key}: "
                    f"B = {r['block']}, H = {r['halo_rows']}, {r['edges']:,} edges, "
                    f"{r['exchange_mib']:.2f} MiB exchanged a layer and pass (bf16, 256 wide), "
                    f"step {r['step_ms']:.3f} ms, forward {r['forward_ms']:.3f} ms, peak "
                    f"{r['peak_mib']:.1f} MiB, shard build {r['build_s']:.2f} s")
        for pr in per_rank:
            calls = pr["collectives"]
            log(f"arxiv-sharded-train {backend} world {size} rank {pr['rank']}: collectives "
                f"this run (name, axis, backend, tensor device: calls) {calls}")
            check_collectives(f"arxiv-sharded-train {backend} world {size}", calls, backend)
        if size > 1:
            log(f"arxiv-sharded-train gloo world {size}: each of those ran under gloo on the "
                f"card's tensors (torch {torch.__version__}); the package stages no buffer "
                f"through the host, and a collective gloo refused would have raised")
        one = r0.get("one_device_time_test")
        if one:
            log(f"arxiv-sharded-train beside the one-device Trainer (same graph, same "
                f"model): {one['step_ms']:.3f} ms a step, forward {one['forward_ms']:.3f} ms, "
                f"peak {one['peak_mib']:.1f} MiB")
        results[("sharded", name)] = per_rank
        out[name] = per_rank

    # the CLI: the ogbn-arxiv recipe with --trainer sharded --use_halo
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "cli-data")
    shutil.rmtree(root, ignore_errors=True)
    write_ogb_arxiv(ds, root)
    flags = recipe_flags("large.sh", "$RUN --trainer full --dataset ogbn-arxiv")
    at = flags.index("--trainer")
    argv = (flags[:at] + ["--trainer", "sharded", "--use_halo"] + flags[at + 2:]
            + ["--data_dir", root, "--runs", "1", "--epochs", str(SHARDED_CLI_EPOCHS),
               "--eval_step", "9"])
    log(f"cli: python -m sgformer_tpu_torch.cli.main {' '.join(argv)}")
    losses = []
    step = sharded.ShardedTrainer.train_step

    def recording(self, mask):
        loss = step(self, mask)
        losses.append(loss)
        return loss

    kernels.reset_launch_counts()
    t = time.perf_counter()
    with mock.patch.object(sharded.ShardedTrainer, "train_step", recording):
        logger = cli.main(argv)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    counts = kernels.launch_counts()
    step_want, forward_want = sharded_launches(True)
    evals = len(logger.results[0])
    want = {k: c * SHARDED_CLI_EPOCHS + evals * forward_want[k] for k, c in step_want.items()}
    losses = torch.stack(losses).tolist()
    log(f"cli: sharded halo recipe (world 1, NCCL): {run_s:.2f} s for {SHARDED_CLI_EPOCHS} "
        f"epochs and {evals} evals; launches {counts}; losses first {losses[0]:.6f}, last 3 "
        f"{[round(x, 6) for x in losses[-3:]]}; statistics {logger.statistics()}")
    if evals != math.ceil(SHARDED_CLI_EPOCHS / 9) or counts != want:
        raise AssertionError(f"cli sharded recipe: launch counts {counts}, expected {want}")
    if len(losses) != SHARDED_CLI_EPOCHS or not all(np.isfinite(losses)) \
            or not sum(losses[-3:]) / 3 < losses[0]:
        raise AssertionError("the cli sharded recipe's loss did not fall")
    out["cli"] = counts
    results["sharded_cli_s"] = run_s
    shutil.rmtree(root, ignore_errors=True)
    torch.distributed.destroy_process_group()  # the CLI's group of one

    # the scaling harness at the one count one card can measure
    cmd = [sys.executable, "-m", "sgformer_tpu_torch.parallel.scaling", "--devices", "1",
           "--halo", "--reorder"]
    t = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[1:])} failed:\n{proc.stderr[-4000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f"{' '.join(cmd[2:])}: {line} in {time.perf_counter() - t:.1f} s ({card_line()}; one "
        f"card: no scaling efficiency)")
    if set(line) != {"devices", "step_ms", "edges_per_sec", "edges_per_sec_per_device"}:
        raise AssertionError(f"scaling harness printed {line}")
    results["scaling"] = line
    torch.cuda.empty_cache()
    return out


def state_digest(model) -> str:
    """sha256 of every parameter's and buffer's bytes, in state-dict order."""
    import hashlib

    h = hashlib.sha256()
    for t in model.state_dict().values():
        h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def dp_tail(rank: int, mesh, what: str) -> dict:
    """The tail at small width: ``DPBatchTrainer`` (f32, hidden 16, dropout
    0) on ``DP_TAIL``'s graph in batches of ``DP_TAIL_BATCH`` for 6 epochs;
    then, every node a train node, a full step's and the remainder step's
    loss and gradients through the kernels against the plain versions (f32
    tolerances; the remainder's groups hold 1 and 0 real nodes, so its
    gradients are held as one vector: ``check_step``'s ``whole``), the
    remainder step's launches against a full step's (the same kernels), and
    every state finite."""
    import numpy as np

    from sgformer_tpu_torch import SGFormer, SGFormerConfig, kernels, preprocess_graph
    from sgformer_tpu_torch.data import synthetic_dataset
    from sgformer_tpu_torch.parallel import DPBatchTrainer
    from sgformer_tpu_torch.parallel.sharded import average_gradients, sharded_loss
    from sgformer_tpu_torch.train import BatchTrainConfig

    ds = synthetic_dataset(**DP_TAIL, device=mesh.device)
    n = ds.num_nodes
    graph = preprocess_graph(ds.graph["edge_index"], n, device=mesh.device)
    edges = torch.stack([graph.edge_src, graph.edge_dst])
    cfg = SGFormerConfig(16, DP_TAIL["num_classes"], gnn="graphconv", axis_name="sp",
                         trans_dropout=0.0, gnn_dropout=0.0)
    tr = DPBatchTrainer(SGFormer(cfg, DP_TAIL["num_features"], device=mesh.device), edges,
                        ds.graph["node_feat"], ds.label,
                        BatchTrainConfig(lr=0.02, epochs=6, eval_step=5,
                                         batch_size=DP_TAIL_BATCH, display_step=-1), mesh=mesh)
    split = ds.get_idx_split(rng=np.random.default_rng(0))
    tr.record_losses = True
    logger = tr.fit([split])
    perm = torch.from_numpy(np.random.default_rng(1).permutation(n)).to(mesh.device)
    every = torch.ones(n, dtype=torch.bool, device=mesh.device)
    steps = tr.num_batches()
    full = tr.build_batch(tr.batch_nodes(perm, 0), every)
    tail = tr.build_batch(tr.batch_nodes(perm, steps - 1), every)
    rel = {}
    for key, batch in (("full", full), ("remainder", tail)):
        rel[key] = check_step(
            f"{what} tail {key} step ({batch.group_nodes} real nodes in this rank's group)",
            tr.model, tr.generator,
            lambda: sharded_loss(tr.model, batch.x, batch.graph, batch.label, batch.node_mask,
                                 batch.train_mask, mesh.axis_names),
            BATCH_LOSS_RTOL, BATCH_GRAD_RTOL, bench_scale_of(cfg.gnn_num_layers),
            lambda: average_gradients(tr.model, mesh.axis_names), whole=key == "remainder")[2:]
    kernels.reset_launch_counts()
    tr.train_step(full)
    torch.cuda.synchronize()
    full_launches = kernels.launch_counts()
    _, tail_launches = counted(f"{what} tail: the remainder step ({tail.group_nodes} real "
                               f"nodes in this rank's group), as a full step's",
                               lambda: tr.train_step(tail), full_launches)
    finite = (all(bool(torch.isfinite(v).all()) for v in tr.model.state_dict().values())
              and bool(np.isfinite(tr.train_losses).all()))
    if not finite or not all(full_launches[k] for k in BATCH_KERNELS):
        raise AssertionError(f"{what} tail: state finite {finite}, launches {full_launches}")
    return dict(steps=steps, group_nodes=tail.group_nodes, launches=tail_launches,
                plain_rel=rel, results=logger.results[0],
                final_test=logger.run_summary(0)["final_test"])


def dp_batch_worker(rank: int, backend: str, dp: int, out_dir: str) -> None:
    """One rank of arxiv-dp-batch-train (spawned by ``dp_batch_phase``): the
    bench model (dropout 0 for the checks) with ``axis_name="sp"`` behind
    ``DPBatchTrainer`` on synth-arxiv's batch-tier edge list in batches of
    ``ARXIV_BATCH``, on a (dp, world / dp) grid. Every rank holds the first
    step's loss and gradients through the kernels (this rank's rectangular,
    padded shard, the sums all-reduced over sp) against the same step
    through the plain versions, every rank joining both; rank 0 holds them
    against the mean over every group's batch through the one-device model
    (with dp = 1, ``BatchTrainer``'s loss on that batch); bf16 tolerances.
    Each rank: the launches of a step and of an eval batch's forward (the
    unsharded twin), that forward's logits against the plain forward's, its
    state's digest after the step, step and forward ms (3 warm-up steps, ``TRAIN_EPOCHS`` timed
    on the host clock to a synchronize) and peak MiB, an epoch's wall time
    (every step's build, the remainder step's included), ``fit`` for one
    epoch (its launches, losses and accuracies), each collective it ran,
    and with dp > 1 the tail at small width (``dp_tail``). Writes its
    numbers to ``out_dir/rank{rank}.json``."""
    import numpy as np

    from sgformer_tpu_torch import SGFormer, SGFormerConfig, kernels, preprocess_graph
    from sgformer_tpu_torch.data import synthetic_dataset
    from sgformer_tpu_torch.parallel import DPBatchTrainer, comm, make_global_mesh
    from sgformer_tpu_torch.parallel.sharded import average_gradients, sharded_loss
    from sgformer_tpu_torch.train import BatchTrainConfig, BatchTrainer, build_subgraph_batch
    from sgformer_tpu_torch.train.trainer import nll_per_node

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_global_mesh(dp)
    world, sp = mesh[mesh.axis_names].size, mesh.shape["sp"]
    what = f"arxiv-dp-batch-train[{backend} dp {dp} x sp {sp} rank {rank}]"
    dev, b = mesh.device, ARXIV_BATCH
    out = {"rank": rank, "coords": list(mesh.coords)}
    comm.calls.clear()
    ds = synthetic_dataset("synth-arxiv", seed=0, device=dev)
    n = ds.num_nodes
    graph = preprocess_graph(ds.graph["edge_index"], n, device=dev)
    edges = torch.stack([graph.edge_src, graph.edge_dst])
    del graph
    split = {"train": np.arange(0, n, 2), "valid": np.arange(1, n, 4),
             "test": np.arange(3, n, 4)}
    tc = BatchTrainConfig(**BENCH_TRAIN, epochs=1, batch_size=b, display_step=-1)
    checked = dict(BENCH_CONFIG, trans_dropout=0.0, gnn_dropout=0.0)

    def model(axis_name):
        cfg = SGFormerConfig.large(256, 40, axis_name=axis_name, **checked)
        return SGFormer(cfg, ds.graph["node_feat"].shape[1],
                        generator=torch.Generator().manual_seed(0), device=dev)

    tr = DPBatchTrainer(model("sp"), edges, ds.graph["node_feat"], ds.label, tc, mesh=mesh)
    tr.init_state(0)
    train_set = torch.zeros(n, dtype=torch.bool, device=dev)
    train_set[torch.from_numpy(split["train"]).to(dev)] = True
    perm = torch.from_numpy(np.random.default_rng(0).permutation(n)).to(dev)
    batch = tr.build_batch(tr.batch_nodes(perm, 0), train_set)
    out.update(block=batch.graph.num_nodes, edges=batch.graph.gcn.num_edges,
               group_nodes=batch.group_nodes)

    # (a) the dp step's loss and gradients against the plain step's, then
    # against the one-device mean
    scale_of = bench_scale_of()
    loss, grads, out["plain_loss_rel"], out["plain_grad_rel"] = check_step(
        what, tr.model, tr.generator,
        lambda: sharded_loss(tr.model, batch.x, batch.graph, batch.label, batch.node_mask,
                             batch.train_mask, mesh.axis_names),
        TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, scale_of,
        lambda: average_gradients(tr.model, mesh.axis_names))
    if rank == 0:
        one = BatchTrainer(model(None), edges, ds.graph["node_feat"], ds.label, tc, device=dev)
        one.init_state(0)
        one.model.train()
        total = count = 0.0
        for g in range(dp):
            bg = one.build_batch(perm[g * b:(g + 1) * b], train_set)
            per = nll_per_node(one.model(bg.x, bg.graph), bg.label)
            total, count = total + (per * bg.train_mask).sum(), count + bg.train_mask.sum()
        ref = total / count
        ref.backward()
        want = {k: p.grad.float() for k, p in one.model.named_parameters()}
        rel = abs(loss - ref.item()) / abs(ref.item())
        worst = max((((grads[k] - g).norm() / want[scale_of.get(k, k)].norm()).item(), k)
                    for k, g in want.items())
        log(f"{what}: step loss {loss:.7f} against the one-device mean over the {dp} "
            f"group batches {ref.item():.7f} ({rel:.2e}, tolerance {TRAIN_LOSS_RTOL}); largest "
            f"|g_dp - g| / |g| {worst[0]:.3e} ({worst[1]}, tolerance {TRAIN_GRAD_RTOL})")
        if not (rel <= TRAIN_LOSS_RTOL and worst[0] <= TRAIN_GRAD_RTOL):
            raise AssertionError(f"{what}: the dp step disagrees with the one-device mean")
        out.update(loss_rel=rel, grad_rel=worst[0])
        del one, want, ref
    del grads
    torch.cuda.empty_cache()

    # (b) the launches of a step and of an eval batch's forward; the state
    # after the step
    tr.init_state(0)
    _, out["step_launches"] = counted(f"one {what} step", lambda: tr.train_step(batch),
                                      STEP_LAUNCHES)
    out["state_digest"] = state_digest(tr.model)
    tr.twin.load_state_dict(tr.model.state_dict())
    tr.twin.eval()
    bidx = torch.from_numpy(split["valid"][:b]).to(dev)
    graph_e = build_subgraph_batch(tr.edge_index, bidx, n)

    def forward():
        with torch.no_grad():
            return tr.twin(tr.x[bidx], graph_e)

    logits, out["forward_launches"] = counted(f"one {what} eval batch forward", forward,
                                              FORWARD_LAUNCHES)
    with plain_versions():
        ref = forward()
    check_logits(f"{what} eval batch", logits, ref, (bidx.numel(), 40), (LOGITS_ATOL, 0.0))
    del logits, ref

    # (c) step and forward ms, peak memory
    for _ in range(TRAIN_WARMUP):
        tr.train_step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    for _ in range(TRAIN_EPOCHS):
        tr.train_step(batch)
    torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t) * 1e3 / TRAIN_EPOCHS
    forward()
    torch.cuda.synchronize()
    t = time.perf_counter()
    forward()
    torch.cuda.synchronize()
    out["forward_ms"] = (time.perf_counter() - t) * 1e3
    out["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20

    # (d) an epoch's wall time: every step's build and step, the remainder's
    # included
    perm = torch.from_numpy(np.random.default_rng(1).permutation(n)).to(dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(tr.num_batches()):
        tr.train_step(tr.build_batch(tr.batch_nodes(perm, i), train_set))
    torch.cuda.synchronize()
    out.update(epoch_s=time.perf_counter() - t, steps=tr.num_batches())
    del batch, graph_e
    torch.cuda.empty_cache()

    # (e) fit: one epoch and its eval, from parameters drawn anew
    tr.record_losses = True
    evals = len(range(rank, sum(-(-len(v) // b) for v in split.values()), world))
    want = {k: c * tr.num_batches() + evals * FORWARD_LAUNCHES[k]
            for k, c in STEP_LAUNCHES.items()}
    t = time.perf_counter()
    logger, out["fit_launches"] = counted(f"{what} fit ({tr.num_batches()} steps, {evals} eval "
                                          f"batches on this rank)", lambda: tr.fit([split]),
                                          want)
    out["fit_s"] = time.perf_counter() - t
    losses = tr.train_losses
    if (len(losses) != tr.num_batches() or not np.isfinite(losses).all()
            or not all(bool(torch.isfinite(v).all()) for v in tr.final_state.values())):
        raise AssertionError(f"{what} fit: losses {losses}, or a state not finite")
    out.update(losses=losses, results=logger.results[0])
    del tr
    torch.cuda.empty_cache()
    if dp > 1:
        out["tail"] = dp_tail(rank, mesh, what)
    out["collectives"] = collectives_by_key(comm.calls)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def dp_batch_phase(results: dict) -> dict:
    """arxiv-dp-batch-train: ``dp_batch_worker`` in a spawned group of one
    rank on NCCL (dp = sp = 1) and in one of four ranks sharing the card
    under gloo (dp = 2 x sp = 2); every rank's state after the step and its
    logged accuracies must equal rank 0's, and every collective must have
    run on the group's backend on the card's tensors. Returns each run's
    per-rank numbers."""
    import tempfile

    from sgformer_tpu_torch.parallel.launch import run_group

    out = {}
    for backend, dp, sp in DP_RUNS:
        world, name = dp * sp, f"{backend}{dp}x{sp}"
        what = f"arxiv-dp-batch-train {backend} dp {dp} x sp {sp}"
        t = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            run_group(dp_batch_worker, world, backend, dp, d, device="cuda", backend=backend)
            per_rank = []
            for r in range(world):
                with open(os.path.join(d, f"rank{r}.json")) as f:
                    per_rank.append(json.load(f))
        wall = time.perf_counter() - t
        transport = (" (gloo's host transport on one card, not a multi-card group's)"
                     if backend == "gloo" else "")
        log(f"{what}: {wall:.1f} s wall (spawn, data, checks); {card_line()}")
        for pr in per_rank:
            log(f"{what} rank {pr['rank']} at {tuple(pr['coords'])}: {pr['block']} rows a "
                f"shard, {pr['edges']:,} edges, its group {pr['group_nodes']:,} real nodes; "
                f"step {pr['step_ms']:.3f} ms, eval batch forward {pr['forward_ms']:.3f} ms, "
                f"peak {pr['peak_mib']:.1f} MiB; an epoch of {pr['steps']} steps (the "
                f"remainder's included, each batch built on the card) {pr['epoch_s']:.3f} s; "
                f"fit (one epoch and its eval) {pr['fit_s']:.3f} s{transport}")
            log(f"{what} rank {pr['rank']}: first step through the kernels against the plain "
                f"versions: loss {pr['plain_loss_rel']:.2e}, largest |g - g_plain| / |g_plain| "
                f"{pr['plain_grad_rel']:.3e} (tolerances {TRAIN_LOSS_RTOL}, {TRAIN_GRAD_RTOL}); "
                f"losses {[round(x, 6) for x in pr['losses']]}, accuracies {pr['results']}")
            log(f"{what} rank {pr['rank']}: collectives this run (name, axis, backend, tensor "
                f"device: calls) {pr['collectives']}")
            check_collectives(what, pr["collectives"], backend)
            if "tail" in pr:
                tl = pr["tail"]
                log(f"{what} rank {pr['rank']} tail (n {DP_TAIL['num_nodes']}, B "
                    f"{DP_TAIL_BATCH}, hidden 16, f32): {tl['steps']} steps an epoch, the "
                    f"remainder step's group {tl['group_nodes']} real nodes, its launches "
                    f"{tl['launches']}; against the plain versions (loss, gradients; "
                    f"tolerances {BATCH_LOSS_RTOL}, {BATCH_GRAD_RTOL}) full step "
                    f"{tl['plain_rel']['full']}, remainder step {tl['plain_rel']['remainder']}; "
                    f"accuracies {tl['results']}, final test {tl['final_test']:.4f}; "
                    f"state finite")
        r0 = per_rank[0]
        for pr in per_rank[1:]:
            if pr["state_digest"] != r0["state_digest"] or pr["results"] != r0["results"]:
                raise AssertionError(f"{what}: rank {pr['rank']}'s state after the step or its "
                                     f"accuracies differ from rank 0's")
            if "tail" in pr and pr["tail"]["results"] != r0["tail"]["results"]:
                raise AssertionError(f"{what}: rank {pr['rank']}'s tail accuracies differ")
        if dp > 1 and sorted(pr["tail"]["group_nodes"] for pr in per_rank) != [0, 0, 1, 1]:
            raise AssertionError(f"{what}: the tail's remainder groups are not 1 and 0 nodes")
        log(f"{what}: every rank's parameters and BatchNorm statistics after the step bitwise "
            f"rank 0's (sha256 {r0['state_digest'][:16]}), the logged accuracies equal")
        results[("dp", name)] = per_rank
        out[name] = per_rank
    torch.cuda.empty_cache()
    return out


def device_us(event) -> float:
    """A profiler event's own device time in us (the attribute's name
    differs between PyTorch versions)."""
    us = getattr(event, "self_device_time_total", None)
    return getattr(event, "self_cuda_time_total", 0) if us is None else us


def profile_device(what: str, fn, reps: int) -> tuple[float, float]:
    """Device time per kernel over a few calls of ``fn``, and the device's
    busy share of its wall time (torch.profiler, CUPTI). Returns (wall ms,
    device-busy ms) a call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / reps
    rows = []
    for e in prof.key_averages():
        # a user annotation's range on the device (Optimizer.step#Adam.step)
        # spans kernels that are counted on their own
        if ("CUDA" not in str(getattr(e, "device_type", ""))
                or getattr(e, "is_user_annotation", False)):
            continue
        us = device_us(e)
        if us > 0:
            rows.append((us / reps / 1e3, e.count / reps, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"profile: {what} {wall:.3f} ms wall, device busy {busy:.3f} ms "
        f"({busy / wall:.1%}) over {reps} calls")
    for ms, cnt, key in rows[:20]:
        log(f"  {ms:8.4f} ms x{cnt:g}  {key[:100]}")
    groups: dict = {}
    for ms, cnt, key in rows:
        group = next((g for g, marks in PROFILE_GROUPS if any(m in key for m in marks)),
                     "other elementwise")
        total, launches = groups.get(group, (0.0, 0.0))
        groups[group] = (total + ms, launches + cnt)
    log(f"profile: {what} by group: " + "; ".join(
        f"{g} {ms:.3f} ms x{cnt:g}" for g, (ms, cnt) in
        sorted(groups.items(), key=lambda kv: -kv[1][0])))
    return wall, busy


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
    from sgformer_tpu_torch.graph import gcn_norm_rs, walk_order
    from sgformer_tpu_torch.kernels import _build, ops
    from sgformer_tpu_torch.kernels.spmm import ROW_WALK, walk_design
    from sgformer_tpu_torch.native import build as native_build

    t = time.perf_counter()
    reports = _build.build_all()
    log(f"kernel build: {time.perf_counter() - t:.1f} s")
    # the sampled tier's host sampler (g++), built before anything times it
    t = time.perf_counter()
    native_build.library()
    log(f"host sampler build (g++): {time.perf_counter() - t:.1f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    t = time.perf_counter()
    ds = synthetic_dataset("synth-arxiv", seed=0)
    data_s = time.perf_counter() - t
    # bf16 messages for GAT's aggregation; the fixed-weight SpMM keeps x's type
    graph = preprocess_graph(ds.graph["edge_index"], ds.num_nodes, chunk_dtype="bf16")
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t - data_s
    t = time.perf_counter()
    walk_order(torch.stack([graph.edge_src, graph.edge_dst]), graph.num_nodes)
    log(f"dataset {data_s:.2f} s + preprocess_graph {prep_s:.2f} s (N = {graph.num_nodes}, "
        f"E = {graph.num_edges}); its walk order (the clustering, on the host) alone "
        f"{time.perf_counter() - t:.2f} s")
    if (graph.num_nodes, graph.num_edges) != (169_343, 2_499_039):
        raise AssertionError("unexpected arxiv-shape graph size")
    if graph.schedule is None or graph.walk_orders[1] is not graph.schedule:
        raise AssertionError("the arxiv graph has no walk order for its CSR kernels")

    results: dict = {}
    spmm_phase(graph, results, "cuda")
    attention_phase(graph.num_nodes, results, "cuda")
    attention_bwd_phase(graph.num_nodes, results, "cuda")
    serve_counts, forwards = serve_phase(ds, graph, "cuda")
    exported_forward = serve_export_phase(ds, graph, results, "cuda")
    step_counts, _, train_counts, _ = train_phase(ds, graph, "cuda")
    arxiv_batch = arxiv_batch_phase(ds, graph, results, "cuda")
    edge_value_phase(graph, results, "cuda")
    width_sweep(graph, results, "cuda", "arxiv", SWEEP_WIDTHS, SWEEP_EV_SHAPES)

    t = time.perf_counter()
    pl = synthetic_dataset(**POWERLAW_GRAPH)
    pl_graph = preprocess_graph(pl.graph["edge_index"], pl.num_nodes)
    deg = torch.diff(pl_graph.indptr)
    log(f"power-law graph: {time.perf_counter() - t:.1f} s (N = {pl_graph.num_nodes}, "
        f"E = {pl_graph.num_edges}, in-degree max {deg.max().item()}, "
        f"mean {deg.float().mean().item():.1f})")
    if pl_graph.schedule is None:
        raise AssertionError("the power-law graph has no walk order for its CSR kernels")
    spmm_phase(pl_graph, results, "cuda", key="csr_spmm_powerlaw", sweep=True)
    width_sweep(pl_graph, results, "cuda", "powerlaw", SWEEP_POWERLAW_WIDTHS)
    # the int8 kernel alone on the same graph, with and without its hub plan
    rs = gcn_norm_rs(pl_graph.edge_dst, pl_graph.num_nodes)
    q8_phase(dataclasses.replace(pl_graph, rs=rs), results, "cuda",
             key="csr_spmm_q8_powerlaw", dtypes=(torch.bfloat16,), no_plan=True)
    pl_step, _, pl_counts, _ = powerlaw_train_phase(pl, pl_graph, "cuda")
    # GAT's backward kernels alone on the same graph, with and without the
    # hub plans; then powerlaw-gat-train, GAT there with bf16 messages
    powerlaw_edge_value_phase(pl_graph, results, "cuda")
    sddmm_launches = sddmm_run(pl_graph, "cuda")
    plg_step, _, plg_counts, _ = gat_train_phase(
        pl, dataclasses.replace(pl_graph, chunk_dtype="bf16"), "cuda", "powerlaw-gat")
    del pl, pl_graph, deg
    torch.cuda.empty_cache()

    gat_step, gat_forward, gat_counts, _ = gat_train_phase(ds, graph, "cuda")

    graph_q8 = preprocess_graph(ds.graph["edge_index"], ds.num_nodes, chunk_dtype="bf16",
                                slab_dtype="int8")
    q8_phase(graph_q8, results, "cuda")
    del graph_q8
    q8_step, q8_forward, q8_counts = q8_train_phase(results, "cuda")
    amazon2m_batch = amazon2m_batch_phase(results, "cuda")
    papers = papers_sampled_phase(results, "cuda")
    cli_counts = cli_phase(ds, results, "cuda")
    zoo_counts = zoo_phase(results, "cuda")
    sharded_counts = sharded_phase(ds, results)
    dp_counts = dp_batch_phase(results)
    probe_counts = probe_phase(graph, results, "cuda")
    probe = results["gather_rows"]
    for key in ("csr_spmm_q8_large400k", "csr_spmm_q8", "csr_spmm_q8_powerlaw"):
        r = results[(key, "bf16")]
        log(f"{key} bf16 gather rate: {r['grows_per_s']:.3f} G rows/s of 256 bytes, "
            f"{r['gather_gb_per_s']:.1f} GB/s, against the gather_rows probe's "
            f"{probe['mrows_per_s'] / 1e3:.3f} G rows/s, {probe['gb_per_s']:.1f} GB/s")
    for key in ("csr_spmm_ev_bwd", "csr_spmm_ev_bwd_powerlaw"):
        for layer, (heads, d) in enumerate(GAT_LAYERS):
            r = results[(key, "bf16", layer)]
            log(f"{key} H={heads} D={d} gather rate: {r['grows_per_s']:.3f} G rows/s of {4 * d} "
                f"bytes, {r['gather_gb_per_s']:.1f} GB/s, against the gather_rows probe's "
                f"{probe['mrows_per_s'] / 1e3:.3f} G rows/s of 512 bytes, "
                f"{probe['gb_per_s']:.1f} GB/s")

    via = "sgformer_tpu/kernels/spmm.py:34 via :253"
    sources = {
        "csr_spmm": ("sgformer_tpu_torch/csrc/spmm.cu",
                     "sgformer_tpu/kernels/slab_spmm.py:131, sgformer_tpu/kernels/slab_spmm.py:34, "
                     "sgformer_tpu/kernels/spmm.py:34"),
        "linear_attention_reduce": ("sgformer_tpu_torch/csrc/linear_attention.cu",
                                    "sgformer_tpu/kernels/attention.py:47"),
        "linear_attention_apply": ("sgformer_tpu_torch/csrc/linear_attention.cu",
                                   "sgformer_tpu/kernels/attention.py:76"),
        "linear_attention_bwd_reduce": ("sgformer_tpu_torch/csrc/linear_attention_bwd.cu",
                                        "sgformer_tpu/kernels/attention.py:162"),
        "linear_attention_bwd_apply": ("sgformer_tpu_torch/csrc/linear_attention_bwd.cu",
                                       "sgformer_tpu/kernels/attention.py:209"),
        "csr_spmm_ev": ("sgformer_tpu_torch/csrc/spmm.cu", via),
        "csr_spmm_ev_bwd": ("sgformer_tpu_torch/csrc/spmm.cu",
                            "sgformer_tpu/kernels/spmm.py:294-303 (_spmm_ev_bwd: dx through "
                            ":34 on the bwd plan, dv in XLA)"),
        "sddmm": ("sgformer_tpu_torch/csrc/spmm.cu",
                  "sgformer_tpu/kernels/spmm.py:301-303 (_spmm_ev_bwd's dv, XLA)"),
    }
    # each kernel's numbers in its main path's type at its first layer's
    # shapes (GAT sends bf16 messages of f32 x; dv reads f32); launches from
    # the run of the path that uses it (time_test), with one train step and
    # one forward beside them; sddmm, which no path runs, from its own run
    main = {"csr_spmm_ev": ("bf16", 0), "csr_spmm_ev_bwd": ("bf16", 0), "sddmm": ("f32", 0)}
    # each forward kernel's custom op (kernels/ops.py) and its launches in one
    # exported forward (serve-export); the backward kernels and the probes
    # are no ops
    op_of = {count: f"sgformer_tpu_torch::{name}" for name, count in ops.LAUNCH_COUNT.items()}

    def as_op(name: str) -> dict:
        return {"registered_op": op_of.get(name),
                "launches_per_exported_forward": exported_forward[name]}

    def sharded_fields(name: str) -> dict:
        """arxiv-sharded-train's launches of ``name`` on rank 0 of each run
        (its time_test, one step, one forward) and over the CLI's sharded
        recipe run."""
        fields = {"cli_sharded_launches": sharded_counts["cli"][name]}
        for run in ("nccl1", "gloo2"):
            for key in ("allgather", "halo"):
                r = sharded_counts[run][0][key]
                fields.update({
                    f"sharded_{run}_{key}_launches": r["run_launches"][name],
                    f"sharded_{run}_{key}_launches_per_train_step": r["step_launches"][name],
                    f"sharded_{run}_{key}_launches_per_forward": r["forward_launches"][name]})
        return fields

    def dp_fields(name: str) -> dict:
        """arxiv-dp-batch-train's launches of ``name`` on rank 0 of each run
        (its fit, one step, one eval batch's forward)."""
        fields = {}
        for run, per_rank in dp_counts.items():
            r = per_rank[0]
            fields.update({f"dp_batch_{run}_launches": r["fit_launches"][name],
                           f"dp_batch_{run}_launches_per_train_step": r["step_launches"][name],
                           f"dp_batch_{run}_launches_per_forward": r["forward_launches"][name]})
        return fields

    line = {"kernels": []}
    for name, (source, replaces) in sources.items():
        if name in main:
            dtype, layer = main[name]
            r = dict(results[(name, dtype, layer)])
            r.update({f"layer1_{k}": v for k, v in results[(name, dtype, 1)].items()
                      if k.endswith("ms")})
            counts, per_step, per_forward = gat_counts, gat_step, gat_forward
            r.update(powerlaw_launches=plg_counts[name],
                     powerlaw_launches_per_train_step=plg_step[name])
            if name == "csr_spmm_ev":
                # f32 messages (the CLI's GAT) at both layers, the narrow
                # walk's design at the output layer and the width sweep
                for layer_ in range(len(GAT_LAYERS)):
                    prefix = "f32_" if layer_ == 0 else "f32_layer1_"
                    r.update({f"{prefix}{k}": v for k, v in results[(name, "f32", layer_)].items()
                              if k.endswith("ms")})
                r.update(layer1_design=walk_design(GAT_LAYERS[1][1]),
                         width_sweep=sweep_fields(results, name))
            if name == "csr_spmm_ev_bwd":
                r.update({f"f32_messages_{k}": v for k, v in results[(name, "f32", 0)].items()
                          if k.endswith("ms")})
                for layer_ in range(len(GAT_LAYERS)):
                    prefix = "powerlaw_" if layer_ == 0 else "powerlaw_layer1_"
                    r.update({f"{prefix}{k}": v for k, v in
                              results[("csr_spmm_ev_bwd_powerlaw", "bf16", layer_)].items()
                              if k.endswith("ms") or k in ("max_abs_err", "grows_per_s")})
            if name == "sddmm":
                counts = dict(counts, sddmm=sddmm_launches)
                r.update({k.replace("sddmm", "powerlaw"): v for k, v in
                          results[("csr_spmm_ev_bwd_powerlaw", "bf16", 0)].items()
                          if k.startswith("sddmm")})
        else:
            r = dict(results[(name, "bf16")])
            if (name, "f32") in results:  # f32 at arxiv's N (the attention kernels: 3xTF32)
                r.update({f"f32_{k}": v for k, v in results[(name, "f32")].items()})
            counts, per_step = train_counts, step_counts
            per_forward = {k: c / forwards for k, c in serve_counts.items()}
        if name in BATCH_KERNELS:
            # the batch and sampled paths: launches of their fit runs and of
            # one batch step; each kernel alone in f32 and bf16 at a full
            # batch's and the tail's shapes, in f32 at a sampled batch's (E
            # = the batch graph's edges for csr_spmm, on A and on A^T)
            for what, (b_step, _, b_counts, _) in (("arxiv_batch", arxiv_batch),
                                                   ("amazon2m_batch", amazon2m_batch),
                                                   ("papers_sampled", papers)):
                r.update({f"{what}_launches": b_counts[name],
                          f"{what}_launches_per_train_step": b_step[name]})
            for key, v in results.items():
                if (key[0] in ("arxiv-batch", "amazon2m-batch", "papers-sampled")
                        and key[1] in (name, f"{name}_t")):
                    prefix = f"{key[0].replace('-', '_')}_{key[2]}_n{key[3]}_"
                    if key[1] != name:
                        prefix = f"{key[0].replace('-', '_')}_transposed_{key[2]}_n{key[3]}_"
                    r.update({prefix + k: v[k] for k in ("ms", "plain_ms", "bound_ms",
                                                         "bytes_bound_ms", "max_abs_err",
                                                         "edges", "design", "main_ms",
                                                         "finish_ms", "scalars_ms", "slices",
                                                         "library_ms", "hub_segments")
                              if k in v})
        if name in ("csr_spmm", "csr_spmm_ev"):
            r.update(design=ROW_WALK)
        if name == "csr_spmm":
            r.update({f"powerlaw_{k}": v for k, v in
                      results[("csr_spmm_powerlaw", "bf16")].items()
                      if k.endswith("ms") or k == "hub_segments"})
            r.update({f"powerlaw_f32_{k}": v for k, v in
                      results[("csr_spmm_powerlaw", "f32")].items()
                      if k.endswith("ms") or k in ("max_abs_err", "bound_by")})
            r.update(powerlaw_launches=pl_counts[name],
                     powerlaw_launches_per_train_step=pl_step[name],
                     width_sweep=sweep_fields(results, name))
        # the CLI's runs (the recipes and H2GCN) and the zoo's
        r.update({f"cli_{what}_launches": c[name] for what, c in cli_counts.items()})
        r.update({f"zoo_{what}_launches": c[name] for what, c in zoo_counts.items()})
        r.update(sharded_fields(name))
        r.update(dp_fields(name))
        line["kernels"].append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name], "launches_per_forward": per_forward[name],
            "launches_per_train_step": per_step[name], **as_op(name), **r,
        })
    # the int8 aggregation and its quantiser: launches from
    # large-400K-int8-train's time_test, error and times at that path's
    # shape in bf16; the arxiv shape's in bf16 and f32 and the power-law
    # graph's in bf16 beside them
    for name, replaces in (
            ("csr_spmm_q8", "slab_spmm.py:131 (int8 branch :193-200)"),
            ("quantize_absmax", "slab_spmm.py:380-394 (_apply_side's absmax quantiser, XLA "
                                "outside the pallas_call)")):
        r = dict(results[(f"{name}_large400k", "bf16")])
        for prefix, key, dtype in (("arxiv_", name, "bf16"), ("arxiv_f32_", name, "f32"),
                                   ("powerlaw_", f"{name}_powerlaw", "bf16")):
            r.update({f"{prefix}{k}": v for k, v in results[(key, dtype)].items()
                      if k.endswith("ms") or k in ("max_abs_err", "design", "grows_per_s")})
        line["kernels"].append({
            "name": name, "route": "cuda", "source": "sgformer_tpu_torch/csrc/spmm.cu",
            "replaces": f"sgformer_tpu/kernels/{replaces}", "launches": q8_counts[name],
            "launches_per_forward": q8_forward[name], "launches_per_train_step": q8_step[name],
            **as_op(name), **r,
            **{f"cli_{what}_launches": c[name] for what, c in cli_counts.items()},
            **{f"zoo_{what}_launches": c[name] for what, c in zoo_counts.items()},
            **sharded_fields(name), **dp_fields(name),
        })
    # the timing probes: launches from their own runs; per forward and per
    # step as counted on large-400K-int8-train (no model path runs them, and
    # every path's launch check holds them to 0)
    for name, replaces in zip(PROBES, ("scripts/microbench_dma_gather.py:70",
                                       "scripts/microbench_dma_tile.py:65",
                                       "scripts/microbench_slab_variants.py:145")):
        line["kernels"].append({
            "name": name, "route": "cuda", "source": "sgformer_tpu_torch/csrc/microbench.cu",
            "replaces": replaces, "launches": probe_counts[name],
            "launches_per_forward": q8_forward[name], "launches_per_train_step": q8_step[name],
            **as_op(name), **results[name],
            **{f"cli_{what}_launches": c[name] for what, c in cli_counts.items()},
            **{f"zoo_{what}_launches": c[name] for what, c in zoo_counts.items()},
            **sharded_fields(name), **dp_fields(name),
        })
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
