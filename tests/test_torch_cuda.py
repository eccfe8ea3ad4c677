"""The port's CUDA kernels against their plain versions on the card, at
shapes the serving path does not reach: partial tiles, tail rows, rows of
more than 32 edges, hub rows split into segments, isolated nodes and empty
rows, strided heads, widths off the 16-byte path, several heads of
per-edge values; and the trainers and the CLI's set-up on the card against
the CPU. Skipped without a CUDA card. This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: f32 1e-5 (summation order only, TF32 off); bf16 1e-2 relative
and absolute (the output rounding to bf16 may differ by one ulp, 2^-8)."""

import itertools

import numpy as np
import pytest
import torch

from sgformer_tpu_torch import Predictor, SGFormer, SGFormerConfig, preprocess_graph
from sgformer_tpu_torch import kernels
from sgformer_tpu_torch.kernels import attention as attn
from sgformer_tpu_torch.kernels import spmm as spmm_kernel
from sgformer_tpu_torch.kernels.spmm import csr_spmm, csr_spmm_ev, csr_spmm_ev_bwd, sddmm
from sgformer_tpu_torch.ops.attention import linear_attention
from sgformer_tpu_torch.ops.sddmm import sddmm as sddmm_plain
from sgformer_tpu_torch.ops.spmm import spmm, spmm_edge_values, spmm_edge_values_backward
from sgformer_tpu_torch.utils.measure import (apply_product_inputs, bwd_product_inputs,
                                              bwd_reduce_product_inputs, reduce_product_inputs,
                                              rel_err)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _graph(cuda, n=700, e=3000, seed=0):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n - 20, e)
    dst = rng.integers(0, n - 20, e)
    hub = np.stack([np.arange(70), np.full(70, 5)])  # node 5: in-degree > 64
    ei = np.concatenate([np.stack([src, dst]), hub], axis=1)
    # undirected=False keeps the last 20 nodes isolated but for their loop
    return preprocess_graph(ei, n, undirected=False, device=cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [520, 256, 128, 64, 40, 37, 32, 16, 1])
def test_csr_spmm_kernel_matches_plain(cuda, dtype, width):
    g = _graph(cuda)
    x = torch.randn(g.num_nodes, width, device=cuda).to(dtype)
    before = kernels.spmm.launches
    got = csr_spmm(x, g.indptr, g.edge_src, g.edge_dst, g.gcn_weight)
    assert kernels.spmm.launches == before + 1
    want = spmm(x, g.edge_src, g.edge_dst, g.gcn_weight, g.num_nodes)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.equal(got, csr_spmm(x, g.indptr, g.edge_src, g.edge_dst, g.gcn_weight))


def test_csr_spmm_unaligned_rows_take_the_scalar_path(cuda):
    g = _graph(cuda)
    flat = torch.randn(g.num_nodes * 64 + 1, device=cuda)
    x = flat[1:].view(g.num_nodes, 64)  # contiguous, 4 bytes off 16-byte alignment
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    got = csr_spmm(x, g.indptr, g.edge_src, g.edge_dst, g.gcn_weight)
    want = spmm(x, g.edge_src, g.edge_dst, g.gcn_weight, g.num_nodes)
    torch.testing.assert_close(got, want, **TOL[torch.float32])


def test_csr_spmm_rejects_what_the_kernel_cannot_take(cuda):
    g = _graph(cuda)
    with pytest.raises(TypeError):
        csr_spmm(torch.zeros(g.num_nodes, 8, device=cuda), g.indptr.long(),
                 g.edge_src, g.edge_dst, g.gcn_weight)
    with pytest.raises(ValueError):
        csr_spmm(torch.zeros(g.num_nodes, 8), g.indptr, g.edge_src, g.edge_dst,
                 g.gcn_weight)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,m,d", [(1, 256, 256), (2, 48, 80), (3, 16, 8)])
@pytest.mark.parametrize("masked", [False, True])
def test_linear_attention_kernels_match_plain(cuda, dtype, heads, m, d, masked):
    n = 1000  # not a multiple of the 64-row apply tile or the 32-row step
    q, k = (torch.randn(n, heads, m, device=cuda).to(dtype) for _ in range(2))
    v = torch.randn(n, heads, d, device=cuda).to(dtype)
    mask = (torch.arange(n, device=cuda) % 3 != 1).float() if masked else None
    r0, a0 = attn.reduce_launches, attn.apply_launches
    got = attn.fused_linear_attention(q, k, v, node_mask=mask)
    assert (attn.reduce_launches - r0, attn.apply_launches - a0) == (heads, heads)
    want = linear_attention(q, k, v, node_mask=mask)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])

    # the apply kernel alone, where q @ kvs carries the output (n = 1)
    qp, kp = (torch.rand(n, m, device=cuda).to(dtype) for _ in range(2))
    vp = torch.rand(n, d, device=cuda).to(dtype)
    kvs, ksum, scal = attn.reduce(qp, kp, vp)
    kvs_w, ksum_w, scal_w = attn.reduce_plain(qp, kp, vp, False)
    torch.testing.assert_close(kvs, kvs_w, rtol=1e-5, atol=1e-5 * kvs_w.abs().max().item())
    torch.testing.assert_close(ksum, ksum_w, rtol=1e-5, atol=1e-5 * ksum_w.abs().max().item())
    torch.testing.assert_close(scal, scal_w, rtol=1e-6, atol=0.0)
    one = torch.ones((), device=cuda)
    got_a = attn.apply(qp, vp, kvs_w, ksum_w, scal_w, one)
    want_a = attn.apply_plain(qp, vp, kvs_w, ksum_w, scal_w, one, False)
    torch.testing.assert_close(got_a.float(), want_a.float(), **TOL[dtype])


def test_all_masked_attention_is_finite_zero(cuda):
    q, k, v = (torch.randn(500, 1, 32, device=cuda) for _ in range(3))
    mask = torch.zeros(500, device=cuda)
    got = attn.fused_linear_attention(q, k, v, node_mask=mask)
    assert torch.isfinite(got).all() and not got.any()


@pytest.mark.parametrize("compute_dtype", ["f32", "bf16"])
def test_predictor_on_the_card_matches_the_cpu(cuda, compute_dtype):
    rng = np.random.default_rng(1)
    n = 900
    ei = rng.integers(0, n, (2, 5000))
    x = rng.standard_normal((n, 24)).astype(np.float32)
    cfg = SGFormerConfig.large(64, 5, gnn_num_layers=3, compute_dtype=compute_dtype)
    logits = {}
    for dev in ("cpu", "cuda"):
        model = SGFormer(cfg, 24, generator=torch.Generator().manual_seed(0), device=dev)
        graph = preprocess_graph(ei, n, device=dev)
        logits[dev] = Predictor(model, graph, x, device=dev).compile().logits()
    if compute_dtype == "f32":
        np.testing.assert_allclose(logits["cuda"], logits["cpu"], rtol=1e-4, atol=1e-4)
    else:
        assert (logits["cuda"].argmax(-1) == logits["cpu"].argmax(-1)).mean() >= 0.99
        np.testing.assert_allclose(logits["cuda"], logits["cpu"], rtol=0, atol=5e-2)


def _check_rel(got, want, rel):
    """max |got - want| <= rel * max |want| (gradients are far from O(1) at
    these sizes, so the forward's tolerances apply to each tensor's scale)."""
    err, scale = rel_err(got, want)
    assert err <= rel * scale


BWD_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,m,d,n", [
    (1, 256, 256, 1000), (2, 48, 80, 1000), (1, 64, 128, 1000), (3, 16, 8, 1000),
    (1, 1024, 64, 1000),
    # amazon2m-batch-train's shapes: a full batch and the tail
    (1, 256, 256, 100_000), (1, 256, 256, 49_029)])
@pytest.mark.parametrize("masked", [False, True])
def test_attention_backward_kernels_match_plain(cuda, dtype, heads, m, d, n, masked):
    # n = 1000: not a multiple of the 64-row tile, the 128-row block or the
    # 32-row step
    q, k = (torch.randn(n, heads, m, device=cuda).to(dtype) for _ in range(2))
    v = torch.randn(n, heads, d, device=cuda).to(dtype)
    g = torch.randn(n, heads, d, device=cuda).to(dtype)
    mask = (torch.arange(n, device=cuda) % 3 != 1).float() if masked else None
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    # both types run the tensor-core kernels (f32 in 3xTF32), widths whose
    # A tile outgrows one block's shared memory (m = 1024) the CUDA-core ones
    for design in (attn.bwd_apply_design(dtype, m, d), attn.bwd_reduce_design(dtype, m, d)):
        assert design.startswith("tensor cores") == (m < 1024)
        assert ("3xTF32" in design) == (dtype == torch.float32 and m < 1024)
    r0, a0 = attn.bwd_reduce_launches, attn.bwd_apply_launches
    got = torch.autograd.grad(attn.fused_linear_attention(*leaves, node_mask=mask), leaves, g)
    assert (attn.bwd_reduce_launches - r0, attn.bwd_apply_launches - a0) == (heads, heads)
    want = torch.autograd.grad(linear_attention(*leaves, node_mask=mask), leaves, g)
    for a, b in zip(got, want):
        _check_rel(a, b, BWD_REL[dtype])
    again = torch.autograd.grad(attn.fused_linear_attention(*leaves, node_mask=mask), leaves, g)
    assert all(torch.equal(a, b) for a, b in zip(got, again))

    # each kernel alone against its plain version, with n = 1 so that the
    # attention products carry the gradients. The reduce is held to the
    # plain version evaluated in f64 on the same inputs; dinv's two sums
    # (sum gd*a and sum gden*b) cancel there to ~1e-4 of their size, so any
    # f32 evaluation of it, the plain version's included, is exact only to a
    # share of the sums' magnitude, which is its scale here
    qp, kp = (torch.rand(n, m, device=cuda).to(dtype) for _ in range(2))
    vp, gp = (torch.rand(n, d, device=cuda).to(dtype) for _ in range(2))
    one = torch.ones((), device=cuda)
    sums = attn.reduce_plain(qp, kp, vp, False)
    got_r = attn.bwd_reduce(qp, vp, gp, *sums, one)
    qd, vd, gd, kvs, ksum = (t.double() for t in (qp, vp, gp, *sums[:2]))
    exact = attn.bwd_reduce_plain(qd, vd, gd, kvs, ksum, sums[2].double(), one.double(), False)
    for i in (0, 1, 3):  # P, ds, rows
        _check_rel(got_r[i], exact[i], 1e-5)
    a, b = qd @ kvs, qd @ ksum
    den, gden = exact[3]
    dinv_scale = (gd / den[:, None] * a).abs().sum() + (gden * b).abs().sum()
    assert (got_r[2].double() - exact[2]).abs() <= 1e-5 * dinv_scale
    # the apply against its plain version evaluated in f64 on the same
    # inputs: its epilogue's terms cancel here to ~1/13 of their size, and
    # an f32 evaluation of it, the plain version's included, is then itself
    # ~1e-5 of the scale off
    want_r = attn.bwd_reduce_plain(qp, vp, gp, *sums, one, False)
    got_a = attn.bwd_apply(qp, kp, vp, gp, *sums, one, *want_r)
    want_a = attn.bwd_apply_plain(*(t.double() for t in (qp, kp, vp, gp, *sums, one, *want_r)),
                                  False)
    for a, b in zip(got_a, want_a):
        _check_rel(a, b, BWD_REL[dtype])


@pytest.mark.parametrize("m,d", [(37, 19), (256, 40), (8, 300)])
def test_tensor_core_apply_takes_any_width(cuda, m, d):
    """The bf16 apply on widths off its tiles and off the 16-byte row path
    (zero-filled partial tiles, scalar A rows), on row-strided views, with n
    = 1 so the products carry the gradients; bitwise repeatable."""
    n = 777
    qkv = torch.rand(n, 3, max(m, d) + 3, device=cuda).to(torch.bfloat16)
    q, k, v = qkv[:, 0, :m], qkv[:, 1, :m], qkv[:, 2, :d]
    g = torch.rand(n, d, device=cuda).to(torch.bfloat16)
    assert attn.bwd_apply_design(torch.bfloat16, m, d).startswith("tensor cores")
    one = torch.ones((), device=cuda)
    sums = attn.reduce_plain(q, k, v, False)
    red = attn.bwd_reduce_plain(q, v, g, *sums, one, False)
    got = attn.bwd_apply(q, k, v, g, *sums, one, *red)
    want = attn.bwd_apply_plain(q, k, v, g, *sums, one, *red, False)
    for a, b in zip(got, want):
        _check_rel(a, b, BWD_REL[torch.bfloat16])
    again = attn.bwd_apply(q, k, v, g, *sums, one, *red)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_reduce_designs_name_the_kernels(cuda):
    """The forward reduces run on warpgroup MMAs at every width (bf16,
    ``la_reduce_wgmma_kernel``; f32 in 3xTF32, ``la_reduce_wg_kernel``: the
    node rows stream through a fixed tile); bf16 backward reduces at any
    width the backward's q tile fits (up to M = 640), the f32 backward
    reduce in 3xTF32 on warpgroup MMAs up to M = 256 (its P pass
    ``la_bwd_reduce_wg_kernel``, at any D)."""
    for m, d in ((256, 256), (37, 40), (640, 64), (1024, 64)):
        bf16 = attn.reduce_design(torch.bfloat16, m, d)
        assert bf16.startswith("tensor cores (wgmma bf16") and "la_reduce_wgmma_kernel" in bf16
        f32 = attn.reduce_design(torch.float32, m, d)
        assert f32.startswith("tensor cores (wgmma 3xTF32") and "la_reduce_wg_kernel" in f32, f32
        assert attn.bwd_reduce_design(torch.bfloat16, m, d).startswith("tensor cores") == (
            m <= 640)
        f32 = attn.bwd_reduce_design(torch.float32, m, d)
        assert f32.startswith("tensor cores (wgmma 3xTF32, f32 sums: rows pass") == (m <= 256), f32
        assert ("la_bwd_reduce_wg_kernel" in f32) == (m <= 256), f32
    assert "la_bwd_reduce_wg_kernel" in attn.bwd_reduce_design(torch.float32, 256, 999)
    assert attn.bwd_reduce_design(torch.float32, 257, 8).startswith("CUDA cores")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reduce_grid_follows_its_design(cuda, monkeypatch, dtype):
    """reduce() sizes its slices for the tensor-core design of its type:
    one wave of resident blocks, one an SM in both types (two consumer
    warpgroups and a producer warpgroup a block)."""
    seen = []
    slices = attn._slices

    def spy(*args):
        seen.append(args)
        return slices(*args)

    monkeypatch.setattr(attn, "_slices", spy)
    n = 100_000
    q, k, v = (torch.randn(n, 256, device=cuda).to(dtype) for _ in range(3))
    _f64_reduce_close(attn.reduce(q, k, v), q, k, v)
    (_, _, _, _, tensor_cores), = seen
    assert tensor_cores
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert slices(n, 256, 256, q.device, True)[0] == -(-sms // 4)


@pytest.mark.parametrize("m,d", [(37, 19), (256, 40), (8, 250), (256, 256), (130, 19),
                                 (256, 999)])
@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("n", [777, 1])
def test_tf32_backward_takes_any_width(cuda, m, d, strided, n):
    """The f32 (3xTF32) backward reduce and apply on widths off their tiles
    and off the 16-byte path (37, 19, 130: scalar A rows and epilogues), up
    to the widest tile they take (256; the reduce's P pass at D = 999 too,
    where the apply runs on the CUDA cores), on the per-head views of
    [N, 2, *] tensors (strided: rows 3 elements longer, so no 16-byte copies
    and no tensor maps), with tail rows (N = 777) and at N = 1: at n = N on
    random inputs and at n = 1 on positive inputs (the products carry den,
    gden and the gradients), the reduce within 1e-5 of its scale of the
    plain version in f64 (dinv of its sums' magnitude), the apply within
    1e-5 of each output's scale of its plain version in f64 (at n = 1 the
    epilogue's terms cancel to ~1/13 of their size, and the plain version
    evaluated in f32 is itself ~1e-5 of the scale off); each bitwise
    repeatable, one launch a call; an all-masked group gives finite zero
    gradients. At N = 1 and at D = 999 the reduce
    alone: one row's dq and dk cancel to ~1e-7 of their terms, and at D =
    999 the apply runs on the CUDA cores, whose n = 1 epilogue cancels
    further, past what an f32 evaluation holds (the plain version in f32
    is 2e-5 of the scale off there)."""
    pad = 3 if strided else 0
    assert "la_bwd_reduce_wg_kernel" in attn.bwd_reduce_design(torch.float32, m, d)
    assert ("3xTF32" in attn.bwd_apply_design(torch.float32, m, d)) == (d <= 256)

    def heads(draw, w):  # head 1 of an [n, 2, w + pad] tensor
        return draw(n, 2, w + pad, device=cuda)[:, 1, :w]

    # an all-masked group: finite zero gradients through the P pass (zero
    # norms: inv = 0, den taken as 1)
    leaves = [heads(torch.randn, w)[:, None].clone().requires_grad_() for w in (m, m, d)]
    out = attn.fused_linear_attention(*leaves, node_mask=torch.zeros(n, device=cuda))
    assert all(torch.isfinite(t).all() and not t.any()
               for t in torch.autograd.grad(out, leaves, torch.randn_like(out)))

    # a single random row's den may come near 0, where no f32 evaluation
    # holds 1e-5: at N = 1 the positive inputs alone
    for draw in (torch.randn, torch.rand) if n > 1 else (torch.rand,):
        q, k, v, g = heads(draw, m), heads(draw, m), heads(draw, d), heads(draw, d)
        sums = attn.reduce_plain(q, k, v, False)
        n_t = torch.full((), 1.0 if draw is torch.rand else float(n), device=cuda)
        b0, a0 = attn.bwd_reduce_launches, attn.bwd_apply_launches
        got_r = attn.bwd_reduce(q, v, g, *sums, n_t)
        _f64_bwd_reduce_close(got_r, q, v, g, *sums, n_t)
        assert all(torch.equal(a, b) for a, b in zip(got_r, attn.bwd_reduce(q, v, g, *sums,
                                                                            n_t)))
        if n == 1 or d > 256:
            assert attn.bwd_reduce_launches - b0 == 2
            continue
        red = attn.bwd_reduce_plain(q, v, g, *sums, n_t, False)
        got_a = attn.bwd_apply(q, k, v, g, *sums, n_t, *red)
        exact = attn.bwd_apply_plain(*(t.double() for t in (q, k, v, g, *sums, n_t, *red)),
                                     False)
        for a, b in zip(got_a, exact):
            _check_rel(a, b, BWD_REL[torch.float32])
        assert all(torch.equal(a, b) for a, b in zip(got_a, attn.bwd_apply(q, k, v, g, *sums,
                                                                           n_t, *red)))
        assert (attn.bwd_reduce_launches - b0, attn.bwd_apply_launches - a0) == (2, 2)


@pytest.mark.parametrize("m,d", [(8, 72), (72, 200), (200, 256), (256, 256), (37, 19),
                                 (8, 250), (256, 40), (256, 999)])
def test_tf32_backward_kernels_carry_the_products(cuda, m, d):
    """The f32 backward kernels on warpgroup MMAs (the apply, the reduce's
    rows pass and P pass) where their products carry the outputs and every
    (row, column) pairing of kvs and P moves them (``bwd_product_inputs``:
    one TF32 product in place of three, k-steps or B columns swapped, or A
    rows shifted would miss the f32 tolerance), with tail rows (N = 777):
    the reduce within 1e-5 of its scale of its plain version in f64 (dinv
    of its sums' magnitude), the apply within 1e-5 of each output's scale of
    ``bwd_apply_plain`` in f64; each bitwise repeatable. The P pass also on
    ``bwd_reduce_product_inputs`` (a dropped tf32 lo piece of q or of g/den
    would miss the tolerance) at N = 777 and N = 1, on contiguous rows (the
    copy engine's tensor maps) and on strided heads (the producer's own
    copies). At D = 999 the apply runs on the CUDA cores."""
    gen = torch.Generator(device=cuda).manual_seed(m + d)
    for n in (777, 1):
        for strided in (False, True):
            ins = list(bwd_reduce_product_inputs(n, m, d, torch.float32, gen))
            if strided:  # head 1 of [n, 2, w + 3] tensors
                for i in range(3):
                    t = torch.zeros(n, 2, ins[i].shape[1] + 3, device=cuda)
                    t[:, 1, :ins[i].shape[1]] = ins[i]
                    ins[i] = t[:, 1, :ins[i].shape[1]]
            got_p = attn.bwd_reduce(*ins)
            _f64_bwd_reduce_close(got_p, *ins)
            assert all(torch.equal(a, b) for a, b in zip(got_p, attn.bwd_reduce(*ins)))
    ins = bwd_product_inputs(777, m, d, torch.float32, gen)
    q, k, v, g, kvs, ksum, scal, n_t = ins[:8]
    assert "la_bwd_reduce_wg_kernel" in attn.bwd_reduce_design(torch.float32, m, d)
    assert attn.bwd_apply_design(torch.float32, m, d).startswith("tensor cores (wgmma 3xTF32") == (
        d <= 256)
    got_r = attn.bwd_reduce(q, v, g, kvs, ksum, scal, n_t)
    _f64_bwd_reduce_close(got_r, q, v, g, kvs, ksum, scal, n_t)
    assert all(torch.equal(a, b) for a, b in zip(got_r, attn.bwd_reduce(q, v, g, kvs, ksum, scal,
                                                                        n_t)))
    got_a = attn.bwd_apply(*ins)
    exact = attn.bwd_apply_plain(*(t.double() for t in ins), False)
    for a, b in zip(got_a, exact):
        _check_rel(a, b, BWD_REL[torch.float32])
    assert all(torch.equal(a, b) for a, b in zip(got_a, attn.bwd_apply(*ins)))


@pytest.mark.parametrize("n", [777, 1000])
@pytest.mark.parametrize("m,d", [(37, 19), (256, 40), (8, 250), (256, 256), (130, 200), (640, 72),
                                 (40, 37)])
@pytest.mark.parametrize("strided", [False, True])
def test_bf16_wgmma_backward_takes_any_width(cuda, n, m, d, strided):
    """The bf16 backward on warpgroup MMAs (``la_bwd_rows_ws16_kernel``,
    ``la_bwd_reduce_ws16_kernel``, ``la_bwd_apply_ws16_kernel`` and above M,
    D = 256 ``la_bwd_apply_wgmma_kernel``) on widths
    off their 64- and 128-column tiles and off the 16-byte path (37, 19,
    130: scalar rows), up to the widest q tile the rows pass takes beside
    two stages (640), on the per-head views of [N, 2, *] tensors (strided:
    rows 3 elements longer, so no 16-byte copies but for (40, 37), whose
    view of 37 columns is 16-byte aligned: an odd width on the copy
    engine's path), with tail rows (777 and
    1,000: off the 64-row P chunk and the 128-row block): at n = N on random
    inputs and at n = 1 on positive inputs (the products carry den, gden
    and the gradients), the reduce within 1e-5 of its scale of the plain
    version in f64 (dinv of its sums' magnitude), the apply within the bf16
    tolerance of each output's scale of its plain version in f64; each
    bitwise repeatable, one launch a call."""
    pad = 3 if strided else 0
    for design in (attn.bwd_reduce_design(torch.bfloat16, m, d),
                   attn.bwd_apply_design(torch.bfloat16, m, d)):
        assert design.startswith("tensor cores (wgmma bf16"), design

    def heads(draw, w):  # head 1 of an [n, 2, w + pad] tensor
        return draw(n, 2, w + pad, device=cuda).to(torch.bfloat16)[:, 1, :w]

    for draw in (torch.randn, torch.rand):
        q, k, v, g = heads(draw, m), heads(draw, m), heads(draw, d), heads(draw, d)
        sums = attn.reduce_plain(q, k, v, False)
        n_t = torch.full((), 1.0 if draw is torch.rand else float(n), device=cuda)
        b0, a0 = attn.bwd_reduce_launches, attn.bwd_apply_launches
        got_r = attn.bwd_reduce(q, v, g, *sums, n_t)
        _f64_bwd_reduce_close(got_r, q, v, g, *sums, n_t)
        assert all(torch.equal(a, b) for a, b in zip(got_r, attn.bwd_reduce(q, v, g, *sums,
                                                                            n_t)))
        red = attn.bwd_reduce_plain(q, v, g, *sums, n_t, False)
        got_a = attn.bwd_apply(q, k, v, g, *sums, n_t, *red)
        exact = attn.bwd_apply_plain(*(t.double() for t in (q, k, v, g, *sums, n_t, *red)),
                                     False)
        for a, b in zip(got_a, exact):
            _check_rel(a, b, BWD_REL[torch.bfloat16])
        assert all(torch.equal(a, b) for a, b in zip(got_a, attn.bwd_apply(q, k, v, g, *sums,
                                                                           n_t, *red)))
        assert (attn.bwd_reduce_launches - b0, attn.bwd_apply_launches - a0) == (2, 2)


@pytest.mark.parametrize("m,d", [(8, 72), (72, 200), (200, 256), (256, 256)])
def test_bf16_wgmma_backward_kernels_carry_the_products(cuda, m, d):
    """The bf16 backward kernels where their products carry the outputs and
    every (row, column) pairing of kvs and P moves them
    (``bwd_product_inputs`` in bf16: a wrong swizzle, descriptor or k step
    garbles them, and a dropped piece of kvs or g/den misses the reduce's
    tolerance), with tail rows (N = 777): the reduce within 1e-5 of its
    scale of its plain version in f64 (dinv of its sums' magnitude), the
    apply within the bf16 tolerance of each output's scale of
    ``bwd_apply_plain`` in f64; each bitwise repeatable."""
    gen = torch.Generator(device=cuda).manual_seed(m + d)
    ins = bwd_product_inputs(777, m, d, torch.bfloat16, gen)
    q, k, v, g, kvs, ksum, scal, n_t = ins[:8]
    got_r = attn.bwd_reduce(q, v, g, kvs, ksum, scal, n_t)
    _f64_bwd_reduce_close(got_r, q, v, g, kvs, ksum, scal, n_t)
    assert all(torch.equal(a, b) for a, b in zip(got_r, attn.bwd_reduce(q, v, g, kvs, ksum, scal,
                                                                        n_t)))
    got_a = attn.bwd_apply(*ins)
    exact = attn.bwd_apply_plain(*(t.double() for t in ins), False)
    for a, b in zip(got_a, exact):
        _check_rel(a, b, BWD_REL[torch.bfloat16])
    assert all(torch.equal(a, b) for a, b in zip(got_a, attn.bwd_apply(*ins)))


@pytest.mark.parametrize("m,d", [(130, 19), (256, 256)])
def test_bf16_wgmma_backward_with_masked_rows(cuda, m, d):
    """Two heads of bf16 with every third row masked and tail rows (N =
    1,000): the attention's gradients through the wgmma backward against
    autograd of the plain forward (the bf16 tolerance of each output's
    scale), bitwise repeatable, one launch of each kernel a head."""
    n = 1000
    q, k = (torch.randn(n, 2, m, device=cuda).to(torch.bfloat16) for _ in range(2))
    v, g = (torch.randn(n, 2, d, device=cuda).to(torch.bfloat16) for _ in range(2))
    mask = (torch.arange(n, device=cuda) % 3 != 1).float()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    r0, a0 = attn.bwd_reduce_launches, attn.bwd_apply_launches
    got = torch.autograd.grad(attn.fused_linear_attention(*leaves, node_mask=mask), leaves, g)
    assert (attn.bwd_reduce_launches - r0, attn.bwd_apply_launches - a0) == (2, 2)
    want = torch.autograd.grad(linear_attention(*leaves, node_mask=mask), leaves, g)
    for a, b in zip(got, want):
        _check_rel(a, b, BWD_REL[torch.bfloat16])
    again = torch.autograd.grad(attn.fused_linear_attention(*leaves, node_mask=mask), leaves, g)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _f64_reduce_close(got, q, k, v):
    """kvs, ksum and the norms within 1e-5 of their scale of the reduce's
    sums in f64 on the same inputs (``reduce_plain`` sums in f32 whatever
    its inputs)."""
    qd, kd, vd = q.double(), k.double(), v.double()
    norms = torch.stack([qd.square().sum(), kd.square().sum()])
    for a, b in ((got[0], kd.T @ vd), (got[1], kd.sum(0)), (got[2][:2], norms)):
        _check_rel(a, b, 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_reduce_products_carry_it(cuda, monkeypatch, dtype):
    """The forward reduce over one slice of 40,000 rows (the grid forced to
    one slice a tile, so that its fresh sums and f32 running sums chain the
    whole input) on ``reduce_product_inputs`` (positive, each value a
    fraction of a tf32 step above a tf32 value): kvs, ksum and the norms
    within REDUCE_REL_TOL (1e-5) of their sums in f64, bitwise repeatable,
    one launch. In f32 the same kᵀv with k's or v's tf32 lo piece dropped
    misses that tolerance by more than 10x, so a kernel that dropped one
    would fail here."""
    n, m, d = 40_000, 256, 256
    monkeypatch.setattr(attn, "_slices", lambda n_, *args: (1, -(-n_ // 32) * 32))
    q, k, v = reduce_product_inputs(n, m, d, dtype, torch.Generator(device=cuda).manual_seed(25))
    r0 = attn.reduce_launches
    got = attn.reduce(q, k, v)
    assert attn.reduce_launches == r0 + 1
    _f64_reduce_close(got, q, k, v)
    assert all(torch.equal(a, b) for a, b in zip(got, attn.reduce(q, k, v)))
    if dtype == torch.bfloat16:
        return  # bf16 values are tf32 values: nothing to drop
    exact = k.double().T @ v.double()
    for hi_k, hi_v in ((True, False), (False, True)):
        ks, vs = (_tf32_hi(x) if hi else x.float() for x, hi in ((k, hi_k), (v, hi_v)))
        dropped = ks.double().T @ vs.double()
        assert (dropped - exact).abs().max() > 10 * 1e-5 * exact.abs().max()


def _tf32_hi(t):
    """f32 ``t`` rounded to tf32 as cvt.rna rounds it (the hi piece)."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _f64_bwd_reduce_close(got, q, v, g, kvs, ksum, scal, n_total, rel=1e-5, guard=False):
    """P, ds, den and gden within ``rel`` of their scale of the plain
    backward reduce in f64 (with the node mask's guard where ``guard``);
    dinv, whose two sums cancel, within ``rel`` of their magnitudes."""
    qd, vd, gd, kvs_d, ksum_d = (t.double() for t in (q, v, g, kvs, ksum))
    exact = attn.bwd_reduce_plain(qd, vd, gd, kvs_d, ksum_d, scal.double(), n_total.double(),
                                  guard)
    for a, b in ((got[0], exact[0]), (got[1], exact[1]), (got[3][0], exact[3][0]),
                 (got[3][1], exact[3][1])):
        _check_rel(a, b, rel)
    den, gden = exact[3]
    scale = (gd / den[:, None] * (qd @ kvs_d)).abs().sum() + (gden * (qd @ ksum_d)).abs().sum()
    assert (got[2].double() - exact[2]).abs() <= rel * scale


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,d", [(256, 256), (37, 40), (40, 37), (130, 19), (640, 72)])
@pytest.mark.parametrize("strided", [False, True])
def test_tensor_core_reduces_take_any_width(cuda, m, d, strided, dtype):
    """The reduce and backward reduce, bf16 and f32 (3xTF32), on widths off
    their tiles and off the 16-byte path, on the per-head views of [N, 2, *]
    tensors (strided: rows 3 elements longer, so no 16-byte copies), with
    tail rows (N = 777, not a multiple of the 32-row chunk or the 128-row
    block): the reduce at random and at positive inputs, the backward reduce
    at n = N and at n = 1 with positive inputs (the products carry den and
    gden there), each within 1e-5 of its scale of the plain version in f64
    and bitwise repeatable, one launch a call. The forward reduce takes the
    tensor cores at every width (M = 640 too); the f32 backward reduce runs
    on the CUDA cores above M = 256."""
    n, pad = 777, 3 if strided else 0
    assert attn.reduce_design(dtype, m, d).startswith("tensor cores")
    assert attn.bwd_reduce_design(dtype, m, d).startswith("tensor cores") == (
        dtype == torch.bfloat16 or m <= 256)

    def heads(draw, w):  # head 1 of an [n, 2, w + pad] tensor
        return draw(n, 2, w + pad, device=cuda).to(dtype)[:, 1, :w]

    for draw in (torch.randn, torch.rand):
        q, k, v, g = heads(draw, m), heads(draw, m), heads(draw, d), heads(draw, d)
        r0 = attn.reduce_launches
        got = attn.reduce(q, k, v)
        assert attn.reduce_launches == r0 + 1
        _f64_reduce_close(got, q, k, v)
        assert all(torch.equal(a, b) for a, b in zip(got, attn.reduce(q, k, v)))
        sums = attn.reduce_plain(q, k, v, False)
        n_t = torch.full((), 1.0 if draw is torch.rand else float(n), device=cuda)
        b0 = attn.bwd_reduce_launches
        got_b = attn.bwd_reduce(q, v, g, *sums, n_t)
        assert attn.bwd_reduce_launches == b0 + 1
        _f64_bwd_reduce_close(got_b, q, v, g, *sums, n_t)
        assert all(torch.equal(a, b) for a, b in zip(got_b, attn.bwd_reduce(q, v, g, *sums,
                                                                            n_t)))


@pytest.mark.parametrize("heads", [1, 2])
def test_tensor_core_reduces_at_the_arxiv_width_match_plain(cuda, heads):
    """bf16 at M = D = 256 on 20,000 rows (several slices a tile): the whole
    attention's forward and gradients through the kernels against autograd
    of the plain forward (bf16 tolerance of each output's scale), and each
    head's reduce and backward reduce against the f64 plain version."""
    n = 20_000
    q, k, v, g = (torch.randn(n, heads, 256, device=cuda).to(torch.bfloat16) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = attn.fused_linear_attention(*leaves)
    want = linear_attention(*leaves)
    torch.testing.assert_close(out.float(), want.float(), **TOL[torch.bfloat16])
    got_g = torch.autograd.grad(out, leaves, g)
    for a, b in zip(got_g, torch.autograd.grad(want, leaves, g)):
        _check_rel(a, b, BWD_REL[torch.bfloat16])
    n_t = torch.full((), float(n), device=cuda)
    for h in range(heads):
        got = attn.reduce(q[:, h], k[:, h], v[:, h])
        _f64_reduce_close(got, q[:, h], k[:, h], v[:, h])
        sums = attn.reduce_plain(q[:, h], k[:, h], v[:, h], False)
        _f64_bwd_reduce_close(attn.bwd_reduce(q[:, h], v[:, h], g[:, h], *sums, n_t),
                              q[:, h], v[:, h], g[:, h], *sums, n_t)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tensor_core_reduces_masked_and_all_masked(cuda, dtype):
    """bf16 and f32 (3xTF32), two heads: a partly masked group through the
    kernels against the plain forward and its autograd; an all-masked group
    gives finite zeros forward and backward (zero norms: inv = 0, den taken
    as 1)."""
    n = 3000
    q, k, v, g = (torch.randn(n, 2, 64, device=cuda).to(dtype) for _ in range(4))
    for mask in ((torch.arange(n, device=cuda) % 5 != 2).float(), torch.zeros(n, device=cuda)):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = attn.fused_linear_attention(*leaves, node_mask=mask)
        got = torch.autograd.grad(out, leaves, g)
        if not mask.any():
            assert all(torch.isfinite(t).all() and not t.any() for t in (out, *got))
            continue
        want = linear_attention(*leaves, node_mask=mask)
        torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
        for a, b in zip(got, torch.autograd.grad(want, leaves, g)):
            _check_rel(a, b, BWD_REL[dtype])


def test_all_masked_attention_gradients_are_finite_zeros(cuda):
    leaves = [torch.randn(500, 2, 32, device=cuda).requires_grad_() for _ in range(3)]
    out = attn.fused_linear_attention(*leaves, node_mask=torch.zeros(500, device=cuda))
    for t in torch.autograd.grad(out, leaves, torch.randn_like(out)):
        assert torch.isfinite(t).all() and not t.any()


def test_apply_design_names_the_kernel(cuda):
    """The forward apply runs on the tensor cores at the bench width and
    wherever its q tile fits one block's shared memory: bf16 by wgmma
    (``la_apply_wgmma_kernel``, persistent, fed by TMA) up to M = 704, f32
    in 3xTF32 by wgmma (``la_apply_wg_kernel``) up to M = 256 (at any D);
    beyond that on the CUDA cores."""
    for m, d in ((256, 256), (8, 72), (704, 40)):
        bf16 = attn.apply_design(torch.bfloat16, m, d)
        assert bf16.startswith("tensor cores (wgmma") and "la_apply_wgmma_kernel" in bf16, bf16
        assert "persistent, fed by TMA" in bf16, bf16
        f32 = attn.apply_design(torch.float32, m, d)
        assert f32.startswith("tensor cores (wgmma 3xTF32") == (m <= 256), f32
        assert ("la_apply_wg_kernel" in f32) == (m <= 256), f32
    assert attn.apply_design(torch.float32, 256, 999).startswith("tensor cores (wgmma 3xTF32")
    assert attn.apply_design(torch.float32, 257, 64).startswith("CUDA cores")
    assert attn.apply_design(torch.bfloat16, 705, 64).startswith("CUDA cores")


def test_bwd_apply_design_names_the_kernel(cuda):
    """The backward apply runs on the tensor cores wherever its tiles fit
    one block's shared memory: f32 in 3xTF32 by wgmma
    (``la_bwd_apply_ws_kernel``, persistent, fed by TMA from a producer
    warpgroup) up to M, D = 256; bf16 by wgmma, persistent
    (``la_bwd_apply_ws16_kernel``, its A slots) up to M, D = 256 and above
    that (``la_bwd_apply_wgmma_kernel``) up to 704; beyond that on the CUDA
    cores."""
    for m, d in ((256, 256), (8, 72), (37, 256), (256, 19)):
        f32 = attn.bwd_apply_design(torch.float32, m, d)
        assert f32.startswith("tensor cores (wgmma 3xTF32") and "la_bwd_apply_ws_kernel" in f32
        assert "persistent, fed by TMA" in f32, f32
        bf16 = attn.bwd_apply_design(torch.bfloat16, m, d)
        assert bf16.startswith("tensor cores (wgmma bf16") and "la_bwd_apply_ws16_kernel" in bf16
        assert "persistent, fed by TMA" in bf16, bf16
    for m, d in ((257, 64), (64, 257), (704, 704)):
        if max(m, d) == 257:
            assert attn.bwd_apply_design(torch.float32, m, d).startswith("CUDA cores")
        bf16 = attn.bwd_apply_design(torch.bfloat16, m, d)
        assert bf16.startswith("tensor cores (wgmma bf16") and "la_bwd_apply_wgmma_kernel" in bf16
    assert attn.bwd_apply_design(torch.bfloat16, 705, 64).startswith("CUDA cores")


def _on_view(view, t):
    """t's values in a layout the kernels may get rows in: contiguous, head 1
    of [N, 2, w + 8] (for widths of whole 16 bytes, 16-byte aligned rows and
    base: tensor maps that clip at an odd width), head 1 of [N, 2, w + 3]
    (strides no tensor map takes: the producer's lanes copy them) or rows
    one element off 16-byte alignment."""
    n, w = t.shape
    if view == "contiguous":
        return t.contiguous()
    if view == "unaligned":
        out = torch.empty(n * w + 1, dtype=t.dtype, device=t.device)[1:].view(n, w)
    else:
        pad = 8 if view == "aligned head" else 3
        out = torch.empty(n, 2, w + pad, dtype=t.dtype, device=t.device)[:, 1, :w]
    return out.copy_(t)


def _out_views(n, widths, dtype, cuda):
    """Outputs of n rows as views of the first n rows of allocations 200
    rows longer, filled with NaN: a kernel that stores rows past N (a
    tensor map whose extent is the allocation's) changes the rows after."""
    bufs = [torch.full((n + 200, w), float("nan"), dtype=dtype, device=cuda) for w in widths]
    return bufs, [b[:n] for b in bufs]


@pytest.mark.parametrize("m,d", [(256, 256), (64, 64), (37, 36), (200, 37), (704, 40),
                                 (640, 130), (8, 999)])
@pytest.mark.parametrize("view", ["contiguous", "aligned head", "strided", "unaligned"])
@pytest.mark.parametrize("n", [777, 1, 60_000])
def test_bf16_wgmma_forward_apply_on_views(cuda, m, d, view, n):
    """The bf16 apply on warpgroup MMAs fed by the copy engine
    (``la_apply_wgmma_kernel``, both layouts of its shared memory: two q
    buffers at M <= 256, one at 640 and 704) with tail rows (N = 777), at
    N = 1 and at N = 60,000 (469 row blocks: each of the 132 persistent
    blocks takes at least 3, so q buffers, den and v tiles are reused, with
    one column tile a row block at D <= 64, where den is still being formed
    when the MMAs are done), on q and v as they come (``_on_view``), on
    random rows and
    where q @ kvs carries the output (``apply_product_inputs``), against
    ``apply_plain`` in f64 at the bf16 tolerance; out as the op allocates it
    and as a view of a longer allocation whose rows past N keep their NaN;
    bitwise repeatable, one launch a call."""
    gen = torch.Generator(device=cuda).manual_seed(m + d + n)
    assert "la_apply_wgmma_kernel" in attn.apply_design(torch.bfloat16, m, d)
    q, k, v = (_on_view(view, torch.randn(n, w, generator=gen, device=cuda).bfloat16())
               for w in (m, m, d))
    sums = attn.reduce_plain(q, k, v, False)
    n_t = torch.full((), float(n), device=cuda)
    prod = apply_product_inputs(n, m, d, torch.bfloat16, gen, True)
    for ins in ((q, v, *sums, n_t), (_on_view(view, prod[0]), _on_view(view, prod[1]),
                                     *prod[2:])):
        want = attn.apply_plain(*(t.double() for t in ins), False)
        a0 = attn.apply_launches
        got = attn.apply(*ins)
        assert attn.apply_launches == a0 + 1
        torch.testing.assert_close(got.double(), want, **TOL[torch.bfloat16])
        assert torch.equal(got, attn.apply(*ins))
        (buf,), (out,) = _out_views(n, (d,), torch.bfloat16, cuda)
        attn.apply(*ins, out=out)
        assert torch.equal(out, got) and buf[n:].isnan().all()


@pytest.mark.parametrize("m,d", [(256, 256), (37, 36), (200, 37), (256, 40), (8, 250),
                                 (130, 200)])
@pytest.mark.parametrize("view", ["contiguous", "aligned head", "strided", "unaligned"])
@pytest.mark.parametrize("n", [777, 1, 20_000])
def test_f32_ws_backward_apply_on_views(cuda, m, d, view, n):
    """The f32 backward apply on warpgroup MMAs fed by the copy engine
    (``la_bwd_apply_ws_kernel``: A rows streamed into slots that the item
    before frees atom by atom; M != D hands the slots past a product's
    depth over empty) with tail rows (N = 777), at N = 1 and at N = 20,000
    (471 (row block, product) items: each of the 132 persistent blocks takes
    at least 3, so A slots, B stages and epilogue tiles pass from item to
    item, across products of different depths where M != D), on its inputs
    as they come (``_on_view``), where its three products carry dq, dk
    and dv (``bwd_product_inputs``), against ``bwd_apply_plain`` in f64
    within 1e-5 of each output's scale, and on random rows at N > 1;
    outputs as the wrapper allocates them and as views of longer
    allocations whose rows past N keep their NaN; bitwise repeatable, one
    launch a call."""
    gen = torch.Generator(device=cuda).manual_seed(m + d + n)
    assert "la_bwd_apply_ws_kernel" in attn.bwd_apply_design(torch.float32, m, d)
    kinds = [bwd_product_inputs(n, m, d, torch.float32, gen)]
    if n > 1:
        q, k, v, g = (torch.randn(n, w, generator=gen, device=cuda) for w in (m, m, d, d))
        sums = attn.reduce_plain(q, k, v, False)
        n_t = torch.full((), float(n), device=cuda)
        kinds.append((q, k, v, g, *sums, n_t, *attn.bwd_reduce_plain(q, v, g, *sums, n_t,
                                                                      False)))
    for ins in kinds:
        ins = (*(_on_view(view, t) for t in ins[:4]), *ins[4:])
        exact = attn.bwd_apply_plain(*(t.double() for t in ins), False)
        a0 = attn.bwd_apply_launches
        got = attn.bwd_apply(*ins)
        assert attn.bwd_apply_launches == a0 + 1
        for a, b in zip(got, exact):
            _check_rel(a, b, BWD_REL[torch.float32])
        assert all(torch.equal(a, b) for a, b in zip(got, attn.bwd_apply(*ins)))
        bufs, outs = _out_views(n, (m, m, d), torch.float32, cuda)
        attn.bwd_apply(*ins, out=tuple(outs))
        assert all(torch.equal(a, b) for a, b in zip(outs, got))
        assert all(b[n:].isnan().all() for b in bufs)


@pytest.mark.parametrize("which", ["bf16 forward apply", "f32 backward apply",
                                   "bf16 backward apply"])
def test_redesigned_applies_all_masked_give_finite_zeros(cuda, which):
    """Zero norms through the bf16 forward apply and the f32 and bf16
    backward applies at the bench width: inv = 0, a zero den taken as 1, so
    finite zero outputs and gradients on every column tile."""
    dtype = torch.bfloat16 if which.startswith("bf16") else torch.float32
    leaves = [torch.randn(777, 1, 256, device=cuda).to(dtype).requires_grad_()
              for _ in range(3)]
    out = attn.fused_linear_attention(*leaves, node_mask=torch.zeros(777, device=cuda))
    assert torch.isfinite(out).all() and not out.any()
    if which.endswith("backward apply"):
        grads = torch.autograd.grad(out, leaves, torch.randn_like(out))
        assert all(torch.isfinite(t).all() and not t.any() for t in grads)


# sha256 (16 hex digits) of the outputs of the bf16 forward apply and the f32
# and bf16 backward applies of the kernels these replaced (the bf16 backward
# apply's: la_bwd_apply_wgmma_kernel), on host-made inputs of N rows
# (``_host_apply_inputs``), read on an NVIDIA H100 80GB HBM3
EARLIER_APPLY_DIGESTS = {("bf16 forward apply", 2000): "882404fec194b1e4",
                         ("bf16 forward apply", 60_000): "cc5d1ddbde0d0bb8",
                         ("f32 backward apply", 2000): "309bb2ffbe641596",
                         ("f32 backward apply", 20_000): "b2a4d39c4f9ceb2a",
                         ("bf16 backward apply", 2000): "250752a52042f994",
                         ("bf16 backward apply", 60_000): "d696e22d4aa6037b"}


def _host_apply_inputs(dtype, n):
    """q, k, v, g [n, 256] of ``dtype`` from numpy (seed 27) and the plain
    reduces' outputs, all made on the host, so that only the apply kernels
    make the digested outputs."""
    rng = np.random.default_rng(27)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((n, 256)).astype(np.float32)).to(dtype)
                  for _ in range(4))
    sums = attn.reduce_plain(q, k, v, False)
    n_t = torch.tensor(float(n))
    return q, k, v, g, sums, n_t


@pytest.mark.parametrize("which,n", list(EARLIER_APPLY_DIGESTS))
def test_redesigned_applies_are_bitwise_the_earlier_kernels(cuda, which, n):
    """The redesigned kernels keep the arithmetic of the kernels they
    replaced (the products' k order, the fresh-sum periods, den and the
    epilogue's terms), so their outputs are bitwise those kernels', also
    where each persistent block takes several row blocks or items (N =
    60,000 forward and bf16 backward, 20,000 f32 backward)."""
    import hashlib

    dtype = torch.bfloat16 if which.startswith("bf16") else torch.float32
    q, k, v, g, sums, n_t = _host_apply_inputs(dtype, n)
    if which == "bf16 forward apply":
        got = [attn.apply(*(t.to(cuda) for t in (q, v, *sums, n_t)))]
    else:
        red = attn.bwd_reduce_plain(q, v, g, *sums, n_t, False)
        got = attn.bwd_apply(*(t.to(cuda) for t in (q, k, v, g, *sums, n_t, *red[:3])),
                             red[3].to(cuda))
    sha = hashlib.sha256(b"".join(t.reshape(-1).cpu().view(torch.uint8).numpy().tobytes()
                                  for t in got)).hexdigest()[:16]
    assert sha == EARLIER_APPLY_DIGESTS[which, n]


@pytest.mark.parametrize("m,d", [(256, 256), (64, 64), (37, 36), (200, 37), (130, 200),
                                 (8, 250), (256, 40), (704, 40), (640, 130)])
@pytest.mark.parametrize("view", ["contiguous", "aligned head", "strided", "unaligned"])
@pytest.mark.parametrize("n", [777, 60_000])
def test_bf16_ws_backward_apply_on_views(cuda, m, d, view, n):
    """The bf16 backward apply, persistent up to M, D = 256
    (``la_bwd_apply_ws16_kernel``: items of 256 rows and one product, A rows
    streamed into slots that the item before frees, M != D handing the
    slots past a product's depth over empty, B chunks and the epilogue
    operand's halves through one ring, each warpgroup's 128 rows stored
    apart) and above that up to 704 (``la_bwd_apply_wgmma_kernel``), with
    tail rows (N = 777: the last item's second warpgroup holds rows past N)
    and at N = 60,000 (705 items: each of the 132 persistent blocks takes
    at least 5, so slots, stages and halves pass from item to item, across
    products of different depths where M != D), on its inputs as they come
    (``_on_view``): where its three products carry dq, dk and dv
    (``bwd_product_inputs``) and on random rows, against
    ``bwd_apply_plain`` in f64 within the bf16 tolerance of each output's
    scale; outputs as the wrapper allocates them and as views of longer
    allocations whose rows past N keep their NaN; bitwise repeatable, one
    launch a call."""
    gen = torch.Generator(device=cuda).manual_seed(m + d + n)
    kernel = "la_bwd_apply_ws16_kernel" if max(m, d) <= 256 else "la_bwd_apply_wgmma_kernel"
    assert kernel in attn.bwd_apply_design(torch.bfloat16, m, d)
    q, k, v, g = (torch.randn(n, w, generator=gen, device=cuda).bfloat16() for w in (m, m, d, d))
    sums = attn.reduce_plain(q, k, v, False)
    n_t = torch.full((), float(n), device=cuda)
    kinds = [bwd_product_inputs(n, m, d, torch.bfloat16, gen),
             (q, k, v, g, *sums, n_t, *attn.bwd_reduce_plain(q, v, g, *sums, n_t, False))]
    for ins in kinds:
        ins = (*(_on_view(view, t) for t in ins[:4]), *ins[4:])
        exact = attn.bwd_apply_plain(*(t.double() for t in ins), False)
        a0 = attn.bwd_apply_launches
        got = attn.bwd_apply(*ins)
        assert attn.bwd_apply_launches == a0 + 1
        for a, b in zip(got, exact):
            _check_rel(a, b, BWD_REL[torch.bfloat16])
        assert all(torch.equal(a, b) for a, b in zip(got, attn.bwd_apply(*ins)))
        bufs, outs = _out_views(n, (m, m, d), torch.bfloat16, cuda)
        attn.bwd_apply(*ins, out=tuple(outs))
        assert all(torch.equal(a, b) for a, b in zip(outs, got))
        assert all(b[n:].isnan().all() for b in bufs)


@pytest.mark.parametrize("m,d", [(256, 256), (37, 19), (200, 37), (130, 19), (8, 250),
                                 (256, 40)])
@pytest.mark.parametrize("view", ["contiguous", "aligned head", "strided", "unaligned"])
@pytest.mark.parametrize("n", [777, 60_000])
def test_f32_ws_rows_pass_on_views(cuda, m, d, view, n):
    """The f32 backward reduce with its rows pass on warpgroup MMAs fed by
    the copy engine (``la_bwd_rows_ws_kernel``: persistent, the next row
    block's q rows streamed into slots that this one frees atom by atom, b
    and sum g*v on the producer's spare warps) with tail rows (N = 777) and
    at N = 60,000 (469 row blocks: each of the 132 persistent blocks takes
    at least 3, so q slots, kvs^T stages, g tiles and the row sums pass from
    row block to row block), on q, v and g as they come (``_on_view``): on
    random rows, where q @ kvs carries den's partner terms
    (``bwd_product_inputs``), on a masked group (every third row zero, the
    guard on) and on one positive row (N = 1), each against
    ``bwd_reduce_plain`` in f64 within 1e-5 of each output's scale (dinv of
    its sums' magnitude), bitwise repeatable, one launch a call; and an
    all-masked group (zero norms: inv = 0, den taken as 1) as finite zeros
    and den 1."""
    gen = torch.Generator(device=cuda).manual_seed(m + d + n)
    assert "la_bwd_rows_ws_kernel" in attn.bwd_reduce_design(torch.float32, m, d)

    def rows(draw, n_rows):
        return [draw(n_rows, w, generator=gen, device=cuda) for w in (m, m, d, d)]

    q, k, v, g = rows(torch.randn, n)
    keep = (torch.arange(n, device=cuda) % 3 != 1).float()[:, None]
    qm, km, vm = q * keep, k * keep, v * keep
    q1, k1, v1, g1 = rows(torch.rand, 1)
    prod = bwd_product_inputs(n, m, d, torch.float32, gen)
    kinds = [((q, v, g, *attn.reduce_plain(q, k, v, False),
               torch.full((), float(n), device=cuda)), False),
             ((prod[0], prod[2], prod[3], *prod[4:8]), False),
             ((qm, vm, g, *attn.reduce_plain(qm, km, vm, True), keep.sum()), True),
             ((q1, v1, g1, *attn.reduce_plain(q1, k1, v1, False), torch.ones((), device=cuda)),
              False)]
    for ins, guard in kinds:
        ins = (*(_on_view(view, t) for t in ins[:3]), *ins[3:])
        b0 = attn.bwd_reduce_launches
        got = attn.bwd_reduce(*ins, guard)
        assert attn.bwd_reduce_launches == b0 + 1
        _f64_bwd_reduce_close(got, *ins, guard=guard)
        assert all(torch.equal(a, b) for a, b in zip(got, attn.bwd_reduce(*ins, guard)))
    zeros = [_on_view(view, torch.zeros(n, w, device=cuda)) for w in (m, m, d)]
    P, ds, dinv, (den, gden) = attn.bwd_reduce(
        zeros[0], zeros[2], _on_view(view, g), *attn.reduce_plain(*zeros, True),
        torch.zeros((), device=cuda), True)
    assert not (P.any() or ds.any() or dinv.any() or gden.any())
    assert torch.equal(den, torch.ones_like(den))


# sha256 (16 hex digits) of the f32 backward reduce's outputs (P, ds, dinv,
# den and gden) of the rows pass it replaced (la_bwd_rows_wg_kernel), on
# host-made inputs of N rows (``_host_apply_inputs``), read on an NVIDIA
# H100 80GB HBM3
EARLIER_ROWS_DIGESTS = {2000: "3a12ff8371b2fa27", 60_000: "55f20282fa8e105d"}


@pytest.mark.parametrize("n", list(EARLIER_ROWS_DIGESTS))
def test_redesigned_rows_pass_is_bitwise_the_earlier_kernel(cuda, n):
    """The redesigned rows pass keeps the arithmetic of the one it replaced
    (the products' k order and fresh-sum periods, the fold's chains and
    tree, b's two chains, den, gden and the dinv tree), so the reduce's
    outputs are bitwise that kernel's, also where each persistent block
    takes several row blocks (N = 60,000)."""
    import hashlib

    q, _, v, g, sums, n_t = _host_apply_inputs(torch.float32, n)
    got = attn.bwd_reduce(*(t.to(cuda) for t in (q, v, g, *sums, n_t)))
    sha = hashlib.sha256(b"".join(t.reshape(-1).cpu().view(torch.uint8).numpy().tobytes()
                                  for t in got)).hexdigest()[:16]
    assert sha == EARLIER_ROWS_DIGESTS[n]


@pytest.mark.parametrize("m,d", [(256, 256), (704, 40), (37, 19), (200, 37), (130, 200),
                                 (8, 250), (640, 130)])
@pytest.mark.parametrize("view", ["contiguous", "aligned head", "strided", "unaligned"])
@pytest.mark.parametrize("n", [777, 60_000])
def test_bf16_ws_reduce_on_views(cuda, m, d, view, n):
    """The bf16 backward reduce with its rows pass and P pass persistent
    (``la_bwd_rows_ws16_kernel``: the next row block's q rows streamed into
    slots that this one frees k-tile by k-tile, b on the producer's spare
    warps; ``la_bwd_reduce_ws16_kernel``) with tail rows (N = 777) and at N
    = 60,000 (469 row blocks: each of the 132 persistent blocks takes at
    least 3, so q slots, kvs^T stages, g tiles and the row sums pass from
    row block to row block), up to the widest q the rows pass takes (704:
    two stages, no g tile), on q, v and g as they come (``_on_view``): on
    random rows, where q @ kvs carries den's partner terms
    (``bwd_product_inputs``, and its ``cancel`` form, where a dropped lo
    piece of kvs^T would miss), on a masked group (every third row zero, the
    guard on) and on one positive row (N = 1), each against
    ``bwd_reduce_plain`` in f64 within 1e-5 of each output's scale (dinv of
    its sums' magnitude), bitwise repeatable, one launch a call; and an
    all-masked group (zero norms: inv = 0, den taken as 1) as finite zeros
    and den 1."""
    gen = torch.Generator(device=cuda).manual_seed(m + d + n)
    design = attn.bwd_reduce_design(torch.bfloat16, m, d)
    assert "la_bwd_rows_ws16_kernel" in design and "la_bwd_reduce_ws16_kernel" in design, design

    def rows(draw, n_rows):
        return [draw(n_rows, w, generator=gen, device=cuda).bfloat16() for w in (m, m, d, d)]

    q, k, v, g = rows(torch.randn, n)
    keep = (torch.arange(n, device=cuda) % 3 != 1).bfloat16()[:, None]
    qm, km, vm = q * keep, k * keep, v * keep
    q1, k1, v1, g1 = rows(torch.rand, 1)
    kinds = [((q, v, g, *attn.reduce_plain(q, k, v, False),
               torch.full((), float(n), device=cuda)), False),
             ((qm, vm, g, *attn.reduce_plain(qm, km, vm, True), keep.float().sum()), True),
             ((q1, v1, g1, *attn.reduce_plain(q1, k1, v1, False), torch.ones((), device=cuda)),
              False)]
    for cancel in (False, True):
        prod = bwd_product_inputs(n, m, d, torch.bfloat16, gen, cancel)
        kinds.append(((prod[0], prod[2], prod[3], *prod[4:8]), False))
    for ins, guard in kinds:
        ins = (*(_on_view(view, t) for t in ins[:3]), *ins[3:])
        b0 = attn.bwd_reduce_launches
        got = attn.bwd_reduce(*ins, guard)
        assert attn.bwd_reduce_launches == b0 + 1
        _f64_bwd_reduce_close(got, *ins, guard=guard)
        assert all(torch.equal(a, b) for a, b in zip(got, attn.bwd_reduce(*ins, guard)))
    zeros = [_on_view(view, torch.zeros(n, w, device=cuda).bfloat16()) for w in (m, m, d)]
    P, ds, dinv, (den, gden) = attn.bwd_reduce(
        zeros[0], zeros[2], _on_view(view, g), *attn.reduce_plain(*zeros, True),
        torch.zeros((), device=cuda), True)
    assert not (P.any() or ds.any() or dinv.any() or gden.any())
    assert torch.equal(den, torch.ones_like(den))


def test_bf16_bwd_reduce_design_names_the_kernels(cuda):
    """The bf16 backward reduce runs its persistent rows pass and P pass
    wherever the rows pass's q slots and two kvs^T stages fit one block's
    shared memory (M up to 704, any D), else the CUDA-core passes."""
    for m, d in ((256, 256), (8, 72), (704, 40), (640, 999), (37, 19)):
        bf16 = attn.bwd_reduce_design(torch.bfloat16, m, d)
        assert bf16.startswith("tensor cores (wgmma bf16"), bf16
        assert "la_bwd_rows_ws16_kernel" in bf16 and "la_bwd_reduce_ws16_kernel" in bf16, bf16
        assert "persistent" in bf16, bf16
    assert attn.bwd_reduce_design(torch.bfloat16, 705, 64).startswith("CUDA cores")


# sha256 (16 hex digits) of the bf16 backward reduce's outputs (P, ds, dinv,
# den and gden) of the passes these replaced (la_bwd_rows_wgmma_kernel and
# la_bwd_reduce_wgmma_kernel), on host-made inputs of N rows
# (``_host_bf16_reduce_inputs``), read on an NVIDIA H100 80GB HBM3
EARLIER_BF16_REDUCE_DIGESTS = {2000: "8b766824f5491e9f", 60_000: "4b2b912e1791940a"}


def _host_bf16_reduce_inputs(n):
    """The bf16 backward reduce's arguments made on the host, as
    ``chip_compare.py``'s ``host_bf16_inputs`` makes them: q, v, g [n, 256]
    bf16 from numpy (seed 28), and kvs, ksum and the scalars of k's and
    those rows summed in f64 and rounded to f32 once."""
    rng = np.random.default_rng(28)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((n, 256)).astype(np.float32))
                  .to(torch.bfloat16) for _ in range(4))
    qd, kd, vd = q.double(), k.double(), v.double()
    q_sq, k_sq = qd.square().sum(), kd.square().sum()
    scal = torch.stack([q_sq, k_sq, 1.0 / (q_sq.sqrt() * k_sq.sqrt()),
                        torch.zeros((), dtype=torch.float64)]).float()
    return q, v, g, (kd.T @ vd).float(), kd.sum(0).float(), scal, torch.tensor(float(n))


@pytest.mark.parametrize("n", list(EARLIER_BF16_REDUCE_DIGESTS))
def test_redesigned_bf16_reduce_is_bitwise_the_earlier_kernels(cuda, n):
    """The redesigned rows pass and P pass keep the arithmetic of the ones
    they replaced (the rows pass's products, fresh sums, fold chains and
    tree, b's two chains, den, gden and the dinv tree; the P pass's 32-row
    fresh sums, gd = g * (1/den) as hi + lo, the slice partials and ds's
    four f64 chains), so the reduce's outputs are bitwise those kernels',
    also where each persistent block takes several row blocks (N =
    60,000)."""
    import hashlib

    got = attn.bwd_reduce(*(t.to(cuda) for t in _host_bf16_reduce_inputs(n)))
    sha = hashlib.sha256(b"".join(t.reshape(-1).cpu().view(torch.uint8).numpy().tobytes()
                                  for t in got)).hexdigest()[:16]
    assert sha == EARLIER_BF16_REDUCE_DIGESTS[n]


@pytest.mark.parametrize("m,d", [(256, 256), (37, 36), (200, 37), (8, 999), (256, 40)])
@pytest.mark.parametrize("view", ["contiguous", "aligned head", "strided", "unaligned"])
def test_f32_wgmma_forward_apply_on_views(cuda, m, d, view):
    """The f32 apply on warpgroup MMAs fed by the copy engine, with tail rows
    (N = 777), on q and v as they come: contiguous, head 1 of [N, 2, w + 4]
    (16-byte aligned rows and base: tensor maps that clip at an odd width,
    so a box never reads the next head's columns), head 1 of [N, 2, w + 3]
    (strides no tensor map takes: the producer's lanes copy the rows) and
    rows one element off 16-byte alignment; out as the op allocates it
    (tensor-map stores where D % 4 == 0, clipped to D) and as a strided
    view. Against ``apply_plain`` in f64 at the f32 tolerance, bitwise
    repeatable, one launch a call."""
    n = 777
    gen = torch.Generator(device=cuda).manual_seed(m + d)

    def rows(w):
        if view == "contiguous":
            return torch.randn(n, w, generator=gen, device=cuda)
        if view == "unaligned":
            return torch.randn(n * w + 1, generator=gen, device=cuda)[1:].view(n, w)
        pad = 4 if view == "aligned head" else 3
        return torch.randn(n, 2, w + pad, generator=gen, device=cuda)[:, 1, :w]

    q, k, v = rows(m), rows(m), rows(d)
    sums = attn.reduce_plain(q, k, v, False)
    n_t = torch.full((), float(n), device=cuda)
    want = attn.apply_plain(*(t.double() for t in (q, v, *sums, n_t)), False)
    a0 = attn.apply_launches
    got = attn.apply(q, v, *sums, n_t)
    assert attn.apply_launches == a0 + 1
    torch.testing.assert_close(got.double(), want, **TOL[torch.float32])
    assert torch.equal(got, attn.apply(q, v, *sums, n_t))
    out = torch.full((n, 2, d + 4), float("nan"), device=cuda)[:, 1, :d]
    attn.apply(q, v, *sums, n_t, out=out)
    assert torch.equal(out, got)


def test_f32_wgmma_forward_apply_all_masked_is_finite_zero(cuda):
    """Zero norms through the f32 apply at the bench width: inv = 0, a zero
    den taken as 1, so finite zeros, on every column tile."""
    q, k, v = (torch.randn(777, 1, 256, device=cuda) for _ in range(3))
    got = attn.fused_linear_attention(q, k, v, node_mask=torch.zeros(777, device=cuda))
    assert torch.isfinite(got).all() and not got.any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,d", [(8, 256), (72, 200), (200, 72), (256, 8), (256, 256)])
@pytest.mark.parametrize("strided", [False, True])
def test_tensor_core_forward_apply_takes_any_width(cuda, m, d, strided, dtype):
    """The forward apply, bf16 (wgmma) and f32 (3xTF32), on widths off its
    tiles, on the per-head views of [N, 2, *] tensors (strided: rows 3
    elements longer, so no 16-byte copies), with tail rows (N = 777): at
    n = N on random inputs and at n = 1 on positive ones (q @ kvs carries
    the output there), against ``apply_plain`` at the type's tolerance, f32
    against it evaluated in f64 at n = 1 (its own f32 error printed beside
    it); bitwise repeatable, one launch a call."""
    n, pad = 777, 3 if strided else 0
    assert attn.apply_design(dtype, m, d).startswith("tensor cores")

    def heads(draw, w):  # head 1 of an [n, 2, w + pad] tensor
        return draw(n, 2, w + pad, device=cuda).to(dtype)[:, 1, :w]

    for draw, n_total in ((torch.randn, float(n)), (torch.rand, 1.0)):
        q, k, v = heads(draw, m), heads(draw, m), heads(draw, d)
        sums = attn.reduce_plain(q, k, v, False)
        n_t = torch.full((), n_total, device=cuda)
        out = torch.empty(n, 2, d + pad, dtype=dtype, device=cuda)[:, 0, :d]
        a0 = attn.apply_launches
        got = attn.apply(q, v, *sums, n_t, out=out)
        assert attn.apply_launches == a0 + 1
        want = attn.apply_plain(q, v, *sums, n_t, False)
        if dtype == torch.float32 and n_total == 1.0:
            exact = attn.apply_plain(*(t.double() for t in (q, v, *sums, n_t)), False)
            err, scale = rel_err(want, exact)
            print(f"m={m} d={d}: the f32 plain version, {err / scale:.2e} of the scale "
                  f"off its f64 evaluation")
            want = exact
        torch.testing.assert_close(got.double(), want.double(), **TOL[dtype])
        assert torch.equal(got, attn.apply(q, v, *sums, n_t))


@pytest.mark.parametrize("m,d", [(8, 256), (72, 200), (200, 72), (256, 256)])
@pytest.mark.parametrize("dtype,cancel", [(torch.bfloat16, False), (torch.bfloat16, True),
                                          (torch.float32, False)])
def test_tensor_core_forward_apply_carries_the_product(cuda, m, d, dtype, cancel):
    """The forward apply where q @ kvs carries the output and every (m, d)
    pairing of kvs moves it (``apply_product_inputs``: in f32, one TF32
    product, the lo pieces dropped, would miss the f32 tolerance ~10x; in
    bf16 with ``cancel`` large kvs terms cancel, so that kvs rounded to
    bf16 would miss the bf16 one), with tail rows (N = 777), against
    ``apply_plain`` in f64 at the type's tolerance."""
    gen = torch.Generator(device=cuda).manual_seed(m + d)
    ins = apply_product_inputs(777, m, d, dtype, gen, cancel)
    got = attn.apply(*ins)
    want = attn.apply_plain(*(t.double() for t in ins), False)
    torch.testing.assert_close(got.double(), want, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tensor_core_forward_apply_unaligned_rows_take_the_scalar_path(cuda, dtype):
    """Rows one element off 16-byte alignment (no 16-byte copies of q, v or
    out), through the tensor-core reduce and apply against their plain
    versions (the apply's in f64)."""
    n, m = 500, 64
    flat = torch.rand(3, n * m + 1, device=cuda).to(dtype)
    q, k, v = (t[1:].view(n, m) for t in flat)  # contiguous, one element off 16-byte alignment
    assert q.is_contiguous() and q.data_ptr() % 16 != 0
    one = torch.ones((), device=cuda)
    _f64_reduce_close(attn.reduce(q, k, v), q, k, v)
    sums = attn.reduce_plain(q, k, v, False)
    got = attn.apply(q, v, *sums, one)
    want = attn.apply_plain(*(t.double() for t in (q, v, *sums, one)), False)
    torch.testing.assert_close(got.double(), want, **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_all_masked_bf16_attention_is_finite_zero(cuda, dtype):
    """bf16 and f32 through the tensor-core apply: zero norms give inv = 0
    and a zero den taken as 1, so the output is finite zeros."""
    q, k, v = (torch.randn(500, 2, 40, device=cuda).to(dtype) for _ in range(3))
    got = attn.fused_linear_attention(q, k, v, node_mask=torch.zeros(500, device=cuda))
    assert torch.isfinite(got).all() and not got.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("undirected", [True, False])
def test_spmm_gradient_runs_the_kernel_on_the_transpose(cuda, dtype, undirected):
    rng = np.random.default_rng(3)
    n = 700
    ei = rng.integers(0, n, (2, 4000))
    g = preprocess_graph(ei, n, undirected=undirected, device=cuda)
    x = torch.randn(n, 40, device=cuda).to(dtype).requires_grad_()
    w = torch.randn(n, 40, device=cuda).to(dtype)
    before = kernels.spmm.launches
    got = torch.autograd.grad(g.propagate(x), x, w)[0]
    assert kernels.spmm.launches == before + 2
    want = torch.autograd.grad(spmm(x, g.edge_src, g.edge_dst, g.gcn_weight, n), x, w)[0]
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_train_steps_on_the_card_match_the_cpu(cuda):
    from sgformer_tpu_torch.train import TrainConfig, Trainer

    rng = np.random.default_rng(4)
    n = 900
    ei = rng.integers(0, n, (2, 5000))
    x = rng.standard_normal((n, 24)).astype(np.float32)
    label = rng.integers(0, 5, (n, 1))
    cfg = SGFormerConfig.large(64, 5, gnn_num_layers=3, trans_dropout=0.0, gnn_dropout=0.0)
    tc = TrainConfig(lr=1e-2, trans_weight_decay=1e-3, gnn_weight_decay=5e-4)
    losses = {}
    for dev in ("cpu", "cuda"):
        model = SGFormer(cfg, 24, device=dev)
        trainer = Trainer(model, preprocess_graph(ei, n, device=dev), x, label, tc, device=dev)
        trainer.init_state(0)
        idx = trainer.prepare_train_idx({"train": np.arange(0, n, 2)})
        losses[dev] = trainer.multi_step(idx, 4).cpu().numpy()
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    assert losses["cuda"][-1] < losses["cuda"][0]


def _edge_value_graph(cuda, chunk_dtype="f32"):
    """No self-loops and a directed edge list: rows 680-699 are empty, node
    5 has an in-degree above 64."""
    rng = np.random.default_rng(5)
    n = 700
    ei = np.concatenate([rng.integers(0, n - 20, (2, 3000)),
                         np.stack([np.arange(70), np.full(70, 5)])], axis=1)
    return preprocess_graph(ei, n, undirected=False, self_loops=False,
                            chunk_dtype=chunk_dtype, device=cuda)


@pytest.mark.parametrize("msg_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,d", [(1, 40), (2, 256), (2, 40), (1, 256), (3, 37)])
def test_edge_value_kernels_match_plain(cuda, msg_dtype, heads, d):
    """csr_spmm_ev (f32 and bf16 messages, f32 and message-type results) and
    sddmm against their plain versions on the same inputs: the f32 sums
    differ in order only (1e-5), a bf16 result by one rounding; both are
    bitwise repeatable."""
    g = _edge_value_graph(cuda)
    n, e = g.num_nodes, g.num_edges
    assert (g.indptr[1:] == g.indptr[:-1]).any()  # empty rows
    x = torch.randn(n, heads, d, device=cuda)
    v = torch.rand(e, heads, device=cuda)
    xm = x.to(msg_dtype)
    csr = (g.indptr, g.edge_src, g.edge_dst)
    for out_dtype in (torch.float32, msg_dtype):
        before = spmm_kernel.ev_launches
        got = csr_spmm_ev(xm, *csr, v, out_dtype)
        assert spmm_kernel.ev_launches == before + 1 and got.dtype == out_dtype
        want = spmm_edge_values(xm, g.edge_src, g.edge_dst, v, n, out_dtype)
        torch.testing.assert_close(got.float(), want.float(), **TOL[out_dtype])
        assert torch.equal(got, csr_spmm_ev(xm, *csr, v, out_dtype))
    grad = torch.randn(n, heads, d, device=cuda).to(msg_dtype)
    before = spmm_kernel.sddmm_launches
    dv = sddmm(grad, xm, *csr)
    assert spmm_kernel.sddmm_launches == before + 1 and dv.dtype == torch.float32
    _check_rel(dv, sddmm_plain(grad.float(), xm.float(), g.edge_src, g.edge_dst), 1e-5)
    assert torch.equal(dv, sddmm(grad, xm, *csr))


def test_edge_value_kernel_with_one_head_is_csr_spmm(cuda):
    g = _edge_value_graph(cuda)
    x = torch.randn(g.num_nodes, 64, device=cuda)
    csr = (g.indptr, g.edge_src, g.edge_dst)
    got = csr_spmm_ev(x[:, None], *csr, g.gcn_weight[:, None].contiguous())
    assert torch.equal(got[:, 0], csr_spmm(x, *csr, g.gcn_weight))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [8, 16, 32, 40, 64, 128])
def test_narrow_walk_through_hub_plans(cuda, dtype, d):
    """The row walk in lane groups (a head of at most 128 columns on the
    16-byte path) through hub plans of several lengths: csr_spmm and
    csr_spmm_ev (two heads, f32 result) against their plain versions,
    bitwise repeatable, and H = 1 csr_spmm_ev bitwise csr_spmm of the same
    values under each plan."""
    g = _edge_value_graph(cuda)
    n, e = g.num_nodes, g.num_edges
    csr = (g.indptr, g.edge_src, g.edge_dst)
    x = torch.randn(n, 2, d, device=cuda).to(dtype)
    v = torch.rand(e, 2, device=cuda)
    x1, v1 = x[:, 0].contiguous(), v[:, 0].contiguous()
    want = spmm(x1, g.edge_src, g.edge_dst, v1, n)
    want_ev = spmm_edge_values(x, g.edge_src, g.edge_dst, v, n, torch.float32)
    for length in EV_SEGMENT_LENGTHS:
        plan = spmm_kernel.hub_plan(g.indptr, length)
        got = csr_spmm(x1, *csr, v1, plan, length)
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
        assert torch.equal(got, csr_spmm(x1, *csr, v1, plan, length)), length
        one = csr_spmm_ev(x1[:, None], *csr, v1[:, None], dtype, plan, length)
        assert torch.equal(one[:, 0], got), length
        got_ev = csr_spmm_ev(x, *csr, v, torch.float32, plan, length)
        torch.testing.assert_close(got_ev, want_ev, **TOL[torch.float32])
        assert torch.equal(got_ev, csr_spmm_ev(x, *csr, v, torch.float32, plan, length)), length


def _ev_counts(since=(0, 0, 0)):
    """Launches of csr_spmm_ev, csr_spmm_ev_bwd and sddmm (since ``since``)."""
    now = (spmm_kernel.ev_launches, spmm_kernel.ev_bwd_launches, spmm_kernel.sddmm_launches)
    return tuple(a - b for a, b in zip(now, since))


# hub segment lengths of the backward's card tests: on _edge_value_graph
# (in-degree up to 77, out-degree up to 12) 16 and 32 split node 5's row of
# the dst-sorted CSR and 4 also most rows of the transposed one; 128 splits
# none
EV_SEGMENT_LENGTHS = (4, 16, 32, 128)


@pytest.mark.parametrize("x_dtype,msg_dtype", [(torch.float32, torch.float32),
                                               (torch.float32, torch.bfloat16),
                                               (torch.bfloat16, torch.float32),
                                               (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("heads,d", [(1, 40), (2, 256), (2, 40), (1, 256), (3, 37), (2, 16),
                                     (1, 128)])
def test_fused_edge_value_backward_matches_plain(cuda, x_dtype, msg_dtype, heads, d):
    """csr_spmm_ev_bwd through hub plans of several lengths, against
    spmm_edge_values_backward and the parent formulation on the same
    inputs: dv within 1e-5 of the plain version's scale, bitwise the
    dv-mode sddmm's with the dst-sorted CSR's plan of the same length, and
    the same under every plan; dx bitwise csr_spmm_ev on the transposed
    order with the same plan at every width (both walk in the same lane
    groups: D = 16, 40 and 128 take groups of 4, 8 and 16 lanes), and
    within 1e-5 of the plain version's scale (f32) or the output type's
    tolerance (bf16); each flag alone gives its half bit for bit; bitwise
    repeatable."""
    g = _edge_value_graph(cuda)
    n, e = g.num_nodes, g.num_edges
    csr = (g.indptr, g.edge_src, g.edge_dst)
    csr_t = (g.t_indptr, g.t_edge_src, g.t_edge_dst, g.t_perm)
    x = torch.randn(n, heads, d, device=cuda).to(x_dtype)
    cot = torch.randn(n, heads, d, device=cuda).to(x_dtype)
    v = torch.rand(e, heads, device=cuda)
    want_dx, want_dv = spmm_edge_values_backward(cot, x, v, g.t_edge_src, g.t_edge_dst,
                                                 g.t_perm, msg_dtype)
    v_t = v.index_select(0, g.t_perm.long())
    first_dv = None
    for length in EV_SEGMENT_LENGTHS:
        plan = spmm_kernel.hub_plan(g.indptr, length)
        t_plan = spmm_kernel.hub_plan(g.t_indptr, length)
        counts = _ev_counts()
        dx, dv = csr_spmm_ev_bwd(cot, x, v, *csr_t, msg_dtype, t_plan, length)
        assert _ev_counts(counts) == (0, 1, 0)
        assert dx.dtype == x_dtype and dv.dtype == torch.float32
        parent_dx = csr_spmm_ev(cot.to(msg_dtype), *csr_t[:3], v_t, x_dtype, t_plan, length)
        assert torch.equal(dx, parent_dx), length
        if x_dtype == torch.float32:
            _check_rel(dx, want_dx, 1e-5)
        else:
            torch.testing.assert_close(dx.float(), want_dx.float(), **TOL[x_dtype])
        _check_rel(dv, want_dv, 1e-5)
        assert torch.equal(dv, sddmm(cot, x, *csr, plan, length)), length
        first_dv = dv if first_dv is None else first_dv
        assert torch.equal(dv, first_dv), length
        again = csr_spmm_ev_bwd(cot, x, v, *csr_t, msg_dtype, t_plan, length)
        assert torch.equal(again[0], dx) and torch.equal(again[1], dv)
        only_dx = csr_spmm_ev_bwd(cot, x, v, *csr_t, msg_dtype, t_plan, length, True, False)
        only_dv = csr_spmm_ev_bwd(cot, x, v, *csr_t, msg_dtype, t_plan, length, False, True)
        assert only_dx[1] is None and torch.equal(only_dx[0], dx)
        assert only_dv[0] is None and torch.equal(only_dv[1], dv)
    counts = _ev_counts()
    assert csr_spmm_ev_bwd(cot, x, v, *csr_t, msg_dtype, None, None, False, False) == (None, None)
    assert _ev_counts(counts) == (0, 0, 0)


def test_fused_edge_value_backward_unaligned_rows_take_the_scalar_path(cuda):
    """Rows off 16-byte alignment at D = 64: the 1-column path, dx bitwise
    the parent formulation's, dv bitwise sddmm's and within 1e-5."""
    g = _edge_value_graph(cuda)
    n = g.num_nodes
    flat = torch.randn(2, n * 64 + 1, device=cuda)
    x, cot = (flat[i, 1:].view(n, 1, 64) for i in range(2))
    assert x.data_ptr() % 16 != 0
    v = torch.rand(g.num_edges, 1, device=cuda)
    csr_t = (g.t_indptr, g.t_edge_src, g.t_edge_dst, g.t_perm)
    dx, dv = csr_spmm_ev_bwd(cot, x, v, *csr_t, torch.float32)
    parent_dx = csr_spmm_ev(cot.contiguous(), *csr_t[:3], v.index_select(0, g.t_perm.long()))
    assert torch.equal(dx, parent_dx)
    assert torch.equal(dv, sddmm(cot, x, g.indptr, g.edge_src, g.edge_dst))
    _check_rel(dv, sddmm_plain(cot, x, g.edge_src, g.edge_dst), 1e-5)


def test_edge_value_backward_plan_without_its_length_raises(cuda):
    """csr_spmm_ev_bwd and sddmm refuse a hub plan given without its segment
    length, before any launch."""
    g = _edge_value_graph(cuda)
    x = torch.randn(g.num_nodes, 2, 48, device=cuda)
    v = torch.rand(g.num_edges, 2, device=cuda)
    counts = _ev_counts()
    with pytest.raises(ValueError, match="segment length"):
        csr_spmm_ev_bwd(x, x, v, g.t_indptr, g.t_edge_src, g.t_edge_dst, g.t_perm,
                        torch.float32, g.t_hub_segments)
    with pytest.raises(ValueError, match="segment length"):
        sddmm(x, x, g.indptr, g.edge_src, g.edge_dst, g.hub_segments)
    assert _ev_counts(counts) == (0, 0, 0)


@pytest.mark.parametrize("chunk_dtype", ["f32", "bf16"])
def test_edge_value_gradient_runs_the_kernels(cuda, chunk_dtype):
    """propagate_edge_values forward and backward on the card: the forward
    is the aggregation kernel, dx and dv one csr_spmm_ev_bwd launch (the
    transposed order with v[t_perm]); held to torch autograd of the plain
    version on the same (rounded) messages, with dv on the unrounded x."""
    g = _edge_value_graph(cuda, chunk_dtype)
    msg = torch.float32 if chunk_dtype == "f32" else torch.bfloat16
    x = torch.randn(g.num_nodes, 2, 48, device=cuda, requires_grad=True)
    v = torch.rand(g.num_edges, 2, device=cuda, requires_grad=True)
    cot = torch.randn(g.num_nodes, 2, 48, device=cuda)
    counts = _ev_counts()
    out = g.propagate_edge_values(x, v)
    dx, dv = torch.autograd.grad(out, (x, v), cot)
    assert _ev_counts(counts) == (1, 1, 0)  # forward; dx and dv in one launch
    xr = x.detach().to(msg).float().requires_grad_()
    want = spmm_edge_values(xr, g.edge_src, g.edge_dst, v, g.num_nodes)
    want_dx, _ = torch.autograd.grad(want, (xr, v), cot.to(msg).float())
    want_dv = sddmm_plain(cot, x.detach(), g.edge_src, g.edge_dst)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dx, want_dx, rtol=1e-5, atol=1e-5)
    _check_rel(dv, want_dv, 1e-5)


def test_gat_train_steps_on_the_card_match_the_cpu(cuda):
    from sgformer_tpu_torch.nn import GAT
    from sgformer_tpu_torch.train import TrainConfig, Trainer

    rng = np.random.default_rng(6)
    n = 900
    ei = rng.integers(0, n, (2, 5000))
    x = rng.standard_normal((n, 24)).astype(np.float32)
    label = rng.integers(0, 5, (n, 1))
    tc = TrainConfig(lr=1e-2, trans_weight_decay=5e-3, gnn_weight_decay=5e-3)
    losses = {}
    for dev in ("cpu", "cuda"):
        model = GAT(24, 16, 5, heads=2, dropout=0.0, device=dev)
        trainer = Trainer(model, preprocess_graph(ei, n, device=dev), x, label, tc, device=dev)
        trainer.init_state(0)
        idx = trainer.prepare_train_idx({"train": np.arange(0, n, 2)})
        losses[dev] = trainer.multi_step(idx, 4).cpu().numpy()
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    assert losses["cuda"][-1] < losses["cuda"][0]


def _hub_graph(cuda, chunk_dtype="f32"):
    """Node 3 has 10,000 in-edges and node 5 10,000 out-edges, so A and A^T
    each have one row far above HUB_EDGES; every other row has 1-3."""
    rng = np.random.default_rng(7)
    n = 12_000
    fan = rng.permutation(np.arange(6, n))[:10_000]
    ei = np.concatenate([np.stack([rng.integers(0, n, n), np.arange(n)]),
                         np.stack([rng.integers(0, n, n), np.arange(n)]),
                         np.stack([fan, np.full(10_000, 3)]),
                         np.stack([np.full(10_000, 5), fan])], axis=1)
    g = preprocess_graph(ei, n, undirected=False, chunk_dtype=chunk_dtype, device=cuda)
    assert g.hub_segments[:, 0].unique().tolist() == [3]
    assert g.t_hub_segments[:, 0].unique().tolist() == [5]
    return g


def _close_to_exact(got, x, src, dst, w, n):
    """The sum over the edges (src -> dst) of w * x, exact in f64, against
    ``got``: the output's own rounding (bf16 2^-8, f32 2^-24 of the value)
    plus 1e-5 of the sum of the terms' magnitudes, which bounds the f32
    summation error in any order over a hub row's ~10,000 terms. x: [N, F]
    with w [E], or [N, H, D] with w [E, H]."""
    wd = w.double()[:, None] if x.dim() == 2 else w.double()[..., None]
    terms = x.double()[src.long()] * wd
    exact = torch.zeros(n, *x.shape[1:], dtype=torch.float64, device=x.device)
    mag = torch.zeros_like(exact)
    exact.index_add_(0, dst.long(), terms)
    mag.index_add_(0, dst.long(), terms.abs())
    rnd = 2.0 ** -8 if got.dtype == torch.bfloat16 else 2.0 ** -24
    assert ((got.double() - exact).abs() <= rnd * exact.abs() + 1e-5 * mag).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [256, 37])
def test_csr_spmm_splits_hub_rows(cuda, dtype, width):
    """A hub row summed over several warps and added in segment order: the
    plain version's tolerance, the exact sum's (f64) tolerance, bitwise
    repeatable, the same without a plan (built from indptr), one launch a
    call; the gradient on A^T (a hub row there too) through the kernel,
    against the exact sum (plain and kernel sum its 10,000 terms in other
    orders)."""
    g = _hub_graph(cuda)
    n = g.num_nodes
    csr = (g.indptr, g.edge_src, g.edge_dst, g.gcn_weight)
    x = torch.randn(n, width, device=cuda).to(dtype)
    before = spmm_kernel.launches
    got = csr_spmm(x, *csr, g.hub_segments, g.hub_edges)
    assert spmm_kernel.launches == before + 1
    want = spmm(x, g.edge_src, g.edge_dst, g.gcn_weight, n)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    _close_to_exact(got, x, g.edge_src, g.edge_dst, g.gcn_weight, n)
    assert torch.equal(got, csr_spmm(x, *csr, g.hub_segments, g.hub_edges))
    assert torch.equal(got, csr_spmm(x, *csr))
    xr = x.clone().requires_grad_()
    cot = torch.randn(n, width, device=cuda).to(dtype)
    before = spmm_kernel.launches
    got_g = torch.autograd.grad(g.propagate(xr), xr, cot)[0]
    assert spmm_kernel.launches == before + 2
    _close_to_exact(got_g, cot, g.t_edge_src, g.t_edge_dst, g.t_weight, n)


@pytest.mark.parametrize("msg_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,d", [(2, 256), (3, 37)])
def test_csr_spmm_ev_splits_hub_rows(cuda, msg_dtype, heads, d):
    """The per-edge-value aggregation on the hub graph, f32 and message-type
    results, against the exact sum and bitwise repeatable; dx on the
    transposed order (its own hub row) against the exact sum of the rounded
    cotangent, and dv, through the kernels."""
    g = _hub_graph(cuda, "f32" if msg_dtype == torch.float32 else "bf16")
    n, e = g.num_nodes, g.num_edges
    csr = (g.indptr, g.edge_src, g.edge_dst)
    x = torch.randn(n, heads, d, device=cuda)
    v = torch.rand(e, heads, device=cuda)
    xm = x.to(msg_dtype)
    for out_dtype in (torch.float32, msg_dtype):
        got = csr_spmm_ev(xm, *csr, v, out_dtype, g.hub_segments, g.hub_edges)
        _close_to_exact(got, xm, g.edge_src, g.edge_dst, v, n)
        assert torch.equal(got, csr_spmm_ev(xm, *csr, v, out_dtype, g.hub_segments,
                                            g.hub_edges))
    xr, vr = x.clone().requires_grad_(), v.clone().requires_grad_()
    cot = torch.randn(n, heads, d, device=cuda)
    counts = _ev_counts()
    out = g.propagate_edge_values(xr, vr)
    dx, dv = torch.autograd.grad(out, (xr, vr), cot)
    assert _ev_counts(counts) == (1, 1, 0)
    _close_to_exact(dx, cot.to(msg_dtype), g.t_edge_src, g.t_edge_dst,
                    v[g.t_perm.long()], n)
    _check_rel(dv, sddmm_plain(cot, x, g.edge_src, g.edge_dst), 1e-5)


def test_hub_plan_of_another_segment_length_raises(cuda):
    """A plan built for 256-edge segments on a graph with a 200-edge row:
    the kernel's row walk at the default 128 edges would skip that row and
    the plan does not list it, so a plan given without its length is
    refused by csr_spmm and csr_spmm_ev; given with it, the walk takes 256
    and every row, the 200-edge one included, matches the plain version."""
    rng = np.random.default_rng(8)
    n = 600
    ei = np.concatenate([rng.integers(0, n, (2, 2 * n)),
                         np.stack([np.arange(10, 210), np.full(200, 4)]),
                         np.stack([rng.integers(0, n, 300), np.full(300, 9)])], axis=1)
    g = preprocess_graph(ei, n, undirected=False, self_loops=False, device=cuda)
    deg = torch.diff(g.indptr)  # the random edges add a few to each
    assert spmm_kernel.HUB_EDGES < deg[4].item() <= 256 < deg[9].item()
    plan = spmm_kernel.hub_plan(g.indptr, 256)
    assert plan[:, 0].unique().tolist() == [9]
    csr = (g.indptr, g.edge_src, g.edge_dst)
    x = torch.randn(n, 64, device=cuda)
    v = torch.rand(g.num_edges, 2, device=cuda)
    before = (spmm_kernel.launches, spmm_kernel.ev_launches)
    with pytest.raises(ValueError, match="segment length"):
        csr_spmm(x, *csr, g.gcn_weight, plan)
    with pytest.raises(ValueError, match="segment length"):
        csr_spmm_ev(x.view(n, 2, 32), *csr, v, None, plan)
    assert (spmm_kernel.launches, spmm_kernel.ev_launches) == before
    got = csr_spmm(x, *csr, g.gcn_weight, plan, 256)
    torch.testing.assert_close(got, spmm(x, g.edge_src, g.edge_dst, g.gcn_weight, n),
                               **TOL[torch.float32])
    got = csr_spmm_ev(x.view(n, 2, 32), *csr, v, None, plan, 256)
    torch.testing.assert_close(got, spmm_edge_values(x.view(n, 2, 32), g.edge_src, g.edge_dst,
                                                     v, n), **TOL[torch.float32])
    # the graph's own plans come with their length, through propagate
    assert g.hub_edges == spmm_kernel.HUB_EDGES and g.hub_segments[:, 0].unique().tolist() == [
        4, 9]
    torch.testing.assert_close(g.propagate(x), spmm(x, g.edge_src, g.edge_dst, g.gcn_weight, n),
                               **TOL[torch.float32])


def _int8_graph(cuda, undirected=False):
    """The hub and isolated rows of :func:`_graph`, aggregated in int8."""
    rng = np.random.default_rng(0)
    n, e = 700, 3000
    ei = np.concatenate([rng.integers(0, n - 20, (2, e)),
                         np.stack([np.arange(70), np.full(70, 5)])], axis=1)
    return preprocess_graph(ei, n, undirected=undirected, chunk_dtype="bf16",
                            slab_dtype="int8", device=cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [520, 256, 77, 8, 1])
def test_csr_spmm_q8_kernel_matches_plain(cuda, dtype, width):
    """The int8 kernel against its plain version on the same inputs: the
    integer sums are exact and the epilogue is the same f32 operations in the
    same order, so the two are equal; bitwise repeatable."""
    from sgformer_tpu_torch.kernels.spmm import csr_spmm_q8
    from sgformer_tpu_torch.ops.spmm import spmm_q8

    g = _int8_graph(cuda)
    x = torch.randn(g.num_nodes, width, device=cuda).to(dtype)
    csr = (g.indptr, g.edge_src, g.edge_dst, g.gcn_weight)
    before = (spmm_kernel.q8_launches, spmm_kernel.quantize_launches)
    got = csr_spmm_q8(x, *csr, g.rs)
    assert (spmm_kernel.q8_launches, spmm_kernel.quantize_launches) == (before[0] + 1,
                                                                        before[1] + 1)
    assert got.dtype == dtype
    want = spmm_q8(x, g.edge_src, g.edge_dst, g.gcn_weight, g.rs, g.num_nodes)
    assert torch.equal(got, want)
    assert torch.equal(got, csr_spmm_q8(x, *csr, g.rs))


def test_csr_spmm_q8_unaligned_rows_take_the_scalar_path(cuda):
    from sgformer_tpu_torch.kernels.spmm import csr_spmm_q8_apply
    from sgformer_tpu_torch.ops.spmm import quantize_absmax, spmm_q8_apply

    g = _int8_graph(cuda)
    n = g.num_nodes
    x = torch.randn(n, 64, device=cuda)
    q, s = quantize_absmax(x, g.rs)
    flat = torch.empty(n * 64 + 3, dtype=torch.int8, device=cuda)
    qu = flat[3:].view(n, 64)
    qu.copy_(q)
    assert qu.is_contiguous() and qu.data_ptr() % 16 != 0
    xb = x.to(torch.bfloat16)
    got = csr_spmm_q8_apply(qu, s, xb, g.indptr, g.edge_src, g.edge_dst, g.gcn_weight, g.rs,
                            torch.float32)
    want = spmm_q8_apply(q, s, xb, g.edge_src, g.edge_dst, g.gcn_weight, g.rs, n,
                         torch.float32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("undirected", [True, False])
def test_int8_gradient_runs_the_kernel_on_the_transpose(cuda, undirected):
    from sgformer_tpu_torch.ops.spmm import spmm_q8

    g = _int8_graph(cuda, undirected)
    n = g.num_nodes
    x = torch.randn(n, 40, device=cuda).to(torch.bfloat16).requires_grad_()
    cot = torch.randn(n, 40, device=cuda).to(torch.bfloat16)
    before = spmm_kernel.q8_launches
    out = g.propagate(x)
    (got,) = torch.autograd.grad(out, x, cot)
    assert spmm_kernel.q8_launches == before + 2
    csr_t = ((g.edge_src, g.edge_dst, g.gcn_weight) if undirected
             else (g.t_edge_src, g.t_edge_dst, g.t_weight))
    assert torch.equal(got, spmm_q8(cot, *csr_t, g.rs, n))
    assert torch.equal(out, spmm_q8(x.detach(), g.edge_src, g.edge_dst, g.gcn_weight, g.rs, n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [256, 40, 7])
def test_quantizer_kernel_is_the_plain_version(cuda, dtype, width):
    """q and s bit for bit the plain quantiser's, at N not a multiple of a
    block's items (16-byte path at F = 256 and 40, one element a thread at
    F = 7); one launch a call."""
    from sgformer_tpu_torch.ops.spmm import quantize_absmax

    n = 5003
    gen = torch.Generator(device=cuda).manual_seed(width)
    x = (3 * torch.randn(n, width, generator=gen, device=cuda)).to(dtype)
    rs = torch.rand(n, generator=gen, device=cuda)
    before = spmm_kernel.quantize_launches
    q, s = spmm_kernel.quantize_absmax(x, rs)
    assert spmm_kernel.quantize_launches == before + 1
    q_p, s_p = quantize_absmax(x, rs)
    assert q.dtype == torch.int8 and s.shape == () and s.dtype == torch.float32
    assert torch.equal(s, s_p) and torch.equal(q, q_p)
    assert q.abs().max().item() == 127


@pytest.mark.parametrize("width", [8, 1])
def test_quantizer_kernel_ties_zeros_and_nan(cuda, width):
    """Values that land on .5 after the scale round half to even; an
    all-zero x gives s = 1e-30 and q = 0; a NaN in x gives a NaN s, as the
    plain version's amax does."""
    from sgformer_tpu_torch.ops.spmm import quantize_absmax

    vals = torch.tensor([127.0, 0.5, 1.5, 2.5, 3.5, -0.5, -1.5, -2.5, 126.5, -126.5],
                        device=cuda)
    x = vals[:, None].repeat(1, width)
    ones = torch.ones(len(vals), device=cuda)
    q, s = spmm_kernel.quantize_absmax(x, ones)
    assert s.item() == 127.0
    assert q[:, 0].tolist() == [127, 0, 2, 2, 4, 0, -2, -2, 126, -126]
    assert torch.equal(q, quantize_absmax(x, ones)[0])
    zero = torch.zeros(300, width, dtype=torch.bfloat16, device=cuda)
    q, s = spmm_kernel.quantize_absmax(zero, torch.ones(300, device=cuda))
    assert s.item() == torch.tensor(1e-30).item() and not q.any()
    x[3, width - 1] = float("nan")
    s = spmm_kernel.quantize_absmax(x, ones)[1]
    assert torch.isnan(s).item() and torch.isnan(quantize_absmax(x, ones)[1]).item()


def _int8_hub_graph(cuda):
    """:func:`_hub_graph`'s edges (a 10,000-edge row in A and in A^T),
    aggregated in int8."""
    rng = np.random.default_rng(7)
    n = 12_000
    fan = rng.permutation(np.arange(6, n))[:10_000]
    ei = np.concatenate([np.stack([rng.integers(0, n, n), np.arange(n)]),
                         np.stack([rng.integers(0, n, n), np.arange(n)]),
                         np.stack([fan, np.full(10_000, 3)]),
                         np.stack([np.full(10_000, 5), fan])], axis=1)
    g = preprocess_graph(ei, n, undirected=False, chunk_dtype="bf16", slab_dtype="int8",
                         device=cuda)
    assert g.hub_segments[:, 0].unique().tolist() == [3]
    return g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [256, 40, 7])
def test_csr_spmm_q8_walks_split_hub_rows(cuda, dtype, width):
    """The int8 walk on a graph with a 10,000-edge row, through its hub
    plan (8-byte gathers at F = 256 and 40, one byte at F = 7): bitwise the
    plain version on the same quantised rows (integer sums, the same
    epilogue), bitwise repeatable, one launch a call; without a plan (built
    from indptr) the same."""
    from sgformer_tpu_torch.ops.spmm import quantize_absmax, spmm_q8_apply

    g = _int8_hub_graph(cuda)
    n = g.num_nodes
    csr = (g.indptr, g.edge_src, g.edge_dst, g.gcn_weight)
    x = torch.randn(n, width, device=cuda).to(dtype)
    q, s = quantize_absmax(x, g.rs)
    xb = x.to(torch.bfloat16)
    before = spmm_kernel.q8_launches
    got = spmm_kernel.csr_spmm_q8_apply(q, s, xb, *csr, g.rs, dtype, g.hub_segments,
                                        g.hub_edges)
    assert spmm_kernel.q8_launches == before + 1
    want = spmm_q8_apply(q, s, xb, g.edge_src, g.edge_dst, g.gcn_weight, g.rs, n, dtype)
    assert torch.equal(got, want)
    assert torch.equal(got, spmm_kernel.csr_spmm_q8_apply(
        q, s, xb, *csr, g.rs, dtype, g.hub_segments, g.hub_edges))
    assert torch.equal(got, spmm_kernel.csr_spmm_q8_apply(q, s, xb, *csr, g.rs, dtype))


@pytest.mark.parametrize("width", [256, 77, 32])
@pytest.mark.parametrize("hubs", [False, True])
def test_csr_spmm_q8_walk_order_is_the_node_order_walk_bitwise(cuda, width, hubs):
    """``csr_spmm_q8`` walked in the graph's order and in a random one is
    bitwise its node-order walk and the plain version on the same quantised
    rows (integer sums in any order, the self weight in edge order), on a
    graph with a 10,000-edge row through its hub plan and on one without hub
    rows, f32 and bf16 out; bitwise repeatable, one launch a call."""
    from sgformer_tpu_torch.ops.spmm import quantize_absmax, spmm_q8_apply

    g = _int8_hub_graph(cuda) if hubs else _int8_graph(cuda)
    assert g.schedule is not None
    n = g.num_nodes
    csr = (g.indptr, g.edge_src, g.edge_dst, g.gcn_weight)
    plan = (g.hub_segments, g.hub_edges)
    assert (plan[0].shape[0] > 0) == hubs
    shuffled = torch.randperm(n, generator=torch.Generator().manual_seed(2)).int().to(cuda)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(n, width, device=cuda).to(dtype)
        q, s = quantize_absmax(x, g.rs)
        xb = x.to(torch.bfloat16)
        want = spmm_q8_apply(q, s, xb, g.edge_src, g.edge_dst, g.gcn_weight, g.rs, n, dtype)
        base = spmm_kernel.csr_spmm_q8_apply(q, s, xb, *csr, g.rs, dtype, *plan)
        assert torch.equal(base, want)
        for order in (g.schedule, shuffled):
            before = spmm_kernel.q8_launches
            got = spmm_kernel.csr_spmm_q8_apply(q, s, xb, *csr, g.rs, dtype, *plan,
                                                schedule=order)
            assert spmm_kernel.q8_launches == before + 1
            assert torch.equal(got, base)
            assert torch.equal(got, spmm_kernel.csr_spmm_q8_apply(q, s, xb, *csr, g.rs, dtype,
                                                                  *plan, schedule=order))


def test_int8_gradient_splits_the_transposes_hub_row(cuda):
    """Through ``Graph.propagate``: the forward on A's plan and the gradient
    on A^T's (its own 10,000-edge row), each bitwise the plain int8
    aggregation; two quantiser and two int8 launches."""
    from sgformer_tpu_torch.ops.spmm import spmm_q8

    g = _int8_hub_graph(cuda)
    n = g.num_nodes
    x = torch.randn(n, 256, device=cuda).to(torch.bfloat16).requires_grad_()
    cot = torch.randn(n, 256, device=cuda).to(torch.bfloat16)
    before = (spmm_kernel.q8_launches, spmm_kernel.quantize_launches)
    out = g.propagate(x)
    (got,) = torch.autograd.grad(out, x, cot)
    assert (spmm_kernel.q8_launches - before[0], spmm_kernel.quantize_launches - before[1]) == (
        2, 2)
    assert torch.equal(out, spmm_q8(x.detach(), g.edge_src, g.edge_dst, g.gcn_weight, g.rs, n))
    assert torch.equal(got, spmm_q8(cot, g.t_edge_src, g.t_edge_dst, g.t_weight, g.rs, n))


def test_int8_hub_plan_without_its_length_raises(cuda):
    g = _int8_hub_graph(cuda)
    x = torch.randn(g.num_nodes, 64, device=cuda)
    before = (spmm_kernel.q8_launches, spmm_kernel.quantize_launches)
    with pytest.raises(ValueError, match="segment length"):
        spmm_kernel.csr_spmm_q8(x, g.indptr, g.edge_src, g.edge_dst, g.gcn_weight, g.rs,
                                g.hub_segments)
    assert (spmm_kernel.q8_launches, spmm_kernel.quantize_launches) == before


def test_int8_train_steps_on_the_card_match_the_cpu(cuda):
    from sgformer_tpu_torch.train import TrainConfig, Trainer

    rng = np.random.default_rng(4)
    n = 900
    ei = rng.integers(0, n, (2, 5000))
    x = rng.standard_normal((n, 24)).astype(np.float32)
    label = rng.integers(0, 5, (n, 1))
    cfg = SGFormerConfig.large(64, 5, gnn_num_layers=3, trans_dropout=0.0, gnn_dropout=0.0)
    tc = TrainConfig(lr=1e-2, trans_weight_decay=1e-3, gnn_weight_decay=5e-4)
    losses = {}
    for dev in ("cpu", "cuda"):
        model = SGFormer(cfg, 24, device=dev)
        graph = preprocess_graph(ei, n, chunk_dtype="bf16", slab_dtype="int8", device=dev)
        trainer = Trainer(model, graph, x, label, tc, device=dev)
        trainer.init_state(0)
        idx = trainer.prepare_train_idx({"train": np.arange(0, n, 2)})
        before = spmm_kernel.q8_launches
        losses[dev] = trainer.multi_step(idx, 4).cpu().numpy()
        if dev == "cuda":
            assert spmm_kernel.q8_launches - before == 4 * 6
    # the first step's loss agrees as the bf16 one does; after an update, a
    # last-bit difference of the activations (the attention sums in another
    # order) can carry a value across a rounding boundary of the quantiser,
    # one int8 step (1/127 of the absmax) in that element, which the later
    # losses show at ~1e-3
    np.testing.assert_allclose(losses["cuda"][0], losses["cpu"][0], rtol=1e-4)
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=5e-3)
    assert losses["cuda"][-1] < losses["cuda"][0]


@pytest.mark.parametrize("stages", [4, 8, 16, 32])
@pytest.mark.parametrize("width", [256, 64])
def test_gather_rows_kernel_matches_plain(cuda, stages, width):
    from sgformer_tpu_torch.microbench import dma_gather

    x, idx = dma_gather.make_inputs(cuda, n=5000, e=8192, f=width)
    before = kernels.probe_launches["gather_rows"]
    got = dma_gather.gather_rows(x, idx, chunk=512, stages=stages)
    assert kernels.probe_launches["gather_rows"] == before + 1
    _check_rel(got, dma_gather.gather_rows_plain(x, idx, 512), dma_gather.REL_TOL)
    assert torch.equal(got, dma_gather.gather_rows(x, idx, chunk=512, stages=stages))


@pytest.mark.parametrize("stages", [1, 8, 32])
@pytest.mark.parametrize("width,chunk", [(256, 256), (64, 64)])
@pytest.mark.parametrize("waves", ["below one", "several"])
def test_gather_tiles_kernel_matches_plain(cuda, stages, width, chunk, waves):
    """Below one wave of the persistent grid (8 steps) and over several (3
    waves and 5 steps: 3 or 4 steps a block), bitwise repeatable; S = 1
    runs one consumer warp, 8 and 32 eight."""
    from sgformer_tpu_torch.microbench import dma_tile

    steps = 8
    if waves == "several":
        steps = 3 * dma_tile.card_plan(1 << 30, width, stages, 0)["grid"] + 5
    x, idx = dma_tile.make_inputs(cuda, n=4096, f=width, e=steps * chunk, chunk=chunk,
                                  stages=(8,))
    grid = dma_tile.card_plan(steps, width, stages, x.device.index)["grid"]
    assert grid == steps if waves == "below one" else steps == 3 * grid + 5
    before = kernels.probe_launches["gather_tiles"]
    got = dma_tile.gather_tiles(x, idx[8], chunk=chunk, stages=stages)
    assert kernels.probe_launches["gather_tiles"] == before + 1
    _check_rel(got, dma_tile.gather_tiles_plain(x, idx[8], chunk), dma_tile.REL_TOL)
    assert torch.equal(got, dma_tile.gather_tiles(x, idx[8], chunk=chunk, stages=stages))


# sha256 (16 hex digits) of the gather probes' outputs from the kernels the
# persistent ones replaced (one block a chunk or a step), read on an NVIDIA
# H100 80GB HBM3: (kernel, n, e, f, chunk, stages) on the probes' make_inputs
EARLIER_PROBE_DIGESTS = {("gather_rows", 5000, 8192, 256, 512, 16): "d2599c5767adfea7",
                         ("gather_rows", 5000, 8192, 64, 512, 16): "bc582f8cfd00d563",
                         ("gather_tiles", 4096, 2048, 256, 256, 8): "de48a7d1f15862e9",
                         ("gather_tiles", 4096, 2048, 64, 64, 8): "bc69b29023b98e2b"}


@pytest.mark.parametrize("which", list(EARLIER_PROBE_DIGESTS))
def test_gather_probes_are_bitwise_the_replaced_kernels(cuda, which):
    """Both kernels add each group's terms in the order the replaced ones
    did (gather_rows: the rows in index order; gather_tiles: for each
    column, the tiles in index order and rows 0-7 of each), so their outputs
    are those kernels' bit for bit, and bitwise the same sums taken one term
    at a time in f32 on the host, at every S the probes run."""
    import hashlib

    from sgformer_tpu_torch.microbench import dma_gather, dma_tile

    kernel, n, e, f, chunk, _ = which
    if kernel == "gather_rows":
        x, idx = dma_gather.make_inputs(cuda, n=n, e=e, f=f)
        run = lambda s: dma_gather.gather_rows(x, idx, chunk=chunk, stages=s)
        stages, rows = dma_gather.STAGES, idx.cpu().numpy().reshape(-1, 8, chunk // 8, 1)
    else:
        x, tidx = dma_tile.make_inputs(cuda, n=n, f=f, e=e, chunk=chunk, stages=(8,))
        run = lambda s: dma_tile.gather_tiles(x, tidx[8], chunk=chunk, stages=s)
        stages = dma_tile.STAGES
        rows = 8 * tidx[8].cpu().numpy().reshape(-1, 8, chunk // 8, 1) + np.arange(8)
    xf = x.float().cpu().numpy()
    terms = rows.reshape(rows.shape[0], 8, -1)
    want = np.zeros((terms.shape[0], 8, f), np.float32)
    for j in range(terms.shape[2]):
        want += xf[terms[:, :, j]]
    for s in stages:
        got = run(s)
        assert hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16] == \
            EARLIER_PROBE_DIGESTS[which]
        assert np.array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("probe", ["gather_rows", "gather_tiles"])
def test_gather_plans_hold_on_the_card(cuda, probe):
    """At the scripts' width, every S of their runs, the card holds the
    blocks an SM that the plan reckons from shared memory and threads (the
    registers never cut it), so the persistent grid is one wave."""
    from sgformer_tpu_torch.microbench import dma_gather, dma_tile

    mod, n = (dma_gather, dma_gather.E // dma_gather.C) if probe == "gather_rows" else \
        (dma_tile, dma_tile.E // dma_tile.C)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for s in mod.STAGES:
        assert mod.card_plan(n, mod.F, s, 0) == mod.plan(n, mod.F, s, sms)


@pytest.mark.parametrize("mode", ["prod", "static_sub", "no_src_matmul"])
@pytest.mark.parametrize("width", [256, 520, 64])
def test_slab_variant_kernel_matches_its_formula(cuda, mode, width):
    """Each mode against its plain formula (f32 order, and no_src_matmul's
    fused multiply-add); prod is bitwise ``csr_spmm``'s walk of the whole
    warp on the same x: ``csr_spmm`` itself above 128 columns, and at 64
    (which ``csr_spmm`` takes in lane groups) ``csr_spmm`` of x in rows off
    16-byte alignment, whose one-column walk over the whole warp chains
    each column's products in the same edge order."""
    from sgformer_tpu_torch.microbench import slab_variants

    g = _graph(cuda)
    x = slab_variants.make_x(g.num_nodes, cuda, f=width)
    csr = (g.indptr, g.edge_src, g.edge_dst, g.gcn_weight)
    before = kernels.probe_launches["slab_variant"]
    got = slab_variants.slab_variant(x, *csr, mode)
    assert kernels.probe_launches["slab_variant"] == before + 1
    _check_rel(got, slab_variants.slab_variant_plain(x, g.edge_src, g.edge_dst,
                                                     g.gcn_weight, mode), slab_variants.REL_TOL)
    if mode == "prod":
        whole_warp = x.float()
        if width <= 128:
            flat = torch.empty(x.numel() + 1, device=cuda)
            whole_warp = flat[1:].view(x.shape).copy_(x.float())
            assert spmm_kernel.walk_design(width, whole_warp.data_ptr() % 16 == 0).startswith(
                "1 group of 32 lanes")
        assert torch.equal(got, csr_spmm(whole_warp, *csr))


def _batch_edges(n=1500):
    """The batch tier's edge list of a power-law graph (symmetrised, self-loops
    replaced): its hub rows hold more in-edges than a hub segment (128)."""
    from sgformer_tpu_torch.data import synthetic_dataset
    from sgformer_tpu_torch.graph import add_self_loops, remove_self_loops, to_undirected

    ds = synthetic_dataset(num_nodes=n, num_edges=25000, num_features=16, num_classes=5,
                           powerlaw=1.1, seed=7, device="cpu")
    ei = torch.as_tensor(ds.graph["edge_index"])
    return ds, add_self_loops(remove_self_loops(to_undirected(ei)), n).numpy()


@pytest.mark.parametrize("pyg", [False, True])
def test_batch_build_on_the_card_is_bitwise_the_cpu_build(cuda, pyg):
    """Every tensor of a batch's graph, the transposed CSRs and all hub plans
    included, is bitwise the same built on the card and on the CPU."""
    import dataclasses

    from sgformer_tpu_torch.train import build_subgraph_batch

    ds, ei = _batch_edges()
    n = ds.num_nodes
    perm = np.random.default_rng(0).permutation(n)
    ei_card = torch.from_numpy(ei).to(cuda, torch.int32)
    for bidx in (perm[:1200], perm[1200:]):
        want = build_subgraph_batch(torch.from_numpy(ei), torch.from_numpy(bidx), n,
                                    with_pyg_norm=pyg)
        got = build_subgraph_batch(ei_card, torch.from_numpy(bidx).to(cuda), n,
                                   with_pyg_norm=pyg)
        assert got.device.type == "cuda"
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if isinstance(b, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a.cpu(), b), f.name
            else:
                assert a == b, f.name
        if len(bidx) == 1200:
            assert got.hub_segments.shape[0] > 0 and got.t_hub_segments.shape[0] > 0


def _batch_trainer(ds, ei, dev, **kw):
    from sgformer_tpu_torch.train import BatchTrainConfig, BatchTrainer

    cfg = SGFormerConfig.large(64, 5, gnn_num_layers=3, gnn_use_init=True, trans_dropout=0.0,
                               gnn_dropout=0.0)
    model = SGFormer(cfg, 16, device=dev)
    tc = BatchTrainConfig(lr=1e-2, trans_weight_decay=0.0, gnn_weight_decay=0.0,
                          batch_size=600, display_step=-1, **kw)
    full = preprocess_graph(ds.graph["edge_index"], ds.num_nodes, device=dev)
    return BatchTrainer(model, ei, ds.graph["node_feat"].cpu().numpy(), ds.label, tc,
                        full_graph=full, device=dev)


def test_batch_step_through_the_kernels_matches_the_cpu(cuda):
    """One batch step on the card (6 csr_spmm and the four attention kernels)
    against the same step on the CPU (the plain versions), from the same
    parameters: the loss within 1e-5, every gradient within 1e-4 of its
    norm (f32, summation order only)."""
    ds, ei = _batch_edges()
    bidx = np.random.default_rng(1).permutation(ds.num_nodes)[:600]
    out = {}
    for dev in ("cpu", "cuda"):
        trainer = _batch_trainer(ds, ei, dev)
        trainer.init_state(0)
        train_set = torch.zeros(ds.num_nodes, dtype=torch.bool, device=dev)
        train_set[::2] = True
        batch = trainer.build_batch(torch.from_numpy(bidx), train_set)
        kernels.reset_launch_counts()
        loss = trainer.loss(batch)
        loss.backward()
        counts = kernels.launch_counts()
        out[dev] = (loss.item(), {k: p.grad.cpu() for k, p in trainer.model.named_parameters()})
    assert counts["csr_spmm"] == 6 and all(
        counts[k] == 1 for k in ("linear_attention_reduce", "linear_attention_apply",
                                 "linear_attention_bwd_reduce", "linear_attention_bwd_apply"))
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    # a bias that feeds a train-mode BatchNorm has an exact gradient of 0:
    # both give rounding noise, held to the gradient of the shift after it
    scale_of = {"graph_conv.fc_in.bias": "graph_conv.bn_in.bias"}
    scale_of.update({f"graph_conv.conv_{i}.W.bias": f"graph_conv.bn_{i}.bias" for i in range(3)})
    for k, want in out["cpu"][1].items():
        rel = (out["cuda"][1][k] - want).norm() / out["cpu"][1][scale_of.get(k, k)].norm()
        assert rel.item() <= 1e-4, k


def test_batch_fit_on_the_card_gives_the_cpu_fit(cuda):
    """Two epochs of batches on the card (the kernels) and on the CPU (the
    plain versions), from the same parameters and batches: per-batch losses
    within 1e-4 relative (f32 summation order, compounded by 6 Adam steps);
    then the full-graph eval of the card's final parameters on both: logits
    within 1e-4 of the largest, accuracies within one node's share of each
    split, the valid NLL within twice the logits' difference."""
    ds, ei = _batch_edges()
    split = {"train": np.arange(0, ds.num_nodes, 2), "valid": np.arange(1, ds.num_nodes, 4),
             "test": np.arange(3, ds.num_nodes, 4)}
    trainers = {}
    for dev in ("cpu", "cuda"):
        trainer = _batch_trainer(ds, ei, dev, epochs=2)
        trainer.record_losses = True
        trainer.fit([split], np_rng=np.random.default_rng(5))
        trainers[dev] = trainer
    card, cpu = trainers["cuda"], trainers["cpu"]
    assert len(card.train_losses) == 6
    np.testing.assert_allclose(card.train_losses, cpu.train_losses, rtol=1e-4)
    cpu.model.load_state_dict({k: v.cpu() for k, v in card.final_state.items()})
    got, want = card.eval_logits_full(), cpu.eval_logits_full()
    err = np.abs(got - want).max()
    assert err <= 1e-4 * np.abs(want).max()
    res_card, res_cpu = card.evaluate_full(got, split), cpu.evaluate_full(want, split)
    np.testing.assert_allclose(res_card[:3], res_cpu[:3], atol=1.0 / len(split["test"]))
    assert abs(res_card[3] - res_cpu[3]) <= 2 * err + 1e-6


def _sampled_setup(dev, **kw):
    """A sampled trainer on ``_batch_edges``'s graph (its CSR sorted on
    ``dev``), batches of 100 seeds, fanouts (8, 4, 2)."""
    from sgformer_tpu_torch.train import SampledTrainConfig, SampledTrainer

    ds, ei = _batch_edges()
    cfg = SGFormerConfig.papers100m(64, 5, trans_num_layers=1, gnn_num_layers=3,
                                    gnn_use_init=True, trans_dropout=0.0, gnn_dropout=0.0)
    model = SGFormer(cfg, 16, device=dev)
    tc = SampledTrainConfig(lr=1e-2, trans_weight_decay=0.0, gnn_weight_decay=0.0,
                            batch_size=100, fanouts=(8, 4, 2), display_step=-1, **kw)
    edges = torch.from_numpy(ei).to(dev)
    return ds, SampledTrainer(model, edges, ds.graph["node_feat"], ds.label, tc, device=dev)


def test_sampled_graph_on_the_card_is_bitwise_the_cpu_build(cuda):
    """Each batch's graph, the transposed CSR and both hub plans included, is
    bitwise the same built on the card and on the CPU, from the C++ sampler's
    batches (their weights) and the numpy path's (weights computed on each
    device); the CSR sorted on the card is the CPU's."""
    import dataclasses

    from sgformer_tpu_torch.sample import CSRGraph, NeighborSampler
    from sgformer_tpu_torch.train import build_sampled_graph

    ds, ei = _batch_edges()
    n = ds.num_nodes
    csr = CSRGraph.from_edge_index(torch.from_numpy(ei).to(cuda), n)
    want_csr = CSRGraph.from_edge_index(ei, n)
    assert np.array_equal(csr.indptr, want_csr.indptr)
    assert np.array_equal(csr.indices, want_csr.indices)
    hub = np.bincount(ei[1]).argmax()
    for use_native, seeds in itertools.product(
            (True, False), (np.unique(ei[0][ei[1] == hub]), np.arange(0, n, 7))):
        sampler = NeighborSampler(csr, n, (15, 10, 5), 300, seed=0, use_native=use_native)
        batch = sampler.sample(seeds)
        assert (batch.edge_weight is not None) == use_native
        got, want = build_sampled_graph(batch, cuda), build_sampled_graph(batch, "cpu")
        assert got.device.type == "cuda"
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if isinstance(b, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a.cpu(), b), f.name
            else:
                assert a == b, f.name
    assert got.num_nodes > 300


def test_sampled_step_through_the_kernels_matches_the_cpu(cuda):
    """One sampled batch step on the card (6 csr_spmm and the four attention
    kernels, none other) against the same step on the CPU from the same
    parameters: the loss within 1e-5, every gradient within 1e-4 of its norm
    (f32, summation order only)."""
    out = {}
    for dev in ("cpu", "cuda"):
        ds, trainer = _sampled_setup(dev)
        trainer.init_state(0)
        batch = trainer.sampler.sample(np.arange(0, 1500, 15))
        b = trainer.to_device(batch, trainer.gather_x(batch.node_ids))
        kernels.reset_launch_counts()
        loss = trainer.loss(b)
        loss.backward()
        counts = kernels.launch_counts()
        out[dev] = (loss.item(), {k: p.grad.cpu() for k, p in trainer.model.named_parameters()})
    want_counts = dict.fromkeys(counts, 0)
    want_counts.update(csr_spmm=6, linear_attention_reduce=1, linear_attention_apply=1,
                       linear_attention_bwd_reduce=1, linear_attention_bwd_apply=1)
    assert counts == want_counts
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    scale_of = {"graph_conv.fc_in.bias": "graph_conv.bn_in.bias"}
    scale_of.update({f"graph_conv.conv_{i}.W.bias": f"graph_conv.bn_{i}.bias" for i in range(3)})
    for k, want in out["cpu"][1].items():
        rel = (out["cuda"][1][k] - want).norm() / out["cpu"][1][scale_of.get(k, k)].norm()
        assert rel.item() <= 1e-4, k


def test_sampled_fit_on_the_card_gives_the_cpu_fit(cuda):
    """Two epochs of 500 train seeds on the card and on the CPU, from the
    same parameters and the same batches: per-batch losses within 1e-4
    relative (f32 summation order compounded by Adam steps), the streaming
    accuracies within one seed's share of each split."""
    split = {"train": np.arange(0, 1500, 3), "valid": np.arange(1, 1500, 6),
             "test": np.arange(2, 1500, 6)}
    trainers = {}
    for dev in ("cpu", "cuda"):
        _, trainer = _sampled_setup(dev, epochs=2)
        trainer.record_losses = True
        logger = trainer.fit([split], np_rng=np.random.default_rng(5))
        trainers[dev] = (trainer, logger)
    (card, lc), (cpu, lp) = trainers["cuda"], trainers["cpu"]
    assert len(card.train_losses) == 10
    np.testing.assert_allclose(card.train_losses, cpu.train_losses, rtol=1e-4)
    np.testing.assert_allclose(np.array(lc.results[0])[:, 1:3], np.array(lp.results[0])[:, 1:3],
                               atol=1.0 / 250)


def _hub_rows_graph(cuda):
    """A directed graph whose node 3 has 10,000 in-edges and node 4 10,000
    out-edges, beside random edges."""
    rng = np.random.default_rng(8)
    n = 12000
    fan = rng.permutation(np.arange(10, n))[:10000]
    ei = np.concatenate([rng.integers(0, n, (2, 40000)), np.stack([fan, np.full(10000, 3)]),
                         np.stack([np.full(10000, 4), fan])], axis=1)
    return preprocess_graph(ei, n, undirected=False, device=cuda)


def test_plain_sums_are_bitwise_repeatable_on_the_card(cuda):
    """edge_softmax (with its gradient), spmm and spmm_edge_values sum each
    destination's edges in one fixed order, no float atomics: repeated calls
    on 10,000-edge rows give the same bits, and the aggregations give the
    CPU's."""
    from sgformer_tpu_torch.ops.spmm import edge_softmax

    g = _hub_rows_graph(cuda)
    n, e = g.num_nodes, g.num_edges
    gen = torch.Generator(device=cuda).manual_seed(0)
    scores = torch.randn(e, 2, generator=gen, device=cuda) * 3
    cot = torch.randn(e, 2, generator=gen, device=cuda)
    x = torch.randn(n, 2, 40, generator=gen, device=cuda)
    v = torch.rand(e, 2, generator=gen, device=cuda)
    w = torch.rand(e, generator=gen, device=cuda)

    def run():
        s = scores.clone().requires_grad_()
        out = edge_softmax(s, g.edge_dst, n)
        (grad,) = torch.autograd.grad(out, s, cot)
        return (out, grad, spmm(x.view(n, 80), g.edge_src, g.edge_dst, w, n),
                spmm(x.view(n, 80), g.t_edge_src, g.t_edge_dst, w, n),
                spmm_edge_values(x, g.edge_src, g.edge_dst, v, n))

    first = run()
    for _ in range(5):
        assert all(torch.equal(a, b) for a, b in zip(run(), first))
    # the aggregations sum in the same order on the CPU
    gc, xc, wc = g.to("cpu"), x.cpu(), w.cpu()
    assert torch.equal(first[2].cpu(), spmm(xc.view(n, 80), gc.edge_src, gc.edge_dst, wc, n))
    assert torch.equal(first[4].cpu(), spmm_edge_values(xc, gc.edge_src, gc.edge_dst, v.cpu(), n))


def test_gat_eval_logits_are_bitwise_repeatable(cuda):
    """GAT's eval forward on the card, through the kernels and through the
    plain versions, gives the same bits on every call."""
    import contextlib
    from unittest import mock

    from sgformer_tpu_torch.nn import GAT

    g = _hub_rows_graph(cuda)
    g = preprocess_graph(torch.stack([g.edge_src, g.edge_dst]).cpu().numpy(), g.num_nodes,
                         chunk_dtype="bf16", device=cuda)
    model = GAT(16, 64, 5, num_layers=2, heads=2, device=cuda).eval()
    x = torch.randn(g.num_nodes, 16, generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda)

    def plain_ev(x, values, csr, csr_t, msg_dtype, *_):
        return spmm_edge_values(x.to(msg_dtype), csr[1], csr[2], values, csr[0].shape[0] - 1,
                                x.dtype)

    for patch in (contextlib.nullcontext(),
                  mock.patch.object(spmm_kernel, "csr_spmm_ev_autograd", plain_ev)):
        with patch, torch.no_grad():
            first = model(x, g)
            for _ in range(5):
                assert torch.equal(model(x, g), first)


def _cli_build(device, *flags):
    import argparse

    from sgformer_tpu_torch.cli import main as cli

    argv = ["--dataset", "synth-n1500-e9000-f16-c4", "--epochs", "2", "--rand_split",
            "--hidden_channels", "32", "--dropout", "0", "--trans_dropout", "0",
            "--gnn_dropout", "0", "--device", device, *flags]
    return cli.build(cli.parser_add_main_args(argparse.ArgumentParser()).parse_args(argv))


@pytest.mark.parametrize("flags", [("--trainer", "full"),
                                   ("--trainer", "full", "--backbone", "graphconv",
                                    "--slab_int8"),
                                   ("--trainer", "batch", "--batch_size", "500"),
                                   ("--trainer", "sampled", "--batch_size", "200"),
                                   ("--trainer", "full", "--method", "h2gcn")])
def test_cli_build_on_the_card_is_bitwise_the_cpu_build(cuda, flags):
    """The CLI's set-up on the card gives the CPU's graph, edge list and
    H2GCN edge sets, bitwise, and the same splits."""
    card, cpu = _cli_build("cuda", *flags), _cli_build("cpu", *flags)
    for k in ("train", "valid", "test"):
        np.testing.assert_array_equal(card.splits[0][k], cpu.splits[0][k])
    graphs = [(card.graph, cpu.graph)]
    h2 = getattr(card.trainer, "model_kwargs", {}).get("h2_graphs")
    if h2 is not None:
        graphs += list(zip(h2, cpu.trainer.model_kwargs["h2_graphs"]))
    for g, c in graphs:
        if g is None:
            continue
        assert g.device.type == "cuda"
        for name in ("edge_src", "edge_dst", "gcn_weight", "indptr", "t_indptr", "t_edge_src",
                     "hub_segments", "rs", "pyg_src", "pyg_weight"):
            a, b = getattr(g, name), getattr(c, name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert torch.equal(a.cpu(), b), name
    if card.edges is not None:
        assert torch.equal(card.edges.cpu(), cpu.edges)


@pytest.mark.parametrize("method", ["sgformer", "h2gcn"])
def test_cli_full_trainer_on_the_card_matches_the_cpu(cuda, method):
    """Through the CLI's set-up, from the same parameters (dropout 0, f32):
    the eval logits within 1e-5 of the largest, and three train steps'
    losses within 1e-5 relative (summation order only, compounded by Adam
    steps)."""
    out = {}
    for dev in ("cpu", "cuda"):
        built = _cli_build(dev, "--trainer", "full", "--method", method)
        trainer = built.trainer
        trainer.init_state(0)
        idx = trainer.prepare_train_idx(built.splits[0])
        logits = trainer.eval_step().cpu()
        losses = torch.stack([trainer.train_step(idx) for _ in range(3)]).cpu()
        out[dev] = logits, losses
    (lc, sc), (lp, sp) = out["cuda"], out["cpu"]
    assert (lc - lp).abs().max().item() <= 1e-5 * lp.abs().max().item()
    torch.testing.assert_close(sc, sp, rtol=1e-5, atol=0)


# (step, forward) csr_spmm launches through the CLI's set-up at 2 layers
# (the ablations' GCN backbone at 2 layers, DIFFormer's and NodeFormer's 2
# layers, GraphGPS's and GraphTrans's 2 GCN layers, Graphormer none)
ZOO_SPMM = {("--method", "difformer"): (4, 2), ("--method", "nodeformer"): (8, 4),
            ("--method", "graphgps"): (4, 2), ("--method", "graphtrans"): (4, 2),
            ("--method", "graphormer"): (0, 0), ("--attention", "softmax"): (4, 2),
            ("--attention", "gat"): (4, 2), ("--attention", "performer"): (4, 2)}


@pytest.mark.parametrize("flags", sorted(ZOO_SPMM))
def test_zoo_on_the_card_matches_the_cpu(cuda, flags, monkeypatch):
    """Each zoo model and attention ablation through the CLI's set-up, from
    the same parameters (dropout 0, f32; NodeFormer's train-mode projection
    and Gumbel uniforms drawn once on the CPU and shared): the eval logits
    within 1e-5 of the largest, three train steps' losses within 1e-5
    relative, and the csr_spmm launches of a step and a forward."""
    from sgformer_tpu_torch.nn import Dropout
    from sgformer_tpu_torch.nn.nodeformer import NodeFormerConv

    gen = torch.Generator().manual_seed(0)
    proj = torch.randn(30, 32, generator=gen)
    uniforms = torch.rand(1500, 1, 10, generator=gen).clamp_min(1e-20)
    monkeypatch.setattr(NodeFormerConv, "draw",
                        lambda self, n: (proj.to(self.Wq.weight.device),
                                         uniforms.to(self.Wq.weight.device)))
    out = {}
    for dev in ("cpu", "cuda"):
        built = _cli_build(dev, "--trainer", "full", "--num_layers", "2", "--gnn_num_layers",
                           "2", *flags)
        trainer = built.trainer
        trainer.init_state(0)
        for mod in trainer.model.modules():  # GraphTrans's encoder keeps its own 0.1
            if isinstance(mod, Dropout):
                mod.rate = 0.0
        idx = trainer.prepare_train_idx(built.splits[0])
        kernels.reset_launch_counts()
        logits = trainer.eval_step().cpu()
        forward = kernels.launch_counts()["csr_spmm"]
        losses = [trainer.train_step(idx)]
        step = kernels.launch_counts()["csr_spmm"] - forward
        losses = torch.stack(losses + [trainer.train_step(idx) for _ in range(2)]).cpu()
        out[dev] = logits, losses, (step, forward)
    (lc, sc, launches), (lp, sp, _) = out["cuda"], out["cpu"]
    assert torch.isfinite(lc).all()
    assert (lc - lp).abs().max().item() <= 1e-5 * lp.abs().max().item()
    torch.testing.assert_close(sc, sp, rtol=1e-5, atol=0)
    assert launches == ZOO_SPMM[flags]


def _op_args_on_the_card(cuda):
    from sgformer_tpu_torch.ops.spmm import quantize_absmax as quantize_plain

    g = _int8_graph(cuda)
    hub = _hub_graph(cuda)
    n = g.num_nodes
    gen = torch.Generator(device=cuda).manual_seed(0)
    csr = (g.indptr, g.edge_src, g.edge_dst, g.gcn_weight)
    x = torch.randn(n, 40, generator=gen, device=cuda)
    q, s = quantize_plain(x, g.rs)
    heads = torch.randn(3, n, 2, 72, generator=gen, device=cuda).bfloat16()
    qh, kh, vh = heads[0, :, 0], heads[1, :, 0], heads[2, :, 1]
    kvs, ksum, scal = attn.reduce_plain(qh, kh, vh, False)
    return {
        "csr_spmm": (torch.randn(hub.num_nodes, 256, generator=gen, device=cuda).bfloat16(),
                     hub.indptr, hub.edge_src, hub.edge_dst, hub.gcn_weight,
                     hub.hub_segments, hub.hub_edges),
        "csr_spmm_ev": (torch.randn(n, 2, 40, generator=gen, device=cuda).bfloat16(), *csr[:3],
                        torch.rand(g.num_edges, 2, generator=gen, device=cuda), torch.float32,
                        g.hub_segments, g.hub_edges),
        "quantize_absmax": (x, g.rs),
        "csr_spmm_q8_apply": (q, s, x.bfloat16(), *csr, g.rs, torch.float32, g.hub_segments,
                              g.hub_edges),
        "linear_attention_reduce": (qh, kh, vh, False),
        "linear_attention_apply": (qh, vh, kvs, ksum, scal,
                                   torch.tensor(float(n), device=cuda), False),
    }


@pytest.mark.parametrize("name", ["csr_spmm", "csr_spmm_ev", "quantize_absmax",
                                  "csr_spmm_q8_apply", "linear_attention_reduce",
                                  "linear_attention_apply"])
def test_opcheck_on_the_card(cuda, name):
    """Each forward kernel's op on CUDA tensors (hub rows, strided heads):
    its schema, its fake implementation against the kernel's results, and
    one launch counted a call."""
    from sgformer_tpu_torch.kernels import ops

    args = _op_args_on_the_card(cuda)[name]
    torch.library.opcheck(ops.OPS[name], args)
    kernels.reset_launch_counts()
    ops.OPS[name](*args)
    counts = kernels.launch_counts()
    assert counts[ops.LAUNCH_COUNT[name]] == 1 and sum(counts.values()) == 1


# each kind: (compute dtype or None for GAT, preprocess_graph options, launches
# of one forward)
EXPORT_KINDS = {
    "sgformer-bf16": ("bf16", {}, {"csr_spmm": 3, "linear_attention_reduce": 1,
                                   "linear_attention_apply": 1}),
    "sgformer-f32": ("f32", {}, {"csr_spmm": 3, "linear_attention_reduce": 1,
                                 "linear_attention_apply": 1}),
    "sgformer-int8": ("bf16", dict(chunk_dtype="bf16", slab_dtype="int8"),
                      {"csr_spmm_q8": 3, "quantize_absmax": 3, "linear_attention_reduce": 1,
                       "linear_attention_apply": 1}),
    "gat": (None, dict(chunk_dtype="bf16"), {"csr_spmm_ev": 2}),
}


@pytest.mark.parametrize("kind", sorted(EXPORT_KINDS))
def test_exported_forward_on_the_card_is_bitwise_the_predictors(cuda, tmp_path, kind):
    """``export_artifact`` on the card, ``load_exported``, and the program
    called with ``export_leaves()``: the predictor's logits bit for bit,
    through the same kernel launches."""
    from sgformer_tpu_torch import load_exported
    from sgformer_tpu_torch.nn import GAT

    dtype, options, launches = EXPORT_KINDS[kind]
    rng = np.random.default_rng(2)
    n = 1200
    ei = np.concatenate([rng.integers(0, n, (2, 8000)),
                         np.stack([np.arange(300), np.full(300, 7)])], axis=1)  # a hub row
    x = rng.standard_normal((n, 24)).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    if dtype is None:
        model = GAT(24, 64, 5, heads=2, generator=gen, device=cuda)
    else:
        model = SGFormer(SGFormerConfig.large(64, 5, gnn_num_layers=3, compute_dtype=dtype), 24,
                         generator=gen, device=cuda)
    pred = Predictor(model, preprocess_graph(ei, n, device=cuda, **options), x,
                     device=cuda).compile()
    program = load_exported(pred.export_artifact(str(tmp_path / "forward.pt2")))
    want = pred._forward()
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = program.module()(*pred.export_leaves())
    torch.cuda.synchronize()
    assert {k: v for k, v in kernels.launch_counts().items() if v} == launches
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [256, 40])
def test_csr_spmm_on_a_rectangular_a_matches_plain(cuda, dtype, width):
    """A node shard's CSR: 300 rows over 1,000 columns (the gathered rows),
    a hub row of 500 edges split into segments; the gradient through the
    CSR of Aᵀ (1,000 rows over 300 columns)."""
    from sgformer_tpu_torch.parallel.partition import ShardCsr

    rng = np.random.default_rng(3)
    rows, cols = 300, 1000
    dst = np.sort(np.concatenate([rng.integers(0, rows, 4000), np.full(500, 7)]))
    src = rng.integers(0, cols, dst.shape[0])
    # weights of the GCN's scale: each row's sum near 1
    w = (rng.uniform(0.5, 1.5, dst.shape[0]) / np.bincount(dst)[dst]).astype(np.float32)
    a = ShardCsr.build(src, dst, w, rows, cols, cuda)
    assert a.fwd_segments.shape[0] > 0
    x = torch.randn(cols, width, device=cuda).to(dtype).requires_grad_(True)
    before = kernels.spmm.launches
    out = a(x)
    assert out.shape == (rows, width) and kernels.spmm.launches == before + 1
    want = spmm(x.detach(), a.fwd[1], a.fwd[2], a.fwd[3], rows)
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    _close_to_exact(out.detach(), x.detach(), a.fwd[1], a.fwd[2], a.fwd[3], rows)
    g = torch.randn(rows, width, device=cuda).to(dtype)
    out.backward(g)
    assert kernels.spmm.launches == before + 2
    want_dx = spmm(g, a.bwd[1], a.bwd[2], a.bwd[3], cols)
    torch.testing.assert_close(x.grad.float(), want_dx.float(), **TOL[dtype])
    _close_to_exact(x.grad, g, a.bwd[1], a.bwd[2], a.bwd[3], cols)
    assert torch.equal(a(x.detach()), out.detach())


@pytest.mark.parametrize("halo", [False, True])
def test_world_one_nccl_sharded_step_matches_the_trainer(cuda, halo):
    """A group of one on NCCL: the sharded step (one collective a layer and
    pass, each a copy) against the one-device Trainer's, f32, dropout 0:
    loss 1e-5, ‖Δg‖/‖g‖ ≤ 1e-4, eval logits 1e-5 of the largest; a step's
    csr_spmm launches 2 a GraphConv layer (all-gather) or 6 (halo: the send
    gather, the local and the remote CSR, forward and backward)."""
    from sgformer_tpu_torch.data import synthetic_dataset
    from sgformer_tpu_torch.parallel import ShardedTrainer, make_mesh
    from sgformer_tpu_torch.train import TrainConfig, Trainer

    mesh = make_mesh("sp", device="cuda")
    assert mesh.size == 1 and mesh.backend == "nccl"
    ds = synthetic_dataset(num_nodes=2000, num_edges=12000, num_features=32, num_classes=5,
                           seed=1, device="cpu")
    graph = preprocess_graph(ds.graph["edge_index"], 2000, device=cuda)
    out = {}
    for axis in (None, "sp"):
        cfg = SGFormerConfig.large(64, 5, gnn_num_layers=2, trans_dropout=0.0, gnn_dropout=0.0,
                                   axis_name=axis)
        model = SGFormer(cfg, 32, device=cuda)
        tc = TrainConfig(lr=1e-3)
        tr = (Trainer(model, graph, ds.graph["node_feat"], ds.label, tc, device=cuda)
              if axis is None else
              ShardedTrainer(model, graph, ds.graph["node_feat"], ds.label, tc, mesh=mesh,
                             use_halo=halo))
        tr.init_state(0)
        idx = tr.prepare_train_idx({"train": np.arange(0, 2000, 2)})
        logits = tr.eval_step()
        kernels.reset_launch_counts()
        loss = tr.train_step(idx)
        out[axis] = (logits, loss, {k: p.grad.clone() for k, p in model.named_parameters()},
                     kernels.launch_counts())
    (l0, loss0, g0, _), (l1, loss1, g1, counts) = out[None], out["sp"]
    torch.testing.assert_close(l1, l0, rtol=0, atol=1e-5 * l0.abs().max().item())
    torch.testing.assert_close(loss1, loss0, rtol=1e-5, atol=0)
    diff = torch.sqrt(sum(((g1[k] - g) ** 2).sum() for k, g in g0.items()))
    norm = torch.sqrt(sum((g ** 2).sum() for g in g0.values()))
    assert diff <= 1e-4 * norm
    assert counts["csr_spmm"] == (12 if halo else 4)
    assert counts["linear_attention_reduce"] == counts["linear_attention_bwd_apply"] == 1


def _walk_graph(cuda):
    """A power-law graph on the card: rows of every length from 1 to
    several hundred edges (the lane groups' walkers prefetch a row's first
    64), and hub rows above the plan's segment length; with its walk order
    (``Graph.schedule``)."""
    from sgformer_tpu_torch.data import synthetic_dataset

    ds = synthetic_dataset(num_nodes=6000, num_edges=60_000, num_features=4, num_classes=8,
                           powerlaw=1.1, seed=5, device="cpu")
    g = preprocess_graph(ds.graph["edge_index"], 6000, device=cuda)
    deg = torch.diff(g.indptr)
    assert g.schedule is not None and int(deg.max()) > 256 and int((deg > 64).sum()) > 10
    return g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [256, 64, 40])
@pytest.mark.parametrize("segment", [128, 256])
def test_walk_order_gives_the_node_order_walk_bitwise(cuda, dtype, width, segment):
    """``csr_spmm`` walked in the graph's order, and in a random one, is
    bitwise the walk in node order (each row summed edge for edge, written in
    place), through hub plans of 128 and 256 edges; and held to the plain
    version at the file's tolerances."""
    g = _walk_graph(cuda)
    n = g.num_nodes
    csr = (g.indptr, g.edge_src, g.edge_dst, g.gcn_weight)
    plan = (spmm_kernel.hub_plan(g.indptr, segment), segment)
    x = torch.randn(n, width, device=cuda).to(dtype)
    base = csr_spmm(x, *csr, *plan)
    shuffled = torch.randperm(n, generator=torch.Generator().manual_seed(1)).int().to(cuda)
    for order in (g.schedule, shuffled):
        before = spmm_kernel.launches
        got = csr_spmm(x, *csr, *plan, schedule=order)
        assert spmm_kernel.launches == before + 1
        assert torch.equal(got, base)
    want = spmm(x, g.edge_src, g.edge_dst, g.gcn_weight, n)
    torch.testing.assert_close(base.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [256, 40])
def test_walk_order_on_a_rectangular_a(cuda, dtype, width):
    """A node shard's rectangular CSR (300 rows over 1,000 columns, a hub
    row of 500 edges) walked in a random order of its rows, and its Aᵀ in
    one of its columns: bitwise the node-order walks, and the plain sums'."""
    from sgformer_tpu_torch.kernels.spmm import HUB_EDGES
    from sgformer_tpu_torch.parallel.partition import ShardCsr

    rng = np.random.default_rng(3)
    rows, cols = 300, 1000
    dst = np.sort(np.concatenate([rng.integers(0, rows, 4000), np.full(500, 7)]))
    src = rng.integers(0, cols, dst.shape[0])
    w = (rng.uniform(0.5, 1.5, dst.shape[0]) / np.bincount(dst)[dst]).astype(np.float32)
    a = ShardCsr.build(src, dst, w, rows, cols, cuda)
    x = torch.randn(cols, width, device=cuda).to(dtype)
    g = torch.randn(rows, width, device=cuda).to(dtype)
    for csr, plan, inp, n_rows, n_cols in ((a.fwd, a.fwd_segments, x, rows, cols),
                                           (a.bwd, a.bwd_segments, g, cols, rows)):
        order = torch.from_numpy(rng.permutation(n_rows)).int().to(cuda)
        got = csr_spmm(inp, *csr, plan, HUB_EDGES, n_cols, schedule=order)
        assert torch.equal(got, csr_spmm(inp, *csr, plan, HUB_EDGES, n_cols))
        want = spmm(inp, csr[1], csr[2], csr[3], n_rows)
        torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("msg_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,d", [(2, 256), (2, 40), (3, 64)])
def test_walk_order_in_the_edge_value_walks(cuda, msg_dtype, heads, d):
    """``csr_spmm_ev`` in the graph's walk order (one, two and three heads of
    values) and ``csr_spmm_ev_bwd`` in its transposed CSR's: bitwise the
    node-order walks; against the plain
    versions relative to the largest value and against the exact sums
    (``_close_to_exact``), the tolerances of this file's hub-row tests, since
    rows of up to 708 edges sum in another order than the plain version's."""
    g = _walk_graph(cuda)
    n, e = g.num_nodes, g.num_edges
    csr = (g.indptr, g.edge_src, g.edge_dst)
    x = torch.randn(n, heads, d, device=cuda)
    v = torch.rand(e, heads, device=cuda)
    xm = x.to(msg_dtype)
    plan = (g.hub_segments, g.hub_edges)
    got = csr_spmm_ev(xm, *csr, v, torch.float32, *plan, schedule=g.schedule)
    assert torch.equal(got, csr_spmm_ev(xm, *csr, v, torch.float32, *plan))
    want = spmm_edge_values(xm, g.edge_src, g.edge_dst, v, n, torch.float32)
    _check_rel(got, want, 1e-5)
    _close_to_exact(got, xm, g.edge_src, g.edge_dst, v, n)
    cot = torch.randn(n, heads, d, device=cuda)
    t_csr = (g.t_indptr, g.t_edge_src, g.t_edge_dst, g.t_perm)
    t_plan = (g.t_hub_segments, g.hub_edges)
    dx, dv = csr_spmm_ev_bwd(cot, x, v, *t_csr, msg_dtype, *t_plan,
                             t_schedule=g.walk_orders[1])
    dx0, dv0 = csr_spmm_ev_bwd(cot, x, v, *t_csr, msg_dtype, *t_plan)
    assert torch.equal(dx, dx0) and torch.equal(dv, dv0)
    want_dx, want_dv = spmm_edge_values_backward(cot, x, v, g.t_edge_src, g.t_edge_dst,
                                                 g.t_perm, msg_dtype)
    _check_rel(dx, want_dx, 1e-5)
    _close_to_exact(dx, cot.to(msg_dtype), g.t_edge_src, g.t_edge_dst, v[g.t_perm.long()], n)
    _check_rel(dv, want_dv, 1e-5)
