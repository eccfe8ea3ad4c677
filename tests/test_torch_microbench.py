"""The timing probes' plain versions (``sgformer_tpu_torch.microbench``, and
each kernel wrapper's CPU path) against what the JAX package's inline Pallas
probes compute. Those kernels are closures inside each script's ``main()``
behind a TPU check, so a test cannot call them; each test here holds the
port to a numpy transcription of the Pallas body, step by step, and states
it. ``slab_variant``'s ``prod`` mode is held to the JAX ``slab_spmm`` itself,
in interpret mode.

Tolerances: f32 sums of the same terms in another order, 1e-5 relative to
the largest sum (1e-6 absolute); where the Pallas body rounds its one-hot
weights and messages to bf16, one bf16 rounding of each term: 1e-2 of the
largest magnitude."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgformer_tpu.kernels.slab_spmm import slab_spmm
from sgformer_tpu.kernels.slabs import build_slabs

from sgformer_tpu_torch import kernels
from sgformer_tpu_torch.graph import preprocess_graph
from sgformer_tpu_torch.microbench import dma_gather, dma_tile, slab_variants
from sgformer_tpu_torch.utils import measure

torch.set_num_threads(1)


def _close(got, want, rel=1e-5):
    got = np.asarray(got, dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max() + 1e-6)


def test_dma_gather_draws_its_inputs_as_the_script_does():
    x, idx = dma_gather.make_inputs("cpu", n=1000, e=2048, f=16)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(idx.numpy(), rng.integers(0, 1000, 2048))
    want_x = torch.from_numpy(rng.standard_normal((1000, 16))).to(torch.bfloat16)
    assert torch.equal(x, want_x)


@pytest.mark.parametrize("chunk", [512, 64])
def test_gather_rows_is_the_pallas_body_at_every_step(chunk):
    """``microbench_dma_gather.py``'s ``dma_kernel``, transcribed: at grid
    step i the S-deep DMA ring copies row ``idx[i, j]`` into scratch row j
    for every j < C, then ``out = sum(scratch.reshape(8, C/8, F), axis=1)``
    in f32. The TPU output block is overwritten each step, so the kernel
    returns the last step's; the port returns every step's."""
    n, e, f = 1000, 2048, 32
    x, idx = dma_gather.make_inputs("cpu", n=n, e=e, f=f)
    got = dma_gather.gather_rows(x, idx, chunk=chunk)
    assert got.shape == (e // chunk, 8, f) and got.dtype == torch.float32
    xn, ids = x.float().numpy(), idx.numpy().reshape(e // chunk, 1, chunk)
    for i in range(e // chunk):
        scratch = np.empty((chunk, f), np.float32)
        for j in range(chunk):
            scratch[j] = xn[ids[i, 0, j]]
        _close(got[i].numpy(), scratch.reshape(8, chunk // 8, f).astype(np.float64).sum(1))
    # the last step is what the TPU kernel returns
    assert torch.equal(got[-1], dma_gather.gather_rows_plain(x, idx, chunk)[-1])


def test_dma_tile_draws_its_inputs_as_the_script_does():
    x, idx = dma_tile.make_inputs("cpu", n=512, f=8, e=512, chunk=256)
    rng = np.random.default_rng(0)
    assert torch.equal(x, torch.from_numpy(rng.standard_normal((512, 8))).to(torch.bfloat16))
    for s in dma_tile.STAGES:  # one draw per S, in the script's order
        np.testing.assert_array_equal(idx[s].numpy(),
                                      rng.integers(0, 64, (2, 1, 256)).reshape(-1))


@pytest.mark.parametrize("chunk", [256, 64])
def test_gather_tiles_is_the_pallas_body_at_every_step(chunk):
    """``microbench_dma_tile.py``'s ``dma_kernel``, transcribed: at grid step
    i tile j lands in scratch rows ``[8j, 8j + 8)`` from x rows
    ``[8 idx[i, j], 8 idx[i, j] + 8)``, then ``out = sum(scratch.reshape(8,
    C, F), axis=1)`` in f32."""
    n, e, f = 2048, 1024, 16
    x, idx = dma_tile.make_inputs("cpu", n=n, f=f, e=e, chunk=chunk, stages=(8,))
    got = dma_tile.gather_tiles(x, idx[8], chunk=chunk, stages=8)
    assert got.shape == (e // chunk, 8, f)
    xn, ids = x.float().numpy(), idx[8].numpy().reshape(e // chunk, 1, chunk)
    for i in range(e // chunk):
        scratch = np.empty((chunk * 8, f), np.float32)
        for j in range(chunk):
            base = ids[i, 0, j] * 8
            scratch[8 * j:8 * j + 8] = xn[base:base + 8]
        _close(got[i].numpy(), scratch.reshape(8, chunk, f).astype(np.float64).sum(1))


def _chip_smoke():
    """``chip_smoke.py`` at the repository's root, as a module (it imports
    torch and the port's measurement helpers, nothing of JAX)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_for_tests", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# the plans at the scripts' sizes on 132 SMs: S -> (blocks an SM, grid)
ROWS_PLANS = {4: (8, 1056), 8: (6, 792), 16: (3, 396), 32: (1, 132)}
TILES_PLANS = {8: (6, 792), 32: (1, 132)}


@pytest.mark.parametrize("stages", dma_gather.STAGES)
def test_gather_rows_plan_at_the_scripts_sizes(stages):
    """8 warps x S rows of 256 bf16 a block: the SM's 228 KB (1 KB a block
    kept) hold 13 blocks at S = 4, which the 2,048 threads cut to 8, then 6,
    3 and 1; the persistent grid is one block a slot of the 132 SMs, fewer
    than the 2,048 chunks, and a tail of one chunk takes one block."""
    p = dma_gather.plan(dma_gather.E // dma_gather.C, dma_gather.F, stages, sms=132)
    assert p["ring_bytes"] == 8 * stages * 256 * 2 and p["threads"] == 256
    assert (p["blocks_per_sm"], p["grid"]) == ROWS_PLANS[stages]
    assert dma_gather.plan(1, dma_gather.F, stages, sms=132)["grid"] == 1
    # the card's occupancy query, where it counts registers too, decides
    assert dma_gather.plan(2048, 256, stages, sms=132, resident=2)["grid"] == 264


@pytest.mark.parametrize("stages", dma_tile.STAGES)
def test_gather_tiles_plan_at_the_scripts_sizes(stages):
    """gcd(S, 8) = 8 warps (256 threads, 8 an SM by threads); S mbarriers
    padded to 128 bytes and S tiles of 4 KB: 6 blocks an SM at S = 8, 1 at S
    = 32; the grid covers the 1,024 steps' slots, and a tail of one step
    takes one block."""
    p = dma_tile.plan(dma_tile.E // dma_tile.C, dma_tile.F, stages, sms=132)
    assert p["warps"] == 8 and p["threads"] == 256
    assert p["smem_bytes"] == -(-stages * 8 // 128) * 128 + stages * 4096
    assert (p["blocks_per_sm"], p["grid"]) == TILES_PLANS[stages]
    assert dma_tile.plan(1, dma_tile.F, stages, sms=132)["grid"] == 1


@pytest.mark.parametrize("n_items,grid", [(2048, 396), (1024, 792), (5, 132), (1, 1), (7, 7)])
def test_persistent_blocks_walk_every_item_once(n_items, grid):
    """Block b walks items b, b + grid, ...; the kernels count them as
    (n - 1 - b) // grid + 1 (``total`` over the chunk's or step's rows)."""
    grid = min(grid, n_items)
    seen = []
    for b in range(grid):
        mine = list(range(b, n_items, grid))
        assert len(mine) == (n_items - 1 - b) // grid + 1
        seen += mine
    assert sorted(seen) == list(range(n_items))


@pytest.mark.parametrize("stages", [1, 2, 3, 4, 6, 8, 12, 32, 56])
def test_gather_tiles_slots_each_serve_one_consumer_warp(stages):
    """The kernel's stream: position p of a step is tile p // 8 of group
    p % 8, stream position k lands in slot k % S and is summed by warp k %
    W, W = gcd(S, 8) warps: every slot serves one warp only (which waits on
    its uses in order and refills it), each warp takes its groups' tiles in
    index order, and every tile of a step is taken once."""
    warps = dma_tile.plan(4, 256, stages)["warps"]
    assert warps == np.gcd(stages, 8) and stages % warps == 0
    chunk = 64
    owner, taken = {}, {}
    for k in range(3 * chunk):  # three steps of one block's stream
        step, p = divmod(k, chunk)
        group, tile = p % 8, p // 8
        assert owner.setdefault(k % stages, k % warps) == k % warps
        assert group % warps == k % warps
        taken.setdefault((step, group), []).append(tile)
    assert all(t == list(range(chunk // 8)) for t in taken.values())


def test_gather_tiles_refuses_a_ring_past_shared_memory():
    """The ring's bytes as the kernel lays them out: at F = 256, 56 slots
    fit the 227 KB a block may take, 57 do not."""
    assert dma_tile.smem_bytes(256, 56) <= 227 * 1024 < dma_tile.smem_bytes(256, 57)
    assert dma_tile.smem_bytes(256, 8) == 128 + 8 * 4096
    assert dma_tile.smem_bytes(256, 32) == 256 + 32 * 4096


@pytest.mark.parametrize("reorder", [False, True])
def test_csr_gather_stream_is_edge_src_row_by_row(reorder):
    """K3's ids (``chip_smoke.csr_gather_stream``): ``edge_src`` of each row
    in ``Graph.schedule``'s order, then in node order, cut to a multiple of
    C, against a numpy loop over the rows; a graph with no walk order
    (``reorder=True``) takes node order both times."""
    cs = _chip_smoke()
    ei, n = _clustered_edges(1, n=300, e=1500)
    g = preprocess_graph(ei, n, device="cpu", reorder=reorder)
    assert (g.schedule is None) == reorder
    indptr, src = g.indptr.numpy(), g.edge_src.numpy()
    order = np.arange(n) if g.schedule is None else g.schedule.numpy()
    walk = np.concatenate([src[indptr[r]:indptr[r + 1]] for r in order])
    for chunk in (64, 512):
        keep = len(src) // chunk * chunk
        for is_walk, want in ((True, walk), (False, src)):
            got, cut = cs.csr_gather_stream(g, chunk, is_walk)
            assert got.dtype == torch.int32 and got.is_contiguous()
            np.testing.assert_array_equal(got.numpy(), want[:keep])
            assert cut == len(src) - keep
    assert not np.array_equal(walk, src) or reorder


@pytest.mark.parametrize("kind", ["rows", "tiles"])
def test_probe_sums_in_the_kernels_order(kind):
    """``chip_smoke.rows_in_order`` and ``tiles_in_order`` (the sums the
    card's digests are read against) add each group's terms one at a time
    in the kernels' order: bitwise a scalar f32 loop, and within the probes'
    tolerance of the plain versions."""
    cs = _chip_smoke()
    if kind == "rows":
        x, idx = dma_gather.make_inputs("cpu", n=500, e=1024, f=16)
        got = cs.rows_in_order(x, idx, 128)
        plain = dma_gather.gather_rows_plain(x, idx, 128)
        terms = lambda c, r: [idx[c * 128 + r * 16 + j].item() for j in range(16)]
    else:
        x, tidx = dma_tile.make_inputs("cpu", n=512, f=16, e=256, chunk=64, stages=(8,))
        idx = tidx[8]
        got = cs.tiles_in_order(x, idx, 64)
        plain = dma_tile.gather_tiles_plain(x, idx, 64)
        terms = lambda c, r: [8 * idx[c * 64 + r * 8 + j].item() + i
                              for j in range(8) for i in range(8)]
    xf = x.float().numpy()
    for c, r in ((0, 0), (1, 5), (got.shape[0] - 1, 7)):
        acc = np.zeros(16, np.float32)
        for row in terms(c, r):
            acc = (acc + xf[row]).astype(np.float32)
        assert np.array_equal(got[c, r].numpy(), acc)
    _close(got.numpy(), plain.numpy().astype(np.float64))


@pytest.mark.parametrize("probe,bad,error", [
    ("rows", dict(chunk=100), ValueError),            # chunk % 8
    ("rows", dict(chunk=1024), ValueError),           # E % chunk
    ("rows", dict(x_dtype=torch.float32), TypeError),
    ("rows", dict(idx_dtype=torch.int64), TypeError),
    ("rows", dict(x_shape=(104, 8, 1)), TypeError),
    ("tiles", dict(chunk=12), ValueError),
    ("tiles", dict(chunk=1024), ValueError),
    ("tiles", dict(x_rows=99), TypeError),           # N % 8
    ("tiles", dict(idx_dtype=torch.int64), TypeError),
    ("tiles", dict(x_dtype=torch.float32), TypeError),
])
def test_gather_wrappers_refuse_what_the_kernels_cannot_take(probe, bad, error):
    """The refusals each wrapper makes before it picks the kernel or the
    plain version, on CPU tensors as on the card."""
    x, idx = dma_gather.make_inputs("cpu", n=104, e=512, f=8)
    if "x_rows" in bad:
        x = x[:bad["x_rows"]]
    if "x_dtype" in bad:
        x = x.to(bad["x_dtype"])
    if "x_shape" in bad:
        x = x.reshape(bad["x_shape"])
    if "idx_dtype" in bad:
        idx = idx.to(bad["idx_dtype"])
    chunk = bad.get("chunk", 64)
    with pytest.raises(error):
        if probe == "rows":
            dma_gather.gather_rows(x, idx, chunk=chunk)
        else:
            dma_tile.gather_tiles(x, idx % 13, chunk=chunk)


def test_probe_wrappers_reject_what_their_kernels_cannot_take():
    x, idx = dma_gather.make_inputs("cpu", n=100, e=512, f=8)
    with pytest.raises(ValueError):
        dma_gather.gather_rows(x, idx, chunk=100)
    with pytest.raises(TypeError):
        dma_gather.gather_rows(x.float(), idx)
    with pytest.raises(TypeError):
        dma_tile.gather_tiles(x[:99], idx, chunk=512)
    g = preprocess_graph(np.array([[0, 1], [1, 0]]), 200, device="cpu")
    xs = slab_variants.make_x(200, "cpu", f=8)
    with pytest.raises(ValueError):
        slab_variants.slab_variant(xs, g.indptr, g.edge_src, g.edge_dst, g.gcn_weight, "x")


def _clustered_edges(seed, n=600, e=3000, k=5, homophily=0.85):
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, k, n)
    src = rng.integers(0, n, e)
    same = rng.random(e) < homophily
    order = np.argsort(lab, kind="stable")
    starts = np.searchsorted(lab[order], np.arange(k))
    ends = np.searchsorted(lab[order], np.arange(k), side="right")
    ls, le = starts[lab[src]], ends[lab[src]]
    dst_same = order[ls + (rng.random(e) * (le - ls)).astype(np.int64)]
    dst = np.where(same, dst_same, rng.integers(0, n, e))
    return np.stack([src, dst]).astype(np.int64), n


@pytest.fixture(scope="module")
def variant_problem():
    ei, n = _clustered_edges(0)
    g = preprocess_graph(ei, n, device="cpu")
    x = slab_variants.make_x(n, "cpu", f=48)
    return g, x


def test_slab_variant_prod_matches_jax_slab_spmm_interpret(variant_problem):
    """prod against the JAX meta-mode slab SpMM (``_slab_kernel`` for the
    intra-slab edges, ``_spmm_kernel`` for the cross-slab ones, the
    self-loop term), f32 in interpret mode, on the same edges, weights and
    (bf16-valued) x: A_norm @ x, summation order apart."""
    g, x = variant_problem
    s, d, w = (t.numpy() for t in (g.edge_src, g.edge_dst, g.gcn_weight))
    plan = build_slabs(s, d, w, g.num_nodes, window_rows=64, block_rows=64, chunk_edges=128,
                       chunks_per_step=2, slab_rows=256)
    assert plan.fwd.meta is not None and plan.fwd.remote is not None
    want = np.asarray(slab_spmm(jnp.asarray(x.float().numpy()), plan,
                                compute_dtype=jnp.float32, interpret=True))
    got = slab_variants.slab_variant(x, g.indptr, g.edge_src, g.edge_dst, g.gcn_weight, "prod")
    assert got.dtype == torch.float32
    _close(got.numpy(), want)


def _bf16(a):
    return np.asarray(jnp.asarray(a, dtype=jnp.bfloat16).astype(jnp.float32))


def test_slab_variant_static_sub_is_the_pallas_body(variant_problem):
    """``microbench_slab_variants.py``'s ``make_variant("static_sub")``,
    transcribed over a one-slab meta plan with block_rows = 128: at each grid
    step, for each chunk, the weighted one-hot (bf16) times
    ``slab[0:128]``, the f32 messages rounded to bf16, summed into the
    window's rows. With the slab at row 0 the chunk's ``lsrc`` (the source
    within its 128-row sub-block) is ``src % 128``. The variant leaves out
    the self-loops that ``build_slabs`` pulls out of the plan; the test adds
    them the same way (``w_self[i] * x[i % 128]``)."""
    g, x = variant_problem
    n = g.num_nodes
    s, d, w = (t.numpy() for t in (g.edge_src, g.edge_dst, g.gcn_weight))
    plan = build_slabs(s, d, w, n, window_rows=64, block_rows=128, chunk_edges=128,
                       chunks_per_step=2, slab_rows=1024, min_pair=1)
    side = plan.fwd
    assert side.remote is None and side.meta is not None and side.block_rows == 128
    W, B, C, Q = side.window_rows, side.block_rows, side.chunk_edges, side.chunks_per_step
    meta = np.asarray(side.meta)
    xn = x.float().numpy()
    xpad = np.zeros((plan.n_pad, xn.shape[1]), np.float32)
    xpad[:n] = xn
    out = np.zeros((side.num_rows_out, xn.shape[1]), np.float64)
    for i in range(side.n_steps):
        base = int(np.asarray(side.slab_id)[i]) * side.base_rows
        slab = xpad[base:base + side.slab_rows]
        win = int(np.asarray(side.window_id)[i])
        for q in range(Q):
            lsrc, ldst = meta[i, q], meta[i, Q + q]
            wq = _bf16(meta[i, 2 * Q + q].view(np.float32))
            msgs = _bf16(wq[:, None] * slab[0:B][lsrc])  # [C, F]
            np.add.at(out, win * W + ldst, msgs)
    out = out[:n] + np.asarray(plan.w_self)[:n, None] * xn[np.arange(n) % B]
    got = slab_variants.slab_variant(x, g.indptr, g.edge_src, g.edge_dst, g.gcn_weight,
                                     "static_sub")
    _close(got.numpy(), out, rel=1e-2)
    # and its formula exactly as the port states it, in f32
    want = np.zeros_like(out)
    np.add.at(want, d, w[:, None].astype(np.float64) * xn[s % B])
    _close(got.numpy(), want)


def test_slab_variant_no_src_matmul_formula(variant_problem):
    """no_src_matmul keeps the row walk and the weights and sends the
    destination's own row, ``(1.0001 * w_e) * x[i]``: the TPU body's
    messages (the first C rows of the sub-block, whatever the edges) have no
    counterpart in a CSR row kernel, so it is held to this formula,
    transcribed row by row."""
    g, x = variant_problem
    indptr, w = g.indptr.numpy(), g.gcn_weight.numpy()
    xn = x.float().numpy().astype(np.float64)
    want = np.zeros_like(xn)
    for i in range(g.num_nodes):
        for e in range(indptr[i], indptr[i + 1]):
            want[i] += float(np.float32(1.0001) * w[e]) * xn[i]
    got = slab_variants.slab_variant(x, g.indptr, g.edge_src, g.edge_dst, g.gcn_weight,
                                     "no_src_matmul")
    _close(got.numpy(), want)


def test_probe_launch_counts_stay_zero_on_the_cpu(variant_problem):
    g, x = variant_problem
    kernels.reset_launch_counts()
    slab_variants.slab_variant(x, g.indptr, g.edge_src, g.edge_dst, g.gcn_weight, "prod")
    xr, idx = dma_gather.make_inputs("cpu", n=100, e=512, f=8)
    dma_gather.gather_rows(xr, idx)
    xt, tidx = dma_tile.make_inputs("cpu", n=64, f=8, e=64, chunk=16, stages=(8,))
    dma_tile.gather_tiles(xt, tidx[8], chunk=16)
    counts = kernels.launch_counts()
    assert {"gather_rows", "gather_tiles", "slab_variant"} <= set(counts)
    assert not any(counts.values())


def test_probe_launches_share_the_kernels_registry():
    kernels.probe_launches["gather_tiles"] = 3
    assert kernels.launch_counts()["gather_tiles"] == 3
    kernels.reset_launch_counts()
    assert kernels.launch_counts()["gather_tiles"] == 0


@pytest.mark.parametrize("nbytes,ops,dtype,by", [
    (3.35e9, 0.0, torch.bfloat16, "bytes"),           # 1 ms of bytes, no work
    (0.0, 989e9, torch.bfloat16, "operations"),       # 1 ms of bf16 tensor-core work
    (3.35e9, 1979e9, torch.int8, "bytes"),            # 1 ms each: ties go to bytes
    (3.35e6, 165e9, torch.float32, "operations"),     # 1 us of bytes, 1 ms of 3xTF32 f32
])
def test_bound_takes_the_larger_of_bytes_and_operations(nbytes, ops, dtype, by):
    ms, got_by = measure.bound_ms(nbytes, ops, dtype)
    assert (ms, got_by) == (pytest.approx(1.0), by)


def test_rel_err_measures_against_the_plain_scale_and_refuses_non_finite():
    want = torch.tensor([1.0, -4.0, 2.0])
    err, scale = measure.rel_err(torch.tensor([1.5, -4.0, 2.0], dtype=torch.bfloat16), want)
    assert (err, scale) == (0.5, 4.0)
    assert measure.rel_err(torch.empty(0), torch.empty(0)) == (0.0, 0.0)
    with pytest.raises(AssertionError, match="not finite"):
        measure.rel_err(torch.tensor([float("nan"), 0.0, 0.0]), want)
