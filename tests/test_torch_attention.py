"""The port's linear attention (the reduce/apply wrappers' CPU path and the
plain version) against the JAX package: its Pallas ``fused_linear_attention``
(reduce and apply kernels, interpret mode) and its XLA
``linear_attention``; forward, and the gradient that the port's autograd
Function computes through the backward wrappers' CPU path
(``bwd_reduce_plain``, ``bwd_apply_plain``).

Tolerances: f32 1e-5 (summation order only); bf16 2e-2, because the Pallas
apply rounds kvs to bf16 before its product (kernels/attention.py:83), the
Pallas backward rounds gd, kvs and P (kernels/attention.py:234-249), and the
XLA path rounds its bf16 products differently, while the port keeps kvs, P
and every sum in f32. Gradients are compared against each tensor's largest
magnitude: at these sizes dq and dk are ~1e-4 of dv."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgformer_tpu.kernels.attention import _apply as jax_apply
from sgformer_tpu.kernels.attention import _reduce as jax_reduce
from sgformer_tpu.kernels.attention import fused_linear_attention as jax_fused
from sgformer_tpu.ops.attention import linear_attention as jax_linear_attention

from sgformer_tpu_torch.kernels import attention as attn
from sgformer_tpu_torch.kernels.attention import fused_linear_attention
from sgformer_tpu_torch.ops.attention import linear_attention
from sgformer_tpu_torch.utils.measure import (apply_product_inputs, bwd_product_inputs,
                                              bwd_reduce_product_inputs)

torch.set_num_threads(1)

TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}


def _qkv(seed, n=300, h=1, m=16, d=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, h, m)).astype(np.float32),
            rng.standard_normal((n, h, m)).astype(np.float32),
            rng.standard_normal((n, h, d)).astype(np.float32))


def _both(arrays, dtype):
    jx = [jnp.asarray(a).astype(JNP[dtype]) for a in arrays]
    tx = [torch.from_numpy(a).to(TORCH[dtype]) for a in arrays]
    return jx, tx


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
def test_fused_matches_jax_pallas_interpret(dtype, masked):
    q, k, v = _qkv(0, h=1)
    mask = (np.arange(q.shape[0]) % 7 != 3).astype(np.float32) if masked else None
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), dtype)
    want = jax_fused(jq, jk, jv, node_mask=None if mask is None else jnp.asarray(mask),
                     block=128, interpret=True)
    got = fused_linear_attention(tq, tk, tv,
                                 node_mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == TORCH[dtype] and got.shape == tuple(want.shape)
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
def test_linear_attention_matches_jax_xla(dtype, masked):
    q, k, v = _qkv(1, h=2)
    mask = (np.arange(q.shape[0]) % 5 != 0).astype(np.float32) if masked else None
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), dtype)
    want = jax_linear_attention(jq, jk, jv,
                                node_mask=None if mask is None else jnp.asarray(mask))
    got = linear_attention(tq, tk, tv,
                           node_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_multihead_takes_one_norm_over_heads(dtype):
    """At H > 1 the port scales q and k by one norm over all heads, as the
    reference and the JAX XLA path do; the JAX Pallas path loops a
    single-head kernel with per-head norms and so answers differently."""
    q, k, v = _qkv(7, n=40, h=2)  # few rows: the attention term is not tiny
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), dtype)
    got = _f32(fused_linear_attention(tq, tk, tv))
    np.testing.assert_allclose(got, _f32(jax_linear_attention(jq, jk, jv)), **TOL[dtype])
    if dtype == "f32":
        per_head = _f32(jax_fused(jq, jk, jv, block=128, interpret=True))
        assert np.abs(got - per_head).max() > 100 * TOL[dtype]["atol"]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_cpu_path_equals_plain(dtype):
    """The wrappers' CPU path (reduce_plain + apply_plain per head) and the
    plain whole function compute the same f32 sums; they differ by the last
    bits of the einsum order at most."""
    q, k, v = _qkv(2, h=2)
    _, (tq, tk, tv) = _both((q, k, v), dtype)
    got = fused_linear_attention(tq, tk, tv)
    want = linear_attention(tq, tk, tv)
    tol = {"f32": dict(rtol=1e-6, atol=1e-6), "bf16": dict(rtol=8e-3, atol=8e-3)}
    np.testing.assert_allclose(_f32(got), _f32(want), **tol[dtype])


def test_all_masked_group_stays_finite():
    """Zero norms (an all-masked padded group) must give finite zeros, as the
    guarded XLA path does; the Pallas apply's unguarded rsqrt
    (kernels/attention.py:79) is inf there, so the port follows XLA."""
    q, k, v = _qkv(3)
    mask = np.zeros(q.shape[0], np.float32)
    want = np.asarray(jax_linear_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), node_mask=jnp.asarray(mask)))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    for fn in (fused_linear_attention, linear_attention):
        got = fn(tq, tk, tv, node_mask=torch.from_numpy(mask)).numpy()
        assert np.isfinite(got).all()
        np.testing.assert_array_equal(got, want)


def test_output_attn_matches_jax():
    q, k, v = _qkv(4, n=120, h=2)
    want_out, want_attn = jax_linear_attention(jnp.asarray(q), jnp.asarray(k),
                                               jnp.asarray(v), output_attn=True)
    got_out, got_attn = linear_attention(torch.from_numpy(q), torch.from_numpy(k),
                                         torch.from_numpy(v), output_attn=True)
    assert got_attn.shape == (120, 120)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_attn.numpy(), np.asarray(want_attn), rtol=1e-5, atol=1e-7)


def test_reduce_and_apply_match_jax_partials():
    """The reduced quantities the two passes hand over (kvs, Σk, ‖q‖², ‖k‖²)
    are the JAX reduce kernel's, in f32."""
    from sgformer_tpu.kernels.attention import _reduce

    q, k, v = _qkv(5)
    jkvs, jksum, jscal = _reduce(jnp.asarray(q[:, 0]), jnp.asarray(k[:, 0]),
                                 jnp.asarray(v[:, 0]), 128, True)
    kvs, ksum, scal = attn.reduce(torch.from_numpy(q[:, 0]), torch.from_numpy(k[:, 0]),
                                  torch.from_numpy(v[:, 0]))
    np.testing.assert_allclose(kvs.numpy(), np.asarray(jkvs), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(ksum.numpy(), np.asarray(jksum)[0], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(scal[:2].numpy(), np.asarray(jscal)[0, :2], rtol=1e-6)
    inv = 1.0 / np.sqrt(float(scal[0]) * float(scal[1]))
    np.testing.assert_allclose(float(scal[2]), inv, rtol=1e-6)


def test_wrappers_reject_bad_inputs():
    q, k, v = (torch.from_numpy(a) for a in _qkv(6))
    with pytest.raises(ValueError):
        fused_linear_attention(q, k[:10], v)
    with pytest.raises(TypeError):
        attn.reduce(q[:, 0].double(), k[:, 0].double(), v[:, 0].double())
    kvs, ksum, scal = attn.reduce(q[:, 0], k[:, 0], v[:, 0])
    with pytest.raises(ValueError):
        attn.apply(q[:, 0], v[:, 0], kvs[:3], ksum, scal, torch.tensor(300.0))


def _grads_close(got, want, rel):
    for g_, w_ in zip(got, want):
        g_, w_ = _f32(g_), _f32(w_)
        assert np.isfinite(g_).all()
        assert np.abs(g_ - w_).max() <= rel * np.abs(w_).max()


def _port_vjp(q, k, v, g, dtype, mask=None):
    leaves = [torch.from_numpy(a).to(TORCH[dtype]).requires_grad_() for a in (q, k, v)]
    out = fused_linear_attention(*leaves, node_mask=None if mask is None
                                 else torch.from_numpy(mask))
    assert out.grad_fn is not None
    return torch.autograd.grad(out, leaves, torch.from_numpy(g).to(TORCH[dtype]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True])
def test_backward_matches_jax_pallas_interpret(dtype, masked):
    """H = 1: the port's Function against ``jax.vjp`` of the Pallas
    ``fused_linear_attention`` (its ``_bwd_reduce_kernel`` and
    ``_bwd_apply_kernel``, interpret mode)."""
    q, k, v = _qkv(8, h=1)
    g = np.random.default_rng(9).standard_normal(v.shape).astype(np.float32)
    mask = (np.arange(q.shape[0]) % 7 != 3).astype(np.float32) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    (jq, jk, jv), _ = _both((q, k, v), dtype)
    _, vjp = jax.vjp(lambda a, b, c: jax_fused(a, b, c, node_mask=jmask, block=128,
                                               interpret=True), jq, jk, jv)
    want = vjp(jnp.asarray(g).astype(JNP[dtype]))
    got = _port_vjp(q, k, v, g, dtype, mask)
    assert all(t.dtype == TORCH[dtype] for t in got)
    _grads_close(got, want, TOL[dtype]["rtol"])


@pytest.mark.parametrize("masked", [False, True])
def test_backward_multihead_matches_jax_xla(masked):
    """H = 2: one norm over all heads, so dinv is summed over the heads
    before either head's apply; the XLA ``linear_attention`` is the
    reference (the Pallas path normalises each head alone)."""
    q, k, v = _qkv(10, n=60, h=2)  # few rows: the attention terms are not tiny
    g = np.random.default_rng(11).standard_normal(v.shape).astype(np.float32)
    mask = (np.arange(q.shape[0]) % 5 != 0).astype(np.float32) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda a, b, c: jax_linear_attention(a, b, c, node_mask=jmask),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp(jnp.asarray(g))
    _grads_close(_port_vjp(q, k, v, g, "f32", mask), want, TOL["f32"]["rtol"])


def test_all_masked_gradients_are_finite_zeros():
    """Zero norms: the forward's guard carries into the backward (no 0/0 in
    the dinv terms), as in autograd of the guarded XLA path; the Pallas
    backward has no guard (kernels/attention.py:213)."""
    q, k, v = _qkv(12, n=50, h=2)
    g = np.ones_like(v)
    mask = np.zeros(q.shape[0], np.float32)
    got = _port_vjp(q, k, v, g, "f32", mask)
    _, vjp = jax.vjp(lambda a, b, c: jax_linear_attention(a, b, c,
                                                          node_mask=jnp.asarray(mask)),
                     *(jnp.asarray(a) for a in (q, k, v)))
    for t, w in zip(got, vjp(jnp.asarray(g))):
        assert np.isfinite(t.numpy()).all() and not t.numpy().any()
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))


@pytest.mark.parametrize("guard", [False, True])
def test_plain_backward_matches_autograd_of_plain_forward(guard):
    """``bwd_reduce_plain`` and ``bwd_apply_plain`` write out the Pallas
    kernels' hand-derived formulas; torch autograd of ``reduce_plain`` +
    ``apply_plain`` must give the same dq, dk, dv (f32, 1e-5 of scale)."""
    q, k, v = (a[:, 0] for a in _qkv(13, n=80))
    g = np.random.default_rng(14).standard_normal(v.shape).astype(np.float32)
    if guard:  # masked rows are zeros, n counts the rest
        keep = (np.arange(80) % 4 != 1).astype(np.float32)[:, None]
        q, k, v = q * keep, k * keep, v * keep
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tg = torch.from_numpy(g)
    n = torch.tensor(float(keep.sum() if guard else 80))
    kvs, ksum, scal = attn.reduce_plain(tq, tk, tv, guard)
    out = attn.apply_plain(tq, tv, kvs, ksum, scal, n, guard)
    want = torch.autograd.grad(out, (tq, tk, tv), tg)
    with torch.no_grad():
        parts = attn.bwd_reduce_plain(tq, tv, tg, kvs, ksum, scal, n, guard)
        got = attn.bwd_apply_plain(tq, tk, tv, tg, kvs, ksum, scal, n, *parts, guard)
    _grads_close(got, want, 1e-5)


def test_no_autograd_function_where_autograd_does_not_record():
    """Under ``no_grad`` / ``inference_mode`` the kernels run directly and
    nothing is saved for a backward."""
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(15, n=40))
    assert type(fused_linear_attention(q, k, v).grad_fn).__name__ \
        == "LinearAttentionFunctionBackward"
    with torch.no_grad():
        assert fused_linear_attention(q, k, v).grad_fn is None
    with torch.inference_mode():
        assert fused_linear_attention(q, k, v).grad_fn is None


def _split_bf16(t):
    """f32 ``t`` as bf16 hi + lo (hi = bf16(t), lo = bf16(t - hi)), both
    returned in f32."""
    hi = t.to(torch.bfloat16).float()
    return hi, (t - hi).to(torch.bfloat16).float()


def _tensor_core_apply(q, k, v, g, kvs, ksum, scal, n_total, P, ds, dinv, rows, guard,
                       lo=True):
    """The bf16 apply's arithmetic (``la_bwd_apply_ws16_kernel``;
    ``la_bwd_apply_wgmma_kernel`` above M, D = 256) written plainly: the bf16 rows g, v, k as they are, kvs and P split into bf16
    hi + lo with one product each (``lo=False`` drops the lo half: kvs and
    P rounded to bf16, as the Pallas kernel does), f32 sums, the 1/den of gd
    in the epilogue. Returns f32."""
    qf, kf, vf, gf = (t.float() for t in (q, k, v, g))
    inv = scal[2]
    den, gden = rows[0], rows[1]

    def mm(a, b):  # a @ b^T, b [C, K] f32 as hi + lo
        b_hi, b_lo = _split_bf16(b)
        return a @ b_hi.T + (a @ b_lo.T if lo else 0.0)

    zero = torch.zeros_like(inv)
    c_q = torch.where(guard & (inv == 0.0), zero, dinv * inv / scal[0])
    c_k = torch.where(guard & (inv == 0.0), zero, dinv * inv / scal[1])
    dq = inv * (mm(gf, kvs) / den[:, None]) + inv * gden[:, None] * ksum - c_q * qf
    dk = inv * mm(vf, P) + inv * ds - c_k * kf
    dv = n_total * (gf / den[:, None]) + inv * mm(kf, P.T)
    return dq, dk, dv


@pytest.mark.parametrize("n_one", [False, True])
def test_tensor_core_apply_keeps_kvs_and_p_at_f32_precision(n_one):
    """bf16 inputs: the hi + lo apply agrees with ``bwd_apply_plain`` (f32
    kvs and P) to 2^-14 of each output's scale before the output rounding,
    and within the card's bf16 tolerance (1e-2 of scale) after it. ``n_one``:
    n = 1 and positive inputs, so the products carry the gradients; kvs and
    P rounded to bf16 instead are then at least 10x further off."""
    rng = np.random.default_rng(17)
    n, m, d = 300, 48, 40
    draw = rng.random if n_one else rng.standard_normal
    q, k, v, g = (torch.from_numpy(draw((n, w)).astype(np.float32)).to(torch.bfloat16)
                  for w in (m, m, d, d))
    n_t = torch.tensor(1.0 if n_one else float(n))
    kvs, ksum, scal = attn.reduce_plain(q, k, v, False)
    red = attn.bwd_reduce_plain(q, v, g, kvs, ksum, scal, n_t, False)
    exact = attn.bwd_apply_plain(*(t.float() for t in (q, k, v, g)), kvs, ksum, scal, n_t,
                                 *red, False)
    got = _tensor_core_apply(q, k, v, g, kvs, ksum, scal, n_t, *red, torch.tensor(False))
    hi_only = _tensor_core_apply(q, k, v, g, kvs, ksum, scal, n_t, *red, torch.tensor(False),
                                 lo=False)
    rounded = attn.bwd_apply_plain(q, k, v, g, kvs, ksum, scal, n_t, *red, False)
    for a, b, c, r in zip(got, exact, hi_only, rounded):
        err = (a - b).abs().max()
        assert err <= 2.0 ** -14 * b.abs().max()
        if n_one:  # at n = N the n * gd and norm terms swamp the products
            assert (c - b).abs().max() >= 10 * err
        _grads_close((a.to(torch.bfloat16),), (r,), 1e-2)


@pytest.mark.parametrize("masked", [False, True])
def test_tensor_core_apply_matches_jax_pallas_interpret(masked):
    """H = 1, bf16: the port's backward with the tensor-core apply's
    arithmetic (the plain reduce, then the hi + lo apply) against
    ``jax.vjp`` of the Pallas ``fused_linear_attention`` in interpret mode,
    at the bf16 tolerance of the Pallas comparisons (2e-2 of scale)."""
    q, k, v = _qkv(18, h=1)
    g = np.random.default_rng(19).standard_normal(v.shape).astype(np.float32)
    mask = (np.arange(q.shape[0]) % 7 != 3).astype(np.float32) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), "bf16")
    _, vjp = jax.vjp(lambda a, b, c: jax_fused(a, b, c, node_mask=jmask, block=128,
                                               interpret=True), jq, jk, jv)
    want = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    keep = torch.ones(q.shape[0]) if mask is None else torch.from_numpy(mask)
    tq, tk, tv = (t[:, 0] * keep.to(torch.bfloat16)[:, None] for t in (tq, tk, tv))
    tg = torch.from_numpy(g[:, 0]).to(torch.bfloat16)
    n_t = keep.sum()
    sums = attn.reduce_plain(tq, tk, tv, masked)
    red = attn.bwd_reduce_plain(tq, tv, tg, *sums, n_t, masked)
    got = _tensor_core_apply(tq, tk, tv, tg, *sums, n_t, *red, torch.tensor(masked))
    got = [(t * keep[:, None]).to(torch.bfloat16)[:, None] for t in got]
    _grads_close(got, want, TOL["bf16"]["rtol"])


def _tensor_core_forward_apply(q, v, kvs, ksum, scal, n_total, guard, lo=True):
    """The bf16 forward apply's arithmetic (``la_apply_wgmma_kernel``) written
    plainly: the bf16 rows q and v as they are, kvsᵀ split into bf16 hi + lo
    with one product each into f32 sums (``lo=False`` drops the lo half:
    kvs rounded to bf16, as the Pallas kernel does), b = q . ksum in f32,
    den = inv * b + n with a zero den taken as 1 under ``guard``. Returns
    out in f32, before the rounding to bf16."""
    qf, vf = q.float(), v.float()
    inv = scal[2]
    hi, low = _split_bf16(kvs)
    a = qf @ hi + (qf @ low if lo else 0.0)
    den = (qf @ ksum) * inv + n_total
    if guard:
        den = torch.where(den == 0.0, torch.ones_like(den), den)
    return (inv * a + n_total * vf) / den[:, None]


@pytest.mark.parametrize("n_one", [False, True])
def test_tensor_core_forward_apply_keeps_kvs_at_f32_precision(n_one):
    """bf16 inputs: the hi + lo forward apply agrees with ``apply_plain``
    evaluated in f64 (f32 kvs) to 2^-14 of the output's scale before the
    output rounding, and within the card's bf16 tolerance (1e-2) after it.
    ``n_one``: n = 1 and positive inputs, so q @ kvs carries the output; kvs
    rounded to bf16 instead then misses the 2^-14 bound."""
    rng = np.random.default_rng(21)
    n, m, d = 300, 48, 40
    draw = rng.random if n_one else rng.standard_normal
    q, k, v = (torch.from_numpy(draw((n, w)).astype(np.float32)).to(torch.bfloat16)
               for w in (m, m, d))
    n_t = torch.tensor(1.0 if n_one else float(n))
    kvs, ksum, scal = attn.reduce_plain(q, k, v, False)
    exact = attn.apply_plain(q.double(), v.double(), kvs.double(), ksum.double(),
                             scal.double(), n_t.double(), False)
    got = _tensor_core_forward_apply(q, v, kvs, ksum, scal, n_t, False)
    bound = 2.0 ** -14 * exact.abs().max()
    assert (got.double() - exact).abs().max() <= bound
    if n_one:  # at n = N the n * v term swamps the product
        hi_only = _tensor_core_forward_apply(q, v, kvs, ksum, scal, n_t, False, lo=False)
        assert (hi_only.double() - exact).abs().max() > bound
    torch.testing.assert_close(got.to(torch.bfloat16).float(),
                               attn.apply_plain(q, v, kvs, ksum, scal, n_t, False).float(),
                               rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("masked", [False, True])
def test_tensor_core_forward_apply_matches_jax_pallas_interpret(masked):
    """H = 1, bf16: the tensor-core forward apply's arithmetic on the plain
    reduce's sums against the Pallas ``_reduce`` and ``_apply`` kernels in
    interpret mode, at the bf16 tolerance of the Pallas comparisons (the
    Pallas apply rounds kvs to bf16; the port keeps it as hi + lo)."""
    q, k, v = (a[:, 0] for a in _qkv(22, h=1))
    mask = (np.arange(q.shape[0]) % 7 != 3).astype(np.float32) if masked else \
        np.ones(q.shape[0], np.float32)
    q, k, v = (a * mask[:, None] for a in (q, k, v))
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), "bf16")
    want = jax_apply(jq, jv, *jax_reduce(jq, jk, jv, 128, True), float(mask.sum()), 128, True)
    n_t = torch.tensor(float(mask.sum()))
    got = _tensor_core_forward_apply(tq, tv, *attn.reduce_plain(tq, tk, tv, masked), n_t, masked)
    np.testing.assert_allclose(_f32(got.to(torch.bfloat16)), _f32(want), **TOL["bf16"])


# Faults of a tensor-core forward apply, each as what it would compute:
# its product from (q, kvs) (``prod``): the lo piece dropped, k permuted
# within q's 16-byte chunks or across kvs's 64-deep k-tiles, kvs columns
# swapped within an 8-column fragment, the product's A rows taken from other
# rows than den's, or a ring stage read one column tile stale (each 64-column
# tile's kvs chunk the tile before's); its epilogue's v from the neighbouring
# column tile (``v``); or the rows of its last block past N read as the
# rows that follow the view and stored there (``rows``: a tensor map whose
# extent is the allocation's and not the view's).
def _column_tiles_shifted(t):
    """t's columns as the tile one 64-column tile back reads them."""
    return t[:, (torch.arange(t.shape[1]) - 64) % t.shape[1]]


_APPLY_FAULTS = {
    "lo piece dropped": (True, dict(prod=lambda q, kvs: (q, kvs.to(torch.bfloat16).float()))),
    "q k-pairs swapped": (False, dict(prod=lambda q, kvs: (q[:, torch.arange(q.shape[1]) ^ 1],
                                                           kvs))),
    "kvs k-tiles swapped": (False, dict(prod=lambda q, kvs: (q, kvs[torch.arange(kvs.shape[0])
                                                                    ^ 64]))),
    "kvs columns swapped": (False, dict(prod=lambda q, kvs: (q, kvs[:, torch.arange(kvs.shape[1])
                                                                    ^ 1]))),
    "A rows shifted": (False, dict(prod=lambda q, kvs: (torch.roll(q, 1, 0), kvs))),
    "ring stage one column tile stale": (False, dict(prod=lambda q, kvs: (
        q, _column_tiles_shifted(kvs)))),
    "v from the neighbouring column tile": (False, dict(v=_column_tiles_shifted)),
    "rows past N read as non-zero": (False, dict(rows=True)),
}
# the rows that follow the view in the rows' and the output's allocations,
# up to the last block's end (300 + 84 = 3 x 128), and the output's value there
_PAST_N = 84
_SENTINEL = 7.0


@pytest.mark.parametrize("fault", list(_APPLY_FAULTS))
def test_apply_product_inputs_catch_a_faulty_kernel(fault):
    """The card checks of the forward apply (``chip_smoke.py``,
    ``tests/test_torch_cuda.py``) hold it to ``apply_plain`` in f64 at the
    bf16 tolerance on ``apply_product_inputs``, and the rows that follow an
    output view to what they held. There the tensor-core design's
    arithmetic (hi + lo, rounded to bf16 once, stores clipped at N) passes,
    and the same arithmetic with one fault misses; a dropped lo piece shows
    where kvs terms cancel (``cancel``)."""
    cancel, broken = _APPLY_FAULTS[fault]
    gen = torch.Generator().manual_seed(23)
    q, v, kvs, ksum, scal, n_t = ins = apply_product_inputs(300, 128, 128, torch.bfloat16,
                                                            gen, cancel)
    exact = attn.apply_plain(*(t.double() for t in ins), False)
    past = apply_product_inputs(_PAST_N, 128, 128, torch.bfloat16,
                                torch.Generator().manual_seed(24), cancel)
    q_buf, v_buf = torch.cat((q, past[0])), torch.cat((v, past[1]))

    def misses(fault):
        """The design's arithmetic with ``fault``, rounded to bf16 and stored
        into an output allocation of 384 rows, misses the tolerance in the
        view's rows or changes the rows after them."""
        rows = q_buf.shape[0] if fault.get("rows") else q.shape[0]
        qr, vr = q_buf[:rows], v_buf[:rows]
        qa, kvs_a = fault.get("prod", lambda a, b: (a, b))(qr, kvs)
        va = fault.get("v", lambda x: x)(vr)
        hi, lo = _split_bf16(kvs_a)
        a = qa.float() @ hi + qa.float() @ lo
        den = (qr.float() @ ksum) * scal[2] + n_t  # den from the rows as read
        out = torch.full((q_buf.shape[0], 128), _SENTINEL, dtype=torch.bfloat16)
        out[:rows] = ((scal[2] * a + n_t * va.float()) / den[:, None]).to(torch.bfloat16)
        view = out[:q.shape[0]].double()
        return bool(((view - exact).abs() > 1e-2 + 1e-2 * exact.abs()).any()
                    or (out[q.shape[0]:] != _SENTINEL).any())

    assert not misses({})
    assert misses(broken)


def _runs(n, rows):
    """Consecutive ranges of ``rows`` indices covering range(n)."""
    return [range(s, min(s + rows, n)) for s in range(0, n, rows)]


# the forward reduces' fresh-sum period (node rows a fresh sum of kᵀv
# holds), their staged chunks of node rows and the row groups of their
# column sums (bf16: the eight consumer warps; f32: three warps of the
# producer warpgroup)
_NODE_PERIOD = 32
_NODE_CHUNK = {torch.bfloat16: 64, torch.float32: 32}
_SUM_GROUPS = {torch.bfloat16: 8, torch.float32: 3}


def _column_sums(x, chunk, square, groups):
    """Per column of x [rows, m] (one slice, f32 values), its sum (or sum of
    squares) as the forward reduces form it: each ``chunk`` rows from the
    slice's start, the rows of each of ``groups`` row groups (r % groups) in
    one f32 chain (each square added by one rounding, as an FMA adds it),
    made an f64 and added to the group's f64 sum; at the end the groups'
    sums added in order. Returns f64."""
    sums = torch.zeros(groups, x.shape[1], dtype=torch.float64)
    for c0 in range(0, x.shape[0], chunk):
        rows = x[c0:c0 + chunk].double()
        for rg in range(groups):
            chain = torch.zeros(x.shape[1], dtype=torch.float64)
            for y in rows[rg::groups]:
                chain = (chain + (y * y if square else y)).float().double()
            sums[rg] = sums[rg] + chain
    out = torch.zeros(x.shape[1], dtype=torch.float64)
    for rg in range(groups):
        out = out + sums[rg]
    return out


def _tensor_core_reduce(q, k, v, guard, rows=96):
    """The bf16 reduce's arithmetic (``la_reduce_wgmma_kernel`` and its
    finish) written plainly: the bf16 rows as they are, so every product of
    k and v is exact in f32; each 32-row period's kᵀv summed alone (the
    MMAs' fresh sums) and added to its slice's f32 sum, the slices of
    ``rows`` nodes added in slice order in f32; Σk, ‖k‖² and ‖q‖² per column
    and slice through the consumers' f32 chains (:func:`_column_sums`, 64-row
    chunks, eight row groups), rounded to f32 and added over slices (ksum in
    f32, the norms in f64). Returns kvs, ksum and scal as :func:`reduce_plain` does."""
    qf, kf, vf = q.float(), k.float(), v.float()
    n, m, d = q.shape[0], q.shape[1], v.shape[1]
    kvs, ksum = torch.zeros(m, d), torch.zeros(m)
    qsq = ksq = torch.zeros((), dtype=torch.float64)
    sums = dict(chunk=_NODE_CHUNK[torch.bfloat16], groups=_SUM_GROUPS[torch.bfloat16])
    for sl in _runs(n, rows):
        part = torch.zeros(m, d)
        for ch in _runs(len(sl), _NODE_PERIOD):
            r = slice(sl.start + ch.start, sl.start + ch.stop)
            part = part + kf[r].T @ vf[r]
        kvs = kvs + part
        r = slice(sl.start, sl.stop)
        ksum = ksum + _column_sums(kf[r], square=False, **sums).float()
        qsq = qsq + _column_sums(qf[r], square=True, **sums).float().double().sum()
        ksq = ksq + _column_sums(kf[r], square=True, **sums).float().double().sum()
    q_sq, k_sq = qsq.float(), ksq.float()
    scal = torch.stack([q_sq, k_sq, attn._inv(q_sq, k_sq, guard), torch.zeros_like(q_sq)])
    return kvs, ksum, scal


def _tensor_core_bwd_reduce(q, v, g, kvs, ksum, scal, n_total, guard, rows=96, lo=True):
    """The bf16 backward reduce's arithmetic (``la_bwd_rows_ws16_kernel`` and
    ``la_bwd_reduce_ws16_kernel``) written plainly: a = q @ kvs with kvs as
    three bf16 pieces, hi + mid + lo, each k16 step's three products summed
    alone and added to the f32 sums (the rows pass's fresh sums), b = q .
    ksum, den and gden in f32 as the rows pass forms them; gd = g * (1/den)
    in f32, split into bf16 hi + lo, P = qᵀ gd summed 32 rows at a time
    (the P pass's fresh sums), each added to its slice's f32 sum, the slices
    of ``rows`` nodes added in slice order in f32; ds per slice in f64; dinv
    from the per-row f64 terms. ``lo=False`` keeps only the hi pieces: kvs
    and gd rounded to bf16. Returns P, ds, dinv and rows = [den; gden], as
    :func:`bwd_reduce_plain` does."""
    qf, vf, gf = q.float(), v.float(), g.float()
    inv = scal[2]

    def pieces(t, count):  # t as the tensor cores see it, in f32 (the sum is exact)
        out, rest = torch.zeros_like(t), t
        for _ in range(count if lo else 1):
            piece = rest.to(torch.bfloat16).float()
            out, rest = out + piece, rest - piece
        return out

    kvs_t = pieces(kvs, 3)
    a = torch.zeros(q.shape[0], kvs.shape[1])
    for k in _runs(q.shape[1], 16):
        a = a + qf[:, k.start:k.stop] @ kvs_t[k.start:k.stop]
    b = qf @ ksum
    den = inv * b + n_total
    gden_of = -(inv * (gf * a).sum(1) + n_total * (gf * vf).sum(1))
    if guard:
        zero = den == 0.0
        den = torch.where(zero, torch.ones_like(den), den)
        gden = torch.where(zero, torch.zeros_like(den), gden_of / (den * den))
    else:
        gden = gden_of / (den * den)
    gd = pieces(gf * (1.0 / den)[:, None], 2)
    P = torch.zeros(q.shape[1], g.shape[1])
    ds = torch.zeros(q.shape[1])
    for sl in _runs(q.shape[0], rows):
        part = torch.zeros_like(P)
        for ch in _runs(len(sl), 32):
            r = slice(sl.start + ch.start, sl.start + ch.stop)
            part = part + qf[r].T @ gd[r]
        P = P + part
        r = slice(sl.start, sl.stop)
        ds = ds + (qf[r].double().T @ gden[r].double()).float()
    ga = (gf * a).sum(1)
    dinv = ((ga / den).double() + (gden * b).double()).sum().float()
    return P, ds, dinv, torch.stack([den, gden])


def _bf16_inputs(rng, n, widths, positive):
    draw = rng.random if positive else rng.standard_normal
    return [torch.from_numpy(draw((n, w)).astype(np.float32)).to(torch.bfloat16)
            for w in widths]


@pytest.mark.parametrize("positive", [False, True])
def test_tensor_core_reduce_matches_plain_in_f64(positive):
    """bf16 inputs, n = 300, m = 48, d = 40: the tensor-core reduce's
    arithmetic agrees with ``reduce_plain`` evaluated in f64 to 1e-5 of each
    output's scale (its products are exact; only the f32 sums' order
    differs), on random and on positive inputs, with and without the guard,
    and with one slice or many."""
    q, k, v = _bf16_inputs(np.random.default_rng(20), 300, (48, 48, 40), positive)
    exact = attn.reduce_plain(q.double(), k.double(), v.double(), False)
    for rows, guard in ((96, False), (300, True), (32, False)):
        got = _tensor_core_reduce(q, k, v, guard, rows)
        for a, b in ((got[0], exact[0]), (got[1], exact[1]), (got[2][:3], exact[2][:3])):
            _grads_close((a,), (b,), 1e-5)


@pytest.mark.parametrize("n_one", [False, True])
def test_tensor_core_bwd_reduce_keeps_kvs_and_gd_at_f32_precision(n_one):
    """bf16 inputs, n = 300, m = 48, d = 40: the tensor-core backward
    reduce's arithmetic (kvs as bf16 hi + mid + lo, g/den as hi + lo) agrees
    with ``bwd_reduce_plain`` evaluated in f64 to 2^-14 of each output's
    scale (dinv: of the magnitudes of its two sums, which cancel). ``n_one``: n =
    1 and positive inputs, so that q @ kvs, not n * v, carries den and gden;
    kvs and gd rounded to bf16 instead are then at least 10x further off in
    P and gden (dinv, a sum over all rows, averages the roundings out)."""
    rng = np.random.default_rng(21)
    n, m, d = 300, 48, 40
    q, k, v, g = _bf16_inputs(rng, n, (m, m, d, d), n_one)
    n_t = torch.tensor(1.0 if n_one else float(n))
    sums = attn.reduce_plain(q, k, v, False)
    qd, vd, gdd, kvs_d, ksum_d = (t.double() for t in (q, v, g, *sums[:2]))
    exact = attn.bwd_reduce_plain(qd, vd, gdd, kvs_d, ksum_d, sums[2].double(),
                                  n_t.double(), False)
    den, gden = exact[3]
    dinv_scale = (gdd / den[:, None] * (qd @ kvs_d)).abs().sum() \
        + (gden * (qd @ ksum_d)).abs().sum()

    def errors(out):
        parts = ((out[0], exact[0]), (out[1], exact[1]), (out[3][0], den), (out[3][1], gden))
        errs = [((a.double() - b).abs().max() / b.abs().max()).item() for a, b in parts]
        return errs + [(abs(out[2].double() - exact[2]) / dinv_scale).item()]

    got = errors(_tensor_core_bwd_reduce(q, v, g, *sums, n_t, False))
    assert max(got) <= 2.0 ** -14, got
    if n_one:
        rounded = errors(_tensor_core_bwd_reduce(q, v, g, *sums, n_t, False, lo=False))
        for i in (0, 3):  # P, gden
            assert rounded[i] >= 10 * got[i], (rounded, got)


@pytest.mark.parametrize("masked", [False, True])
def test_tensor_core_backward_matches_jax_pallas_interpret(masked):
    """H = 1, bf16: the port's attention gradient with the tensor-core
    reduces' arithmetic (the emulated forward reduce, then the emulated
    backward reduce, then ``bwd_apply_plain``) against ``jax.vjp`` of the
    Pallas ``fused_linear_attention`` in interpret mode, at the bf16
    tolerance of the Pallas comparisons (2e-2 of scale)."""
    q, k, v = _qkv(22, h=1)
    g = np.random.default_rng(23).standard_normal(v.shape).astype(np.float32)
    mask = (np.arange(q.shape[0]) % 7 != 3).astype(np.float32) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), "bf16")
    _, vjp = jax.vjp(lambda a, b, c: jax_fused(a, b, c, node_mask=jmask, block=128,
                                               interpret=True), jq, jk, jv)
    want = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    keep = torch.ones(q.shape[0]) if mask is None else torch.from_numpy(mask)
    tq, tk, tv = (t[:, 0] * keep.to(torch.bfloat16)[:, None] for t in (tq, tk, tv))
    tg = torch.from_numpy(g[:, 0]).to(torch.bfloat16)
    n_t = keep.sum()
    sums = _tensor_core_reduce(tq, tk, tv, masked)
    red = _tensor_core_bwd_reduce(tq, tv, tg, *sums, n_t, masked)
    got = attn.bwd_apply_plain(tq.float(), tk.float(), tv.float(), tg.float(), *sums, n_t,
                               *red, masked)
    got = [(t * keep[:, None]).to(torch.bfloat16)[:, None] for t in got]
    _grads_close(got, want, TOL["bf16"]["rtol"])


# The f32 backward kernels' 3xTF32 arithmetic, written plainly. A test
# helper only: the port's f32 path runs the kernels on the card and the
# plain versions on the CPU.

def _tf32(t):
    """f32 ``t`` rounded to tf32 as ``cvt.rna.tf32.f32`` rounds: to nearest
    on 10 mantissa bits, ties away from zero (half a tf32 ulp added to the
    sign-magnitude bits, the low 13 bits cleared)."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split_tf32(t):
    """f32 ``t`` as tf32 hi + lo (hi = tf32(t), lo = tf32(t - hi))."""
    hi = _tf32(t)
    return hi, _tf32(t.float() - hi)


def _mm_3xtf32(a, b, lo=True):
    """a @ b of f32 operands as the kernels form it: each split into tf32
    hi + lo, the product lo*hi + hi*lo + hi*hi (``lo=False``: hi*hi alone,
    one TF32 product). The pieces' products are summed in f64, so this
    holds the split's error only, not the tensor cores' f32 sums."""
    a_hi, a_lo = (x.double() for x in _split_tf32(a))
    b_hi, b_lo = (x.double() for x in _split_tf32(b))
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi if lo else a_hi @ b_hi


def _round_toward_zero(x):
    """f64 ``x`` rounded to f32 toward zero."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(), torch.nextafter(y, torch.zeros_like(y)), y)


def _mm_3xtf32_sums(a, b, period, lo=True):
    """a @ b as the f32 kernels' warpgroup MMAs sum it (the row kernels;
    with the node axis as k, ``la_reduce_wg_kernel``): each operand split
    into tf32 hi + lo; k in steps of 8, each step's lo*hi, hi*lo and hi*hi
    added in that order into the period's sum, each add the step's products
    summed exactly and then rounded toward zero to f32 (the tensor cores'
    own accumulation, which behaves as if it truncates); every ``period``
    deep the sum starts afresh and is added to the running f32 sum rounded
    to nearest. ``lo=False``: hi*hi alone, one TF32 product. Returns f64."""
    a_hi, a_lo = (x.double() for x in _split_tf32(a))
    b_hi, b_lo = (x.double() for x in _split_tf32(b))
    products = ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)) if lo else ((a_hi, b_hi),)
    out = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], period):
        part = torch.zeros_like(out)
        for k in range(k0, min(k0 + period, a.shape[1]), 8):
            s = slice(k, k + 8)
            for x, y in products:
                part = _round_toward_zero(part.double() + x[:, s] @ y[s])
        out = out + part
    return out.double()


def _tf32_backward(q, k, v, g, kvs, ksum, scal, n_total, lo=True, period=None):
    """The f32 backward reduce (``la_bwd_rows_ws_kernel``,
    ``la_bwd_reduce_wg_kernel``) and apply (``la_bwd_apply_ws_kernel``)
    in 3xTF32, unguarded: a = q @ kvs, den, gden and dinv from it; gd =
    g * (1/den) in f32, P = qᵀ gd with the node axis as the MMAs' k, summed
    as the P pass's warpgroup MMAs sum it (:func:`_mm_3xtf32_sums`, fresh
    sums every 32 rows, the kernel's order); then dq (1/den in the
    epilogue), dk and dv from the f32 P, ds and dinv. The row kernels'
    pieces' products (a, dq, dk, dv) are summed in f64, or with ``period``
    as their MMAs sum them. Returns P, dinv, dq, dk, dv in f64."""
    qd, vd, gdd = q.double(), v.double(), g.double()
    inv, n = scal[2].double(), n_total.double()

    def rows_mm(a, b):
        return _mm_3xtf32(a, b, lo) if period is None else _mm_3xtf32_sums(a, b, period)

    a = rows_mm(q, kvs)
    b = qd @ ksum.double()
    den = inv * b + n
    gden = -(inv * (gdd * a).sum(1) + n * (gdd * vd).sum(1)) / (den * den)
    dinv = ((gdd * a).sum(1) / den + gden * b).sum()
    gd = g * (1.0 / den.float())[:, None]
    P = _mm_3xtf32_sums(q.T, gd, _NODE_PERIOD, lo)
    ds = qd.T @ gden
    Pf, dsf, dinvf = P.float(), ds.float(), dinv.float()
    c_q, c_k = (dinvf * scal[2] / scal[i] for i in (0, 1))
    dq = inv * (rows_mm(g, kvs.T) / den[:, None]) + inv * gden[:, None] * ksum.double() \
        - c_q.double() * qd
    dk = inv * rows_mm(v, Pf.T) + inv * dsf.double() - c_k.double() * k.double()
    dv = n * (gdd / den[:, None]) + inv * rows_mm(k, Pf)
    return P, dinv, dq, dk, dv


def _f64_backward(q, k, v, g, kvs, ksum, scal, n_total, P=None, ds=None, dinv=None):
    """The plain backward in f64 on the same inputs: P and dinv exact, and
    dq, dk, dv from the f32 P, ds and dinv given (the ones the apply reads)."""
    qd, kd, vd, gdd = (t.double() for t in (q, k, v, g))
    args = (kvs.double(), ksum.double(), scal.double(), n_total.double())
    red = attn.bwd_reduce_plain(qd, vd, gdd, *args, False)
    if P is not None:
        red = (P.double(), ds.double(), dinv.double(), red[3])
    return red, attn.bwd_apply_plain(qd, kd, vd, gdd, *args, *red, False)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    """``_tf32`` is ``cvt.rna.tf32.f32``: 10 mantissa bits (the low 13 bits
    zero), within 2^-11 of each value, ties away from zero."""
    x = torch.randn(10_000)
    t = _tf32(x)
    assert not (t.view(torch.int32) & 0x1FFF).any()
    assert ((t - x).abs() <= 2.0 ** -11 * x.abs()).all()
    tie = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -11 - 2.0 ** -23])
    assert _tf32(tie).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0]


@pytest.mark.parametrize("part", ["P", "dq", "dk", "dv"])
def test_tf32_backward_keeps_f32_precision(part):
    """f32 at a batch's statistics (randn q, k, v, g; kvs from the plain
    reduce; n = N), M = D = 256 on 2,048 rows: the 3xTF32 arithmetic agrees
    with the plain backward in f64 to 1e-6 of each output's scale (the
    split leaves ~1e-7: 2^-21 of each term), where one TF32 product (hi*hi
    alone) is at least 10x further off in P, dq and dk."""
    n, m = 2048, 256
    q, k, v, g = (torch.from_numpy(a) for a in
                  np.random.default_rng(31).standard_normal((4, n, m)).astype(np.float32))
    n_t = torch.tensor(float(n))
    kvs, ksum, scal = attn.reduce_plain(q, k, v, False)
    P, dinv, *grads = _tf32_backward(q, k, v, g, kvs, ksum, scal, n_t)
    (P_x, ds_x, dinv_x, _), _ = _f64_backward(q, k, v, g, kvs, ksum, scal, n_t)
    _, exact = _f64_backward(q, k, v, g, kvs, ksum, scal, n_t, P_x.float(), ds_x.float(),
                             dinv_x.float())
    P1, _, *grads1 = _tf32_backward(q, k, v, g, kvs, ksum, scal, n_t, lo=False)
    i = ("P", "dq", "dk", "dv").index(part)
    got, one, want = ((P, *grads)[i], (P1, *grads1)[i], (P_x, *exact)[i])
    err = (got - want).abs().max()
    assert err <= 1e-6 * want.abs().max()
    # dv carries n * gd, which swamps its product at n = N
    if part != "dv":
        assert (one - want).abs().max() >= 10 * err


def test_tf32_backward_reduce_dinv_at_n_one():
    """n = 1 and positive inputs, where q @ kvs carries den, gden and dinv
    (the chip's n = 1 check): the 3xTF32 rows pass predicts dinv within
    ~1e-6 of itself and ~1e-10 of the magnitudes of its two sums (which
    cancel to ~1e-4 of them), under both REDUCE_REL_TOL (1e-5 of dinv) and
    N1_REL_TOL (2^-14 of the magnitudes); P within 1e-6 of its scale."""
    n, m = 2048, 256
    q, k, v, g = (torch.from_numpy(a) for a in
                  np.random.default_rng(32).random((4, n, m)).astype(np.float32))
    one = torch.tensor(1.0)
    kvs, ksum, scal = attn.reduce_plain(q, k, v, False)
    P, dinv, *_ = _tf32_backward(q, k, v, g, kvs, ksum, scal, one)
    (P_x, _, dinv_x, (den, gden)), _ = _f64_backward(q, k, v, g, kvs, ksum, scal, one)
    qd, gdd = q.double(), g.double()
    sums = (gdd / den[:, None] * (qd @ kvs.double())).abs().sum() \
        + (gden * (qd @ ksum.double())).abs().sum()
    err = (dinv - dinv_x).abs()
    assert err <= 1e-6 * dinv_x.abs() and err <= 1e-10 * sums
    assert (P - P_x).abs().max() <= 1e-6 * P_x.abs().max()


# the depth of the row kernels' fresh sums (tc::kWgPeriod), and the whole
# depth of the products at M = D = 256: one chain, no fresh sums
_WG_PERIOD = 16
_ONE_CHAIN = 256


def _accumulation_errors(seed, positive, period):
    """M = D = 256 on 2,048 rows (randn at n = N, or positive at n = 1), the
    backward through the row kernels' accumulation at ``period``: dinv's
    error over |dinv| and over its two sums' magnitude, and dq's, dk's and
    dv's over their scale, against the plain backward in f64 (dq, dk, dv
    from the f32 P, ds and dinv, as the apply reads them)."""
    n, m = 2048, 256
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(a) for a in
                  (rng.random if positive else rng.standard_normal)((4, n, m))
                  .astype(np.float32))
    n_t = torch.tensor(1.0 if positive else float(n))
    kvs, ksum, scal = attn.reduce_plain(q, k, v, False)
    _, dinv, *grads = _tf32_backward(q, k, v, g, kvs, ksum, scal, n_t, period=period)
    (P_x, ds_x, dinv_x, (den, gden)), _ = _f64_backward(q, k, v, g, kvs, ksum, scal, n_t)
    _, exact = _f64_backward(q, k, v, g, kvs, ksum, scal, n_t, P_x.float(), ds_x.float(),
                             dinv_x.float())
    qd, gdd = q.double(), g.double()
    sums = (gdd / den[:, None] * (qd @ kvs.double())).abs().sum() \
        + (gden * (qd @ ksum.double())).abs().sum()
    err = (dinv - dinv_x).abs()
    return ((err / dinv_x.abs()).item(), (err / sums).item(),
            *(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(grads, exact)))


@pytest.mark.parametrize("period", [_WG_PERIOD, _ONE_CHAIN])
def test_tf32_backward_accumulation_keeps_f32_precision(period):
    """The inputs of test_tf32_backward_keeps_f32_precision (randn, n = N)
    through the row kernels' accumulation (:func:`_mm_3xtf32_sums`: the
    tensor cores' sums truncate): at the kernels' period, 16 deep, dq and dk
    stay within 1e-6 of their scale and dinv within 1e-6 of itself, as with
    the split alone; summed in one chain over the whole depth, dq, dk or
    dinv misses 1e-6, so the fresh sums are what keep them."""
    dinv_rel, _, dq, dk, _ = _accumulation_errors(31, False, period)
    assert (max(dq, dk) <= 1e-6 and dinv_rel <= 1e-6) == (period == _WG_PERIOD)


@pytest.mark.parametrize("period", [_WG_PERIOD, _ONE_CHAIN])
def test_tf32_backward_accumulation_at_n_one(period):
    """The inputs of test_tf32_backward_reduce_dinv_at_n_one (positive,
    n = 1), where the products carry dinv and the gradients, through the
    row kernels' accumulation: at the kernels' period dinv is within 2^-14
    of its sums' magnitude (N1_REL_TOL of the card's check) and dq, dk, dv
    within 1e-5 of their scale (the card's f32 BWD_REL_TOL); in one chain
    over the whole depth dq or dk misses 1e-5. The truncation leaves dinv
    here ~3e-8 of its sums' magnitude off (~4e-4 of itself: the sums cancel
    to ~1e-4 of their size), so the 1e-6 and 1e-10 that the split alone
    keeps do not hold for the tensor cores' sums, at this period or any
    other (the f32 forward apply, ``la_apply_wg_kernel``, sums in the same
    order and 16 deep too)."""
    _, dinv_sums, dq, dk, dv = _accumulation_errors(32, True, period)
    assert dinv_sums <= 2.0 ** -14
    assert max(dq, dk, dv) <= 1e-5 if period == _WG_PERIOD else max(dq, dk) > 1e-5


# The bf16 rows pass's accumulation (``la_bwd_rows_ws16_kernel``): the
# depth of its fresh sums, one k16 step, against one chain over the whole
# depth at M = 256.
_BF16_PERIOD = 16


def _split_bf16_pieces(t, count):
    """f32 ``t`` as ``count`` bf16 pieces (hi = bf16(t), then each the bf16
    of what the ones before leave), each in f64."""
    out, rest = [], t.float()
    for _ in range(count):
        piece = rest.to(torch.bfloat16).float()
        out.append(piece.double())
        rest = rest - piece
    return out


def _mm_bf16_sums(a, b, pieces, period, drop=()):
    """a @ b as the bf16 rows pass's warpgroup MMAs sum it: a bf16 (exact),
    b f32 split into ``pieces`` bf16 pieces (but those whose index is in
    ``drop``); k in steps of 16, each step's piece products added in order
    (hi first) into the period's sum, each add the step's products summed
    exactly and then rounded toward zero to f32 (the tensor cores' own
    accumulation, which behaves as if it truncates); every ``period`` deep
    the sum starts afresh and is added to the running f32 sum rounded to
    nearest. Returns f64."""
    ad = a.double()
    bs = [y for i, y in enumerate(_split_bf16_pieces(b, pieces)) if i not in drop]
    out = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], period):
        part = torch.zeros_like(out)
        for k in range(k0, min(k0 + period, a.shape[1]), 16):
            s = slice(k, k + 16)
            for y in bs:
                part = _round_toward_zero(part.double() + ad[:, s] @ y[s])
        out = out + part
    return out.double()


def _bf16_rows_errors(seed, positive, period):
    """M = D = 256 on 2,048 bf16 rows (randn at n = N, or positive at
    n = 1): the rows pass's den, gden and dinv with a = q @ kvs summed as
    :func:`_mm_bf16_sums` sums it at ``period`` (kvs as hi + mid + lo), the
    rest in f64, against the plain reduce in f64: gden's error over its
    scale, dinv's over |dinv| and over its two sums' magnitude."""
    n, m = 2048, 256
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(x).to(torch.bfloat16) for x in
                  (rng.random if positive else rng.standard_normal)((4, n, m))
                  .astype(np.float32))
    n_t = torch.tensor(1.0 if positive else float(n))
    kvs, ksum, scal = attn.reduce_plain(q, k, v, False)
    qd, vd, gdd = q.double(), v.double(), g.double()
    inv, nd = scal[2].double(), n_t.double()
    a = _mm_bf16_sums(q, kvs, 3, period)
    b = qd @ ksum.double()
    den = inv * b + nd
    gden = -(inv * (gdd * a).sum(1) + nd * (gdd * vd).sum(1)) / (den * den)
    dinv = ((gdd * a).sum(1) / den + gden * b).sum()
    _, _, dinv_x, (den_x, gden_x) = attn.bwd_reduce_plain(
        qd, vd, gdd, kvs.double(), ksum.double(), scal.double(), nd, False)
    sums = (gdd / den_x[:, None] * (qd @ kvs.double())).abs().sum() \
        + (gden_x * (qd @ ksum.double())).abs().sum()
    err = (dinv - dinv_x).abs()
    return (((gden - gden_x).abs().max() / gden_x.abs().max()).item(),
            (err / dinv_x.abs()).item(), (err / sums).item())


@pytest.mark.parametrize("period", [_BF16_PERIOD, _ONE_CHAIN])
def test_bf16_rows_accumulation_keeps_f32_precision(period):
    """bf16 at a batch's statistics (randn q, k, v, g; n = N) through the
    rows pass's accumulation (:func:`_mm_bf16_sums`: the tensor cores' sums
    truncate): n * sum g*v carries gden there, so at either depth gden is
    within 1e-10 of its scale and dinv within 1e-6 of itself, far inside
    the card's REDUCE_REL_TOL (1e-5)."""
    gden, dinv_rel, _ = _bf16_rows_errors(31, False, period)
    assert gden <= 1e-10 and dinv_rel <= 1e-6, (gden, dinv_rel)


@pytest.mark.parametrize("period", [_BF16_PERIOD, _ONE_CHAIN])
def test_bf16_rows_accumulation_at_n_one(period):
    """n = 1 and positive bf16 inputs, where q @ kvs carries den, gden and
    dinv (the card's n = 1 check): at the rows pass's period, one k16 step,
    gden is within 1e-7 of its scale and dinv within 1e-7 of its two sums'
    magnitude; summed in one chain over the whole depth each is at least 5x
    further off (the truncation grows with the chain), though still inside
    N1_REL_TOL (2^-14): the fresh sums hold the rows pass at the precision
    of the three pieces' split."""
    gden, _, dinv_sums = _bf16_rows_errors(32, True, period)
    if period == _BF16_PERIOD:
        assert gden <= 1e-7 and dinv_sums <= 1e-7, (gden, dinv_sums)
    else:
        fresh = _bf16_rows_errors(32, True, _BF16_PERIOD)
        assert gden >= 5 * fresh[0] and dinv_sums >= 5 * fresh[2], (gden, dinv_sums, fresh)
        assert max(gden, dinv_sums) <= 2.0 ** -14


# Faults of an f32 backward apply, each as what one of its products would
# be formed from (``ab``: A rows, B as [k][n], and the A rows of the product
# whose item last used A's shared-memory slots): B's lo piece dropped (one
# TF32 product in place of three), A's k-steps swapped (k and k ^ 8), B's
# columns swapped in pairs, A's rows shifted against the epilogue's, a ring
# stage read one column tile stale (each 64-column tile's B chunk the tile
# before's), or A's second 32-deep k atom taken from the other product's
# rows (a slot read before its refill landed); its epilogue operand (q, k
# or g) from the neighbouring column tile (``x``); or the rows of its last
# block past N read as the rows that follow the views and stored there
# (``rows``).
_BWD_FAULTS = {
    "lo piece dropped": dict(ab=lambda a, b, _: (a, _tf32(b))),
    "k-steps swapped": dict(ab=lambda a, b, _: (a[:, torch.arange(a.shape[1]) ^ 8], b)),
    "B columns swapped": dict(ab=lambda a, b, _: (a, b[:, torch.arange(b.shape[1]) ^ 1])),
    "A rows shifted": dict(ab=lambda a, b, _: (torch.roll(a, 1, 0), b)),
    "ring stage one column tile stale": dict(ab=lambda a, b, _: (a, _column_tiles_shifted(b))),
    "A k-atom from the other product": dict(ab=lambda a, b, other: (
        torch.cat((a[:, :32], other[:, 32:64], a[:, 64:]), 1), b)),
    "epilogue operand from the neighbouring tile": dict(x=_column_tiles_shifted),
    "rows past N read as non-zero": dict(rows=True),
}


@pytest.mark.parametrize("fault", list(_BWD_FAULTS))
def test_bwd_product_inputs_catch_a_faulty_kernel(fault):
    """The card checks of the f32 backward apply (``chip_smoke.py``,
    ``tests/test_torch_cuda.py``) hold it to ``bwd_apply_plain`` in f64 at
    the f32 tolerance (1e-5 of each output's scale) on
    ``bwd_product_inputs``, and the rows that follow an output view to what
    they held. There the design's arithmetic (3xTF32 products summed as the
    warpgroup MMAs sum them, the epilogue in f32, stores clipped at N)
    passes in dq, dk and dv, and the same arithmetic with one fault misses
    in each."""
    gen = torch.Generator().manual_seed(29)
    ins = bwd_product_inputs(300, 128, 128, torch.float32, gen)
    q, k, v, g, kvs, ksum, scal, n_t, P, ds, dinv, (den, gden) = ins
    exact = attn.bwd_apply_plain(*(t.double() for t in ins), False)
    inv = scal[2]
    c_q, c_k = dinv * inv / scal[0], dinv * inv / scal[1]
    past = bwd_product_inputs(_PAST_N, 128, 128, torch.float32, torch.Generator().manual_seed(30))
    bufs = [torch.cat((a, b)) for a, b in zip((q, k, v, g, den, gden), past[:4] + tuple(past[11]))]

    def misses(fault):
        """Which of dq, dk, dv, each stored into an output allocation of
        384 rows, miss the tolerance in the view's rows or change the rows
        after them, with ``fault``."""
        rows = bufs[0].shape[0] if fault.get("rows") else q.shape[0]
        qr, kr, vr, gr, dn, gdn = (t[:rows] for t in bufs)
        ab = fault.get("ab", lambda a, b, _: (a, b))
        x = fault.get("x", lambda t: t)

        def mm(a, b, other):
            return _mm_3xtf32_sums(*ab(a, b, other), _WG_PERIOD).float()

        dq = inv * (mm(gr, kvs.T, kr) / dn[:, None]) + inv * gdn[:, None] * ksum - c_q * x(qr)
        dk = inv * mm(vr, P.T, gr) + inv * ds - c_k * x(kr)
        dv = n_t * (x(gr) / dn[:, None]) + inv * mm(kr, P, vr)
        got = []
        for a, b in zip((dq, dk, dv), exact):
            out = torch.full((bufs[0].shape[0], a.shape[1]), _SENTINEL)
            out[:rows] = a
            view = out[:q.shape[0]].double()
            got.append(bool(((view - b).abs().max() > 1e-5 * b.abs().max()).item()
                            or (out[q.shape[0]:] != _SENTINEL).any()))
        return got

    assert misses({}) == [False] * 3
    assert misses(_BWD_FAULTS[fault]) == [True] * 3


# The faults the f32 rows pass's design (la_bwd_rows_ws_kernel) can have,
# each as the operands its arithmetic would be formed from: a q k-atom taken
# from the previous row block's rows (``q``: a slot read before its refill
# landed), a ring stage one column tile stale (``kvs``: each 64-column
# tile's kvs^T chunk the tile before's), kvs^T's lo piece dropped (one TF32
# product in place of three), the g tile from the neighbouring column tile
# (``g``: the fold's and the sum warps' g), or the rows of the last block
# past N read as the rows that follow the views and summed into dinv
# (``rows``); with which of den, gden and dinv each misses (``misses``: den
# reads none of the faulty operands).
_ROWS_FAULTS = {
    "q k-atom from the previous row block": dict(
        q=lambda q: torch.cat((q[:, :32], torch.roll(q, 128, 0)[:, 32:64], q[:, 64:]), 1),
        misses=[False, True, True]),
    "ring stage one column tile stale": dict(kvs=_column_tiles_shifted,
                                             misses=[False, True, True]),
    "lo piece dropped": dict(kvs=_tf32, misses=[False, True, False]),
    "g tile from the neighbouring column tile": dict(g=_column_tiles_shifted,
                                                     misses=[False, True, True]),
    "rows past N read as non-zero": dict(rows=True, misses=[False, False, True]),
}


def _fma_chain(x, y, start):
    """start + x[:, 0] y[:, 0] + x[:, 1] y[:, 1] + ... as a chain of f32
    FMAs, each step formed in f64 and rounded to f32 once."""
    p = start
    for e in range(x.shape[1]):
        p = (p.double() + x[:, e].double() * y[:, e].double()).float()
    return p


def _group_fold(x, y):
    """sum_d x*y of each row as the rows pass folds it, in f32: each column
    tile's eight-column groups an FMA chain from 0, the groups added by the
    tree ((0 + 4) + (2 + 6)) + ((1 + 5) + (3 + 7)), the tiles in order."""
    n, d = x.shape
    pad = -d % 64
    x, y = (torch.cat((t.float(), torch.zeros(n, pad)), 1) for t in (x, y))
    out = torch.zeros(n)
    for c0 in range(0, d + pad, 64):
        p = [_fma_chain(x[:, c0 + 8 * j:c0 + 8 * j + 8], y[:, c0 + 8 * j:c0 + 8 * j + 8],
                        torch.zeros(n)) for j in range(8)]
        out = out + (((p[0] + p[4]) + (p[2] + p[6])) + ((p[1] + p[5]) + (p[3] + p[7])))
    return out


@pytest.mark.parametrize("fault", list(_ROWS_FAULTS))
def test_bwd_product_inputs_catch_a_faulty_rows_pass(fault):
    """The card checks of the f32 backward reduce (``chip_smoke.py``,
    ``tests/test_torch_cuda.py``) hold den and gden within 1e-5 of their
    scale of ``bwd_reduce_plain`` in f64 and dinv within 1e-5 of its two
    sums' magnitude, on ``bwd_product_inputs`` among others. There the rows
    pass's arithmetic (a = q @ kvs in 3xTF32 summed as its warpgroup MMAs
    sum it, at the 16-deep period; sum_d g*a and sum_d g*v folded as it
    folds them, b as two f32 FMA chains, den, gden and the f64 dinv terms of
    the rows before N) passes, and the same arithmetic with one fault
    misses in gden, in dinv or in both."""
    gen = torch.Generator().manual_seed(31)
    q, _, v, g, kvs, ksum, scal, n_t = bwd_product_inputs(300, 128, 128, torch.float32,
                                                          gen)[:8]
    exact_den, exact_gden = attn.bwd_reduce_plain(*(t.double() for t in (q, v, g, kvs, ksum,
                                                                         scal, n_t)),
                                                  False)[3]
    qd, kvs_d = q.double(), kvs.double()
    exact = attn.bwd_reduce_plain(qd, v.double(), g.double(), kvs_d, ksum.double(),
                                  scal.double(), n_t.double(), False)[2]
    dinv_scale = ((g.double() / exact_den[:, None] * (qd @ kvs_d)).abs().sum()
                  + (exact_gden * (qd @ ksum.double())).abs().sum())
    past = bwd_product_inputs(_PAST_N, 128, 128, torch.float32,
                              torch.Generator().manual_seed(32))
    bufs = [torch.cat((a, b)) for a, b in zip((q, v, g), (past[0], past[2], past[3]))]
    inv, n = scal[2], n_t

    def misses(fault):
        """Whether den, gden and dinv miss their tolerances with ``fault``."""
        rows = bufs[0].shape[0] if fault.get("rows") else q.shape[0]
        qr, vr, gr = (t[:rows] for t in bufs)
        qa = fault.get("q", lambda t: t)(qr)
        ga_g = fault.get("g", lambda t: t)(gr)
        a = _mm_3xtf32_sums(qa, fault.get("kvs", lambda t: t)(kvs), _WG_PERIOD).float()
        s_ga, s_gv = _group_fold(ga_g, a), _group_fold(ga_g, vr)
        b = (_fma_chain(qr[:, 0::2], ksum[None, 0::2].expand(rows, -1), torch.zeros(rows))
             + _fma_chain(qr[:, 1::2], ksum[None, 1::2].expand(rows, -1), torch.zeros(rows)))
        den = inv * b + n
        gden = -(inv * s_ga + n * s_gv) / (den * den)
        dinv = ((s_ga / den).double() + (gden * b).double()).sum()
        nq = q.shape[0]
        return [bool((den[:nq] - exact_den).abs().max() > 1e-5 * exact_den.abs().max()),
                bool((gden[:nq] - exact_gden).abs().max() > 1e-5 * exact_gden.abs().max()),
                bool((dinv - exact).abs() > 1e-5 * dinv_scale)]

    assert misses({}) == [False] * 3
    assert misses(_ROWS_FAULTS[fault]) == _ROWS_FAULTS[fault]["misses"]


# The faults the bf16 rows pass's design (la_bwd_rows_ws16_kernel) can have,
# each as the operands its arithmetic would be formed from: a q k-tile
# taken from the previous row block's rows (``q``: a slot read before its
# refill landed), a ring stage one column tile stale (``kvs``: each
# 64-column tile's kvs^T chunk the tile before's), kvs^T's mid or lo piece
# dropped (``drop``), the g tile from the neighbouring column tile (``g``),
# or the rows of the last block past N read as the rows that follow the
# views and summed into dinv (``rows``); on ``bwd_product_inputs``, or on
# its ``cancel`` form where kvs's terms cancel in q @ kvs (``cancel``); with
# which of den, gden and dinv each misses (``misses``: den reads none of
# the faulty operands).
_BF16_ROWS_FAULTS = {
    "q k-tile from the previous row block": dict(
        q=lambda q: torch.cat((q[:, :64], torch.roll(q, 128, 0)[:, 64:128], q[:, 128:]), 1),
        misses=[False, True, True]),
    "ring stage one column tile stale": dict(kvs=_column_tiles_shifted,
                                             misses=[False, True, True]),
    "kvs mid piece dropped": dict(drop=(1,), misses=[False, True, True]),
    "kvs lo piece dropped": dict(drop=(2,), cancel=True, misses=[False, True, False]),
    "g tile from the neighbouring column tile": dict(g=_column_tiles_shifted,
                                                     misses=[False, True, True]),
    "rows past N summed into dinv": dict(rows=True, misses=[False, False, True]),
}


def _lane_fold(x, y):
    """sum_d x*y of each row as the bf16 rows pass folds it, in f32: each of
    a fragment row's four lanes an FMA chain from 0 over its two columns of
    every eight-column group (columns 8 j + 2 t4, + 1 of each 64-column
    tile, the tiles in order), the lanes added by the xor tree (0 + 1) +
    (2 + 3)."""
    n, d = x.shape
    pad = -d % 64
    x, y = (torch.cat((t.float(), torch.zeros(n, pad)), 1) for t in (x, y))
    lanes = []
    for t4 in range(4):
        cols = [c0 + 8 * j + 2 * t4 + e for c0 in range(0, d + pad, 64) for j in range(8)
                for e in range(2)]
        lanes.append(_fma_chain(x[:, cols], y[:, cols], torch.zeros(n)))
    return (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])


@pytest.mark.parametrize("fault", list(_BF16_ROWS_FAULTS))
def test_bwd_product_inputs_catch_a_faulty_bf16_rows_pass(fault):
    """The card checks of the bf16 backward reduce (``chip_smoke.py``,
    ``tests/test_torch_cuda.py``) hold den and gden within REDUCE_REL_TOL
    (1e-5) of their scale of ``bwd_reduce_plain`` in f64 and dinv within
    1e-5 of its two sums' magnitude, on ``bwd_product_inputs`` and its
    ``cancel`` form among others. There the rows pass's arithmetic (a = q @
    kvs with kvs as bf16 hi + mid + lo, summed as its warpgroup MMAs sum it,
    fresh sums every k16 step; sum_d g*a and sum_d g*v folded as its lanes
    fold them, b as two f32 FMA chains, den, gden and the f64 dinv terms of
    the rows before N) passes on both, and the same arithmetic with one
    fault misses in gden, in dinv or in both."""
    spec = _BF16_ROWS_FAULTS[fault]
    q, _, v, g, kvs, ksum, scal, n_t = bwd_product_inputs(
        300, 128, 128, torch.bfloat16, torch.Generator().manual_seed(33),
        cancel=spec.get("cancel", False))[:8]
    ind = [t.double() for t in (q, v, g, kvs, ksum, scal, n_t)]
    _, _, exact, (exact_den, exact_gden) = attn.bwd_reduce_plain(*ind, False)
    qd, kvs_d = ind[0], ind[3]
    dinv_scale = ((ind[2] / exact_den[:, None] * (qd @ kvs_d)).abs().sum()
                  + (exact_gden * (qd @ ind[4])).abs().sum())
    past = bwd_product_inputs(_PAST_N, 128, 128, torch.bfloat16,
                              torch.Generator().manual_seed(34))
    bufs = [torch.cat((a, b)) for a, b in zip((q, v, g), (past[0], past[2], past[3]))]
    inv, n = scal[2], n_t

    def misses(fault):
        """Whether den, gden and dinv miss their tolerances with ``fault``."""
        rows = bufs[0].shape[0] if fault.get("rows") else q.shape[0]
        qr, vr, gr = (t[:rows] for t in bufs)
        qa = fault.get("q", lambda t: t)(qr)
        ga_g = fault.get("g", lambda t: t)(gr)
        a = _mm_bf16_sums(qa, fault.get("kvs", lambda t: t)(kvs), 3, _BF16_PERIOD,
                          fault.get("drop", ())).float()
        s_ga, s_gv = _lane_fold(ga_g, a), _lane_fold(ga_g, vr)
        qf = qr.float()
        b = (_fma_chain(qf[:, 0::2], ksum[None, 0::2].expand(rows, -1), torch.zeros(rows))
             + _fma_chain(qf[:, 1::2], ksum[None, 1::2].expand(rows, -1), torch.zeros(rows)))
        den = inv * b + n
        gden = -(inv * s_ga + n * s_gv) / (den * den)
        dinv = ((s_ga / den).double() + (gden * b).double()).sum()
        nq = q.shape[0]
        return [bool((den[:nq] - exact_den).abs().max() > 1e-5 * exact_den.abs().max()),
                bool((gden[:nq] - exact_gden).abs().max() > 1e-5 * exact_gden.abs().max()),
                bool((dinv - exact).abs() > 1e-5 * dinv_scale)]

    assert misses({}) == [False] * 3
    assert misses(spec) == spec["misses"]


# Faults of the bf16 P pass where one block forms each chunk's gd = g/den
# once for every m row of its tile (la_bwd_reduce_ws16_kernel), each as the
# gd its product qᵀ gd would be formed from: gd's lo piece dropped (the
# split's second store lost), or gd from the neighbouring 64-row chunk (a
# gd buffer read before the split of its chunk landed).
_BF16_P_FAULTS = {
    "gd lo piece dropped": dict(drop=(1,)),
    "gd from the neighbouring chunk": dict(gd=lambda t: torch.roll(t, 64, 0)),
}


@pytest.mark.parametrize("fault", list(_BF16_P_FAULTS))
def test_bwd_product_inputs_catch_a_faulty_bf16_p_pass(fault):
    """The card checks of the bf16 backward reduce hold its P within
    REDUCE_REL_TOL (1e-5) of its scale of ``bwd_reduce_plain`` in f64 on
    ``bwd_product_inputs`` (positive q and g, den = 1 + q . ksum, so that
    g/den is no bf16 value and its lo piece matters). There the P pass's
    arithmetic (gd = g * (1/den) as bf16 hi + lo, exact products summed as
    its warpgroup MMAs sum them, fresh sums every 32 nodes) passes, and the
    same arithmetic with one fault in gd misses."""
    ins = bwd_product_inputs(300, 128, 128, torch.bfloat16, torch.Generator().manual_seed(35))
    q, _, v, g, kvs, ksum, scal, n_t = ins[:8]
    exact = attn.bwd_reduce_plain(*(t.double() for t in (q, v, g, kvs, ksum, scal, n_t)),
                                  False)[0]
    den = scal[2] * (q.float() @ ksum) + n_t  # the rows pass's den, to f32 rounding
    gd = g.float() * (1.0 / den)[:, None]
    assert not torch.equal(gd, gd.to(torch.bfloat16).float())

    def misses(spec):
        got = _mm_bf16_sums(q.T, spec.get("gd", lambda t: t)(gd), 2, _NODE_PERIOD,
                            spec.get("drop", ()))
        return ((got - exact).abs().max() > 1e-5 * exact.abs().max()).item()

    assert not misses({})
    assert misses(_BF16_P_FAULTS[fault])


# Faults the persistent bf16 backward apply (la_bwd_apply_ws16_kernel: items
# of 256 rows and one product, the A rows in slots that the item before
# frees, B chunks and the epilogue operand's halves through one ring, each
# warpgroup's 128 rows stored apart) can have, each as the operands its
# arithmetic would be formed from: an A slot (k chunk 1) still holding the
# previous item's rows (``a``: read before its refill landed), a B chunk (k
# chunk 1 of every column tile) from the neighbouring column tile (``b``, on
# B as the kernel reads it, [n][k]), the second 128 rows of each item taking
# the first rows' epilogue operand (``x``: a warpgroup reading the other's
# half of the stage), or the rows of the last item past N stored (``rows``);
# with which of dq, dk and dv misses the tolerance and whether the rows
# after the output views change (``misses``). The epilogue operand enters dq
# and dk only through the dinv terms (~1e-2 of a product term on
# ``bwd_product_inputs``); in dv n * g/den is one product term's size.
_BF16_APPLY_ITEM = 256
_BF16_APPLY_PAST = 200  # rows after the output views, as the card tests allocate them


def _a_slot_stale(t):
    return torch.cat((t[:, :64], torch.roll(t, _BF16_APPLY_ITEM, 0)[:, 64:128], t[:, 128:]), 1)


def _b_chunk_from_the_next_tile(b):
    out = b.clone()
    out[:, 64:128] = torch.roll(b[:, 64:128], 128, 0)
    return out


def _operand_of_the_first_rows(x):
    r = torch.arange(x.shape[0])
    return x[torch.where(r % _BF16_APPLY_ITEM >= 128, r - 128, r)]


_BF16_APPLY_FAULTS = {
    "A slot holding the previous item's rows": dict(a=_a_slot_stale,
                                                    misses=[True, True, True, False]),
    "B chunk from the neighbouring column tile": dict(b=_b_chunk_from_the_next_tile,
                                                      misses=[True, True, True, False]),
    "second 128 rows take the first rows' operand": dict(x=_operand_of_the_first_rows,
                                                         misses=[False, False, True, False]),
    "rows past N stored": dict(rows=True, misses=[False, False, False, True]),
}


@pytest.mark.parametrize("fault", list(_BF16_APPLY_FAULTS))
def test_bwd_product_inputs_catch_a_faulty_bf16_apply(fault):
    """The card checks of the bf16 backward apply (``chip_smoke.py``,
    ``tests/test_torch_cuda.py``) hold dq, dk and dv within the bf16
    tolerance (1e-2 of each output's scale) of ``bwd_apply_plain`` in f64 on
    ``bwd_product_inputs`` among others, and the rows that follow an output
    view to their NaN. There the persistent design's arithmetic (kvs and P
    as bf16 hi + lo, the products summed as its warpgroup MMAs sum them, the
    epilogue's terms, rounded to bf16 once, stores clipped at N) passes at M
    = D = 256 (two column tiles, four k chunks), and the same arithmetic
    with one fault misses in the outputs it reaches (the operand fault in
    dv, by 1.6-1.9 times the tolerance on three seeds; the card's random
    rows, where n * g/den carries dv, show it by far) or changes the rows
    after the views."""
    spec = _BF16_APPLY_FAULTS[fault]
    n, m = 300, 256
    ins = bwd_product_inputs(n, m, m, torch.bfloat16, torch.Generator().manual_seed(36))
    exact = attn.bwd_apply_plain(*(t.double() for t in ins), False)
    past = bwd_product_inputs(_BF16_APPLY_PAST, m, m, torch.bfloat16,
                              torch.Generator().manual_seed(37))
    q, k, v, g, kvs, ksum, scal, n_t, P, ds, dinv, rows = ins
    bufs = [torch.cat((a, b)) for a, b in zip((q, k, v, g), past[:4])]
    rows_buf = torch.cat((rows, past[11]), 1)
    inv = scal[2]
    c_q, c_k = dinv * inv / scal[0], dinv * inv / scal[1]

    def misses(fault):
        """Whether dq, dk and dv miss the tolerance with ``fault``, and
        whether the rows after their views change."""
        stored = n + _BF16_APPLY_PAST if fault.get("rows") else n
        qr, kr, vr, gr = (t[:stored] for t in bufs)
        den, gden = rows_buf[0, :stored, None], rows_buf[1, :stored, None]
        fa, fb, fx = (fault.get(key, lambda t: t) for key in ("a", "b", "x"))
        # the products' B as the kernel reads it, [n][k]: kvs, P, P^T
        sq, sk, sv = (_mm_bf16_sums(fa(a), fb(b).T, 2, m).float()
                      for a, b in ((gr, kvs), (vr, P), (kr, P.T)))
        xq, xk, xg = (fx(t).float() for t in (qr, kr, gr))
        outs = (inv * (sq / den) + inv * gden * ksum - c_q * xq, inv * sk + inv * ds - c_k * xk,
                n_t * (xg / den) + inv * sv)
        out = []
        changed = False
        for o, want in zip(outs, exact):
            buf = torch.full((n + _BF16_APPLY_PAST, o.shape[1]), float("nan"),
                             dtype=torch.bfloat16)
            buf[:stored] = o.to(torch.bfloat16)
            err = (buf[:n].double() - want).abs().max()
            out.append(bool(err > 1e-2 * want.abs().max()))
            changed = changed or not buf[n:].isnan().all()
        return out + [changed]

    assert misses({}) == [False] * 4
    assert misses(spec) == spec["misses"]


@pytest.mark.parametrize("masked", [False, True])
def test_tf32_backward_matches_jax_pallas_interpret(masked):
    """H = 1, f32: the port's attention gradient with the 3xTF32
    arithmetic of the backward kernels against ``jax.vjp`` of the Pallas
    ``fused_linear_attention`` in interpret mode, at the f32 tolerance (1e-5
    of scale). Masked rows are zeroed as the port's wrapper zeroes them; no
    row's den is 0 here, so the guard does not act."""
    q, k, v = _qkv(24, h=1)
    g = np.random.default_rng(25).standard_normal(v.shape).astype(np.float32)
    mask = (np.arange(q.shape[0]) % 7 != 3).astype(np.float32) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), "f32")
    _, vjp = jax.vjp(lambda a, b, c: jax_fused(a, b, c, node_mask=jmask, block=128,
                                               interpret=True), jq, jk, jv)
    want = vjp(jnp.asarray(g))
    keep = torch.ones(q.shape[0]) if mask is None else torch.from_numpy(mask)
    tq, tk, tv = (t[:, 0] * keep[:, None] for t in (tq, tk, tv))
    tg = torch.from_numpy(g[:, 0])
    n_t = keep.sum()
    sums = attn.reduce_plain(tq, tk, tv, masked)
    _, _, *got = _tf32_backward(tq, tk, tv, tg, *sums, n_t)
    got = [(t.float() * keep[:, None])[:, None] for t in got]
    _grads_close(got, want, TOL["f32"]["rtol"])


def _tf32_forward(q, k, v, n_total, guard=False, lo=True):
    """The f32 forward reduce (``la_reduce_wg_kernel``, one slice) and apply
    (``la_apply_wg_kernel``) in 3xTF32: kvs = kᵀv with the node axis as the
    MMAs' k, summed as they sum it (:func:`_mm_3xtf32_sums`, fresh sums every
    32 rows; returned in f64), ksum and the norms through the column sums
    (:func:`_column_sums`, 32-row chunks, three row groups) rounded to f32;
    then
    a = q @ kvs through :func:`_mm_3xtf32` on the f32 kvs, b = q . ksum, and
    the apply's epilogue in f32: out = (inv * a + n * v) / den, a zero den
    taken as 1 under ``guard``. ``lo=False``: one TF32 product each."""
    sums = dict(chunk=_NODE_CHUNK[torch.float32], groups=_SUM_GROUPS[torch.float32])
    kvs = _mm_3xtf32_sums(k.T, v, _NODE_PERIOD, lo)
    ksum = _column_sums(k, square=False, **sums).float()
    q_sq, k_sq = (_column_sums(x, square=True, **sums).float().double().sum().float()
                  for x in (q, k))
    inv = attn._inv(q_sq, k_sq, guard)
    a = _mm_3xtf32(q, kvs.float(), lo).float()
    b = (q.double() @ ksum.double()).float()
    den = inv * b + n_total
    if guard:
        den = torch.where(den == 0.0, torch.ones_like(den), den)
    return kvs, (inv * a + n_total * v) / den[:, None]


@pytest.mark.parametrize("n_one", [False, True])
@pytest.mark.parametrize("part", ["kvs", "out"])
def test_tf32_forward_keeps_f32_precision(part, n_one):
    """M = D = 256 on 2,048 rows, randn inputs at n = N (a batch's
    statistics) and positive ones at n = 1 (q @ kvs carries the output):
    the 3xTF32 arithmetic agrees with the plain forward in f64 to 1e-6 of
    each output's scale, where one TF32 product (hi*hi alone) is at least
    10x further off; at n = N, n * v swamps q @ kvs in out, so there only
    kvs tells them apart."""
    n, m = 2048, 256
    rng = np.random.default_rng(33)
    draw = rng.random if n_one else rng.standard_normal
    q, k, v = (torch.from_numpy(a) for a in draw((3, n, m)).astype(np.float32))
    n_t = torch.tensor(1.0 if n_one else float(n))
    qd, kd, vd = q.double(), k.double(), v.double()  # reduce_plain sums in f32
    kvs_x = kd.T @ vd
    inv = 1.0 / (qd.square().sum().sqrt() * kd.square().sum().sqrt())
    scal_x = torch.stack([inv.new_zeros(()), inv.new_zeros(()), inv, inv.new_zeros(())])
    want = {"kvs": kvs_x,
            "out": attn.apply_plain(qd, vd, kvs_x, kd.sum(0), scal_x, n_t.double(),
                                    False)}[part]
    i = ("kvs", "out").index(part)
    got = _tf32_forward(q, k, v, n_t)[i]
    one = _tf32_forward(q, k, v, n_t, lo=False)[i]
    err = (got.double() - want).abs().max()
    assert err <= 1e-6 * want.abs().max()
    if part == "kvs" or n_one:
        assert (one.double() - want).abs().max() >= 10 * err


# one slice of the forward reduce, longer than any the card's grid gives
_SLICE = 8192


def _node_axis_inputs(seed, positive, dtype=torch.float32):
    """k, v [_SLICE, 64] of ``dtype`` from seeded numpy (randn, or uniform
    in [0, 1)), and kᵀv in f64."""
    rng = np.random.default_rng(seed)
    k, v = (torch.from_numpy(a).to(dtype) for a in
            (rng.random if positive else rng.standard_normal)((2, _SLICE, 64))
            .astype(np.float32))
    return k, v, k.double().T @ v.double()


def _rel(got, want):
    return ((got.double() - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("positive", [False, True])
def test_tf32_node_axis_reduce_keeps_f32_precision(positive):
    """The f32 reduce's kᵀv over one slice of 8,192 rows, the node axis as
    the MMAs' k (:func:`_mm_3xtf32_sums`: each 8-row step's three products
    added into the period's sum by the tensor cores' truncating adds, fresh
    sums every 32 rows added in f32 round-to-nearest): within 1e-6 of the
    scale of kᵀv in f64, on randn and on positive inputs, where one
    truncating chain over the whole slice, or hi*hi alone (one TF32
    product), is at least 10x further off."""
    k, v, exact = _node_axis_inputs(35, positive)
    err = _rel(_mm_3xtf32_sums(k.T, v, _NODE_PERIOD), exact)
    assert err <= 1e-6, err
    chain = _rel(_mm_3xtf32_sums(k.T, v, _SLICE), exact)
    hi_hi = _rel(_mm_3xtf32_sums(k.T, v, _NODE_PERIOD, lo=False), exact)
    assert min(chain, hi_hi) >= 10 * err, (err, chain, hi_hi)


@pytest.mark.parametrize("draw", ["randn", "positive"])
def test_tf32_node_axis_bwd_reduce_keeps_f32_precision(draw):
    """The f32 backward P pass's P = qᵀ gd over one slice of 8,192 rows, gd
    = g * (1/den) as ``la_bwd_reduce_wg_kernel`` forms it (den's f32
    reciprocal, correctly rounded, then one rounded product), the node axis
    as the MMAs' k (:func:`_mm_3xtf32_sums`: fresh sums every 32 rows):
    within 1e-6 of the scale of qᵀ(g/den) in f64, on randn and on positive
    q and g, where one truncating chain over the whole slice, or hi*hi
    alone (one TF32 product), is at least 10x further off."""
    rng = np.random.default_rng(38)
    make = rng.standard_normal if draw == "randn" else rng.random
    q, g = (torch.from_numpy(a) for a in make((2, _SLICE, 64)).astype(np.float32))
    den = torch.from_numpy((0.5 + 1.5 * rng.random(_SLICE)).astype(np.float32))
    gd = g * (1.0 / den)[:, None]
    exact = q.double().T @ (g.double() / den.double()[:, None])
    err = _rel(_mm_3xtf32_sums(q.T, gd, _NODE_PERIOD), exact)
    assert err <= 1e-6, err
    chain = _rel(_mm_3xtf32_sums(q.T, gd, _SLICE), exact)
    hi_hi = _rel(_mm_3xtf32_sums(q.T, gd, _NODE_PERIOD, lo=False), exact)
    assert min(chain, hi_hi) >= 10 * err, (err, chain, hi_hi)


def _ds_sums(q, gden, f64_route=True):
    """ds = Σ_r q[r] gden[r] per column over one slice (f32 values) as the
    f32 P pass's three ds warps sum it: rows rg + 3 j of each 32-row chunk
    to row group rg; with ``f64_route`` (``la_bwd_reduce_wg_kernel``) each
    product, exact in f64, added by an f64 FMA to its group's sum; else as
    the forward reduce's column sums run (:func:`_column_sums`), one f32
    chain a group and chunk (each product added by one rounding, as an FMA
    adds it), made f64 once a chunk. The groups' sums are added in order at
    the end. Returns f64, before the rounding to f32."""
    chunk, groups = _NODE_CHUNK[torch.float32], _SUM_GROUPS[torch.float32]
    terms = q.double() * gden.double()[:, None]  # exact: f32 x f32 fits f64
    sums = torch.zeros(groups, q.shape[1], dtype=torch.float64)
    for c0 in range(0, q.shape[0], chunk):
        for rg in range(groups):
            chain = torch.zeros(q.shape[1], dtype=torch.float64)
            for y in terms[c0 + rg:c0 + chunk:groups]:
                if f64_route:
                    sums[rg] = sums[rg] + y
                else:
                    chain = (chain + y).float().double()
            if not f64_route:
                sums[rg] = sums[rg] + chain
    out = torch.zeros(q.shape[1], dtype=torch.float64)
    for rg in range(groups):
        out = out + sums[rg]
    return out


def test_bwd_reduce_ds_route_holds_f64_where_gden_cancels():
    """ds = Σ q·gden per column over one slice of 8,192 rows, gden's sign
    changing from row to row (randn q and gden) and the sum made to cancel
    to 1e-5 of Σ|q·gden| (each column's last q set so): the P pass's route
    (:func:`_ds_sums`: exact products added by f64 FMAs in three row
    groups), rounded to f32 once, is within 1e-6 of |ds| of the exact sum,
    where f32 chains made f64 once a 32-row chunk (the forward reduce's
    column sums' route) are at least 10x further off."""
    import math

    rng = np.random.default_rng(39)
    q = rng.standard_normal((_SLICE, 16)).astype(np.float32)
    gden = rng.standard_normal(_SLICE).astype(np.float32)
    gden[-1] = 1.0
    mags = np.abs(q.astype(np.float64) * gden.astype(np.float64)[:, None]).sum(0)
    for j in range(q.shape[1]):
        rest = math.fsum(float(x) * float(y) for x, y in zip(q[:-1, j], gden[:-1]))
        q[-1, j] = np.float32(1e-5 * mags[j] * rng.choice([-1.0, 1.0]) - rest)
    exact = torch.tensor([math.fsum(float(x) * float(y) for x, y in zip(q[:, j], gden))
                          for j in range(q.shape[1])], dtype=torch.float64)
    assert (exact.abs() <= 2e-5 * torch.from_numpy(mags)).all()  # the sums cancel
    qt, gt = torch.from_numpy(q), torch.from_numpy(gden)
    err = ((_ds_sums(qt, gt).float().double() - exact).abs() / exact.abs()).max().item()
    assert err <= 1e-6, err
    f32 = ((_ds_sums(qt, gt, f64_route=False).float().double() - exact).abs()
           / exact.abs()).max().item()
    assert f32 >= 10 * err and f32 > 1e-6, (err, f32)


# Faults of the f32 P pass, each as what its product qᵀ gd would be formed
# from (A = qᵀ, B = gd, k the node axis): a tf32 lo piece dropped (of gd or
# of q: one TF32 product in place of three), A's node k-steps swapped (k and
# k ^ 8), and B's columns swapped in pairs.
_P_PASS_FAULTS = {
    "gd lo piece dropped": lambda a, b: (a, _tf32(b)),
    "q lo piece dropped": lambda a, b: (_tf32(a), b),
    "k-steps swapped": lambda a, b: (a[:, torch.arange(a.shape[1]) ^ 8], b),
    "B columns swapped": lambda a, b: (a, b[:, torch.arange(b.shape[1]) ^ 1]),
}


@pytest.mark.parametrize("fault", list(_P_PASS_FAULTS))
def test_bwd_reduce_product_inputs_catch_a_faulty_kernel(fault):
    """The card checks of the f32 backward reduce (``chip_smoke.py``,
    ``tests/test_torch_cuda.py``, ``chip_compare.py tf32-bwd``) hold its P
    to ``bwd_reduce_plain`` in f64 at 1e-5 of its scale on
    ``bwd_reduce_product_inputs`` (positive q and g a fraction of a tf32
    step above tf32 values, every den exactly 1). There the P pass's
    arithmetic (gd = g * (1/den), 3xTF32 products summed as its warpgroup
    MMAs sum them) passes, and the same arithmetic with one fault in its
    product misses."""
    ins = bwd_reduce_product_inputs(320, 128, 128, torch.float32,
                                    torch.Generator().manual_seed(30))
    q, v, g, kvs, ksum, scal, n_t = ins
    exact = attn.bwd_reduce_plain(*(t.double() for t in ins), False)[0]
    den = scal[2] * (q @ ksum) + n_t  # the rows pass's den
    assert bool((den == 1.0).all())
    gd = g * (1.0 / den)[:, None]

    def misses(broken):
        got = _mm_3xtf32_sums(*broken(q.T, gd), _NODE_PERIOD)
        return ((got - exact).abs().max() > 1e-5 * exact.abs().max()).item()

    assert not misses(lambda a, b: (a, b))
    assert misses(_P_PASS_FAULTS[fault])


@pytest.mark.parametrize("positive", [False, True])
def test_bf16_node_axis_reduce_keeps_f32_precision(positive):
    """The bf16 reduce's kᵀv over one slice of 8,192 rows (exact products,
    each 16-row step's sum added by the tensor cores' truncating adds, fresh
    sums every 32 rows: :func:`_mm_bf16_sums` with the node axis as k):
    within 1e-6 of the scale of kᵀv in f64, on randn and on positive inputs,
    where one truncating chain over the whole slice is at least 10x further
    off."""
    k, v, exact = _node_axis_inputs(36, positive, torch.bfloat16)
    err = _rel(_mm_bf16_sums(k.T, v, 1, _NODE_PERIOD), exact)
    assert err <= 1e-6, err
    chain = _rel(_mm_bf16_sums(k.T, v, 1, _SLICE), exact)
    assert chain >= 10 * err, (err, chain)


def test_forward_reduce_column_sums_hold_f64():
    """The forward reduces' column sums (:func:`_column_sums`: an f32 chain
    a row group, made f64 once a chunk) over one slice of 8,192 rows,
    randn and positive f32 values: Σx and Σx² within 1e-6 of their f64
    sums' scale, bf16 values within 1e-7 (their squares are exact in f32)."""
    rng = np.random.default_rng(37)
    for draw in (rng.standard_normal, rng.random):
        x = torch.from_numpy(draw((_SLICE, 16)).astype(np.float32))
        for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 1e-7)):
            xs = x.to(dtype).float()
            for square in (False, True):
                want = (xs.double() ** (2 if square else 1)).sum(0)
                got = _column_sums(xs, _NODE_CHUNK[dtype], square, _SUM_GROUPS[dtype])
                assert ((got - want).abs().max() / want.abs().max()).item() <= tol


@pytest.mark.parametrize("masked", [False, True])
def test_tf32_forward_matches_jax_pallas_interpret(masked):
    """H = 1, f32: the port's attention forward with the 3xTF32 arithmetic
    of the forward kernels against the Pallas ``fused_linear_attention`` in
    interpret mode, at the f32 tolerance. Masked rows are zeroed as the
    port's wrapper zeroes them, and n is the count of kept rows."""
    q, k, v = _qkv(26, h=1)
    mask = (np.arange(q.shape[0]) % 7 != 3).astype(np.float32) if masked else None
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), "f32")
    want = jax_fused(jq, jk, jv, node_mask=None if mask is None else jnp.asarray(mask),
                     block=128, interpret=True)
    keep = torch.ones(q.shape[0]) if mask is None else torch.from_numpy(mask)
    tq, tk, tv = (t[:, 0] * keep[:, None] for t in (tq, tk, tv))
    _, got = _tf32_forward(tq, tk, tv, keep.sum(), guard=masked)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got[:, None].numpy(), np.asarray(want), **TOL["f32"])
