"""The port's linear attention (the reduce/apply wrappers' CPU path and the
plain version) against the JAX package: its Pallas ``fused_linear_attention``
(reduce and apply kernels, interpret mode) and its XLA
``linear_attention``.

Tolerances: f32 1e-5 (summation order only); bf16 2e-2, because the Pallas
apply rounds kvs to bf16 before its product (kernels/attention.py:83) and the
XLA path rounds its bf16 products differently, while the port keeps kvs and
every sum in f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sgformer_tpu.kernels.attention import fused_linear_attention as jax_fused
from sgformer_tpu.ops.attention import linear_attention as jax_linear_attention

from sgformer_tpu_torch.kernels import attention as attn
from sgformer_tpu_torch.kernels.attention import fused_linear_attention
from sgformer_tpu_torch.ops.attention import linear_attention

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
