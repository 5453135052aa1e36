"""Module-level tests: QuantLinear vs dense oracle (the analogue of the
reference's examples/layers/test_qlinear.py), LoRA, rope, rmsnorm."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eetq_tpu.modules import (
    DenseLinear,
    LoraAdapter,
    linear_apply,
    quantize_linear,
)
from eetq_tpu.modules.linear import init_only_linear
from eetq_tpu.ops import make_cos_sin_cache, rmsnorm, rope


def test_quantlinear_matches_dense(rng):
    k, n, m = 512, 256, 128
    w = rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)
    b = rng.standard_normal(n).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32))
    ql = quantize_linear(jnp.asarray(w), bias=jnp.asarray(b))
    dl = DenseLinear(weight=jnp.asarray(w), bias=jnp.asarray(b))
    out_q = linear_apply(ql, x)
    out_d = linear_apply(dl, x)
    # int8 per-channel quantization noise accumulates ~ sqrt(K) * step/2;
    # for K=512 unit-variance that's ~2e-2 worst case (the reference's
    # test_qlinear.py checks atol=1e-2 on fp16 at its shapes).
    err = np.abs(np.asarray(out_q) - np.asarray(out_d))
    assert err.max() < 5e-2, err.max()
    assert err.mean() < 1e-2, err.mean()


def test_quantlinear_bnb_external_scales(rng):
    """bitsandbytes import path: pre-quantized int8 + SCB/127 scales
    (reference utils/quantizer.py:23-25)."""
    k, n = 256, 256
    w = rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)
    from eetq_tpu.quant import symmetric_quantize

    q, s = symmetric_quantize(jnp.asarray(w))
    ql = quantize_linear(q, external_scales=s)
    ql2 = quantize_linear(jnp.asarray(w))
    x = jnp.asarray(rng.standard_normal((16, k)).astype(np.float32))
    np.testing.assert_array_equal(
        np.asarray(linear_apply(ql, x)), np.asarray(linear_apply(ql2, x))
    )


def test_quantlinear_errors(rng):
    with pytest.raises(ValueError):
        quantize_linear(jnp.zeros((8, 8), jnp.int8))  # int8 without scales
    with pytest.raises(ValueError):
        quantize_linear(jnp.zeros((8, 8)), external_scales=jnp.ones(8))


def test_init_only_shell():
    ql = init_only_linear(128, 64, with_bias=True)
    assert ql.in_features == 128 and ql.out_features == 64
    assert ql.bias is not None


def test_lora_side_path(rng):
    k, n, r = 256, 256, 8
    w = rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)
    a = rng.standard_normal((k, r)).astype(np.float32) * 0.01
    bmat = rng.standard_normal((r, n)).astype(np.float32) * 0.01
    x = jnp.asarray(rng.standard_normal((4, k)).astype(np.float32))
    ql = quantize_linear(jnp.asarray(w))
    lora = LoraAdapter(lora_a=jnp.asarray(a), lora_b=jnp.asarray(bmat), scaling=2.0)
    out = linear_apply(ql, x, lora=lora)
    base = linear_apply(ql, x)
    expected_side = (np.asarray(x) @ a @ bmat) * 2.0
    # atol covers a compiled f32 dot's rounding
    np.testing.assert_allclose(
        np.asarray(out) - np.asarray(base), expected_side, rtol=1e-3, atol=3e-4
    )


def test_lora_backward_grads_flow(rng):
    """LoRA-over-frozen-quantized training path: grads flow through the
    dequantizing matmul to x and to LoRA params (the reference implements
    this as a hand-written autograd backward, qlinear.py:64-94; here jax AD
    differentiates the dequant matmul directly)."""
    k, n, r = 128, 64, 4
    w = rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)
    ql = quantize_linear(jnp.asarray(w))
    lora = LoraAdapter(
        lora_a=jnp.asarray(rng.standard_normal((k, r)).astype(np.float32) * 0.01),
        lora_b=jnp.zeros((r, n), jnp.float32),
        scaling=1.0,
    )
    x = jnp.asarray(rng.standard_normal((2, k)).astype(np.float32))

    def loss(lora, x):
        return jnp.sum(linear_apply(ql, x, lora=lora) ** 2)

    grads_lora, grads_x = jax.grad(loss, argnums=(0, 1))(lora, x)
    assert float(jnp.abs(grads_lora.lora_b).sum()) > 0
    assert float(jnp.abs(grads_x).sum()) > 0
    # frozen base: qweight is int8, not differentiable — by construction.


def test_rope_neox_convention(rng):
    """Position 0 is identity; rotation preserves norms; matches the
    split-half NeoX formula."""
    cache = make_cos_sin_cache(64, 32)
    x = jnp.asarray(rng.standard_normal((1, 1, 2, 32)).astype(np.float32))
    pos0 = jnp.zeros((1, 1), jnp.int32)
    np.testing.assert_allclose(
        np.asarray(rope(x, pos0, cache)), np.asarray(x), rtol=1e-6, atol=1e-6
    )
    pos = jnp.full((1, 1), 7, jnp.int32)
    out = rope(x, pos, cache)
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(out), axis=-1),
        np.linalg.norm(np.asarray(x), axis=-1),
        rtol=1e-5,
    )
    # explicit NeoX formula for dim pair (i, i+half)
    half = 16
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, 32, 2) / 32))
    ang = 7 * inv_freq
    x_np = np.asarray(x)
    expect_first = x_np[..., :half] * np.cos(ang) - x_np[..., half:] * np.sin(ang)
    np.testing.assert_allclose(np.asarray(out)[..., :half], expect_first, rtol=1e-5, atol=1e-6)


def test_rope_partial_rotary(rng):
    """rot_dim < head_dim leaves the tail untouched."""
    cache = make_cos_sin_cache(16, 16)
    x = jnp.asarray(rng.standard_normal((1, 2, 1, 32)).astype(np.float32))
    pos = jnp.asarray([[3, 5]], jnp.int32)
    out = rope(x, pos, cache)
    np.testing.assert_array_equal(np.asarray(out)[..., 16:], np.asarray(x)[..., 16:])


def test_rmsnorm_matches_formula(rng):
    x = rng.standard_normal((4, 64)).astype(np.float32)
    g = rng.standard_normal(64).astype(np.float32)
    out = rmsnorm(jnp.asarray(x), jnp.asarray(g), eps=1e-5)
    expected = x / np.sqrt((x**2).mean(-1, keepdims=True) + 1e-5) * g
    np.testing.assert_allclose(np.asarray(out), expected, rtol=1e-5, atol=1e-6)
