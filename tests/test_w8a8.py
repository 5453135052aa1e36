"""W8A8 (int8 activations x int8 weights) path tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from eetq_tpu.layout import pack_weights
from eetq_tpu.ops.linear8 import quantize_activations, w8a8_matmul
from eetq_tpu.quant import symmetric_quantize


def _np_w8a8(x, q, s, bias=None, activation=None):
    """numpy oracle: per-token int8 activations (round half to even, like
    jnp.round), exact integer products, per-channel or per-group scales."""
    xf = np.asarray(x, np.float32)
    sx = np.abs(xf).max(-1) / 127.0
    safe = np.where(sx == 0, 1.0, sx)
    xq = np.clip(np.round(xf / safe[:, None]), -127, 127).astype(np.int64)
    qi = np.asarray(q, np.int64)
    s = np.asarray(s, np.float64)
    if s.ndim == 1:
        r = (xq @ qi) * s
    else:
        g = qi.shape[0] // s.shape[0]
        r = sum(
            (xq[:, i * g : (i + 1) * g] @ qi[i * g : (i + 1) * g]) * s[i]
            for i in range(s.shape[0])
        )
    r = r * sx[:, None]
    if bias is not None:
        r = r + np.asarray(bias, np.float64)
    if activation == "silu":
        r = r / (1.0 + np.exp(-r))
    return r.astype(np.float32)


def test_quantize_activations(rng):
    x = jnp.asarray(rng.standard_normal((4, 64)).astype(np.float32))
    q, s = quantize_activations(x)
    assert q.dtype == jnp.int8 and s.shape == (4,)
    deq = np.asarray(q, np.float32) * np.asarray(s)[:, None]
    err = np.abs(deq - np.asarray(x))
    assert (err <= np.asarray(s)[:, None] * 0.5 + 1e-6).all()


def test_zero_row_safe():
    x = jnp.zeros((2, 32), jnp.float32)
    q, s = quantize_activations(x)
    assert (np.asarray(q) == 0).all() and (np.asarray(s) == 0).all()


@pytest.mark.parametrize("m,k,n", [(1, 256, 256), (64, 512, 512), (100, 300, 200)])
def test_kernel_matches_reference(rng, m, k, n):
    x = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32))
    w = rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)
    q, s = symmetric_quantize(jnp.asarray(w))
    out = w8a8_matmul(x, pack_weights(q), s)
    ref = _np_w8a8(x, q, s)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), ref,
        rtol=2e-2, atol=2e-2,
    )


def test_accuracy_vs_fp32(rng):
    """W8A8 error stays within a few times the W8A16 error at unit scale."""
    m, k, n = 64, 1024, 512
    x = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32))
    w = rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)
    q, s = symmetric_quantize(jnp.asarray(w))
    out = np.asarray(w8a8_matmul(x, pack_weights(q), s), np.float32)
    exact = np.asarray(x) @ w
    assert np.abs(out - exact).mean() < 5e-2


def test_bias_activation_epilogue(rng):
    m, k, n = 8, 512, 256
    x = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32))
    w = rng.standard_normal((k, n)).astype(np.float32)
    bias = jnp.asarray(rng.standard_normal((n,)).astype(np.float32))
    q, s = symmetric_quantize(jnp.asarray(w))
    out = w8a8_matmul(x, q, s, bias=bias, activation="silu")
    ref = _np_w8a8(x, q, s, bias=bias, activation="silu")
    np.testing.assert_allclose(
        np.asarray(out, np.float32), ref,
        rtol=2e-2, atol=2e-2,
    )


def test_rejects_int8_groupwise_accepts_int4(rng):
    w = rng.standard_normal((256, 128)).astype(np.float32)
    # int4 routes to W4A8 (tests/test_w4a8.py)
    q4, s4 = symmetric_quantize(jnp.asarray(w), bits=4)
    out = w8a8_matmul(jnp.ones((2, 256)), pack_weights(q4, bits=4), s4)
    assert out.shape == (2, 128)
    # int8 group-wise stays on the W8A16 path
    qg, sg = symmetric_quantize(jnp.asarray(w), group_size=64)
    with pytest.raises(ValueError):
        w8a8_matmul(jnp.ones((2, 256)), pack_weights(qg), sg)


def test_a8_prefill_model_quality(rng):
    """W8A8 prefill on a full model: logits close to the W8A16 path."""
    import jax

    from eetq_tpu.models import ModelConfig, quantize_params, random_dense_params
    from eetq_tpu.models.transformer import forward

    cfg = ModelConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=16, max_position=64,
    )
    params = quantize_params(
        random_dense_params(cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    )
    toks = jnp.arange(16, dtype=jnp.int32)[None, :]
    pos = jnp.arange(16, dtype=jnp.int32)[None, :]
    lg16, _ = forward(params, cfg, toks, pos, None, jnp.int32(0))
    lg8, _ = forward(params, cfg, toks, pos, None, jnp.int32(0), a8=True)
    err = np.abs(np.asarray(lg8) - np.asarray(lg16)).mean()
    spread = np.abs(np.asarray(lg16)).mean()
    assert err < 0.1 * max(spread, 1.0), (err, spread)
