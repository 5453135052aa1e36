"""W4A8 (int8 activations x int4 split-half-packed weights) path tests.

The int4 analogue of the W8A8 prefill path: nibbles unpacked to int8
operands, s8 x s8 -> s32 dots, per-channel or group-wise dequant (the
reference's int8 epilogue infrastructure, `epilogue_quant_helper.h:36-42`,
has no int4-activation-quantized variant).
"""

import jax
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


@pytest.mark.parametrize(
    "m,k,n,g",
    [
        (16, 256, 256, None),   # per-channel
        (64, 512, 256, 64),     # group-wise g=64
        (33, 512, 384, 128),    # group-wise g=128, padded m
        (100, 384, 200, None),  # padded everything
    ],
)
def test_w4a8_kernel_matches_reference(rng, m, k, n, g):
    x = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32))
    w = rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)
    q, s = symmetric_quantize(jnp.asarray(w), bits=4, group_size=g)
    out = w8a8_matmul(x, pack_weights(q, bits=4), s)
    ref = _np_w8a8(x, q, s)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), ref,
        rtol=2e-2, atol=2e-2,
    )


def test_w4a8_bias_activation(rng):
    m, k, n, g = 24, 512, 256, 128
    x = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32))
    w = rng.standard_normal((k, n)).astype(np.float32)
    bias = jnp.asarray(rng.standard_normal((n,)).astype(np.float32))
    q, s = symmetric_quantize(jnp.asarray(w), bits=4, group_size=g)
    out = w8a8_matmul(x, pack_weights(q, bits=4), s, bias=bias,
                      activation="silu")
    ref = _np_w8a8(x, q, s, bias=bias, activation="silu")
    np.testing.assert_allclose(
        np.asarray(out, np.float32), ref,
        rtol=2e-2, atol=2e-2,
    )


def test_w4a8_accuracy_vs_fp32(rng):
    """W4A8 error is bounded by int4 group quantization + int8 activation
    quantization — a few times the W4A16 error at unit scale."""
    m, k, n = 32, 1024, 512
    x = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32))
    w = rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)
    q, s = symmetric_quantize(jnp.asarray(w), bits=4, group_size=128)
    out = np.asarray(
        w8a8_matmul(x, pack_weights(q, bits=4), s), np.float32
    )
    exact = np.asarray(x) @ w
    assert np.abs(out - exact).mean() < 0.15


def test_w4a8_linear_apply_gate(rng):
    """linear_apply(a8=True) routes int4 QuantLinears through W4A8 and
    matches the explicit op."""
    from eetq_tpu.modules.linear import linear_apply, quantize_linear

    k, n = 256, 128
    w = jnp.asarray(rng.standard_normal((k, n)).astype(np.float32))
    lay = quantize_linear(w, bits=4, group_size=64)
    x = jnp.asarray(rng.standard_normal((4, k)).astype(np.float32))
    out = linear_apply(lay, x, a8=True)
    direct = w8a8_matmul(x, lay.qweight, lay.scales)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(direct))


def test_w4a8_engine_prefill(rng):
    """Engine a8_prefill on an int4 group-wise model: decodes greedily and
    stays close to the non-a8 engine (prefill activation quantization only
    perturbs the first token's logits)."""
    from eetq_tpu.models import ModelConfig, quantize_params, random_dense_params
    from eetq_tpu.serve.engine import Engine

    cfg = ModelConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=16, max_position=128,
    )
    params = quantize_params(
        random_dense_params(cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16),
        bits=4, group_size=32,
    )
    prompt = [3, 17, 42, 9]
    ref_eng = Engine(params, cfg, max_batch=2, max_len=64, prompt_buckets=(8,))
    u0 = ref_eng.add_request(prompt, 8)
    ref_eng.run()
    eng = Engine(params, cfg, max_batch=2, max_len=64, prompt_buckets=(8,),
                 a8_prefill=True)
    u1 = eng.add_request(prompt, 8)
    eng.run()
    a, b = ref_eng.result(u0), eng.result(u1)
    assert len(b) == 8
    # same greedy continuation in the (common) case the first token agrees
    if a[0] == b[0]:
        assert a == b
