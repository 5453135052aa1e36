"""int4 (W4A16) and group-wise quantization tests: the reference GEMV's
Int4b and GroupWise(64/128) modes (`csrc/weightOnlyBatchedGemv/common.h`,
instantiations `weightOnlyBatchedGemvBs{1..4}Int4b.cu`), rebuilt as kernel
features (split-half nibble packing + in-loop group scales)."""

import jax.numpy as jnp
import numpy as np
import pytest

from eetq_tpu.layout import pack_weights, unpack_weights
from eetq_tpu.modules.linear import linear_apply, quantize_linear
from eetq_tpu.ops import w8a16_matmul
from eetq_tpu.quant import dequantize, symmetric_quantize


def _np_ref(x, q, s, bias=None, activation=None):
    """numpy f32 oracle: x @ dequant(q, s), per-channel [N] or group-wise
    [G, N] scales (each group's scale repeated over its K rows)."""
    s = np.asarray(s, np.float32)
    qf = np.asarray(q, np.float32)
    if s.ndim == 2:
        s = np.repeat(s, qf.shape[0] // s.shape[0], axis=0)
    r = np.asarray(x, np.float32) @ (qf * s)
    if bias is not None:
        r = r + np.asarray(bias, np.float32)
    if activation == "silu":
        r = r / (1.0 + np.exp(-r))
    return r


# ---------- quantizer ----------


def test_groupwise_quantize_shapes_and_oracle(rng):
    w = rng.standard_normal((512, 128)).astype(np.float32)
    q, s = symmetric_quantize(jnp.asarray(w), group_size=64)
    assert q.shape == (512, 128) and s.shape == (8, 128)
    # each group independently: absmax/127 scale
    for gi in range(8):
        blk = w[gi * 64 : (gi + 1) * 64]
        np.testing.assert_allclose(
            np.asarray(s)[gi], np.abs(blk).max(0) / 128.0, rtol=1e-6
        )
    # roundtrip error bounded by one scale step per group (the absmax
    # element quantizes to 128 and clips to 127 -> error exactly one step)
    deq = np.asarray(dequantize(q, s))
    err = np.abs(deq - w)
    bound = np.repeat(np.asarray(s), 64, axis=0) * (1 + 1e-4) + 1e-7
    assert (err <= bound).all()


def test_groupwise_equals_per_channel_when_one_group(rng):
    w = jnp.asarray(rng.standard_normal((256, 64)).astype(np.float32))
    q1, s1 = symmetric_quantize(w)
    q2, s2 = symmetric_quantize(w, group_size=256)
    np.testing.assert_array_equal(np.asarray(q1), np.asarray(q2))
    np.testing.assert_allclose(np.asarray(s1), np.asarray(s2)[0], rtol=1e-7)


def test_groupwise_int4(rng):
    w = jnp.asarray(rng.standard_normal((256, 64)).astype(np.float32))
    q, s = symmetric_quantize(w, bits=4, group_size=64)
    assert int(jnp.max(q)) <= 7 and int(jnp.min(q)) >= -8
    assert s.shape == (4, 64)


# ---------- layout: int4 split-half packing ----------


@pytest.mark.parametrize("shape", [(512, 256), (300, 100), (2, 256, 128)])
def test_int4_pack_unpack_roundtrip(rng, shape):
    q = rng.integers(-8, 8, size=shape).astype(np.int8)
    pw = pack_weights(jnp.asarray(q), bits=4)
    assert pw.bits == 4
    assert pw.data.shape[-2] * 2 == pw.kp
    back = np.asarray(unpack_weights(pw))
    np.testing.assert_array_equal(back, q)


def test_int4_packed_size_is_half(rng):
    q = rng.integers(-8, 8, size=(512, 256)).astype(np.int8)
    pw = pack_weights(jnp.asarray(q), bits=4)
    assert pw.data.shape == (256, 256)


# ---------- matmul: int4 ----------


@pytest.mark.parametrize("m,k,n", [(1, 512, 256), (8, 1024, 512), (64, 512, 512),
                                   (100, 300, 200)])
def test_int4_kernel_matches_reference(rng, m, k, n):
    x = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32))
    w = rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)
    q, s = symmetric_quantize(jnp.asarray(w), bits=4)
    out = w8a16_matmul(x, pack_weights(q, bits=4), s)
    ref = _np_ref(x, q, s)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), ref,
        rtol=2e-2, atol=2e-2,
    )


def test_int4_raw_array_entry(rng):
    """bits=4 with a raw int8-holding-int4 array packs on the fly."""
    x = jnp.asarray(rng.standard_normal((4, 512)).astype(np.float32))
    w = rng.standard_normal((512, 256)).astype(np.float32)
    q, s = symmetric_quantize(jnp.asarray(w), bits=4)
    out_raw = w8a16_matmul(x, q, s, bits=4)
    out_packed = w8a16_matmul(x, pack_weights(q, bits=4), s)
    np.testing.assert_array_equal(np.asarray(out_raw), np.asarray(out_packed))


# ---------- matmul: group-wise ----------


@pytest.mark.parametrize("m", [1, 8, 64])
@pytest.mark.parametrize("g", [64, 128, 256])
def test_groupwise_kernel_matches_reference(rng, m, g):
    k, n = 512, 256
    x = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32))
    w = rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)
    q, s = symmetric_quantize(jnp.asarray(w), group_size=g)
    out = w8a16_matmul(x, q, s)
    ref = _np_ref(x, q, s)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), ref,
        rtol=2e-2, atol=2e-2,
    )


def test_group_spanning_multiple_blocks(rng):
    """A group (g=512) spanning several 256-row tiles of the padded
    layout: each K row takes its own group's scale."""
    k, n = 1024, 256
    x = jnp.asarray(rng.standard_normal((4, k)).astype(np.float32))
    w = rng.standard_normal((k, n)).astype(np.float32)
    q, s = symmetric_quantize(jnp.asarray(w), group_size=512)
    out = w8a16_matmul(x, q, s)
    ref = _np_ref(x, q, s)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), ref,
        rtol=2e-2, atol=2e-2,
    )


def test_int4_groupwise_kernel(rng):
    k, n = 512, 256
    x = jnp.asarray(rng.standard_normal((8, k)).astype(np.float32))
    w = rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)
    q, s = symmetric_quantize(jnp.asarray(w), bits=4, group_size=128)
    out = w8a16_matmul(x, pack_weights(q, bits=4), s)
    ref = _np_ref(x, q, s)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), ref,
        rtol=2e-2, atol=2e-2,
    )


def test_groupwise_accuracy_beats_per_channel(rng):
    """The point of group-wise: outlier rows only poison their own group.
    Construct a weight with one huge row; per-channel int4 loses most
    precision, group-wise keeps the other groups exact-ish."""
    k, n = 512, 128
    w = rng.standard_normal((k, n)).astype(np.float32)
    w[0, :] *= 50.0  # outlier row
    x = jnp.asarray(rng.standard_normal((16, k)).astype(np.float32))
    exact = np.asarray(x) @ w

    q_pc, s_pc = symmetric_quantize(jnp.asarray(w), bits=4)
    q_gw, s_gw = symmetric_quantize(jnp.asarray(w), bits=4, group_size=64)
    err_pc = np.abs(np.asarray(w8a16_matmul(x, pack_weights(q_pc, bits=4), s_pc),
                               np.float32) - exact).mean()
    err_gw = np.abs(np.asarray(w8a16_matmul(x, pack_weights(q_gw, bits=4), s_gw),
                               np.float32) - exact).mean()
    assert err_gw < err_pc * 0.5, (err_gw, err_pc)


# ---------- module + epilogue integration ----------


def test_quantize_linear_int4_groupwise_forward(rng):
    w = rng.standard_normal((512, 256)).astype(np.float32) / 20
    b = rng.standard_normal((256,)).astype(np.float32)
    ql = quantize_linear(jnp.asarray(w), bias=jnp.asarray(b), bits=4,
                         group_size=128)
    x = jnp.asarray(rng.standard_normal((4, 512)).astype(np.float32))
    out = np.asarray(linear_apply(ql, x), np.float32)
    exact = np.asarray(x) @ w + b
    assert np.abs(out - exact).mean() < 0.15


def test_groupwise_with_epilogue(rng):
    k, n = 512, 256
    x = jnp.asarray(rng.standard_normal((8, k)).astype(np.float32))
    w = rng.standard_normal((k, n)).astype(np.float32)
    bias = jnp.asarray(rng.standard_normal((n,)).astype(np.float32))
    q, s = symmetric_quantize(jnp.asarray(w), group_size=128)
    out = w8a16_matmul(x, q, s, bias=bias, activation="silu")
    ref = _np_ref(x, q, s, bias=bias, activation="silu")
    np.testing.assert_allclose(
        np.asarray(out, np.float32), ref,
        rtol=2e-2, atol=2e-2,
    )
