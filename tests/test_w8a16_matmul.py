"""Quantized-matmul tests — the analogue (and superset) of the reference's
`examples/layers/test_w8a16_gemm.py` dual-path consistency check:
quantize -> pack -> w8a16_matmul must equal a float dequant-matmul oracle,
in both regimes (decode m <= 8 and prefill), with every epilogue; plus the
decode GEMV kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest

from eetq_tpu.kernels.gemv import DEFAULT, MAX_M, GemvConfig, choose_splits, int8_gemv
from eetq_tpu.layout import pack_weights
from eetq_tpu.ops.linear import w8a16_matmul_ref
from eetq_tpu.ops import w8a16_matmul
from eetq_tpu.quant import symmetric_quantize


def _setup(rng, m, k, n, dtype=jnp.float32):
    x = jnp.asarray(rng.standard_normal((m, k)).astype(np.float32), dtype=dtype)
    w = rng.standard_normal((k, n)).astype(np.float32) / np.sqrt(k)
    q, s = symmetric_quantize(jnp.asarray(w))
    return x, q, s, w


@pytest.mark.parametrize(
    "m,k,n",
    [
        (1, 256, 256),     # decode regime, exact tile
        (4, 512, 768),     # decode regime (reference SMALL_M_FAST_PATH m<=4)
        (8, 512, 512),     # decode boundary
        (16, 256, 256),    # prefill regime, small
        (100, 300, 200),   # unaligned everything
        (128, 1024, 512),  # prefill regime
    ],
)
def test_kernel_matches_reference(rng, m, k, n):
    x, q, s, _ = _setup(rng, m, k, n)
    out = w8a16_matmul(x, q, s)
    ref = np.asarray(x, np.float32) @ (
        np.asarray(q, np.float32) * np.asarray(s, np.float32)
    )
    np.testing.assert_allclose(
        np.asarray(out, np.float32), ref, rtol=2e-2, atol=2e-2
    )


def test_dual_path_consistency(rng):
    """quantize->pack->kernel == quantize->kernel(raw int8): the reference's
    test_w8a16_gemm.py:28-48 invariant."""
    x, q, s, _ = _setup(rng, 16, 512, 512)
    out_raw = w8a16_matmul(x, q, s)
    out_packed = w8a16_matmul(x, pack_weights(q), s)
    np.testing.assert_array_equal(np.asarray(out_raw), np.asarray(out_packed))


def test_accuracy_vs_fp32_matmul(rng):
    """End-to-end quantization error at module tolerance (reference
    test_qlinear.py uses atol=1e-2 at fp16)."""
    x, q, s, w = _setup(rng, 64, 1024, 1024)
    out = np.asarray(w8a16_matmul(x, q, s), np.float32)
    exact = np.asarray(x, np.float32) @ w
    assert np.abs(out - exact).mean() < 2e-2


def test_decode_vs_prefill_config_same_result(rng):
    """Row r of a 200-row (prefill) product equals the same row computed
    alone (decode, m=1)."""
    x, q, s, _ = _setup(rng, 200, 512, 512)
    packed = pack_weights(q)
    out_prefill = w8a16_matmul(x, packed, s)
    for r in (0, 7, 199):
        out_decode = w8a16_matmul(x[r : r + 1], packed, s)
        np.testing.assert_allclose(
            np.asarray(out_decode, np.float32)[0],
            np.asarray(out_prefill, np.float32)[r],
            rtol=1e-5,
            atol=1e-5,
        )


@pytest.mark.parametrize("activation", [None, "relu", "gelu", "silu"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_epilogues(rng, activation, with_bias):
    x, q, s, _ = _setup(rng, 32, 256, 256)
    bias = jnp.asarray(rng.standard_normal(256).astype(np.float32)) if with_bias else None
    out = w8a16_matmul(x, q, s, bias=bias, activation=activation)
    ref = w8a16_matmul_ref(x, q, s, bias=bias, activation=activation)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(ref, np.float32), rtol=2e-2, atol=2e-2
    )


@pytest.mark.parametrize("mode", ["add", "mul"])
def test_residual_epilogue(rng, mode):
    x, q, s, _ = _setup(rng, 32, 256, 256)
    res = jnp.asarray(rng.standard_normal((32, 256)).astype(np.float32))
    out = w8a16_matmul(x, q, s, activation="gelu", residual=res, residual_mode=mode)
    ref = w8a16_matmul_ref(x, q, s, activation="gelu", residual=res, residual_mode=mode)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(ref, np.float32), rtol=2e-2, atol=2e-2
    )


def test_bf16_activations(rng):
    x, q, s, w = _setup(rng, 16, 512, 512, dtype=jnp.bfloat16)
    out = w8a16_matmul(x, q, s)
    assert out.dtype == jnp.bfloat16
    exact = np.asarray(x, np.float32) @ w
    assert np.abs(np.asarray(out, np.float32) - exact).mean() < 5e-2


def test_leading_dims(rng):
    x = jnp.asarray(rng.standard_normal((2, 3, 256)).astype(np.float32))
    w = rng.standard_normal((256, 128)).astype(np.float32)
    q, s = symmetric_quantize(jnp.asarray(w))
    out = w8a16_matmul(x, q, s)
    assert out.shape == (2, 3, 128)
    flat = w8a16_matmul(x.reshape(6, 256), q, s)
    np.testing.assert_array_equal(np.asarray(out).reshape(6, 128), np.asarray(flat))


def test_3d_batched_expert_weights_vmap(rng):
    """3-D 'experts' weights work under vmap (reference's batched quantize,
    `fpA_intB_gemm_wrapper.cu:44-66`)."""
    import jax

    w = rng.standard_normal((3, 128, 64)).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((3, 8, 128)).astype(np.float32))
    q, s = symmetric_quantize(jnp.asarray(w))
    out = jax.vmap(lambda xe, qe, se: w8a16_matmul(xe, qe, se))(x, q, s)
    for e in range(3):
        ref = w8a16_matmul_ref(x[e], q[e], s[e])
        np.testing.assert_allclose(np.asarray(out[e]), np.asarray(ref), rtol=1e-5)


def test_shape_mismatch_raises(rng):
    x, q, s, _ = _setup(rng, 4, 256, 256)
    with pytest.raises(ValueError):
        w8a16_matmul(x[:, :128], q, s)


@pytest.mark.parametrize(
    "m,k,n,cfg",
    [
        (1, 256, 256, DEFAULT),    # one K split, decode batch 1
        (3, 768, 384, DEFAULT),    # uneven rows, several splits
        (MAX_M, 1024, 128, DEFAULT),  # the kernel's row limit
        (2, 1024, 512, GemvConfig(bn=64, bk=256, num_warps=4)),  # other blocks
    ],
)
def test_gemv_kernel_interpret_matches_reference(rng, m, k, n, cfg):
    """The decode GEMV kernel (Pallas, Triton route) in interpret mode vs
    the dequant-matmul oracle on bf16 activations."""
    x = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    q = jnp.asarray(rng.integers(-127, 128, (k, n)), jnp.int8)
    s = jnp.asarray(rng.random(n) * 0.01, jnp.float32)
    got = int8_gemv(x, q, s, cfg=cfg, interpret=True)
    want = np.asarray(x, np.float32) @ np.asarray(q, np.float32) * np.asarray(s)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=1e-4)


def test_gemv_splits_and_shape_checks():
    """K splits divide the K steps, stay within max_splits, and bring narrow
    llama2-7b layers towards two programs per SM; bad shapes raise."""
    bk, bn = DEFAULT.bk, DEFAULT.bn
    for k, n in [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096),
                 (4096, 32000)]:
        sp = choose_splits(k, n)
        assert (k // bk) % sp == 0 and 1 <= sp <= DEFAULT.max_splits
    wide = GemvConfig(bn=4096, bk=128, max_splits=8)
    assert choose_splits(4096, 4096, wide) == 8  # one strip: split K 8 ways
    assert choose_splits(4096, 4096) == 8  # 32 strips x 8 splits
    assert choose_splits(4096, 32000) == 2  # 250 strips x 2: 2 per SM
    assert choose_splits(4096, 32000, GemvConfig(bn=64)) == 1  # 500 strips
    x = jnp.zeros((MAX_M + 1, bk), jnp.bfloat16)
    with pytest.raises(ValueError):
        int8_gemv(x, jnp.zeros((bk, bn), jnp.int8), jnp.ones((bn,)))
    with pytest.raises(ValueError):
        int8_gemv(x[:1, :100], jnp.zeros((100, bn), jnp.int8), jnp.ones((bn,)))


def test_gemv_kernel_off_the_gpu():
    """The backend rule keeps the GEMV kernel off the CPU, whatever m is."""
    from eetq_tpu import backend

    assert not backend.use_gemv_kernel(1)
    assert not backend.use_gemv_kernel(MAX_M)


@pytest.mark.parametrize("group", [None, 128])
@pytest.mark.parametrize("m", [1, 64, 65, 1024])
def test_convert_fused_up_to_the_row_threshold(m, group):
    """The int8 -> bf16 convert stays inside the dot for at most
    FUSED_CONVERT_MAX_M rows and is materialized behind an optimization
    barrier for more, per-channel and group-wise."""
    import jax

    from eetq_tpu.ops.linear import FUSED_CONVERT_MAX_M

    k, n = 256, 128
    x = jnp.ones((m, k), jnp.bfloat16)
    q = jnp.ones((k, n), jnp.int8)
    s = jnp.ones((n,) if group is None else (k // group, n), jnp.float32)
    text = jax.jit(w8a16_matmul_ref).lower(x, q, s).as_text()
    assert ("optimization_barrier" in text) == (m > FUSED_CONVERT_MAX_M)


def test_prenorm_fusion_matches_separate(rng):
    """prenorm_gamma == rmsnorm() then matmul, bitwise, at decode and
    prefill row counts."""
    from eetq_tpu.ops import rmsnorm

    k, n = 512, 256
    x = jnp.asarray(rng.standard_normal((4, k)).astype(np.float32), jnp.bfloat16)
    w = rng.standard_normal((k, n)).astype(np.float32)
    gamma = jnp.asarray(rng.standard_normal((k,)).astype(np.float32))
    q, s = symmetric_quantize(jnp.asarray(w))
    pw = pack_weights(q)

    for rows in (4, 64):
        xr = jnp.resize(x, (rows, k))
        ref = w8a16_matmul(rmsnorm(xr, gamma, eps=1e-5), pw, s)
        got = w8a16_matmul(xr, pw, s, prenorm_gamma=gamma, prenorm_eps=1e-5)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_preallocated_output_via_donation(rng):
    """The reference exposes an in-place variant `w8_a16_gemm_` writing into
    a caller-provided buffer (`csrc/eetpy.cpp:10`). The XLA-native
    equivalent: donate the buffer through the fused-residual form
    (out = x @ W + out_buf) — XLA records an input/output alias
    (tf.aliasing_output in the lowered module) so the result lands in the
    caller's buffer with no extra allocation."""
    import functools

    import jax

    k, n, m = 256, 512, 16
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    x = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    q, s = symmetric_quantize(jnp.asarray(w))
    out_init = rng.standard_normal((m, n)).astype(np.float32)
    out_buf = jnp.asarray(out_init, jnp.bfloat16)

    @functools.partial(jax.jit, donate_argnums=(3,))
    def gemm_(x, q, s, out_buf):
        return w8a16_matmul(x, q, s, residual=out_buf)

    # the donated buffer is aliased to the output in the lowered module
    txt = gemm_.lower(x, q, s, out_buf).as_text()
    assert "tf.aliasing_output" in txt

    out = gemm_(x, q, s, out_buf)
    ref = np.asarray(x, np.float32) @ w + out_init
    assert np.abs(np.asarray(out, np.float32) - ref).max() < 0.25
