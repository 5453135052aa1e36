"""Tests of what runs only on the card: the decode GEMV kernel compiled
through Triton, W8A16 at shapes where XLA's fused convert faulted,
verify-vs-decode agreement, and cuDNN's prefill attention. Marked `chip`; they skip
elsewhere. On the card:

    JAX_PLATFORMS=cuda python -m pytest tests/ -m chip
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.chip


@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (8, 11008, 4096)])
def test_gemv_kernel_compiled(m, k, n):
    from eetq_tpu.kernels.gemv import int8_gemv

    kx, kw, ks = jax.random.split(jax.random.PRNGKey(0), 3)
    x = jax.random.normal(kx, (m, k), jnp.bfloat16)
    q = jax.random.randint(kw, (k, n), -127, 128).astype(jnp.int8)
    s = jax.random.uniform(ks, (n,)) * 0.01
    got = np.asarray(int8_gemv(x, q, s))
    want = np.asarray(x, np.float64) @ np.asarray(q, np.float64) * np.asarray(s)
    # f32 accumulation of exact bf16 x int8 products
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_w8a16_decode_uses_the_kernel_and_matches_plain():
    """On the card a decode-row projection takes the GEMV kernel; it agrees
    with the plain XLA dot up to bf16 output rounding."""
    from eetq_tpu import backend
    from eetq_tpu.ops import w8a16_matmul
    from eetq_tpu.ops.linear import w8a16_matmul_ref
    from eetq_tpu.quant import symmetric_quantize

    assert backend.use_gemv_kernel(1)
    w = jax.random.normal(jax.random.PRNGKey(1), (4096, 12288)) * 4096**-0.5
    q, s = symmetric_quantize(w)
    x = jax.random.normal(jax.random.PRNGKey(2), (1, 4096), jnp.bfloat16)
    got = np.asarray(jax.jit(w8a16_matmul)(x, q, s), np.float32)
    want = np.asarray(w8a16_matmul_ref(x, q, s), np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("m,k,n", [(256, 4096, 12288), (500, 8192, 10240)])
def test_w8a16_prefill_finite_where_fused_convert_was_not(m, k, n):
    """Shapes at which XLA's GEMM fusion with the int8 convert inside
    returned NaN on an H100; ops.linear materializes the convert first."""
    from eetq_tpu.ops import w8a16_matmul
    from eetq_tpu.ops.linear import w8a16_matmul_ref
    from eetq_tpu.quant import symmetric_quantize

    w = jax.random.normal(jax.random.PRNGKey(4), (k, n)) * k**-0.5
    q, s = symmetric_quantize(w)
    x = jax.random.normal(jax.random.PRNGKey(5), (m, k), jnp.bfloat16)
    got = np.asarray(jax.jit(w8a16_matmul)(x, q, s), np.float32)
    assert np.isfinite(got).all()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(w8a16_matmul_ref(x.astype(jnp.float32), q, s))
    # bf16 output rounding and f32 summation order
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=2e-2)


def test_decode_projection_rows_do_not_depend_on_the_batch():
    """A decode-regime projection gives each row bit for bit the same
    result whether it runs alone (m=1) or among 8 rows (a speculative
    verify): the GEMV kernel sums every row in the same order."""
    from eetq_tpu.ops import w8a16_matmul
    from eetq_tpu.quant import symmetric_quantize

    w = jax.random.normal(jax.random.PRNGKey(8), (4096, 12288)) * 4096**-0.5
    q, s = symmetric_quantize(w)
    x = jax.random.normal(jax.random.PRNGKey(9), (8, 4096), jnp.bfloat16)
    f = jax.jit(w8a16_matmul)
    rows = np.asarray(f(x, q, s))
    for i in range(8):
        np.testing.assert_array_equal(np.asarray(f(x[i : i + 1], q, s))[0],
                                      rows[i])


def test_verify_forward_matches_sequential_decode():
    """serve.spec's verify forward over 8 tokens against the single-token
    decode step at each position: the same greedy token, and logits within
    bf16 rounding. Not bit for bit: the attention einsums (S=8 against
    S=1) and the bf16 lm_head (m=8 against m=1) reduce in shape-dependent
    orders, on the CPU as well."""
    from eetq_tpu.models import ModelConfig, init_caches, quantize_params
    from eetq_tpu.models import random_dense_params
    from eetq_tpu.serve.generate import decode_step, prefill
    from eetq_tpu.serve.spec import _verify_forward

    cfg = ModelConfig(
        vocab_size=32000, hidden_size=1024, intermediate_size=2816,
        num_layers=2, num_heads=8, num_kv_heads=8, head_dim=128,
        max_position=512,
    )
    qp = quantize_params(random_dense_params(cfg, jax.random.PRNGKey(6)))
    b, p, s = 1, 40, 8  # b * s = 8 rows: the top of the decode regime
    toks = jax.random.randint(jax.random.PRNGKey(7), (b, p + s), 1, 32000)
    _, caches = prefill(qp, cfg, toks[:, :p], init_caches(cfg, b, 256))
    start = jnp.full((b,), p, jnp.int32)
    verify, _ = jax.jit(_verify_forward, static_argnums=1)(
        qp, cfg, toks[:, p:], start, caches)
    verify = np.asarray(verify, np.float32)
    for i in range(s):
        single, caches = decode_step(qp, cfg, toks[:, p + i : p + i + 1],
                                     p + i, caches)
        single = np.asarray(single, np.float32)
        np.testing.assert_array_equal(verify[:, i].argmax(-1),
                                      single.argmax(-1))
        # bf16 activations and logits: a few rounding steps (2^-8
        # relative each) at the largest logit; a wrong position or mask
        # moves logits by O(1)
        atol = 2.0**-5 * np.abs(single).max()
        np.testing.assert_allclose(verify[:, i], single, rtol=0, atol=atol)


def test_cudnn_prefill_attention_matches_xla():
    from eetq_tpu.modules.attention import (
        attention_prefill,
        attention_reference,
        causal_mask,
    )

    q, k, v = (jax.random.normal(kk, (1, 1024, 32, 128), jnp.bfloat16)
               for kk in jax.random.split(jax.random.PRNGKey(3), 3))
    got = np.asarray(attention_prefill(q, k, v), np.float32)
    with jax.default_matmul_precision("highest"):
        want = attention_reference(
            q.astype(jnp.float32), k.astype(jnp.float32),
            v.astype(jnp.float32), causal_mask(1024), 128**-0.5,
        )
    # bf16 probabilities in the product with V, bf16 output
    np.testing.assert_allclose(got, np.asarray(want), atol=3e-2)
