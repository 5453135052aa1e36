"""int8 KV cache (opt-in): quantized-cache decode vs bf16 cache, full
generate, and the continuous-batching engine."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eetq_tpu.models import ModelConfig, init_caches, quantize_params, random_dense_params
from eetq_tpu.modules.attention import (
    _dequantize_kv,
    _quantize_kv,
    attention,
    init_kv_cache,
)
from eetq_tpu.serve.generate import greedy_generate

CFG = ModelConfig(
    vocab_size=128,
    hidden_size=64,
    intermediate_size=128,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    max_position=64,
)


def test_kv_quantize_roundtrip(rng):
    x = jnp.asarray(rng.standard_normal((2, 8, 4, 16)).astype(np.float32))
    q, s = _quantize_kv(x)
    deq = np.asarray(_dequantize_kv(q, s), np.float32)
    err = np.abs(deq - np.asarray(x))
    bound = np.asarray(s)[..., None] * 1.0 + 1e-6  # half-step + bf16 dequant
    assert (err <= bound).all()


def test_attention_with_int8_cache_close(rng):
    b, hq, hkv, d = 1, 4, 2, 16
    cache_bf = init_kv_cache(b, 32, hkv, d)
    cache_i8 = init_kv_cache(b, 32, hkv, d, dtype=jnp.int8)
    assert cache_i8.quantized and not cache_bf.quantized

    # prefill 8 tokens then one decode step on both caches
    k0 = jnp.asarray(rng.standard_normal((b, 8, hkv, d)).astype(np.float32), jnp.bfloat16)
    v0 = jnp.asarray(rng.standard_normal((b, 8, hkv, d)).astype(np.float32), jnp.bfloat16)
    q0 = jnp.asarray(rng.standard_normal((b, 8, hq, d)).astype(np.float32), jnp.bfloat16)
    _, cache_bf = attention(q0, k0, v0, cache_bf, 0)
    _, cache_i8 = attention(q0, k0, v0, cache_i8, 0)

    q1 = jnp.asarray(rng.standard_normal((b, 1, hq, d)).astype(np.float32), jnp.bfloat16)
    k1 = jnp.asarray(rng.standard_normal((b, 1, hkv, d)).astype(np.float32), jnp.bfloat16)
    o_bf, _ = attention(q1, k1, k1, cache_bf, 8)
    o_i8, _ = attention(q1, k1, k1, cache_i8, 8)
    np.testing.assert_allclose(
        np.asarray(o_bf, np.float32), np.asarray(o_i8, np.float32),
        atol=5e-2, rtol=5e-2,
    )


@pytest.fixture(scope="module")
def params():
    return quantize_params(
        random_dense_params(CFG, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    )


def test_generate_with_int8_kv(params):
    prompt = jnp.asarray([[3, 17, 42, 9]], jnp.int32)
    out_bf = np.asarray(greedy_generate(params, CFG, prompt, 8)[0])
    out_i8 = np.asarray(
        greedy_generate(params, CFG, prompt, 8, kv_dtype=jnp.int8)[0]
    )
    assert out_i8.shape == out_bf.shape
    # prefixes usually agree on this scale of model; tokens stay valid
    assert (out_i8 >= 0).all() and (out_i8 < CFG.vocab_size).all()
    assert (out_i8[:2] == out_bf[:2]).all()


def test_engine_with_int8_kv(params):
    from eetq_tpu.serve.engine import Engine

    eng = Engine(params, CFG, max_batch=2, max_len=64, prompt_buckets=(16,),
                 kv_dtype=jnp.int8)
    prompts = [[5, 6, 7], [11] * 10]
    outs = eng.generate_all(prompts, max_new_tokens=5)
    for o in outs:
        assert len(o) == 5
        assert all(0 <= t < CFG.vocab_size for t in o)


def test_init_caches_int8(params):
    caches = init_caches(CFG, 2, 32, dtype=jnp.int8)
    assert caches[0].k.dtype == jnp.int8
    # cache layout [B, H, L, D]; allocation rounded up to 128
    assert caches[0].k_scale.shape == (2, CFG.num_kv_heads, 128)
