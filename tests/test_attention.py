"""KV-cache attention layer tests: prefill/decode equivalence."""

import jax.numpy as jnp
import numpy as np

from eetq_tpu.modules.attention import (
    KVCache,
    attention,
    attention_reference,
    causal_mask,
    init_kv_cache,
    update_cache,
)


def test_cache_update(rng):
    cache = init_kv_cache(2, 16, 4, 8, dtype=jnp.float32)
    k_new = jnp.asarray(rng.standard_normal((2, 3, 4, 8)).astype(np.float32))
    v_new = jnp.asarray(rng.standard_normal((2, 3, 4, 8)).astype(np.float32))
    cache = update_cache(cache, k_new, v_new, 5)
    # cache layout is [B, H, L, D]; k_new is [B, S, H, D]
    np.testing.assert_array_equal(
        np.asarray(cache.k[:, :, 5:8]), np.asarray(k_new.transpose(0, 2, 1, 3))
    )
    assert np.all(np.asarray(cache.k[:, :, :5]) == 0)
    assert np.all(np.asarray(cache.k[:, :, 8:]) == 0)


def test_prefill_then_decode_matches_full_attention(rng):
    """Greedy-decoding invariant: prefill S tokens then decode one more must
    equal full causal attention over S+1 tokens."""
    b, s, hq, hkv, d, max_len = 1, 12, 4, 2, 16, 32
    q_all = jnp.asarray(rng.standard_normal((b, s + 1, hq, d)).astype(np.float32))
    k_all = jnp.asarray(rng.standard_normal((b, s + 1, hkv, d)).astype(np.float32))
    v_all = jnp.asarray(rng.standard_normal((b, s + 1, hkv, d)).astype(np.float32))

    # Oracle: full causal attention over s+1 tokens.
    full = attention_reference(
        q_all, k_all, v_all, causal_mask(s + 1), 1.0 / d**0.5
    )

    # Framework: prefill s, then decode token s.
    cache = init_kv_cache(b, max_len, hkv, d, dtype=jnp.float32)
    out_prefill, cache = attention(
        q_all[:, :s], k_all[:, :s], v_all[:, :s], cache, 0
    )
    out_decode, cache = attention(
        q_all[:, s:], k_all[:, s:], v_all[:, s:], cache, s
    )
    np.testing.assert_allclose(
        np.asarray(out_prefill), np.asarray(full[:, :s]), rtol=1e-4, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(out_decode), np.asarray(full[:, s:]), rtol=1e-4, atol=1e-5
    )


def test_prefill_flash_path_matches_reference_path(rng):
    """The prefill entry (jax.nn.dot_product_attention) matches the
    masked-softmax oracle."""
    b, s, hq, hkv, d = 1, 130, 8, 2, 64
    q = jnp.asarray(rng.standard_normal((b, s, hq, d)).astype(np.float32))
    k = jnp.asarray(rng.standard_normal((b, s, hkv, d)).astype(np.float32))
    v = jnp.asarray(rng.standard_normal((b, s, hkv, d)).astype(np.float32))
    out, _ = attention(q, k, v, None, 0)
    out_ref = attention_reference(q, k, v, causal_mask(s), 1.0 / d**0.5)
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(out_ref), rtol=2e-2, atol=1e-2
    )


def test_decode_respects_length_mask(rng):
    """Entries beyond `length` in the cache must not affect decode output."""
    b, hq, hkv, d, max_len = 1, 4, 4, 16, 16
    cache = init_kv_cache(b, max_len, hkv, d, dtype=jnp.float32)
    k_new = jnp.asarray(rng.standard_normal((b, 5, hkv, d)).astype(np.float32))
    v_new = jnp.asarray(rng.standard_normal((b, 5, hkv, d)).astype(np.float32))
    cache = update_cache(cache, k_new, v_new, 0)
    # poison the tail
    poison = KVCache(
        k=cache.k.at[:, :, 5:].set(1e9), v=cache.v.at[:, :, 5:].set(1e9)
    )
    q = jnp.asarray(rng.standard_normal((b, 1, hq, d)).astype(np.float32))
    from eetq_tpu.modules.attention import attention_decode

    out_clean = attention_decode(q, cache, 5)
    out_poison = attention_decode(q, poison, 5)
    np.testing.assert_array_equal(np.asarray(out_clean), np.asarray(out_poison))
