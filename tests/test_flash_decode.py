"""Decode and multi-query verify attention over the KV cache vs a numpy
float32 oracle: bf16 and int8 caches, scalar and per-row lengths, GQA/MHA,
sliding window, ALiBi, length clamping (entries past `length` must not
affect output), and the verify-vs-decode bitwise guarantee."""

import math

import jax.numpy as jnp
import numpy as np
import pytest

from eetq_tpu.modules.attention import (
    KVCache,
    attention_decode,
    attention_verify,
    init_kv_cache,
)


def _oracle(q, cache, lengths, window=None, slopes=None):
    """numpy f32 attention of q [B, S, Hq, D] (query row i of batch row b
    at position lengths[b] - S + i) over the dequantized cache."""
    q = np.asarray(q, np.float32)
    b, s, hq, d = q.shape
    k = np.asarray(cache.k, np.float32)
    v = np.asarray(cache.v, np.float32)
    if cache.quantized:
        k = k * np.asarray(cache.k_scale, np.float32)[..., None]
        v = v * np.asarray(cache.v_scale, np.float32)[..., None]
    hkv, l = k.shape[1], k.shape[2]
    g = hq // hkv
    lengths = np.broadcast_to(np.asarray(lengths), (b,))
    out = np.zeros_like(q)
    j = np.arange(l)[None, :]
    for r in range(b):
        qpos = lengths[r] - s + np.arange(s)[:, None]
        mask = j <= qpos
        if window is not None:
            mask &= j > qpos - window
        for h in range(hq):
            sc = q[r, :, h] @ k[r, h // g].T / math.sqrt(d)
            if slopes is not None:
                sc = sc + float(slopes[h]) * (j - qpos)
            sc = np.where(mask, sc, -np.inf)
            p = np.exp(sc - sc.max(-1, keepdims=True))
            out[r, :, h] = (p / p.sum(-1, keepdims=True)) @ v[r, h // g]
    return out


def _decode(q, cache, lengths, window=None, slopes=None):
    """attention over the cache through the module entries: decode for
    one query row, verify for several."""
    lengths = jnp.asarray(lengths, jnp.int32)
    if q.shape[1] == 1:
        return attention_decode(q, cache, lengths, window=window,
                                slopes=slopes)
    return attention_verify(q, cache, lengths, window,
                            1.0 / math.sqrt(q.shape[-1]), slopes=slopes)


def _filled_cache(rng, b, hkv, d, max_len, n, dtype=jnp.bfloat16):
    cache = init_kv_cache(b, max_len, hkv, d, dtype=dtype)
    k = jnp.asarray(rng.standard_normal((b, n, hkv, d)).astype(np.float32),
                    jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((b, n, hkv, d)).astype(np.float32),
                    jnp.bfloat16)
    from eetq_tpu.modules.attention import update_cache

    return update_cache(cache, k, v, 0)


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.int8])
@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 4), (4, 1)])
def test_matches_oracle(rng, dtype, hq, hkv):
    b, d, max_len, n = 2, 64, 256, 100
    cache = _filled_cache(rng, b, hkv, d, max_len, n, dtype)
    q = jnp.asarray(rng.standard_normal((b, 1, hq, d)).astype(np.float32),
                    jnp.bfloat16)
    out = _decode(q, cache, n)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), _oracle(q, cache, n),
        atol=2e-2, rtol=2e-2,
    )


def test_per_row_lengths(rng):
    b, hq, hkv, d, max_len = 3, 4, 2, 32, 256
    cache = _filled_cache(rng, b, hkv, d, max_len, 200)
    q = jnp.asarray(rng.standard_normal((b, 1, hq, d)).astype(np.float32),
                    jnp.bfloat16)
    lengths = jnp.asarray([7, 130, 200], jnp.int32)
    out = _decode(q, cache, lengths)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), _oracle(q, cache, lengths),
        atol=2e-2, rtol=2e-2,
    )


def test_poison_beyond_length_ignored(rng):
    b, hq, hkv, d, max_len, n = 1, 4, 2, 32, 256, 60
    cache = _filled_cache(rng, b, hkv, d, max_len, n)
    poison = KVCache(
        k=cache.k.at[:, :, n:].set(30000.0), v=cache.v.at[:, :, n:].set(30000.0)
    )
    q = jnp.asarray(rng.standard_normal((b, 1, hq, d)).astype(np.float32),
                    jnp.bfloat16)
    out_c = _decode(q, cache, n)
    out_p = _decode(q, poison, n)
    np.testing.assert_array_equal(np.asarray(out_c), np.asarray(out_p))


def test_sliding_window(rng):
    b, hq, hkv, d, max_len, n = 1, 4, 2, 32, 256, 180
    cache = _filled_cache(rng, b, hkv, d, max_len, n)
    q = jnp.asarray(rng.standard_normal((b, 1, hq, d)).astype(np.float32),
                    jnp.bfloat16)
    out = _decode(q, cache, n, window=64)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), _oracle(q, cache, n, window=64),
        atol=2e-2, rtol=2e-2,
    )


# ---- multi-query (speculative-decode verify) mode ----


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.int8])
@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 4)])
def test_multiquery_matches_verify_oracle(rng, dtype, hq, hkv):
    b, s, d, max_len, n = 2, 5, 64, 256, 100
    cache = _filled_cache(rng, b, hkv, d, max_len, n, dtype)
    q = jnp.asarray(rng.standard_normal((b, s, hq, d)).astype(np.float32),
                    jnp.bfloat16)
    out = _decode(q, cache, n)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), _oracle(q, cache, n),
        atol=2e-2, rtol=2e-2,
    )


def test_multiquery_bitwise_vs_single_token(rng):
    """THE spec-decoding guarantee: verify row i must be BITWISE equal to a
    single-token decode call at length - S + i + 1."""
    b, s, hq, hkv, d, max_len, n = 2, 4, 4, 2, 32, 256, 100
    cache = _filled_cache(rng, b, hkv, d, max_len, n)
    q = jnp.asarray(rng.standard_normal((b, s, hq, d)).astype(np.float32),
                    jnp.bfloat16)
    out = _decode(q, cache, n)
    for i in range(s):
        single = _decode(q[:, i : i + 1], cache, n - s + i + 1)
        np.testing.assert_array_equal(
            np.asarray(out[:, i : i + 1]), np.asarray(single)
        )


def test_multiquery_per_row_lengths_window(rng):
    """Per-row lengths + sliding window: fully-masked visited blocks must
    contribute exactly nothing (the p-masking path)."""
    b, s, hq, hkv, d, max_len = 2, 4, 4, 2, 32, 256
    cache = _filled_cache(rng, b, hkv, d, max_len, 220)
    q = jnp.asarray(rng.standard_normal((b, s, hq, d)).astype(np.float32),
                    jnp.bfloat16)
    lengths = jnp.asarray([9, 220], jnp.int32)
    for window in (None, 64):
        out = _decode(q, cache, lengths, window=window)
        np.testing.assert_allclose(
            np.asarray(out, np.float32),
            _oracle(q, cache, lengths, window=window), atol=2e-2, rtol=2e-2,
        )


def test_multiquery_alibi(rng):
    from eetq_tpu.ops.alibi import alibi_slopes

    b, s, hq, hkv, d, max_len, n = 1, 3, 4, 2, 32, 256, 90
    cache = _filled_cache(rng, b, hkv, d, max_len, n)
    q = jnp.asarray(rng.standard_normal((b, s, hq, d)).astype(np.float32),
                    jnp.bfloat16)
    slopes = jnp.asarray(alibi_slopes(hq), jnp.float32)
    out = _decode(q, cache, n, slopes=slopes)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), _oracle(q, cache, n, slopes=slopes),
        atol=2e-2, rtol=2e-2,
    )
