"""Paged KV cache: pool + block-table primitives and the paged decode
path must reproduce the dense cache exactly — including with physical
blocks deliberately scattered/permuted through the pool (the whole point)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eetq_tpu.modules.attention import (
    KVCache,
    attention_decode_ref,
    init_kv_cache,
    update_cache,
)
from eetq_tpu.modules.paged import (
    PagedKVCache,
    init_paged_kv_cache,
    paged_attention_decode,
    paged_gather_dense,
    paged_insert_dense,
    paged_write,
)

B, HKV, D, BS = 2, 4, 32, 128
HQ = 8


def _mk_paged(num_blocks=16, max_blocks=4, dtype=jnp.bfloat16):
    return init_paged_kv_cache(num_blocks, BS, HKV, D, B, max_blocks, dtype)


def _rand_kv(rng, b, s):
    k = jnp.asarray(rng.standard_normal((b, s, HKV, D)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((b, s, HKV, D)), jnp.bfloat16)
    return k, v


def _scattered_tables(rng, num_blocks, max_blocks):
    """Distinct, deliberately shuffled physical blocks per row."""
    perm = rng.permutation(num_blocks)[: B * max_blocks]
    return jnp.asarray(perm.reshape(B, max_blocks), jnp.int32)


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.int8])
def test_insert_gather_roundtrip(dtype):
    rng = np.random.default_rng(0)
    s = 2 * BS
    k, v = _rand_kv(rng, 1, s)
    dense = update_cache(
        init_kv_cache(1, s, HKV, D, dtype=dtype), k, v, jnp.int32(0)
    )
    cache = _mk_paged(dtype=dtype)
    cache = cache.__class__(
        **{**cache.__dict__, "table": _scattered_tables(rng, 16, 4)}
    )
    blocks = cache.table[0, :2]
    cache = paged_insert_dense(cache, dense, jnp.int32(0), blocks, 2)
    out = paged_gather_dense(cache, 2 * BS)
    np.testing.assert_array_equal(
        np.asarray(out.k[0, :, :s]), np.asarray(dense.k[0, :, :s])
    )
    np.testing.assert_array_equal(
        np.asarray(out.v[0, :, :s]), np.asarray(dense.v[0, :, :s])
    )
    if dtype == jnp.int8:
        np.testing.assert_array_equal(
            np.asarray(out.k_scale[0, :, :s]),
            np.asarray(dense.k_scale[0, :, :s]),
        )


def test_paged_write_matches_dense():
    rng = np.random.default_rng(1)
    cache = _mk_paged()
    cache = PagedKVCache(
        k=cache.k, v=cache.v, table=_scattered_tables(rng, 16, 4)
    )
    dense = init_kv_cache(B, 4 * BS, HKV, D)
    lengths = np.array([BS + 3, 2 * BS], np.int32)  # second row at a block edge
    for step in range(3):
        k, v = _rand_kv(rng, B, 1)
        pos = jnp.asarray(lengths + step, jnp.int32)
        cache = paged_write(cache, k, v, pos)
        dense = update_cache(dense, k, v, pos)
    out = paged_gather_dense(cache, 4 * BS)
    for b in range(B):
        for step in range(3):
            p = int(lengths[b]) + step
            np.testing.assert_array_equal(
                np.asarray(out.k[b, :, p]), np.asarray(dense.k[b, :, p])
            )
            np.testing.assert_array_equal(
                np.asarray(out.v[b, :, p]), np.asarray(dense.v[b, :, p])
            )


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.int8])
@pytest.mark.parametrize("window", [None, 40])
def test_paged_decode_matches_dense(dtype, window):
    """Paged attention == dense attention over the same logical sequence,
    with pool blocks permuted, with and without a sliding window."""
    rng = np.random.default_rng(2)
    s_full = 4 * BS
    k, v = _rand_kv(rng, B, s_full)
    dense = update_cache(
        init_kv_cache(B, s_full, HKV, D, dtype=dtype), k, v, jnp.int32(0)
    )
    cache = _mk_paged(num_blocks=32, max_blocks=4, dtype=dtype)
    table = _scattered_tables(rng, 32, 4)
    cache = PagedKVCache(
        k=cache.k, v=cache.v, table=table,
        k_scale=cache.k_scale, v_scale=cache.v_scale,
    )
    for b in range(B):
        cache = paged_insert_dense(cache, dense, jnp.int32(b), table[b], 4)
    q = jnp.asarray(rng.standard_normal((B, 1, HQ, D)), jnp.bfloat16)
    lengths = jnp.asarray([3 * BS + 17, 2 * BS], jnp.int32)
    got = paged_attention_decode(q, cache, lengths, window=window)
    want = attention_decode_ref(
        q, dense, lengths, window, 1.0 / math.sqrt(D)
    )
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), atol=3e-2
    )


# ---- engine integration ----


def test_engine_paged_matches_dense():
    """Paged engine == dense engine == greedy_generate, across slot
    recycling (blocks freed and reallocated) and mixed lengths."""
    from eetq_tpu.models import ModelConfig, quantize_params, random_dense_params
    from eetq_tpu.serve.engine import Engine
    from eetq_tpu.serve.generate import greedy_generate

    cfg = ModelConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=16, max_position=512,
    )
    params = quantize_params(
        random_dense_params(cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    )
    rng = np.random.default_rng(0)
    prompts = [
        list(rng.integers(1, cfg.vocab_size, size=rng.integers(2, 20)))
        for _ in range(6)
    ]
    # pool sized for ~2 concurrent sequences + trash: forces recycling
    eng = Engine(params, cfg, max_batch=2, max_len=256,
                 prompt_buckets=(32,), paged_blocks=7, paged_block_size=128)
    uids = [eng.add_request(p, 6) for p in prompts]
    eng.run()
    for uid, p in zip(uids, prompts):
        ref = [int(t) for t in np.asarray(
            greedy_generate(params, cfg,
                            jnp.asarray(np.asarray(p, np.int32)[None]), 6)[0]
        )]
        assert eng.result(uid) == ref, (p, eng.result(uid), ref)


def test_engine_paged_multiblock_growth():
    """A sequence crossing block boundaries during decode allocates new
    blocks on the fly and still matches greedy."""
    from eetq_tpu.models import ModelConfig, quantize_params, random_dense_params
    from eetq_tpu.serve.engine import Engine
    from eetq_tpu.serve.generate import greedy_generate

    cfg = ModelConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=16, max_position=1024,
    )
    params = quantize_params(
        random_dense_params(cfg, jax.random.PRNGKey(1), dtype=jnp.bfloat16)
    )
    rng = np.random.default_rng(1)
    prompt = list(rng.integers(1, cfg.vocab_size, size=120))
    eng = Engine(params, cfg, max_batch=1, max_len=512,
                 prompt_buckets=(128,), paged_blocks=6, paged_block_size=128,
                 decode_window=4)
    uid = eng.add_request(prompt, 16)  # 120 + 16 crosses the 128 boundary
    eng.run()
    ref = [int(t) for t in np.asarray(
        greedy_generate(params, cfg,
                        jnp.asarray(np.asarray(prompt, np.int32)[None]), 16)[0]
    )]
    assert eng.result(uid) == ref


def test_engine_paged_pool_exhaustion():
    from eetq_tpu.models import ModelConfig, quantize_params, random_dense_params
    from eetq_tpu.serve.engine import Engine

    cfg = ModelConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=16, max_position=2048,
    )
    params = quantize_params(
        random_dense_params(cfg, jax.random.PRNGKey(2), dtype=jnp.bfloat16)
    )
    eng = Engine(params, cfg, max_batch=2, max_len=1024,
                 prompt_buckets=(256,), paged_blocks=3, paged_block_size=128)
    eng.add_request(list(range(1, 100)), 600)  # needs ~6 blocks; pool has 2
    with pytest.raises(RuntimeError, match="pool exhausted"):
        eng.run()
