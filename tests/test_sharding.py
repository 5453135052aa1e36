"""Tensor-parallel correctness on the 8-device virtual CPU mesh: the sharded
shard_map forward must match the single-device forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eetq_tpu.dist import (
    make_mesh,
    shard_model,
    split_gateup_columns,
    split_qkv_columns,
    split_rows,
)
from eetq_tpu.dist.sharding import make_forward_fn
from eetq_tpu.models import (
    ModelConfig,
    forward,
    init_caches,
    quantize_params,
    random_dense_params,
)
from eetq_tpu.quant import symmetric_quantize

CFG = ModelConfig(
    vocab_size=256,
    hidden_size=64,
    intermediate_size=128,
    num_layers=2,
    num_heads=8,
    num_kv_heads=4,
    head_dim=16,
    max_position=32,
)


@pytest.fixture(scope="module")
def dense_params():
    return random_dense_params(CFG, jax.random.PRNGKey(0), dtype=jnp.float32)


def _tokens(rng, b, s):
    return jnp.asarray(rng.integers(0, CFG.vocab_size, (b, s)), jnp.int32)


def test_qkv_split_reassembles(rng, dense_params):
    w = dense_params.layers[0].qkv.weight
    shards = split_qkv_columns(w, CFG, 4)
    assert all(s.shape == (64, w.shape[1] // 4) for s in shards)
    # Reassembling per-projection must recover the original.
    hq, hkv, d = CFG.num_heads, CFG.num_kv_heads, CFG.head_dim
    hq_l, hkv_l = hq // 4, hkv // 4
    qs = jnp.concatenate([s[:, : hq_l * d] for s in shards], -1)
    ks = jnp.concatenate([s[:, hq_l * d : (hq_l + hkv_l) * d] for s in shards], -1)
    vs = jnp.concatenate([s[:, (hq_l + hkv_l) * d :] for s in shards], -1)
    np.testing.assert_array_equal(
        np.asarray(jnp.concatenate([qs, ks, vs], -1)), np.asarray(w)
    )


def test_column_split_scales_exact(rng, dense_params):
    """Quantizing a column shard independently == slicing the globally
    quantized weight + scales (scale-exact fusion/splitting — SURVEY.md
    hard part #2)."""
    w = dense_params.layers[0].gateup.weight
    q_global, s_global = symmetric_quantize(w)
    shards = split_gateup_columns(w, 4)
    q_shard, s_shard = symmetric_quantize(shards[1])
    q_slice = split_gateup_columns(q_global.astype(jnp.int8), 4)[1]
    s_slice = split_gateup_columns(s_global[None, :], 4)[1][0]
    np.testing.assert_array_equal(np.asarray(q_shard), np.asarray(q_slice))
    np.testing.assert_allclose(np.asarray(s_shard), np.asarray(s_slice), rtol=1e-7)


def test_row_split_covers(dense_params):
    w = dense_params.layers[0].down.weight
    shards = split_rows(w, 4)
    np.testing.assert_array_equal(
        np.asarray(jnp.concatenate(shards, axis=0)), np.asarray(w)
    )


def test_tp_must_divide_heads(dense_params):
    mesh = make_mesh(tp=8, dp=1)
    with pytest.raises(ValueError):
        shard_model(dense_params, CFG, mesh)  # 4 kv heads, tp=8


def test_mha_tp8(rng):
    import dataclasses

    cfg = dataclasses.replace(CFG, num_kv_heads=8)
    params = random_dense_params(cfg, jax.random.PRNGKey(3), dtype=jnp.float32)
    mesh = make_mesh(tp=8, dp=1)
    model = shard_model(params, cfg, mesh, quantize=False)
    fwd = make_forward_fn(model)
    tokens = _tokens(rng, 1, 4)
    pos = jnp.broadcast_to(jnp.arange(4, dtype=jnp.int32), (1, 4))
    caches = init_caches(cfg, 1, 8, dtype=jnp.float32)
    logits_sh, _ = fwd(model.params, tokens, pos, caches, jnp.int32(0))
    logits_1d, _ = forward(params, cfg, tokens, pos, None, 0)
    ls, l1 = np.asarray(logits_sh), np.asarray(logits_1d)
    np.testing.assert_allclose(ls, l1, rtol=5e-2, atol=8e-2)


@pytest.mark.parametrize("tp,dp", [(4, 2), (2, 4), (2, 1)])
def test_sharded_dense_forward_matches_single(rng, dense_params, tp, dp):
    """TP plumbing exactness: unquantized sharded forward == single-device
    forward (up to f32 reduction order)."""
    mesh = make_mesh(tp=tp, dp=dp)
    model = shard_model(dense_params, CFG, mesh, quantize=False)
    fwd = make_forward_fn(model)

    b, s = 4, 8  # batch divisible by every dp under test
    tokens = _tokens(rng, b, s)
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
    caches = init_caches(CFG, b, 16, dtype=jnp.float32)

    logits_sh, caches_sh = fwd(model.params, tokens, pos, caches, jnp.int32(0))
    logits_1d, _ = forward(dense_params, CFG, tokens, pos, None, 0)
    # Activations are bf16; the TP path all-reduces bf16 partials (standard
    # Megatron practice) while single-device accumulates full-K in f32, so
    # agreement is at bf16 granularity.
    ls, l1 = np.asarray(logits_sh), np.asarray(logits_1d)
    np.testing.assert_allclose(ls, l1, rtol=5e-2, atol=8e-2)
    assert (ls.argmax(-1) == l1.argmax(-1)).mean() > 0.95


def test_sharded_quantized_forward_close(rng, dense_params):
    """Quantized TP forward ~= quantized single-device forward. Not exact:
    row-parallel shards are quantized per-shard (tighter scales)."""
    mesh = make_mesh(tp=4, dp=1)
    model = shard_model(dense_params, CFG, mesh, quantize=True)
    fwd = make_forward_fn(model)

    b, s = 1, 8
    tokens = _tokens(rng, b, s)
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
    caches = init_caches(CFG, b, 16, dtype=jnp.float32)
    logits_sh, _ = fwd(model.params, tokens, pos, caches, jnp.int32(0))

    qp = quantize_params(dense_params)
    logits_q, _ = forward(qp, CFG, tokens, pos, None, 0)
    ls, lq = np.asarray(logits_sh), np.asarray(logits_q)
    assert (ls.argmax(-1) == lq.argmax(-1)).mean() > 0.9
    assert np.abs(ls - lq).mean() < 0.1


def test_sharded_decode_step(rng, dense_params):
    """Prefill + decode through the sharded forward stays consistent with
    the single-device path."""
    mesh = make_mesh(tp=4, dp=1)
    model = shard_model(dense_params, CFG, mesh, quantize=False)
    fwd = make_forward_fn(model)

    b, s = 1, 6
    tokens = _tokens(rng, b, s + 1)
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
    caches = init_caches(CFG, b, 16, dtype=jnp.float32)
    _, caches = fwd(model.params, tokens[:, :s], pos, caches, jnp.int32(0))
    logits_step, _ = fwd(
        model.params,
        tokens[:, s : s + 1],
        jnp.full((b, 1), s, jnp.int32),
        caches,
        jnp.int32(s),
    )

    full_pos = jnp.broadcast_to(jnp.arange(s + 1, dtype=jnp.int32), (b, s + 1))
    logits_full, _ = forward(
        dense_params, CFG, tokens, full_pos, None, 0
    )
    np.testing.assert_allclose(
        np.asarray(logits_step[:, 0]),
        np.asarray(logits_full[:, -1]),
        rtol=5e-2,
        atol=8e-2,
    )


def test_multihost_mesh_single_process():
    """make_hybrid_mesh degenerates to a plain (dp, tp) mesh in-process."""
    import jax
    import pytest

    from eetq_tpu.dist import multihost

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    multihost.initialize()  # no-op single-process
    mesh = multihost.make_hybrid_mesh(tp=4, dp=2)
    assert mesh.shape == {"data": 2, "model": 4}
    with pytest.raises(ValueError):
        multihost.make_hybrid_mesh(tp=3, dp=3)
