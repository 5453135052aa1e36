"""Mixture-of-Experts: the expert-gather matmul vs the jnp oracle,
routed-MLP correctness (gather, ragged-dot and masked-scan paths), the full mixtral-family
model (prefill/decode parity, engine, checkpoints), and expert parallelism
on the virtual mesh.

The reference carries 3-D "num_experts" quantization without a runtime
(`fpA_intB_gemm_wrapper.cu:44-66`, num_experts=1 hardcoded in the runner,
`fpA_intB_gemm_template.h:475-476`); these tests cover the runtime this
repo adds on top of that parity surface.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eetq_tpu.layout import pack_weights, unpack_weights
from eetq_tpu.models import forward, init_caches, quantize_params, random_dense_params
from eetq_tpu.models.config import TOY_MOE, ModelConfig
from eetq_tpu.modules.moe import MoEMLP, moe_apply, quantize_moe, route
from eetq_tpu.ops.linear import w8a16_matmul_ref
from eetq_tpu.ops.moe import expert_matmul_ref, w8a16_expert_matmul
from eetq_tpu.quant import symmetric_quantize


def _bank(key, e, k, n, bits=8, group_size=None):
    w = jax.random.normal(key, (e, k, n), jnp.float32)
    q, s = symmetric_quantize(w, bits=bits, group_size=group_size)
    return q, pack_weights(q, bits=bits), s


def test_expert_matmul_matches_ref():
    q, pw, s = _bank(jax.random.PRNGKey(0), 4, 192, 200)
    x = jax.random.normal(jax.random.PRNGKey(1), (3, 192), jnp.bfloat16)
    eids = jnp.array([0, 2, 2, 1, 3], jnp.int32)  # with a repeat
    out = w8a16_expert_matmul(x, pw, s, eids)
    ref = expert_matmul_ref(x, q, s, eids).astype(out.dtype)
    assert out.shape == (5, 3, 200)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_expert_matmul_prefill_grid():
    # prefill-sized m: every selection sees all 130 rows
    q, pw, s = _bank(jax.random.PRNGKey(2), 3, 256, 256)
    x = jax.random.normal(jax.random.PRNGKey(3), (130, 256), jnp.bfloat16)
    eids = jnp.array([1, 0], jnp.int32)
    out = w8a16_expert_matmul(x, pw, s, eids)
    ref = expert_matmul_ref(x, q, s, eids).astype(out.dtype)
    assert out.shape == (2, 130, 256)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def test_expert_matmul_int4_groupwise():
    q, pw, s = _bank(jax.random.PRNGKey(4), 4, 192, 128, bits=4, group_size=64)
    x = jax.random.normal(jax.random.PRNGKey(5), (2, 192), jnp.bfloat16)
    eids = jnp.array([3, 1, 1], jnp.int32)
    out = w8a16_expert_matmul(x, pw, s, eids)
    ref = expert_matmul_ref(x, q, s, eids).astype(out.dtype)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))


def _manual_combine(moe, x, top_k):
    """Hand-built top-k softmax combine of per-expert dequant-MLP oracles,
    token by token. x [1, T, H] -> [T, H] f32."""
    x2 = x.reshape(-1, x.shape[-1])
    topw, topi = route(moe.router, x2, top_k)
    gu = unpack_weights(moe.gateup.qweight)
    dn = unpack_weights(moe.down.qweight)
    want = np.zeros(x2.shape, np.float32)
    for t in range(x2.shape[0]):
        for j in range(top_k):
            e = int(topi[t, j])
            g_out = w8a16_matmul_ref(
                x2[t : t + 1], gu[e], moe.gateup.scales[e]
            ).astype(x.dtype)
            gate, up = jnp.split(g_out, 2, axis=-1)
            hidden = (
                jax.nn.silu(gate.astype(jnp.float32)) * up.astype(jnp.float32)
            ).astype(x.dtype)
            d_out = w8a16_matmul_ref(hidden, dn[e], moe.down.scales[e])
            want[t] += float(topw[t, j]) * np.asarray(d_out, np.float32)[0]
    return want


def test_grouped_matmul_matches_ref():
    """Routed prefill over a per-channel int8 bank (jax.lax.ragged_dot over
    expert-sorted tokens) == the per-token combine oracle."""
    from eetq_tpu.modules.moe import moe_grouped_combine

    moe = quantize_moe(_toy_moe(jax.random.PRNGKey(0)))
    x = jax.random.normal(jax.random.PRNGKey(1), (1, 24, 64), jnp.bfloat16)
    x2 = x.reshape(24, 64)
    topw, topi = route(moe.router, x2, 2)
    got = moe_grouped_combine(moe, x2, topw, topi, "silu")
    np.testing.assert_allclose(
        np.asarray(got), _manual_combine(moe, x, 2), rtol=2e-2, atol=2e-2
    )


def test_grouped_matmul_int4_groupwise():
    """int4 banks at prefill size: per-channel int4 takes the ragged-dot
    path, group-wise int4 the masked scan; both == the combine oracle."""
    for g in (None, 32):
        moe = quantize_moe(_toy_moe(jax.random.PRNGKey(2)), bits=4,
                           group_size=g)
        x = jax.random.normal(jax.random.PRNGKey(3), (1, 20, 64), jnp.bfloat16)
        got = moe_apply(moe, x, 2)
        np.testing.assert_allclose(
            np.asarray(got, np.float32).reshape(20, 64),
            _manual_combine(moe, x, 2), rtol=3e-2, atol=3e-2,
        )


def test_moe_grouped_prefill_matches_scan():
    """The routed ragged-dot prefill matches the combine oracle — including
    zero-token experts and heavily imbalanced routing."""
    moe = quantize_moe(_toy_moe(jax.random.PRNGKey(0)))
    for seed, t in ((5, 33), (6, 64), (7, 9)):
        x = jax.random.normal(jax.random.PRNGKey(seed), (1, t, 64), jnp.bfloat16)
        got = moe_apply(moe, x, 2)
        np.testing.assert_allclose(
            np.asarray(got, np.float32).reshape(t, 64),
            _manual_combine(moe, x, 2), rtol=2e-2, atol=2e-2,
        )

    # degenerate routing: a router that sends every token to expert 0
    # and 1 (experts 2/3 get zero tokens)
    import dataclasses as dc

    from eetq_tpu.modules.linear import DenseLinear

    rw = np.zeros((64, 4), np.float32)
    rw[:, 0], rw[:, 1] = 5.0, 4.0
    skewed = dc.replace(moe, router=DenseLinear(weight=jnp.asarray(rw, jnp.bfloat16)))
    x = jax.random.normal(jax.random.PRNGKey(8), (1, 17, 64), jnp.bfloat16)
    got = moe_apply(skewed, x, 2)
    np.testing.assert_allclose(
        np.asarray(got, np.float32).reshape(17, 64),
        _manual_combine(skewed, x, 2), rtol=2e-2, atol=2e-2,
    )


def test_moe_grouped_prefill_ep_parity():
    """EP routed prefill: with k < E_local each shard takes the routed
    ragged-dot path (non-local selections parked on local expert 0 with a
    ZERO combine weight) and the caller's psum completes the cross-shard
    combine — matching the single-device grouped output."""
    from jax import shard_map
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    e, h, i, k, t = 8, 64, 96, 2, 33
    moe = quantize_moe(_toy_moe(jax.random.PRNGKey(0), e=e, h=h, i=i))
    x = jax.random.normal(jax.random.PRNGKey(9), (1, t, h), jnp.bfloat16)
    # single-device routed path (n_sel = 66 > MAX_GATHER_SELECTIONS)
    want = moe_apply(moe, x, k)

    def bank_specs(lin):
        return jax.tree.map(
            lambda a: P("model", *(None,) * (a.ndim - 1)), lin
        )

    specs = MoEMLP(
        router=jax.tree.map(lambda a: P(), moe.router),
        gateup=bank_specs(moe.gateup),
        down=bank_specs(moe.down),
    )
    # tp=2: E_local=4 > k=2 -> the routed path holds per shard
    mesh = Mesh(np.array(jax.devices()[:2]), ("model",))
    fn = shard_map(
        lambda m, xx: jax.lax.psum(
            moe_apply(m, xx, k, tp_axis="model"), "model"
        ),
        mesh=mesh, in_specs=(specs, P()), out_specs=P(), check_vma=False,
    )
    got = fn(moe, x)
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32),
        rtol=2e-2, atol=2e-2,
    )

    # tp=4: E_local=2 == k -> the gate falls back to the masked scan,
    # which must agree too
    mesh4 = Mesh(np.array(jax.devices()[:4]), ("model",))
    fn4 = shard_map(
        lambda m, xx: jax.lax.psum(
            moe_apply(m, xx, k, tp_axis="model"), "model"
        ),
        mesh=mesh4, in_specs=(specs, P()), out_specs=P(), check_vma=False,
    )
    got4 = fn4(moe, x)
    np.testing.assert_allclose(
        np.asarray(got4, np.float32), np.asarray(want, np.float32),
        rtol=2e-2, atol=2e-2,
    )


def _toy_moe(key, e=4, h=64, i=96, dtype=jnp.bfloat16) -> MoEMLP:
    k1, k2, k3 = jax.random.split(key, 3)
    from eetq_tpu.modules.linear import DenseLinear

    return MoEMLP(
        router=DenseLinear(
            weight=jax.random.normal(k1, (h, e), jnp.float32).astype(dtype)
        ),
        gateup=DenseLinear(
            weight=(jax.random.normal(k2, (e, h, 2 * i), jnp.float32) * h**-0.5
                    ).astype(dtype)
        ),
        down=DenseLinear(
            weight=(jax.random.normal(k3, (e, i, h), jnp.float32) * i**-0.5
                    ).astype(dtype)
        ),
    )


def test_moe_apply_gather_matches_scan_ref():
    moe = quantize_moe(_toy_moe(jax.random.PRNGKey(0)))
    # decode shape -> gather path
    x1 = jax.random.normal(jax.random.PRNGKey(1), (1, 1, 64), jnp.bfloat16)
    got = moe_apply(moe, x1, 2)
    np.testing.assert_allclose(
        np.asarray(got, np.float32).reshape(1, 64),
        _manual_combine(moe, x1, 2), rtol=2e-2, atol=2e-2,
    )
    # prefill shape (18 selections) -> routed ragged-dot path
    x2 = jax.random.normal(jax.random.PRNGKey(2), (1, 9, 64), jnp.bfloat16)
    got2 = moe_apply(moe, x2, 2)
    np.testing.assert_allclose(
        np.asarray(got2, np.float32).reshape(9, 64),
        _manual_combine(moe, x2, 2), rtol=2e-2, atol=2e-2,
    )


def test_moe_routing_combine_manual():
    """The routed output of a dense (unquantized) MoE layer — the masked
    scan — equals the combine of its quantized twin's oracle within
    quantization error, and the quantized layer matches exactly that
    oracle."""
    moe_d = _toy_moe(jax.random.PRNGKey(7))
    moe = quantize_moe(moe_d)
    x = jax.random.normal(jax.random.PRNGKey(8), (1, 5, 64), jnp.bfloat16)
    want = _manual_combine(moe, x, 2)
    got = np.asarray(moe_apply(moe, x, 2), np.float32)
    np.testing.assert_allclose(got.reshape(5, 64), want, rtol=2e-2, atol=2e-2)
    dense = np.asarray(moe_apply(moe_d, x, 2), np.float32)
    np.testing.assert_allclose(dense.reshape(5, 64), want, rtol=0.1, atol=0.1)


def test_moe_model_prefill_decode_parity():
    cfg = TOY_MOE
    qp = quantize_params(random_dense_params(cfg, jax.random.PRNGKey(0)))
    toks = jax.random.randint(jax.random.PRNGKey(3), (1, 8), 0, cfg.vocab_size)
    pos = jnp.arange(8)[None]
    full, _ = forward(qp, cfg, toks, pos, init_caches(cfg, 1, 32), 0)
    l7, c7 = forward(qp, cfg, toks[:, :7], pos[:, :7], init_caches(cfg, 1, 32), 0)
    l8, _ = forward(qp, cfg, toks[:, 7:], pos[:, 7:], c7, 7)
    np.testing.assert_allclose(
        np.asarray(full[:, 7]), np.asarray(l8[:, 0]), rtol=5e-2, atol=8e-2
    )
    assert int(jnp.argmax(full[:, 7])) == int(jnp.argmax(l8[:, 0]))


def test_moe_engine_matches_generate():
    from eetq_tpu.serve.engine import Engine
    from eetq_tpu.serve.generate import generate

    cfg = TOY_MOE
    qp = quantize_params(random_dense_params(cfg, jax.random.PRNGKey(0)))
    prompt = list(np.arange(10) % cfg.vocab_size)
    out = generate(qp, cfg, jnp.asarray(prompt)[None], max_new_tokens=8)
    eng = Engine(qp, cfg, max_batch=2, max_len=64)
    uid = eng.add_request(prompt, max_new_tokens=8)
    eng.run()
    assert list(np.asarray(out)[0][:8]) == list(eng.result(uid)[:8])


def test_moe_checkpoint_roundtrip():
    from eetq_tpu.models.hf import load_quantized, save_quantized

    cfg = TOY_MOE
    qp = quantize_params(random_dense_params(cfg, jax.random.PRNGKey(0)))
    with tempfile.TemporaryDirectory() as d:
        save_quantized(qp, cfg, d)
        cfg2, qp2 = load_quantized(d)
    assert cfg2.num_experts == cfg.num_experts
    assert cfg2.num_experts_per_tok == cfg.num_experts_per_tok
    m1, m2 = qp.layers[0].moe, qp2.layers[0].moe
    np.testing.assert_array_equal(
        np.asarray(unpack_weights(m1.gateup.qweight)),
        np.asarray(unpack_weights(m2.gateup.qweight)),
    )
    np.testing.assert_array_equal(
        np.asarray(unpack_weights(m1.down.qweight)),
        np.asarray(unpack_weights(m2.down.qweight)),
    )
    np.testing.assert_array_equal(
        np.asarray(m1.router.weight, np.float16),
        np.asarray(m2.router.weight, np.float16),
    )
    # fp16-rounded scales: bit-equal after the same rounding
    np.testing.assert_array_equal(
        np.asarray(m1.gateup.scales, np.float16),
        np.asarray(m2.gateup.scales, np.float16),
    )


def _write_mixtral_dir(dense, cfg, dd):
    """Write `dense` as a mixtral-named fp32 HF checkpoint directory
    (per-expert w1/w3/w2 + gate router + llama-named attention)."""
    import json
    import os

    from eetq_tpu.models.safetensors_np import save_file

    tensors = {}
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    for i, lp in enumerate(dense.layers):
        pfx = f"model.layers.{i}"
        qkv = np.asarray(lp.qkv.weight, np.float32)  # [H, (hq+2hkv)d]
        q, k, v = np.split(qkv, [hq * d, (hq + hkv) * d], axis=-1)
        tensors[f"{pfx}.self_attn.q_proj.weight"] = q.T.copy()
        tensors[f"{pfx}.self_attn.k_proj.weight"] = k.T.copy()
        tensors[f"{pfx}.self_attn.v_proj.weight"] = v.T.copy()
        tensors[f"{pfx}.self_attn.o_proj.weight"] = np.asarray(
            lp.o_proj.weight, np.float32
        ).T.copy()
        tensors[f"{pfx}.input_layernorm.weight"] = np.asarray(
            lp.input_norm, np.float32
        )
        tensors[f"{pfx}.post_attention_layernorm.weight"] = np.asarray(
            lp.post_norm, np.float32
        )
        moe = lp.moe
        tensors[f"{pfx}.block_sparse_moe.gate.weight"] = np.asarray(
            moe.router.weight, np.float32
        ).T.copy()
        gu = np.asarray(moe.gateup.weight, np.float32)  # [E, H, 2I]
        dn = np.asarray(moe.down.weight, np.float32)  # [E, I, H]
        isz = cfg.intermediate_size
        for j in range(cfg.num_experts):
            ex = f"{pfx}.block_sparse_moe.experts.{j}"
            tensors[f"{ex}.w1.weight"] = gu[j, :, :isz].T.copy()
            tensors[f"{ex}.w3.weight"] = gu[j, :, isz:].T.copy()
            tensors[f"{ex}.w2.weight"] = dn[j].T.copy()
    tensors["model.embed_tokens.weight"] = np.asarray(dense.embed, np.float32)
    tensors["model.norm.weight"] = np.asarray(dense.final_norm, np.float32)
    tensors["lm_head.weight"] = np.asarray(
        dense.lm_head.weight, np.float32
    ).T.copy()
    hf_cfg = {
        "model_type": "mixtral",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim,
        "max_position_embeddings": cfg.max_position,
        "num_local_experts": cfg.num_experts,
        "num_experts_per_tok": cfg.num_experts_per_tok,
    }
    save_file(tensors, os.path.join(dd, "model.safetensors"))
    with open(os.path.join(dd, "config.json"), "w") as f:
        json.dump(hf_cfg, f)


def test_moe_hf_fp16_checkpoint_load():
    """A mixtral-named fp16 checkpoint (per-expert w1/w3/w2 + gate router)
    loads and quantizes to the same params as quantizing the pytree
    directly (the native host quantizer is bit-identical to the JAX one)."""
    from eetq_tpu.models.hf import load_config, _source_from_dir, _build_params

    cfg = TOY_MOE
    dense = random_dense_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    with tempfile.TemporaryDirectory() as dd:
        _write_mixtral_dir(dense, cfg, dd)
        cfg2, _ = load_config(dd)
        assert cfg2.num_experts == cfg.num_experts
        src = _source_from_dir(dd)
        loaded = _build_params(src, cfg2, quantize=True, bits=8)
    want = quantize_params(dense, bits=8)
    np.testing.assert_array_equal(
        np.asarray(unpack_weights(loaded.layers[0].moe.gateup.qweight)),
        np.asarray(unpack_weights(want.layers[0].moe.gateup.qweight)),
    )
    toks = jnp.arange(6)[None] % cfg.vocab_size
    pos = jnp.arange(6)[None]
    l_a, _ = forward(loaded, cfg, toks, pos, None, 0)
    l_b, _ = forward(want, cfg, toks, pos, None, 0)
    np.testing.assert_allclose(
        np.asarray(l_a), np.asarray(l_b), rtol=2e-2, atol=2e-2
    )


def test_mixtral_public_api_end_to_end():
    """The full public workflow on the MoE family —
    AutoEETQForCausalLM.from_pretrained(mixtral_dir) -> quantize(save_dir)
    -> from_quantized -> Engine.add_request -> tokens, all through public
    symbols (reference: one registry dispatches every supported family,
    `python/eetq/models/auto.py:6-32`)."""
    import os

    from eetq_tpu import AutoEETQForCausalLM
    from eetq_tpu.serve.engine import Engine

    cfg = TOY_MOE
    dense = random_dense_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    with tempfile.TemporaryDirectory() as dd:
        _write_mixtral_dir(dense, cfg, dd)
        model = AutoEETQForCausalLM.from_pretrained(dd)
        assert model.cfg.model_type == "mixtral"
        assert model.cfg.num_experts == cfg.num_experts
        assert not model.quantized

        qdir = os.path.join(dd, "quantized")
        model.quantize(qdir)  # eet_quantize walk: MoEMLP banks, bf16 router
        assert model.quantized
        from eetq_tpu.modules.linear import DenseLinear as DL

        assert isinstance(model.params.layers[0].moe.router, DL)

        served = AutoEETQForCausalLM.from_quantized(qdir)
        assert served.quantized
        # roundtrip is bit-exact on the integer weights
        np.testing.assert_array_equal(
            np.asarray(unpack_weights(model.params.layers[0].moe.gateup.qweight)),
            np.asarray(unpack_weights(served.params.layers[0].moe.gateup.qweight)),
        )

        prompt = list(np.arange(10) % cfg.vocab_size)
        want = served.generate(jnp.asarray(prompt)[None], max_new_tokens=8)
        eng = Engine(served.params, served.cfg, max_batch=2, max_len=64)
        uid = eng.add_request(prompt, max_new_tokens=8)
        eng.run()
        assert list(np.asarray(want)[0][:8]) == list(eng.result(uid)[:8])


def test_moe_sharded_ep_parity():
    """Expert parallelism: tp=2 shard_map forward (2 experts per device,
    attention head-split on the same axis) matches single-device."""
    from eetq_tpu.dist.sharding import make_forward_fn, make_mesh, shard_model

    cfg = TOY_MOE
    dense = random_dense_params(cfg, jax.random.PRNGKey(0))
    qp = quantize_params(dense, bits=8)
    toks = jax.random.randint(jax.random.PRNGKey(3), (2, 8), 0, cfg.vocab_size)
    pos = jnp.broadcast_to(jnp.arange(8)[None], (2, 8))
    ref, _ = forward(qp, cfg, toks, pos, init_caches(cfg, 2, 32), 0)

    mesh = make_mesh(tp=2)
    sm = shard_model(dense, cfg, mesh, quantize=True, bits=8)
    fwd = make_forward_fn(sm)
    sh, _ = fwd(sm.params, toks, pos, init_caches(cfg, 2, 32), jnp.int32(0))
    np.testing.assert_allclose(
        np.asarray(ref), np.asarray(sh), rtol=5e-2, atol=8e-2
    )
    assert np.array_equal(
        np.argmax(np.asarray(ref)[:, -1], -1), np.argmax(np.asarray(sh)[:, -1], -1)
    )
