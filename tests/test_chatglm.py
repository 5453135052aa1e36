"""ChatGLM2/3 family support (the reference's WIP ChatGLMFuser,
`/root/reference/python/eetq/models/chatglm.py:41-83`): loading the
chatglm HF weight layout (fused query_key_value with MQA-sized k/v, fused
dense_h_to_4h swiglu, transformer.encoder.* naming), partial INTERLEAVED
rotary, quantized checkpoint roundtrip, and TP resharding of the MQA qkv.

Parity oracle: a from-scratch numpy implementation of the chatglm block
(independent of eetq_tpu code paths)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eetq_tpu.models.config import ModelConfig
from eetq_tpu.models.hf import load_hf_dense, load_quantized, save_quantized
from eetq_tpu.models.transformer import forward
from eetq_tpu.ops.rope import make_cos_sin_cache, rope

H, FFN, L, NH, G, D = 64, 96, 2, 4, 2, 16  # hidden, ffn, layers, q-heads, kv-groups, head_dim
VOCAB, MAXPOS = 96, 64

CFG = ModelConfig(
    vocab_size=VOCAB, hidden_size=H, intermediate_size=FFN, num_layers=L,
    num_heads=NH, num_kv_heads=G, head_dim=D, max_position=MAXPOS,
    rope_dim=D // 2, rope_interleaved=True, qkv_bias=True,
    model_type="chatglm",
)

GLM_HF_CONFIG = {
    "model_type": "chatglm",
    "padded_vocab_size": VOCAB,
    "hidden_size": H,
    "ffn_hidden_size": FFN,
    "num_layers": L,
    "num_attention_heads": NH,
    "multi_query_attention": True,
    "multi_query_group_num": G,
    "kv_channels": D,
    "seq_length": MAXPOS,
    "layernorm_epsilon": 1e-5,
    "add_qkv_bias": True,
}


@pytest.fixture(scope="module")
def glm_weights():
    rng = np.random.default_rng(0)

    def w(*shape):
        # fp16-representable values (real HF checkpoints ship fp16/bf16;
        # save_quantized stores norms/biases at fp16, so fp16-exact inputs
        # make the roundtrip test bit-exact)
        arr = (rng.standard_normal(shape) * 0.05).astype(np.float16)
        return arr.astype(np.float32)

    def norm_w(n):
        return (1.0 + 0.1 * w(n)).astype(np.float16).astype(np.float32)

    layers = []
    for _ in range(L):
        layers.append(dict(
            input_norm=norm_w(H),
            qkv_w=w((NH + 2 * G) * D, H),   # torch [out, in], rows q|k|v
            qkv_b=w((NH + 2 * G) * D),
            o_w=w(H, NH * D),
            post_norm=norm_w(H),
            gateup_w=w(2 * FFN, H),         # dense_h_to_4h, rows gate|up
            down_w=w(H, FFN),
        ))
    return dict(
        embed=w(VOCAB, H),
        layers=layers,
        final_norm=norm_w(H),
        lm_head=w(VOCAB, H),                # output_layer
    )


@pytest.fixture(scope="module")
def glm_dir(glm_weights, tmp_path_factory):
    """A fake chatglm3 HF checkpoint directory (safetensors + config)."""
    from eetq_tpu.models.safetensors_np import save_file

    d = tmp_path_factory.mktemp("hf_chatglm")
    tensors = {
        "transformer.embedding.word_embeddings.weight": glm_weights["embed"],
        "transformer.encoder.final_layernorm.weight": glm_weights["final_norm"],
        "transformer.output_layer.weight": glm_weights["lm_head"],
    }
    for i, lw in enumerate(glm_weights["layers"]):
        p = f"transformer.encoder.layers.{i}"
        tensors[f"{p}.input_layernorm.weight"] = lw["input_norm"]
        tensors[f"{p}.self_attention.query_key_value.weight"] = lw["qkv_w"]
        tensors[f"{p}.self_attention.query_key_value.bias"] = lw["qkv_b"]
        tensors[f"{p}.self_attention.dense.weight"] = lw["o_w"]
        tensors[f"{p}.post_attention_layernorm.weight"] = lw["post_norm"]
        tensors[f"{p}.mlp.dense_h_to_4h.weight"] = lw["gateup_w"]
        tensors[f"{p}.mlp.dense_4h_to_h.weight"] = lw["down_w"]
    save_file(tensors, os.path.join(str(d), "model.safetensors"))
    with open(os.path.join(str(d), "config.json"), "w") as f:
        json.dump(GLM_HF_CONFIG, f)
    return str(d)


# ---- independent numpy oracle ----


def _np_rmsnorm(x, gamma, eps=1e-5):
    return x / np.sqrt(np.mean(x * x, -1, keepdims=True) + eps) * gamma


def _np_glm_rotary(x, positions):
    """ChatGLM2/3 rotary: adjacent-lane pairs over the FIRST HALF of
    head_dim, theta over n_elem = head_dim // 2 (the partial rotary the
    upstream modeling_chatglm.apply_rotary_pos_emb performs)."""
    s, nh, d = x.shape
    rot = d // 2
    half = rot // 2
    inv = 1.0 / (10000.0 ** (np.arange(0, rot, 2) / rot))  # [half]
    ang = positions[:, None] * inv[None, :]                # [s, half]
    cos, sin = np.cos(ang), np.sin(ang)
    out = x.copy()
    x1 = x[..., 0:rot:2]
    x2 = x[..., 1:rot:2]
    out[..., 0:rot:2] = x1 * cos[:, None, :] - x2 * sin[:, None, :]
    out[..., 1:rot:2] = x2 * cos[:, None, :] + x1 * sin[:, None, :]
    return out


def _np_glm_forward(weights, tokens):
    x = weights["embed"][tokens]  # [s, H]
    s = x.shape[0]
    positions = np.arange(s)
    for lw in weights["layers"]:
        h = _np_rmsnorm(x, lw["input_norm"])
        qkv = h @ lw["qkv_w"].T + lw["qkv_b"]
        q = qkv[:, : NH * D].reshape(s, NH, D)
        k = qkv[:, NH * D : (NH + G) * D].reshape(s, G, D)
        v = qkv[:, (NH + G) * D :].reshape(s, G, D)
        q = _np_glm_rotary(q, positions)
        k = _np_glm_rotary(k, positions)
        # GQA expansion: each kv group serves NH // G q heads
        rep = NH // G
        k_full = np.repeat(k, rep, axis=1)
        v_full = np.repeat(v, rep, axis=1)
        scores = np.einsum("shd,thd->hst", q, k_full) / np.sqrt(D)
        mask = np.tril(np.ones((s, s), bool))
        scores = np.where(mask[None], scores, -np.inf)
        p = np.exp(scores - scores.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        attn = np.einsum("hst,thd->shd", p, v_full).reshape(s, NH * D)
        x = x + attn @ lw["o_w"].T
        h = _np_rmsnorm(x, lw["post_norm"])
        gu = h @ lw["gateup_w"].T
        gate, up = gu[:, :FFN], gu[:, FFN:]
        silu = gate / (1.0 + np.exp(-gate))
        x = x + (silu * up) @ lw["down_w"].T
    x = _np_rmsnorm(x, weights["final_norm"])
    return x @ weights["lm_head"].T


def test_interleaved_rope_unit():
    """rope(interleaved=True) == manual pairwise rotation (partial dim)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 5, 3, D)).astype(np.float32)
    positions = np.arange(5, dtype=np.int32)[None]
    cache = make_cos_sin_cache(16, D // 2)
    got = np.asarray(
        rope(jnp.asarray(x), jnp.asarray(positions), cache, interleaved=True)
    )
    want = _np_glm_rotary(x[0], positions[0])[None]
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_config_from_hf():
    cfg = ModelConfig.from_hf_config(GLM_HF_CONFIG)
    assert cfg == CFG


def test_forward_parity_vs_numpy_oracle(glm_dir):
    cfg, params = load_hf_dense(glm_dir, dtype=jnp.float32)
    assert cfg == CFG
    rng = np.random.default_rng(2)
    toks = rng.integers(0, VOCAB, size=12)
    ref = _np_glm_forward_weights(glm_dir, toks)
    tokens = jnp.asarray(toks, jnp.int32)[None]
    pos = jnp.arange(12, dtype=jnp.int32)[None]
    logits, _ = forward(params, cfg, tokens, pos, None, 0)
    ours = np.asarray(logits)[0]
    np.testing.assert_allclose(ours, ref, rtol=2e-2, atol=2e-2)
    assert (ours.argmax(-1) == ref.argmax(-1)).mean() > 0.9


def _np_glm_forward_weights(glm_dir, toks):
    # reload the weights from the checkpoint so the oracle sees exactly
    # what the loader saw
    from eetq_tpu.models.safetensors_np import load_file

    t = load_file(os.path.join(glm_dir, "model.safetensors"))
    weights = dict(
        embed=t["transformer.embedding.word_embeddings.weight"],
        final_norm=t["transformer.encoder.final_layernorm.weight"],
        lm_head=t["transformer.output_layer.weight"],
        layers=[
            dict(
                input_norm=t[f"transformer.encoder.layers.{i}.input_layernorm.weight"],
                qkv_w=t[f"transformer.encoder.layers.{i}.self_attention.query_key_value.weight"],
                qkv_b=t[f"transformer.encoder.layers.{i}.self_attention.query_key_value.bias"],
                o_w=t[f"transformer.encoder.layers.{i}.self_attention.dense.weight"],
                post_norm=t[f"transformer.encoder.layers.{i}.post_attention_layernorm.weight"],
                gateup_w=t[f"transformer.encoder.layers.{i}.mlp.dense_h_to_4h.weight"],
                down_w=t[f"transformer.encoder.layers.{i}.mlp.dense_4h_to_h.weight"],
            )
            for i in range(L)
        ],
    )
    return _np_glm_forward(weights, toks)


def test_quantized_roundtrip_bit_exact(glm_dir, tmp_path):
    """quantize -> save_quantized (chatglm names) -> load_quantized."""
    from eetq_tpu.models.auto import AutoEETQForCausalLM

    model = AutoEETQForCausalLM.from_pretrained(glm_dir, quantize=True)
    save_dir = str(tmp_path / "glm_q")
    model.save_quantized(save_dir)
    # saved tensors keep the chatglm naming (fused, transformer.encoder.*)
    from eetq_tpu.models.safetensors_np import safe_open

    st = [f for f in os.listdir(save_dir) if f.endswith(".safetensors")][0]
    with safe_open(os.path.join(save_dir, st)) as h:
        names = set(h.keys())
    assert "transformer.encoder.layers.0.self_attention.query_key_value.weight" in names
    assert "transformer.encoder.layers.0.mlp.dense_h_to_4h.weight" in names
    assert "transformer.output_layer.weight" in names

    model2 = AutoEETQForCausalLM.from_quantized(save_dir)
    rng = np.random.default_rng(3)
    tokens = jnp.asarray(rng.integers(0, VOCAB, (1, 8)), jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(8, dtype=jnp.int32), (1, 8))
    l1, _ = model.forward(tokens, pos)
    l2, _ = model2.forward(tokens, pos)
    np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2))


def test_generate_and_engine(glm_dir):
    """End-to-end decode through generate() and the serving engine."""
    from eetq_tpu.models.auto import AutoEETQForCausalLM
    from eetq_tpu.serve.engine import Engine
    from eetq_tpu.serve.generate import greedy_generate

    model = AutoEETQForCausalLM.from_pretrained(glm_dir, quantize=True)
    prompt = [5, 6, 7, 8]
    out = model.generate(jnp.asarray(prompt)[None], max_new_tokens=6)
    assert out.shape == (1, 6)
    ref = [int(t) for t in
           greedy_generate(model.params, model.cfg, jnp.asarray(prompt)[None], 6)[0]]
    eng = Engine(model.params, model.cfg, max_batch=2, max_len=32,
                 prompt_buckets=(8,))
    uid = eng.add_request(prompt, 6)
    eng.run()
    assert eng.result(uid) == ref


def test_tp_qkv_split_mqa(glm_weights):
    """TP column split of the chatglm fused MQA qkv (the reference
    ChatGLMFuser's split_tp_column on query_key_value,
    `chatglm.py:46-51`): tp=2 gives each shard its own 2 q heads + 1 kv
    group, GQA/MQA co-located."""
    from eetq_tpu.dist.sharding import split_qkv_columns

    w = jnp.asarray(glm_weights["layers"][0]["qkv_w"].T)  # [K, (NH+2G)*D]
    shards = split_qkv_columns(w, CFG, 2)
    assert [s.shape[-1] for s in shards] == [(NH // 2 + 2 * (G // 2)) * D] * 2
    # shard 0: q heads 0..1, k group 0, v group 0
    want = np.concatenate(
        [
            np.asarray(w[..., : (NH // 2) * D]),
            np.asarray(w[..., NH * D : NH * D + (G // 2) * D]),
            np.asarray(w[..., (NH + G) * D : (NH + G) * D + (G // 2) * D]),
        ],
        axis=-1,
    )
    np.testing.assert_array_equal(np.asarray(shards[0]), want)


def test_sharded_model_parity_tp2(glm_dir):
    """Runtime TP over a 2-device mesh reproduces the single-device logits
    for the chatglm architecture (MQA head split + interleaved rope inside
    shard_map)."""
    from eetq_tpu.dist import make_mesh, shard_model
    from eetq_tpu.dist.sharding import make_forward_fn
    from eetq_tpu.models.auto import AutoEETQForCausalLM
    from eetq_tpu.models.transformer import init_caches

    model = AutoEETQForCausalLM.from_pretrained(glm_dir, quantize=False)
    mesh = make_mesh(tp=2, devices=jax.devices()[:2])
    sharded = shard_model(model.params, model.cfg, mesh, quantize=True)
    fwd = make_forward_fn(sharded)

    toks = jnp.asarray([[4, 9, 2, 7]], jnp.int32)
    pos = jnp.arange(4, dtype=jnp.int32)[None]
    caches = init_caches(model.cfg, 1, 16)
    logits_tp, _ = fwd(sharded.params, toks, pos, caches, jnp.int32(0))

    from eetq_tpu.models import quantize_params
    from eetq_tpu.models.transformer import forward

    qp = quantize_params(model.params)
    caches = init_caches(model.cfg, 1, 16)
    logits_1, _ = forward(qp, model.cfg, toks, pos, caches, jnp.int32(0))
    np.testing.assert_allclose(
        np.asarray(logits_tp), np.asarray(logits_1), atol=3e-2, rtol=3e-2
    )
