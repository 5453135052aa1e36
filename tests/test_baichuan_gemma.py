"""Baichuan + Gemma HF-interop roundtrips: the W_pack
fused-qkv load path (`models/hf.py` baichuan scheme, reference
`python/eetq/models/baichuan.py:31-78`) and the gemma load path (tied
embeddings, gelu_pytorch_tanh, unit-offset rmsnorm, sqrt(H) embedding
multiplier, reference `python/eetq/models/gemma.py`) — safetensors ->
load -> forward parity -> quantized roundtrip, like test_chatglm does for
chatglm and test_hf_interop for llama."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eetq_tpu.models.config import ModelConfig
from eetq_tpu.models.hf import (
    load_config,
    load_hf_dense,
    load_quantized,
    save_quantized,
)
from eetq_tpu.models.transformer import forward

# ---------------------------------------------------------------------------
# baichuan: W_pack fused qkv, llama MLP names
# ---------------------------------------------------------------------------

H, I, L, NH, D = 64, 128, 2, 4, 16
VOCAB = 96


def _mk_weights(rng):
    """fp16-representable random torch-layout weights for one tiny MHA
    model (baichuan-7b style: RoPE, no GQA — W_pack assumes equal q/k/v)."""

    def w(*shape):
        return (rng.standard_normal(shape) * 0.05).astype(np.float16).astype(
            np.float32
        )

    def norm_w(n):
        return (1.0 + 0.1 * w(n)).astype(np.float16).astype(np.float32)

    layers = []
    for _ in range(L):
        layers.append(dict(
            input_norm=norm_w(H),
            q=w(NH * D, H), k=w(NH * D, H), v=w(NH * D, H),
            o=w(H, NH * D),
            post_norm=norm_w(H),
            gate=w(I, H), up=w(I, H), down=w(H, I),
        ))
    return dict(
        embed=w(VOCAB, H), layers=layers, final_norm=norm_w(H),
        lm_head=w(VOCAB, H),
    )


def _write_dir(d, weights, names, hf_cfg):
    """names: 'llama' (q/k/v_proj) or 'baichuan' (W_pack)."""
    from eetq_tpu.models.safetensors_np import save_file

    tensors = {
        "model.embed_tokens.weight": weights["embed"],
        "model.norm.weight": weights["final_norm"],
        "lm_head.weight": weights["lm_head"],
    }
    for i, lw in enumerate(weights["layers"]):
        p = f"model.layers.{i}"
        tensors[f"{p}.input_layernorm.weight"] = lw["input_norm"]
        tensors[f"{p}.post_attention_layernorm.weight"] = lw["post_norm"]
        if names == "baichuan":
            tensors[f"{p}.self_attn.W_pack.weight"] = np.concatenate(
                [lw["q"], lw["k"], lw["v"]], axis=0
            )
        else:
            tensors[f"{p}.self_attn.q_proj.weight"] = lw["q"]
            tensors[f"{p}.self_attn.k_proj.weight"] = lw["k"]
            tensors[f"{p}.self_attn.v_proj.weight"] = lw["v"]
        tensors[f"{p}.self_attn.o_proj.weight"] = lw["o"]
        tensors[f"{p}.mlp.gate_proj.weight"] = lw["gate"]
        tensors[f"{p}.mlp.up_proj.weight"] = lw["up"]
        tensors[f"{p}.mlp.down_proj.weight"] = lw["down"]
    save_file(tensors, os.path.join(d, "model.safetensors"))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(hf_cfg, f)


_BASE_CFG = {
    "vocab_size": VOCAB,
    "hidden_size": H,
    "intermediate_size": I,
    "num_hidden_layers": L,
    "num_attention_heads": NH,
    "num_key_value_heads": NH,
    "max_position_embeddings": 64,
}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    rng = np.random.default_rng(0)
    weights = _mk_weights(rng)
    d_llama = str(tmp_path_factory.mktemp("hf_llama_named"))
    d_bc = str(tmp_path_factory.mktemp("hf_baichuan"))
    _write_dir(d_llama, weights, "llama", {**_BASE_CFG, "model_type": "llama"})
    _write_dir(d_bc, weights, "baichuan",
               {**_BASE_CFG, "model_type": "baichuan"})
    return d_llama, d_bc


def test_baichuan_wpack_load_matches_llama_layout(dirs):
    """The same weights through the W_pack fused layout and through the
    split q/k/v llama layout load to IDENTICAL params and logits (W_pack
    rows q|k|v transpose directly into the fused [H, (q|k|v)] layout)."""
    d_llama, d_bc = dirs
    cfg_a, pa = load_hf_dense(d_llama, dtype=jnp.float32)
    cfg_b, pb = load_hf_dense(d_bc, dtype=jnp.float32)
    assert cfg_b.model_type == "baichuan"
    assert not cfg_b.alibi  # 4 heads -> 7b-style RoPE detection
    np.testing.assert_array_equal(
        np.asarray(pa.layers[0].qkv.weight), np.asarray(pb.layers[0].qkv.weight)
    )
    toks = jnp.arange(8)[None] % VOCAB
    pos = jnp.arange(8)[None]
    la, _ = forward(pa, cfg_a, toks, pos, None, 0)
    lb, _ = forward(pb, cfg_b, toks, pos, None, 0)
    np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))


def test_baichuan_quantized_roundtrip_bit_exact(dirs, tmp_path):
    """quantize -> save (W_pack stays fused in the HF names) -> load:
    integer weights and scales roundtrip bit-exactly, and the public
    from_quantized end-to-end generate works."""
    from eetq_tpu.layout import unpack_weights
    from eetq_tpu.models import quantize_params

    _, d_bc = dirs
    cfg, dense = load_hf_dense(d_bc, dtype=jnp.float32)
    qp = quantize_params(dense)
    out = str(tmp_path / "bc_q")
    save_quantized(qp, cfg, out)
    with open(os.path.join(out, "config.json")) as f:
        saved = json.load(f)
    assert saved["model_type"] == "baichuan"
    assert saved["quantization_config"]["quant_method"] == "eetq"
    # W_pack stays a single fused tensor in the checkpoint
    from eetq_tpu.models.safetensors_np import safe_open

    with safe_open(os.path.join(out, "model.safetensors")) as h:
        names = set(h.keys())
    assert "model.layers.0.self_attn.W_pack.weight" in names
    assert "model.layers.0.self_attn.q_proj.weight" not in names

    cfg2, qp2 = load_quantized(out)
    np.testing.assert_array_equal(
        np.asarray(unpack_weights(qp.layers[0].qkv.qweight)),
        np.asarray(unpack_weights(qp2.layers[0].qkv.qweight)),
    )
    np.testing.assert_array_equal(
        np.asarray(qp.layers[0].qkv.scales, np.float16),
        np.asarray(qp2.layers[0].qkv.scales, np.float16),
    )
    toks = jnp.arange(6)[None] % VOCAB
    pos = jnp.arange(6)[None]
    l1, _ = forward(qp, cfg, toks, pos, None, 0)
    l2, _ = forward(qp2, cfg2, toks, pos, None, 0)
    np.testing.assert_allclose(
        np.asarray(l1), np.asarray(l2), rtol=2e-2, atol=2e-2
    )


def test_baichuan_13b_alibi_detection():
    cfg = ModelConfig.from_hf_config({
        "model_type": "baichuan", "vocab_size": 64000, "hidden_size": 5120,
        "intermediate_size": 13696, "num_hidden_layers": 40,
        "num_attention_heads": 40, "max_position_embeddings": 4096,
    })
    assert cfg.alibi  # 40 heads -> the 13B ALiBi variant


# ---------------------------------------------------------------------------
# gemma: transformers oracle (tied embeddings, gelu, unit-offset norm)
# ---------------------------------------------------------------------------

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")


@pytest.fixture(scope="module")
def gemma_dir(tmp_path_factory):
    from transformers import GemmaConfig, GemmaForCausalLM

    torch.manual_seed(0)
    cfg = GemmaConfig(
        vocab_size=128,
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=2,
        head_dim=16,
        max_position_embeddings=64,
        hidden_act="gelu_pytorch_tanh",
        hidden_activation="gelu_pytorch_tanh",
    )
    model = GemmaForCausalLM(cfg).eval()
    d = tmp_path_factory.mktemp("hf_gemma")
    model.save_pretrained(d, safe_serialization=True)
    return str(d), model


def test_gemma_forward_parity_with_transformers(gemma_dir, rng):
    """Our gemma load (tied embeddings, sqrt(H) embedding multiplier,
    unit-offset rmsnorm, tanh-gelu) matches the transformers PyTorch
    forward on the same checkpoint."""
    d, torch_model = gemma_dir
    cfg, params = load_hf_dense(d, dtype=jnp.float32)
    assert cfg.model_type == "gemma"
    assert cfg.tie_word_embeddings and params.lm_head is None
    assert cfg.rmsnorm_unit_offset
    assert cfg.embedding_multiplier == pytest.approx(cfg.hidden_size ** 0.5)
    assert cfg.activation == "gelu"

    toks_np = rng.integers(0, cfg.vocab_size, size=(1, 8))
    with torch.no_grad():
        want = torch_model(torch.tensor(toks_np)).logits.numpy()
    toks = jnp.asarray(toks_np, jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(8, dtype=jnp.int32), (1, 8))
    got, _ = forward(params, cfg, toks, pos, None, 0)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-2, atol=2e-2)
    assert np.array_equal(np.asarray(got).argmax(-1), want.argmax(-1))


def test_gemma_quantized_roundtrip(gemma_dir, tmp_path, rng):
    """quantize -> save -> from_quantized through the PUBLIC API: config
    keys roundtrip (tied embeddings: no lm_head tensor saved) and the
    reloaded model generates identically."""
    from eetq_tpu import AutoEETQForCausalLM

    d, _ = gemma_dir
    model = AutoEETQForCausalLM.from_pretrained(d)
    out = str(tmp_path / "gemma_q")
    model.quantize(out)
    served = AutoEETQForCausalLM.from_quantized(out)
    assert served.cfg.tie_word_embeddings and served.params.lm_head is None
    assert served.cfg.rmsnorm_unit_offset
    prompt = jnp.asarray(rng.integers(1, 120, size=(1, 6)), jnp.int32)
    a = model.generate(prompt, max_new_tokens=6)
    b = served.generate(prompt, max_new_tokens=6)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
