"""HF interop: parity of our forward vs transformers' PyTorch llama on the
same weights, checkpoint save/load roundtrips, torch-model conversion, and
the one-line accelerate path."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from transformers import LlamaConfig, LlamaForCausalLM

from eetq_tpu.models.auto import AutoEETQForCausalLM
from eetq_tpu.models.hf import load_hf_dense, load_quantized, save_quantized
from eetq_tpu.models.transformer import forward
from eetq_tpu.surgery import eet_accelerator


@pytest.fixture(scope="module")
def torch_llama():
    torch.manual_seed(0)
    cfg = LlamaConfig(
        vocab_size=128,
        hidden_size=64,
        intermediate_size=128,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=2,
        max_position_embeddings=64,
        rms_norm_eps=1e-5,
    )
    model = LlamaForCausalLM(cfg).eval()
    return model


@pytest.fixture(scope="module")
def hf_dir(torch_llama, tmp_path_factory):
    d = tmp_path_factory.mktemp("hf_llama")
    torch_llama.save_pretrained(d, safe_serialization=True)
    return str(d)


def test_forward_parity_with_transformers(torch_llama, hf_dir, rng):
    """THE parity test: our JAX forward on an HF checkpoint must match the
    PyTorch reference model's logits (bf16-activation tolerance)."""
    cfg, params = load_hf_dense(hf_dir, dtype=jnp.float32)
    tokens_np = rng.integers(0, 128, size=(2, 10))
    with torch.no_grad():
        ref = torch_llama(torch.tensor(tokens_np)).logits.numpy()

    tokens = jnp.asarray(tokens_np, jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(10, dtype=jnp.int32), (2, 10))
    logits, _ = forward(params, cfg, tokens, pos, None, 0)
    ours = np.asarray(logits)

    assert (ours.argmax(-1) == ref.argmax(-1)).mean() > 0.95
    np.testing.assert_allclose(ours, ref, rtol=5e-2, atol=5e-2)


def test_quantized_roundtrip_bit_exact(hf_dir, rng, tmp_path):
    """quantize -> save_quantized -> from_quantized must reproduce logits
    bit-exactly (unpacked-int8 checkpoint format is lossless)."""
    model = AutoEETQForCausalLM.from_pretrained(hf_dir, quantize=True)
    save_dir = str(tmp_path / "quantized")
    model.save_quantized(save_dir)

    model2 = AutoEETQForCausalLM.from_quantized(save_dir)
    tokens = jnp.asarray(rng.integers(0, 128, (1, 8)), jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(8, dtype=jnp.int32), (1, 8))
    l1, _ = model.forward(tokens, pos)
    l2, _ = model2.forward(tokens, pos)
    np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2))

    # config.json carries the HF-compatible quantization_config
    with open(os.path.join(save_dir, "config.json")) as f:
        saved_cfg = json.load(f)
    assert saved_cfg["quantization_config"] == {
        "quant_method": "eetq",
        "zero_point": False,
        "bits": 8,
        "tp": 1,
    }
    assert os.path.exists(os.path.join(save_dir, "quant_config.json"))


def test_from_quantized_rejects_plain_checkpoint(hf_dir):
    with pytest.raises(ValueError, match="not an eetq quantized"):
        load_quantized(hf_dir)


def test_from_torch_conversion(torch_llama, rng):
    model = AutoEETQForCausalLM.from_torch(torch_llama, quantize=True)
    assert model.quantized
    tokens_np = rng.integers(0, 128, size=(1, 6))
    with torch.no_grad():
        ref = torch_llama(torch.tensor(tokens_np)).logits.numpy()
    tokens = jnp.asarray(tokens_np, jnp.int32)
    pos = jnp.broadcast_to(jnp.arange(6, dtype=jnp.int32), (1, 6))
    logits, _ = model.forward(tokens, pos)
    ours = np.asarray(logits)
    # quantized + bf16: looser tolerance, argmax agreement
    assert (ours.argmax(-1) == ref.argmax(-1)).mean() > 0.8
    assert np.abs(ours - ref).mean() < 0.2


def test_eet_accelerator_one_liner(torch_llama):
    cfg, params = None, None
    out = eet_accelerator(torch_llama, quantize=True, fused_attn=True)
    cfg, params = out
    assert cfg.model_type == "llama"
    from eetq_tpu.modules.linear import QuantLinear

    assert isinstance(params.layers[0].qkv, QuantLinear)


def test_generate_through_auto_api(hf_dir, rng):
    model = AutoEETQForCausalLM.from_pretrained(hf_dir, quantize=True)
    prompt = jnp.asarray(rng.integers(0, 128, (1, 5)), jnp.int32)
    out = model.generate(prompt, max_new_tokens=4)
    assert out.shape == (1, 4)


def test_unsupported_model_type(tmp_path):
    d = tmp_path / "bad"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({
        "model_type": "gpt_bigcode", "vocab_size": 8, "hidden_size": 8,
        "intermediate_size": 8, "num_hidden_layers": 1,
        "num_attention_heads": 1,
    }))
    with pytest.raises(ValueError, match="isn't supported"):
        AutoEETQForCausalLM.from_pretrained(str(d))


def test_quantized_lm_head_roundtrip(tmp_path, rng):
    """quantize_lm_head=True: lm_head saved as int8+scales and reloaded."""
    import dataclasses

    import jax

    from eetq_tpu.models import quantize_params, random_dense_params
    from eetq_tpu.models.config import ModelConfig
    from eetq_tpu.models.hf import load_quantized, save_quantized
    from eetq_tpu.models.transformer import forward
    from eetq_tpu.modules.linear import QuantLinear

    cfg = ModelConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=1,
        num_heads=4, num_kv_heads=2, head_dim=16, max_position=32,
    )
    dense = random_dense_params(cfg, jax.random.PRNGKey(0), jnp.bfloat16)
    qp = quantize_params(dense, quantize_lm_head=True)
    assert isinstance(qp.lm_head, QuantLinear)
    save_quantized(qp, cfg, str(tmp_path))
    cfg2, loaded = load_quantized(str(tmp_path))
    assert isinstance(loaded.lm_head, QuantLinear)
    toks = jnp.arange(8, dtype=jnp.int32)[None, :]
    pos = jnp.arange(8, dtype=jnp.int32)[None, :]
    lg1, _ = forward(qp, cfg, toks, pos, None, jnp.int32(0))
    lg2, _ = forward(loaded, cfg2, toks, pos, None, jnp.int32(0))
    np.testing.assert_allclose(np.asarray(lg1), np.asarray(lg2), atol=3e-2)


@pytest.mark.parametrize("bits,g", [(4, None), (8, 64), (4, 64)])
def test_int4_groupwise_checkpoint_roundtrip(tmp_path, rng, bits, g):
    """W4A16 and group-wise checkpoints round-trip with identical logits."""
    import jax

    from eetq_tpu.models import random_dense_params
    from eetq_tpu.models.config import ModelConfig
    from eetq_tpu.models.hf import load_quantized, save_quantized
    from eetq_tpu.models.transformer import forward
    from eetq_tpu.surgery.quantize import eet_quantize

    cfg = ModelConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=1,
        num_heads=4, num_kv_heads=2, head_dim=16, max_position=32,
    )
    dense = random_dense_params(cfg, jax.random.PRNGKey(0), jnp.bfloat16)
    qp = eet_quantize(dense, bits=bits, group_size=g)
    d = str(tmp_path / f"b{bits}g{g}")
    save_quantized(qp, cfg, d)
    import json as _json

    with open(f"{d}/config.json") as f:
        assert _json.load(f)["quantization_config"]["bits"] == bits
    cfg2, loaded = load_quantized(d)
    toks = jnp.arange(8, dtype=jnp.int32)[None, :]
    pos = jnp.arange(8, dtype=jnp.int32)[None, :]
    lg1, _ = forward(qp, cfg, toks, pos, None, jnp.int32(0))
    lg2, _ = forward(loaded, cfg2, toks, pos, None, jnp.int32(0))
    np.testing.assert_allclose(np.asarray(lg1), np.asarray(lg2), atol=3e-2)


def test_hub_resolution(tmp_path, monkeypatch):
    """Local dirs pass through; hub ids route to snapshot_download (mocked —
    the environment is zero-egress). Reference parity:
    models/base.py:210-256."""
    import huggingface_hub

    from eetq_tpu.models.auto import resolve_checkpoint

    assert resolve_checkpoint(str(tmp_path)) == str(tmp_path)

    called = {}

    def fake(repo_id, **kw):
        called["id"] = repo_id
        return str(tmp_path)

    monkeypatch.setattr(huggingface_hub, "snapshot_download", fake)
    assert resolve_checkpoint("org/some-model") == str(tmp_path)
    assert called["id"] == "org/some-model"
