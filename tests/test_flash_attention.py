"""Prefill attention (`attention_prefill`: jax.nn.dot_product_attention,
cuDNN on the GPU, XLA here) vs the masked-softmax oracle, forward and
backward."""

import jax.numpy as jnp
import numpy as np
import pytest

from eetq_tpu.modules.attention import (
    attention_prefill,
    attention_reference,
    causal_mask,
)


def _qkv(rng, b, s, hq, hkv, d, skv=None):
    skv = skv or s
    q = jnp.asarray(rng.standard_normal((b, s, hq, d)).astype(np.float32))
    k = jnp.asarray(rng.standard_normal((b, skv, hkv, d)).astype(np.float32))
    v = jnp.asarray(rng.standard_normal((b, skv, hkv, d)).astype(np.float32))
    return q, k, v


@pytest.mark.parametrize(
    "b,s,hq,hkv,d",
    [
        (1, 128, 4, 4, 64),    # MHA
        (2, 256, 8, 2, 64),    # GQA 4:1
        (1, 300, 4, 1, 128),   # MQA, unaligned seq
        (1, 8, 4, 4, 64),      # tiny seq (below one block)
    ],
)
def test_causal_matches_reference(rng, b, s, hq, hkv, d):
    q, k, v = _qkv(rng, b, s, hq, hkv, d)
    scale = 1.0 / d**0.5
    out = attention_prefill(q, k, v)
    ref = attention_reference(q, k, v, causal_mask(s), scale)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(ref, np.float32), rtol=2e-2, atol=2e-3
    )


def test_sliding_window(rng):
    s, w = 256, 64
    q, k, v = _qkv(rng, 1, s, 4, 4, 64)
    out = attention_prefill(q, k, v, window=w)
    ref = attention_reference(q, k, v, causal_mask(s, window=w), 1.0 / 8.0)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(ref, np.float32), rtol=2e-2, atol=2e-3
    )


def test_bf16(rng):
    q, k, v = _qkv(rng, 1, 128, 4, 4, 64)
    q, k, v = q.astype(jnp.bfloat16), k.astype(jnp.bfloat16), v.astype(jnp.bfloat16)
    out = attention_prefill(q, k, v)
    assert out.dtype == jnp.bfloat16
    ref = attention_reference(q, k, v, causal_mask(128), 1.0 / 8.0)
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(ref, np.float32), rtol=5e-2, atol=2e-2
    )


def test_cross_attention_lengths(rng):
    """Sq != Skv (chunked prefill shape): the last query aligns with the
    last key."""
    q, k, v = _qkv(rng, 1, 128, 4, 4, 64, skv=384)
    out = attention_prefill(q, k, v)
    ref = attention_reference(
        q, k, v, causal_mask(128, kv_len=384), 1.0 / 8.0
    )
    np.testing.assert_allclose(
        np.asarray(out, np.float32), np.asarray(ref, np.float32), rtol=2e-2, atol=2e-3
    )


# ---- backward (jax.nn.dot_product_attention's own VJP) ----


def _grad_pair(loss_flash, loss_ref, args):
    import jax

    gf = jax.grad(loss_flash, argnums=tuple(range(len(args))))(*args)
    gr = jax.grad(loss_ref, argnums=tuple(range(len(args))))(*args)
    for name, a, b in zip("qkv", gf, gr):
        rel = float(jnp.max(jnp.abs(a - b))) / (
            float(jnp.max(jnp.abs(b))) + 1e-9
        )
        assert rel < 2e-3, (name, rel)


@pytest.mark.parametrize(
    "hq,hkv,window",
    [(4, 4, None), (8, 2, None), (4, 4, 64)],
)
def test_backward_matches_reference_vjp(rng, hq, hkv, window):
    """Prefill VJP == attention_reference VJP (the reference relies on
    flash-attn's differentiable CUDA kernel, llama_modules.py:132-141)."""
    s, d = 256, 64
    q, k, v = _qkv(rng, 1, s, hq, hkv, d)
    scale = 1.0 / d**0.5

    def lf(q, k, v):
        return jnp.sum(
            attention_prefill(q, k, v, window=window).astype(jnp.float32)
            ** 2
        )

    def lr(q, k, v):
        return jnp.sum(
            attention_reference(
                q, k, v, causal_mask(s, window=window), scale
            ).astype(jnp.float32)
            ** 2
        )

    _grad_pair(lf, lr, (q, k, v))


def test_backward_alibi(rng):
    from eetq_tpu.ops import alibi_slopes

    s, hq, d = 256, 4, 64
    q, k, v = _qkv(rng, 1, s, hq, hq, d)
    sl = jnp.asarray(alibi_slopes(hq))
    scale = 1.0 / d**0.5

    def lf(q, k, v):
        return jnp.sum(
            attention_prefill(q, k, v, slopes=sl).astype(jnp.float32) ** 2
        )

    def lr(q, k, v):
        return jnp.sum(
            attention_reference(q, k, v, causal_mask(s), scale,
                                slopes=sl).astype(jnp.float32) ** 2
        )

    _grad_pair(lf, lr, (q, k, v))


def test_lora_backward_flash_s1024(rng, monkeypatch):
    """LoRA finetuning through the MODEL forward at S=1024: grads through
    the prefill attention's VJP match the grads with attention_reference
    patched in. This is the reference's LoRA-over-frozen-quantized
    training capability (qlinear.py:64-94 + flash_attn_func)."""
    import dataclasses
    import importlib

    import jax

    from eetq_tpu.models import ModelConfig, quantize_params, random_dense_params
    from eetq_tpu.models.transformer import forward_inner
    from eetq_tpu.modules.linear import LoraAdapter

    cfg = ModelConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=1,
        num_heads=2, num_kv_heads=2, head_dim=16, max_position=1024,
    )
    params = quantize_params(
        random_dense_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    )
    r = 4
    lora = LoraAdapter(
        lora_a=jnp.asarray(
            rng.standard_normal((cfg.hidden_size, r)).astype(np.float32) * 0.02
        ),
        lora_b=jnp.asarray(
            rng.standard_normal((r, cfg.qkv_out)).astype(np.float32) * 0.02
        ),
        scaling=1.0,
    )
    s = 1024
    toks = jnp.asarray(
        np.random.default_rng(1).integers(0, 64, size=(1, s)), jnp.int32
    )
    pos = jnp.arange(s, dtype=jnp.int32)[None]

    def loss(lora):
        lp = dataclasses.replace(params.layers[0], qkv_lora=lora)
        p = dataclasses.replace(params, layers=[lp])
        logits, _ = forward_inner(p, cfg, toks, pos, None, jnp.int32(0))
        return jnp.mean(logits.astype(jnp.float32) ** 2)

    gf = jax.grad(loss)(lora)

    def reference_prefill(q, k, v, window=None, slopes=None):
        return attention_reference(
            q, k, v, causal_mask(q.shape[1], window, kv_len=k.shape[1]),
            1.0 / (q.shape[-1] ** 0.5), slopes=slopes,
        )

    attn_mod = importlib.import_module("eetq_tpu.modules.attention")
    monkeypatch.setattr(attn_mod, "attention_prefill", reference_prefill)
    gr = jax.grad(loss)(lora)
    for name in ("lora_a", "lora_b"):
        a, b = getattr(gf, name), getattr(gr, name)
        assert float(jnp.abs(a).sum()) > 0
        rel = float(jnp.max(jnp.abs(a - b))) / (
            float(jnp.max(jnp.abs(b))) + 1e-9
        )
        assert rel < 5e-2, (name, rel)
