"""End-to-end model tests on a tiny llama-family config: quantized forward
vs dense forward, prefill/decode consistency, generate()."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eetq_tpu.models import (
    ModelConfig,
    forward,
    init_caches,
    quantize_params,
    random_dense_params,
)
from eetq_tpu.serve import generate

TINY = ModelConfig(
    vocab_size=256,
    hidden_size=64,
    intermediate_size=128,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    max_position=64,
)


@pytest.fixture(scope="module")
def dense_params():
    return random_dense_params(TINY, jax.random.PRNGKey(0), dtype=jnp.float32)


@pytest.fixture(scope="module")
def quant_params(dense_params):
    return quantize_params(dense_params)


def _tokens(rng, b, s, vocab=256):
    return jnp.asarray(rng.integers(0, vocab, size=(b, s)), dtype=jnp.int32)


def test_quantized_forward_close_to_dense(rng, dense_params, quant_params):
    tokens = _tokens(rng, 2, 8)
    pos = jnp.broadcast_to(jnp.arange(8, dtype=jnp.int32), (2, 8))
    logits_d, _ = forward(dense_params, TINY, tokens, pos, None, 0)
    logits_q, _ = forward(quant_params, TINY, tokens, pos, None, 0)
    ld, lq = np.asarray(logits_d), np.asarray(logits_q)
    # top-1 agreement on most positions + bounded logit error
    agree = (ld.argmax(-1) == lq.argmax(-1)).mean()
    assert agree >= 0.9, agree
    assert np.abs(ld - lq).mean() < 0.1


def test_prefill_decode_consistency(rng, quant_params):
    """Decoding token-by-token must produce the same logits as one prefill
    over the whole sequence (the fundamental KV-cache invariant)."""
    b, s = 1, 6
    tokens = _tokens(rng, b, s)
    pos = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
    full_logits, _ = forward(quant_params, TINY, tokens, pos, None, 0)

    caches = init_caches(TINY, b, 16, dtype=jnp.float32)
    step_logits = []
    for i in range(s):
        li, caches = forward(
            quant_params,
            TINY,
            tokens[:, i : i + 1],
            pos[:, i : i + 1],
            caches,
            jnp.int32(i),
        )
        step_logits.append(li[:, 0])
    stepwise = np.stack([np.asarray(l) for l in step_logits], axis=1)
    np.testing.assert_allclose(
        np.asarray(full_logits), stepwise, rtol=2e-2, atol=2e-2
    )


def test_generate_greedy_deterministic(rng, quant_params):
    prompt = _tokens(rng, 2, 5)
    out1 = generate(quant_params, TINY, prompt, max_new_tokens=8)
    out2 = generate(quant_params, TINY, prompt, max_new_tokens=8)
    assert out1.shape == (2, 8)
    np.testing.assert_array_equal(np.asarray(out1), np.asarray(out2))


def test_generate_sampled_valid(rng, quant_params):
    prompt = _tokens(rng, 1, 4)
    out = generate(
        quant_params, TINY, prompt, max_new_tokens=6, temperature=0.8, top_k=10,
        key=jax.random.PRNGKey(7),
    )
    toks = np.asarray(out)
    assert toks.shape == (1, 6)
    assert (toks >= 0).all() and (toks < TINY.vocab_size).all()


def test_generate_matches_forward_argmax(rng, quant_params):
    """First generated token == argmax of prefill logits at the last
    position."""
    prompt = _tokens(rng, 1, 5)
    pos = jnp.broadcast_to(jnp.arange(5, dtype=jnp.int32), (1, 5))
    logits, _ = forward(quant_params, TINY, prompt, pos, None, 0)
    expected = int(np.asarray(logits)[0, -1].argmax())
    out = generate(quant_params, TINY, prompt, max_new_tokens=1)
    assert int(np.asarray(out)[0, 0]) == expected


def test_gemma_style_config(rng):
    """Exercise gemma variants: tied embeddings, unit-offset rmsnorm,
    embedding multiplier, gelu."""
    cfg = dataclasses.replace(
        TINY,
        tie_word_embeddings=True,
        rmsnorm_unit_offset=True,
        embedding_multiplier=8.0,
        activation="gelu",
        model_type="gemma",
    )
    params = random_dense_params(cfg, jax.random.PRNGKey(1), dtype=jnp.float32)
    assert params.lm_head is None
    qp = quantize_params(params)
    out = generate(qp, cfg, _tokens(rng, 1, 4), max_new_tokens=3)
    assert out.shape == (1, 3)


def test_sliding_window_config(rng):
    cfg = dataclasses.replace(TINY, sliding_window=4, model_type="mistral")
    params = quantize_params(
        random_dense_params(cfg, jax.random.PRNGKey(2), dtype=jnp.float32)
    )
    out = generate(params, cfg, _tokens(rng, 1, 6), max_new_tokens=3)
    assert out.shape == (1, 3)


def test_from_hf_config():
    hf = {
        "model_type": "llama",
        "vocab_size": 32000,
        "hidden_size": 2048,
        "intermediate_size": 5632,
        "num_hidden_layers": 22,
        "num_attention_heads": 32,
        "num_key_value_heads": 4,
        "max_position_embeddings": 2048,
        "rope_theta": 10000.0,
        "rms_norm_eps": 1e-5,
        "hidden_act": "silu",
    }
    cfg = ModelConfig.from_hf_config(hf)
    assert cfg.head_dim == 64 and cfg.num_kv_heads == 4
    assert cfg.qkv_out == (32 + 8) * 64
