"""Speculative decoding: verify-attention oracle equivalence and exact
greedy parity of spec_generate / ngram_spec_generate vs greedy_generate.

The guarantee under test is the strong one: speculative output must equal
the target's greedy decode TOKEN-FOR-TOKEN regardless of the draft's
quality (a bad draft only costs speed, never correctness).

The draft-model spec_generate checks (which compile TWO full models into
one while_loop) run in a clean subprocess — tests/spec_checks.py — because
that compile segfaulted XLA CPU at ~83% of two consecutive full-suite runs
while passing in isolation; the subprocess makes the
full suite deterministic and keeps the coverage."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eetq_tpu.models import (
    ModelConfig,
    quantize_params,
    random_dense_params,
)
from eetq_tpu.modules.attention import (
    KVCache,
    attention_reference,
    attention_verify,
    causal_mask,
    update_cache,
)
from eetq_tpu.serve.generate import greedy_generate
from eetq_tpu.serve.spec import (
    ngram_spec_generate,
    positional_generate,
)

TINY = ModelConfig(
    vocab_size=256,
    hidden_size=64,
    intermediate_size=128,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    max_position=128,
)


@pytest.fixture(scope="module")
def dense_params():
    return random_dense_params(TINY, jax.random.PRNGKey(3), dtype=jnp.float32)


@pytest.fixture(scope="module")
def quant_params(dense_params):
    return quantize_params(dense_params)


def _tokens(rng, b, s, vocab=256):
    return jnp.asarray(rng.integers(0, vocab, size=(b, s)), dtype=jnp.int32)


def test_attention_verify_matches_reference(rng):
    """attention_verify over a cache == dense attention_reference with the
    equivalent causal mask, for every query row."""
    b, hq, hkv, d, prefix, s, max_len = 2, 4, 2, 16, 9, 3, 32
    q = jnp.asarray(rng.normal(size=(b, s, hq, d)), jnp.float32)
    k_all = jnp.asarray(rng.normal(size=(b, prefix + s, hkv, d)), jnp.float32)
    v_all = jnp.asarray(rng.normal(size=(b, prefix + s, hkv, d)), jnp.float32)

    cache = KVCache(
        k=jnp.zeros((b, hkv, max_len, d), jnp.float32),
        v=jnp.zeros((b, hkv, max_len, d), jnp.float32),
    )
    cache = update_cache(cache, k_all, v_all, 0)
    out = attention_verify(
        q, cache, jnp.full((b,), prefix + s, jnp.int32), None, d ** -0.5
    )

    mask = causal_mask(s, kv_len=prefix + s)
    ref = attention_reference(q, k_all, v_all, mask, d ** -0.5)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5)


def test_attention_verify_per_row_lengths(rng):
    """Per-row dynamic lengths: each row must mask by its own position."""
    b, hq, hkv, d, s, max_len = 2, 4, 2, 16, 2, 32
    lengths = jnp.asarray([7, 12], jnp.int32)  # includes the s new tokens
    q = jnp.asarray(rng.normal(size=(b, s, hq, d)), jnp.float32)
    cache = KVCache(
        k=jnp.asarray(rng.normal(size=(b, hkv, max_len, d)), jnp.float32),
        v=jnp.asarray(rng.normal(size=(b, hkv, max_len, d)), jnp.float32),
    )
    out = attention_verify(q, cache, lengths, None, d ** -0.5)
    for r in range(b):
        L = int(lengths[r])
        k_r = cache.k[r : r + 1, :, :L].transpose(0, 2, 1, 3)
        v_r = cache.v[r : r + 1, :, :L].transpose(0, 2, 1, 3)
        ref = attention_reference(
            q[r : r + 1], k_r, v_r, causal_mask(s, kv_len=L), d ** -0.5
        )
        np.testing.assert_allclose(
            np.asarray(out[r : r + 1]), np.asarray(ref), atol=1e-5
        )


@pytest.mark.slow
def test_spec_draft_model_parity_subprocess():
    """spec_generate draft-model parity (same-model k=1/3, int4 draft,
    batch-diverge) in a fresh process — see module docstring / the
    spec_checks.py docstring for why these two-model compiles are
    isolated."""
    script = os.path.join(os.path.dirname(__file__), "spec_checks.py")
    proc = subprocess.run(
        [sys.executable, "-u", script],
        capture_output=True,
        text=True,
        timeout=2400,
    )
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-2000:])
    assert "ALL SPEC CHECKS PASS" in proc.stdout, proc.stdout[-2000:]


def test_ngram_spec_exact_parity(rng, quant_params):
    """Prompt-lookup drafting: exact greedy parity on an arbitrary prompt
    (few/no matches — worst case) and on a repetitive prompt (matches)."""
    n = 12
    for prompt in (
        _tokens(rng, 2, 8),
        jnp.tile(jnp.asarray([[5, 9, 5, 9]], jnp.int32), (1, 4)),  # [1,16]
    ):
        ref = greedy_generate(quant_params, TINY, prompt, n)
        toks, stats = ngram_spec_generate(
            quant_params, TINY, prompt, n, k=3, return_stats=True
        )
        np.testing.assert_array_equal(np.asarray(toks), np.asarray(ref))


@pytest.mark.parametrize("top_k", [0, 5])
def test_ngram_spec_sampled_exact_parity(rng, quant_params, top_k):
    """SAMPLED speculation (r5): with positional PRNG (`_sample_pos`,
    randomness keyed by (row, emission index) not draw order), the
    speculative output equals the plain positionally-sampled decode
    token-for-token — same key ⇒ same tokens, the distribution-exactness
    guarantee."""
    key = jax.random.PRNGKey(42)
    n = 12
    for prompt in (
        _tokens(rng, 2, 8),
        jnp.tile(jnp.asarray([[5, 9, 5, 9]], jnp.int32), (1, 4)),
    ):
        ref = positional_generate(
            quant_params, TINY, prompt, n, temperature=0.8, top_k=top_k,
            key=key,
        )
        toks, stats = ngram_spec_generate(
            quant_params, TINY, prompt, n, k=3, temperature=0.8,
            top_k=top_k, key=key, return_stats=True,
        )
        np.testing.assert_array_equal(np.asarray(toks), np.asarray(ref))
    # different key -> (almost surely) different sampled tokens
    other = ngram_spec_generate(
        quant_params, TINY, _tokens(rng, 2, 8), n, k=3, temperature=0.8,
        key=jax.random.PRNGKey(7),
    )
    assert other.shape == (2, n)


def test_ngram_repetitive_accepts(rng, quant_params):
    """On self-generated repetitive continuations the lookup draft should
    accept at least one draft somewhere (sanity that matching works)."""
    # a prompt whose greedy continuation quickly enters a loop is typical
    # for a random tiny model; verify accepted_drafts is counted
    prompt = jnp.tile(jnp.asarray([[7, 3]], jnp.int32), (1, 8))
    toks, stats = ngram_spec_generate(
        quant_params, TINY, prompt, 20, k=3, return_stats=True
    )
    ref = greedy_generate(quant_params, TINY, prompt, 20)
    np.testing.assert_array_equal(np.asarray(toks), np.asarray(ref))
    assert stats["rounds"] <= 19


@pytest.mark.parametrize("quantize_lm_head", [False, True])
def test_verify_forward_agrees_with_decode_steps(rng, dense_params,
                                                  quantize_lm_head):
    """The verify forward over k+1 = 8 tokens against the single-token
    decode step at each position: the same greedy token and logits within
    bf16 rounding (the attention einsums and the lm_head reduce in
    shape-dependent orders, so not bit for bit in general)."""
    from eetq_tpu.models import init_caches
    from eetq_tpu.serve.generate import decode_step, prefill
    from eetq_tpu.serve.spec import _verify_forward

    qp = quantize_params(dense_params, quantize_lm_head=quantize_lm_head)
    p, s = 12, 8
    toks = _tokens(rng, 1, p + s)
    _, caches = prefill(qp, TINY, toks[:, :p], init_caches(TINY, 1, 64))
    verify, _ = jax.jit(_verify_forward, static_argnums=1)(
        qp, TINY, toks[:, p:], jnp.full((1,), p, jnp.int32), caches)
    verify = np.asarray(verify, np.float32)
    for i in range(s):
        single, caches = decode_step(qp, TINY, toks[:, p + i : p + i + 1],
                                     p + i, caches)
        single = np.asarray(single, np.float32)
        np.testing.assert_array_equal(verify[:, i].argmax(-1),
                                      single.argmax(-1))
        # bf16 activations between layers: one rounding step (2^-8
        # relative) at the largest logit, with room for one more
        atol = 2.0**-7 * np.abs(single).max()
        np.testing.assert_allclose(verify[:, i], single, rtol=0, atol=atol)
