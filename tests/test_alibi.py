"""ALiBi tests: slope formula vs the recursive reference definition, the
prefill and decode attention entries vs a numpy oracle, and
baichuan-13b-style e2e
consistency (prefill+decode lock-step == full re-prefill each step).

Parity target: the reference serves baichuan-13b through HF's ALiBi model
code (`/root/reference/python/eetq/models/baichuan.py:15-106` only does
W_pack fusion/TP); here ALiBi is implemented in our own attention stack."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eetq_tpu.models import ModelConfig, quantize_params, random_dense_params
from eetq_tpu.models.transformer import forward, init_caches
from eetq_tpu.modules.attention import (
    attention_decode,
    attention_prefill,
    attention_reference,
    causal_mask,
    init_kv_cache,
    update_cache,
)
from eetq_tpu.ops import alibi_slopes
from eetq_tpu.serve.generate import greedy_generate


def _slopes_recursive(n):
    """Press et al. reference implementation (recursive form)."""

    def pow2(m):
        start = 2.0 ** (-(2.0 ** -(math.log2(m) - 3)))
        return [start * (start**i) for i in range(m)]

    if math.log2(n).is_integer():
        return pow2(n)
    closest = 2 ** math.floor(math.log2(n))
    return (
        pow2(closest)
        + _slopes_recursive(2 * closest)[0::2][: n - closest]
    )


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7, 8, 12, 16, 20, 32, 40, 64])
def test_slopes_match_reference_formula(n):
    got = alibi_slopes(n)
    want = np.asarray(_slopes_recursive(n), np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _oracle_full(q, k, v, slopes, mask):
    """Plain numpy ALiBi attention oracle (MHA or GQA)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qf = np.asarray(q, np.float32)
    kf = np.asarray(k, np.float32)
    vf = np.asarray(v, np.float32)
    out = np.zeros((b, s, hq, d), np.float32)
    scale = 1.0 / math.sqrt(d)
    l = k.shape[1]
    for bi in range(b):
        for h in range(hq):
            scores = qf[bi, :, h] @ kf[bi, :, h // g].T * scale
            i = np.arange(s)[:, None]
            j = np.arange(l)[None, :]
            scores = scores + slopes[h] * (j - i + (l - s))
            scores = np.where(mask, scores, -1e30)
            p = np.exp(scores - scores.max(-1, keepdims=True))
            p /= p.sum(-1, keepdims=True)
            out[bi, :, h] = p @ vf[bi, :, h // g]
    return out


def test_reference_attention_alibi_vs_numpy():
    rng = np.random.default_rng(0)
    b, s, hq, hkv, d = 2, 16, 4, 2, 8
    q = jnp.asarray(rng.standard_normal((b, s, hq, d)), jnp.float32)
    k = jnp.asarray(rng.standard_normal((b, s, hkv, d)), jnp.float32)
    v = jnp.asarray(rng.standard_normal((b, s, hkv, d)), jnp.float32)
    slopes = alibi_slopes(hq)
    mask = np.tril(np.ones((s, s), bool))
    got = attention_reference(
        q, k, v, causal_mask(s), 1.0 / math.sqrt(d), slopes=jnp.asarray(slopes)
    )
    want = _oracle_full(q, k, v, slopes, mask)
    np.testing.assert_allclose(np.asarray(got), want, atol=2e-5)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
def test_flash_attention_alibi_matches_oracle(hq, hkv):
    """The prefill entry (jax.nn.dot_product_attention with an ALiBi
    bias) against the numpy oracle; bf16 inputs, f32 oracle."""
    rng = np.random.default_rng(1)
    b, s, d = 1, 256, 64
    q = jnp.asarray(rng.standard_normal((b, s, hq, d)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((b, s, hkv, d)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((b, s, hkv, d)), jnp.bfloat16)
    slopes = alibi_slopes(hq)
    got = attention_prefill(q, k, v, slopes=jnp.asarray(slopes))
    want = _oracle_full(q, k, v, slopes, np.tril(np.ones((s, s), bool)))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=3e-2)


@pytest.mark.parametrize("quantized", [False, True])
def test_flash_decode_alibi_matches_oracle(quantized):
    """The decode entry over a bf16 or int8 cache with per-row lengths
    against the numpy oracle on the dequantized cache."""
    rng = np.random.default_rng(2)
    b, hq, hkv, d, lmax, length = 2, 8, 4, 32, 256, 100
    cache = init_kv_cache(b, lmax, hkv, d,
                          dtype=jnp.int8 if quantized else jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((b, lmax, hkv, d)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((b, lmax, hkv, d)), jnp.bfloat16)
    cache = update_cache(cache, k, v, jnp.int32(0))
    q = jnp.asarray(rng.standard_normal((b, 1, hq, d)), jnp.bfloat16)
    slopes = alibi_slopes(hq)
    lengths = [length, length - 17]
    got = attention_decode(
        q, cache, jnp.asarray(lengths, jnp.int32), slopes=jnp.asarray(slopes)
    )

    def dense(x, sc):  # [B, H, L, D] cache leaf -> f32 [B, L, H, D]
        x = np.asarray(x, np.float32)
        if sc is not None:
            x = x * np.asarray(sc, np.float32)[..., None]
        return x.transpose(0, 2, 1, 3)

    kd, vd = dense(cache.k, cache.k_scale), dense(cache.v, cache.v_scale)
    for r, n in enumerate(lengths):
        want = _oracle_full(
            q[r : r + 1], kd[r : r + 1, :n], vd[r : r + 1, :n], slopes,
            np.ones((1, n), bool),
        )
        np.testing.assert_allclose(
            np.asarray(got[r : r + 1], np.float32), want, atol=3e-2
        )


CFG13B_TINY = ModelConfig(
    vocab_size=128,
    hidden_size=64,
    intermediate_size=128,
    num_layers=2,
    num_heads=8,  # MHA like baichuan-13b
    num_kv_heads=8,
    head_dim=8,
    max_position=128,
    alibi=True,
    model_type="baichuan",
)


def test_alibi_model_decode_consistent_with_prefill():
    """Greedy generation (prefill + cached decode) must match argmax of a
    from-scratch full forward at every step — validates that the decode
    path's ALiBi bias (relative to length-1) agrees with the prefill
    bias."""
    params = quantize_params(
        random_dense_params(CFG13B_TINY, jax.random.PRNGKey(3), dtype=jnp.bfloat16)
    )
    prompt = [5, 9, 23, 40]
    n_new = 6
    out = greedy_generate(
        params, CFG13B_TINY, jnp.asarray(np.asarray(prompt, np.int32)[None]), n_new
    )
    toks = [int(t) for t in np.asarray(out[0])]

    # oracle: full re-prefill (no cache) each step, argmax of last logits
    seq = list(prompt)
    for step in range(n_new):
        t = jnp.asarray(np.asarray(seq, np.int32)[None])
        pos = jnp.arange(len(seq), dtype=jnp.int32)[None]
        logits, _ = forward(params, CFG13B_TINY, t, pos, None, jnp.int32(0))
        nxt = int(jnp.argmax(logits[0, -1]))
        assert nxt == toks[step], (step, nxt, toks)
        seq.append(nxt)


def test_alibi_config_detection():
    hf = {
        "model_type": "baichuan", "vocab_size": 64000, "hidden_size": 5120,
        "intermediate_size": 13696, "num_hidden_layers": 40,
        "num_attention_heads": 40, "max_position_embeddings": 4096,
    }
    assert ModelConfig.from_hf_config(hf).alibi
    hf7 = dict(hf, num_attention_heads=32, hidden_size=4096,
               num_hidden_layers=32)
    assert not ModelConfig.from_hf_config(hf7).alibi
    assert ModelConfig.from_hf_config(dict(hf7, alibi=True)).alibi


def test_alibi_tp_matches_single_device():
    """8 ALiBi heads over tp=2: local head slices must pick the right
    slopes (global head index, not local)."""
    from eetq_tpu.dist import make_mesh
    from eetq_tpu.dist.sharding import make_forward_fn
    from eetq_tpu.surgery.tp_reshard import quantize_params_tp, shard_quantized

    if len(jax.devices()) < 2:
        pytest.skip("needs >= 2 devices")
    dense = random_dense_params(CFG13B_TINY, jax.random.PRNGKey(4), dtype=jnp.bfloat16)
    qp = quantize_params_tp(dense, CFG13B_TINY, tp=2)
    model = shard_quantized(qp, CFG13B_TINY, make_mesh(tp=2, dp=1))
    fwd = make_forward_fn(model)
    toks = jnp.asarray([[3, 5, 7, 9]], jnp.int32)
    pos = jnp.arange(4, dtype=jnp.int32)[None]
    caches = init_caches(CFG13B_TINY, 1, 32)
    logits_sh, _ = fwd(model.params, toks, pos, caches, jnp.int32(0))
    logits_1, _ = forward(qp, CFG13B_TINY, toks, pos,
                          init_caches(CFG13B_TINY, 1, 32), jnp.int32(0))
    np.testing.assert_allclose(
        np.asarray(logits_sh), np.asarray(logits_1), atol=0.05
    )
