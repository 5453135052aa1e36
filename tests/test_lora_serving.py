"""LoRA serving: the continuous-batching Engine runs a
quantized model with LoraAdapter side paths attached (the LoRAX use-case
the reference's W8A16LoraLinear exists for, `modules/qlinear.py:127-186`),
and merge_lora mirrors the reference's merge-and-unload-then-quantize flow
(`examples/models/llama_transformers_example.py:164-197`)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eetq_tpu.models import ModelConfig, quantize_params, random_dense_params
from eetq_tpu.serve.engine import Engine
from eetq_tpu.serve.generate import greedy_generate
from eetq_tpu.surgery import attach_lora, merge_lora

CFG = ModelConfig(
    vocab_size=128, hidden_size=64, intermediate_size=128, num_layers=2,
    num_heads=4, num_kv_heads=2, head_dim=16, max_position=128,
)


@pytest.fixture(scope="module")
def qparams():
    return quantize_params(
        random_dense_params(CFG, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    )


def _trained(params, seed=7, scale=0.2):
    """Adapters with random non-zero B (a stand-in for finetuned weights)."""
    withl = attach_lora(params, rank=4, key=jax.random.PRNGKey(seed))
    layers = []
    keys = iter(jax.random.split(jax.random.PRNGKey(seed + 1),
                                 2 * len(withl.layers)))
    for lp in withl.layers:
        def bump(ad):
            return dataclasses.replace(
                ad,
                lora_b=scale * jax.random.normal(
                    next(keys), ad.lora_b.shape, jnp.float32
                ).astype(ad.lora_b.dtype),
            )
        layers.append(dataclasses.replace(
            lp, qkv_lora=bump(lp.qkv_lora), o_lora=bump(lp.o_lora)
        ))
    return dataclasses.replace(withl, layers=layers)


def test_fresh_adapters_are_noop(qparams):
    """attach_lora with B=0 must not change generation at all."""
    withl = attach_lora(qparams, rank=4, key=jax.random.PRNGKey(1))
    prompt = jnp.asarray([[3, 5, 7]], jnp.int32)
    base = greedy_generate(qparams, CFG, prompt, 6)
    lora = greedy_generate(withl, CFG, prompt, 6)
    np.testing.assert_array_equal(np.asarray(base), np.asarray(lora))


def test_engine_serves_lora_model(qparams):
    """THE serving test: the Engine decodes through the adapter side paths
    (prefill + windowed decode) and matches standalone generate on the
    same adapted params."""
    adapted = _trained(qparams)
    prompts = [[3, 5, 7], [11] * 9, [2, 4]]
    refs = [
        [int(t) for t in greedy_generate(adapted, CFG, jnp.asarray(p)[None], 6)[0]]
        for p in prompts
    ]
    # adapters must actually change behavior vs the base model
    base = [int(t) for t in greedy_generate(qparams, CFG,
                                            jnp.asarray(prompts[0])[None], 6)[0]]
    assert base != refs[0]

    eng = Engine(adapted, CFG, max_batch=2, max_len=64, prompt_buckets=(16,),
                 decode_window=4)
    uids = [eng.add_request(p, 6) for p in prompts]
    eng.run()
    for u, ref in zip(uids, refs):
        assert eng.result(u) == ref


def test_merge_lora_matches_adapter_model(qparams):
    """merge-then-quantize: folding adapters into the int8 base weights
    reproduces the side-path model's logits up to requantization error,
    and leaves no adapters behind (full quantized-GEMM serving speed)."""
    from eetq_tpu.models.transformer import forward
    from eetq_tpu.modules.linear import QuantLinear

    adapted = _trained(qparams)
    merged = merge_lora(adapted)
    assert all(
        lp.qkv_lora is None and lp.o_lora is None for lp in merged.layers
    )
    assert all(isinstance(lp.qkv, QuantLinear) for lp in merged.layers)

    toks = jnp.asarray([[3, 5, 7, 11, 2]], jnp.int32)
    pos = jnp.arange(5, dtype=jnp.int32)[None]
    la, _ = forward(adapted, CFG, toks, pos, None, jnp.int32(0))
    lm, _ = forward(merged, CFG, toks, pos, None, jnp.int32(0))
    la, lm = np.asarray(la), np.asarray(lm)
    # requantization of (W + AB) vs side-path: small quantization-level gap
    assert np.abs(la - lm).mean() < 0.05
    assert (la.argmax(-1) == lm.argmax(-1)).mean() > 0.9


@pytest.mark.parametrize("bits,g", [(8, 32), (4, 32)])
def test_merge_lora_groupwise_base(bits, g):
    """merge_lora over GROUP-WISE (incl. int4 / W4A16) bases — the repo's
    first-class serving mode (r5; was a per-channel-only raise). The merge
    dequantizes with the [G, N] scale rows, folds the delta, and
    requantizes at the SAME bits/group_size."""
    from eetq_tpu.models.transformer import forward
    from eetq_tpu.modules.linear import QuantLinear

    qp = quantize_params(
        random_dense_params(CFG, jax.random.PRNGKey(0), dtype=jnp.bfloat16),
        bits=bits, group_size=g,
    )
    adapted = _trained(qp)
    merged = merge_lora(adapted)
    assert all(
        lp.qkv_lora is None and lp.o_lora is None for lp in merged.layers
    )
    for lp in merged.layers:
        assert isinstance(lp.qkv, QuantLinear)
        assert lp.qkv.qweight.bits == bits
        assert lp.qkv.scales.ndim == 2  # group rows preserved
        assert lp.qkv.scales.shape[0] == CFG.hidden_size // g

    # weight-space exactness: dequant(merged) must equal
    # dequant(base) + A@B*scaling to within ONE QUANT STEP per group
    # (scale = absmax/2^(b-1), the reference convention — the absmax
    # element itself quantizes to 2^(b-1) and clips to 2^(b-1)-1, a full
    # step of error; everything else is within half a step)
    from eetq_tpu.layout import unpack_weights

    lp_a, lp_m = adapted.layers[0], merged.layers[0]
    ad = lp_a.qkv_lora
    delta = np.asarray(
        ad.lora_a.astype(jnp.float32) @ ad.lora_b.astype(jnp.float32)
    ) * ad.scaling
    deq = lambda ql: np.asarray(unpack_weights(ql.qweight), np.float32) * (
        np.repeat(np.asarray(ql.scales, np.float32), g, axis=0)
    )
    want = deq(lp_a.qkv) + delta
    got = deq(lp_m.qkv)
    step = np.repeat(np.asarray(lp_m.qkv.scales, np.float32), g, axis=0)
    assert (np.abs(got - want) <= 1.01 * step + 1e-5).all()

    toks = jnp.asarray([[3, 5, 7, 11, 2]], jnp.int32)
    pos = jnp.arange(5, dtype=jnp.int32)[None]
    la, _ = forward(adapted, CFG, toks, pos, None, jnp.int32(0))
    lm, _ = forward(merged, CFG, toks, pos, None, jnp.int32(0))
    la, lm = np.asarray(la), np.asarray(lm)
    # requantization noise scales with the quant step: 2^(8-bits) coarser
    # levels for int4. The weight-space bound above is the exactness
    # assertion; the logits checks only guard against gross breakage —
    # random tiny-model logits are near-tied, so int4-step noise flips
    # argmax often without any merge bug (real models have margins).
    bound = 0.08 if bits == 8 else 0.25
    assert np.abs(la - lm).mean() < bound, np.abs(la - lm).mean()
    agree_floor = 0.9 if bits == 8 else 0.4
    assert (la.argmax(-1) == lm.argmax(-1)).mean() > agree_floor


def test_merge_lora_dense_base():
    dense = random_dense_params(CFG, jax.random.PRNGKey(2), jnp.bfloat16)
    adapted = _trained(dense)
    merged = merge_lora(adapted)
    from eetq_tpu.models.transformer import forward

    toks = jnp.asarray([[1, 2, 3]], jnp.int32)
    pos = jnp.arange(3, dtype=jnp.int32)[None]
    la, _ = forward(adapted, CFG, toks, pos, None, jnp.int32(0))
    lm, _ = forward(merged, CFG, toks, pos, None, jnp.int32(0))
    la, lm = np.asarray(la), np.asarray(lm)
    # merged weight is one bf16 rounding; the side path rounds base GEMM
    # and delta GEMM separately — per-layer bf16 jitter compounds
    assert np.abs(la - lm).mean() < 0.05
    assert (la.argmax(-1) == lm.argmax(-1)).mean() > 0.9
