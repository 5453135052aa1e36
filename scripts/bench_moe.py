"""MoE decode benchmark: truncated Mixtral-8x7B W8A16 on one GPU.

Benches TRUNCATED-layer models at the REAL per-layer dims (4096 hidden,
8 experts x 14336 intermediate, top-2, GQA 32q/8kv). Decode gathers only
the SELECTED experts' int8 slices (k/E of the bank); the routed-bytes
roofline for L layers at batch 1 is
    t = (L * (qkv + o + kv_read + k * (gateup_e + down_e)) + lm_head) / BW
and the all-experts figure is printed beside it. Prefill (best-of-reps)
takes the routed ragged-dot path over expert-sorted tokens.

Env: EETQ_MOE_LAYERS (default 4), EETQ_MOE_PROMPT (1024),
EETQ_MOE_NEW_TOKENS (50), EETQ_MOE_REPS (4), EETQ_MOE_BITS (8).
"""

import dataclasses
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from bench import bench_decode, log
from eetq_tpu.models.config import MIXTRAL_8X7B
from eetq_tpu.models.transformer import LayerParams, ModelParams
from eetq_tpu.modules.linear import DenseLinear, quantize_linear
from eetq_tpu.modules.moe import MoEMLP, quantize_moe
from eetq_tpu.utils.profiling import chip_peaks


def _gen_moe_layer(cfg, key, bits: int) -> LayerParams:
    ks = jax.random.split(key, 5)
    h = cfg.hidden_size

    def lin(k, kin, kout):
        w = jax.random.normal(k, (kin, kout), jnp.bfloat16) * (kin**-0.5)
        ql = quantize_linear(w, bits=bits)
        jax.block_until_ready(ql.qweight.data)
        return ql

    def expert_bank(kin, kout, keys):
        parts = []
        for j in range(cfg.num_experts):
            w = jax.random.normal(keys[j], (1, kin, kout), jnp.bfloat16)
            parts.append(w * (kin**-0.5))
        return DenseLinear(weight=jnp.concatenate(parts, axis=0))

    moe_dense = MoEMLP(
        router=DenseLinear(
            weight=jax.random.normal(ks[0], (h, cfg.num_experts), jnp.bfloat16)
            * 0.02
        ),
        gateup=expert_bank(
            h, 2 * cfg.intermediate_size, jax.random.split(ks[3], cfg.num_experts)
        ),
        down=expert_bank(
            cfg.intermediate_size, h, jax.random.split(ks[4], cfg.num_experts)
        ),
    )
    moe = quantize_moe(moe_dense, bits=bits)
    jax.block_until_ready(moe.gateup.qweight.data)
    del moe_dense
    gc.collect()
    return LayerParams(
        input_norm=jnp.ones((h,), jnp.float32),
        qkv=lin(ks[1], h, cfg.qkv_out),
        o_proj=lin(ks[2], cfg.num_heads * cfg.head_dim, h),
        post_norm=jnp.ones((h,), jnp.float32),
        gateup=None,
        down=None,
        moe=moe,
    )


def build_moe_params(cfg, bits: int) -> ModelParams:
    keys = jax.random.split(jax.random.PRNGKey(0), cfg.num_layers + 2)
    layers = []
    for i in range(cfg.num_layers):
        layers.append(_gen_moe_layer(cfg, keys[i], bits))
        log(f"  layer {i + 1}/{cfg.num_layers} built")
    embed = (
        jax.random.normal(keys[-2], (cfg.vocab_size, cfg.hidden_size),
                          jnp.bfloat16) * 0.02
    )
    lm_w = jax.random.normal(
        keys[-1], (cfg.hidden_size, cfg.vocab_size), jnp.bfloat16
    ) * (cfg.hidden_size**-0.5)
    return ModelParams(
        embed=embed,
        layers=layers,
        final_norm=jnp.ones((cfg.hidden_size,), jnp.float32),
        lm_head=quantize_linear(lm_w.astype(jnp.float32), bits=bits),
    )


def roofline_ms(cfg, prompt_len: int, routed: bool, bits: int) -> float:
    """Bandwidth floor per decode step (batch 1) in ms."""
    h, i, e, k = (
        cfg.hidden_size, cfg.intermediate_size, cfg.num_experts,
        cfg.num_experts_per_tok,
    )
    wbytes = bits / 8
    per_expert = (h * 2 * i + i * h) * wbytes
    experts = (k if routed else e) * per_expert
    qkv = h * cfg.qkv_out * wbytes
    o = cfg.num_heads * cfg.head_dim * h * wbytes
    kv = 2 * cfg.num_kv_heads * cfg.head_dim * prompt_len * 2  # bf16
    lm_head = h * cfg.vocab_size * wbytes
    total = cfg.num_layers * (qkv + o + kv + experts) + lm_head
    return 1e3 * total / (chip_peaks().hbm_gbs * 1e9)


def main():
    layers = int(os.environ.get("EETQ_MOE_LAYERS", 4))
    prompt_len = int(os.environ.get("EETQ_MOE_PROMPT", 1024))
    new_tokens = int(os.environ.get("EETQ_MOE_NEW_TOKENS", 50))
    bits = int(os.environ.get("EETQ_MOE_BITS", 8))
    os.environ.setdefault("EETQ_BENCH_REPS", os.environ.get("EETQ_MOE_REPS", "4"))

    cfg = dataclasses.replace(MIXTRAL_8X7B, num_layers=layers)
    log(
        f"bench_moe: mixtral-8x7b[{layers} layers] W{bits}A16 b=1 "
        f"prompt={prompt_len} new={new_tokens} on {jax.devices()}"
    )

    t0 = time.time()
    params = build_moe_params(cfg, bits)
    log(f"  built in {time.time() - t0:.1f}s")

    # --- prefill (routed ragged-dot path) ---
    from eetq_tpu.models.transformer import init_caches
    from eetq_tpu.serve.generate import prefill

    prompt = jnp.ones((1, prompt_len), jnp.int32)
    reps = int(os.environ["EETQ_BENCH_REPS"])
    logits, _c = prefill(
        params, cfg, prompt, init_caches(cfg, 1, prompt_len + new_tokens)
    )
    jax.block_until_ready(logits)  # compile + warmup
    del logits, _c
    gc.collect()
    prefill_s = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        logits, _c = prefill(
            params, cfg, prompt, init_caches(cfg, 1, prompt_len + new_tokens)
        )
        jax.block_until_ready(logits)
        prefill_s = min(prefill_s, time.perf_counter() - t0)
        del logits, _c
        gc.collect()
    log(f"prefill: {prefill_s * 1e3:.1f} ms best-of-{reps}")

    res = bench_decode(params, cfg, 1, prompt_len, new_tokens, jnp.bfloat16)
    routed_floor = roofline_ms(cfg, prompt_len, routed=True, bits=bits)
    all_floor = roofline_ms(cfg, prompt_len, routed=False, bits=bits)
    log(
        f"measured {res['ms_per_step']} ms/step; routed-bytes floor "
        f"{routed_floor:.2f} ms, all-experts floor {all_floor:.2f} ms"
    )
    print(json.dumps({
        "metric": f"mixtral8x7b_L{layers}_w{bits}a16_decode_tok_s_b1_p{prompt_len}",
        "value": res["decode_tok_s"],
        "unit": "tok/s",
        "ms_per_step": res["ms_per_step"],
        "routed_floor_ms": round(routed_floor, 2),
        "all_experts_floor_ms": round(all_floor, 2),
        "prefill_ms": prefill_s * 1e3,
        "reps": int(os.environ["EETQ_BENCH_REPS"]),
    }))


if __name__ == "__main__":
    main()
