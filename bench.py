"""Headline benchmark: W8A16 decode throughput vs bf16 on one NVIDIA GPU.

Mirrors the reference's benchmark config (`README.md:109-113`: llama-13b,
prompt=1024, max_new_tokens=50, batch sweep) at Llama-2-7B, batch 1 by
default. Weights are random, made from a seed directly on the device —
the same compute and bandwidth profile as real checkpoints.

Prints ONE JSON line to stdout:
  {"metric": ..., "value": N, "unit": "tok/s", "vs_bf16": N, "device": {...}}

Env knobs: EETQ_BENCH_PRESET (default llama2-7b), EETQ_BENCH_PROMPT (1024),
EETQ_BENCH_NEW_TOKENS (50), EETQ_BENCH_BATCH (1), EETQ_BENCH_BITS (8),
EETQ_BENCH_SKIP_BF16, EETQ_BENCH_QUANT_LMHEAD (1), EETQ_BENCH_KV (bf16 |
int8, quantized run only), EETQ_BENCH_PREFILL_CHUNK (0 = whole prompt),
EETQ_BENCH_REPS (5).
"""

import gc
import json
import os
import sys
import time

import jax
import jax.numpy as jnp

from eetq_tpu.models import (
    PRESETS,
    init_caches,
    random_dense_params,
    random_quantized_params,
)
from eetq_tpu.serve.generate import decode_loop, prefill, prefill_chunked
from eetq_tpu.utils.compile_cache import enable_compile_cache


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def bench_decode(params, cfg, batch, prompt_len, new_tokens, kv_dtype) -> dict:
    """Prefill time and scanned-decode throughput, each timed on the host
    clock around work that ends in block_until_ready."""
    max_len = prompt_len + new_tokens
    prompt = jnp.ones((batch, prompt_len), jnp.int32)
    chunk = int(os.environ.get("EETQ_BENCH_PREFILL_CHUNK", 0))

    def do_prefill():
        caches = init_caches(cfg, batch, max_len, dtype=kv_dtype)
        if chunk:
            return prefill_chunked(params, cfg, prompt, caches, chunk=chunk)
        return prefill(params, cfg, prompt, caches)

    t0 = time.perf_counter()
    logits, caches = jax.block_until_ready(do_prefill())
    token = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    jax.block_until_ready(decode_loop(params, cfg, token, jnp.int32(prompt_len),
                                      caches, new_tokens))
    log(f"  compile + first run: {time.perf_counter() - t0:.1f} s")

    reps = int(os.environ.get("EETQ_BENCH_REPS", 5))
    prefill_s = decode_s = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        logits, caches = jax.block_until_ready(do_prefill())
        prefill_s = min(prefill_s, time.perf_counter() - t0)
        token = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        t0 = time.perf_counter()
        jax.block_until_ready(decode_loop(
            params, cfg, token, jnp.int32(prompt_len), caches, new_tokens))
        decode_s = min(decode_s, time.perf_counter() - t0)
        del logits, caches
    steps = new_tokens - 1  # the first token came from the prefill
    return {
        "prefill_s": prefill_s,
        "decode_tok_s": batch * steps / decode_s,
        "ms_per_step": 1e3 * decode_s / steps,
    }


def main():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform}")
    log(f"compile cache: {enable_compile_cache()}")
    preset = os.environ.get("EETQ_BENCH_PRESET", "llama2-7b")
    bits = int(os.environ.get("EETQ_BENCH_BITS", 8))
    prompt_len = int(os.environ.get("EETQ_BENCH_PROMPT", 1024))
    new_tokens = int(os.environ.get("EETQ_BENCH_NEW_TOKENS", 50))
    batch = int(os.environ.get("EETQ_BENCH_BATCH", 1))
    kv = os.environ.get("EETQ_BENCH_KV", "bf16")
    cfg = PRESETS[preset]
    log(f"bench: {preset} batch={batch} prompt={prompt_len} new={new_tokens} "
        f"on {dev.device_kind} x{len(jax.devices())}")

    r_bf16 = None
    if not os.environ.get("EETQ_BENCH_SKIP_BF16"):
        dense = random_dense_params(cfg, jax.random.PRNGKey(0))
        r_bf16 = bench_decode(dense, cfg, batch, prompt_len, new_tokens,
                              jnp.bfloat16)
        log(f"bf16:  {r_bf16}")
        del dense
        gc.collect()

    quant = random_quantized_params(
        cfg, 0, bits=bits,
        quantize_lm_head=os.environ.get("EETQ_BENCH_QUANT_LMHEAD", "1") != "0",
    )
    kv_dtype = {"bf16": jnp.bfloat16, "int8": jnp.int8}[kv]
    r_q = bench_decode(quant, cfg, batch, prompt_len, new_tokens, kv_dtype)
    log(f"w{bits}a16: {r_q}")

    result = {
        "metric": f"{preset}_w{bits}a16_decode_tok_s_b{batch}_p{prompt_len}",
        "value": r_q["decode_tok_s"],
        "unit": "tok/s",
        "ms_per_step": r_q["ms_per_step"],
        "prefill_s": r_q["prefill_s"],
        "kv": kv,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    if r_bf16 is not None:
        result["vs_bf16"] = r_q["decode_tok_s"] / r_bf16["decode_tok_s"]
    print(json.dumps(result))


if __name__ == "__main__":
    main()
