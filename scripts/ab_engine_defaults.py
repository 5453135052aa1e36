"""Interleaved same-process A/B of the serving defaults that are still
open on the GPU: engine decode with int8 KV caches and W8A8 prefill, each
against the bf16 default, on the SAME staggered continuous-batching
workload in ONE process (the engine is host-driven, so wall-clock is the
honest metric).

Writes one JSON line per variant to stdout and to
chiprun_out/engine_defaults.jsonl.

Usage: python scripts/ab_engine_defaults.py
Env: EETQ_BENCH_PRESET (llama2-7b), EETQ_ENGINE_BATCH (4),
     EETQ_ENGINE_PROMPT (128), EETQ_ENGINE_NEW (64),
     EETQ_ENGINE_WINDOW (8), EETQ_AB_REPS (3)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    from eetq_tpu.models import PRESETS, random_quantized_params
    from eetq_tpu.serve.engine import Engine

    preset = os.environ.get("EETQ_BENCH_PRESET", "llama2-7b")
    batch = int(os.environ.get("EETQ_ENGINE_BATCH", 4))
    prompt_len = int(os.environ.get("EETQ_ENGINE_PROMPT", 128))
    new_tokens = int(os.environ.get("EETQ_ENGINE_NEW", 64))
    window = int(os.environ.get("EETQ_ENGINE_WINDOW", 8))
    reps = int(os.environ.get("EETQ_AB_REPS", 3))
    cfg = PRESETS[preset]
    params = random_quantized_params(cfg, 0)
    max_len = prompt_len + new_tokens + 8
    n_req = 2 * batch
    rng = np.random.default_rng(0)
    prompts = [
        list(rng.integers(1, cfg.vocab_size, size=prompt_len))
        for _ in range(n_req)
    ]

    variants = {
        "base_bf16kv_noa8": dict(kv_dtype=jnp.bfloat16, a8_prefill=False),
        "int8kv": dict(kv_dtype=jnp.int8, a8_prefill=False),
        "a8_prefill": dict(kv_dtype=jnp.bfloat16, a8_prefill=True),
        "int8kv+a8": dict(kv_dtype=jnp.int8, a8_prefill=True),
    }

    def run(kw):
        eng = Engine(params, cfg, max_batch=batch, max_len=max_len,
                     prompt_buckets=(prompt_len,), decode_window=window,
                     prefill_rows=1, **kw)
        t0 = time.perf_counter()
        uids = []
        fed = 0
        while fed < n_req or eng.has_work:
            while fed < n_req and eng.free_slots > 0:
                uids.append(eng.add_request(prompts[fed], new_tokens))
                fed += 1
            eng.step()
        dt = time.perf_counter() - t0
        toks = sum(len(eng.result(u)) for u in uids)
        return toks / dt, [eng.result(u) for u in uids]

    # compile pass + greedy-parity check across variants
    outs0 = None
    for name, kw in variants.items():
        t0 = time.perf_counter()
        _, outs = run(kw)
        log(f"compile {name}: {time.perf_counter() - t0:.1f}s")
        if outs0 is None:
            outs0 = outs
        else:
            agree = np.mean([
                x == y for a, b in zip(outs, outs0) for x, y in zip(a, b)
            ])
            log(f"  token agreement vs base: {agree:.3f}")

    times = {k: [] for k in variants}
    for r in range(reps):
        for name, kw in variants.items():
            tps, _ = run(kw)
            times[name].append(tps)
            log(f"rep {r} {name}: {tps:.1f} tok/s")

    os.makedirs("chiprun_out", exist_ok=True)
    out_path = os.path.join("chiprun_out", "engine_defaults.jsonl")
    with open(out_path, "a") as f:
        for name in variants:
            best = max(times[name])
            row = {
                "ab": "engine_defaults", "variant": name,
                "engine_tok_s_best": round(best, 1),
                "all": [round(t, 1) for t in times[name]],
                "preset": preset, "batch": batch, "prompt": prompt_len,
                "new": new_tokens, "window": window, "reps": reps,
                "device": jax.devices()[0].device_kind,
            }
            f.write(json.dumps(row) + "\n")
            print(json.dumps(row))


if __name__ == "__main__":
    main()
