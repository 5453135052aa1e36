"""Engine throughput benchmark: continuous-batching tok/s with staggered arrivals, vs the scanned decode_loop on the
same full batch; optional paged-KV A/B, sampled workload, and a Poisson
mixed-length served-traffic trace (the TGI/LoRAX behavior the reference
exists to serve, `/root/reference/README.md:88-101`).

The engine is host-driven, so host round-trips are PART of its real cost —
wall-clock is the honest metric here, unlike kernel benchmarks. The
multi-step decode window amortizes a round trip across decode_window
tokens per dispatch, and window CHAINING keeps the carry on device across
several windows when the batch is full.

Usage: python scripts/bench_engine.py
Env: EETQ_BENCH_PRESET (llama2-7b), EETQ_ENGINE_BATCH (4),
     EETQ_ENGINE_PROMPT (128), EETQ_ENGINE_NEW (64),
     EETQ_ENGINE_WINDOW (8), EETQ_ENGINE_REQUESTS (2*batch),
     EETQ_ENGINE_PAGED (0: dense; 1: paged-KV engine on the same workload),
     EETQ_ENGINE_TEMP (0: greedy; >0: every request samples at this
     temperature with top_k=40),
     EETQ_ENGINE_TRACE (0; 1 = Poisson mixed-length trace mode: prompts
     drawn lognormal in [32, bucketmax], exponential interarrival times,
     reports p50/p99 per-token latency — use with --preset mistral-7b for
     BASELINE config 4),
     EETQ_ENGINE_RATE (trace mode requests/sec; default sized to ~80%
     of the measured static-batch throughput),
     EETQ_ENGINE_A8 (0; 1 = W8A8 prefill — int8 tensor cores),
     EETQ_ENGINE_KV (bf16 | int8 KV cache),
     EETQ_ENGINE_SPEC (0; k>0 = n-gram SPECULATIVE decode windows with
     draft length k — greedy-exact, greedy workloads only)
Prints one JSON line with engine tok/s and the scanned-loop comparison.
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


def make_engine(params, cfg, batch, max_len, buckets, window, paged,
                temp):
    from eetq_tpu.serve.engine import Engine

    kw = {}
    spec = int(os.environ.get("EETQ_ENGINE_SPEC", 0))
    if spec:
        kw["spec_ngram"] = spec
    if paged:
        # pool sized for the workload's live tokens + window overshoot
        bs = min(256, -(-max_len // 128) * 128)
        blocks = 1 + batch * (-(-max_len // bs))
        kw.update(paged_blocks=blocks, paged_block_size=bs)
    # EETQ_ENGINE_A8=0/1 and EETQ_ENGINE_KV=bf16/int8 set W8A8 prefill
    # (dynamic int8 activations; decode stays W8A16) and the KV dtype
    # (unset = the engine default: off and bf16) — the A/B knobs.
    a8_env = os.environ.get("EETQ_ENGINE_A8")
    if a8_env is not None:
        kw["a8_prefill"] = a8_env == "1"
    kv_env = os.environ.get("EETQ_ENGINE_KV")
    if kv_env:
        kw["kv_dtype"] = {"bf16": jnp.bfloat16, "int8": jnp.int8}[kv_env]
    return Engine(
        params, cfg, max_batch=batch, max_len=max_len,
        prompt_buckets=buckets, decode_window=window,
        prefill_rows=min(4, batch), **kw,
    )


def run_staggered(params, cfg, prompts, batch, max_len, buckets, window,
                  new_tokens, paged, temp):
    """The staggered workload: half the requests up front, the rest fed as
    slots free up. Returns tok/s."""
    n_requests = len(prompts)
    skw = dict(temperature=temp, top_k=40 if temp > 0 else 0)

    def fresh():
        return make_engine(params, cfg, batch, max_len, buckets, window,
                           paged, temp)

    # warm compiles on BOTH decode paths (multi-window AND the single-step
    # used near admissions) plus prefill: a staggered mini-workload shaped
    # like the timed one
    eng = fresh()
    us = [eng.add_request(prompts[i], new_tokens, **skw)
          for i in range(batch)]
    for _ in range(2):
        eng.step()
    us.append(eng.add_request(prompts[0], new_tokens, **skw))
    eng.run()
    assert all(len(eng.result(u)) == new_tokens for u in us)

    eng2 = fresh()  # same compiles as warmup
    uids = [eng2.add_request(p, new_tokens, **skw) for p in prompts[:batch]]
    pending = list(prompts[batch:])
    t0 = time.perf_counter()
    steps = 0
    while eng2.has_work or pending:
        # "fed as slots free up": one pending request
        # per free slot. The old `steps % 2` cadence dated from the
        # window-1 era when a step was a constant ~30 ms unit; with window
        # CHAINING a step can retire a whole batch (64+ tokens), so an
        # every-other-step drip starved the tail down to batch 1-2 and
        # measured the arrival process, not the engine.
        while pending and len(eng2.queue) < eng2.free_slots:
            uids.append(eng2.add_request(pending.pop(0), new_tokens, **skw))
        eng2.step()
        steps += 1
    dt = time.perf_counter() - t0
    total = sum(len(eng2.result(u)) for u in uids)
    assert total == n_requests * new_tokens, (total,)
    return total / dt


def run_trace(params, cfg, batch, max_len, buckets, window, new_tokens,
              paged, temp, rate, n_requests, seed=0):
    """Served-traffic trace: Poisson arrivals, lognormal mixed prompt
    lengths. Returns (tok/s, p50 ms/token, p99 ms/token) where per-token
    latency = (completion - arrival) / tokens_generated per request."""
    rng = np.random.default_rng(seed)
    max_prompt = max(buckets)
    lens = np.clip(
        np.exp(rng.normal(np.log(max_prompt / 4), 0.8, n_requests)),
        32, max_prompt,
    ).astype(int)
    prompts = [list(rng.integers(1, cfg.vocab_size, size=int(n)))
               for n in lens]
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n_requests))
    skw = dict(temperature=temp, top_k=40 if temp > 0 else 0)

    # warm every bucket's prefill + all decode paths (compile cache is
    # process-global, so the fresh timed engine below reuses it)
    make_engine(params, cfg, batch, max_len, buckets, window, paged,
                temp).warmup(temperature=temp)

    eng = make_engine(params, cfg, batch, max_len, buckets, window, paged,
                      temp)
    t0 = time.perf_counter()
    submitted, done_t = {}, {}
    i = 0
    while i < n_requests or eng.has_work:
        now = time.perf_counter() - t0
        while i < n_requests and arrivals[i] <= now:
            uid = eng.add_request(prompts[i], new_tokens, **skw)
            submitted[uid] = arrivals[i]
            i += 1
        if not eng.has_work:
            if i < n_requests:  # idle until the next arrival
                time.sleep(max(0.0, arrivals[i] - (time.perf_counter() - t0)))
                continue
            break
        before = {u for u, r in eng.requests.items() if r.done}
        eng.step()
        now = time.perf_counter() - t0
        for u, r in eng.requests.items():
            if r.done and u not in before and u not in done_t:
                done_t[u] = now
    dt = time.perf_counter() - t0
    total = sum(len(r.out_tokens) for r in eng.requests.values())
    per_tok_ms = sorted(
        (done_t[u] - submitted[u]) / max(1, len(eng.requests[u].out_tokens))
        * 1e3
        for u in done_t
    )
    p50 = per_tok_ms[len(per_tok_ms) // 2]
    p99 = per_tok_ms[min(len(per_tok_ms) - 1,
                         int(len(per_tok_ms) * 0.99))]
    return total / dt, p50, p99


def main():
    from eetq_tpu.models import PRESETS, init_caches, random_quantized_params
    from eetq_tpu.serve.generate import decode_loop, prefill

    preset = os.environ.get("EETQ_BENCH_PRESET", "llama2-7b")
    batch = int(os.environ.get("EETQ_ENGINE_BATCH", 4))
    prompt_len = int(os.environ.get("EETQ_ENGINE_PROMPT", 128))
    new_tokens = int(os.environ.get("EETQ_ENGINE_NEW", 64))
    window = int(os.environ.get("EETQ_ENGINE_WINDOW", 8))
    n_requests = int(os.environ.get("EETQ_ENGINE_REQUESTS", 2 * batch))
    paged = bool(int(os.environ.get("EETQ_ENGINE_PAGED", 0)))
    temp = float(os.environ.get("EETQ_ENGINE_TEMP", 0.0))
    spec = int(os.environ.get("EETQ_ENGINE_SPEC", 0))
    if spec and temp > 0:
        raise SystemExit("EETQ_ENGINE_SPEC serves greedy workloads only")
    trace = bool(int(os.environ.get("EETQ_ENGINE_TRACE", 0)))
    cfg = PRESETS[preset]
    max_len = prompt_len + new_tokens + 8

    log(f"engine bench: {preset} max_batch={batch} prompt={prompt_len} "
        f"new={new_tokens} window={window} requests={n_requests} "
        f"paged={paged} temp={temp} trace={trace}")
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("bench_engine.py needs a GPU")
    params = random_quantized_params(cfg, 0)
    rng = np.random.default_rng(0)

    if trace:
        buckets = tuple(
            b for b in (32, 64, 128, 256, 512, 1024) if b <= prompt_len
        ) or (prompt_len,)
        maxl = max(buckets) + new_tokens + 8
        rate = os.environ.get("EETQ_ENGINE_RATE")
        rate = float(rate) if rate else batch * 2.0 / (new_tokens * 0.012)
        tok_s, p50, p99 = run_trace(
            params, cfg, batch, maxl, buckets, window, new_tokens, paged,
            temp, rate, n_requests,
        )
        print(json.dumps({
            "metric": f"{preset}_engine_trace_tok_s_b{batch}",
            "value": round(tok_s, 2),
            "unit": "tok/s",
            "arrival_rate_rps": round(rate, 3),
            "p50_ms_per_token": round(p50, 2),
            "p99_ms_per_token": round(p99, 2),
            "paged": paged,
            "temperature": temp,
            "a8_prefill": bool(int(os.environ.get("EETQ_ENGINE_A8", 0))),
        }))
        return

    prompts = [
        list(rng.integers(1, cfg.vocab_size, size=prompt_len))
        for _ in range(n_requests)
    ]

    # --- static-batching reference: the same n_requests served as
    # consecutive full batches through prefill + the scanned decode loop
    # (prefill time INCLUDED — the engine pays it too) ---
    def static_batch(i0):
        prompt_arr = jnp.asarray(np.stack(prompts[i0 : i0 + batch]), jnp.int32)
        caches = init_caches(cfg, batch, max_len)
        logits, caches = prefill(params, cfg, prompt_arr, caches)
        token = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        toks, _ = decode_loop(params, cfg, token, jnp.int32(prompt_len),
                              caches, new_tokens)
        return toks

    np.asarray(static_batch(0))  # compile + warm
    n_batches = n_requests // batch
    t0 = time.perf_counter()
    for bi in range(n_batches):
        np.asarray(static_batch(bi * batch))
    loop_s = time.perf_counter() - t0
    loop_tok_s = n_requests * new_tokens / loop_s
    log(f"static batches (prefill + scanned loop): {loop_tok_s:.1f} tok/s")

    buckets = (prompt_len,)
    eng_tok_s = run_staggered(params, cfg, prompts, batch, max_len, buckets,
                              window, new_tokens, paged, temp)
    log(f"engine (window={window}, paged={paged}): {eng_tok_s:.1f} tok/s")
    eng1_tok_s = run_staggered(params, cfg, prompts, batch, max_len, buckets,
                               1, new_tokens, paged, temp)
    log(f"engine (window=1):      {eng1_tok_s:.1f} tok/s")

    print(json.dumps({
        "metric": f"{preset}_engine_tok_s_b{batch}_w{window}"
                  + ("_paged" if paged else "")
                  + (f"_t{temp}" if temp > 0 else "")
                  + (f"_spec{spec}" if spec else ""),
        "value": round(eng_tok_s, 2),
        "unit": "tok/s",
        "engine_window1_tok_s": round(eng1_tok_s, 2),
        "static_batching_tok_s": round(loop_tok_s, 2),
        "engine_vs_loop": round(eng_tok_s / loop_tok_s, 4),
        "paged": paged,
        "temperature": temp,
        "a8_prefill": bool(int(os.environ.get("EETQ_ENGINE_A8", 0))),
        "spec_ngram": spec or None,
        "feed_policy": "per_free_slot",
        "device": jax.devices()[0].device_kind,
    }))


if __name__ == "__main__":
    main()
