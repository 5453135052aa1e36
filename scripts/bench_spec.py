"""Speculative decoding benchmark (one GPU): target W8A16 llama2-7b, drafts
from (a) the W4A16 quantization of the SAME weights and (b) n-gram
prompt lookup — vs the plain single-dispatch decode loop, in one process.

Weights are random (made from a seed), so ACCEPTANCE RATES here
characterize the random-weight model's own greedy continuations, not
natural-language drafting quality — they are reported alongside every
throughput number, plus the analytic tokens/round -> tok/s curve so the
expected speedup at any real-model acceptance rate is inspectable:

  spec tok/s = (1 + E[a]) / (k * t_draft + t_verify)
  where t_verify ~= t_decode (the verify rides the same m<=8 decode regime).

Usage: python scripts/bench_spec.py
Env: EETQ_BENCH_PROMPT (1024), EETQ_SPEC_NEW_TOKENS (128),
     EETQ_SPEC_K (comma list, default "3,7"), EETQ_AB_REPS (4)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    from eetq_tpu.models import PRESETS, init_caches, random_quantized_params
    from eetq_tpu.serve.generate import decode_loop, prefill
    from eetq_tpu.serve.spec import ngram_spec_decode_loop, spec_decode_loop

    preset = os.environ.get("EETQ_BENCH_PRESET", "llama2-7b")
    prompt_len = int(os.environ.get("EETQ_BENCH_PROMPT", 1024))
    new_tokens = int(os.environ.get("EETQ_SPEC_NEW_TOKENS", 128))
    ks = [int(x) for x in os.environ.get("EETQ_SPEC_K", "3,7").split(",")]
    reps = int(os.environ.get("EETQ_AB_REPS", 4))
    cfg = PRESETS[preset]
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("bench_spec.py needs a GPU")
    print(f"{preset} prompt={prompt_len} new={new_tokens} ks={ks}",
          file=sys.stderr)

    print("building W8A16 target...", file=sys.stderr)
    target = random_quantized_params(cfg, 0, bits=8)
    print("building W4A16 draft (same weights)...", file=sys.stderr)
    draft = random_quantized_params(cfg, 0, bits=4)

    prompt = jnp.ones((1, prompt_len), jnp.int32)
    kmax = max(ks)
    max_len = prompt_len + new_tokens + 2 * kmax + 1

    def prefilled(params):
        caches = init_caches(cfg, 1, max_len)
        logits, caches = prefill(params, cfg, prompt, caches)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        return tok, caches

    rows = []

    def timeit(fn, label, prep=None):
        """Time fn(*prep()) with the prefill excluded: prep() runs and
        finishes (block_until_ready) before the clock starts."""
        def run():
            args = ()
            if prep is not None:
                args = jax.block_until_ready(prep())
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn(*args))
            return time.perf_counter() - t0, out

        # warm (compile)
        t0 = time.perf_counter()
        dt, out = run()
        print(f"  {label}: compile+first {time.perf_counter()-t0:.1f}s",
              file=sys.stderr)
        best, best_out = float("inf"), out
        for _ in range(reps):
            dt, out = run()
            if dt < best:
                best, best_out = dt, out
        return best, best_out

    # ---- baseline: plain scanned decode loop ----
    def base(tok, caches):
        toks, _ = decode_loop(target, cfg, tok, jnp.int32(prompt_len), caches,
                              new_tokens)
        return (toks,)

    base_s, _ = timeit(base, "decode_loop", prep=lambda: prefilled(target))
    base_toks = (new_tokens - 1) / base_s
    rows.append({"metric": f"{preset}_spec_baseline_tok_s", "value":
                 round(base_toks, 2), "unit": "tok/s",
                 "ms_per_tok": round(1e3 * base_s / (new_tokens - 1), 3)})
    print(f"baseline decode_loop: {base_toks:.2f} tok/s", file=sys.stderr)

    # ---- draft-model spec at each k ----
    for k in ks:
        def spec_prep():
            tok, t_caches = prefilled(target)
            _, d_caches = prefilled(draft)
            return tok, t_caches, d_caches

        def spec(tok, t_caches, d_caches):
            toks, stats = spec_decode_loop(
                target, draft, cfg, cfg, tok, prompt[:, -1],
                prompt_len, t_caches, d_caches, new_tokens, k=k,
            )
            return toks, stats

        spec_s, (toks, stats) = timeit(spec, f"spec k={k}", prep=spec_prep)
        rounds, acc = int(stats[0]), int(stats[1])
        tok_s = (new_tokens - 1) / spec_s
        row = {
            "metric": f"{preset}_spec_w4draft_tok_s_k{k}",
            "value": round(tok_s, 2), "unit": "tok/s",
            "rounds": rounds, "accepted_drafts": acc,
            "accept_per_round": round(acc / max(rounds, 1), 3),
            "tokens_per_round": round((new_tokens - 1) / max(rounds, 1), 3),
            "vs_plain_decode": round(tok_s / base_toks, 4),
        }
        rows.append(row)
        print(f"spec w4-draft k={k}: {tok_s:.2f} tok/s "
              f"({row['tokens_per_round']} tok/round, "
              f"accept {row['accept_per_round']}/{k})", file=sys.stderr)

    # ---- n-gram prompt-lookup spec: worst case (uniform prompt can only
    # help it; label honestly) and a random prompt ----
    rng = np.random.default_rng(0)
    rand_prompt = jnp.asarray(
        rng.integers(100, cfg.vocab_size - 100, size=(1, prompt_len)),
        jnp.int32,
    )
    for k in ks:
        for pname, p in (("rand", rand_prompt),):
            def ngram_prep(p=p):
                caches = init_caches(cfg, 1, max_len)
                logits, caches = prefill(target, cfg, p, caches)
                tok = jnp.argmax(logits, -1).astype(jnp.int32)
                return tok, caches

            def ngram(tok, caches, p=p, k=k):
                toks, stats = ngram_spec_decode_loop(
                    target, cfg, p, tok, prompt_len, caches, new_tokens, k=k,
                )
                return toks, stats

            spec_s, (toks, stats) = timeit(
                ngram, f"ngram k={k} {pname}", prep=ngram_prep
            )
            rounds, acc = int(stats[0]), int(stats[1])
            tok_s = (new_tokens - 1) / spec_s
            row = {
                "metric": f"{preset}_spec_ngram_tok_s_k{k}_{pname}",
                "value": round(tok_s, 2), "unit": "tok/s",
                "rounds": rounds, "accepted_drafts": acc,
                "tokens_per_round": round((new_tokens - 1) / max(rounds, 1), 3),
                "vs_plain_decode": round(tok_s / base_toks, 4),
            }
            rows.append(row)
            print(f"ngram k={k} {pname}: {tok_s:.2f} tok/s "
                  f"({row['tokens_per_round']} tok/round)", file=sys.stderr)

    for r in rows:
        print(json.dumps(r))


if __name__ == "__main__":
    main()
