"""Batch sweep mirroring the reference's published chart
(`README.md:109-113`: llama-13b on 3090, prompt=1024, max_new_tokens=50,
batch 1/2/4) — on one NVIDIA GPU, W8A16 and W4A16 vs bf16. One bench.py
process per cell, run one after another (this parent stays off JAX, so
each child has the card to itself).

Run from the repo root:
  python scripts/bench_sweep.py                 # llama2-7b, batches 1/2/4
  EETQ_SWEEP_PRESET=llama2-13b \
  EETQ_SWEEP_BATCHES=1,2,4,8,16 python scripts/bench_sweep.py
    # the reference's published chart shape — 13B at prompt=1024 swept to
    # the card's memory limit
Writes a markdown table to stdout, one bench JSON line per cell to stderr.
"""

import ast
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(__file__), "..")


def run(preset: str, batch: int, bits: int | None,
        skip_bf16: bool = False) -> dict | None:
    env = dict(os.environ, EETQ_BENCH_PRESET=preset,
               EETQ_BENCH_BATCH=str(batch))
    if bits is not None:
        env["EETQ_BENCH_BITS"] = str(bits)
    if skip_bf16:
        env["EETQ_BENCH_SKIP_BF16"] = "1"
    out = subprocess.run(
        [sys.executable, "bench.py"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=2400,
    )
    lines = [l for l in out.stdout.splitlines() if l.startswith("{")]
    if not lines:
        err = out.stderr[-2000:]
        # XLA reports OOM several ways: RESOURCE_EXHAUSTED, "out of
        # memory", or (when buffer assignment fails at compile time) an
        # "Allocation type: HLO temp" buffer dump.
        oom_marks = ("RESOURCE_EXHAUSTED", "out of memory",
                     "Allocation type:", "exceeds the limit")
        if any(m in out.stderr or m.lower() in err.lower() for m in oom_marks):
            print(f"OOM at batch={batch} bits={bits}", file=sys.stderr)
            return None  # memory limit reached — the sweep's stop signal
        print(err, file=sys.stderr)
        raise RuntimeError(f"bench failed (batch={batch}, bits={bits})")
    line = lines[-1]
    stats = {}
    for l in out.stderr.splitlines():
        if l.startswith(("bf16:", "w8a16:", "w4a16:")):
            key = l.split(":")[0]
            stats[key] = ast.literal_eval(l.split(":", 1)[1].strip())
    print(line, file=sys.stderr)  # per-cell JSON for the record
    return {"json": json.loads(line), **stats}


def main():
    preset = os.environ.get("EETQ_SWEEP_PRESET", "llama2-7b")
    batches = [
        int(b)
        for b in os.environ.get("EETQ_SWEEP_BATCHES", "1,2,4").split(",")
    ]
    rows = []
    kind = None
    for batch in batches:
        r8 = run(preset, batch, 8)
        r4 = run(preset, batch, 4, skip_bf16=True)
        if r8 is None and r4 is None:
            break  # the card's memory limit: end of the sweep
        if r8 is not None:
            kind = r8["json"]["device"]["kind"]
        bf = r8["bf16"]["decode_tok_s"] if r8 and "bf16" in r8 else None
        rows.append((
            batch,
            bf,
            r8["w8a16"]["decode_tok_s"] if r8 else None,
            r4["w4a16"]["decode_tok_s"] if r4 else None,
        ))
        print(f"done batch={batch}", file=sys.stderr)
    print(f"{preset} (prompt=1024, 50 new tokens, 1x {kind}):")
    print("| batch | bf16 tok/s | W8A16 tok/s | W4A16 tok/s |")
    print("|---|---|---|---|")
    for b, bf, w8, w4 in rows:
        bf_s = f"{bf:.1f}" if bf else "OOM"

        def cell(w):
            if w is None:
                return "OOM"
            return f"{w:.1f}" + (f" ({w/bf:.2f}x)" if bf else "")
        print(f"| {b} | {bf_s} | {cell(w8)} | {cell(w4)} |")


if __name__ == "__main__":
    main()
