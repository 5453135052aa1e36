"""Where a llama2-7b W8A16 decode step spends its device time.

    python scripts/trace_decode.py [--steps 32] [--out chiprun_out/trace_decode]

Builds the model from a seed and, for the decode GEMV kernel and for the
plain XLA dot in its place, warms the scanned decode loop (b=1, 2048-slot
cache, 1000 tokens in), traces one loop with jax.profiler, and reduces the
trace: per-kernel device time summed over the window (top 20), the device
busy time (union of kernel intervals), and the idle share of the window.
Each top kernel is attributed to its instruction in the compiled program
(output and operand shapes). The reduction reads the .xplane.pb with
jax.profiler.ProfileData only.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def reduce_trace(path: str, device_prefix: str = "/device:GPU:0") -> dict:
    """Per-op device time, busy time and window of the newest trace under
    `path`. Kernel events are read from the device plane's stream lines
    ("Stream #..."), or from every line when it has none; a summary of
    each line (events, summed ns) is returned beside them."""
    from jax.profiler import ProfileData

    files = sorted(glob.glob(os.path.join(path, "plugins/profile/*/*.xplane.pb")))
    if not files:
        raise FileNotFoundError(f"no .xplane.pb under {path}")
    data = ProfileData.from_file(files[-1])
    per_op: dict[str, float] = collections.defaultdict(float)
    intervals = []
    lines = {}
    for plane in data.planes:
        if not plane.name.startswith(device_prefix):
            continue
        all_lines = list(plane.lines)
        for line in all_lines:
            evs = list(line.events)
            lines[line.name] = (len(evs), sum(e.duration_ns for e in evs))
        streams = [ln for ln in all_lines if ln.name.startswith("Stream")]
        for line in streams or all_lines:
            for ev in line.events:
                per_op[ev.name] += ev.duration_ns
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not intervals:
        raise ValueError(f"no events on a plane named {device_prefix}*")
    intervals.sort()
    busy, cur_s, cur_e = 0.0, *intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = intervals[-1][1] - intervals[0][0]
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:20]
    return {"window_ns": window, "busy_ns": busy,
            "idle_share": 1.0 - busy / window, "top_ops_ns": top,
            "lines": lines}


def attribute(hlo: str, name: str) -> str:
    """Kernel `name` in the compiled program: its output shape, the JAX
    operation it came from, and that operation's source line. The trace
    names a kernel after its instruction with '.' turned into '_'."""
    for m in re.finditer(r"^\s*(?:ROOT )?%?([\w.\-]+) = (\S+) (.*)$", hlo,
                         re.M):
        if re.sub(r"[.\-]", "_", m.group(1)) != name:
            continue
        op = re.search(r'op_name="([^"]*)"', m.group(3))
        src = re.search(r'source_file="([^"]*)" source_line=(\d+)',
                        m.group(3))
        where = (f" at {os.path.basename(src.group(1))}:{src.group(2)}"
                 if src else "")
        return f"{m.group(2)} {op.group(1)[-160:] if op else '?'}{where}"
    return "not found"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--out", default="chiprun_out/trace_decode")
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("trace_decode.py needs a GPU")
    from eetq_tpu import backend
    from eetq_tpu.models import PRESETS, init_caches, random_quantized_params
    from eetq_tpu.serve.generate import decode_loop
    from eetq_tpu.utils.compile_cache import enable_compile_cache
    from eetq_tpu.utils.profiling import trace

    enable_compile_cache()
    cfg = PRESETS["llama2-7b"]
    params = random_quantized_params(cfg, 0)
    tok, start = jnp.zeros((1,), jnp.int32), jnp.int32(1000)

    def run():
        c = init_caches(cfg, 1, 2048)
        jax.block_until_ready(c)
        t = time.perf_counter()
        jax.block_until_ready(
            decode_loop(params, cfg, tok, start, c, args.steps + 1))
        return time.perf_counter() - t

    rule = backend.use_gemv_kernel
    for name, use in (("gemv_kernel", rule), ("xla_plain", lambda m: False)):
        backend.use_gemv_kernel = use
        jax.clear_caches()
        hlo = decode_loop.lower(params, cfg, tok, start,
                                init_caches(cfg, 1, 2048),
                                args.steps + 1).compile().as_text()
        run()
        host_s = min(run() for _ in range(2))
        out = os.path.join(args.out, name)
        with trace(out):
            run()
        red = reduce_trace(out)
        red["decode_path"] = name
        red["host_ms_per_step"] = host_s / args.steps * 1e3
        red["device_busy_ms_per_step"] = red["busy_ns"] / args.steps / 1e6
        red["top_ops"] = [
            {"name": op, "ms_per_step": ns / args.steps / 1e6,
             "hlo": attribute(hlo, op)}
            for op, ns in red.pop("top_ops_ns")]
        print(json.dumps(red, indent=1), flush=True)
    backend.use_gemv_kernel = rule


if __name__ == "__main__":
    main()
