"""Kernel decisions on the GPU: each hand-written or library kernel against
what XLA makes of the plain version, at llama2-7b widths, and end to end.

    python scripts/kernel_bench.py [--parts matmuls,attention,gemv_sweep,mlp,e2e,attn_e2e,
                                            convert_check,convert]
                                   [--out chiprun_out/kernel_bench.jsonl]

Kernel times come from a jitted loop over distinct weight copies (more
bytes than the 50 MB L2 holds, so no copy is read from cache) that repeats
R times; one call's time is the loop's best time over calls. gemv_sweep
times the GEMV kernel's block configurations at the four llama2-7b layer
shapes (m=1) and keeps the fastest for the later parts. End to end:
llama2-7b W8A16 prefill (S=1000) and decode (b=1) with the decode GEMV
kernel on and off, in the order on, off, off, on. convert_check: where
the int8 -> bf16 convert stays fused into XLA's dot
(ops.linear._converted), the fused dot is finite and close to a float32
reference at every decode-regime row count. convert: the end-to-end cost
of materializing the convert at every row count instead. Prints one JSON object per
measurement and writes them to --out.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import eetq_tpu.ops.linear as linear_ops  # noqa: E402
from eetq_tpu import backend  # noqa: E402
from eetq_tpu.kernels.gemv import DEFAULT, GemvConfig, int8_gemv  # noqa: E402
from eetq_tpu.layout import pack_weights, unpack_weights  # noqa: E402
from eetq_tpu.ops.linear import w8a16_matmul_ref  # noqa: E402
from eetq_tpu.ops.linear8 import w8a8_matmul  # noqa: E402
from eetq_tpu.quant import symmetric_quantize  # noqa: E402
from eetq_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402
from eetq_tpu.utils.profiling import chip_peaks, time_fn  # noqa: E402

SHAPES = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096),
          (4096, 32000)]
LAYER_SHAPES = SHAPES[:4]  # qkv, o_proj, gate/up, down: once per layer
RECORDS: list[dict] = []
GEMV_CFG = [DEFAULT]  # the configuration the later parts run


def emit(**rec) -> None:
    RECORDS.append(rec)
    print(json.dumps(rec), flush=True)


def loop_time(fn, x, weights, reps: int = 10) -> float:
    """Seconds per fn(x, w) call, w cycling over `weights` inside one jit
    (a scalar carry keeps XLA from hoisting or dropping the calls)."""

    @jax.jit
    def run(x, ws):
        def body(_, c):
            xx = x + (c * 1e-30).astype(x.dtype)
            tot = c
            for w in ws:
                tot = tot + fn(xx, w)[0, 0].astype(jnp.float32)
            return tot

        return jax.lax.fori_loop(0, reps, body, jnp.float32(0.0))

    return time_fn(run, x, weights, reps=5, warmup=1) / (reps * len(weights))


def emit_matmul(op, m, k, n, impl, t) -> None:
    """One matmul timing with its bytes (int8 weight, bf16 x and out) and
    FLOPs per second."""
    nbytes, flops = k * n + 2 * m * (k + n), 2 * m * k * n
    emit(op=op, shape=[m, k, n], impl=impl, us=t * 1e6, bytes=nbytes,
         flops=flops, gbs=nbytes / t / 1e9, tflops=flops / t / 1e12)


def copies_for(nbytes: int) -> int:
    return max(2, min(64, -(-256 * 2**20 // nbytes)))


def bench_matmuls(key) -> None:
    for k, n in SHAPES:
        w = jax.random.normal(key, (k, n), jnp.float32) * k**-0.5
        q, s = symmetric_quantize(w, bits=8)
        del w
        nc = copies_for(k * n)
        packs = [pack_weights(q + 0) for _ in range(nc)]
        sp = jnp.pad(s, (0, packs[0].np - n))

        def gemv(x, pw):
            return int8_gemv(x, pw.data, sp, cfg=GEMV_CFG[0])

        def plain(x, pw):
            return w8a16_matmul_ref(x, unpack_weights(pw), s)

        for m in (1, 8):
            x = jax.random.normal(key, (m, k), jnp.bfloat16)
            for name, fn in (("gemv_kernel", gemv), ("xla_plain", plain)):
                emit_matmul("w8a16", m, k, n, name, loop_time(fn, x, packs))
        m = 1024
        x = jax.random.normal(key, (m, k), jnp.bfloat16)
        emit_matmul("w8a16", m, k, n, "xla_plain", loop_time(plain, x, packs[:2]))
        t = loop_time(lambda x, pw: w8a8_matmul(x, pw, s), x, packs[:2])
        emit_matmul("w8a8", m, k, n, "xla_plain", t)
        bench_mixed_mgpu(q, s, x, k, n)
        del packs


def bench_mixed_mgpu(q, s, x, k, n) -> None:
    """JAX's shipped Hopper mixed-type matmul (a library kernel: int8 x
    bf16 on wgmma). It takes int8 as the LEFT operand, so it computes
    out^T = W^T x^T over the [N, K] layout."""
    from jax.experimental.pallas.ops.gpu import (
        hopper_mixed_type_matmul_mgpu as mm,
    )

    wt = [jnp.asarray(q.T) + 0 for _ in range(2)]
    # 128x128x64 tiles; 128x256x64 ones need 320 KiB of shared memory, more
    # than the card's 227 KiB
    cfg = mm.TuningConfig(
        tile_m=128, tile_n=128, tile_k=64, max_concurrent_steps=4,
        grid_minor_dim=mm.MatmulDimension.N, grid_tile_width=4,
        wg_dimension=mm.MatmulDimension.N,
    )

    def fn(x, a):
        out_t = mm.mixed_matmul_kernel(a, x.T, out_dtype=jnp.bfloat16,
                                       config=cfg)
        return (out_t.T.astype(jnp.float32) * s).astype(jnp.bfloat16)

    emit_matmul("w8a16", x.shape[0], k, n, "mgpu_mixed (library) 128x128x64",
                loop_time(fn, x, wt))


def bench_attention(key) -> None:
    from jax.experimental.pallas.ops.gpu import decode_attention

    from eetq_tpu.modules.attention import (
        attention_decode,
        init_kv_cache,
        update_cache,
    )

    s, h, d = 1024, 32, 128
    q, k, v = (jax.random.normal(kk, (1, s, h, d), jnp.bfloat16)
               for kk in jax.random.split(key, 3))
    for impl, dt in (("cudnn", jnp.bfloat16), ("xla", jnp.bfloat16),
                     ("xla", jnp.float32)):
        f = jax.jit(functools.partial(
            jax.nn.dot_product_attention, is_causal=True, implementation=impl))
        args = [t.astype(dt) for t in (q, k, v)]
        t = time_fn(f, *args, reps=10)
        emit(op="prefill_attention", shape=[s, h, d], impl=f"{impl} {dt.__name__}",
             us=t * 1e6)

    slots = 2048
    for b, n in ((1, 512), (1, 2048), (4, 512)):
        kf = jax.random.normal(key, (b, slots, h, d), jnp.bfloat16)
        cache = update_cache(init_kv_cache(b, slots, h, d), kf, kf, 0)
        qd = jax.random.normal(key, (b, 1, h, d), jnp.bfloat16)
        lens = jnp.full((b,), n, jnp.int32)
        t = time_fn(attention_decode, qd, cache, lens, reps=20)
        emit(op="decode_attention", shape=[b, slots, n, h, d],
             impl="xla_plain", us=t * 1e6)
        # the library kernel reads a [B, L, H, D] cache (its own layout)
        kl = jnp.asarray(cache.k).transpose(0, 2, 1, 3)
        vl = jnp.asarray(cache.v).transpose(0, 2, 1, 3)
        lib = jax.jit(functools.partial(decode_attention.gqa, k_splits=16))
        t = time_fn(lib, qd[:, 0], kl, vl, None, lens, reps=20)
        emit(op="decode_attention", shape=[b, slots, n, h, d],
             impl="pallas_triton_gqa (library)", us=t * 1e6)


def bench_gemv_sweep(key) -> None:
    """GEMV block configurations at the layer shapes (m=1); the fastest
    (least summed time over one layer's four projections) becomes
    GEMV_CFG[0], and XLA's plain dot is timed beside it."""
    data = []
    for k, n in LAYER_SHAPES:
        q = jax.random.randint(key, (k, n), -127, 128).astype(jnp.int8)
        s = jax.random.uniform(key, (n,), jnp.float32) * 0.01
        data.append((k, n, [q + 0 for _ in range(copies_for(k * n))], s))
    x1 = {k: jax.random.normal(key, (1, k), jnp.bfloat16) for k, _ in LAYER_SHAPES}
    plain = sum(
        loop_time(lambda x, w, s=s: w8a16_matmul_ref(x, w, s), x1[k], ws)
        for k, n, ws, s in data)
    emit(op="gemv_sweep", impl="xla_plain", layer_us=plain * 1e6)
    best = (float("inf"), DEFAULT)
    for bn in (64, 128, 256):
        for bk in (128, 256):
            for warps in (4, 8):
                cfg = GemvConfig(bn=bn, bk=bk, num_warps=warps)
                try:
                    t = sum(
                        loop_time(lambda x, w, s=s, cfg=cfg: int8_gemv(
                            x, w, s, cfg=cfg), x1[k], ws)
                        for k, n, ws, s in data)
                except Exception as e:  # a block shape Triton refuses
                    emit(op="gemv_sweep", impl=str(cfg), error=repr(e)[:300])
                    continue
                emit(op="gemv_sweep", impl=str(cfg), layer_us=t * 1e6)
                best = min(best, (t, cfg), key=lambda p: p[0])
    GEMV_CFG[0] = best[1]
    emit(op="gemv_sweep", chosen=str(best[1]), layer_us=best[0] * 1e6)


def bench_mlp_block(key) -> None:
    """The unfused decode MLP block (m=1): gate/up projection, SwiGLU, down
    projection — the target any later fused-MLP kernel must beat."""
    from eetq_tpu.modules.linear import linear_apply, quantize_linear

    h, i = 4096, 11008
    blocks = []
    for kk in jax.random.split(key, copies_for(h * 3 * i)):
        k1, k2 = jax.random.split(kk)
        blocks.append((
            quantize_linear(jax.random.normal(k1, (h, 2 * i), jnp.bfloat16)
                            * h**-0.5),
            quantize_linear(jax.random.normal(k2, (i, h), jnp.bfloat16)
                            * i**-0.5),
        ))

    def block(x, w):
        gu, dn = w
        g, u = jnp.split(linear_apply(gu, x), 2, axis=-1)
        hid = (jax.nn.silu(g.astype(jnp.float32)) * u.astype(jnp.float32))
        return linear_apply(dn, hid.astype(x.dtype))

    x = jax.random.normal(key, (1, h), jnp.bfloat16)
    for on in (True, False, False, True):
        use_gemv(on)
        t = loop_time(block, x, blocks)
        emit(op="mlp_block_decode", shape=[1, h, i],
             impl="gemv_kernel" if on else "xla_plain", us=t * 1e6,
             gbs=3 * h * i / t / 1e9)
    use_gemv(True)


RULE = backend.use_gemv_kernel


def use_gemv(on: bool) -> None:
    """Switch the decode GEMV kernel (with GEMV_CFG[0]) on or off for the
    model path by patching the backend rule, and drop JAX's caches so the
    next trace sees it."""
    backend.use_gemv_kernel = RULE if on else (lambda m: False)
    linear_ops.int8_gemv = functools.partial(int8_gemv, cfg=GEMV_CFG[0])
    jax.clear_caches()


def bench_prefill_attention_e2e(seed: int) -> None:
    """llama2-7b W8A16 prefill (S=1000) with prefill attention on cuDNN and
    on the XLA path, in the order cudnn, xla, xla, cudnn."""
    from eetq_tpu.models import PRESETS, init_caches, random_quantized_params
    from eetq_tpu.serve.generate import prefill

    cfg = PRESETS["llama2-7b"]
    params = random_quantized_params(cfg, seed)
    toks = jax.random.randint(jax.random.PRNGKey(seed), (1, 1000), 1, 32000)
    caches = init_caches(cfg, 1, 2048)
    rule = backend.attention_implementation
    for impl in ("cudnn", "xla", "xla", "cudnn"):
        backend.attention_implementation = lambda impl=impl: impl
        jax.clear_caches()
        t = time_fn(lambda: prefill(params, cfg, toks, caches), reps=5)
        emit(op="llama2-7b W8A16 prefill S=1000", impl=f"attention {impl}",
             prefill_ms=t * 1e3)
    backend.attention_implementation = rule
    jax.clear_caches()


def check_fused_convert(key) -> None:
    """w8a16_matmul with the convert fused (m <= FUSED_CONVERT_MAX_M) at
    the llama2-7b and llama2-70b projection shapes: every element finite
    and within bf16 rounding of a float32 reference, over three runs of
    each compiled call."""
    from eetq_tpu.ops import w8a16_matmul

    shapes = SHAPES + [(8192, 10240), (28672, 8192)]
    cases = [(k, n, 8, None) for k, n in shapes]
    cases += [(k, n, 4, 128) for k, n in LAYER_SHAPES]
    for k, n, bits, group in cases:
        w = jax.random.normal(key, (k, n), jnp.float32) * k**-0.5
        q, s = symmetric_quantize(w, bits=bits, group_size=group)
        pw = pack_weights(q, bits=bits)
        del w
        for m in (9, 16, 32, 64):
            x = jax.random.normal(jax.random.PRNGKey(m), (m, k), jnp.bfloat16)
            with jax.default_matmul_precision("highest"):
                want = jax.jit(w8a16_matmul_ref)(x.astype(jnp.float32), q, s)
            f = jax.jit(w8a16_matmul)
            worst, finite = 0.0, True
            for _ in range(3):
                got = f(x, pw, s).astype(jnp.float32)
                finite &= bool(jnp.isfinite(got).all())
                err = jnp.max(jnp.abs(got - want) / (jnp.abs(want) + 1.0))
                worst = max(worst, float(err))
            emit(op="fused convert check", shape=[m, k, n], bits=bits,
                 group=group, finite=finite, max_rel_err=worst)
            if not finite or worst > 2e-2:
                raise SystemExit(f"fused convert wrong at {[m, k, n]}")


def bench_convert(seed: int) -> None:
    """End to end, the committed rule (convert fused for m <= 64,
    materialized above) against the convert materialized at every m
    (decode b=16 and b=32, int4 g128 b=1) or fused at every m (prefill)."""
    from eetq_tpu.models import PRESETS, init_caches, random_quantized_params
    from eetq_tpu.serve.generate import decode_loop, prefill

    committed = linear_ops._converted

    def materialized(q, dtype, m):
        return jax.lax.optimization_barrier(q.astype(dtype))

    def fused(q, dtype, m):
        return q.astype(dtype)

    cfg = PRESETS["llama2-7b"]
    steps = 32

    def decode_ms(params, b, slots=2048):
        def once():
            c = init_caches(cfg, b, slots)
            jax.block_until_ready(c)
            t = time.perf_counter()
            jax.block_until_ready(decode_loop(
                params, cfg, jnp.zeros((b,), jnp.int32),
                jnp.int32(slots - steps - 16), c, steps + 1))
            return (time.perf_counter() - t) / steps * 1e3
        once()
        return min(once() for _ in range(3))

    def ab(label, other_name, other, measure):
        for name in ("committed", other_name, other_name, "committed"):
            linear_ops._converted = committed if name == "committed" else other
            jax.clear_caches()
            emit(op=label, impl=name, ms=measure())
        linear_ops._converted = committed
        jax.clear_caches()

    params = random_quantized_params(cfg, seed)
    # b=32 over 2048 slots does not fit: the scanned loop holds the KV
    # cache twice (PERF.md, open questions)
    for b, slots in (16, 2048), (32, 1024):
        ab(f"llama2-7b W8A16 decode b={b} {slots} slots ms/step",
           "materialized", materialized,
           lambda b=b, slots=slots: decode_ms(params, b, slots))
    toks = jax.random.randint(jax.random.PRNGKey(seed), (1, 1000), 1, 32000)
    caches = init_caches(cfg, 1, 2048)
    ab("llama2-7b W8A16 prefill S=1000 ms", "fused", fused,
       lambda: time_fn(lambda: prefill(params, cfg, toks, caches), reps=3) * 1e3)
    del params, caches
    params = random_quantized_params(cfg, seed, bits=4, group_size=128)
    ab("llama2-7b W4A16 g128 decode b=1 ms/step", "materialized",
       materialized, lambda: decode_ms(params, 1))


def bench_end_to_end(seed: int) -> None:
    from eetq_tpu.models import PRESETS, init_caches, random_quantized_params
    from eetq_tpu.serve.generate import decode_loop, prefill

    cfg = PRESETS["llama2-7b"]
    params = random_quantized_params(cfg, seed)
    toks = jax.random.randint(jax.random.PRNGKey(seed), (1, 1000), 1, 32000)
    steps = 64

    def decode_ms():
        c = init_caches(cfg, 1, 2048)
        jax.block_until_ready(c)
        t = time.perf_counter()
        jax.block_until_ready(decode_loop(
            params, cfg, jnp.zeros((1,), jnp.int32), jnp.int32(1000), c,
            steps + 1))
        return (time.perf_counter() - t) / steps * 1e3

    for on in (True, False, False, True):
        use_gemv(on)
        caches = init_caches(cfg, 1, 2048)
        pre = time_fn(lambda: prefill(params, cfg, toks, caches), reps=3)
        decode_ms()
        dec = min(decode_ms() for _ in range(3))
        emit(op="llama2-7b W8A16 end to end", impl="gemv_kernel" if on
             else "xla_plain", prefill_ms_s1000=pre * 1e3,
             decode_ms_per_step_b1=dec, gemv_cfg=str(GEMV_CFG[0]))
    use_gemv(True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/kernel_bench.jsonl")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parts", default="matmuls,attention,gemv_sweep,mlp,e2e")
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"kernel_bench needs a GPU, found {dev.platform}")
    enable_compile_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    emit(device=dev.device_kind, nvidia_smi=smi, jax=jax.__version__)
    key = jax.random.PRNGKey(args.seed)
    parts = {
        "matmuls": lambda: bench_matmuls(key),
        "attention": lambda: bench_attention(key),
        "gemv_sweep": lambda: bench_gemv_sweep(key),
        "mlp": lambda: bench_mlp_block(key),
        "e2e": lambda: bench_end_to_end(args.seed),
        "attn_e2e": lambda: bench_prefill_attention_e2e(args.seed),
        "convert_check": lambda: check_fused_convert(key),
        "convert": lambda: bench_convert(args.seed),
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    for name in args.parts.split(","):
        parts[name]()
        with open(args.out, "w") as f:  # what is done so far
            for rec in RECORDS:
                f.write(json.dumps(rec) + "\n")
    # roofline shares against the published peaks (an unknown card raises)
    peaks = chip_peaks(dev.device_kind)
    for rec in RECORDS:
        if "bytes" in rec:
            t = rec["us"] * 1e-6
            peak = peaks.int8_tops if rec["op"] == "w8a8" else peaks.bf16_tflops
            share = max(rec["bytes"] / (peaks.hbm_gbs * 1e9),
                        rec["flops"] / (peak * 1e12)) / t
            print(f"roofline {rec['op']} {rec['shape']} {rec['impl']}: "
                  f"{share:.3f}", flush=True)


if __name__ == "__main__":
    main()
