"""Weight-streaming int8 GEMV for the decode regime (Pallas, Triton route).

The design of the reference's batched GEMV
(`csrc/weightOnlyBatchedGemv/kernel.h:296`, hot loop `:332-467`): each
program owns a strip of output columns and a slice of K, streams its int8
weight tile with wide loads, converts it to bf16 in registers, and
accumulates x @ w in f32. K is split across programs so that a narrow
layer still puts work on every SM; the per-split f32 partial sums land in
their own rows and XLA adds them (a deterministic order, unlike atomics).
The per-channel scale multiplies the summed accumulator.

Decode with m <= MAX_M rows is memory-bound: llama2-7b reads ~6.7 GB of
int8 weights per step. x is zero-padded to 16 rows, the smallest tile the
tensor cores take; the extra rows cost nothing next to the weight stream.
The block configuration (`GemvConfig`) was chosen on an H100 (PERF.md,
"Kernel decisions").
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

MAX_M = 8  # decode rows the kernel serves
ROWS = 16  # padded row tile
TARGET_PROGRAMS = 264  # two programs for each of the H100's 132 SMs


@dataclasses.dataclass(frozen=True)
class GemvConfig:
    # defaults: the fastest of 12 block configurations over llama2-7b's four
    # layer projections at m=1 on an H100 (scripts/kernel_bench.py
    # gemv_sweep; PERF.md, "Kernel decisions")
    bn: int = 128  # output columns per program
    bk: int = 128  # K rows per loop step
    max_splits: int = 8  # bounds the f32 partial-sum traffic
    num_warps: int = 8
    num_stages: int = 3


DEFAULT = GemvConfig()


def choose_splits(kp: int, np_: int, cfg: GemvConfig = DEFAULT) -> int:
    """K splits for a [kp, np_] weight: the largest divisor of the K steps
    that brings the program count towards TARGET_PROGRAMS."""
    steps, cols = kp // cfg.bk, np_ // cfg.bn
    want = min(cfg.max_splits, max(1, -(-TARGET_PROGRAMS // cols)))
    return max(d for d in range(1, want + 1) if steps % d == 0)


def _gemv_kernel(x_ref, w_ref, o_ref, *, bn: int, bk: int, per_split: int):
    j = pl.program_id(0)
    sp = pl.program_id(1)
    cols = pl.ds(j * bn, bn)

    def body(i, acc):
        k0 = (sp * per_split + i) * bk
        x = x_ref[:, pl.ds(k0, bk)]
        w = w_ref[pl.ds(k0, bk), cols].astype(x.dtype)
        return acc + jnp.dot(x, w, preferred_element_type=jnp.float32)

    acc = jax.lax.fori_loop(
        0, per_split, body, jnp.zeros((ROWS, bn), jnp.float32)
    )
    o_ref[sp, :, cols] = acc


@functools.partial(jax.jit, static_argnames=("cfg", "interpret"))
def int8_gemv(
    x: jax.Array, w: jax.Array, scales: jax.Array,
    cfg: GemvConfig = DEFAULT, interpret: bool = False,
) -> jax.Array:
    """f32 [m, Np] = (x @ w) * scales.

    x: [m, Kp] float with m <= MAX_M; w: int8 [Kp, Np] with Kp % cfg.bk ==
    0 and Np % cfg.bn == 0 (the packed layout pads to 256); scales: [Np].
    """
    m, kp = x.shape
    np_ = w.shape[1]
    if m > MAX_M or kp % cfg.bk or np_ % cfg.bn or w.shape[0] != kp:
        raise ValueError(f"int8_gemv shapes: x {x.shape}, w {w.shape}")
    splits = choose_splits(kp, np_, cfg)
    xp = jnp.pad(x, ((0, ROWS - m), (0, 0)))
    kernel = functools.partial(
        _gemv_kernel, bn=cfg.bn, bk=cfg.bk, per_split=kp // cfg.bk // splits
    )
    partial = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((splits, ROWS, np_), jnp.float32),
        grid=(np_ // cfg.bn, splits),
        compiler_params=pltriton.CompilerParams(
            num_warps=cfg.num_warps, num_stages=cfg.num_stages
        ),
        backend="triton",
        interpret=interpret,
        name="int8_gemv",
    )(xp, w)
    return jnp.sum(partial[:, :m], axis=0) * scales.astype(jnp.float32)
