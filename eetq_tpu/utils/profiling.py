"""Timing, roofline and trace utilities for the GPU.

- `time_fn(fn, *args)`: seconds per call, timed on the host clock around
  work that ends in `block_until_ready`.
- `roofline(...)`: achieved bytes/s and FLOP/s against the card's published
  peaks (`PEAKS`, keyed by `device_kind`; an unknown device is an error).
- `count_collectives(...)`: collective census of a (sharded) program.
- `trace(path)`: a `jax.profiler` device trace of the enclosed work.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable

import jax


@dataclasses.dataclass(frozen=True)
class Peaks:
    """Published dense peaks of one card (no sparsity)."""

    hbm_gbs: float
    bf16_tflops: float
    int8_tops: float
    power_w: float


# NVIDIA H100 SXM data sheet (dense rates at the 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": Peaks(
        hbm_gbs=3350.0, bf16_tflops=989.0, int8_tops=1979.0, power_w=700.0
    ),
}


def chip_peaks(kind: str | None = None) -> Peaks:
    """Peaks of `kind` (default: device 0's device_kind). Raises KeyError
    for a device the table does not hold — no default peak is assumed."""
    if kind is None:
        kind = jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise KeyError(
            f"no published peaks for device kind {kind!r}; add it to "
            f"eetq_tpu.utils.profiling.PEAKS with its source"
        )
    return PEAKS[kind]


def time_fn(fn: Callable, *args, reps: int = 5, warmup: int = 1) -> float:
    """Best-of-`reps` seconds per call of fn(*args), each call ended by
    block_until_ready. `warmup` untimed calls compile and warm first."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


@dataclasses.dataclass
class RooflineReport:
    seconds: float
    bytes_moved: int
    flops: int
    achieved_gbs: float
    achieved_tflops: float
    peak_gbs: float
    peak_tflops: float
    bound: str  # "memory" | "compute"
    fraction_of_roof: float

    def __str__(self) -> str:
        return (
            f"{self.seconds*1e6:.1f} us | {self.achieved_gbs:.0f}/{self.peak_gbs:.0f} "
            f"GB/s | {self.achieved_tflops:.1f}/{self.peak_tflops:.0f} TFLOP/s | "
            f"{self.bound}-bound, {self.fraction_of_roof:.0%} of roof"
        )


def roofline(
    seconds: float, bytes_moved: int, flops: int, kind: str | None = None,
    int8: bool = False,
) -> RooflineReport:
    """Score a measured kernel time against the card's roofline (bf16
    tensor-core peak, or the int8 peak with int8=True)."""
    peaks = chip_peaks(kind)
    peak_tflops = peaks.int8_tops if int8 else peaks.bf16_tflops
    achieved_gbs = bytes_moved / seconds / 1e9
    achieved_tflops = flops / seconds / 1e12
    t_mem = bytes_moved / (peaks.hbm_gbs * 1e9)
    t_flop = flops / (peak_tflops * 1e12)
    bound = "memory" if t_mem >= t_flop else "compute"
    return RooflineReport(
        seconds=seconds,
        bytes_moved=bytes_moved,
        flops=flops,
        achieved_gbs=achieved_gbs,
        achieved_tflops=achieved_tflops,
        peak_gbs=peaks.hbm_gbs,
        peak_tflops=peak_tflops,
        bound=bound,
        fraction_of_roof=max(t_mem, t_flop) / seconds,
    )


def count_collectives(fn: Callable, *args) -> dict[str, int]:
    """Count collective ops and their per-call payload bytes in `fn`'s
    jaxpr (recursing through pjit/scan/shard_map/closed_call bodies).

    Returns {primitive_name: total_bytes, primitive_name + "_count": n}, so
    a test can assert the sharded program's communication census (2 psums
    per layer + 1 lm_head all-gather under TP)."""
    jaxpr = jax.make_jaxpr(fn)(*args)
    out: dict[str, int] = {}

    def visit(jx):
        for eqn in jx.eqns:
            name = eqn.primitive.name
            if name in ("psum", "psum2", "all_gather", "ppermute",
                        "reduce_scatter", "all_to_all", "psum_invariant"):
                nbytes = sum(
                    v.aval.size * v.aval.dtype.itemsize
                    for v in eqn.invars
                    if hasattr(v.aval, "size")
                )
                out[name] = out.get(name, 0) + nbytes
                out[f"{name}_count"] = out.get(f"{name}_count", 0) + 1
            for pval in eqn.params.values():
                for sub in jax.tree.leaves(
                    pval, is_leaf=lambda x: hasattr(x, "eqns")
                    or hasattr(x, "jaxpr")
                ):
                    if hasattr(sub, "jaxpr"):
                        visit(sub.jaxpr)
                    elif hasattr(sub, "eqns"):
                        visit(sub)

    visit(jaxpr.jaxpr)
    return out


@contextlib.contextmanager
def trace(path: str):
    """Capture a jax.profiler device trace of the enclosed work to `path`
    (an `.xplane.pb` under `path/plugins/profile/`). Raises if the profiler
    cannot start."""
    jax.profiler.start_trace(path)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
