"""ALiBi (Attention with Linear Biases) slopes.

The reference serves baichuan-13b — an ALiBi model — by delegating attention
to HF's model code (`python/eetq/models/baichuan.py:1-106` only handles
W_pack fusion/TP). Here attention is ours, so ALiBi is a first-class path:
the per-head slopes computed below feed an additive `slope * (key_pos -
query_pos)` bias in the prefill, decode and verify attention paths
(modules/attention.py).

Slope convention (Press et al., "Train Short, Test Long"): for n a power of
two, slope_h = 2^(-8(h+1)/n). For other n, the first p = 2^floor(log2 n)
heads use the power-of-two formula at p, and the remaining heads take every
other slope of the 2p sequence: slope_{p+j} = 2^(-4(2j+1)/p). The closed
form below is property-tested against the recursive reference formula in
tests/test_alibi.py (baichuan-13b has 40 heads — NOT a power of two)."""

from __future__ import annotations

import numpy as np


def alibi_slopes(n_heads: int) -> np.ndarray:
    """Per-head ALiBi slopes [n_heads] f32 (closed form, any head count)."""
    if n_heads < 1:
        raise ValueError(f"n_heads must be >= 1, got {n_heads}")
    p = 1 << (n_heads.bit_length() - 1)  # largest power of two <= n_heads
    h = np.arange(n_heads, dtype=np.float64)
    slopes = np.where(
        h < p,
        2.0 ** (-8.0 * (h + 1) / p),
        2.0 ** (-4.0 * (2.0 * (h - p) + 1.0) / p),
    )
    return slopes.astype(np.float32)
