"""Per-channel symmetric weight-only quantizer (no calibration data, no QAT).

Semantics mirror the reference host quantizer
(`csrc/cutlass_kernels/cutlass_preprocessors.cc:581-678`):

- weight layout is [K, N] (in-features x out-features); per-**output-channel**
  (last axis) scales.
- ``scale[n] = max_k |w[k, n]| / 2^(bits-1)``  (i.e. /128 for int8, /8 for int4)
- ``q[k, n] = clip(round_half_away(w[k, n] / scale[n]), -2^(b-1), 2^(b-1)-1)``
- 3-D "experts" weights [E, K, N] quantize each expert independently
  (reference: `cutlass_preprocessors.cc:594-614`).

Unlike the reference (a ~700-line OpenMP C++ loop nest), this is a handful of
jitted JAX array ops: the quantization itself runs on whatever backend is
available (CPU or GPU) and vectorizes trivially.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _round_half_away(x: jax.Array) -> jax.Array:
    """C `round()` semantics: round half away from zero.

    jnp.round is round-half-even; the reference uses C round()
    (`cutlass_preprocessors.cc:649`), so match it exactly for bit-exact
    checkpoint reproducibility.
    """
    return jnp.trunc(x + jnp.where(x >= 0, 0.5, -0.5))


@functools.partial(jax.jit, static_argnames=("bits", "scale_dtype", "group_size"))
def symmetric_quantize(
    weight: jax.Array,
    bits: int = 8,
    scale_dtype: jnp.dtype = jnp.float32,
    group_size: int | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Quantize a [K, N] (or [E, K, N]) weight to signed ints + absmax scales.

    Args:
      weight: float array, shape [K, N] or [E, K, N]. N is the output-channel
        axis (scales are per element of the last axis).
      bits: 8 or 4. For bits=4 the returned qweight still holds one int4 value
        per int8 element in [-8, 7]; `eetq_tpu.layout.pack_weights(bits=4)`
        nibble-packs it for the kernel.
      scale_dtype: dtype of the returned scales.
      group_size: None for per-channel scales [..., N] (the reference's
        PerChannel mode); an int g (dividing K) for group-wise scales
        [..., K/g, N] (the reference GEMV's GroupWise(64/128) mode,
        `weightOnlyBatchedGemv/common.h:73-79`). Group-wise is also the
        representation of offline-TP-resharded row-parallel weights (each
        rank's K-slice quantized independently = group_size K/tp).

    Returns:
      (qweight int8 same shape as weight, scales).
    """
    if bits not in (8, 4):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if weight.ndim not in (2, 3):
        raise ValueError(f"weight must be 2-D or 3-D, got shape {weight.shape}")
    w = weight.astype(jnp.float32)
    kdim, n = w.shape[-2], w.shape[-1]
    qmax = 2 ** (bits - 1) - 1
    qmin = -(2 ** (bits - 1))
    if group_size is not None:
        if kdim % group_size:
            raise ValueError(f"group_size {group_size} must divide K {kdim}")
        wg = w.reshape(*w.shape[:-2], kdim // group_size, group_size, n)
        absmax = jnp.max(jnp.abs(wg), axis=-2)  # [..., G, N]
    else:
        absmax = jnp.max(jnp.abs(w), axis=-2)  # [..., N]
    # scale = absmax / 2^(b-1)  (reference: quant_range_scale, :611)
    scale = absmax * (1.0 / float(2 ** (bits - 1)))
    # Avoid 0/0 for all-zero columns; q ends up 0 there anyway.
    safe = jnp.where(scale == 0.0, 1.0, scale)
    if group_size is not None:
        q = _round_half_away(wg / safe[..., None, :]).reshape(w.shape)
    else:
        q = _round_half_away(w / safe[..., None, :])
    q = jnp.clip(q, qmin, qmax).astype(jnp.int8)
    return q, scale.astype(scale_dtype)


@jax.jit
def dequantize(qweight: jax.Array, scales: jax.Array) -> jax.Array:
    """Reference dequantization: ``w ≈ q * scale`` broadcast over the K axis.

    qweight: int8 [..., K, N]; scales [..., N] (per-channel) or [..., G, N]
    (group-wise; K % G == 0). Returns float32.
    """
    q = qweight.astype(jnp.float32)
    s = scales.astype(jnp.float32)
    if s.ndim == q.ndim:  # group-wise
        kdim, n = q.shape[-2], q.shape[-1]
        gcount = s.shape[-2]
        qg = q.reshape(*q.shape[:-2], gcount, kdim // gcount, n)
        return (qg * s[..., None, :]).reshape(q.shape)
    return q * s[..., None, :]


def int4_pack(q: jax.Array) -> jax.Array:
    """Pack int4 values (stored in int8, range [-8, 7]) two-per-byte along N.

    Layout matches the reference (`cutlass_preprocessors.cc:653-668`): element
    2j goes in the low nibble, 2j+1 in the high nibble. N must be even.
    """
    if q.shape[-1] % 2:
        raise ValueError("last axis must be even to int4-pack")
    lo = q[..., 0::2].astype(jnp.uint8) & 0x0F
    hi = (q[..., 1::2].astype(jnp.uint8) & 0x0F) << 4
    return (lo | hi).astype(jnp.int8)


def int4_unpack(packed: jax.Array) -> jax.Array:
    """Inverse of :func:`int4_pack`; returns int8 values in [-8, 7]."""
    p = packed.astype(jnp.uint8)
    lo = (p & 0x0F).astype(jnp.int8)
    hi = ((p >> 4) & 0x0F).astype(jnp.int8)
    # sign-extend 4-bit values
    lo = jnp.where(lo >= 8, lo - 16, lo)
    hi = jnp.where(hi >= 8, hi - 16, hi)
    out = jnp.stack([lo, hi], axis=-1)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def quantize_and_pack(weight, bits: int = 8, scale_dtype=jnp.float32):
    """Quantize then pack to the kernel-native tile layout.

    One-stop analogue of the reference's `quant_weights(..., return_unprocessed
    =False)` path (`csrc/eetpy.cpp:14-17`): returns (packed qweight, scales).
    """
    from eetq_tpu.layout import pack_weights

    q, s = symmetric_quantize(weight, bits=bits, scale_dtype=scale_dtype)
    return pack_weights(q), s
