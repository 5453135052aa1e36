"""Packed-weight tile layout: defined ONCE, imported by both the offline
repacker and the matmul paths.

This module plays the role of the reference's layout single-source-of-truth
(`csrc/cutlass_extensions/gemm/kernel/mixed_gemm_B_layout.h:59-85`), which ties
the CPU preprocessor (`cutlass_preprocessors.cc:497-534`) to the GEMM kernels.
The reference's packed layout is an arch-specific row-permute + transpose +
column-interleave + sign-bias chain so that ldmatrix/HMMA register layouts line
up. Here XLA's dot and the decode GEMV kernel read plain row-major tiles and
convert int8 to bf16 in registers, so the packed layout is:

  - logical weight [K, N] int8 (in-features x out-features, matching the
    reference's K x N storage, `modules/qlinear.py:34`),
  - zero-padded so K % k_tile == 0 and N % n_tile == 0 (256: whole blocks
    for the GEMV kernel; the padding is inert in XLA's dot),
  - stored row-major [Kp, Np].

Checkpoints store the UNPACKED [K, N] int8 + scales (portable across layout
versions and devices — deliberately unlike the reference, whose saved
qweight bakes in SM-specific permutes, see SURVEY.md §5 checkpoint notes);
packing happens at load time and is a cheap jitted pad.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

LAYOUT_VERSION = 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pad_axis_to(x: jax.Array, axis: int, multiple: int) -> jax.Array:
    """Zero-pad `axis` of x up to the next multiple of `multiple`."""
    size = x.shape[axis]
    target = _cdiv(size, multiple) * multiple
    if target == size:
        return x
    pads = [(0, 0)] * x.ndim
    pads[axis] = (0, target - size)
    return jnp.pad(x, pads)


@dataclasses.dataclass(frozen=True)
class TileLayout:
    """The packed int8 weight layout contract between repacker and kernels.

    k_tile/n_tile are the padding granules: 256, so every block of the
    decode GEMV kernel is full (no partial-block masking on the hot path).
    Padding waste is < 256/4096 ≈ 6% worst case on real transformer dims,
    ~0% on the common ones (all multiples of 256).
    """

    k_tile: int = 256
    n_tile: int = 256
    version: int = LAYOUT_VERSION

    def padded_kn(self, k: int, n: int) -> tuple[int, int]:
        return _cdiv(k, self.k_tile) * self.k_tile, _cdiv(n, self.n_tile) * self.n_tile


DEFAULT_LAYOUT = TileLayout()


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PackedWeight:
    """A kernel-ready packed int8 weight plus its logical shape.

    data: int8 [Kp, Np] (or [E, Kp, Np] for batched/"experts" weights), padded
    per DEFAULT_LAYOUT. k/n are the logical (unpadded) dims; extra rows/cols
    are zeros so matmul results over the padded range are exact.
    """

    data: jax.Array
    k: int = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))
    bits: int = dataclasses.field(default=8, metadata=dict(static=True))
    version: int = dataclasses.field(default=LAYOUT_VERSION, metadata=dict(static=True))

    @property
    def kp(self) -> int:
        """Logical padded K (int4 data rows each pack two logical rows)."""
        rows = self.data.shape[-2]
        return rows * 2 if self.bits == 4 else rows

    @property
    def np(self) -> int:
        return self.data.shape[-1]


def pack_weights(
    qweight: jax.Array, layout: TileLayout = DEFAULT_LAYOUT, bits: int = 8
) -> PackedWeight:
    """Repack an unprocessed int8 [K, N] (or [E, K, N]) weight to kernel layout.

    The analogue of the reference's `preprocess_weights`
    (`csrc/eetpy.cpp:11-13` → `cutlass_preprocessors.cc:497-534`): offline,
    one-time, before serving. Returns a PackedWeight consumed by
    eetq_tpu.ops.

    bits=8: zero-pad to (k_tile, n_tile) granules, stored row-major [Kp, Np].
    bits=4 (values in [-8, 7] held one-per-int8): split-half nibble packing
    [Kp/2, Np] — element (i, n) packs logical row i in the low nibble and
    row i + Kp/2 in the high nibble, so the kernel needs no in-register row
    interleave. K is padded so each half is a whole number of k_tiles.
    """
    if qweight.dtype != jnp.int8:
        raise TypeError(f"pack_weights expects int8, got {qweight.dtype}")
    if qweight.ndim not in (2, 3):
        raise ValueError(f"weight must be 2-D or 3-D, got {qweight.shape}")
    if bits not in (8, 4):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    k, n = qweight.shape[-2], qweight.shape[-1]
    padded = pad_axis_to(pad_axis_to(qweight, -1, layout.n_tile), -2, layout.k_tile)
    if bits == 4:
        padded = pad_axis_to(padded, -2, 2 * layout.k_tile)
        half = padded.shape[-2] // 2
        lo = padded[..., :half, :].astype(jnp.uint8) & 0x0F
        hi = padded[..., half:, :].astype(jnp.uint8) << 4
        padded = (lo | hi).astype(jnp.int8)
    return PackedWeight(data=padded, k=k, n=n, bits=bits, version=layout.version)


def unpack_weights(packed: PackedWeight) -> jax.Array:
    """Exact inverse of :func:`pack_weights` — recover the logical [K, N]
    int8 (int4 values sign-extended, one per int8)."""
    if packed.bits == 4:
        p = packed.data.astype(jnp.uint8)
        lo = (p & 0x0F).astype(jnp.int8)
        hi = (p >> 4).astype(jnp.int8)
        lo = jnp.where(lo >= 8, lo - 16, lo)
        hi = jnp.where(hi >= 8, hi - 16, hi)
        full = jnp.concatenate([lo, hi], axis=-2)
        return full[..., : packed.k, : packed.n]
    return packed.data[..., : packed.k, : packed.n]
