"""`w8a8_matmul` — full-int8 matmul with dynamic per-token activation
quantization (the live version of the reference's unused W8A8 epilogue
infrastructure, SURVEY.md §2.2 epilogue extensions row: per-row/per-col
rescale epilogues, QuantMode{PerToken,PerChannel}).

The product is `lax.dot_general(int8, int8, preferred_element_type=int32)`,
which XLA hands to the GPU's int8 tensor cores; token and channel scales
multiply the int32 result. int4 weights (**W4A8**) are unpacked to int8
first, per-channel or group-wise.

Intended for the prefill regime (compute-bound; decode is weight-bandwidth
bound, where int8 activations buy nothing). Accuracy: per-token absmax int8
activations are the standard "W8A8 smooth-free" tradeoff; use W8A16 when
logits-exactness matters.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from eetq_tpu.layout import PackedWeight, pack_weights, unpack_weights
from eetq_tpu.ops.linear import ACTIVATIONS


@jax.jit
def quantize_activations(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Per-token (last-axis) symmetric int8 quantization of activations.

    x: [..., K] float. Returns (q int8 [..., K], scales f32 [...]).
    """
    xf = x.astype(jnp.float32)
    absmax = jnp.max(jnp.abs(xf), axis=-1)
    scale = absmax / 127.0
    safe = jnp.where(scale == 0.0, 1.0, scale)
    q = jnp.clip(
        jnp.round(xf / safe[..., None]), -127, 127
    ).astype(jnp.int8)
    return q, scale


def _idot(a: jax.Array, b: jax.Array) -> jax.Array:
    """s8 x s8 -> s32 contraction of a's last axis with b's first."""
    return jax.lax.dot_general(
        a, b, (((a.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )


def w8a8_matmul_ref(x, qweight, w_scales, bias=None, activation=None):
    """Per-token quantize activations, integer matmul, dequant.

    qweight: logical int8 [K, N] (int4 values sign-extended).
    w_scales: [N] per-channel, or [G, N] group-wise (g = K // G) — the
    group-wise case dequantizes per-group integer partial sums.
    """
    xq, sx = quantize_activations(x)
    if w_scales.ndim == 1:
        acc = _idot(xq, qweight).astype(jnp.float32)
        r = acc * sx[..., None] * w_scales.astype(jnp.float32)
    else:
        gcount = w_scales.shape[0]
        k, n = qweight.shape
        g = k // gcount
        part = jnp.einsum(
            "...gk,gkn->...gn",
            xq.reshape(*xq.shape[:-1], gcount, g),
            qweight.reshape(gcount, g, n),
            preferred_element_type=jnp.int32,
        ).astype(jnp.float32)
        r = jnp.einsum(
            "...gn,gn->...n", part, w_scales.astype(jnp.float32)
        ) * sx[..., None]
    if bias is not None:
        r = r + bias.astype(jnp.float32)
    r = ACTIVATIONS[activation](r)
    return r.astype(x.dtype)


def w8a8_matmul(
    x: jax.Array,
    qweight: PackedWeight | jax.Array,
    scales: jax.Array,
    bias: jax.Array | None = None,
    activation: str | None = None,
) -> jax.Array:
    """out = act((int8(x) @ intW) * row_scale * col_scale + bias).

    x: [..., K] float. Weights: int8 per-channel (W8A8), or int4 with
    per-channel or group-wise scales (W4A8). int8 group-wise stays on the
    W8A16 path.
    """
    if not isinstance(qweight, PackedWeight):
        qweight = pack_weights(qweight)
    if qweight.bits == 8 and scales.ndim != 1:
        raise ValueError(
            "a8 with int8 weights needs per-channel scales "
            "(group-wise int8 stays on the W8A16 path)"
        )
    k, n = qweight.k, qweight.n
    *lead, xk = x.shape
    if xk != k:
        raise ValueError(f"x feature dim {xk} != weight K {k}")
    return w8a8_matmul_ref(
        x.reshape(-1, k), unpack_weights(qweight), scales, bias, activation
    ).reshape(*lead, n)
