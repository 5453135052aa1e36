"""`w8a16_matmul` — the single user-facing quantized matmul entry.

Mirrors `w8_a16_gemm_forward_cuda` (`csrc/cutlass_kernels/
fpA_intB_gemm_wrapper.cu:130-173`): flatten leading dims to m x k and
compute act(x @ dequant(W) + bias) [+|*] residual. The reference dispatches
on m between a hand-written batched GEMV (m <= 4) and a CUTLASS
mixed-input GEMM; here both regimes are one XLA program,
`dot(x, convert(q)) * scales` with f32 accumulation (the convert fused
into the dot for at most FUSED_CONVERT_MAX_M rows, materialized first for
more, see `_converted`), and the per-channel scale is applied once to the
f32 accumulator (scales commute
with the K-sum — the invariant the reference keeps with its warp-level
dequantizer, `mma_tensorop_dequantizer.h:152-183`). On the GPU, decode
rows (m <= kernels.gemv.MAX_M, int8 per-channel) take the weight-streaming
GEMV kernel in `eetq_tpu.kernels.gemv` instead.

Supports int8 and int4 weights (the reference's Int8b/Int4b GEMV kernels),
per-channel [N] or group-wise [K/g, N] scales (PerChannel / GroupWise
quant modes, `weightOnlyBatchedGemv/common.h:73-79`).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from eetq_tpu import backend
from eetq_tpu.kernels.gemv import MAX_M, int8_gemv
from eetq_tpu.layout import PackedWeight, pack_weights, unpack_weights

ACTIVATIONS = {
    None: lambda x: x,
    "relu": lambda x: jnp.maximum(x, 0.0),
    "gelu": jax.nn.gelu,  # tanh approx, like ft_fused_activations.h:40-60
    "silu": jax.nn.silu,
}

# Rows up to which the int8 -> bf16 convert stays fused into the dot (see
# `_converted`): every decode batch the engine runs by default.
FUSED_CONVERT_MAX_M = 64


def w8a16_matmul_ref(
    x: jax.Array,
    qweight: jax.Array,
    scales: jax.Array,
    bias: jax.Array | None = None,
    activation: str | None = None,
    residual: jax.Array | None = None,
    residual_mode: str = "add",
) -> jax.Array:
    """Dequant-matmul on the logical weight: the compute path of
    `w8a16_matmul` and the oracle its tests compare against.

    qweight: logical int8 [K, N] (int4 values sign-extended to int8).
    scales: [N] per-channel or [G, N] group-wise.
    Per-channel: the weight converts to x's dtype inside the dot, the dot
    accumulates in f32, and the scale multiplies the accumulator.
    Group-wise: each group's scale multiplies that group's f32 partial sum.
    """
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if residual_mode not in ("add", "mul"):
        raise ValueError(f"unknown residual mode {residual_mode!r}")
    m = x.size // x.shape[-1]
    if scales.ndim == 1:
        acc = jnp.dot(
            x, _converted(qweight, x.dtype, m),
            preferred_element_type=jnp.float32,
        )
        r = acc * scales.astype(jnp.float32)[None, :]
    else:
        kdim, n = qweight.shape
        gcount = scales.shape[0]
        lead = x.shape[:-1]
        # [G, M, g] x [G, g, N] -> [G, M, N] f32 partial dots, the group axis
        # leading on both operands and the output (the canonical batched
        # GEMM), each group scaled, then summed
        xg = x.reshape(-1, gcount, kdim // gcount).swapaxes(0, 1)
        wg = _converted(qweight, x.dtype, m).reshape(
            gcount, kdim // gcount, n)
        parts = jax.lax.dot_general(
            xg, wg, (((2,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32,
        )
        r = jnp.sum(parts * scales.astype(jnp.float32)[:, None, :], axis=0)
        r = r.reshape(*lead, n)
    return _epilogue(r, bias, activation, residual, residual_mode, x.dtype)


def _converted(qweight: jax.Array, dtype, m: int) -> jax.Array:
    """The int weight converted to the activation dtype for an m-row dot.

    With at most FUSED_CONVERT_MAX_M rows the convert stays inside the dot:
    XLA's GEMM fusion then reads 1 byte per weight, which is what a
    memory-bound decode step pays for. With more rows the bf16 weight is
    materialized first (a bf16 copy written and read back, 4 more bytes
    per weight, small next to a compute-bound GEMM). On an H100 under JAX
    0.9.0, the Triton
    GEMM with the convert fused that XLA's autotuner picks at some prefill
    shapes writes NaN or garbage into a few output elements (4096x12288
    at m=256, 8192x10240 at m=256 and m=500; none at m <= 64 over the
    llama2 projection shapes; PERF.md)."""
    w = qweight.astype(dtype)
    return w if m <= FUSED_CONVERT_MAX_M else jax.lax.optimization_barrier(w)


def _epilogue(r, bias, activation, residual, residual_mode, dtype):
    """bias, activation and residual on the f32 accumulator r."""
    if bias is not None:
        r = r + bias.astype(jnp.float32)[None, :]
    r = ACTIVATIONS[activation](r)
    if residual is not None:
        res = residual.astype(jnp.float32)
        r = r + res if residual_mode == "add" else r * res
    return r.astype(dtype)


def w8a16_matmul(
    x: jax.Array,
    qweight: PackedWeight | jax.Array,
    scales: jax.Array,
    bias: jax.Array | None = None,
    activation: str | None = None,
    residual: jax.Array | None = None,
    residual_mode: str = "add",
    bits: int = 8,
    prenorm_gamma: jax.Array | None = None,
    prenorm_eps: float = 1e-6,
) -> jax.Array:
    """out = act(x @ dequant(qweight, scales) + bias) [+|*] residual.

    Args:
      x: [..., K] float (bf16 recommended).
      qweight: PackedWeight (preferred; pack once offline) or raw int8 [K, N]
        one-value-per-int8 (packed on the fly; pass `bits=4` for int4
        values).
      scales: [N] per-output-channel or [K/g, N] group-wise scales.
      bias: optional [N].
      activation: None | "relu" | "gelu" | "silu".
      residual: optional [..., N]; residual_mode "add"|"mul".
      bits: weight bit-width when passing a raw int8 array (ignored for
        PackedWeight, which knows its own).
      prenorm_gamma: optional [K] RMSNorm gain: ``rmsnorm(x, gamma,
        prenorm_eps)`` is applied first (XLA fuses it into the producer of
        the dot's input).
    """
    if not isinstance(qweight, PackedWeight):
        qweight = pack_weights(qweight, bits=bits)
    k, n = qweight.k, qweight.n
    *lead, xk = x.shape
    if xk != k:
        raise ValueError(f"x feature dim {xk} != weight K {k}")
    if scales.ndim == 2 and k % scales.shape[0]:
        raise ValueError(f"scale rows {scales.shape[0]} must divide K {k}")
    if prenorm_gamma is not None:
        from eetq_tpu.ops.rmsnorm import rmsnorm

        x = rmsnorm(x, prenorm_gamma, eps=prenorm_eps)
    m = 1
    for d in lead:
        m *= d
    res2 = None if residual is None else residual.reshape(m, n)
    if backend.use_gemv_kernel(m) and qweight.bits == 8 and scales.ndim == 1:
        # decode regime on the GPU: the weight-streaming GEMV kernel reads
        # the padded int8 layout directly
        x2 = jnp.pad(x.reshape(m, k), ((0, 0), (0, qweight.kp - k)))
        scales_p = jnp.pad(scales.astype(jnp.float32), (0, qweight.np - n))
        acc = int8_gemv(x2, qweight.data, scales_p)[:, :n]
        out = _epilogue(acc, bias, activation, res2, residual_mode, x.dtype)
        return out.reshape(*lead, n)
    x2 = x.reshape(m, k)
    if m < MAX_M:
        # every decode-regime call runs the same [MAX_M, K] program, so a
        # row's result does not depend on how many rows share the call: a
        # speculative verify's projections over k+1 rows reproduce those
        # of sequential decode bit for bit
        x2 = jnp.pad(x2, ((0, MAX_M - m), (0, 0)))
        if res2 is not None:
            res2 = jnp.pad(res2, ((0, MAX_M - m), (0, 0)))
    out = w8a16_matmul_ref(
        x2, unpack_weights(qweight), scales, bias=bias,
        activation=activation, residual=res2, residual_mode=residual_mode,
    )
    return out[:m].reshape(*lead, n)
