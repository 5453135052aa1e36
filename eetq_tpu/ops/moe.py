"""`w8a16_expert_matmul` — quantized matmul against a stacked expert BANK.

The MoE extension of `ops.linear.w8a16_matmul`: the weight is a 3-D
[E, K, N] quantized bank (the reference carries exactly this "num_experts"
batched-weight quantization, `fpA_intB_gemm_wrapper.cu:44-66` /
`cutlass_preprocessors.cc:594-614`, but ships no runtime for it — here the
runtime exists). Per selection s, out[s] = x @ dequant(bank[expert_ids[s]]):
the selected experts' int8 slices are gathered and fed to the plain
dequant dot, so a routed decode step reads k/E of the bank's bytes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from eetq_tpu.layout import PackedWeight, unpack_weights
from eetq_tpu.ops.linear import w8a16_matmul_ref


def expert_matmul_ref(
    x: jax.Array,
    qweight_logical: jax.Array,
    scales: jax.Array,
    expert_ids: jax.Array,
) -> jax.Array:
    """[n_sel, m, N] = x @ dequant(bank[eid]) per selection.

    qweight_logical: int8 [E, K, N] (int4 sign-extended); scales [E, N] or
    [E, G, N].
    """
    w_sel = jnp.take(qweight_logical, expert_ids, axis=0)
    s_sel = jnp.take(scales, expert_ids, axis=0)
    return jax.vmap(lambda w, s: w8a16_matmul_ref(x, w, s))(w_sel, s_sel)


def w8a16_expert_matmul(
    x: jax.Array,
    qweight: PackedWeight,
    scales: jax.Array,
    expert_ids: jax.Array,
) -> jax.Array:
    """out[s] = x @ dequant(qweight[expert_ids[s]], scales[expert_ids[s]]).

    Args:
      x: [m, K] float (every selection sees all m rows; at decode m is the
        token batch and the caller picks its own row out of each selection).
      qweight: 3-D PackedWeight (data [E, Kp, Np], int4 nibble-packed).
      scales: [E, N] per-channel or [E, G, N] group-wise.
      expert_ids: [n_sel] int32 expert index per selection (may repeat).

    Returns [n_sel, m, N] in x.dtype.
    """
    if qweight.data.ndim != 3:
        raise ValueError(f"expert bank must be 3-D, got {qweight.data.shape}")
    k = qweight.k
    m, xk = x.shape
    if xk != k:
        raise ValueError(f"x feature dim {xk} != weight K {k}")
    if scales.ndim == 3:
        if k % scales.shape[1]:
            raise ValueError(
                f"scale rows {scales.shape[1]} must divide K {k}"
            )
    elif scales.ndim != 2:
        raise ValueError(f"scales must be [E, N] or [E, G, N], got {scales.shape}")
    # gather the selected experts' PACKED slices first, so only their bytes
    # are read and unpacked
    sel = PackedWeight(
        data=jnp.take(qweight.data, expert_ids, axis=0), k=k, n=qweight.n,
        bits=qweight.bits,
    )
    s_sel = jnp.take(scales, expert_ids, axis=0)
    w_sel = unpack_weights(sel)
    return jax.vmap(lambda w, s: w8a16_matmul_ref(x, w, s))(w_sel, s_sel)
