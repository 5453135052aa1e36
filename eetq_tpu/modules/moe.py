"""Mixture-of-Experts MLP over quantized expert banks (Mixtral-style).

The reference carries 3-D "num_experts" batched quantization end to end
(`fpA_intB_gemm_wrapper.cu:44-66`, `cutlass_preprocessors.cc:594-614`,
MoE-aware layout traits `mixed_gemm_B_layout.h:1-4`) but hardcodes
num_experts=1 in its GEMM runner and ships no router — the infrastructure
without the runtime. This module is the runtime:

- experts live as ONE stacked [E, K, N] quantized bank (a 3-D PackedWeight —
  the layout the quantizer/native preprocessor already produce);
- routing is a top-k softmax over a small bf16 router linear;
- **decode** (few selections) runs `ops.moe.w8a16_expert_matmul`: the
  selected experts' int8 slices are gathered into the plain dequant dot,
  so top-2-of-8 decode reads 1/4 of the bank's bytes;
- **prefill** of per-channel quantized banks sorts the (token, expert)
  selections by expert and runs `jax.lax.ragged_dot` over the expert
  groups — routed k/E FLOPs; other banks (dense, group-wise) run a
  `lax.scan` over experts whose outputs are masked by the routing weights
  (exact, static shapes, E/k times the routed FLOPs);
- **expert parallelism**: under shard_map the local bank holds E/p experts;
  prefill takes the routed path per shard when k < E/p (non-local
  selections park on local expert 0 with a zero combine weight) and the
  masked scan otherwise; the decoder's existing row-parallel psum completes
  the combine (see models.transformer.decoder_layer).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from eetq_tpu.layout import unpack_weights
from eetq_tpu.modules.linear import DenseLinear, QuantLinear
from eetq_tpu.ops.linear import w8a16_matmul_ref
from eetq_tpu.ops.moe import w8a16_expert_matmul
from eetq_tpu.quant import symmetric_quantize

# Routed decode gathers the selected experts while the selection count
# stays this small; beyond it (prefill) the grouped or masked paths run.
MAX_GATHER_SELECTIONS = 8

_ACT = {"silu": jax.nn.silu, "gelu": jax.nn.gelu, "relu": jax.nn.relu}


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class MoEMLP:
    """Routed MLP block: router [H, E] + stacked expert gate/up and down.

    gateup/down are QuantLinear (3-D PackedWeight data [E, Kp, Np], scales
    [E, N] or [E, G, N]) or DenseLinear (3-D weight [E, K, N], bf16)."""

    router: DenseLinear  # weight [H, E]
    gateup: QuantLinear | DenseLinear  # [E, H, 2I]
    down: QuantLinear | DenseLinear  # [E, I, H]

    @property
    def num_local_experts(self) -> int:
        w = (
            self.gateup.qweight.data
            if isinstance(self.gateup, QuantLinear)
            else self.gateup.weight
        )
        return w.shape[0]


def quantize_moe(
    moe: MoEMLP, bits: int = 8, group_size: int | None = None
) -> MoEMLP:
    """Quantize a dense MoEMLP's expert banks (router stays bf16 — it is a
    [H, E] sliver whose logits decide routing; quantizing it risks flipped
    top-k picks for ~zero bytes saved)."""
    from eetq_tpu.layout import pack_weights

    def q(lin: DenseLinear) -> QuantLinear:
        if lin.bias is not None:
            raise NotImplementedError("expert biases not supported")
        qw, s = symmetric_quantize(lin.weight, bits=bits, group_size=group_size)
        return QuantLinear(qweight=pack_weights(qw, bits=bits), scales=s)

    return MoEMLP(router=moe.router, gateup=q(moe.gateup), down=q(moe.down))


def route(
    router: DenseLinear, x2: jax.Array, top_k: int
) -> tuple[jax.Array, jax.Array]:
    """Top-k routing: softmax over the selected logits (the Mixtral
    convention — normalize AFTER top-k). x2 [T, H] -> (weights [T, k] f32,
    ids [T, k] int32)."""
    logits = jnp.dot(
        x2, router.weight.astype(x2.dtype), preferred_element_type=jnp.float32
    )
    topv, topi = jax.lax.top_k(logits, top_k)
    topw = jax.nn.softmax(topv, axis=-1)
    return topw, topi.astype(jnp.int32)


def _gated(gu_out: jax.Array, activation: str, dtype) -> jax.Array:
    gate, up = jnp.split(gu_out, 2, axis=-1)
    return (
        _ACT[activation](gate.astype(jnp.float32)) * up.astype(jnp.float32)
    ).astype(dtype)


def moe_grouped_combine(
    moe: MoEMLP,
    x2: jax.Array,  # [T, H]
    topw: jax.Array,  # [T, k] f32
    topi: jax.Array,  # [T, k] int32 (GLOBAL expert ids)
    activation: str,
    tp_axis: str | None = None,
) -> jax.Array:
    """Routed MoE prefill over per-channel quantized banks: sort the
    (token, expert) selections by expert, run `jax.lax.ragged_dot` over the
    expert groups (the int8 bank converts to x's dtype inside the dot, the
    per-channel scales of each row's expert multiply the f32 result), then
    un-sort and combine with the routing weights. FLOPs are the ROUTED k/E
    fraction instead of the masked scan's all-E dense compute.

    Under EP (tp_axis set, local E/p bank): selections routed to OTHER
    shards' experts keep their rows (static shapes) but compute against
    local expert 0 with a ZERO combine weight, and the caller's psum
    completes the cross-shard sum.

    Returns [T, H] f32 (caller casts / reshapes)."""
    t, h = x2.shape
    top_k = topi.shape[-1]
    e = moe.num_local_experts
    eids = topi.reshape(-1)  # [S] global
    wflat = topw.reshape(-1)
    if tp_axis is not None:
        off = jax.lax.axis_index(tp_axis) * e
        local = (eids >= off) & (eids < off + e)
        # non-local selections: park on local expert 0 with zero weight
        eids = jnp.where(local, eids - off, 0).astype(jnp.int32)
        wflat = jnp.where(local, wflat, 0.0)
    order = jnp.argsort(eids, stable=True)  # sorted-selection -> selection
    e_sorted = eids[order]
    counts = jnp.sum(jax.nn.one_hot(eids, e, dtype=jnp.int32), axis=0)

    def project(lin: QuantLinear, rows: jax.Array) -> jax.Array:
        bank = unpack_weights(lin.qweight).astype(rows.dtype)  # [E, K, N]
        acc = jax.lax.ragged_dot(
            rows, bank, counts, preferred_element_type=jnp.float32
        )
        return (acc * lin.scales[e_sorted].astype(jnp.float32)).astype(
            rows.dtype
        )

    xs = x2[order // top_k]  # [S, H] token rows in sorted order
    hidden = _gated(project(moe.gateup, xs), activation, x2.dtype)
    dn_sorted = project(moe.down, hidden)  # [S, H]
    contrib = (
        jnp.zeros_like(dn_sorted).at[order].set(dn_sorted)
    ).astype(jnp.float32)
    return jnp.sum(
        contrib.reshape(t, top_k, h)
        * wflat.reshape(t, top_k)[..., None].astype(jnp.float32),
        axis=1,
    )


def moe_apply(
    moe: MoEMLP,
    x: jax.Array,
    top_k: int,
    activation: str = "silu",
    tp_axis: str | None = None,
) -> jax.Array:
    """Routed MLP forward. x [B, S, H] (already normed) -> [B, S, H].

    Under expert parallelism (tp_axis set, inside shard_map) the banks hold
    the LOCAL E/p experts; the return value is this shard's partial combine
    and the caller psums it (same contract as the row-parallel down proj).
    """
    b, s, h = x.shape
    t = b * s
    x2 = x.reshape(t, h)
    quantized = isinstance(moe.gateup, QuantLinear)

    topw, topi = route(moe.router, x2, top_k)  # [T, k]

    e_local = moe.num_local_experts
    n_sel = t * top_k
    per_channel = quantized and moe.gateup.scales.ndim == 2
    if (
        quantized
        and tp_axis is None
        and n_sel <= min(MAX_GATHER_SELECTIONS, e_local)
    ):
        # Decode regime: gather exactly the selected experts' int8 slices.
        eids = topi.reshape(-1)
        sel = jnp.arange(n_sel)
        tok = sel // top_k
        gu_sel = w8a16_expert_matmul(
            x2, moe.gateup.qweight, moe.gateup.scales, eids
        )  # [n_sel, T, 2I]
        hidden = _gated(gu_sel[sel, tok], activation, x2.dtype)  # [n_sel, I]
        dn_sel = w8a16_expert_matmul(
            hidden, moe.down.qweight, moe.down.scales, eids
        )  # [n_sel, n_sel, H]
        dn_rows = dn_sel[sel, sel].astype(jnp.float32)  # [n_sel, H]
        out2 = jnp.sum(
            dn_rows.reshape(t, top_k, h) * topw[..., None], axis=1
        )
        return out2.astype(x.dtype).reshape(b, s, h)
    if (
        per_channel
        and n_sel > MAX_GATHER_SELECTIONS
        # Under EP every shard still computes T*k selection rows (non-local
        # ones park on local expert 0 with zero weight — static shapes);
        # the masked scan computes T*E_local rows per shard, so the routed
        # path only wins when k < E_local.
        and (tp_axis is None or top_k < e_local)
    ):
        out2 = moe_grouped_combine(
            moe, x2, topw, topi, activation, tp_axis=tp_axis
        )
        return out2.astype(x.dtype).reshape(b, s, h)

    # Dense-masked scan over (local) experts: coeff[t, e] = routing weight
    # if expert e was picked for token t else 0. Exact for any T.
    e_global = moe.router.weight.shape[-1]
    coeff = jnp.sum(
        jax.nn.one_hot(topi, e_global, dtype=jnp.float32) * topw[..., None],
        axis=-2,
    )  # [T, E_global]
    if tp_axis is not None and e_local != e_global:
        off = jax.lax.axis_index(tp_axis) * e_local
        coeff = jax.lax.dynamic_slice(coeff, (0, off), (t, e_local))
    coeff_t = coeff.T  # [E_local, T]

    if quantized:
        gu_logical = unpack_weights(moe.gateup.qweight)
        dn_logical = unpack_weights(moe.down.qweight)

        def body(acc, xs_):
            wg, sg, wd, sd, c = xs_
            g_out = w8a16_matmul_ref(x2, wg, sg).astype(x2.dtype)
            hidden = _gated(g_out, activation, x2.dtype)
            d_out = w8a16_matmul_ref(hidden, wd, sd)
            return acc + c[:, None] * d_out.astype(jnp.float32), None

        xs = (gu_logical, moe.gateup.scales, dn_logical, moe.down.scales,
              coeff_t)
    else:

        def body(acc, xs_):
            wg, wd, c = xs_
            g_out = jnp.dot(x2, wg.astype(x2.dtype))
            hidden = _gated(g_out, activation, x2.dtype)
            d_out = jnp.dot(hidden, wd.astype(hidden.dtype))
            return acc + c[:, None] * d_out.astype(jnp.float32), None

        xs = (moe.gateup.weight, moe.down.weight, coeff_t)

    out2, _ = jax.lax.scan(body, jnp.zeros((t, h), jnp.float32), xs)
    return out2.astype(x.dtype).reshape(b, s, h)
