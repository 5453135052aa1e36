"""Quantized linear layers as functional pytree modules.

The functional re-design of the reference's `W8A16Linear` / `EetqLinear` /
`W8A16LoraLinear` (`python/eetq/modules/qlinear.py`). Instead of nn.Module
buffers, each layer is a frozen dataclass pytree of arrays; `linear_apply`
is the forward. This is what makes runtime tensor parallelism trivial: pjit
shards these pytrees with NamedSharding rules (eetq_tpu.dist).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from eetq_tpu.layout import PackedWeight, pack_weights
from eetq_tpu.ops import w8a16_matmul
from eetq_tpu.quant import symmetric_quantize


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class DenseLinear:
    """Unquantized linear (kept in bf16), weight stored [K, N]."""

    weight: jax.Array
    bias: jax.Array | None = None

    @property
    def in_features(self) -> int:
        return self.weight.shape[0]

    @property
    def out_features(self) -> int:
        return self.weight.shape[1]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class QuantLinear:
    """W8A16 linear: int8 qweight (packed [Kp, Np]) + per-channel scales [N].

    Mirrors the reference's buffer layout — qweight [in, out] int8 + fp
    weight_scales [out] (`modules/qlinear.py:27-41`) — with the packed tile
    layout of eetq_tpu.layout instead of the reference's interleave.
    """

    qweight: PackedWeight
    scales: jax.Array
    bias: jax.Array | None = None

    @property
    def in_features(self) -> int:
        return self.qweight.k

    @property
    def out_features(self) -> int:
        return self.qweight.n


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class LoraAdapter:
    """Unquantized low-rank side path: x @ A @ B * scaling.

    The analogue of `W8A16LoraLinear` (`modules/qlinear.py:127-186`): base
    GEMM stays quantized/frozen, the LoRA path runs in bf16 and its params
    are the only trainable leaves.
    """

    lora_a: jax.Array  # [K, r]
    lora_b: jax.Array  # [r, N]
    scaling: float = dataclasses.field(default=1.0, metadata=dict(static=True))


def quantize_linear(
    weight: jax.Array,
    bias: jax.Array | None = None,
    bits: int = 8,
    group_size: int | None = None,
    external_scales: jax.Array | None = None,
) -> QuantLinear:
    """Build a QuantLinear from a float [K, N] weight.

    bits: 8 (W8A16) or 4 (W4A16, nibble-packed storage).
    group_size: None for per-channel scales; an int g for group-wise
      scales [K/g, N] (reference GEMV GroupWise(64/128) mode).
    external_scales supports the bitsandbytes import path (reference
    `utils/quantizer.py:23-25`: already-int8 weights with scales = SCB/127) —
    pass pre-quantized int8 `weight` plus its scales and it is repacked
    without requantization.
    """
    if weight.dtype == jnp.int8:
        if external_scales is None:
            raise ValueError("int8 weight requires external_scales")
        return QuantLinear(
            qweight=pack_weights(weight, bits=bits),
            scales=external_scales,
            bias=bias,
        )
    if external_scales is not None:
        raise ValueError("external_scales only valid with int8 weight")
    q, s = symmetric_quantize(weight, bits=bits, group_size=group_size)
    return QuantLinear(qweight=pack_weights(q, bits=bits), scales=s, bias=bias)


def init_only_linear(k: int, n: int, with_bias: bool = False) -> QuantLinear:
    """Empty shell for checkpoint loading (reference `init_only=True`,
    `utils/quantizer.py:13-38`)."""
    q = jnp.zeros((k, n), dtype=jnp.int8)
    return QuantLinear(
        qweight=pack_weights(q),
        scales=jnp.zeros((n,), dtype=jnp.float32),
        bias=jnp.zeros((n,), dtype=jnp.bfloat16) if with_bias else None,
    )


def linear_apply(
    layer: QuantLinear | DenseLinear,
    x: jax.Array,
    activation: str | None = None,
    lora: LoraAdapter | None = None,
    residual: jax.Array | None = None,
    a8: bool = False,
    prenorm: tuple[jax.Array, float] | None = None,
    lora_idx: jax.Array | None = None,
) -> jax.Array:
    """Forward through a (quantized or dense) linear with optional fused
    activation, fused residual add, and LoRA side path.

    Multi-adapter serving (the LoRAX hosting model the reference's LoRA
    machinery exists for, reference `README.md:96-101`): when `lora`
    carries a BANK — lora_a [n_adapters, K, r], lora_b [n_adapters, r, N]
    — `lora_idx` [B] selects each batch row's adapter. The gathered
    adapters are tiny next to the base weight stream (K*r + r*N elements
    per row), so mixed-adapter batches decode at full speed.

    a8=True uses the W8A8/W4A8 path (dynamic per-token int8 activations,
    int8 tensor cores at 2x the bf16 rate) when the layer is an int8 per-channel
    or int4 (per-channel or group-wise) QuantLinear — the compute-bound
    prefill accelerator; ignored otherwise.

    prenorm=(gamma, eps) applies rmsnorm(x, gamma, eps) before the matmul
    (XLA fuses it into the producer of the dot's input); not combinable
    with LoRA.
    """
    if lora is not None and residual is not None:
        raise ValueError("fused residual with LoRA is not supported")
    if prenorm is not None and lora is not None:
        raise ValueError("prenorm with LoRA is not supported")

    def _maybe_norm(x):
        if prenorm is None:
            return x
        from eetq_tpu.ops import rmsnorm

        return rmsnorm(x, prenorm[0], eps=prenorm[1])

    if isinstance(layer, QuantLinear):
        if (
            a8
            and residual is None
            and (
                (layer.qweight.bits == 8 and layer.scales.ndim == 1)
                or layer.qweight.bits == 4
            )
        ):
            from eetq_tpu.ops import w8a8_matmul

            out = w8a8_matmul(
                _maybe_norm(x), layer.qweight, layer.scales, bias=layer.bias,
                activation=activation,
            )
        else:
            out = w8a16_matmul(
                x, layer.qweight, layer.scales, bias=layer.bias,
                activation=activation, residual=residual,
                prenorm_gamma=None if prenorm is None else prenorm[0],
                prenorm_eps=1e-6 if prenorm is None else prenorm[1],
            )
    else:
        x = _maybe_norm(x)
        # bf16 output (the dot still accumulates in f32 internally); an f32
        # output dtype would double the HBM write traffic of large prefill
        # activations for no accuracy gain.
        out = jnp.dot(x, layer.weight.astype(x.dtype))
        if layer.bias is not None:
            out = out + layer.bias.astype(out.dtype)
        if activation is not None:
            out = {"relu": jax.nn.relu, "gelu": jax.nn.gelu, "silu": jax.nn.silu}[
                activation
            ](out.astype(jnp.float32))
        if residual is not None:
            out = out + residual.astype(out.dtype)
        out = out.astype(x.dtype)
    if lora is not None:
        if activation is not None:
            raise ValueError("LoRA with fused activation is not supported")
        if lora.lora_a.ndim == 3:  # adapter bank: per-row selection
            if lora_idx is None:
                raise ValueError("banked LoRA requires lora_idx [B]")
            a_sel = lora.lora_a[lora_idx].astype(x.dtype)  # [B, K, r]
            b_sel = lora.lora_b[lora_idx].astype(x.dtype)  # [B, r, N]
            side = jnp.einsum("bsk,bkr->bsr", x, a_sel)
            side = jnp.einsum("bsr,brn->bsn", side, b_sel)
        else:
            side = (x @ lora.lora_a.astype(x.dtype)) @ lora.lora_b.astype(
                x.dtype
            )
        out = out + side * lora.scaling
    return out
