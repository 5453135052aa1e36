"""LoRA utilities over params pytrees: attach adapters to a (quantized)
model and merge-then-quantize.

The serving use-case the reference's LoRA machinery exists for
(`modules/qlinear.py:127-186` W8A16LoraLinear; LoRAX hosts eetq base
weights with per-request adapters, `README.md:96-101`), plus the
merge-and-unload-then-quantize flow of the reference's LoRA example
(`examples/models/llama_transformers_example.py:164-197`: peft
merge_and_unload -> eet_accelerator).

- `attach_lora`: put LoraAdapter side paths on the attention projections
  of every layer (B initialized to zero -> the adapter starts as a no-op,
  the standard LoRA init).
- `merge_lora`: fold each adapter's A@B*scaling delta into its base
  weight. Quantized bases are dequantized, merged, and REquantized (the
  analogue of merge_and_unload on fp16 weights followed by
  quantization) — afterwards the model serves at full quantized-GEMM
  speed with no side path.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from eetq_tpu.layout import unpack_weights
from eetq_tpu.models.transformer import LayerParams, ModelParams
from eetq_tpu.modules.linear import DenseLinear, LoraAdapter, QuantLinear, quantize_linear


def init_lora(key: jax.Array, k: int, n: int, rank: int,
              alpha: float = 16.0, dtype=jnp.bfloat16) -> LoraAdapter:
    """Standard LoRA init: A ~ N(0, 1/r) (kaiming-ish), B = 0 so the
    adapter starts as an exact no-op; scaling = alpha / rank."""
    a = jax.random.normal(key, (k, rank), jnp.float32) / jnp.sqrt(rank)
    return LoraAdapter(
        lora_a=a.astype(dtype),
        lora_b=jnp.zeros((rank, n), dtype),
        scaling=alpha / rank,
    )


def attach_lora(
    params: ModelParams,
    rank: int,
    key: jax.Array,
    alpha: float = 16.0,
    targets: tuple[str, ...] = ("qkv", "o"),
) -> ModelParams:
    """Attach fresh (no-op) adapters to every layer's qkv and/or o_proj —
    the projections the reference's LoRA example targets
    (`llama_transformers_example.py:183-189`: q/k/v)."""
    layers = []
    keys = jax.random.split(key, 2 * len(params.layers))
    for i, lp in enumerate(params.layers):
        upd = {}
        if "qkv" in targets:
            upd["qkv_lora"] = init_lora(
                keys[2 * i], lp.qkv.in_features, lp.qkv.out_features, rank,
                alpha,
            )
        if "o" in targets:
            upd["o_lora"] = init_lora(
                keys[2 * i + 1], lp.o_proj.in_features,
                lp.o_proj.out_features, rank, alpha,
            )
        layers.append(dataclasses.replace(lp, **upd))
    return dataclasses.replace(params, layers=layers)


def _merge_one(base, lora: LoraAdapter | None, bits: int = 8):
    if lora is None:
        return base
    delta = (
        lora.lora_a.astype(jnp.float32) @ lora.lora_b.astype(jnp.float32)
    ) * lora.scaling
    if isinstance(base, QuantLinear):
        q = unpack_weights(base.qweight).astype(jnp.float32)
        if base.scales.ndim == 1:  # per-channel
            w = q * base.scales[None, :]
            group_size = None
        else:  # group-wise [G, N] (the usual int4 / W4A16 base)
            gcount = base.scales.shape[0]
            group_size = q.shape[0] // gcount
            w = q * jnp.repeat(
                base.scales.astype(jnp.float32), group_size, axis=0
            )
        return quantize_linear(w + delta, bias=base.bias,
                               bits=base.qweight.bits,
                               group_size=group_size)
    return dataclasses.replace(
        base, weight=(base.weight.astype(jnp.float32) + delta).astype(
            base.weight.dtype
        )
    )


def merge_lora(params: ModelParams) -> ModelParams:
    """Fold every attached adapter into its base projection and drop the
    side paths. Quantized bases are requantized after the merge."""
    layers = [
        dataclasses.replace(
            lp,
            qkv=_merge_one(lp.qkv, lp.qkv_lora),
            o_proj=_merge_one(lp.o_proj, lp.o_lora),
            qkv_lora=None,
            o_lora=None,
        )
        for lp in params.layers
    ]
    return dataclasses.replace(params, layers=layers)


def stack_adapters(adapted: list[ModelParams]) -> ModelParams:
    """Stack N separately-adapted copies of the SAME base model into one
    multi-adapter model: every attached LoraAdapter's a/b gain a leading
    [n_adapters] bank axis, selected per batch row at serve time via
    `lora_idx` (modules.linear.linear_apply) / per request via
    `Engine.add_request(lora_id=...)`.

    This is the LoRAX hosting model the reference's LoRA machinery exists
    to serve (reference `README.md:96-101`: one quantized base, many
    per-request adapters): base weights are taken from adapted[0] (they
    must be shared), adapters from all. All models must have adapters on
    the same projections with the same rank and scaling."""
    if not adapted:
        raise ValueError("need at least one adapted model")
    base = adapted[0]

    def bank(get):
        ads = [get(p) for p in adapted]
        if any(a is None for a in ads):
            if not all(a is None for a in ads):
                raise ValueError("adapters must target the same projections")
            return None
        if len({a.scaling for a in ads}) != 1:
            raise ValueError("bank adapters must share one scaling")
        return LoraAdapter(
            lora_a=jnp.stack([a.lora_a for a in ads]),
            lora_b=jnp.stack([a.lora_b for a in ads]),
            scaling=ads[0].scaling,
        )

    layers = [
        dataclasses.replace(
            lp,
            qkv_lora=bank(lambda p, i=i: p.layers[i].qkv_lora),
            o_lora=bank(lambda p, i=i: p.layers[i].o_lora),
        )
        for i, lp in enumerate(base.layers)
    ]
    return dataclasses.replace(base, layers=layers)
