"""Random-weight model construction (fp16-equivalent bf16 "reference model")
and its quantization to W8A16 params.

Used by tests and benchmarks: weights come from a seed, so benchmark models
are built from the real configs with random weights — the compute and
bandwidth profile is identical to real checkpoints.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from eetq_tpu.models.config import ModelConfig
from eetq_tpu.models.transformer import LayerParams, ModelParams
from eetq_tpu.modules.linear import DenseLinear, quantize_linear


def _dense(key, k, n, dtype, with_bias: bool = False) -> DenseLinear:
    w = jax.random.normal(key, (k, n), jnp.float32) * (k**-0.5)
    b = None
    if with_bias:
        b = (jax.random.normal(key, (n,), jnp.float32) * 0.02).astype(dtype)
    return DenseLinear(weight=w.astype(dtype), bias=b)


def _dense_experts(key, e, k, n, dtype) -> DenseLinear:
    w = jax.random.normal(key, (e, k, n), jnp.float32) * (k**-0.5)
    return DenseLinear(weight=w.astype(dtype))


def random_dense_params(
    cfg: ModelConfig, key: jax.Array, dtype=jnp.bfloat16
) -> ModelParams:
    """Unquantized (bf16) model with fused qkv / gateup linears (stacked
    expert banks + a router when cfg.num_experts is set)."""
    n_keys = cfg.num_layers * 5 + 2
    keys = iter(jax.random.split(key, n_keys))
    h = cfg.hidden_size
    layers = []
    for _ in range(cfg.num_layers):
        if cfg.num_experts:
            from eetq_tpu.modules.moe import MoEMLP

            e = cfg.num_experts
            moe = MoEMLP(
                router=_dense(next(keys), h, e, dtype),
                gateup=_dense_experts(
                    next(keys), e, h, 2 * cfg.intermediate_size, dtype
                ),
                down=_dense_experts(
                    next(keys), e, cfg.intermediate_size, h, dtype
                ),
            )
            layers.append(
                LayerParams(
                    input_norm=jnp.ones((h,), jnp.float32),
                    qkv=_dense(next(keys), h, cfg.qkv_out, dtype,
                               with_bias=cfg.qkv_bias),
                    o_proj=_dense(
                        next(keys), cfg.num_heads * cfg.head_dim, h, dtype
                    ),
                    post_norm=jnp.ones((h,), jnp.float32),
                    gateup=None,
                    down=None,
                    moe=moe,
                )
            )
            continue
        layers.append(
            LayerParams(
                input_norm=jnp.ones((h,), jnp.float32),
                qkv=_dense(next(keys), h, cfg.qkv_out, dtype,
                           with_bias=cfg.qkv_bias),
                o_proj=_dense(next(keys), cfg.num_heads * cfg.head_dim, h, dtype),
                post_norm=jnp.ones((h,), jnp.float32),
                gateup=_dense(next(keys), h, 2 * cfg.intermediate_size, dtype),
                down=_dense(next(keys), cfg.intermediate_size, h, dtype),
            )
        )
    embed = jax.random.normal(next(keys), (cfg.vocab_size, h), jnp.float32) * 0.02
    lm_head = (
        None
        if cfg.tie_word_embeddings
        else _dense(next(keys), h, cfg.vocab_size, dtype)
    )
    return ModelParams(
        embed=embed.astype(dtype),
        layers=layers,
        final_norm=jnp.ones((h,), jnp.float32),
        lm_head=lm_head,
    )


def random_quantized_params(
    cfg: ModelConfig, seed: int, bits: int = 8,
    quantize_lm_head: bool = False, group_size: int | None = None,
) -> ModelParams:
    """A quantized model at full size, made on the device one layer at a
    time: each layer's bf16 weights (normal, scaled 1/sqrt(fan_in)) are
    drawn and quantized at once, so only one layer's dense copy is ever
    live. Dense MLPs only (no MoE)."""
    if cfg.num_experts:
        raise NotImplementedError("random_quantized_params: dense MLPs only")
    h = cfg.hidden_size
    keys = jax.random.split(jax.random.PRNGKey(seed), cfg.num_layers + 2)

    def lin(key, k, n, with_bias=False):
        w = jax.random.normal(key, (k, n), jnp.bfloat16) * (k**-0.5)
        bias = None
        if with_bias:
            bias = (jax.random.normal(key, (n,), jnp.float32) * 0.02).astype(
                jnp.bfloat16
            )
        return quantize_linear(w, bias=bias, bits=bits, group_size=group_size)

    layers = []
    for i in range(cfg.num_layers):
        ks = jax.random.split(keys[i], 4)
        layers.append(LayerParams(
            input_norm=jnp.ones((h,), jnp.float32),
            qkv=lin(ks[0], h, cfg.qkv_out, with_bias=cfg.qkv_bias),
            o_proj=lin(ks[1], cfg.num_heads * cfg.head_dim, h),
            post_norm=jnp.ones((h,), jnp.float32),
            gateup=lin(ks[2], h, 2 * cfg.intermediate_size),
            down=lin(ks[3], cfg.intermediate_size, h),
        ))
        jax.block_until_ready(jax.tree.leaves(layers[-1]))
    embed = jax.random.normal(keys[-2], (cfg.vocab_size, h), jnp.bfloat16) * 0.02
    lm_head = None
    if not cfg.tie_word_embeddings:
        w = jax.random.normal(keys[-1], (h, cfg.vocab_size), jnp.bfloat16) * (
            h**-0.5
        )
        lm_head = (
            quantize_linear(w, bits=8) if quantize_lm_head
            else DenseLinear(weight=w)
        )
    return ModelParams(
        embed=embed, layers=layers, final_norm=jnp.ones((h,), jnp.float32),
        lm_head=lm_head,
    )


def quantize_params(
    params: ModelParams,
    bits: int = 8,
    quantize_lm_head: bool = False,
    group_size: int | None = None,
) -> ModelParams:
    """One-line quantize-and-swap over a params pytree: every DenseLinear in
    the decoder layers becomes a QuantLinear (per-channel symmetric W8A16;
    group_size=g for group-wise scales, the usual int4 setting).
    By default the lm_head stays dense, matching the reference's exclusion
    (`utils/base.py:273-274`: get_named_linears excludes lm_head);
    quantize_lm_head=True opts it in (halves lm_head HBM traffic per decode
    step — ~3% of a llama2-7b step — at a small logits-precision cost)."""

    def q(lin: DenseLinear):
        return quantize_linear(
            lin.weight, bias=lin.bias, bits=bits, group_size=group_size
        )

    def q_layer(lp: LayerParams) -> LayerParams:
        if lp.moe is not None:
            from eetq_tpu.modules.moe import quantize_moe

            return dataclasses_replace(
                lp,
                qkv=q(lp.qkv),
                o_proj=q(lp.o_proj),
                moe=quantize_moe(lp.moe, bits=bits, group_size=group_size),
            )
        return dataclasses_replace(
            lp,
            qkv=q(lp.qkv),
            o_proj=q(lp.o_proj),
            gateup=q(lp.gateup),
            down=q(lp.down),
        )

    layers = [q_layer(lp) for lp in params.layers]
    lm_head = params.lm_head
    if quantize_lm_head and isinstance(lm_head, DenseLinear):
        lm_head = q(lm_head)
    return dataclasses_replace(params, layers=layers, lm_head=lm_head)


def dataclasses_replace(obj, **kw):
    import dataclasses

    return dataclasses.replace(obj, **kw)
