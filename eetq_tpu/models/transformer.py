"""The decoder-only transformer forward: one parameterized architecture for
the llama family (llama / tinyllama / mistral / gemma / baichuan).

Re-designs the reference's per-model nn.Module surgery
(`python/eetq/models/{llama,baichuan,gemma}.py` + fused attention modules in
`modules/llama_modules.py`) as a single functional forward over a params
pytree. QKV and gate/up are FUSED linears (one quantized GEMM each — the
reference's `fuse_qkv_gateup`, `models/llama.py:39-77`); per-output-channel
scales make fusion/splitting scale-exact.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp

from eetq_tpu.models.config import ModelConfig
from eetq_tpu.modules.attention import KVCache, attention, init_kv_cache
from eetq_tpu.modules.linear import (
    DenseLinear,
    LoraAdapter,
    QuantLinear,
    linear_apply,
)
from eetq_tpu.ops import make_cos_sin_cache, rmsnorm, rope

Linear = Any  # QuantLinear | DenseLinear


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class LayerParams:
    input_norm: jax.Array
    qkv: Linear  # fused [H, (Hq + 2*Hkv) * D]
    o_proj: Linear
    post_norm: jax.Array
    gateup: Linear | None  # fused [H, 2 * I]; None for MoE layers
    down: Linear | None
    qkv_lora: LoraAdapter | None = None
    o_lora: LoraAdapter | None = None
    moe: Any | None = None  # modules.moe.MoEMLP for routed-MLP layers


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ModelParams:
    embed: jax.Array  # [V, H]
    layers: list[LayerParams]
    final_norm: jax.Array
    lm_head: Linear | None  # None -> tied to embed


def _norm(x, gamma, cfg: ModelConfig):
    if cfg.rmsnorm_unit_offset:  # gemma stores gamma - 1
        gamma = gamma + 1.0
    return rmsnorm(x, gamma, eps=cfg.rms_eps)


def _maybe_psum(x, tp_axis):
    return jax.lax.psum(x, tp_axis) if tp_axis is not None else x


def decoder_layer(
    p: LayerParams,
    cfg: ModelConfig,
    x: jax.Array,
    positions: jax.Array,
    cos_sin: jax.Array,
    cache: KVCache | None,
    offset,
    tp: int = 1,
    tp_axis: str | None = None,
    a8: bool = False,
    lora_idx: jax.Array | None = None,
    verify: bool = False,
) -> tuple[jax.Array, KVCache | None]:
    """One decoder layer.

    verify=True: the S > 1 tokens sit at a DYNAMIC offset and attend
    causally over the cache prefix plus themselves (speculative-decoding
    verify step; see modules.attention.attention_verify).

    lora_idx [B]: per-row adapter selection when the layer's adapters are
    BANKS (multi-adapter serving; see modules.linear.linear_apply).

    a8 routes the (compute-bound) projections through the W8A8
    int8-activation path — enable for prefill only.

    Under tensor parallelism (tp > 1, inside shard_map): p holds the LOCAL
    shard — qkv/gateup column-parallel (local output columns), o_proj/down
    row-parallel (local input rows) — and the Megatron-style psum combines
    the row-parallel partial sums. Attention runs entirely on local heads
    (zero communication; GQA q-heads co-located with their kv head)."""
    b, s, h = x.shape
    hq, hkv, d = cfg.num_heads // tp, cfg.num_kv_heads // tp, cfg.head_dim

    # --- attention block ---
    residual = x
    # RMSNorm is handed to linear_apply as a prenorm; XLA fuses it into the
    # producer of the projection's input.
    gamma1 = p.input_norm + 1.0 if cfg.rmsnorm_unit_offset else p.input_norm
    if p.qkv_lora is None:
        qkv = linear_apply(
            p.qkv, x, a8=a8, prenorm=(gamma1, cfg.rms_eps)
        )  # [b, s, (hq+2hkv)*d] local
    else:
        y = _norm(x, p.input_norm, cfg)
        qkv = linear_apply(p.qkv, y, lora=p.qkv_lora, a8=a8,
                           lora_idx=lora_idx)
    q, k, v = jnp.split(qkv, [hq * d, (hq + hkv) * d], axis=-1)
    q = q.reshape(b, s, hq, d)
    k = k.reshape(b, s, hkv, d)
    v = v.reshape(b, s, hkv, d)
    slopes = None
    if cfg.alibi:
        # ALiBi replaces RoPE (baichuan-13b). Slopes are per GLOBAL q head;
        # under TP each shard takes its local contiguous head slice.
        from eetq_tpu.ops.alibi import alibi_slopes

        slopes = jnp.asarray(alibi_slopes(cfg.num_heads))
        if tp_axis is not None:
            start = jax.lax.axis_index(tp_axis) * hq
            slopes = jax.lax.dynamic_slice(slopes, (start,), (hq,))
    else:
        q = rope(q, positions, cos_sin, interleaved=cfg.rope_interleaved)
        k = rope(k, positions, cos_sin, interleaved=cfg.rope_interleaved)
    attn, cache = attention(
        q, k, v, cache, offset, window=cfg.sliding_window, slopes=slopes,
        verify=verify,
    )
    o = linear_apply(p.o_proj, attn.reshape(b, s, hq * d), lora=p.o_lora,
                     a8=a8, lora_idx=lora_idx)
    x = residual + _maybe_psum(o, tp_axis)

    # --- mlp block (fused gate/up, gated activation) ---
    residual = x
    if p.moe is not None:
        # Routed MoE MLP (mixtral): norm -> router -> top-k expert combine.
        # Under EP (experts sharded over tp_axis) moe_apply returns the
        # local-expert partial sum and the psum completes it — the same
        # contract as the row-parallel down projection.
        from eetq_tpu.modules.moe import moe_apply

        y = _norm(x, p.post_norm, cfg)
        out = moe_apply(
            p.moe, y, cfg.num_experts_per_tok, activation=cfg.activation,
            tp_axis=tp_axis,
        )
        return residual + _maybe_psum(out, tp_axis), cache
    gamma2 = p.post_norm + 1.0 if cfg.rmsnorm_unit_offset else p.post_norm
    gateup = linear_apply(
        p.gateup, x, a8=a8, prenorm=(gamma2, cfg.rms_eps)
    )  # [b, s, 2*i_local]
    gate, up = jnp.split(gateup, 2, axis=-1)
    act = {"silu": jax.nn.silu, "gelu": jax.nn.gelu, "relu": jax.nn.relu}[
        cfg.activation
    ]
    h_mlp = (act(gate.astype(jnp.float32)) * up.astype(jnp.float32)).astype(x.dtype)
    down = linear_apply(p.down, h_mlp, a8=a8)
    x = residual + _maybe_psum(down, tp_axis)
    return x, cache


def forward_inner(
    params: ModelParams,
    cfg: ModelConfig,
    tokens: jax.Array,  # [B, S] int32
    positions: jax.Array,  # [B, S] int32
    caches: list[KVCache] | None,
    offset,
    tp: int = 1,
    tp_axis: str | None = None,
    a8: bool = False,
    lora_idx: jax.Array | None = None,
    verify: bool = False,
    last_only: bool = False,
    last_pos: jax.Array | None = None,
) -> tuple[jax.Array, list[KVCache] | None]:
    """Un-jitted forward body; called directly inside shard_map by
    eetq_tpu.dist (tp > 1) and via the jitted `forward` single-device.

    last_only=True computes the lm_head on the LAST position only (logits
    [B, 1, V]) — prefill needs just the next-token logits, and the full
    [B, S, V] head output is the largest prefill temp (262 MB at 13B b=4
    p=1024) plus S x the head FLOPs. last_pos [B] int32 is the per-row
    variant for right-padded prefill buckets: gather each row's hidden
    state at its own index before the head (logits [B, 1, V])."""
    x = params.embed[tokens].astype(jnp.bfloat16)
    if cfg.embedding_multiplier is not None:
        x = (x.astype(jnp.float32) * cfg.embedding_multiplier).astype(x.dtype)
    cos_sin = make_cos_sin_cache(cfg.max_position, cfg.rot_dim, base=cfg.rope_theta)

    new_caches = [] if caches is not None else None
    for i, layer in enumerate(params.layers):
        cache_i = caches[i] if caches is not None else None
        x, cache_i = decoder_layer(
            layer, cfg, x, positions, cos_sin, cache_i, offset,
            tp=tp, tp_axis=tp_axis, a8=a8, lora_idx=lora_idx, verify=verify,
        )
        if new_caches is not None:
            new_caches.append(cache_i)

    x = _norm(x, params.final_norm, cfg)
    if last_only:
        x = x[:, -1:, :]
    elif last_pos is not None:
        x = jax.vmap(
            lambda row, t: jax.lax.dynamic_slice_in_dim(row, t, 1, axis=0)
        )(x, last_pos)
    if params.lm_head is not None:
        # Column-parallel lm_head under TP: gather local vocab shards.
        logits = linear_apply(params.lm_head, x)
        if tp_axis is not None:
            logits = jax.lax.all_gather(logits, tp_axis, axis=2, tiled=True)
    else:
        logits = jnp.dot(
            x, params.embed.T.astype(x.dtype), preferred_element_type=jnp.float32
        )
    return logits.astype(jnp.float32), new_caches


@functools.partial(jax.jit, static_argnames=("cfg", "a8", "last_only"))
def forward(
    params: ModelParams,
    cfg: ModelConfig,
    tokens: jax.Array,
    positions: jax.Array,
    caches: list[KVCache] | None,
    offset,
    a8: bool = False,
    lora_idx: jax.Array | None = None,
    last_only: bool = False,
) -> tuple[jax.Array, list[KVCache] | None]:
    """Single-device forward. Returns (logits [B, S, V] f32, caches);
    last_only=True returns [B, 1, V] (see forward_inner)."""
    return forward_inner(
        params, cfg, tokens, positions, caches, offset, a8=a8,
        lora_idx=lora_idx, last_only=last_only,
    )


def init_caches(
    cfg: ModelConfig, batch: int, max_len: int, dtype=jnp.bfloat16
) -> list[KVCache]:
    return [
        init_kv_cache(batch, max_len, cfg.num_kv_heads, cfg.head_dim, dtype)
        for _ in range(cfg.num_layers)
    ]
