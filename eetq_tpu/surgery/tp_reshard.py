"""Offline tensor-parallel resharding of quantized checkpoints.

The reference's `quantize(save_dir, tp)` flow (`models/base.py:74-102`,
`utils/base.py:132-250`, `models/llama.py:92-132`) splits fused projections
into tp shards BEFORE quantization so each shard gets its own per-channel
scales, then merges the shards back into one checkpoint that TGI/LoRAX
re-slice per rank at load.

The formulation here collapses that machinery into two facts:

1. Column-parallel layers (qkv, gate/up): scales are per OUTPUT channel, so
   per-shard quantization is bit-identical to global quantization — no
   splitting needed (property-tested in tests/test_tp_reshard.py). GQA is
   handled correctly (the reference's merge assumed equal q/k/v sizes —
   SURVEY.md quirk list — which breaks for GQA).
2. Row-parallel layers (o_proj, down): each rank's K-slice quantized
   independently == group-wise quantization with group_size = K/tp. The
   merged artifact is therefore just a group-wise QuantLinear — which our
   kernel executes DIRECTLY (the reference's merged module is a checkpoint
   container that cannot run; ours serves single-chip bit-exactly and
   re-slices to tp ranks losslessly).

`shard_quantized` slices a (TP-)quantized model onto a mesh without
requantization: column layers slice qweight+scales along N; row layers
slice K rows and take the matching scale-row block.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from eetq_tpu.models.config import ModelConfig
from eetq_tpu.models.transformer import LayerParams, ModelParams
from eetq_tpu.modules.linear import DenseLinear, QuantLinear, quantize_linear
from eetq_tpu.layout import pack_weights, unpack_weights


def quantize_params_tp(
    params: ModelParams,
    cfg: ModelConfig,
    tp: int,
    bits: int = 8,
) -> ModelParams:
    """Quantize a dense model so the artifact is exactly what independent
    per-shard quantization at tensor parallelism `tp` would produce.

    tp == 1 is plain per-channel quantization. Row-parallel layers come out
    with group-wise scales [tp, N] (group = K/tp); everything else
    per-channel. lm_head stays dense (reference exclusion,
    `utils/base.py:273-274`).
    """
    if any(lp.moe is not None for lp in params.layers):
        raise NotImplementedError(
            "MoE layers not supported by the offline tp reshard; quantize "
            "with tp=1 and shard at runtime (EP via dist.sharding)"
        )
    if cfg.num_heads % tp or cfg.num_kv_heads % tp or cfg.intermediate_size % tp:
        raise ValueError(
            f"model dims (heads={cfg.num_heads}/{cfg.num_kv_heads}, "
            f"intermediate={cfg.intermediate_size}) not divisible by tp={tp}"
        )

    def col(dl):
        if isinstance(dl, QuantLinear):
            return dl
        return quantize_linear(dl.weight.astype(jnp.float32), bias=dl.bias,
                               bits=bits)

    def row(dl):
        if isinstance(dl, QuantLinear):
            return dl
        kdim = dl.weight.shape[0]
        if kdim % tp:
            raise ValueError(f"K={kdim} not divisible by tp={tp}")
        return quantize_linear(
            dl.weight.astype(jnp.float32),
            bias=dl.bias,
            bits=bits,
            group_size=None if tp == 1 else kdim // tp,
        )

    layers = [
        dataclasses.replace(
            lp,
            qkv=col(lp.qkv),
            o_proj=row(lp.o_proj),
            gateup=col(lp.gateup),
            down=row(lp.down),
        )
        for lp in params.layers
    ]
    return dataclasses.replace(params, layers=layers)


# ---- lossless slicing of a quantized model onto a mesh ----


def _split_quant_columns_grouped(
    ql: QuantLinear, cfg: ModelConfig, tp: int, kind: str
) -> list[QuantLinear]:
    """Column-split a quantized fused linear per projection group (qkv or
    gateup Megatron grouping) — bit-exact (per-output-channel scales)."""
    from eetq_tpu.dist.sharding import split_gateup_columns, split_qkv_columns

    q = unpack_weights(ql.qweight)
    bits = ql.qweight.bits
    if kind == "qkv":
        q_shards = split_qkv_columns(q, cfg, tp)
        s_shards = split_qkv_columns(ql.scales, cfg, tp)
        b_shards = (
            None if ql.bias is None else split_qkv_columns(ql.bias, cfg, tp)
        )
    else:
        q_shards = split_gateup_columns(q, tp)
        s_shards = split_gateup_columns(ql.scales, tp)
        b_shards = None if ql.bias is None else split_gateup_columns(ql.bias, tp)
    return [
        QuantLinear(
            qweight=pack_weights(q_shards[i], bits=bits),
            scales=s_shards[i],
            bias=None if b_shards is None else b_shards[i],
        )
        for i in range(tp)
    ]


def split_quant_rows(ql: QuantLinear, tp: int) -> list[QuantLinear]:
    """Row-split a quantized linear into tp shards, slicing group scales.

    If scales are group-wise with rows divisible by tp, each shard gets its
    scale-row block (squeezed to per-channel when exactly one row) —
    bit-exact with independent per-shard quantization. Per-channel scales
    are replicated (legal: same dequantized weight, just looser scales)."""
    q = unpack_weights(ql.qweight)
    bits = ql.qweight.bits
    kdim = q.shape[0]
    if kdim % tp:
        raise ValueError(f"K={kdim} not divisible by tp={tp}")
    q_shards = jnp.split(q, tp, axis=-2)
    out = []
    for i in range(tp):
        if ql.scales.ndim == 2 and ql.scales.shape[0] % tp == 0:
            rows = ql.scales.shape[0] // tp
            s = ql.scales[i * rows : (i + 1) * rows]
            if rows == 1:
                s = s[0]
        else:
            s = ql.scales
        out.append(
            QuantLinear(
                qweight=pack_weights(q_shards[i], bits=bits),
                scales=s,
                # row-parallel bias is added ONCE after the psum: rank 0 only
                bias=ql.bias if i == 0 else None,
            )
        )
    return out


def shard_quantized(
    params: ModelParams,
    cfg: ModelConfig,
    mesh: Mesh,
):
    """Build a runtime-TP ShardedModel from an ALREADY QUANTIZED model (e.g.
    loaded from a `quantize(save_dir, tp=N)` checkpoint) without
    requantization. Bit-exact when the checkpoint was TP-quantized with the
    same tp; otherwise still exact w.r.t. the stored integer weights."""
    from eetq_tpu.dist.sharding import MODEL_AXIS, ShardedModel

    if any(lp.moe is not None for lp in params.layers):
        raise NotImplementedError(
            "shard_quantized doesn't support MoE layers yet; shard the "
            "dense model with dist.sharding.shard_model(quantize=True) (EP)"
        )
    tp = mesh.shape[MODEL_AXIS]

    def stack(qls: list[QuantLinear]):
        proto = qls[0]
        data = jnp.stack([q.qweight.data for q in qls])
        scales = jnp.stack(
            [jnp.atleast_2d(q.scales.astype(jnp.float32)) for q in qls]
        )
        bias = None
        if any(q.bias is not None for q in qls):
            proto_b = next(q.bias for q in qls if q.bias is not None)
            bias = jnp.stack(
                [
                    q.bias if q.bias is not None else jnp.zeros_like(proto_b)
                    for q in qls
                ]
            )
        ql = QuantLinear(
            qweight=dataclasses.replace(proto.qweight, data=data),
            scales=scales if scales.shape[1] > 1 else scales[:, 0],
            bias=bias,
        )
        placed = QuantLinear(
            qweight=dataclasses.replace(
                ql.qweight,
                data=jax.device_put(
                    ql.qweight.data, NamedSharding(mesh, P(MODEL_AXIS))
                ),
            ),
            scales=jax.device_put(ql.scales, NamedSharding(mesh, P(MODEL_AXIS))),
            bias=None
            if bias is None
            else jax.device_put(bias, NamedSharding(mesh, P(MODEL_AXIS))),
        )
        s_spec = P(*([MODEL_AXIS] + [None] * (ql.scales.ndim - 1)))
        spec = QuantLinear(
            qweight=dataclasses.replace(ql.qweight, data=P(MODEL_AXIS, None, None)),
            scales=s_spec,
            bias=None if bias is None else P(MODEL_AXIS, None),
        )
        return placed, spec

    def repl(x):
        return jax.device_put(x, NamedSharding(mesh, P()))

    layers, layer_specs = [], []
    for lp in params.layers:
        qkv, qkv_s = stack(
            _split_quant_columns_grouped(lp.qkv, cfg, tp, "qkv")
        )
        o, o_s = stack(split_quant_rows(lp.o_proj, tp))
        gu, gu_s = stack(
            _split_quant_columns_grouped(lp.gateup, cfg, tp, "gateup")
        )
        dn, dn_s = stack(split_quant_rows(lp.down, tp))
        layers.append(
            dataclasses.replace(
                lp,
                input_norm=repl(lp.input_norm),
                qkv=qkv,
                o_proj=o,
                post_norm=repl(lp.post_norm),
                gateup=gu,
                down=dn,
            )
        )
        layer_specs.append(
            LayerParams(
                input_norm=P(),
                qkv=qkv_s,
                o_proj=o_s,
                post_norm=P(),
                gateup=gu_s,
                down=dn_s,
            )
        )

    lm_head = None
    lm_head_spec = None
    if params.lm_head is not None:
        if isinstance(params.lm_head, QuantLinear):
            # quantize_lm_head=True artifact: column-parallel over the vocab
            # (per-output-channel scales split with their columns, bit-exact).
            ql = params.lm_head
            q = unpack_weights(ql.qweight)
            v = q.shape[-1]
            if v % tp:
                raise ValueError(f"vocab {v} not divisible by tp={tp}")
            b_shards = (
                [None] * tp if ql.bias is None else jnp.split(ql.bias, tp, -1)
            )
            shards = [
                QuantLinear(
                    qweight=pack_weights(qs, bits=ql.qweight.bits),
                    scales=ss,
                    bias=bs,
                )
                for qs, ss, bs in zip(
                    jnp.split(q, tp, axis=-1),
                    jnp.split(ql.scales, tp, axis=-1),
                    b_shards,
                )
            ]
            lm_head, lm_head_spec = stack(shards)
        else:
            v = params.lm_head.weight.shape[-1]
            if v % tp:
                raise ValueError(f"vocab {v} not divisible by tp={tp}")
            shards = jnp.split(params.lm_head.weight, tp, axis=-1)
            lm_head = DenseLinear(
                weight=jax.device_put(
                    jnp.stack(shards),
                    NamedSharding(mesh, P(MODEL_AXIS, None, None)),
                )
            )
            lm_head_spec = DenseLinear(weight=P(MODEL_AXIS, None, None))

    out_params = ModelParams(
        embed=repl(params.embed),
        layers=layers,
        final_norm=repl(params.final_norm),
        lm_head=lm_head,
    )
    specs = ModelParams(
        embed=P(),
        layers=layer_specs,
        final_norm=P(),
        lm_head=lm_head_spec,
    )
    return ShardedModel(cfg=cfg, mesh=mesh, tp=tp, params=out_params, specs=specs)
