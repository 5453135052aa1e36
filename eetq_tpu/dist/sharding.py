"""Tensor-parallel sharding: mesh definition, per-shard quantization, and the
shard_map'd forward.

This is the layer the reference does NOT have at runtime (SURVEY.md §2.3): its
"TP" is an offline checkpoint reshard (`utils/base.py:132-250`) executed by
TGI/LoRAX at serve time. Here TP is first-class: Megatron-style column-
parallel qkv/gateup + row-parallel o/down over an ICI mesh axis, with psum /
all-gather inserted in the decoder (see models/transformer.decoder_layer) and
the KV cache head-sharded.

Key quantization property (the reference's split-then-quantize trick,
`models/llama.py:92-103`, upgraded): each TP shard is quantized
INDEPENDENTLY after splitting —
- column-parallel shards own disjoint output channels, so per-shard scales
  are exactly the slice of the global scales (bit-exact either way);
- row-parallel shards see only their K rows, so per-shard absmax scales are
  TIGHTER than global ones, and because the kernel applies the scale to the
  local accumulator BEFORE the psum, the sharded result is exactly the sum
  of independently-dequantized partials — per-shard quantization is both
  legal and more accurate.

Storage layout: sharded quantized leaves are stacked on a leading [tp] axis
(each shard keeps its own tile padding), placed with PartitionSpec("model")
on that axis; inside shard_map the leading axis is squeezed away. Replicated
leaves (norms, embed) carry no leading axis. The KV cache is a plain global
[B, L, Hkv, D] array sharded (data, -, model, -).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from eetq_tpu.models.config import ModelConfig
from eetq_tpu.models.transformer import (
    LayerParams,
    ModelParams,
    forward_inner,
)
from eetq_tpu.modules.attention import KVCache
from eetq_tpu.modules.linear import DenseLinear, QuantLinear, quantize_linear

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(tp: int, dp: int = 1, devices=None) -> Mesh:
    """(dp, tp) mesh. TP should map to the ICI-adjacent axis: on a real
    slice, jax.make_mesh orders axes so the last axis is innermost/fastest
    (ICI-contiguous), which is where the per-layer psums ride."""
    if devices is None:
        return jax.make_mesh((dp, tp), (DATA_AXIS, MODEL_AXIS))
    import numpy as np

    return Mesh(np.asarray(devices).reshape(dp, tp), (DATA_AXIS, MODEL_AXIS))


# ---- column/row splitters (the runtime analogue of the reference's offline
# split_tp_column / split_tp_row, utils/base.py:132-186) ----


def split_qkv_columns(w: jax.Array, cfg: ModelConfig, tp: int) -> list[jax.Array]:
    """Split a fused qkv weight [K, (Hq+2Hkv)*D] into tp column shards, each
    holding its own q/k/v heads (Megatron grouping: shard i gets q heads
    [i*Hq/tp:(i+1)*Hq/tp] and the matching kv heads, preserving GQA
    co-location). Works for weights, biases (pass [1, N]), or scales."""
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if hq % tp or hkv % tp:
        raise ValueError(f"heads ({hq}, {hkv}) not divisible by tp={tp}")
    q, k, v = w[..., : hq * d], w[..., hq * d : (hq + hkv) * d], w[..., (hq + hkv) * d :]
    qs = jnp.split(q, tp, axis=-1)
    ks = jnp.split(k, tp, axis=-1)
    vs = jnp.split(v, tp, axis=-1)
    return [jnp.concatenate([qs[i], ks[i], vs[i]], axis=-1) for i in range(tp)]


def split_gateup_columns(w: jax.Array, tp: int) -> list[jax.Array]:
    """Split a fused gate/up weight [K, 2I] into tp shards of [K, 2I/tp],
    each holding its gate slice and up slice."""
    gate, up = jnp.split(w, 2, axis=-1)
    gs = jnp.split(gate, tp, axis=-1)
    us = jnp.split(up, tp, axis=-1)
    return [jnp.concatenate([gs[i], us[i]], axis=-1) for i in range(tp)]


def split_rows(w: jax.Array, tp: int) -> list[jax.Array]:
    """Row-split for o_proj/down_proj [K, N] -> tp x [K/tp, N]."""
    return jnp.split(w, tp, axis=-2)


def _stack_quantized(
    shards: list[jax.Array], bits: int,
    bias_shards: list[jax.Array] | None = None,
) -> QuantLinear:
    """Quantize each dense shard independently and stack along a new leading
    [tp] axis (per-shard scales — see module docstring)."""
    qls = [quantize_linear(s, bits=bits) for s in shards]
    data = jnp.stack([q.qweight.data for q in qls])
    scales = jnp.stack([q.scales for q in qls])
    proto = qls[0]
    qw = dataclasses.replace(proto.qweight, data=data)
    bias = None if bias_shards is None else jnp.stack(bias_shards)
    return QuantLinear(qweight=qw, scales=scales, bias=bias)


def _stack_dense(
    shards: list[jax.Array], bias_shards: list[jax.Array] | None = None
) -> DenseLinear:
    bias = None if bias_shards is None else jnp.stack(bias_shards)
    return DenseLinear(weight=jnp.stack(shards), bias=bias)


@dataclasses.dataclass
class ShardedModel:
    """Sharded parameters + their PartitionSpecs + the forward factory."""

    cfg: ModelConfig
    mesh: Mesh
    tp: int
    params: ModelParams  # stacked-sharded / replicated leaves, device_put
    specs: Any  # pytree of PartitionSpec congruent with params


def shard_model(
    dense_params: ModelParams,
    cfg: ModelConfig,
    mesh: Mesh,
    quantize: bool = True,
    bits: int = 8,
) -> ShardedModel:
    """Split + (per-shard) quantize + device_put a dense model onto the mesh.

    Layer-by-layer to bound peak memory, like the reference's per-layer swap
    + empty_cache (`utils/quantizer.py:30-35`).
    """
    tp = mesh.shape[MODEL_AXIS]

    def mk_linear(
        shards: list[jax.Array],
        bias_shards: list[jax.Array] | None = None,
    ) -> tuple[Any, Any]:
        bspec = None if bias_shards is None else P(MODEL_AXIS, None)
        if quantize:
            ql = _stack_quantized(shards, bits, bias_shards)
            ql_placed = QuantLinear(
                qweight=dataclasses.replace(
                    ql.qweight,
                    data=jax.device_put(
                        ql.qweight.data, NamedSharding(mesh, P(MODEL_AXIS, None, None))
                    ),
                ),
                scales=jax.device_put(
                    ql.scales, NamedSharding(mesh, P(MODEL_AXIS, None))
                ),
                bias=None
                if ql.bias is None
                else jax.device_put(ql.bias, NamedSharding(mesh, bspec)),
            )
            spec = QuantLinear(
                qweight=dataclasses.replace(
                    ql.qweight, data=P(MODEL_AXIS, None, None)
                ),
                scales=P(MODEL_AXIS, None),
                bias=bspec,
            )
            return ql_placed, spec
        dl = _stack_dense(shards, bias_shards)
        placed = DenseLinear(
            weight=jax.device_put(
                dl.weight, NamedSharding(mesh, P(MODEL_AXIS, None, None))
            ),
            bias=None
            if dl.bias is None
            else jax.device_put(dl.bias, NamedSharding(mesh, bspec)),
        )
        return placed, DenseLinear(weight=P(MODEL_AXIS, None, None), bias=bspec)

    def repl(x):
        return jax.device_put(x, NamedSharding(mesh, P()))

    def mk_moe(moe):
        """Expert parallelism: the stacked [E, K, N] banks split on the
        EXPERT axis over the model mesh axis (E/tp experts per device,
        quantized independently — exact, since expert quantization is
        already per-expert). The router is a replicated sliver; attention
        keeps its head split, so MoE models run attention-TP x expert-EP
        on the same axis. The decoder's row-parallel psum completes the
        routed combine (modules.moe.moe_apply returns local partials)."""
        from eetq_tpu.modules.moe import MoEMLP

        e = moe.gateup.weight.shape[0]
        if e % tp:
            raise ValueError(f"num_experts {e} not divisible by tp={tp}")
        router = DenseLinear(weight=repl(moe.router.weight), bias=None)
        router_spec = DenseLinear(weight=P(), bias=None)

        def mk_bank(w):
            shards = list(jnp.split(w, tp, axis=0))
            if quantize:
                from eetq_tpu.modules.linear import quantize_linear as _ql

                qls = [_ql(s_, bits=bits) for s_ in shards]
                data = jnp.stack([q.qweight.data for q in qls])
                scales = jnp.stack([q.scales for q in qls])
                bank = QuantLinear(
                    qweight=dataclasses.replace(
                        qls[0].qweight,
                        data=jax.device_put(
                            data,
                            NamedSharding(mesh, P(MODEL_AXIS, None, None, None)),
                        ),
                    ),
                    scales=jax.device_put(
                        scales, NamedSharding(mesh, P(MODEL_AXIS, None, None))
                    ),
                )
                spec = QuantLinear(
                    qweight=dataclasses.replace(
                        qls[0].qweight, data=P(MODEL_AXIS, None, None, None)
                    ),
                    scales=P(MODEL_AXIS, None, None),
                    bias=None,
                )
                return bank, spec
            stacked = jnp.stack(shards)
            bank = DenseLinear(
                weight=jax.device_put(
                    stacked,
                    NamedSharding(mesh, P(MODEL_AXIS, None, None, None)),
                )
            )
            return bank, DenseLinear(
                weight=P(MODEL_AXIS, None, None, None), bias=None
            )

        gu, gu_s = mk_bank(moe.gateup.weight)
        dn, dn_s = mk_bank(moe.down.weight)
        return (
            MoEMLP(router=router, gateup=gu, down=dn),
            MoEMLP(router=router_spec, gateup=gu_s, down=dn_s),
        )

    layers, layer_specs = [], []
    for lp in dense_params.layers:
        # column-parallel biases split with their columns; row-parallel
        # layers in the supported families carry no bias
        qkv_b = (
            None
            if lp.qkv.bias is None
            else split_qkv_columns(lp.qkv.bias, cfg, tp)
        )
        gu_b = (
            None
            if lp.gateup is None or lp.gateup.bias is None
            else split_gateup_columns(lp.gateup.bias, tp)
        )
        if lp.o_proj.bias is not None or (
            lp.down is not None and lp.down.bias is not None
        ):
            raise NotImplementedError(
                "row-parallel bias sharding not supported"
            )
        qkv, qkv_s = mk_linear(split_qkv_columns(lp.qkv.weight, cfg, tp), qkv_b)
        o, o_s = mk_linear(split_rows(lp.o_proj.weight, tp), None)
        if lp.moe is not None:
            moe, moe_s = mk_moe(lp.moe)
            gu = dn = gu_s = dn_s = None
        else:
            moe = moe_s = None
            gu, gu_s = mk_linear(
                split_gateup_columns(lp.gateup.weight, tp), gu_b
            )
            dn, dn_s = mk_linear(split_rows(lp.down.weight, tp), None)
        layers.append(
            LayerParams(
                input_norm=repl(lp.input_norm),
                qkv=qkv,
                o_proj=o,
                post_norm=repl(lp.post_norm),
                gateup=gu,
                down=dn,
                moe=moe,
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
                moe=moe_s,
            )
        )

    lm_head = None
    lm_head_spec = None
    if dense_params.lm_head is not None:
        # lm_head stays dense (the reference excludes it from quantization,
        # utils/base.py:273-274) but is column-parallel over the vocab.
        v = dense_params.lm_head.weight.shape[-1]
        if v % tp:
            raise ValueError(f"vocab {v} not divisible by tp={tp}")
        shards = jnp.split(dense_params.lm_head.weight, tp, axis=-1)
        lm_head = DenseLinear(
            weight=jax.device_put(
                jnp.stack(shards), NamedSharding(mesh, P(MODEL_AXIS, None, None))
            )
        )
        lm_head_spec = DenseLinear(weight=P(MODEL_AXIS, None, None))

    params = ModelParams(
        embed=repl(dense_params.embed),
        layers=layers,
        final_norm=repl(dense_params.final_norm),
        lm_head=lm_head,
    )
    specs = ModelParams(
        embed=P(),
        layers=layer_specs,
        final_norm=P(),
        lm_head=lm_head_spec,
    )
    return ShardedModel(cfg=cfg, mesh=mesh, tp=tp, params=params, specs=specs)


def _unstack_local(params, specs):
    """Inside shard_map: drop the leading [1] shard axis of sharded leaves."""

    def fix(leaf, spec):
        if isinstance(spec, P) and len(spec) and spec[0] == MODEL_AXIS:
            return leaf[0]
        return leaf

    leaves, treedef = jax.tree.flatten(params)
    # PartitionSpec is an unregistered type -> a leaf; None drops out of both
    # trees identically, keeping leaves aligned.
    spec_leaves = jax.tree.flatten(specs)[0]
    assert len(leaves) == len(spec_leaves), (len(leaves), len(spec_leaves))
    return jax.tree.unflatten(
        treedef, [fix(l, s) for l, s in zip(leaves, spec_leaves)]
    )


def cache_spec() -> P:
    """KV cache [B, Hkv, L, D]: batch over data, heads over model."""
    return P(DATA_AXIS, MODEL_AXIS, None, None)


def make_spec_window_fn(model: ShardedModel, window: int, k: int,
                        sampled: bool = False,
                        topk_cap: int = 0) -> Callable:
    """Sharded counterpart of `serve.spec.ngram_spec_window`: one ENGINE
    n-gram speculative decode window over the (data, model) mesh.

    The whole while_loop runs inside shard_map: per-row state (hist,
    valid, last, lengths) is sharded over the data axis, the verify
    forward is the TP decoder (row-parallel psums over the model axis),
    and the n-gram matching / acceptance logic runs replicated within
    each model group — every device of a model group holds identical row
    state, so their loop conditions agree and the in-loop collectives
    stay aligned; data groups may run different round counts (no
    cross-data collectives inside the loop).

    Returns fn(params, hist, valid, last, lengths, caches) ->
    (out [B, window], counts [B], caches, rounds)."""
    from jax import shard_map

    from eetq_tpu.serve.spec import _ngram_window_core

    cfg, mesh, tp = model.cfg, model.mesh, model.tp
    caches_spec = [
        KVCache(k=cache_spec(), v=cache_spec())
        for _ in range(cfg.num_layers)
    ]

    def local_body(params, hist, valid, last, lengths, caches, sample_args):
        local = _unstack_local(params, model.specs)

        def verify(t_in, start, caches):
            s = t_in.shape[1]
            positions = (
                start[:, None] + jnp.arange(s, dtype=jnp.int32)[None]
            )
            return forward_inner(
                local, cfg, t_in, positions, caches, start, verify=True,
                tp=tp, tp_axis=MODEL_AXIS,
            )

        return _ngram_window_core(
            verify, hist, valid, last, lengths, caches, window, k,
            sample_args=sample_args, topk_cap=topk_cap,
        )

    row_spec = (P(DATA_AXIS), P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS))
    fn = shard_map(
        local_body,
        mesh=mesh,
        in_specs=(
            model.specs,
            P(DATA_AXIS, None),  # hist
            P(DATA_AXIS),  # valid
            P(DATA_AXIS),  # last
            P(DATA_AXIS),  # lengths
            caches_spec,
            # (emit0, row_keys [B, key], temps, topks) or None
            row_spec if sampled else None,
        ),
        out_specs=(
            P(DATA_AXIS, None),  # out
            P(DATA_AXIS),  # counts
            caches_spec,
            P(),  # rounds (per-shard; shards may differ — take the max)
        ),
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(5,))


def make_forward_fn(
    model: ShardedModel,
    per_row_offset: bool = False,
    last_pos: bool = False,
) -> Callable:
    """Returns fwd(params, tokens, positions, caches, offset) -> (logits,
    caches): a jitted shard_map over the (data, model) mesh computing the TP
    decoder with explicit collectives.

    per_row_offset=True makes `offset` a [B] vector of per-row cache
    positions (continuous batching), sharded with the batch.

    last_pos=True adds a trailing `last_idx` [B] argument: each row's
    hidden state is gathered at its own index BEFORE the lm_head, so the
    head computes [B, 1, V_local] and the vocab all_gather moves 1/S of
    the bytes (prefill needs only next-token logits)."""
    cfg, mesh, tp = model.cfg, model.mesh, model.tp
    from jax import shard_map

    n_layers = cfg.num_layers
    caches_spec = [KVCache(k=cache_spec(), v=cache_spec()) for _ in range(n_layers)]

    def local_fwd(params, tokens, positions, caches, offset, last_idx=None):
        local = _unstack_local(params, model.specs)
        return forward_inner(
            local, cfg, tokens, positions, caches, offset,
            tp=tp, tp_axis=MODEL_AXIS,
            last_pos=last_idx,
        )

    fwd = shard_map(
        local_fwd,
        mesh=mesh,
        in_specs=(
            model.specs,
            P(DATA_AXIS, None),
            P(DATA_AXIS, None),
            caches_spec,
            P(DATA_AXIS) if per_row_offset else P(),
        ) + ((P(DATA_AXIS),) if last_pos else ()),
        out_specs=(P(DATA_AXIS, None, None), caches_spec),
        # check_vma would be the one static safety net shard_map offers,
        # but it requires `vma` annotations on every ShapeDtypeStruct the
        # body produces — including each Pallas kernel's out_shape — which
        # jax's pallas_call does not currently accept. Correctness is
        # covered instead by the sharded-vs-single-device equality tests
        # (tests/test_sharding.py, test_engine.py, test_multihost.py).
        check_vma=False,
    )
    return jax.jit(fwd)
