"""Pipeline parallelism: stage-partitioned layers over a `pipe` mesh axis.

The reference has NO pipeline parallelism (SURVEY.md §2.3: HF accelerate's
`device_map` gives naive layer-split *placement* — one GPU computes while the
others idle, `examples/models/llama_transformers_example.py:111-118`). This
module is the upgrade: true pipelined execution where all stages
compute concurrently on different microbatches, built on `shard_map` over a
`pipe` mesh axis with `lax.ppermute` stage-to-stage transfers — the idiomatic
XLA collective for neighbor exchange (rides ICI within a slice, DCN across
hosts, which is exactly where PP belongs: activations are tiny compared with
the all-reduces TP would put on DCN).

Schedules
---------
- Prefill: GPipe-style microbatching. The batch is split into M microbatches;
  a `lax.scan` over M + pp - 1 ticks keeps every stage busy on a different
  microbatch (bubble fraction (pp-1)/(M+pp-1)).
- Decode: a token ring. Stage pp-1 samples the next token and ppermutes it
  back to stage 0, which embeds it while later stages still process other
  microbatches' current tokens. With M >= pp microbatches in flight the ring
  is saturated: unit u = step*M + mb runs on stage s at tick u + s, and the
  sampled token returns to stage 0 exactly when (with M == pp) the microbatch
  is next scheduled — zero steady-state bubble.

Composition: the `pipe` axis composes with tensor parallelism (`model` axis:
each stage's layers are additionally Megatron column/row-split, with the
per-layer psums riding the fast axis) and data parallelism (`data` axis over
the batch). Parameters are stored with per-stage leaves stacked on a leading
[pp] axis ([pp, tp, ...] with TP), exactly like dist.sharding's [tp]
stacking; embed / final_norm / lm_head are replicated across stages (the
boundary stages use them; replication costs ~0.5 GB bf16 at 70B and keeps
every stage's program identical).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from eetq_tpu.models.config import ModelConfig
from eetq_tpu.models.transformer import (
    LayerParams,
    ModelParams,
    decoder_layer,
    _norm,
)
from eetq_tpu.modules.attention import KVCache, init_kv_cache
from eetq_tpu.modules.linear import (
    DenseLinear,
    QuantLinear,
    linear_apply,
    quantize_linear,
)
from eetq_tpu.ops import make_cos_sin_cache
from eetq_tpu.dist.sharding import (
    DATA_AXIS,
    MODEL_AXIS,
    split_gateup_columns,
    split_qkv_columns,
    split_rows,
)

PIPE_AXIS = "pipe"


def make_pp_mesh(pp: int, tp: int = 1, dp: int = 1, devices=None) -> Mesh:
    """(data, pipe, model) mesh. `model` is innermost (fastest/ICI-adjacent)
    because the per-layer TP psums are the latency-critical collectives;
    `pipe` carries only one small activation per tick."""
    if devices is None:
        return jax.make_mesh((dp, pp, tp), (DATA_AXIS, PIPE_AXIS, MODEL_AXIS))
    import numpy as np

    return Mesh(
        np.asarray(devices).reshape(dp, pp, tp),
        (DATA_AXIS, PIPE_AXIS, MODEL_AXIS),
    )


@dataclasses.dataclass(eq=False)  # hash by identity: used as a static jit arg
class PipelinedModel:
    """Stage-stacked parameters + specs + the mesh they live on."""

    cfg: ModelConfig
    mesh: Mesh
    pp: int
    tp: int
    params: ModelParams  # layers: list[Lps] of LayerParams, leaves [pp(,tp),...]
    specs: Any

    @property
    def layers_per_stage(self) -> int:
        return self.cfg.num_layers // self.pp


def _lead_spec(tp: int) -> tuple:
    return (PIPE_AXIS, MODEL_AXIS) if tp > 1 else (PIPE_AXIS,)


def shard_model_pp(
    dense_params: ModelParams,
    cfg: ModelConfig,
    mesh: Mesh,
    quantize: bool = True,
    bits: int = 8,
) -> PipelinedModel:
    """Split the layer stack into pp contiguous stages (layer p*Lps+j goes to
    stage p), optionally TP-splitting each layer inside its stage, quantize
    each shard independently (per-shard scales — see dist.sharding's module
    docstring for why that is exact), and stack stage leaves on a leading
    [pp] axis sharded over `pipe`."""
    if any(lp.moe is not None for lp in dense_params.layers):
        raise NotImplementedError(
            "MoE layers not supported with pipeline parallelism; use "
            "TP/EP via dist.sharding.shard_model"
        )
    pp = mesh.shape[PIPE_AXIS]
    tp = mesh.shape.get(MODEL_AXIS, 1)
    if cfg.num_layers % pp:
        raise ValueError(f"num_layers {cfg.num_layers} not divisible by pp={pp}")
    lps = cfg.num_layers // pp
    lead = _lead_spec(tp)

    def put(x, spec):
        return jax.device_put(x, NamedSharding(mesh, spec))

    def mk_linear(split_fn, weights, biases):
        """weights: list[pp] of dense [K, N] (one per stage for this layer
        slot). Returns (placed linear with [pp(,tp),...] leaves, spec)."""
        def shards_of(w):
            return split_fn(w) if tp > 1 else [w]

        if quantize:
            qls = [
                [quantize_linear(s, bits=bits) for s in shards_of(w)]
                for w in weights
            ]
            if tp > 1:
                data = jnp.stack(
                    [jnp.stack([q.qweight.data for q in row]) for row in qls]
                )
                scales = jnp.stack(
                    [jnp.stack([q.scales for q in row]) for row in qls]
                )
            else:
                data = jnp.stack([row[0].qweight.data for row in qls])
                scales = jnp.stack([row[0].scales for row in qls])
            proto = qls[0][0]
            dspec = P(*lead, *([None] * proto.qweight.data.ndim))
            sspec = P(*lead, *([None] * proto.scales.ndim))
            bias = bspec = None
            if biases is not None:
                if tp > 1:
                    bias = jnp.stack([jnp.stack(split_fn(b)) for b in biases])
                else:
                    bias = jnp.stack(biases)
                bspec = P(*lead, None)
                bias = put(bias, bspec)
            ql = QuantLinear(
                qweight=dataclasses.replace(proto.qweight, data=put(data, dspec)),
                scales=put(scales, sspec),
                bias=bias,
            )
            spec = QuantLinear(
                qweight=dataclasses.replace(proto.qweight, data=dspec),
                scales=sspec,
                bias=bspec,
            )
            return ql, spec
        if tp > 1:
            w = jnp.stack([jnp.stack(shards_of(wt)) for wt in weights])
        else:
            w = jnp.stack(weights)
        wspec = P(*lead, None, None)
        bias = bspec = None
        if biases is not None:
            if tp > 1:
                bias = jnp.stack([jnp.stack(split_fn(b)) for b in biases])
            else:
                bias = jnp.stack(biases)
            bspec = P(*lead, None)
            bias = put(bias, bspec)
        return (
            DenseLinear(weight=put(w, wspec), bias=bias),
            DenseLinear(weight=wspec, bias=bspec),
        )

    qkv_split = lambda w: split_qkv_columns(w, cfg, tp)  # noqa: E731
    gu_split = lambda w: split_gateup_columns(w, tp)  # noqa: E731
    row_split = lambda w: split_rows(w, tp)  # noqa: E731

    layers, layer_specs = [], []
    for j in range(lps):
        slot = [dense_params.layers[p * lps + j] for p in range(pp)]
        if any(l.o_proj.bias is not None or l.down.bias is not None for l in slot):
            raise NotImplementedError("row-parallel bias sharding not supported")
        qkv_b = (
            [l.qkv.bias for l in slot]
            if slot[0].qkv.bias is not None
            else None
        )
        gu_b = (
            [l.gateup.bias for l in slot]
            if slot[0].gateup.bias is not None
            else None
        )
        qkv, qkv_s = mk_linear(qkv_split, [l.qkv.weight for l in slot], qkv_b)
        o, o_s = mk_linear(row_split, [l.o_proj.weight for l in slot], None)
        gu, gu_s = mk_linear(gu_split, [l.gateup.weight for l in slot], gu_b)
        dn, dn_s = mk_linear(row_split, [l.down.weight for l in slot], None)
        nspec = P(PIPE_AXIS, None)
        layers.append(
            LayerParams(
                input_norm=put(jnp.stack([l.input_norm for l in slot]), nspec),
                qkv=qkv,
                o_proj=o,
                post_norm=put(jnp.stack([l.post_norm for l in slot]), nspec),
                gateup=gu,
                down=dn,
            )
        )
        layer_specs.append(
            LayerParams(
                input_norm=nspec, qkv=qkv_s, o_proj=o_s,
                post_norm=nspec, gateup=gu_s, down=dn_s,
            )
        )

    def repl(x):
        return None if x is None else put(x, P())

    lm_head = dense_params.lm_head
    lm_head_placed = jax.tree.map(repl, lm_head) if lm_head is not None else None
    lm_head_spec = (
        jax.tree.map(lambda _: P(), lm_head) if lm_head is not None else None
    )

    params = ModelParams(
        embed=repl(dense_params.embed),
        layers=layers,
        final_norm=repl(dense_params.final_norm),
        lm_head=lm_head_placed,
    )
    specs = ModelParams(
        embed=P(),
        layers=layer_specs,
        final_norm=P(),
        lm_head=lm_head_spec,
    )
    return PipelinedModel(
        cfg=cfg, mesh=mesh, pp=pp, tp=tp, params=params, specs=specs
    )


def init_pp_caches(
    model: PipelinedModel, batch: int, max_len: int, dtype=jnp.bfloat16
) -> list[KVCache]:
    """Per-layer-slot caches with a leading [pp] stage axis: slot j's cache
    entry p belongs to global layer p*Lps + j. Heads are additionally
    TP-sharded over `model` like dist.sharding's cache."""
    cfg, tp = model.cfg, model.tp
    caches = []
    for _ in range(model.layers_per_stage):
        c = init_kv_cache(batch, max_len, cfg.num_kv_heads, cfg.head_dim, dtype)

        def stage_stack(x):
            return jax.device_put(
                jnp.broadcast_to(x[None], (model.pp,) + x.shape),
                NamedSharding(model.mesh, _cache_leaf_spec(tp)),
            )

        caches.append(KVCache(k=stage_stack(c.k), v=stage_stack(c.v)))
    return caches


def _cache_leaf_spec(tp: int) -> P:
    # [pp, B, Hkv, L, D]
    if tp > 1:
        return P(PIPE_AXIS, DATA_AXIS, MODEL_AXIS, None, None)
    return P(PIPE_AXIS, DATA_AXIS, None, None, None)


def _cache_specs(model: PipelinedModel) -> list[KVCache]:
    s = _cache_leaf_spec(model.tp)
    return [
        KVCache(k=s, v=s) for _ in range(model.layers_per_stage)
    ]


def _squeeze_lead(params, specs):
    """Inside shard_map: drop leading stage/tp shard axes (local size 1)."""

    def fix(leaf, spec):
        if isinstance(spec, P):
            while len(spec) and spec[0] in (PIPE_AXIS, MODEL_AXIS):
                leaf = leaf[0]
                spec = P(*spec[1:])
        return leaf

    leaves, treedef = jax.tree.flatten(params)
    spec_leaves = jax.tree.flatten(specs)[0]
    assert len(leaves) == len(spec_leaves), (len(leaves), len(spec_leaves))
    return jax.tree.unflatten(
        treedef, [fix(l, s) for l, s in zip(leaves, spec_leaves)]
    )


def _rows(x, start, size):
    return jax.lax.dynamic_slice_in_dim(x, start, size, axis=0)


def _write_rows(x, new, start, valid):
    old = _rows(x, start, new.shape[0])
    merged = jnp.where(valid, new.astype(x.dtype), old)
    return jax.lax.dynamic_update_slice_in_dim(x, merged, start, axis=0)


def _stage_layers(model: PipelinedModel):
    """Local (squeezed) per-slot LayerParams list — traced inside shard_map."""

    def get(params, specs):
        return [
            _squeeze_lead(lp, sp)
            for lp, sp in zip(params.layers, specs.layers)
        ]

    return get


def _run_stage(
    model: PipelinedModel,
    layers: list[LayerParams],
    cfg: ModelConfig,
    x,
    positions,
    cos_sin,
    caches_rows: list[KVCache],
    offset,
):
    """Run this stage's layer stack over x [mb, S, H]; returns (x, caches)."""
    tp_axis = MODEL_AXIS if model.tp > 1 else None
    new = []
    for lp, c in zip(layers, caches_rows):
        x, c = decoder_layer(
            lp, cfg, x, positions, cos_sin, c, offset,
            tp=model.tp, tp_axis=tp_axis,
        )
        new.append(c)
    return x, new


def _head_logits(model: PipelinedModel, params_local, x_last):
    """final_norm + lm_head on [mb, 1|S, H] -> f32 logits [mb, V]."""
    cfg = model.cfg
    x = _norm(x_last, params_local.final_norm, cfg)
    if params_local.lm_head is not None:
        logits = linear_apply(params_local.lm_head, x)
    else:
        logits = jnp.dot(
            x, params_local.embed.T.astype(x.dtype),
            preferred_element_type=jnp.float32,
        )
    return logits[:, -1, :].astype(jnp.float32)


def _embed(params_local, cfg, tokens):
    x = params_local.embed[tokens].astype(jnp.bfloat16)
    if cfg.embedding_multiplier is not None:
        x = (x.astype(jnp.float32) * cfg.embedding_multiplier).astype(x.dtype)
    return x


@functools.partial(
    jax.jit,
    static_argnames=("model", "microbatches"),
    donate_argnames=("caches",),
)
def _pp_prefill_jit(model, params, tokens, caches, microbatches):
    cfg, pp, mesh = model.cfg, model.pp, model.mesh
    cache_specs = _cache_specs(model)

    def body(params, tokens, caches):
        p = jax.lax.axis_index(PIPE_AXIS)
        local = _squeeze_lead(params, model.specs)
        layers = _stage_layers(model)(params, model.specs)
        caches = [_squeeze_lead(c, s) for c, s in zip(caches, cache_specs)]
        b, s = tokens.shape
        m = microbatches
        mbs = b // m
        cos_sin = make_cos_sin_cache(
            cfg.max_position, cfg.rot_dim, base=cfg.rope_theta
        )
        positions = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (mbs, s))
        h = cfg.hidden_size
        perm = [(i, i + 1) for i in range(pp - 1)]

        def tick(carry, t):
            x_recv, caches, logits_buf = carry
            u = t - p
            valid = (u >= 0) & (u < m)
            u_safe = jnp.clip(u, 0, m - 1)
            row0 = u_safe * mbs
            tok_mb = _rows(tokens, row0, mbs)
            x_in = jnp.where(p == 0, _embed(local, cfg, tok_mb), x_recv)
            cache_rows = [
                KVCache(k=_rows(c.k, row0, mbs), v=_rows(c.v, row0, mbs))
                for c in caches
            ]
            x_out, new_rows = _run_stage(
                model, layers, cfg, x_in, positions, cos_sin, cache_rows, 0
            )
            caches = [
                KVCache(
                    k=_write_rows(c.k, nr.k, row0, valid),
                    v=_write_rows(c.v, nr.v, row0, valid),
                )
                for c, nr in zip(caches, new_rows)
            ]
            is_last = p == pp - 1
            logits = jax.lax.cond(
                is_last,
                lambda xt: _head_logits(model, local, xt),
                lambda xt: jnp.zeros((mbs, cfg.vocab_size), jnp.float32),
                x_out[:, -1:, :],
            )
            logits_buf = _write_rows(logits_buf, logits, row0, valid & is_last)
            x_next = (
                jax.lax.ppermute(x_out, PIPE_AXIS, perm) if perm else x_out
            )
            return (x_next, caches, logits_buf), None

        x0 = jnp.zeros((mbs, s, h), jnp.bfloat16)
        logits0 = jnp.zeros((b, cfg.vocab_size), jnp.float32)
        (x_recv, caches, logits_buf), _ = jax.lax.scan(
            tick, (x0, caches, logits0),
            jnp.arange(m + pp - 1, dtype=jnp.int32),
        )
        # only the last stage holds real logits; share them with every stage
        logits_buf = jax.lax.psum(logits_buf, PIPE_AXIS)
        caches = [
            jax.tree.map(lambda l: l[None], c) for c in caches
        ]
        return logits_buf, caches

    from jax import shard_map

    fwd = shard_map(
        body,
        mesh=mesh,
        in_specs=(model.specs, P(DATA_AXIS, None), cache_specs),
        out_specs=(P(DATA_AXIS, None), cache_specs),
        check_vma=False,
    )
    return fwd(params, tokens, caches)


def pp_prefill(model: PipelinedModel, tokens, caches, microbatches: int = 1):
    """GPipe-microbatched prefill. tokens [B, S]; B must divide by
    microbatches (and by the data-axis size). Returns (last-token logits
    [B, V] f32, caches)."""
    _check_pp_batch(model, tokens.shape[0], microbatches)
    return _pp_prefill_jit(model, model.params, tokens, caches, microbatches)


def _check_pp_batch(model, b: int, m: int) -> None:
    """The PER-SHARD batch must divide into microbatches — inside the
    shard_map body `mbs = b_local // m` silently floors, so a non-dividing
    batch would leave the trailing rows unprefilled (zero logits, no KV)
    with no error. The global check alone is insufficient under dp > 1."""
    dp = model.mesh.shape.get(DATA_AXIS, 1)
    if b % dp:
        raise ValueError(f"batch {b} not divisible by data shards {dp}")
    if (b // dp) % m:
        raise ValueError(
            f"per-shard batch {b // dp} (global {b} / dp {dp}) not "
            f"divisible by microbatches {m}"
        )


@functools.partial(
    jax.jit,
    static_argnames=("model", "num_steps", "microbatches", "temperature",
                     "top_k"),
    donate_argnames=("caches",),
)
def _pp_decode_jit(model, params, first_token, start_pos, caches, num_steps,
                   microbatches, temperature, top_k, key):
    cfg, pp, mesh = model.cfg, model.pp, model.mesh
    cache_specs = _cache_specs(model)
    m = microbatches

    def body(params, first_token, start_pos, caches, key):
        p = jax.lax.axis_index(PIPE_AXIS)
        local = _squeeze_lead(params, model.specs)
        layers = _stage_layers(model)(params, model.specs)
        caches = [_squeeze_lead(c, s) for c, s in zip(caches, cache_specs)]
        b = first_token.shape[0]
        mbs = b // m
        h = cfg.hidden_size
        cos_sin = make_cos_sin_cache(
            cfg.max_position, cfg.rot_dim, base=cfg.rope_theta
        )
        perm = [(i, (i + 1) % pp) for i in range(pp)]
        steps = num_steps - 1  # units per microbatch (decode_loop semantics)
        is_first, is_last = p == 0, p == pp - 1

        def tick(carry, t):
            (x_recv, tok_recv, token_buf, caches, out_buf, keys) = carry
            # stage 0: bank the token that just arrived from the last stage
            # (sent at tick t-1 for unit t-pp)
            u_prev = t - pp
            mb_prev = jnp.clip(u_prev % m, 0, m - 1)
            valid_prev = (u_prev >= 0) & (u_prev < steps * m)
            token_buf = _write_rows(
                token_buf, tok_recv[None], mb_prev, valid_prev & is_first
            )
            # this tick's unit for this stage
            u = t - p
            valid = (u >= 0) & (u < steps * m)
            u_safe = jnp.clip(u, 0, steps * m - 1)
            mb = u_safe % m
            j = u_safe // m
            row0 = mb * mbs
            token = token_buf[mb]
            x_in = jnp.where(
                is_first, _embed(local, cfg, token[:, None]), x_recv
            )
            posn = (start_pos + j).astype(jnp.int32)
            positions = jnp.broadcast_to(posn, (mbs, 1))
            cache_rows = [
                KVCache(k=_rows(c.k, row0, mbs), v=_rows(c.v, row0, mbs))
                for c in caches
            ]
            x_out, new_rows = _run_stage(
                model, layers, cfg, x_in, positions, cos_sin, cache_rows, posn
            )
            caches = [
                KVCache(
                    k=_write_rows(c.k, nr.k, row0, valid),
                    v=_write_rows(c.v, nr.v, row0, valid),
                )
                for c, nr in zip(caches, new_rows)
            ]

            def sample_head(x):
                logits = _head_logits(model, local, x)
                if temperature == 0.0:
                    return jnp.argmax(logits, axis=-1).astype(jnp.int32)
                lg = logits / temperature
                if top_k > 0:
                    kth = jax.lax.top_k(lg, top_k)[0][..., -1:]
                    lg = jnp.where(lg < kth, -jnp.inf, lg)
                return jax.random.categorical(
                    jax.random.fold_in(keys[mb], j), lg
                ).astype(jnp.int32)

            nxt = jax.lax.cond(
                is_last,
                sample_head,
                lambda x: jnp.zeros((mbs,), jnp.int32),
                x_out,
            )
            cur = jax.lax.dynamic_slice(out_buf, (mb, 0, j), (1, mbs, 1))
            new = jnp.where(valid & is_last, nxt[None, :, None], cur)
            out_buf = jax.lax.dynamic_update_slice(out_buf, new, (mb, 0, j))
            x_next, tok_next = jax.lax.ppermute(
                (x_out, nxt), PIPE_AXIS, perm
            )
            return (x_next, tok_next, token_buf, caches, out_buf, keys), None

        token_buf = first_token.reshape(m, mbs)
        x0 = jnp.zeros((mbs, 1, h), jnp.bfloat16)
        t0 = jnp.zeros((mbs,), jnp.int32)
        out0 = jnp.zeros((m, mbs, max(steps, 1)), jnp.int32)
        # `key` arrives REPLICATED (P() spec): fold the data-shard index in
        # first, or every dp shard draws identical Gumbel noise for the
        # same (microbatch, step) and the shards' samples are correlated
        # (equal logits would always yield equal tokens across shards)
        keys = jax.random.split(
            jax.random.fold_in(key, jax.lax.axis_index(DATA_AXIS)), m
        )
        total_ticks = steps * m + pp - 1
        (x_recv, tok_recv, token_buf, caches, out_buf, _), _ = jax.lax.scan(
            tick,
            (x0, t0, token_buf, caches, out0, keys),
            jnp.arange(total_ticks, dtype=jnp.int32),
        )
        out_buf = jax.lax.psum(out_buf, PIPE_AXIS)  # only last stage wrote
        toks = out_buf.reshape(b, max(steps, 1))
        toks = jnp.concatenate(
            [first_token[:, None], toks[:, :steps]], axis=1
        )
        caches = [jax.tree.map(lambda l: l[None], c) for c in caches]
        return toks, caches

    from jax import shard_map

    fwd = shard_map(
        body,
        mesh=mesh,
        in_specs=(
            model.specs, P(DATA_AXIS), P(), _cache_specs(model), P(),
        ),
        out_specs=(P(DATA_AXIS, None), cache_specs),
        check_vma=False,
    )
    return fwd(params, first_token, start_pos, caches, key)


def pp_decode_loop(
    model: PipelinedModel,
    first_token,  # [B]
    start_pos,  # scalar int32 position of first_token
    caches,
    num_steps: int,
    microbatches: int | None = None,
    temperature: float = 0.0,
    top_k: int = 0,
    key=None,
):
    """Ring-pipelined decode: returns (tokens [B, num_steps] incl.
    first_token, caches). microbatches defaults to pp (the saturation
    point); must divide B and be >= 1 (>= pp for zero steady-state
    bubble)."""
    m = microbatches if microbatches is not None else model.pp
    _check_pp_batch(model, first_token.shape[0], m)
    if m < model.pp:
        # the ring schedule needs the sampled token back at stage 0 before
        # the microbatch's next turn: unit u's token arrives at tick
        # u + pp, the next unit of that microbatch starts at tick u + m
        raise ValueError(f"microbatches {m} must be >= pp {model.pp}")
    if key is None:
        key = jax.random.PRNGKey(0)
    return _pp_decode_jit(
        model, model.params, first_token,
        jnp.asarray(start_pos, jnp.int32), caches, num_steps, m,
        temperature, top_k, key,
    )


def pp_generate(
    model: PipelinedModel,
    prompt,  # [B, S] int32
    max_new_tokens: int,
    microbatches: int | None = None,
    temperature: float = 0.0,
    top_k: int = 0,
    key=None,
):
    """End-to-end pipelined generation (prefill + decode ring). Returns
    generated tokens [B, max_new_tokens]."""
    b, s = prompt.shape
    m = microbatches if microbatches is not None else model.pp
    caches = init_pp_caches(model, b, s + max_new_tokens)
    logits, caches = pp_prefill(model, prompt, caches, microbatches=m)
    if temperature == 0.0:
        token = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    else:
        if key is None:
            key = jax.random.PRNGKey(0)
        key, sub = jax.random.split(key)
        lg = logits / temperature
        if top_k > 0:
            kth = jax.lax.top_k(lg, top_k)[0][..., -1:]
            lg = jnp.where(lg < kth, -jnp.inf, lg)
        token = jax.random.categorical(sub, lg).astype(jnp.int32)
    toks, _ = pp_decode_loop(
        model, token, jnp.int32(s), caches, max_new_tokens,
        microbatches=m, temperature=temperature, top_k=top_k, key=key,
    )
    return toks
