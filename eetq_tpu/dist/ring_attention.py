"""Ring attention: sequence-sharded causal attention over an ICI ring.

The reference has no sequence scaling at all (SURVEY.md §5 long-context:
max_position hardcoded 2048, flash-attn on one GPU). This module is the
Long-context layer: Q, K, V are sharded along the SEQUENCE axis
across a mesh axis; each device computes flash-style online-softmax partial
attention against its resident KV chunk, then rotates the KV shard around
the ring with `ppermute` (ICI neighbor exchange), merging the softmax
statistics — memory per device O(S/p), full-sequence attention, and the KV
transfers overlap compute under XLA's scheduler.

Causality at chunk granularity: query chunk qi attends KV chunk ki iff
ki <= qi; the diagonal chunk applies the elementwise causal mask. Chunks
strictly above the diagonal are skipped with `lax.cond` (no flops moved,
the ppermute still advances the ring).

Usage (inside shard_map over mesh axis `axis_name`, inputs are the LOCAL
sequence chunks): `ring_attention(q, k, v, axis_name="model")`.
`ring_attention_sharded` wraps a full array with the shard_map plumbing.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

NEG_INF = -0.7 * float(jnp.finfo(jnp.float32).max)


def _chunk_attn_stats(q, k, v, mask, scale, bias=None):
    """Unnormalized attention over one KV chunk with softmax statistics.

    q: [B, Sq, Hq, D]; k, v: [B, Skv, Hkv, D]; mask None or broadcastable
    to [B, Hq, Sq, Skv] (True = attend); bias (e.g. ALiBi) broadcastable
    to the same, added to the scaled scores before masking.
    Returns (o_unnorm [B, Sq, Hq, D] f32, m [B, Hq, Sq] f32, l [B, Hq, Sq]).
    """
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, sq, hkv, group, d)
    s = jnp.einsum(
        "bskgd,blkd->bkgsl", qg, k, preferred_element_type=jnp.float32
    ).reshape(b, hq, sq, -1)
    s = s * scale
    if bias is not None:
        s = s + bias
    if mask is not None:
        s = jnp.where(mask, s, NEG_INF)
    m = jnp.max(s, axis=-1)  # [B, Hq, Sq]
    p = jnp.exp(s - m[..., None])
    l = jnp.sum(p, axis=-1)
    pg = p.reshape(b, hkv, group, sq, -1)
    o = jnp.einsum("bkgsl,blkd->bskgd", pg, v.astype(p.dtype)).reshape(
        b, sq, hq, d
    )
    return o, m, l


def _merge(o1, m1, l1, o2, m2, l2):
    """Merge two online-softmax partial results (flash-2 combine)."""
    m = jnp.maximum(m1, m2)
    a1 = jnp.exp(m1 - m)
    a2 = jnp.exp(m2 - m)
    # broadcast [B, Hq, Sq] stats onto [B, Sq, Hq, D] outputs
    def scale_o(o, a):
        return o * a.transpose(0, 2, 1)[..., None]

    return scale_o(o1, a1) + scale_o(o2, a2), m, l1 * a1 + l2 * a2


def ring_attention(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    axis_name: str,
    causal: bool = True,
    scale: float | None = None,
    slopes: jax.Array | None = None,
    window: int | None = None,
) -> jax.Array:
    """Sequence-sharded attention; call inside shard_map.

    q: [B, Sq_local, Hq, D]; k, v: [B, Skv_local, Hkv, D] — the local
    sequence chunks (chunk index = device index along `axis_name`).
    slopes [Hq] enables the ALiBi position bias (score += slope * (col -
    row) in GLOBAL positions). window enables causal sliding-window
    attention (col > row - window); KV chunks entirely outside every local
    query's window are skipped like above-diagonal chunks.
    Returns [B, Sq_local, Hq, D] in q.dtype.
    """
    p = jax.lax.psum(1, axis_name)
    idx = jax.lax.axis_index(axis_name)
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    if scale is None:
        scale = 1.0 / (d**0.5)
    qf = q.astype(jnp.bfloat16)

    row = jax.lax.broadcasted_iota(jnp.int32, (sq, skv), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (sq, skv), 1)

    def step(carry, i):
        o, m, l, kc, vc = carry
        src = (idx - i) % p  # global chunk index of the KV we hold now
        # GLOBAL positions of this device's query rows / the held KV cols
        row_g = idx * sq + row
        col_g = src * skv + col

        def attend(_):
            bias = None
            if slopes is not None:
                # ALiBi: per-head linear position bias in global coords
                bias = slopes.astype(jnp.float32)[None, :, None, None] * (
                    (col_g - row_g).astype(jnp.float32)[None, None]
                )
            if causal:
                mask = (col_g <= row_g)[None, None]
                if window is not None:
                    mask &= (col_g > row_g - window)[None, None]
            else:
                mask = None
            oc, mc, lc = _chunk_attn_stats(qf, kc, vc, mask, scale, bias=bias)
            return _merge(o, m, l, oc, mc, lc)

        def skip(_):
            return o, m, l

        if causal:
            run = src <= idx
            if window is not None:
                # old-chunk liveness is governed by the FIRST local row
                # (idx*sq): it has the smallest window start, so a chunk
                # is dead only when even its last col falls at or before
                # idx*sq - window (later rows' windows start even higher,
                # excluding the chunk a fortiori)
                run &= (src * skv + skv - 1) > (idx * sq - window)
            o2, m2, l2 = jax.lax.cond(run, attend, skip, operand=None)
        else:
            o2, m2, l2 = attend(None)
        # rotate KV shards one step around the ring
        perm = [(j, (j + 1) % p) for j in range(p)]
        kc = jax.lax.ppermute(kc, axis_name, perm)
        vc = jax.lax.ppermute(vc, axis_name, perm)
        return (o2, m2, l2, kc, vc), None

    o0 = jnp.zeros((b, sq, hq, d), jnp.float32)
    m0 = jnp.full((b, hq, sq), NEG_INF, jnp.float32)
    l0 = jnp.zeros((b, hq, sq), jnp.float32)
    (o, m, l, _, _), _ = jax.lax.scan(
        step, (o0, m0, l0, k.astype(jnp.bfloat16), v.astype(jnp.bfloat16)),
        jnp.arange(p, dtype=jnp.int32),
    )
    l = jnp.where(l == 0.0, 1.0, l)
    return (o / l.transpose(0, 2, 1)[..., None]).astype(q.dtype)


def ring_attention_sharded(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    mesh: Mesh,
    axis_name: str = "model",
    causal: bool = True,
    scale: float | None = None,
    slopes: jax.Array | None = None,
    window: int | None = None,
) -> jax.Array:
    """Convenience wrapper: shard [B, S, H, D] arrays along S over
    `axis_name` and run ring attention. S must divide by the axis size."""
    from jax import shard_map

    spec = P(None, axis_name, None, None)
    fn = shard_map(
        functools.partial(
            ring_attention, axis_name=axis_name, causal=causal, scale=scale,
            slopes=slopes, window=window,
        ),
        mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=spec,
        check_vma=False,
    )
    return fn(q, k, v)
