"""Paged KV cache: a shared block pool + per-slot block tables.

The dense engine cache preallocates [max_batch, max_len] rows per layer —
at llama2-7b shapes that is ~1 GB per slot for a 2 k context, so slot count
is capped by the WORST-CASE context, not actual usage. Paging (the vLLM
idea) allocates fixed-size blocks from a shared pool as sequences grow:

- pool per layer: [num_blocks, Hkv, block_size, D] (+ per-token scale pool
  for int8), living entirely on device;
- a per-slot block table [B, max_blocks] int32 maps logical block i of a
  sequence to its physical pool block — the table rides in the cache
  pytree (tiny) and is rebuilt by the host allocator as blocks are
  granted/freed;
- decode gathers each row's blocks through its table into the logical
  dense view and runs the dense decode attention on it;
- decode writes are one batched scatter at (table[p // bs], :, p % bs).

Block size is a multiple of 128, the dense cache's allocation granule.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from eetq_tpu.modules.attention import (
    KVCache,
    _quantize_kv,
    attention_decode_ref,
    attention_verify,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PagedKVCache:
    """One layer's paged cache. k/v pools [NB, Hkv, BS, D]; table
    [B, max_blocks] int32 (physical block of each logical block; rows
    beyond a sequence's length are arbitrary — masked by `lengths`)."""

    k: jax.Array
    v: jax.Array
    table: jax.Array
    k_scale: jax.Array | None = None  # [NB, Hkv, BS] for int8 pools
    v_scale: jax.Array | None = None

    @property
    def block_size(self) -> int:
        return self.k.shape[2]

    @property
    def num_blocks(self) -> int:
        return self.k.shape[0]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_paged_kv_cache(
    num_blocks: int,
    block_size: int,
    n_kv_heads: int,
    head_dim: int,
    batch: int,
    max_blocks_per_seq: int,
    dtype=jnp.bfloat16,
) -> PagedKVCache:
    if block_size % 128:
        raise ValueError(f"block_size {block_size} must be a multiple of 128")
    shape = (num_blocks, n_kv_heads, block_size, head_dim)
    table = jnp.zeros((batch, max_blocks_per_seq), jnp.int32)
    if dtype == jnp.int8:
        sshape = (num_blocks, n_kv_heads, block_size)
        return PagedKVCache(
            k=jnp.zeros(shape, jnp.int8),
            v=jnp.zeros(shape, jnp.int8),
            table=table,
            k_scale=jnp.zeros(sshape, jnp.float32),
            v_scale=jnp.zeros(sshape, jnp.float32),
        )
    return PagedKVCache(
        k=jnp.zeros(shape, dtype), v=jnp.zeros(shape, dtype), table=table
    )


def paged_write(
    cache: PagedKVCache, k_new: jax.Array, v_new: jax.Array, pos
) -> PagedKVCache:
    """Write ONE decode token per row. k_new/v_new [B, 1, Hkv, D]; pos [B]
    (or scalar) logical position of the new token. One batched scatter."""
    bs = cache.block_size
    b = k_new.shape[0]
    pos = jnp.broadcast_to(jnp.asarray(pos, jnp.int32).reshape(-1), (b,))
    phys = jnp.take_along_axis(
        cache.table, (pos // bs)[:, None], axis=1
    )[:, 0]  # [B]
    off = pos % bs
    kn = k_new[:, 0]  # [B, Hkv, D]
    vn = v_new[:, 0]
    ks = vs = None
    if cache.quantized:
        kn, ks = _quantize_kv(kn[:, :, None])  # [B,Hkv,1,D] -> scales [B,Hkv,1]
        vn, vs = _quantize_kv(vn[:, :, None])
        kn, vn = kn[:, :, 0], vn[:, :, 0]
        ks, vs = ks[:, :, 0], vs[:, :, 0]
    out = dataclasses.replace(
        cache,
        k=cache.k.at[phys, :, off, :].set(kn.astype(cache.k.dtype)),
        v=cache.v.at[phys, :, off, :].set(vn.astype(cache.v.dtype)),
    )
    if cache.quantized:
        out = dataclasses.replace(
            out,
            k_scale=cache.k_scale.at[phys, :, off].set(ks),
            v_scale=cache.v_scale.at[phys, :, off].set(vs),
        )
    return out


def paged_write_multi(
    cache: PagedKVCache, k_new: jax.Array, v_new: jax.Array, pos
) -> PagedKVCache:
    """Write S tokens per row at per-row positions pos..pos+S-1 (the
    speculative-decode verify write). k_new/v_new [B, S, Hkv, D]; pos [B]
    (or scalar). S is static and small (k+1 <= 8): S batched scatters,
    each crossing block boundaries correctly through the table."""
    s = k_new.shape[1]
    base = jnp.asarray(pos, jnp.int32)
    for i in range(s):
        cache = paged_write(
            cache, k_new[:, i : i + 1], v_new[:, i : i + 1], base + i
        )
    return cache


def paged_attention_verify(
    q: jax.Array,
    cache: PagedKVCache,
    lengths,
    window: int | None = None,
    slopes: jax.Array | None = None,
) -> jax.Array:
    """Multi-query verify over a paged cache. q [B, S, Hq, D]; lengths [B]
    valid positions INCLUDING the S verify tokens (query row i of row b
    sits at lengths[b] - S + i, per-row causal)."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    max_len = cache.table.shape[1] * cache.block_size
    dense = paged_gather_dense(cache, max_len)
    return attention_verify(
        q, dense, jnp.asarray(lengths, jnp.int32), window, scale,
        slopes=slopes,
    )


def paged_insert_dense(
    cache: PagedKVCache, dense: KVCache, src_row, blocks, n_blocks: int
) -> PagedKVCache:
    """Copy the first n_blocks * block_size positions of dense cache row
    `src_row` into pool blocks `blocks` ([n_blocks] int32 physical ids) —
    one scatter per leaf (prefill hand-off from the dense scratch)."""
    bs = cache.block_size
    hkv, d = cache.k.shape[1], cache.k.shape[3]

    def grab(leaf4):  # [R, Hkv, L, D] -> [n_blocks, Hkv, bs, D]
        row = jax.lax.dynamic_index_in_dim(leaf4, src_row, 0, keepdims=False)
        want = n_blocks * bs
        sl = row[:, : min(want, row.shape[1])]
        if sl.shape[1] < want:  # scratch shorter than whole blocks: zero-pad
            sl = jnp.pad(sl, ((0, 0), (0, want - sl.shape[1]), (0, 0)))
        return sl.reshape(hkv, n_blocks, bs, d).transpose(1, 0, 2, 3)

    out = dataclasses.replace(
        cache,
        k=cache.k.at[blocks].set(grab(dense.k).astype(cache.k.dtype)),
        v=cache.v.at[blocks].set(grab(dense.v).astype(cache.v.dtype)),
    )
    if cache.quantized:
        if not dense.quantized:
            raise ValueError("int8 paged pool needs an int8 dense scratch")

        def grab3(leaf3):  # [R, Hkv, L] -> [n_blocks, Hkv, bs]
            row = jax.lax.dynamic_index_in_dim(leaf3, src_row, 0, keepdims=False)
            want = n_blocks * bs
            sl = row[:, : min(want, row.shape[1])]
            if sl.shape[1] < want:
                sl = jnp.pad(sl, ((0, 0), (0, want - sl.shape[1])))
            return sl.reshape(hkv, n_blocks, bs).transpose(1, 0, 2)

        out = dataclasses.replace(
            out,
            k_scale=cache.k_scale.at[blocks].set(grab3(dense.k_scale)),
            v_scale=cache.v_scale.at[blocks].set(grab3(dense.v_scale)),
        )
    return out


def paged_gather_dense(cache: PagedKVCache, max_len: int) -> KVCache:
    """Materialize the logical dense [B, Hkv, L, D] view by gathering pool
    blocks through the table."""
    bs = cache.block_size
    nb = max_len // bs
    tbl = cache.table[:, :nb]  # [B, nb]

    def gather(pool):  # [NB, Hkv, bs, ...] -> [B, Hkv, nb*bs, ...]
        blocks = pool[tbl]  # [B, nb, Hkv, bs, ...]
        moved = jnp.moveaxis(blocks, 2, 1)  # [B, Hkv, nb, bs, ...]
        return moved.reshape(
            moved.shape[0], moved.shape[1], nb * bs, *moved.shape[4:]
        )

    return KVCache(
        k=gather(cache.k),
        v=gather(cache.v),
        k_scale=None if cache.k_scale is None else gather(cache.k_scale),
        v_scale=None if cache.v_scale is None else gather(cache.v_scale),
    )


def paged_attention_decode(
    q: jax.Array,
    cache: PagedKVCache,
    lengths,
    window: int | None = None,
    slopes: jax.Array | None = None,
) -> jax.Array:
    """Single-step decode over a paged cache. q [B, 1, Hq, D]; lengths [B]
    (valid positions INCLUDING the just-written token)."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    max_len = cache.table.shape[1] * cache.block_size
    dense = paged_gather_dense(cache, max_len)
    return attention_decode_ref(q, dense, lengths, window, scale, slopes=slopes)
