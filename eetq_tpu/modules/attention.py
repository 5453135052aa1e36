"""Attention with a preallocated KV cache, GQA, causal masking and optional
sliding window.

Re-designs the reference's fused attention modules
(`python/eetq/modules/llama_modules.py:68-240`), which concat past_key_value
along the sequence axis every step (O(seq^2) decode, host-framework-owned).
Here the cache is a preallocated static-shape buffer updated with
`lax.dynamic_update_slice` — jit-stable shapes, no reallocation, shardable
over the TP (heads) mesh axis.

Cache layout is [batch, n_kv_heads, max_len, head_dim]: one (head, row)
holds a contiguous [max_len, head_dim] slab.

Prefill runs `jax.nn.dot_product_attention` — cuDNN's fused flash attention
on the GPU (the Hopper counterpart of the reference's FlashAttention-2),
XLA's composition on the CPU (`eetq_tpu.backend.attention_implementation`).
Decode (S=1) and speculative verify (S>1 at dynamic offsets) run the same
XLA einsums below at different query counts. Verify rows agree with
sequential decode steps to f32 rounding, bit for bit at the sizes
tests/test_flash_decode.py checks on the CPU; serve.spec's greedy
exactness rests on that agreement.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from eetq_tpu import backend

NEG_INF = float("-inf")


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class KVCache:
    """Per-layer KV cache: [batch, n_kv_heads, max_len, head_dim].

    dtype bf16 by default; int8 (opt-in via init_kv_cache(dtype=jnp.int8))
    stores per-(token, head) symmetric scales in k_scale/v_scale
    [batch, n_kv_heads, max_len] — halves decode KV bandwidth and cache
    memory (a beyond-reference feature; the reference's cache is the host
    framework's dense fp16 past_key_value, SURVEY.md §5)."""

    k: jax.Array
    v: jax.Array
    k_scale: jax.Array | None = None
    v_scale: jax.Array | None = None

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def init_kv_cache(
    batch: int, max_len: int, n_kv_heads: int, head_dim: int, dtype=jnp.bfloat16
) -> KVCache:
    # round the sequence allocation to 128, the paged block granule
    # (unused tail rows are masked by `length` everywhere)
    max_len = -(-max_len // 128) * 128
    shape = (batch, n_kv_heads, max_len, head_dim)
    if dtype == jnp.int8:
        sshape = (batch, n_kv_heads, max_len)
        return KVCache(
            k=jnp.zeros(shape, jnp.int8),
            v=jnp.zeros(shape, jnp.int8),
            k_scale=jnp.zeros(sshape, jnp.float32),
            v_scale=jnp.zeros(sshape, jnp.float32),
        )
    return KVCache(k=jnp.zeros(shape, dtype), v=jnp.zeros(shape, dtype))


def _quantize_kv(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Per-(head, token) symmetric int8: x [B, H, S, D] -> (q, scales [B,H,S])."""
    xf = x.astype(jnp.float32)
    absmax = jnp.max(jnp.abs(xf), axis=-1)
    scale = absmax / 127.0
    safe = jnp.where(scale == 0.0, 1.0, scale)
    q = jnp.clip(jnp.round(xf / safe[..., None]), -127, 127).astype(jnp.int8)
    return q, scale


def _dequantize_kv(q: jax.Array, scale: jax.Array) -> jax.Array:
    return q.astype(jnp.bfloat16) * scale[..., None].astype(jnp.bfloat16)


def update_cache(cache: KVCache, k_new: jax.Array, v_new: jax.Array, offset) -> KVCache:
    """Write [B, S, Hkv, D] new keys/values at sequence position `offset`.

    offset may be a scalar (all rows at the same position — plain generate)
    or a [B] vector of per-row positions (continuous batching: every slot
    is at its own decode offset)."""
    off = jnp.asarray(offset, jnp.int32)
    # [B, S, H, D] -> cache layout [B, H, S, D]
    k_new = k_new.transpose(0, 2, 1, 3)
    v_new = v_new.transpose(0, 2, 1, 3)
    ks = vs = None
    if cache.quantized:
        k_new, ks = _quantize_kv(k_new)
        v_new, vs = _quantize_kv(v_new)
    if off.ndim == 1:
        def row(ck, cv, kn, vn, o):
            return (
                jax.lax.dynamic_update_slice(ck, kn.astype(ck.dtype), (0, o, 0)),
                jax.lax.dynamic_update_slice(cv, vn.astype(cv.dtype), (0, o, 0)),
            )

        k, v = jax.vmap(row)(cache.k, cache.v, k_new, v_new, off)
        if cache.quantized:
            def srow(cs, sn, o):
                return jax.lax.dynamic_update_slice(cs, sn, (0, o))

            return KVCache(
                k=k, v=v,
                k_scale=jax.vmap(srow)(cache.k_scale, ks, off),
                v_scale=jax.vmap(srow)(cache.v_scale, vs, off),
            )
        return KVCache(k=k, v=v)
    zeros = (0, 0, off, 0)
    out = KVCache(
        k=jax.lax.dynamic_update_slice(cache.k, k_new.astype(cache.k.dtype), zeros),
        v=jax.lax.dynamic_update_slice(cache.v, v_new.astype(cache.v.dtype), zeros),
        k_scale=cache.k_scale,
        v_scale=cache.v_scale,
    )
    if cache.quantized:
        szeros = (0, 0, off)
        out = dataclasses.replace(
            out,
            k_scale=jax.lax.dynamic_update_slice(cache.k_scale, ks, szeros),
            v_scale=jax.lax.dynamic_update_slice(cache.v_scale, vs, szeros),
        )
    return out


def _gqa_scores(q: jax.Array, k: jax.Array) -> jax.Array:
    """q: [B, S, Hq, D], k: [B, L, Hkv, D] -> scores [B, Hq, S, L] with GQA
    head grouping (Hq = Hkv * group)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, s, hkv, group, d)
    scores = jnp.einsum(
        "bskgd,blkd->bkgsl", qg, k, preferred_element_type=jnp.float32
    )
    return scores.reshape(b, hq, s, scores.shape[-1])


def _gqa_out(probs: jax.Array, v: jax.Array) -> jax.Array:
    """probs: [B, Hq, S, L], v: [B, L, Hkv, D] -> [B, S, Hq, D]."""
    b, hq, s, l = probs.shape
    hkv = v.shape[2]
    group = hq // hkv
    pg = probs.reshape(b, hkv, group, s, l)
    out = jnp.einsum("bkgsl,blkd->bskgd", pg, v.astype(probs.dtype))
    return out.reshape(b, s, hq, -1)


def attention_reference(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    mask: jax.Array | None,
    scale: float,
    slopes: jax.Array | None = None,
) -> jax.Array:
    """Masked softmax attention oracle (f32 softmax). q [B,S,Hq,D],
    k/v [B,L,Hkv,D] (sequence-major, NOT cache layout), mask broadcastable
    to [B,1,S,L] (True = attend). slopes [Hq]: ALiBi bias
    slope_h * (key_pos - query_pos), with query i aligned to key i
    (self-attention among the same S positions: S == L)."""
    scores = _gqa_scores(q, k) * scale
    if slopes is not None:
        s, l = scores.shape[-2], scores.shape[-1]
        i = jax.lax.broadcasted_iota(jnp.int32, (s, l), 0)
        j = jax.lax.broadcasted_iota(jnp.int32, (s, l), 1)
        dist = (j - i + (l - s)).astype(jnp.float32)  # key ahead of query > 0
        scores = scores + slopes.astype(jnp.float32)[None, :, None, None] * dist
    if mask is not None:
        scores = jnp.where(mask, scores, NEG_INF)
    probs = jax.nn.softmax(scores, axis=-1)
    return _gqa_out(probs, v).astype(q.dtype)


def causal_mask(
    s: int, window: int | None = None, kv_len: int | None = None
) -> jax.Array:
    """[1, 1, s, kv_len] causal (optionally sliding-window) mask. With
    kv_len > s the LAST query aligns with the LAST key (cache-append /
    chunked-prefill semantics: query row i sits at position i + kv_len - s)."""
    l = kv_len if kv_len is not None else s
    i = jax.lax.broadcasted_iota(jnp.int32, (s, l), 0) + (l - s)
    j = jax.lax.broadcasted_iota(jnp.int32, (s, l), 1)
    m = j <= i
    if window is not None:
        m &= j > i - window
    return m[None, None]


def alibi_bias(slopes: jax.Array, s: int, l: int) -> jax.Array:
    """[1, Hq, s, l] ALiBi bias slope_h * (key_pos - query_pos), with the
    LAST query aligned to the LAST key (query i at position i + l - s)."""
    i = jax.lax.broadcasted_iota(jnp.int32, (s, l), 0)
    j = jax.lax.broadcasted_iota(jnp.int32, (s, l), 1)
    dist = (j - i - (l - s)).astype(jnp.float32)
    return slopes.astype(jnp.float32)[None, :, None, None] * dist


@functools.partial(jax.jit, static_argnames=("window",))
def attention_prefill(
    q: jax.Array,
    k: jax.Array,
    v: jax.Array,
    window: int | None = None,
    slopes: jax.Array | None = None,
) -> jax.Array:
    """Causal attention of S queries over L >= S keys, the last query
    aligned to the last key. q [B, S, Hq, D], k/v [B, L, Hkv, D].

    is_causal mirrors the reference's prefill branch
    (`llama_modules.py:109,132-141`). slopes [Hq] enables ALiBi
    (baichuan-13b; reference `models/baichuan.py` delegates this to HF).

    S == L (whole-prompt prefill) takes `backend.attention_implementation()`
    with its built-in causal mask and left window. S < L (a chunk of a
    chunked prefill) always takes the XLA implementation with an explicit
    mask: cuDNN's causal mask aligns the first query with the first key,
    and these queries sit L - S positions later. The XLA implementation
    runs in f32 (its own default rounds the probabilities to the input
    dtype before the product with V).
    """
    s, l = q.shape[1], k.shape[1]
    scale = 1.0 / (q.shape[-1] ** 0.5)
    impl = backend.attention_implementation() if s == l else "xla"
    if impl == "xla":
        # f32 scores, probabilities and products, like the decode path
        dtype = q.dtype
        q, k, v = (t.astype(jnp.float32) for t in (q, k, v))
    bias = None if slopes is None else alibi_bias(slopes, s, l).astype(q.dtype)
    if s == l:
        out = jax.nn.dot_product_attention(
            q, k, v, bias=bias, scale=scale, is_causal=True,
            local_window_size=None if window is None else (window - 1, 0),
            implementation=impl,
        )
    else:
        out = jax.nn.dot_product_attention(
            q, k, v, bias=bias, mask=causal_mask(s, window, kv_len=l),
            scale=scale, implementation=impl,
        )
    return out if impl == "cudnn" else out.astype(dtype)


@functools.partial(jax.jit, static_argnames=("window",))
def attention_decode(
    q: jax.Array,
    cache: KVCache,
    length,
    window: int | None = None,
    slopes: jax.Array | None = None,
) -> jax.Array:
    """Single-step decode: q [B, 1, Hq, D] attends over cache[:, :, :length].

    length is the number of valid cache entries INCLUDING the token being
    decoded (whose K/V must already be written at position length-1); it
    may be a scalar or a per-row [B] vector. slopes [Hq] enables ALiBi.
    """
    scale = 1.0 / (q.shape[-1] ** 0.5)
    return attention_decode_ref(q, cache, length, window, scale, slopes=slopes)


def attention_decode_ref(q, cache: KVCache, length, window, scale,
                         slopes: jax.Array | None = None):
    """XLA einsum oracle over the [B, H, L, D] cache layout."""
    b, s, hq, d = q.shape
    hkv, l = cache.k.shape[1], cache.max_len
    group = hq // hkv
    if cache.quantized:
        k = _dequantize_kv(cache.k, cache.k_scale)
        v = _dequantize_kv(cache.v, cache.v_scale)
    else:
        k, v = cache.k, cache.v
    qg = q.reshape(b, s, hkv, group, d)
    scores = jnp.einsum(
        "bskgd,bkld->bkgsl", qg, k, preferred_element_type=jnp.float32
    ) * scale  # [B, Hkv, G, S, L]
    pos = jax.lax.broadcasted_iota(jnp.int32, (1, 1, 1, 1, l), 4)
    lv = jnp.asarray(length, jnp.int32).reshape(-1, 1, 1, 1, 1)
    if slopes is not None:
        # query sits at position length-1: bias = slope * (key_pos - (len-1))
        dist = (pos - (lv - 1)).astype(jnp.float32)
        scores = scores + slopes.astype(jnp.float32).reshape(
            1, hkv, group, 1, 1
        ) * dist
    mask = pos < lv
    if window is not None:
        mask &= pos >= lv - window
    scores = jnp.where(mask, scores, NEG_INF)
    probs = jax.nn.softmax(scores, axis=-1)
    out = jnp.einsum("bkgsl,bkld->bskgd", probs, v.astype(probs.dtype))
    return out.reshape(b, s, hq, d).astype(q.dtype)


def attention_verify(q, cache: KVCache, length, window, scale,
                     slopes: jax.Array | None = None):
    """Multi-query decode ("verify") attention: q [B, S, Hq, D] with S > 1
    tokens at DYNAMIC positions, query row i sitting at absolute position
    length - S + i, attending causally over cache[:, :, :length].

    This is the speculative-decoding verify step (and the 2-token draft
    catch-up step): the S new tokens' K/V are already written to the cache
    at [length-S, length), and each query must see the prefix plus the
    drafts at or before its own position. `length` may be a scalar or a
    per-row [B] vector (continuous batching). Unlike chunked prefill
    (static offsets, one compile per chunk), positions here are traced —
    one compile covers every loop iteration of a speculative decode."""
    b, s, hq, d = q.shape
    hkv, l = cache.k.shape[1], cache.max_len
    group = hq // hkv
    if cache.quantized:
        k = _dequantize_kv(cache.k, cache.k_scale)
        v = _dequantize_kv(cache.v, cache.v_scale)
    else:
        k, v = cache.k, cache.v
    qg = q.reshape(b, s, hkv, group, d)
    scores = jnp.einsum(
        "bskgd,bkld->bkgsl", qg, k, preferred_element_type=jnp.float32
    ) * scale  # [B, Hkv, G, S, L]
    pos = jax.lax.broadcasted_iota(jnp.int32, (1, 1, 1, 1, l), 4)
    lv = jnp.asarray(length, jnp.int32).reshape(-1, 1, 1, 1, 1)
    # query row i at absolute position lv - s + i
    qpos = lv - s + jax.lax.broadcasted_iota(jnp.int32, (1, 1, 1, s, 1), 3)
    if slopes is not None:
        dist = (pos - qpos).astype(jnp.float32)
        scores = scores + slopes.astype(jnp.float32).reshape(
            1, hkv, group, 1, 1
        ) * dist
    mask = pos <= qpos
    if window is not None:
        mask &= pos > qpos - window
    scores = jnp.where(mask, scores, NEG_INF)
    probs = jax.nn.softmax(scores, axis=-1)
    out = jnp.einsum("bkgsl,bkld->bskgd", probs, v.astype(probs.dtype))
    return out.reshape(b, s, hq, d).astype(q.dtype)


def attention(
    q: jax.Array,
    k_new: jax.Array,
    v_new: jax.Array,
    cache: KVCache | None,
    offset,
    window: int | None = None,
    slopes: jax.Array | None = None,
    verify: bool = False,
) -> tuple[jax.Array, KVCache | None]:
    """Unified entry: write K/V to cache at `offset`, attend appropriately.

    Prefill = S > 1 with offset 0; decode = S == 1 with offset = current
    length. slopes [Hq] enables ALiBi position bias (no RoPE applied by the caller).
    Returns (attn_out [B, S, Hq, D], updated cache).
    """
    s = q.shape[1]
    if cache is not None and type(cache).__name__ == "PagedKVCache":
        # paged decode (modules.paged): scatter-write through the block
        # table, then attention over the gathered blocks
        from eetq_tpu.modules.paged import (
            paged_attention_decode,
            paged_attention_verify,
            paged_write,
            paged_write_multi,
        )

        if s != 1 and not verify:
            raise NotImplementedError(
                "paged caches serve decode; prefill runs on the dense "
                "scratch and hands off via paged_insert_dense"
            )
        if s != 1:
            # speculative-decode verify over the paged pool: S writes
            # through the table, then multi-query attention
            cache = paged_write_multi(cache, k_new, v_new, offset)
            out = paged_attention_verify(
                q, cache, jnp.asarray(offset, jnp.int32) + s, window=window,
                slopes=slopes,
            )
            return out, cache
        cache = paged_write(cache, k_new, v_new, offset)
        out = paged_attention_decode(
            q, cache, jnp.asarray(offset) + 1, window=window, slopes=slopes,
        )
        return out, cache
    if cache is not None:
        cache = update_cache(cache, k_new, v_new, offset)
    if verify and s > 1:
        # Speculative-decode verify: S tokens at DYNAMIC offset (scalar or
        # per-row), each query causally aligned to its own position.
        assert cache is not None, "verify requires a KV cache"
        out = attention_verify(
            q, cache, jnp.asarray(offset, jnp.int32) + s, window,
            1.0 / (q.shape[-1] ** 0.5), slopes=slopes,
        )
        return out, cache
    if s == 1:
        assert cache is not None, "decode requires a KV cache"
        out = attention_decode(
            q, cache, offset + 1, window=window, slopes=slopes,
        )
    elif cache is not None and isinstance(offset, int) and offset > 0:
        # CHUNKED PREFILL: the S-token chunk (already written to the cache
        # at [offset, offset+S)) attends over the whole prefix. `offset`
        # must be a static python int so the cache slice has a static
        # shape — one compile per chunk index, dispatched by the caller
        # (serve.generate.prefill_chunked).
        hist = offset + s
        k_ctx, v_ctx = cache.k[:, :, :hist], cache.v[:, :, :hist]
        if cache.quantized:
            k_ctx = _dequantize_kv(k_ctx, cache.k_scale[:, :, :hist])
            v_ctx = _dequantize_kv(v_ctx, cache.v_scale[:, :, :hist])
        out = attention_prefill(
            q,
            k_ctx.transpose(0, 2, 1, 3),
            v_ctx.transpose(0, 2, 1, 3),
            window=window,
            slopes=slopes,
        )
    else:
        out = attention_prefill(q, k_new, v_new, window=window, slopes=slopes)
    return out, cache
