"""Speculative decoding: greedy-exact draft-and-verify generation.

A beyond-reference throughput lever (the reference delegates generation to
HF `transformers.generate`, `python/eetq/models/base.py:65-72`, and ships
no speculative path). Decode is weight-streaming-bound, so a verify forward over k+1 tokens at
m = k+1 <= 8 rides the SAME decode-GEMV regime and costs roughly ONE decode
step. Every accepted draft token is therefore nearly free target compute.

Two draft sources:
  * a draft model (`spec_generate`): any smaller/faster model sharing the
    tokenizer — e.g. the W4A16 quantization of the same weights drafting
    for the W8A16 target, or a truncated-layer draft.
  * n-gram / prompt-lookup (`ngram_spec_generate`): draft-free — propose
    the k tokens that followed the most recent occurrence of the current
    bigram in the (prompt + generated) history. Zero draft cost means the
    worst case degenerates to ~1 token per verify step ~= plain decode.

Both run the WHOLE generation as one device-side `lax.while_loop` program
(no per-round host involvement), are exact: the emitted sequence equals the
target model's greedy decode token-for-token, and support per-row dynamic
positions (rows accept different counts and drift apart, like continuous
batching).

Exactness caveat: "token-for-token" holds when the verify forward's
logits pick the same argmax as the sequential decode step's. The m <= 8
verify forward takes the same code path as the m = 1 decode step, and a
decode-regime projection gives each row the same bits whatever the row
count (the CPU pads to 8 rows; the GPU's GEMV kernel sums each row on its
own). The attention einsums (S = k+1 against S = 1) and a bf16 lm_head
reduce in shape-dependent orders, so the logits agree to bf16 rounding,
not bit for bit, on the CPU and the GPU alike (tests/test_chip.py), and
argmax can flip on near-tied logits — real models have ~no ties;
random-weight test models do.

Mechanics per round (positions are absolute, per row; p = position of the
last accepted-but-unprocessed token `last`):
  1. draft catch-up: one 2-token verify-style step over [prev, last] at
     positions p-1..p. Re-writing KV at p-1 is a harmless recompute; it
     heals the one-row cache hole left when the previous round accepted
     every draft (the draft never fed its own final proposal).
  2. k-1 single draft decode steps -> drafts d_1..d_k.
  3. ONE target forward over [last, d_1..d_{k-1}, d_k] at p..p+k with
     `verify=True` attention (each query causally aligned to its own
     dynamic position) -> greedy continuations g_0..g_k.
  4. accept the longest prefix with d_i == g_{i-1}; emit d_1..d_a, g_a
     (a+1 tokens, between 1 and k+1). Rejected rows' KV stay in the cache
     but are masked by length and overwritten next round.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from eetq_tpu.models.transformer import forward_inner, init_caches
from eetq_tpu.serve.generate import prefill


def _verify_forward(params, cfg, tokens, start, caches, lora_idx=None):
    """tokens [B, S] at per-row positions start..start+S-1 (start [B]).
    Returns (logits [B, S, V], caches)."""
    s = tokens.shape[1]
    positions = start[:, None] + jnp.arange(s, dtype=jnp.int32)[None]
    return forward_inner(
        params, cfg, tokens, positions, caches, start, verify=True,
        lora_idx=lora_idx,
    )


def _sample_pos(logits, emit_idx, key, temperature: float, top_k: int):
    """Positional sampling: token for (row r, emission index i) is drawn
    from categorical(logits / T) with PRNG key fold_in(fold_in(key, i), r).

    Randomness is keyed by POSITION, not by draw order — so a sequential
    decode and a speculative decode that evaluate the same (row, index)
    draw the SAME token. This is what makes sampled speculation exact
    token-for-token (accept a draft iff it equals the target's positional
    sample), the sampled counterpart of greedy exact-match acceptance.

    logits [B, S, V]; emit_idx [B, S] int32. Returns [B, S] int32."""
    if temperature == 0.0:
        return jnp.argmax(logits, axis=-1).astype(jnp.int32)
    b, s, v = logits.shape
    scaled = logits.astype(jnp.float32) / temperature
    if top_k > 0:
        kth = jax.lax.top_k(scaled, top_k)[0][..., -1:]
        scaled = jnp.where(scaled < kth, -jnp.inf, scaled)
    rows = jnp.broadcast_to(
        jnp.arange(b, dtype=jnp.int32)[:, None], (b, s)
    ).reshape(-1)
    idxs = emit_idx.reshape(-1).astype(jnp.int32)

    def draw(lg, i, r):
        kk = jax.random.fold_in(jax.random.fold_in(key, i), r)
        return jax.random.categorical(kk, lg)

    toks = jax.vmap(draw)(scaled.reshape(-1, v), idxs, rows)
    return toks.reshape(b, s).astype(jnp.int32)


def _sample_pos_rows(logits, emit_idx, row_keys, temps, topks, topk_cap: int):
    """Per-row mixed greedy/sampled positional sampling (the ENGINE spec
    window's sampler). logits [B, S, V]; emit_idx [B, S] per-request
    emission indices; row_keys [B] per-REQUEST PRNG keys (fold_in of the
    engine seed by request uid — stable across windows, so the committed
    stream is independent of window size); temps [B] (0 = greedy row);
    topks [B] (0 = no filter); topk_cap static. Returns [B, S] int32."""
    b, s, v = logits.shape
    greedy = jnp.argmax(logits, -1).astype(jnp.int32)
    scaled = logits.astype(jnp.float32) / jnp.maximum(temps, 1e-6)[:, None, None]
    if topk_cap > 0:
        vals = jax.lax.top_k(scaled, topk_cap)[0]  # [B, S, cap]
        idx = jnp.clip(topks - 1, 0, topk_cap - 1)[:, None, None]
        kth = jnp.take_along_axis(vals, jnp.broadcast_to(idx, (b, s, 1)), 2)
        scaled = jnp.where(
            (topks[:, None, None] > 0) & (scaled < kth), -jnp.inf, scaled
        )
    rows = jnp.broadcast_to(
        jnp.arange(b, dtype=jnp.int32)[:, None], (b, s)
    ).reshape(-1)

    def draw(lg, i, r):
        return jax.random.categorical(
            jax.random.fold_in(row_keys[r], i), lg
        )

    sampled = jax.vmap(draw)(
        scaled.reshape(-1, v), emit_idx.reshape(-1).astype(jnp.int32), rows
    ).reshape(b, s).astype(jnp.int32)
    return jnp.where(temps[:, None] > 0, sampled, greedy)


def positional_generate(
    params,
    cfg,
    prompt: jax.Array,
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: int = 0,
    key: jax.Array | None = None,
    kv_dtype=jnp.bfloat16,
):
    """Plain SEQUENTIAL decode with positional sampling (`_sample_pos`) —
    the parity oracle for sampled speculation: `spec_generate(...)` /
    `ngram_spec_generate(...)` with the same key/temperature/top_k emit
    exactly this token sequence."""
    if key is None:
        key = jax.random.PRNGKey(0)
    b, s = prompt.shape
    caches = init_caches(cfg, b, s + max_new_tokens, dtype=kv_dtype)
    logits, caches = prefill(params, cfg, prompt, caches)
    tok = _sample_pos(
        logits[:, None], jnp.zeros((b, 1), jnp.int32), key, temperature,
        top_k,
    )[:, 0]
    return _positional_decode_loop(
        params, cfg, tok, jnp.int32(s), caches, max_new_tokens,
        temperature, top_k, key,
    )


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "num_steps", "temperature", "top_k"),
    donate_argnames=("caches",),
)
def _positional_decode_loop(params, cfg, first_token, start_pos, caches,
                            num_steps: int, temperature: float, top_k: int,
                            key):
    b = first_token.shape[0]

    def body(carry, i):
        token, caches = carry
        pos = (start_pos + i).astype(jnp.int32)
        logits, caches = forward_inner(
            params, cfg, token[:, None],
            jnp.broadcast_to(pos, (b, 1)), caches, pos,
        )
        nxt = _sample_pos(
            logits[:, -1][:, None],
            jnp.full((b, 1), i + 1, jnp.int32),
            key, temperature, top_k,
        )[:, 0]
        return (nxt, caches), nxt

    (_, caches), toks = jax.lax.scan(
        body, (first_token, caches), jnp.arange(num_steps - 1, dtype=jnp.int32)
    )
    return jnp.concatenate([first_token[:, None], toks.T], axis=1)


def _accept_and_emit(drafts, g, t_in, last_col_limit, n, out, k):
    """Greedy acceptance: longest prefix of drafts matching the target's
    greedy continuations. Returns (new_last, new_prev, adv [B], a [B],
    out, em [B, k+1] — the emitted block, real only in its first adv
    columns)."""
    match = drafts == g[:, :k]
    a = jnp.sum(jnp.cumprod(match.astype(jnp.int32), axis=1), axis=1)  # [0,k]
    g_at_a = jnp.take_along_axis(g, a[:, None], axis=1)[:, 0]
    j = jnp.arange(k + 1, dtype=jnp.int32)[None]
    d_pad = jnp.concatenate([drafts, drafts[:, -1:]], axis=1)
    em = jnp.where(j < a[:, None], d_pad, g_at_a[:, None])  # [B, k+1]

    def wrow(o, e, idx):
        return jax.lax.dynamic_update_slice(o, e, (idx,))

    # frozen rows (n >= limit) write into the slack columns only
    out = jax.vmap(wrow)(out, em, jnp.minimum(n, last_col_limit))
    adv = jnp.where(n >= last_col_limit, 0, a + 1)
    new_prev = jnp.take_along_axis(t_in, a[:, None], axis=1)[:, 0]
    return g_at_a, new_prev, adv, a, out, em


@functools.partial(
    jax.jit,
    static_argnames=("cfg_t", "cfg_d", "num_steps", "k",
                     "temperature", "top_k"),
    donate_argnames=("t_caches", "d_caches"),
)
def spec_decode_loop(
    t_params,
    d_params,
    cfg_t,
    cfg_d,
    first_token,  # [B] target token from the prefill logits
    prev_token,  # [B] last prompt token (position start_pos - 1)
    start_pos,  # scalar int: position of first_token
    t_caches,
    d_caches,
    num_steps: int,
    k: int = 7,
    temperature: float = 0.0,
    top_k: int = 0,
    sample_key: jax.Array | None = None,
):
    """Whole speculative decode as ONE compiled while_loop program.

    Returns (tokens [B, num_steps] — exactly the target's greedy (or
    positionally-sampled, temperature > 0) sequence, first_token included —
    plus stats (rounds, accepted-draft total))."""
    b = first_token.shape[0]
    width = num_steps + k + 1  # slack so frozen rows scribble out of range
    out0 = jnp.zeros((b, width), jnp.int32).at[:, 0].set(first_token)
    n0 = jnp.ones((b,), jnp.int32)
    start = jnp.asarray(start_pos, jnp.int32)

    def cond(carry):
        return jnp.any(carry[2] < num_steps)

    def body(carry):
        last, prev, n, out, t_caches, d_caches, rounds, acc = carry
        p = start + n - 1  # [B] position of `last`

        # 1. draft catch-up: [prev, last] at p-1..p (rewrites KV at p-1)
        toks2 = jnp.stack([prev, last], axis=1)
        logits2, d_caches = _verify_forward(
            d_params, cfg_d, toks2, p - 1, d_caches
        )
        d1 = jnp.argmax(logits2[:, -1, :], -1).astype(jnp.int32)

        # 2. k-1 single draft steps
        def dstep(c, i):
            tok, caches = c
            pos = p + i
            lg, caches = forward_inner(
                d_params, cfg_d, tok[:, None], pos[:, None], caches, pos,
            )
            return (jnp.argmax(lg[:, -1, :], -1).astype(jnp.int32), caches), tok

        (d_last, d_caches), d_hist = jax.lax.scan(
            dstep, (d1, d_caches), jnp.arange(1, k, dtype=jnp.int32)
        )
        drafts = jnp.concatenate([d_hist.T, d_last[:, None]], axis=1)  # [B,k]

        # 3. verify: one target forward over [last, d_1..d_k] at p..p+k
        t_in = jnp.concatenate([last[:, None], drafts], axis=1)
        logits, t_caches = _verify_forward(
            t_params, cfg_t, t_in, p, t_caches
        )
        # target tokens for emission indices n..n+k (positional sampling;
        # temperature == 0 reduces to argmax)
        emit_idx = n[:, None] + jnp.arange(k + 1, dtype=jnp.int32)[None]
        g = _sample_pos(logits, emit_idx, sample_key, temperature, top_k)

        # 4. accept + emit
        last, prev, adv, a, out, _ = _accept_and_emit(
            drafts, g, t_in, num_steps, n, out, k
        )
        acc = acc + jnp.sum(jnp.where(n >= num_steps, 0, a))
        return (last, prev, n + adv, out, t_caches, d_caches, rounds + 1, acc)

    carry = (
        first_token, prev_token, n0, out0, t_caches, d_caches,
        jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
    )
    _, _, _, out, _, _, rounds, acc = jax.lax.while_loop(cond, body, carry)
    return out[:, :num_steps], (rounds, acc)


def spec_generate(
    t_params,
    cfg_t,
    d_params,
    cfg_d,
    prompt: jax.Array,  # [B, S] int32
    max_new_tokens: int,
    k: int = 7,
    kv_dtype=jnp.bfloat16,
    return_stats: bool = False,
    temperature: float = 0.0,
    top_k: int = 0,
    key: jax.Array | None = None,
):
    """Speculative generation with a draft model. Greedy (temperature 0):
    output is exactly `greedy_generate(t_params, cfg_t, prompt, n)`.
    Sampled (temperature > 0): output is exactly
    `positional_generate(t_params, cfg_t, prompt, n, temperature, top_k,
    key)` — positional PRNG makes acceptance exact (see `_sample_pos`).
    k=7 keeps the verify step at m=8, the top of the decode-GEMV regime."""
    b, s = prompt.shape
    if key is None:
        key = jax.random.PRNGKey(0)
    max_len = s + max_new_tokens + 2 * k + 1  # slack for frozen-row writes
    t_caches = init_caches(cfg_t, b, max_len, dtype=kv_dtype)
    d_caches = init_caches(cfg_d, b, max_len, dtype=kv_dtype)
    t_logits, t_caches = prefill(t_params, cfg_t, prompt, t_caches)
    _, d_caches = prefill(d_params, cfg_d, prompt, d_caches)
    first = _sample_pos(
        t_logits[:, None], jnp.zeros((b, 1), jnp.int32), key, temperature,
        top_k,
    )[:, 0]
    toks, stats = spec_decode_loop(
        t_params, d_params, cfg_t, cfg_d, first, prompt[:, -1], s,
        t_caches, d_caches, max_new_tokens, k=k,
        temperature=temperature, top_k=top_k, sample_key=key,
    )
    if return_stats:
        return toks, {"rounds": int(stats[0]), "accepted_drafts": int(stats[1])}
    return toks


# ---------------------------------------------------------------------------
# n-gram (prompt-lookup) drafting: no draft model at all.
# ---------------------------------------------------------------------------


def _ngram_match(hist, valid, last, k: int):
    """Per-row prompt-lookup draft: the k tokens that followed the most
    recent occurrence of the current bigram (hist[valid-2], last) in
    hist[:valid-1]. hist [B, H]; valid [B] counts real tokens INCLUDING
    `last` (== hist[:, valid-1]). Returns drafts [B, k] (garbage rows
    where no match exists — the verify step rejects them)."""
    hist_len = hist.shape[1]
    prev = jax.vmap(lambda h, i: h[i])(hist, jnp.maximum(valid - 2, 0))
    idx = jnp.arange(hist_len, dtype=jnp.int32)[None]
    m = (
        (hist == last[:, None])
        & (jnp.roll(hist, 1, axis=1) == prev[:, None])
        & (idx >= 1)
        & (idx < (valid - 1)[:, None])  # strictly before `last` itself
    )
    t = jnp.max(jnp.where(m, idx, -1), axis=1)  # [B]; -1 = no match

    def drow(h, ti):
        return jax.lax.dynamic_slice(h, (jnp.maximum(ti, 0) + 1,), (k,))

    return jax.vmap(drow)(hist, t)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "num_steps", "k", "temperature",
                     "top_k"),
    donate_argnames=("caches",),
)
def ngram_spec_decode_loop(
    params,
    cfg,
    prompt,  # [B, S] — matched against as history
    first_token,
    start_pos,
    caches,
    num_steps: int,
    k: int = 7,
    temperature: float = 0.0,
    top_k: int = 0,
    sample_key: jax.Array | None = None,
):
    """Prompt-lookup speculative decode: drafts come from matching the
    current bigram against the prompt + generated history (device-side).
    Worst case (no matches) still emits 1 token per verify — and a verify
    costs about one decode step, so this never loses materially."""
    b, s = prompt.shape
    width = num_steps + k + 1
    out0 = jnp.zeros((b, width), jnp.int32).at[:, 0].set(first_token)
    start = jnp.asarray(start_pos, jnp.int32)
    hist_len = s + width

    def cond(carry):
        return jnp.any(carry[1] < num_steps)

    def body(carry):
        last, n, out, caches, rounds, acc = carry
        p = start + n - 1
        hist = jnp.concatenate([prompt, out], axis=1)  # [B, s + width]
        valid = s + n  # [B] tokens of real history (incl. `last`)
        drafts = _ngram_match(hist, valid, last, k)

        t_in = jnp.concatenate([last[:, None], drafts], axis=1)
        logits, caches = _verify_forward(
            params, cfg, t_in, p, caches
        )
        emit_idx = n[:, None] + jnp.arange(k + 1, dtype=jnp.int32)[None]
        g = _sample_pos(logits, emit_idx, sample_key, temperature, top_k)

        last, _, adv, a, out, _ = _accept_and_emit(
            drafts, g, t_in, num_steps, n, out, k
        )
        acc = acc + jnp.sum(jnp.where(n >= num_steps, 0, a))
        return (last, n + adv, out, caches, rounds + 1, acc)

    carry = (
        first_token, jnp.ones((b,), jnp.int32), out0, caches,
        jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32),
    )
    _, _, out, _, rounds, acc = jax.lax.while_loop(cond, body, carry)
    return out[:, :num_steps], (rounds, acc)


def _ngram_window_core(
    verify_fn,
    hist,  # [B, H] committed history per row (prompt + outputs, padded)
    valid,  # [B] real tokens in hist, INCLUDING the pending `last`
    last,  # [B] last committed token; its KV is NOT yet cached
    lengths,  # [B] cached KV count per row == `last`'s position
    caches,
    window: int,
    k: int,
    sample_args=None,  # None = greedy; (emit0 [B], row_keys [B, ...],
    #                    temps [B], topks [B]) = per-row positional sampling
    topk_cap: int = 0,
):
    """The engine spec-window while_loop, parametrized by `verify_fn(t_in,
    start, caches) -> (logits, caches)` so the LOCAL (forward_inner) and
    SHARDED (shard_map body, dist.sharding.make_spec_window_fn) backends
    share one implementation.

    Engine invariant preserved: on entry each row's cache holds KV for
    positions [0, lengths); `last` is pending at position `lengths`. The
    loop runs verify rounds until every row has emitted >= window tokens
    (each round emits >= 1/row, so it terminates in <= window rounds),
    then reports exactly c = min(emitted, window) tokens per row.
    Overshoot beyond `window` is DISCARDED (its KV is stale-but-masked
    and recomputed next window), so the commit semantics match the plain
    decode window: lengths += c, next last = out[c-1].

    Returns (out [B, window], counts [B], caches, rounds)."""
    b, hist_len = hist.shape
    width = window + k + 1  # frozen rows scribble into the slack columns
    out0 = jnp.zeros((b, width), jnp.int32)
    valid = jnp.maximum(valid, 2)  # inactive engine slots: safe indices

    def cond(carry):
        return jnp.any(carry[1] < window)

    def body(carry):
        last, m, out, hist, valid, caches, rounds = carry
        drafts = _ngram_match(hist, valid, last, k)
        t_in = jnp.concatenate([last[:, None], drafts], axis=1)
        logits, caches = verify_fn(t_in, lengths + m, caches)
        if sample_args is None:
            g = jnp.argmax(logits, -1).astype(jnp.int32)
        else:
            emit0, row_keys, temps, topks = sample_args
            emit_idx = (emit0 + m)[:, None] + jnp.arange(
                k + 1, dtype=jnp.int32
            )[None]
            g = _sample_pos_rows(
                logits, emit_idx, row_keys, temps, topks, topk_cap
            )
        last, _, adv, a, out, em = _accept_and_emit(
            drafts, g, t_in, window, m, out, k
        )

        # append this round's emitted tokens to the device-side history so
        # later rounds can match against them; frozen rows (adv == 0)
        # rewrite garbage at their stale `valid` cursor, which is beyond
        # every index the matcher reads (< valid - 1) — harmless
        def hrow(h, e, at):
            return jax.lax.dynamic_update_slice(h, e, (at,))

        hist = jax.vmap(hrow)(
            hist, em, jnp.minimum(valid, hist_len - (k + 1))
        )
        valid = valid + adv
        return (last, m + adv, out, hist, valid, caches, rounds + 1)

    carry = (last, jnp.zeros((b,), jnp.int32), out0, hist, valid, caches,
             jnp.zeros((), jnp.int32))
    last, m, out, _, _, caches, rounds = jax.lax.while_loop(cond, body, carry)
    counts = jnp.minimum(m, window)
    return out[:, :window], counts, caches, rounds


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "window", "k", "topk_cap"),
    donate_argnames=("caches",),
)
def ngram_spec_window(
    params,
    cfg,
    hist,
    valid,
    last,
    lengths,
    caches,
    window: int,
    k: int = 7,
    lora_ids=None,
    sample_args=None,
    topk_cap: int = 0,
):
    """One ENGINE decode window of n-gram speculative rounds, local
    single-device backend (see `_ngram_window_core` for semantics; the
    sharded counterpart is `dist.sharding.make_spec_window_fn`)."""

    def verify(t_in, start, caches):
        return _verify_forward(
            params, cfg, t_in, start, caches,
            lora_idx=lora_ids,
        )

    return _ngram_window_core(
        verify, hist, valid, last, lengths, caches, window, k,
        sample_args=sample_args, topk_cap=topk_cap,
    )


def ngram_spec_generate(
    params,
    cfg,
    prompt: jax.Array,
    max_new_tokens: int,
    k: int = 7,
    kv_dtype=jnp.bfloat16,
    return_stats: bool = False,
    temperature: float = 0.0,
    top_k: int = 0,
    key: jax.Array | None = None,
):
    """Prompt-lookup speculative generation (draft-free). Greedy output is
    exactly the target's greedy decode; sampled (temperature > 0) output
    is exactly `positional_generate` with the same key (see
    `_sample_pos`)."""
    b, s = prompt.shape
    if key is None:
        key = jax.random.PRNGKey(0)
    max_len = s + max_new_tokens + 2 * k + 1
    caches = init_caches(cfg, b, max_len, dtype=kv_dtype)
    logits, caches = prefill(params, cfg, prompt, caches)
    first = _sample_pos(
        logits[:, None], jnp.zeros((b, 1), jnp.int32), key, temperature,
        top_k,
    )[:, 0]
    toks, stats = ngram_spec_decode_loop(
        params, cfg, prompt, first, s, caches, max_new_tokens, k=k, temperature=temperature, top_k=top_k,
        sample_key=key,
    )
    if return_stats:
        return toks, {"rounds": int(stats[0]), "accepted_drafts": int(stats[1])}
    return toks
