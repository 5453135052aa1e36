"""Generation loop: jitted prefill + jitted single-token decode step.

The reference delegates generation entirely to HF `transformers.generate`
(`models/base.py:65-72`); here the loop is owned by the program. Shapes are static per
(batch, prompt-bucket, max_len) so everything compiles once; the KV cache is
preallocated and threaded functionally through the decode steps.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from eetq_tpu.models.config import ModelConfig
from eetq_tpu.models.transformer import ModelParams, forward, init_caches


@functools.partial(jax.jit, static_argnames=("cfg", "temperature", "top_k"))
def _sample(logits, key, cfg, temperature: float, top_k: int):
    """logits: [B, V] -> tokens [B]."""
    if temperature == 0.0:
        return jnp.argmax(logits, axis=-1).astype(jnp.int32)
    logits = logits / temperature
    if top_k > 0:
        kth = jax.lax.top_k(logits, top_k)[0][..., -1:]
        logits = jnp.where(logits < kth, -jnp.inf, logits)
    return jax.random.categorical(key, logits).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("cfg", "a8"))
def prefill(params, cfg, tokens, caches, a8: bool = False):
    """tokens: [B, S] full prompt. Returns (last-token logits [B, V], caches).

    a8=True runs projections through the W8A8 int8-activation path (int8
    tensor cores, small extra quantization error) — prefill only."""
    b, s = tokens.shape
    positions = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
    # last_only: the [B, S, V] head output is the largest prefill temp
    # (262 MB at 13B b=4) and S x the needed head FLOPs
    logits, caches = forward(
        params, cfg, tokens, positions, caches, 0, a8=a8, last_only=True,
    )
    return logits[:, -1, :], caches


@functools.partial(
    jax.jit, static_argnames=("cfg", "offset"), donate_argnames=("caches",),
)
def _prefill_chunk(params, cfg, tokens, caches, offset: int):
    """One prefill chunk: tokens [B, C] at STATIC positions
    offset..offset+C. The chunk attends over cache[:, :, :offset+C]
    (static slice -> one compile per chunk index). Returns (last-token
    logits [B, V], caches)."""
    from eetq_tpu.models.transformer import forward_inner

    b, c = tokens.shape
    positions = jnp.broadcast_to(
        offset + jnp.arange(c, dtype=jnp.int32), (b, c)
    )
    # forward_inner directly (not the jitted forward): `offset` must stay a
    # python int so attention() takes the static-slice chunked path
    logits, caches = forward_inner(
        params, cfg, tokens, positions, caches, offset, last_only=True,
    )
    return logits[:, -1, :], caches


def prefill_chunked(
    params,
    cfg,
    tokens,  # [B, S]
    caches,
    chunk: int = 512,
):
    """Prefill in fixed-size chunks: bounds peak attention working set and
    per-dispatch latency (a serving engine can interleave decode between
    chunks instead of stalling for the whole prompt — the TGI-style
    chunked-prefill behavior the reference delegates to its host,
    README.md:88-96). S must be a multiple of `chunk` (pad the prompt).

    Returns (last-token logits [B, V], caches)."""
    b, s = tokens.shape
    if s % chunk:
        raise ValueError(f"prompt length {s} must divide by chunk {chunk}")
    logits = None
    for i in range(s // chunk):
        logits, caches = _prefill_chunk(
            params, cfg, tokens[:, i * chunk : (i + 1) * chunk], caches,
            offset=i * chunk,
        )
    return logits, caches


@functools.partial(jax.jit, static_argnames=("cfg",))
def decode_step(params, cfg, token, pos, caches):
    """token: [B, 1]; pos: scalar int32 position of `token`.
    Returns (logits [B, V], caches)."""
    b = token.shape[0]
    positions = jnp.broadcast_to(jnp.asarray(pos, jnp.int32), (b, 1))
    logits, caches = forward(params, cfg, token, positions, caches, pos)
    return logits[:, -1, :], caches


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "num_steps", "temperature", "top_k",
                     "eos_token_id"),
    donate_argnames=("caches",),
)
def decode_loop(
    params,
    cfg,
    first_token,  # [B] sampled from prefill logits
    start_pos,  # scalar int32: position of first_token
    caches,
    num_steps: int,
    temperature: float = 0.0,
    top_k: int = 0,
    key: jax.Array | None = None,
    eos_token_id: int | None = None,
):
    """The whole decode loop as ONE compiled program (lax.scan over steps,
    KV caches as donated carry): a single device-side program with zero per-token host involvement — unlike
    the reference, whose host framework re-dispatches every step
    (`models/base.py:65-72` delegates to HF generate). Returns tokens
    [B, num_steps] (first_token included) and the final caches."""
    if key is None:
        key = jax.random.PRNGKey(0)
    b = first_token.shape[0]
    from eetq_tpu.models.transformer import forward_inner

    def body(carry, i):
        token, caches, key, finished = carry
        key, sub = jax.random.split(key)
        pos = (start_pos + i).astype(jnp.int32)
        logits, caches = forward_inner(
            params, cfg, token[:, None],
            jnp.broadcast_to(pos, (b, 1)), caches, pos,
        )
        nxt = _sample(logits[:, -1, :], sub, cfg, temperature, top_k)
        if eos_token_id is not None:
            nxt = jnp.where(finished, eos_token_id, nxt)
            finished = finished | (nxt == eos_token_id)
        return (nxt, caches, key, finished), nxt

    finished = (
        first_token == eos_token_id
        if eos_token_id is not None
        else jnp.zeros((b,), bool)
    )
    (_, caches, _, _), toks = jax.lax.scan(
        body,
        (first_token, caches, key, finished),
        jnp.arange(num_steps - 1, dtype=jnp.int32),
    )
    return jnp.concatenate([first_token[:, None], toks.T], axis=1), caches


def generate(
    params: ModelParams,
    cfg: ModelConfig,
    prompt: jax.Array,  # [B, S] int32
    max_new_tokens: int,
    temperature: float = 0.0,
    top_k: int = 0,
    key: jax.Array | None = None,
    eos_token_id: int | None = None,
    kv_dtype=jnp.bfloat16,
    use_scan: bool = True,
) -> jax.Array:
    """Returns generated tokens [B, max_new_tokens] (prompt not included).

    Greedy when temperature == 0. use_scan=True (default) runs the whole
    decode loop device-side as one compiled scan; use_scan=False streams
    token-by-token through a single compiled decode step.
    """
    b, s = prompt.shape
    max_len = s + max_new_tokens
    caches = init_caches(cfg, b, max_len, dtype=kv_dtype)
    if key is None:
        key = jax.random.PRNGKey(0)

    logits, caches = prefill(params, cfg, prompt, caches)
    key, sub = jax.random.split(key)
    token = _sample(logits, sub, cfg, temperature, top_k)

    if use_scan:
        toks, _ = decode_loop(
            params, cfg, token, jnp.int32(s), caches, max_new_tokens,
            temperature=temperature, top_k=top_k, key=key,
            eos_token_id=eos_token_id,
        )
        return toks

    # Streaming (per-step dispatch) path — for interactive use.
    out = [token]
    finished = None
    if eos_token_id is not None:
        finished = token == eos_token_id
    for i in range(1, max_new_tokens):
        key, sub = jax.random.split(key)
        # pos as a traced scalar: one compile of decode_step for all steps
        logits, caches = decode_step(
            params, cfg, token[:, None], jnp.int32(s + i - 1), caches
        )
        token = _sample(logits, sub, cfg, temperature, top_k)
        if finished is not None:
            token = jnp.where(finished, eos_token_id, token)
            finished = finished | (token == eos_token_id)
        out.append(token)
        if finished is not None and bool(finished.all()):
            # pad remaining positions with eos
            pad = jnp.full((b,), eos_token_id, jnp.int32)
            out.extend([pad] * (max_new_tokens - 1 - i))
            break
    return jnp.stack(out, axis=1)


def greedy_generate(params, cfg, prompt, max_new_tokens, **kw):
    return generate(params, cfg, prompt, max_new_tokens, temperature=0.0, **kw)
