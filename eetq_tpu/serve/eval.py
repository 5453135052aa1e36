"""Perplexity evaluation harness.

The reference publishes no accuracy numbers (SURVEY.md §6); the implicit
claim of per-channel symmetric W8A16 is near-lossless perplexity
(BASELINE.md: WikiText-2 ΔPPL <= 0.1 vs fp16). This module makes that
measurable: sliding-window NLL over any token stream, plus a dense-vs-
quantized comparison helper. Zero-egress friendly — callers supply the
token ids (e.g. a pre-tokenized WikiText-2 file).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from eetq_tpu.models.config import ModelConfig
from eetq_tpu.models.transformer import ModelParams, forward


@functools.partial(jax.jit, static_argnames=("cfg",))
def _window_nll(params, cfg, tokens, mask):
    """Sum NLL + token count for one [B, S] window.

    tokens[:, :-1] predict tokens[:, 1:]; mask marks REAL target positions
    (0 for padding). Returns (sum_nll f32, num_targets f32).
    """
    b, s = tokens.shape
    positions = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
    logits, _ = forward(
        params, cfg, tokens, positions, None, jnp.int32(0)
    )
    logp = jax.nn.log_softmax(logits[:, :-1, :].astype(jnp.float32), axis=-1)
    tgt = tokens[:, 1:]
    nll = -jnp.take_along_axis(logp, tgt[..., None], axis=-1)[..., 0]
    m = mask[:, 1:].astype(jnp.float32)
    return jnp.sum(nll * m), jnp.sum(m)


def perplexity(
    params: ModelParams,
    cfg: ModelConfig,
    token_ids,
    window: int = 2048,
    batch_size: int = 1,
) -> float:
    """Sliding (non-overlapping) window perplexity over a 1-D token stream.

    Matches the standard WikiText-2 protocol: split the stream into
    `window`-sized chunks, each chunk predicts its own continuation (first
    token of each chunk is context only). Last partial chunk is padded and
    masked out.
    """
    ids = np.asarray(token_ids, dtype=np.int32).ravel()
    window = min(window, cfg.max_position)
    n_chunks = max(1, math.ceil(len(ids) / window))
    padded = np.zeros((n_chunks * window,), np.int32)
    padded[: len(ids)] = ids
    mask = np.zeros_like(padded)
    mask[: len(ids)] = 1
    chunks = padded.reshape(n_chunks, window)
    masks = mask.reshape(n_chunks, window)

    # pad chunk count to a batch multiple
    pad_rows = (-n_chunks) % batch_size
    if pad_rows:
        chunks = np.concatenate([chunks, np.zeros((pad_rows, window), np.int32)])
        masks = np.concatenate([masks, np.zeros((pad_rows, window), np.int32)])

    total_nll, total_cnt = 0.0, 0.0
    for i in range(0, len(chunks), batch_size):
        nll, cnt = _window_nll(
            params,
            cfg,
            jnp.asarray(chunks[i : i + batch_size]),
            jnp.asarray(masks[i : i + batch_size]),
        )
        total_nll += float(nll)
        total_cnt += float(cnt)
    if total_cnt == 0:
        raise ValueError("no target tokens")
    return math.exp(total_nll / total_cnt)


def delta_ppl(
    dense_params: ModelParams,
    quant_params: ModelParams,
    cfg: ModelConfig,
    token_ids,
    **kw,
) -> dict:
    """The BASELINE.md acceptance metric: quantized PPL - dense PPL."""
    p_dense = perplexity(dense_params, cfg, token_ids, **kw)
    p_quant = perplexity(quant_params, cfg, token_ids, **kw)
    return {
        "ppl_dense": p_dense,
        "ppl_quant": p_quant,
        "delta_ppl": p_quant - p_dense,
    }
