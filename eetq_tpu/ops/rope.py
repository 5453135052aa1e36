"""NeoX-style rotary position embedding.

Mirrors the reference's vLLM-derived CUDA kernel
(`csrc/embedding_kernels/pos_encoding_kernels.cu:12-53`) and its Python cache
builder (`python/eetq/modules/llama_modules.py:33-45`): the cache is
[max_pos, rot_dim] = concat([cos, sin], axis=-1) with each half of width
rot_dim/2, and rotation uses the NeoX split-half convention
(x_index = i, y_index = rot_dim/2 + i).

This is pure elementwise work that XLA fuses into neighbouring
ops, so it is expressed as jnp (a dedicated kernel would only add
dispatch overhead); the fused attention layer inlines it under jit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def make_cos_sin_cache(
    max_position: int,
    rot_dim: int,
    base: float = 10000.0,
    dtype=jnp.float32,
) -> jax.Array:
    """[max_position, rot_dim] cache, first half cos, second half sin."""
    inv_freq = 1.0 / (base ** (jnp.arange(0, rot_dim, 2, dtype=jnp.float32) / rot_dim))
    t = jnp.arange(max_position, dtype=jnp.float32)
    freqs = jnp.outer(t, inv_freq)  # [max_pos, rot_dim/2]
    return jnp.concatenate([jnp.cos(freqs), jnp.sin(freqs)], axis=-1).astype(dtype)


@functools.partial(jax.jit, static_argnames=("interleaved",))
def rope(
    x: jax.Array,
    positions: jax.Array,
    cos_sin_cache: jax.Array,
    interleaved: bool = False,
) -> jax.Array:
    """Apply rotary embedding.

    x: [batch, seq, heads, head_dim] (rotates the first rot_dim of head_dim)
    positions: [batch, seq] int32 absolute positions
    cos_sin_cache: [max_pos, rot_dim] from :func:`make_cos_sin_cache`.
    interleaved: False = NeoX split-half pairing (x_i with x_{half+i}; the
    reference kernel's convention). True = GPT-J/ChatGLM pairing of
    adjacent lanes (x_{2i} with x_{2i+1}) — chatglm2/3 applies this over
    the first HALF of head_dim (rot_dim = head_dim // 2).
    """
    rot_dim = cos_sin_cache.shape[-1]
    half = rot_dim // 2
    cs = cos_sin_cache[positions]  # [b, s, rot_dim]
    cos = cs[..., :half][:, :, None, :].astype(jnp.float32)  # [b, s, 1, half]
    sin = cs[..., half:][:, :, None, :].astype(jnp.float32)
    x_rot = x[..., :rot_dim].astype(jnp.float32)
    if interleaved:
        pairs = x_rot.reshape(*x_rot.shape[:-1], half, 2)
        x1 = pairs[..., 0]
        x2 = pairs[..., 1]
        rotated = jnp.stack(
            [x1 * cos - x2 * sin, x2 * cos + x1 * sin], axis=-1
        ).reshape(x_rot.shape)
    else:
        x1 = x_rot[..., :half]
        x2 = x_rot[..., half:]
        rotated = jnp.concatenate(
            [x1 * cos - x2 * sin, x2 * cos + x1 * sin], axis=-1
        )
    out = jnp.concatenate([rotated, x[..., rot_dim:].astype(jnp.float32)], axis=-1)
    return out.astype(x.dtype)
