"""RMSNorm (T5/Llama-style layernorm, no mean subtraction, no bias).

Mirrors `generalT5LayerNorm` (`csrc/layernorm_kernels/layernorm.cu:25-51`):
out = x * rsqrt(mean(x^2) + eps) * gamma, reduction in f32. XLA fuses
this into a bandwidth-bound loop on its own — a hand-written version measured no
faster — so jnp is the implementation (SURVEY.md §2.2 RMSNorm row).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.jit
def rmsnorm(x: jax.Array, gamma: jax.Array, eps: float = 1e-6) -> jax.Array:
    """x: [..., hidden]; gamma: [hidden]. Returns x.dtype."""
    xf = x.astype(jnp.float32)
    var = jnp.mean(xf * xf, axis=-1, keepdims=True)
    normed = xf * jax.lax.rsqrt(var + eps)
    return (normed * gamma.astype(jnp.float32)).astype(x.dtype)
