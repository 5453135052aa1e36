"""Long-context generation with ring attention (sequence-parallel prefill).

The reference's context ceiling is one GPU's flash-attn memory with a
hardcoded 2048-position cache (`modules/llama_modules.py:20,89`). Here the
prompt is prefilled SEQUENCE-SHARDED over a mesh axis: every device owns
S/p contiguous tokens, ring attention rotates KV shards over ICI
(`dist/ring_attention.py`), and decode continues from the gathered dense
cache.

Run on CPU with 8 virtual devices:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python examples/models/long_context_example.py
(on a multi-GPU host, drop the env vars — the mesh axis rides NVLink).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax

if jax.default_backend() == "cpu" and len(jax.devices()) < 2:
    print("need >1 device; set XLA_FLAGS=--xla_force_host_platform_device_count=8")
    sys.exit(0)

import jax.numpy as jnp
import numpy as np

from eetq_tpu.dist import generate_long, make_mesh
from eetq_tpu.models import ModelConfig, quantize_params, random_dense_params
from eetq_tpu.serve.generate import greedy_generate

cfg = ModelConfig(
    vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
    num_heads=8, num_kv_heads=4, head_dim=32, max_position=4096,
)
params = quantize_params(
    random_dense_params(cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
)

p = len(jax.devices())
mesh = make_mesh(tp=p, dp=1)  # the axis is used for SEQUENCE sharding here
s = 128 * p  # long prompt, divisible by the axis size
prompt = jnp.asarray(
    np.random.default_rng(0).integers(1, cfg.vocab_size, size=(1, s)), jnp.int32
)

out = generate_long(params, cfg, prompt, max_new_tokens=16, mesh=mesh)
print(f"ring-prefill over {p} devices, prompt len {s}")
print("generated:", [int(t) for t in np.asarray(out[0])])

ref = greedy_generate(params, cfg, prompt, 16)
print("single-dev:", [int(t) for t in np.asarray(ref[0])])
