"""Continuous-batching serving walkthrough: the engine features the
reference delegates to TGI/LoRAX (`README.md:88-96`).

Runs on the CPU or an NVIDIA GPU. Shows:
  - slot-based continuous batching with staggered arrivals,
  - the multi-step greedy decode window (amortizes host round-trips),
  - chunked prefill (long prompts don't stall running decode slots),
  - the paged KV cache (shared block pool; memory follows live tokens).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax
import jax.numpy as jnp
import numpy as np

from eetq_tpu.models import ModelConfig, quantize_params, random_dense_params
from eetq_tpu.serve import Engine

cfg = ModelConfig(
    vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
    num_heads=8, num_kv_heads=4, head_dim=32, max_position=1024,
)
params = quantize_params(
    random_dense_params(cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
)
rng = np.random.default_rng(0)

eng = Engine(
    params, cfg,
    max_batch=4,
    max_len=512,
    prompt_buckets=(32, 128),
    decode_window=4,        # 4 greedy tokens per host round-trip
    prefill_chunk=32,       # long prompts prefill 32 tokens per step
    paged_blocks=17,        # 16 usable 128-token blocks + trash block
    paged_block_size=128,
)

# a batch up front...
uids = [
    eng.add_request(list(rng.integers(1, cfg.vocab_size, size=n)), 24)
    for n in (5, 80, 20)
]
# ...and a long-prompt request arriving mid-flight
for _ in range(3):
    eng.step()
uids.append(eng.add_request(list(rng.integers(1, cfg.vocab_size, size=120)), 24))

eng.run()
for u in uids:
    toks = eng.result(u)
    print(f"request {u}: {len(toks)} tokens -> {toks[:10]}...")
print("engine drained; paged blocks all returned:",
      len(eng._free_blocks) == 16)
