"""LoRA serving walkthrough: a quantized base model with LoRA side paths,
served by the continuous-batching engine, then merged-and-requantized.

This is the LoRAX use-case the reference's W8A16LoraLinear exists for
(`/root/reference/python/eetq/modules/qlinear.py:127-186`, README.md:96-101:
"LoRAX ... hosts eetq base weights with per-request adapters") plus the
merge-and-unload-then-quantize flow of the reference's LoRA example
(`/root/reference/examples/models/llama_transformers_example.py:164-197`):

  1. quantize the base model (W8A16, frozen);
  2. attach LoRA adapters (bf16 A/B, the only trainable leaves — training
     would run through the custom VJPs in ops/linear.py + the flash
     backward);
  3. serve the adapted model through the Engine — the side path rides the
     same prefill / windowed-decode programs;
  4. merge the adapters into the int8 weights (dequantize + fold +
     requantize) for full quantized-GEMM speed with no side path.

Runs on the CPU or an NVIDIA GPU.
"""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax
import jax.numpy as jnp
import numpy as np

from eetq_tpu.models import ModelConfig, quantize_params, random_dense_params
from eetq_tpu.serve import Engine
from eetq_tpu.surgery import attach_lora, merge_lora

cfg = ModelConfig(
    vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
    num_heads=8, num_kv_heads=4, head_dim=32, max_position=512,
)

# 1. frozen quantized base
base = quantize_params(
    random_dense_params(cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
)

# 2. adapters on qkv + o_proj (rank 8). B starts at zero (exact no-op);
#    stand in for "finetuned" weights with random B.
adapted = attach_lora(base, rank=8, key=jax.random.PRNGKey(1))
keys = iter(jax.random.split(jax.random.PRNGKey(2), 4 * cfg.num_layers))
adapted = dataclasses.replace(
    adapted,
    layers=[
        dataclasses.replace(
            lp,
            qkv_lora=dataclasses.replace(
                lp.qkv_lora,
                lora_b=0.1 * jax.random.normal(
                    next(keys), lp.qkv_lora.lora_b.shape, jnp.bfloat16
                ),
            ),
            o_lora=dataclasses.replace(
                lp.o_lora,
                lora_b=0.1 * jax.random.normal(
                    next(keys), lp.o_lora.lora_b.shape, jnp.bfloat16
                ),
            ),
        )
        for lp in adapted.layers
    ],
)

# 3. serve the adapted model
rng = np.random.default_rng(0)
eng = Engine(adapted, cfg, max_batch=2, max_len=128, prompt_buckets=(16,),
             decode_window=4)
prompts = [list(rng.integers(1, cfg.vocab_size, size=n)) for n in (5, 12)]
uids = [eng.add_request(p, 12) for p in prompts]
eng.run()
outs = [eng.result(u) for u in uids]
print("served with adapters:", outs)

# 4. merge-then-quantize: no side path, same behavior (up to requant error)
merged = merge_lora(adapted)
assert all(lp.qkv_lora is None for lp in merged.layers)
eng2 = Engine(merged, cfg, max_batch=2, max_len=128, prompt_buckets=(16,),
              decode_window=4)
uids2 = [eng2.add_request(p, 12) for p in prompts]
eng2.run()
outs2 = [eng2.result(u) for u in uids2]
print("served after merge:  ", outs2)

agree = np.mean([
    np.mean(np.asarray(a[:4]) == np.asarray(b[:4]))
    for a, b in zip(outs, outs2)
])
print(f"first-4-token agreement adapter vs merged: {agree:.0%}")

# 5. MULTI-adapter serving (the full LoRAX model): stack several adapted
#    copies of the same base into one bank; each request picks its adapter
#    by id. Adapter 0 below is the untouched no-op attach (base behavior).
from eetq_tpu.surgery import stack_adapters

noop = attach_lora(base, rank=8, key=jax.random.PRNGKey(3))
bank = stack_adapters([noop, adapted])
eng3 = Engine(bank, cfg, max_batch=2, max_len=128, prompt_buckets=(16,),
              decode_window=4)
u_base = eng3.add_request(prompts[0], 12, lora_id=0)
u_tuned = eng3.add_request(prompts[0], 12, lora_id=1)
eng3.run()
print("same prompt, adapter 0 (base):", eng3.result(u_base))
print("same prompt, adapter 1 (tuned):", eng3.result(u_tuned))
assert eng3.result(u_tuned) == outs[0], "bank adapter 1 == single-adapter run"
print("lora serving example OK")
