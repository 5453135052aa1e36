"""Kernel-level numerics + perf example — the analogue of the reference's
`examples/layers/test_w8a16_gemm.py` (M=1, N=13824, K=5120: the Llama-13B
MLP decode shape, 500-iteration timing loop).

Run from the repo root: python examples/layers/w8a16_matmul_example.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import time

import jax
import jax.numpy as jnp
import numpy as np

from eetq_tpu import backend
from eetq_tpu.layout import pack_weights
from eetq_tpu.ops import w8a16_matmul
from eetq_tpu.quant import symmetric_quantize

M, N, K = 1, 13824, 5120
ITERS = 500

rng = np.random.default_rng(0)
x = jnp.asarray(rng.standard_normal((M, K)).astype(np.float32), jnp.bfloat16)
w = rng.standard_normal((K, N)).astype(np.float32) / np.sqrt(K)

# quantize + pack offline (dual-path consistency: raw int8 and PackedWeight
# entries must agree — the reference's test_w8a16_gemm check)
q, scales = symmetric_quantize(jnp.asarray(w))
packed = pack_weights(q)
out_raw = w8a16_matmul(x, q, scales)
out_packed = w8a16_matmul(x, packed, scales)
assert (np.asarray(out_raw) == np.asarray(out_packed)).all()

# numerics vs the fp32 oracle
exact = np.asarray(x, np.float32) @ w
err = np.abs(np.asarray(out_packed, np.float32) - exact).mean()
print(f"mean abs err vs fp32 matmul: {err:.5f}")

# perf: ITERS chained calls inside one jitted loop (single dispatch).
# Meaningful on the GPU only. The 71 MB weight is larger than the H100's
# 50 MB L2, so the loop reads it from HBM every call.
if not backend.on_gpu():
    print("(skipping the timing loop off the GPU)")
    sys.exit(0)


@jax.jit
def loop(x):
    def body(i, c):
        out = w8a16_matmul(x + c * 1e-30, packed, scales)
        return out[0, 0]

    return jax.lax.fori_loop(0, ITERS, body, jnp.float32(0.0))

np.asarray(loop(x))  # compile
t0 = time.perf_counter()
np.asarray(loop(x))
dt = (time.perf_counter() - t0) / ITERS
gbs = K * N / dt / 1e9
print(f"{dt*1e6:.1f} us/call  ({gbs:.0f} GB/s weight streaming)")
