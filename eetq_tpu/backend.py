"""The one place the program asks which backend it runs on.

Every choice that depends on the device reads `on_gpu()`; nothing else in
the package compares backend names. The program runs on NVIDIA GPUs and,
for tests and debugging, on the CPU.
"""

from __future__ import annotations

import jax


def on_gpu() -> bool:
    """True when JAX's default backend is an NVIDIA GPU."""
    return jax.default_backend() == "gpu"


def attention_implementation() -> str:
    """`jax.nn.dot_product_attention` implementation for prefill: cuDNN's
    fused flash attention on the GPU, XLA's composition on the CPU."""
    return "cudnn" if on_gpu() else "xla"


def default_decode_window() -> int:
    """Decode steps the engine runs per host round trip. A multi-step
    window saves a host round trip per token on the GPU; the CPU keeps one
    step per round trip so tests see every scheduler step."""
    return 8 if on_gpu() else 1


def use_gemv_kernel(m: int) -> bool:
    """Whether an m-row int8 per-channel projection takes the decode GEMV
    kernel (eetq_tpu.kernels.gemv): on the GPU, for at most MAX_M rows."""
    from eetq_tpu.kernels.gemv import MAX_M

    return on_gpu() and m <= MAX_M
