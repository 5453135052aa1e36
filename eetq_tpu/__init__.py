"""eetq-tpu: W8A16 weight-only quantized inference engine for NVIDIA GPUs.

A from-scratch JAX/XLA re-design of the capabilities of NetEase-FuXi/EETQ
(reference: /root/reference). Per-channel symmetric INT8 weight-only PTQ, fused
dequant+matmul through XLA plus a weight-streaming decode GEMV kernel,
fused flash-attention decoder layers, one-line quantize-and-swap, HF-format
quantized checkpoints, and first-class tensor-parallel serving over GPU meshes.
"""

__version__ = "0.1.0"

from eetq_tpu.quant import symmetric_quantize, dequantize
from eetq_tpu.ops import w8a16_matmul


def __getattr__(name):
    # Lazy heavyweight imports (parity with `from eetq import
    # AutoEETQForCausalLM`, reference python/eetq/__init__.py) without
    # importing the whole model stack on package import.
    if name == "AutoEETQForCausalLM":
        from eetq_tpu.models.auto import AutoEETQForCausalLM

        return AutoEETQForCausalLM
    if name == "eet_quantize":
        from eetq_tpu.surgery.quantize import eet_quantize

        return eet_quantize
    if name == "eet_accelerator":
        from eetq_tpu.surgery.quantize import eet_accelerator

        return eet_accelerator
    raise AttributeError(f"module 'eetq_tpu' has no attribute {name!r}")


__all__ = [
    "symmetric_quantize",
    "dequantize",
    "w8a16_matmul",
    "AutoEETQForCausalLM",
    "eet_quantize",
    "eet_accelerator",
    "__version__",
]
