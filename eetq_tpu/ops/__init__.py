"""Public op surface — the analogue of the reference's pybind module
(`csrc/eetpy.cpp:7-20`), which exposes: w8_a16_gemm, w8_a16_gemm_,
quant_weights, preprocess_weights, rotary_embedding_neox, layernorm_forward.

Here every op is a jitted JAX function:
  - w8a16_matmul       <- w8_a16_gemm / w8_a16_gemm_ (XLA owns buffers; no
                          separate in-place variant is needed)
  - quantize_weights   <- quant_weights
  - pack_weights       <- preprocess_weights
  - rope               <- rotary_embedding_neox
  - rmsnorm            <- layernorm_forward
"""

from eetq_tpu.ops.linear import w8a16_matmul
from eetq_tpu.ops.moe import w8a16_expert_matmul
from eetq_tpu.ops.linear8 import w8a8_matmul
from eetq_tpu.quant import symmetric_quantize as quantize_weights
from eetq_tpu.layout import pack_weights
from eetq_tpu.ops.rope import rope, make_cos_sin_cache
from eetq_tpu.ops.rmsnorm import rmsnorm
from eetq_tpu.ops.alibi import alibi_slopes

__all__ = [
    "w8a16_matmul",
    "w8a16_expert_matmul",
    "w8a8_matmul",
    "quantize_weights",
    "pack_weights",
    "rope",
    "make_cos_sin_cache",
    "rmsnorm",
    "alibi_slopes",
]
