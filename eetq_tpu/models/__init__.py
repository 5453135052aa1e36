from eetq_tpu.models.config import ModelConfig, PRESETS
from eetq_tpu.models.transformer import (
    LayerParams,
    ModelParams,
    forward,
    init_caches,
)
from eetq_tpu.models.init import (
    quantize_params,
    random_dense_params,
    random_quantized_params,
)

__all__ = [
    "ModelConfig",
    "PRESETS",
    "LayerParams",
    "ModelParams",
    "forward",
    "init_caches",
    "random_dense_params",
    "random_quantized_params",
    "quantize_params",
]
