"""One-line quantize-and-swap, including over HuggingFace torch models.

The re-design of `eet_quantize` / `eet_accelerator`
(`python/eetq/utils/quantizer.py:40-61`, `utils/accelerator.py:15-19`): the
reference mutates an nn.Module tree in place (replace each nn.Linear with
W8A16Linear, free + empty_cache per layer); here the equivalents are

- `eet_quantize(params)`: pytree transform DenseLinear -> QuantLinear with
  exclusion patterns (lm_head excluded by default, like
  `utils/base.py:273-274`), and
- `eet_accelerator(torch_model_or_params, quantize=..., fused_attn=...)`:
  the one-liner — accepts either an eetq-tpu ModelParams or a HuggingFace
  PyTorch *ForCausalLM (converted layer by layer, CPU->device, bounding peak
  memory like `utils/quantizer.py:30-35`). "fused_attn" is implicit: the
  eetq-tpu architecture always runs the fused qkv + flash-attention layer.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

import jax.numpy as jnp

from eetq_tpu.models.config import ModelConfig
from eetq_tpu.models.transformer import ModelParams
from eetq_tpu.modules.linear import DenseLinear, QuantLinear, quantize_linear


def eet_quantize(
    params: ModelParams,
    bits: int = 8,
    group_size: int | None = None,
    exclude: tuple[str, ...] = ("lm_head",),
) -> ModelParams:
    """Quantize every DenseLinear in `params` to W8A16 (or W4A16 with
    bits=4, group-wise with group_size) except paths matching `exclude`
    regexes (matched against the pytree path string)."""
    import jax

    from eetq_tpu.modules.moe import MoEMLP, quantize_moe

    patterns = [re.compile(p) for p in exclude]

    def walk(path: str, obj: Any) -> Any:
        if isinstance(obj, MoEMLP):
            # router stays bf16 (its logits decide routing; quantizing it
            # risks flipped top-k picks for ~zero bytes saved); expert
            # banks quantize 3-D via quantize_moe
            if isinstance(obj.gateup, QuantLinear):
                return obj
            return quantize_moe(obj, bits=bits, group_size=group_size)
        if isinstance(obj, DenseLinear):
            if any(p.search(path) for p in patterns):
                return obj
            return quantize_linear(
                obj.weight.astype(jnp.float32), bias=obj.bias, bits=bits,
                group_size=group_size,
            )
        if isinstance(obj, QuantLinear):
            return obj
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            kw = {}
            for f in dataclasses.fields(obj):
                kw[f.name] = walk(f"{path}.{f.name}", getattr(obj, f.name))
            return dataclasses.replace(obj, **kw)
        if isinstance(obj, list):
            return [walk(f"{path}[{i}]", v) for i, v in enumerate(obj)]
        return obj

    return walk("", params)


def eet_accelerator(
    model,
    quantize: bool = True,
    fused_attn: bool = True,
    dev: str | None = None,
    bits: int = 8,
):
    """One-line accelerate: HF torch model or ModelParams in, eetq-tpu
    (cfg, params) out. Mirrors `eet_accelerator(model, quantize=True,
    fused_attn=True, dev="cuda:0")` (`utils/accelerator.py:15-19`)."""
    if isinstance(model, ModelParams):
        return eet_quantize(model, bits=bits) if quantize else model
    from eetq_tpu.models.hf import convert_torch_model

    return convert_torch_model(model, quantize=quantize, bits=bits)
