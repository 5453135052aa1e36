"""`AutoEETQForCausalLM` — the user-facing model API.

Parity with the reference's L4 (`python/eetq/models/auto.py`,
`models/base.py`): auto-dispatch on config.model_type, from_pretrained ->
quantize -> save_quantized -> from_quantized (the last fully implemented,
unlike the reference's stub). Generation is owned by eetq_tpu.serve (the
reference delegates to HF transformers.generate).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from eetq_tpu.models.config import ModelConfig
from eetq_tpu.models.hf import (
    _family,
    convert_torch_model,
    load_config,
    load_hf_dense,
    load_quantized,
    save_quantized,
)
from eetq_tpu.models.transformer import ModelParams, forward, init_caches
from eetq_tpu.surgery.quantize import eet_quantize
from eetq_tpu.utils.logging import get_logger

log = get_logger(__name__)

# model_type -> supported (the reference's EETQ_CAUSAL_LM_MODEL_MAP,
# auto.py:6-10, plus mistral/chatglm — the reference's chatglm fuser is
# WIP/unregistered; here the family is fully implemented — and
# mixtral, the routed-MoE runtime the reference's 3-D "num_experts"
# quantization infrastructure never got (`fpA_intB_gemm_wrapper.cu:44-66`,
# num_experts=1 hardcoded in the runner))
SUPPORTED_MODEL_TYPES = (
    "llama", "mistral", "mixtral", "gemma", "baichuan", "qwen2", "chatglm"
)


@dataclasses.dataclass
class EETQCausalLM:
    """A (config, params) pair with the one-line workflow methods."""

    cfg: ModelConfig
    params: ModelParams
    hf_config: dict | None = None

    @property
    def quantized(self) -> bool:
        from eetq_tpu.modules.linear import QuantLinear

        return isinstance(self.params.layers[0].qkv, QuantLinear)

    def quantize(
        self,
        save_dir: str | None = None,
        bits: int = 8,
        tp: int = 1,
        group_size: int | None = None,
        quantize_lm_head: bool = False,
    ) -> "EETQCausalLM":
        """Quantize in place (fused-projection W8A16/W4A16) and optionally
        save. tp > 1 mirrors the reference's `quantize(save_dir, tp)`
        (`models/base.py:74-102`): row-parallel layers are quantized with
        per-rank K-slice scales (= group_size K/tp) so a later tp-way
        reshard is bit-exact — and unlike the reference's merged module,
        the artifact still serves single-chip (group-wise kernel)."""
        self._tp = tp
        if not self.quantized:
            if tp > 1:
                if group_size is not None:
                    raise ValueError("pass either tp or group_size, not both")
                if any(lp.moe is not None for lp in self.params.layers):
                    raise NotImplementedError(
                        "quantize(tp>1) offline reshard doesn't support MoE "
                        "layers; quantize with tp=1 and shard at runtime "
                        "(EP via .shard())"
                    )
                from eetq_tpu.surgery.tp_reshard import quantize_params_tp

                self.params = quantize_params_tp(
                    self.params, self.cfg, tp=tp, bits=bits
                )
            else:
                self.params = eet_quantize(
                    self.params, bits=bits, group_size=group_size,
                    exclude=() if quantize_lm_head else ("lm_head",),
                )
        if save_dir is not None:
            self.save_quantized(save_dir)
        return self

    def save_quantized(self, save_dir: str) -> None:
        if not self.quantized:
            raise ValueError("call quantize() first")
        save_quantized(
            self.params, self.cfg, save_dir, hf_config=self.hf_config,
            tp=getattr(self, "_tp", 1),
        )

    def forward(self, tokens, positions, caches=None, offset=0):
        return forward(self.params, self.cfg, tokens, positions, caches,
                       jnp.int32(offset))

    def generate(self, prompt, max_new_tokens: int, **kw):
        from eetq_tpu.serve import generate

        return generate(self.params, self.cfg, prompt, max_new_tokens, **kw)

    def init_caches(self, batch: int, max_len: int, dtype=jnp.bfloat16):
        return init_caches(self.cfg, batch, max_len, dtype)

    def shard(self, mesh=None, tp: int | None = None, dp: int = 1):
        """Shard over a device mesh for runtime tensor parallelism.

        Dense params: split, quantize per shard, place (shard_model).
        Quantized params (e.g. loaded via from_quantized from a
        `quantize(tp=N)` checkpoint): lossless slicing without
        requantization (shard_quantized) — bit-exact when the checkpoint
        tp matches the mesh tp."""
        from eetq_tpu.dist import make_mesh, shard_model

        if mesh is None:
            tp = tp or len(jax.devices()) // dp
            mesh = make_mesh(tp=tp, dp=dp)
        if self.quantized:
            from eetq_tpu.surgery.tp_reshard import shard_quantized

            return shard_quantized(self.params, self.cfg, mesh)
        return shard_model(self.params, self.cfg, mesh, quantize=True)


def resolve_checkpoint(path_or_id: str, **download_kwargs) -> str:
    """Resolve a local directory or a HuggingFace Hub model id to a local
    checkpoint directory (the reference's `snapshot_download` resolution,
    `models/base.py:210-256`). Hub ids require network access — in
    air-gapped deployments pass a local path (or a pre-populated
    HF_HUB_CACHE). NOTE: the hub path is implemented but untested in this
    repo's CI (zero-egress environment)."""
    import os

    if os.path.isdir(path_or_id):
        return path_or_id
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:
        raise FileNotFoundError(
            f"{path_or_id} is not a local directory and huggingface_hub is "
            f"unavailable for hub download"
        ) from e
    return snapshot_download(
        path_or_id,
        allow_patterns=["*.json", "*.safetensors", "*.model", "*.txt"],
        **download_kwargs,
    )


class AutoEETQForCausalLM:
    """Entry point: checks config.model_type and builds the model
    (reference `auto.py:12-32` check_and_get_model_type + dispatch).
    `path` may be a local checkpoint directory or a HF Hub model id
    (resolved via snapshot_download, like `models/base.py:210-256`)."""

    @classmethod
    def from_pretrained(
        cls, path: str, dtype=jnp.bfloat16, quantize: bool = False,
        **download_kwargs,
    ) -> EETQCausalLM:
        path = resolve_checkpoint(path, **download_kwargs)
        cfg, hf = load_config(path)
        _check_supported(cfg)
        cfg2, params = load_hf_dense(path, dtype=dtype)
        model = EETQCausalLM(cfg=cfg2, params=params, hf_config=hf)
        if quantize:
            model.quantize()
        return model

    @classmethod
    def from_quantized(cls, path: str, dtype=jnp.bfloat16,
                       **download_kwargs) -> EETQCausalLM:
        path = resolve_checkpoint(path, **download_kwargs)
        cfg, hf = load_config(path)
        _check_supported(cfg)
        cfg2, params = load_quantized(path, dtype=dtype)
        return EETQCausalLM(cfg=cfg2, params=params, hf_config=hf)

    @classmethod
    def from_torch(cls, torch_model, quantize: bool = True) -> EETQCausalLM:
        cfg, params = convert_torch_model(torch_model, quantize=quantize)
        _check_supported(cfg)
        return EETQCausalLM(
            cfg=cfg, params=params, hf_config=torch_model.config.to_dict()
        )


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.model_type not in SUPPORTED_MODEL_TYPES:
        raise ValueError(
            f"model_type {cfg.model_type!r} isn't supported yet; "
            f"supported: {SUPPORTED_MODEL_TYPES}"
        )
    _family(cfg.model_type)
