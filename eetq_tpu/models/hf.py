"""HuggingFace checkpoint interop: load fp16 checkpoints, convert live torch
models, save/load W8A16 quantized checkpoints in the transformers-eetq
format.

Capability parity with the reference's L4 (`models/base.py:108-256`,
`models/auto.py`), with two deliberate upgrades (SURVEY.md §5 checkpoints):
- the saved qweight is the UNPACKED [out, in] int8 + fp16 [out] scales per
  projection — exactly what `transformers` expects for
  `quantization_config={"quant_method": "eetq"}` — so checkpoints are
  portable across devices and kernel layout versions (the reference
  saves its SM-arch-specific interleaved buffer, coupling checkpoints to the
  GPU they were made on);
- `from_quantized` is fully implemented (the reference left it a stub,
  `models/auto.py:34-38`, `models/base.py:258-289`).
"""

from __future__ import annotations

import json
import os
import re

import jax.numpy as jnp
import numpy as np

from eetq_tpu.models.config import ModelConfig
from eetq_tpu.models.safetensors_np import safe_open, save_file
from eetq_tpu.models.transformer import LayerParams, ModelParams
from eetq_tpu.modules.linear import DenseLinear, QuantLinear, quantize_linear
from eetq_tpu.layout import pack_weights, unpack_weights
from eetq_tpu.surgery.fusion import split_quant_columns
from eetq_tpu.utils.logging import get_logger

log = get_logger(__name__)

# Weight-name scheme per model family. Baichuan ships a pre-fused qkv
# ("W_pack", rows q|k|v), which transposes directly into our fused layout;
# chatglm2/3 fuses BOTH qkv ("query_key_value", rows q|k|v with MQA-sized
# k/v) and gate/up ("dense_h_to_4h", rows gate|up — its swiglu chunks in
# the same order) and roots everything under "transformer.encoder"
# (the layout the reference's WIP ChatGLMFuser walks,
# `python/eetq/models/chatglm.py:41-83`). Families without explicit name
# keys use the llama scheme.
_LLAMA_NAMES = dict(
    layer="model.layers.{i}",
    attn="self_attn",
    o="o_proj",
    gateup=("mlp.gate_proj", "mlp.up_proj"),
    down="mlp.down_proj",
    embed="model.embed_tokens.weight",
    final_norm="model.norm.weight",
    lm_head="lm_head.weight",
)
_FAMILY = {
    "llama": dict(qkv=("q_proj", "k_proj", "v_proj")),
    "mistral": dict(qkv=("q_proj", "k_proj", "v_proj")),
    # mixtral: llama attention + routed MoE MLP. The MLP weights live under
    # block_sparse_moe: gate = the [E, H] router, experts.{j}.w1/w3 = the
    # j-th expert's gate/up projections (fused into our stacked [E, H, 2I]
    # bank), w2 = down ([E, I, H]).
    "mixtral": dict(
        qkv=("q_proj", "k_proj", "v_proj"),
        moe_router="block_sparse_moe.gate",
        moe_expert="block_sparse_moe.experts.{j}",
    ),
    "gemma": dict(qkv=("q_proj", "k_proj", "v_proj")),
    "baichuan": dict(qkv=("W_pack",)),
    "qwen2": dict(qkv=("q_proj", "k_proj", "v_proj")),  # with qkv biases
    "chatglm": dict(
        qkv=("query_key_value",),
        layer="transformer.encoder.layers.{i}",
        attn="self_attention",
        o="dense",
        gateup=("mlp.dense_h_to_4h",),
        down="mlp.dense_4h_to_h",
        embed="transformer.embedding.word_embeddings.weight",
        final_norm="transformer.encoder.final_layernorm.weight",
        lm_head="transformer.output_layer.weight",
    ),
}


def _family(model_type: str) -> dict:
    if model_type not in _FAMILY:
        raise ValueError(
            f"unsupported model_type {model_type!r}; supported: {list(_FAMILY)}"
        )
    return {**_LLAMA_NAMES, **_FAMILY[model_type]}


class _TensorSource:
    """Uniform name->numpy access over a safetensors dir or a torch
    state_dict."""

    def __init__(self, get, names):
        self.get = get
        self.names = set(names)

    def __contains__(self, name):
        return name in self.names

    def __call__(self, name) -> np.ndarray:
        if name not in self.names:
            raise KeyError(name)
        return self.get(name)


def _source_from_dir(path: str) -> _TensorSource:
    idx_file = os.path.join(path, "model.safetensors.index.json")
    if os.path.exists(idx_file):
        with open(idx_file) as f:
            weight_map = json.load(f)["weight_map"]
        return _TensorSource(
            _one_handle_getter(path, weight_map), weight_map.keys()
        )
    st_files = [f for f in os.listdir(path) if f.endswith(".safetensors")]
    if not st_files:
        raise FileNotFoundError(f"no .safetensors files in {path}")
    names = {}
    for f in st_files:
        with safe_open(os.path.join(path, f)) as h:
            for n in h.keys():
                names[n] = f
    return _TensorSource(_one_handle_getter(path, names), names.keys())


def _one_handle_getter(path: str, weight_map: dict):
    """name -> array getter keeping ONE shard handle open at a time (reads
    cluster per file; avoids an fd per shard for the loader's lifetime)."""
    current: dict = {}

    def get(name):
        fn = os.path.join(path, weight_map[name])
        if current.get("fn") != fn:
            if "h" in current:
                current["h"].__exit__(None, None, None)
            current["fn"] = fn
            current["h"] = safe_open(fn)
        return current["h"].get_tensor(name)

    return get


def _source_from_torch(model) -> _TensorSource:
    sd = model.state_dict()

    def get(name):
        t = sd[name]
        if t.dtype.is_floating_point:
            return t.detach().to("cpu").float().numpy()
        return t.detach().to("cpu").numpy()

    return _TensorSource(get, sd.keys())


def _to_linear(w_t: np.ndarray, quantize: bool, bits: int, dtype,
               bias: np.ndarray | None = None):
    """torch [out, in] -> our [in, out]; optionally quantize.

    Quantization runs on the HOST (native C++ quantizer, numpy fallback —
    eetq_tpu.native) so the dense fp16/fp32 weight never touches device
    HBM: only the int8 buffer and scales are transferred (the reference
    keeps its quantizer on CPU for the same reason, SURVEY.md §3.1
    GPU->CPU boundary)."""
    b = None if bias is None else jnp.asarray(bias, dtype)
    if quantize:
        from eetq_tpu.native import host_symmetric_quantize

        q, s = host_symmetric_quantize(np.ascontiguousarray(w_t.T), bits=bits)
        return QuantLinear(
            qweight=pack_weights(jnp.asarray(q), bits=bits),
            scales=jnp.asarray(s, jnp.float32),
            bias=b,
        )
    w = jnp.asarray(np.ascontiguousarray(w_t.T))
    return DenseLinear(weight=w.astype(dtype), bias=b)


def _to_moe(src, pfx: str, fam: dict, cfg: ModelConfig, quantize: bool,
            bits: int, dtype):
    """Assemble a stacked-expert MoEMLP from HF mixtral weights: per-expert
    w1/w3 fuse into the [E, H, 2I] gateup bank, w2 transposes into the
    [E, I, H] down bank, gate becomes the [H, E] router (kept bf16)."""
    from eetq_tpu.modules.moe import MoEMLP

    e = cfg.num_experts
    router_t = src(f"{pfx}.{fam['moe_router']}.weight")  # [E, H]
    router = DenseLinear(
        weight=jnp.asarray(np.ascontiguousarray(router_t.T), dtype)
    )
    gu = np.stack([
        np.concatenate(
            [
                src(f"{pfx}.{fam['moe_expert'].format(j=j)}.w1.weight"),
                src(f"{pfx}.{fam['moe_expert'].format(j=j)}.w3.weight"),
            ],
            axis=0,
        ).T  # [H, 2I]
        for j in range(e)
    ])
    dn = np.stack([
        src(f"{pfx}.{fam['moe_expert'].format(j=j)}.w2.weight").T  # [I, H]
        for j in range(e)
    ])

    def mk(bank):
        if quantize:
            from eetq_tpu.native import host_symmetric_quantize

            q, s = host_symmetric_quantize(np.ascontiguousarray(bank), bits=bits)
            return QuantLinear(
                qweight=pack_weights(jnp.asarray(q), bits=bits),
                scales=jnp.asarray(s, jnp.float32),
            )
        return DenseLinear(weight=jnp.asarray(bank).astype(dtype))

    return MoEMLP(router=router, gateup=mk(gu), down=mk(dn))


def _build_params(
    src: _TensorSource,
    cfg: ModelConfig,
    quantize: bool,
    bits: int = 8,
    dtype=jnp.bfloat16,
) -> ModelParams:
    fam = _family(cfg.model_type)
    layers = []
    for i in range(cfg.num_layers):
        pfx = fam["layer"].format(i=i)
        attn = f"{pfx}.{fam['attn']}"

        def cat_wb(names):
            """Stack (concat rows of) one or more [out, in] projections;
            returns (weight, bias|None). A single name = pre-fused
            (baichuan W_pack / chatglm query_key_value & dense_h_to_4h)."""
            w = np.concatenate([src(f"{n}.weight") for n in names], axis=0) \
                if len(names) > 1 else src(f"{names[0]}.weight")
            bias = None
            if f"{names[0]}.bias" in src:
                bias = (
                    np.concatenate([src(f"{n}.bias") for n in names])
                    if len(names) > 1 else src(f"{names[0]}.bias")
                )
            return w, bias

        qkv_t, qkv_bias = cat_wb([f"{attn}.{p}" for p in fam["qkv"]])

        def opt_bias(name):  # attention_bias=True also puts one on o_proj;
            return src(name) if name in src else None  # mlp_bias covers mlp

        o_name = f"{attn}.{fam['o']}"
        if cfg.num_experts:
            moe = _to_moe(src, pfx, fam, cfg, quantize, bits, dtype)
            gateup = down = None
        else:
            moe = None
            gateup_t, gu_bias = cat_wb([f"{pfx}.{p}" for p in fam["gateup"]])
            down_name = f"{pfx}.{fam['down']}"
            gateup = _to_linear(gateup_t, quantize, bits, dtype, bias=gu_bias)
            down = _to_linear(src(f"{down_name}.weight"), quantize, bits,
                              dtype, bias=opt_bias(f"{down_name}.bias"))
        layers.append(
            LayerParams(
                input_norm=jnp.asarray(
                    src(f"{pfx}.input_layernorm.weight"), jnp.float32
                ),
                qkv=_to_linear(qkv_t, quantize, bits, dtype, bias=qkv_bias),
                o_proj=_to_linear(src(f"{o_name}.weight"), quantize, bits,
                                  dtype, bias=opt_bias(f"{o_name}.bias")),
                post_norm=jnp.asarray(
                    src(f"{pfx}.post_attention_layernorm.weight"), jnp.float32
                ),
                gateup=gateup,
                down=down,
                moe=moe,
            )
        )
        log.debug("loaded layer %d/%d", i + 1, cfg.num_layers)
    embed = jnp.asarray(src(fam["embed"]), dtype)  # [V, H]
    lm_head = None
    if not cfg.tie_word_embeddings and fam["lm_head"] in src:
        # lm_head stays dense (reference excludes it from quantization)
        lm_head = DenseLinear(
            weight=jnp.asarray(src(fam["lm_head"]).T.copy(), dtype)
        )
    final_norm = jnp.asarray(src(fam["final_norm"]), jnp.float32)
    return ModelParams(embed=embed, layers=layers, final_norm=final_norm, lm_head=lm_head)


def load_config(path: str) -> tuple[ModelConfig, dict]:
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    return ModelConfig.from_hf_config(hf), hf


def load_hf_dense(path: str, dtype=jnp.bfloat16) -> tuple[ModelConfig, ModelParams]:
    """Load an fp16/bf16 HF checkpoint directory into dense params."""
    cfg, _ = load_config(path)
    src = _source_from_dir(path)
    return cfg, _build_params(src, cfg, quantize=False, dtype=dtype)


def convert_torch_model(
    model, quantize: bool = True, bits: int = 8, dtype=jnp.bfloat16
) -> tuple[ModelConfig, ModelParams]:
    """Convert a live HF PyTorch *ForCausalLM (quantizing layer by layer —
    peak memory is one dense layer, like the reference's per-layer swap)."""
    cfg = ModelConfig.from_hf_config(model.config.to_dict())
    src = _source_from_torch(model)
    return cfg, _build_params(src, cfg, quantize=quantize, bits=bits, dtype=dtype)


# ---- quantized checkpoint save/load (transformers-eetq format) ----


def _unfuse_layer(lp: LayerParams, cfg: ModelConfig) -> dict[str, QuantLinear]:
    """Split fused qkv/gateup back to per-projection quantized linears
    (bit-exact along N). Dict keys are the HF projection names."""
    fam = _family(cfg.model_type)
    d = {}
    if lp.moe is not None:
        # expert banks are handled by save_quantized's put_moe
        if len(fam["qkv"]) == 3:
            nq = cfg.num_heads * cfg.head_dim
            nkv = cfg.num_kv_heads * cfg.head_dim
            for name, ql in zip(
                fam["qkv"], split_quant_columns(lp.qkv, [nq, nkv, nkv])
            ):
                d[f"{fam['attn']}.{name}"] = ql
        else:
            d[f"{fam['attn']}.{fam['qkv'][0]}"] = lp.qkv
        d[f"{fam['attn']}.{fam['o']}"] = lp.o_proj
        return d
    if len(fam["qkv"]) == 3:
        nq = cfg.num_heads * cfg.head_dim
        nkv = cfg.num_kv_heads * cfg.head_dim
        for name, ql in zip(
            fam["qkv"], split_quant_columns(lp.qkv, [nq, nkv, nkv])
        ):
            d[f"{fam['attn']}.{name}"] = ql
    else:  # pre-fused in the HF layout (W_pack / query_key_value)
        d[f"{fam['attn']}.{fam['qkv'][0]}"] = lp.qkv
    d[f"{fam['attn']}.{fam['o']}"] = lp.o_proj
    if len(fam["gateup"]) == 2:
        gate, up = split_quant_columns(lp.gateup, [cfg.intermediate_size] * 2)
        d[fam["gateup"][0]] = gate
        d[fam["gateup"][1]] = up
    else:  # chatglm dense_h_to_4h stays fused (rows gate|up)
        d[fam["gateup"][0]] = lp.gateup
    d[fam["down"]] = lp.down
    return d


def save_quantized(
    params: ModelParams,
    cfg: ModelConfig,
    save_dir: str,
    hf_config: dict | None = None,
    max_shard_bytes: int = 4 * 1024**3,
    tp: int = 1,
) -> None:
    """Write an HF-format quantized checkpoint: config.json with
    quantization_config (reference `models/base.py:108-146`) + sharded
    safetensors of UNPACKED int8 weights [out, in] and fp16 scales.

    Scales: per-channel layers store [out]; group-wise layers (including
    offline-TP-resharded row-parallel ones, reference merge convention
    `utils/base.py:237-250`) store the per-group rows CONCATENATED to
    [G*out] — the loader reconstructs G from the length. `tp` is recorded
    in quantization_config for provenance."""
    os.makedirs(save_dir, exist_ok=True)
    tensors: dict[str, np.ndarray] = {}

    def put_quant(name: str, ql: QuantLinear):
        q = np.asarray(unpack_weights(ql.qweight)).T  # [out, in] int8
        tensors[f"{name}.weight"] = np.ascontiguousarray(q)
        tensors[f"{name}.weight_scales"] = np.asarray(
            ql.scales, dtype=np.float16
        ).reshape(-1)
        if ql.bias is not None:
            tensors[f"{name}.bias"] = np.asarray(ql.bias, np.float16)

    fam = _family(cfg.model_type)

    def put_moe(pfx: str, moe) -> None:
        """Per-expert w1/w3/w2 int8 [out, in] + scales (HF mixtral names),
        router as fp16 — the portable unpacked form of the 3-D banks."""
        tensors[f"{pfx}.{fam['moe_router']}.weight"] = np.ascontiguousarray(
            np.asarray(moe.router.weight, np.float16).T
        )
        qgu = np.asarray(unpack_weights(moe.gateup.qweight))  # [E, H, 2I]
        qdn = np.asarray(unpack_weights(moe.down.qweight))  # [E, I, H]
        sgu = np.asarray(moe.gateup.scales, np.float16)
        sdn = np.asarray(moe.down.scales, np.float16)
        isz = qgu.shape[-1] // 2
        for j in range(qgu.shape[0]):
            ex = f"{pfx}.{fam['moe_expert'].format(j=j)}"
            tensors[f"{ex}.w1.weight"] = np.ascontiguousarray(qgu[j, :, :isz].T)
            tensors[f"{ex}.w1.weight_scales"] = sgu[j, ..., :isz].reshape(-1)
            tensors[f"{ex}.w3.weight"] = np.ascontiguousarray(qgu[j, :, isz:].T)
            tensors[f"{ex}.w3.weight_scales"] = sgu[j, ..., isz:].reshape(-1)
            tensors[f"{ex}.w2.weight"] = np.ascontiguousarray(qdn[j].T)
            tensors[f"{ex}.w2.weight_scales"] = sdn[j].reshape(-1)

    for i, lp in enumerate(params.layers):
        pfx = fam["layer"].format(i=i)
        for proj, ql in _unfuse_layer(lp, cfg).items():
            put_quant(f"{pfx}.{proj}", ql)
        if lp.moe is not None:
            put_moe(pfx, lp.moe)
        tensors[f"{pfx}.input_layernorm.weight"] = np.asarray(lp.input_norm, np.float16)
        tensors[f"{pfx}.post_attention_layernorm.weight"] = np.asarray(
            lp.post_norm, np.float16
        )
    tensors[fam["embed"]] = np.asarray(params.embed, np.float16)
    tensors[fam["final_norm"]] = np.asarray(params.final_norm, np.float16)
    if params.lm_head is not None:
        head_name = fam["lm_head"][: -len(".weight")]
        if isinstance(params.lm_head, QuantLinear):  # quantize_lm_head=True
            put_quant(head_name, params.lm_head)
        else:
            tensors[fam["lm_head"]] = np.ascontiguousarray(
                np.asarray(params.lm_head.weight, np.float16).T
            )

    # shard by size with an index, like save_torch_state_dict
    shards: list[dict] = [{}]
    sizes = [0]
    for name, arr in tensors.items():
        if sizes[-1] + arr.nbytes > max_shard_bytes and shards[-1]:
            shards.append({})
            sizes.append(0)
        shards[-1][name] = arr
        sizes[-1] += arr.nbytes
    if len(shards) == 1:
        save_file(shards[0], os.path.join(save_dir, "model.safetensors"))
    else:
        weight_map = {}
        for j, shard in enumerate(shards):
            fn = f"model-{j + 1:05d}-of-{len(shards):05d}.safetensors"
            save_file(shard, os.path.join(save_dir, fn))
            for n in shard:
                weight_map[n] = fn
        with open(os.path.join(save_dir, "model.safetensors.index.json"), "w") as f:
            json.dump(
                {"metadata": {"total_size": sum(sizes)}, "weight_map": weight_map}, f
            )

    bits = 8
    for lp in params.layers:
        if isinstance(lp.qkv, QuantLinear):
            bits = lp.qkv.qweight.bits
            break
    quant_cfg = {"quant_method": "eetq", "zero_point": False, "bits": bits,
                 "tp": tp}
    hf = dict(hf_config or {})
    hf.setdefault("model_type", cfg.model_type)
    if cfg.model_type == "chatglm":
        # chatglm config key names (so the roundtrip through
        # from_hf_config's chatglm branch reconstructs the same cfg)
        hf.setdefault("padded_vocab_size", cfg.vocab_size)
        hf.setdefault("hidden_size", cfg.hidden_size)
        hf.setdefault("ffn_hidden_size", cfg.intermediate_size)
        hf.setdefault("num_layers", cfg.num_layers)
        hf.setdefault("num_attention_heads", cfg.num_heads)
        hf.setdefault("multi_query_attention",
                      cfg.num_kv_heads != cfg.num_heads)
        hf.setdefault("multi_query_group_num", cfg.num_kv_heads)
        hf.setdefault("kv_channels", cfg.head_dim)
        hf.setdefault("seq_length", cfg.max_position)
        hf.setdefault("rope_ratio", cfg.rope_theta / 10000.0)
        hf.setdefault("layernorm_epsilon", cfg.rms_eps)
        hf.setdefault("add_qkv_bias", cfg.qkv_bias)
        hf.setdefault("tie_word_embeddings", cfg.tie_word_embeddings)
    else:
        hf.setdefault("vocab_size", cfg.vocab_size)
        hf.setdefault("hidden_size", cfg.hidden_size)
        hf.setdefault("intermediate_size", cfg.intermediate_size)
        hf.setdefault("num_hidden_layers", cfg.num_layers)
        hf.setdefault("num_attention_heads", cfg.num_heads)
        hf.setdefault("num_key_value_heads", cfg.num_kv_heads)
        hf.setdefault("head_dim", cfg.head_dim)
        hf.setdefault("max_position_embeddings", cfg.max_position)
        hf.setdefault("rope_theta", cfg.rope_theta)
        hf.setdefault("rms_norm_eps", cfg.rms_eps)
        hf.setdefault("hidden_act", cfg.activation)
        hf.setdefault("tie_word_embeddings", cfg.tie_word_embeddings)
        if cfg.sliding_window:
            hf.setdefault("sliding_window", cfg.sliding_window)
        if cfg.num_experts:
            hf.setdefault("num_local_experts", cfg.num_experts)
            hf.setdefault("num_experts_per_tok", cfg.num_experts_per_tok)
    hf["quantization_config"] = quant_cfg
    with open(os.path.join(save_dir, "config.json"), "w") as f:
        json.dump(hf, f, indent=2)
    # legacy side file, like the reference's EETQConfig (models/_config.py)
    with open(os.path.join(save_dir, "quant_config.json"), "w") as f:
        json.dump(quant_cfg, f, indent=2)
    log.info("saved quantized checkpoint to %s (%d shards)", save_dir, len(shards))


def load_quantized(path: str, dtype=jnp.bfloat16) -> tuple[ModelConfig, ModelParams]:
    """Load a quantized checkpoint saved by `save_quantized` (or by
    transformers with quant_method="eetq"). Completes the reference's
    `from_quantized` stub."""
    cfg, hf = load_config(path)
    qc = hf.get("quantization_config")
    if not qc or qc.get("quant_method") != "eetq":
        raise ValueError(f"{path} is not an eetq quantized checkpoint: {qc}")
    bits = int(qc.get("bits", 8))
    src = _source_from_dir(path)
    fam = _family(cfg.model_type)

    def get_quant(name: str) -> QuantLinear:
        q = src(f"{name}.weight")  # [out, in] int8
        scales = src(f"{name}.weight_scales").reshape(-1)
        out_dim = q.shape[0]
        if scales.size != out_dim:
            # group-wise rows stored concatenated (see save_quantized)
            scales = scales.reshape(scales.size // out_dim, out_dim)
        bias = None
        if f"{name}.bias" in src:
            bias = jnp.asarray(src(f"{name}.bias"), dtype)
        return QuantLinear(
            qweight=pack_weights(
                jnp.asarray(np.ascontiguousarray(q.T)), bits=bits
            ),
            scales=jnp.asarray(scales, jnp.float32),
            bias=bias,
        )

    def fuse_quant(qls: list[QuantLinear]) -> QuantLinear:
        qs = [unpack_weights(q.qweight) for q in qls]
        biases = [q.bias for q in qls]
        bias = None
        if any(b is not None for b in biases):
            bias = jnp.concatenate(
                [
                    b if b is not None else jnp.zeros((q.out_features,), dtype)
                    for b, q in zip(biases, qls)
                ]
            )
        return QuantLinear(
            qweight=pack_weights(jnp.concatenate(qs, axis=-1), bits=bits),
            scales=jnp.concatenate([q.scales for q in qls], axis=-1),
            bias=bias,
        )

    def get_moe(pfx: str):
        """Reassemble the stacked 3-D expert banks from per-expert w1/w3/w2
        (inverse of save_quantized's put_moe)."""
        from eetq_tpu.modules.moe import MoEMLP

        router = DenseLinear(
            weight=jnp.asarray(
                src(f"{pfx}.{fam['moe_router']}.weight").T.copy(), dtype
            )
        )

        def raw(name):
            q = src(f"{name}.weight")  # [out, in] int8
            s = src(f"{name}.weight_scales").reshape(-1)
            out_dim = q.shape[0]
            if s.size != out_dim:
                s = s.reshape(s.size // out_dim, out_dim)
            return np.ascontiguousarray(q.T), s  # logical [in, out]

        gus, gss, dns, dss = [], [], [], []
        for j in range(cfg.num_experts):
            ex = f"{pfx}.{fam['moe_expert'].format(j=j)}"
            w1, s1 = raw(f"{ex}.w1")
            w3, s3 = raw(f"{ex}.w3")
            w2, s2 = raw(f"{ex}.w2")
            gus.append(np.concatenate([w1, w3], axis=-1))  # [H, 2I]
            gss.append(np.concatenate([s1, s3], axis=-1))
            dns.append(w2)
            dss.append(s2)

        def bank(qs, ss):
            return QuantLinear(
                qweight=pack_weights(jnp.asarray(np.stack(qs)), bits=bits),
                scales=jnp.asarray(np.stack(ss), jnp.float32),
            )

        return MoEMLP(router=router, gateup=bank(gus, gss),
                      down=bank(dns, dss))

    layers = []
    for i in range(cfg.num_layers):
        pfx = fam["layer"].format(i=i)
        attn = f"{pfx}.{fam['attn']}"
        if len(fam["qkv"]) == 3:
            qkv = fuse_quant([get_quant(f"{attn}.{p}") for p in fam["qkv"]])
        else:
            qkv = get_quant(f"{attn}.{fam['qkv'][0]}")
        moe = None
        gateup = down = None
        if cfg.num_experts:
            moe = get_moe(pfx)
        elif len(fam["gateup"]) == 2:
            gateup = fuse_quant(
                [get_quant(f"{pfx}.{p}") for p in fam["gateup"]]
            )
            down = get_quant(f"{pfx}.{fam['down']}")
        else:
            gateup = get_quant(f"{pfx}.{fam['gateup'][0]}")
            down = get_quant(f"{pfx}.{fam['down']}")
        layers.append(
            LayerParams(
                input_norm=jnp.asarray(src(f"{pfx}.input_layernorm.weight"), jnp.float32),
                qkv=qkv,
                o_proj=get_quant(f"{attn}.{fam['o']}"),
                post_norm=jnp.asarray(
                    src(f"{pfx}.post_attention_layernorm.weight"), jnp.float32
                ),
                gateup=gateup,
                down=down,
                moe=moe,
            )
        )
    lm_head = None
    head_name = fam["lm_head"][: -len(".weight")]
    if not cfg.tie_word_embeddings and fam["lm_head"] in src:
        if f"{head_name}.weight_scales" in src:  # saved with quantize_lm_head
            lm_head = get_quant(head_name)
        else:
            lm_head = DenseLinear(
                weight=jnp.asarray(src(fam["lm_head"]).T.copy(), dtype)
            )
    return cfg, ModelParams(
        embed=jnp.asarray(src(fam["embed"]), dtype),
        layers=layers,
        final_norm=jnp.asarray(src(fam["final_norm"]), jnp.float32),
        lm_head=lm_head,
    )
