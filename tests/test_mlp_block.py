"""The unfused MLP block (gate/up projection, gated activation, down
projection, residual) of the decoder layer against a float32 reference of
the same dequantized weights — the path that replaced the fused-MLP decode
kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eetq_tpu.models.config import ModelConfig
from eetq_tpu.models.transformer import decoder_layer
from eetq_tpu.modules.linear import quantize_linear
from eetq_tpu.quant import dequantize
from eetq_tpu.layout import unpack_weights

H, I = 128, 256


def _mlp_ref(x, gateup, down, gamma, act):
    """numpy f32: x + down(act(gate) * up), gate|up = rmsnorm(x) @ Wgu."""
    xf = np.asarray(x, np.float32)
    y = xf / np.sqrt(np.mean(xf * xf, -1, keepdims=True) + 1e-6)
    y = y * np.asarray(gamma, np.float32)
    wgu = np.asarray(dequantize(unpack_weights(gateup.qweight), gateup.scales))
    wd = np.asarray(dequantize(unpack_weights(down.qweight), down.scales))
    g, u = np.split(y @ wgu, 2, axis=-1)
    a = {"silu": lambda t: t / (1 + np.exp(-t)),
         "gelu": lambda t: np.asarray(jax.nn.gelu(t))}[act](g)
    return xf + (a * u) @ wd


@pytest.mark.parametrize(
    "bits,group,act,rows",
    [
        (8, None, "silu", 1),    # int8 decode row
        (8, None, "silu", 12),   # int8 prefill rows
        (4, 64, "silu", 3),      # int4 group-wise
        (4, None, "gelu", 5),    # int4 per-channel, gemma's activation
    ],
)
def test_mlp_block_matches_float_reference(bits, group, act, rows):
    cfg = ModelConfig(
        vocab_size=64, hidden_size=H, intermediate_size=I, num_layers=1,
        num_heads=4, num_kv_heads=4, head_dim=32, max_position=64,
        activation=act,
    )
    k = jax.random.split(jax.random.PRNGKey(bits + rows), 4)
    gateup = quantize_linear(
        jax.random.normal(k[0], (H, 2 * I)) * H**-0.5, bits=bits,
        group_size=group,
    )
    down = quantize_linear(
        jax.random.normal(k[1], (I, H)) * I**-0.5, bits=bits, group_size=group,
    )
    gamma = 1.0 + 0.1 * jax.random.normal(k[2], (H,))
    x = jax.random.normal(k[3], (1, rows, H), jnp.bfloat16)

    # the layer's MLP half: attention contributes nothing when o_proj is 0
    from eetq_tpu.models.transformer import LayerParams
    from eetq_tpu.modules.linear import DenseLinear

    zero_attn = LayerParams(
        input_norm=jnp.ones((H,)),
        qkv=DenseLinear(weight=jnp.zeros((H, 3 * H), jnp.bfloat16)),
        o_proj=DenseLinear(weight=jnp.zeros((H, H), jnp.bfloat16)),
        post_norm=gamma, gateup=gateup, down=down,
    )
    from eetq_tpu.ops import make_cos_sin_cache

    from eetq_tpu.modules.attention import init_kv_cache

    pos = jnp.arange(rows, dtype=jnp.int32)[None]
    cache = init_kv_cache(1, 64, 4, 32)  # a 1-row input decodes into it
    out, _ = decoder_layer(zero_attn, cfg, x, pos,
                           make_cos_sin_cache(64, 32), cache, 0)
    want = _mlp_ref(x[0], gateup, down, gamma, act)
    got = np.asarray(out[0], np.float32)
    # bf16 activations between the two projections and a bf16 output
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)
    assert np.abs(got - want).mean() < 1e-2


def test_mlp_block_residual_is_exact_for_zero_weights():
    """With all-zero projections the block returns its input bit for bit
    (the residual add is the only thing left)."""
    cfg = ModelConfig(
        vocab_size=64, hidden_size=H, intermediate_size=I, num_layers=1,
        num_heads=4, num_kv_heads=4, head_dim=32, max_position=64,
    )
    from eetq_tpu.models.transformer import LayerParams
    from eetq_tpu.modules.linear import DenseLinear
    from eetq_tpu.ops import make_cos_sin_cache

    lp = LayerParams(
        input_norm=jnp.ones((H,)),
        qkv=DenseLinear(weight=jnp.zeros((H, 3 * H), jnp.bfloat16)),
        o_proj=DenseLinear(weight=jnp.zeros((H, H), jnp.bfloat16)),
        post_norm=jnp.ones((H,)),
        gateup=quantize_linear(jnp.zeros((H, 2 * I))),
        down=quantize_linear(jnp.zeros((I, H))),
    )
    x = jax.random.normal(jax.random.PRNGKey(0), (2, 3, H), jnp.bfloat16)
    pos = jnp.broadcast_to(jnp.arange(3, dtype=jnp.int32), (2, 3))
    out, _ = decoder_layer(lp, cfg, x, pos, make_cos_sin_cache(64, 32), None, 0)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(x))
