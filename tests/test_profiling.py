"""Profiling/roofline utility tests (CPU: API + math, not absolute perf)."""

import jax.numpy as jnp
import pytest

from eetq_tpu.utils.profiling import (
    PEAKS,
    chip_peaks,
    roofline,
    time_fn,
    trace,
)

H100 = "NVIDIA H100 80GB HBM3"


def test_roofline_memory_bound():
    # 1 GB moved in 2 ms -> 500 GB/s; trivial flops -> memory bound
    r = roofline(2e-3, 10**9, 10**6, kind=H100)
    assert r.bound == "memory"
    assert r.achieved_gbs == 500.0
    assert 0 < r.fraction_of_roof <= 1.0
    assert "GB/s" in str(r)


def test_roofline_compute_bound():
    # 10 TFLOP in 100 ms with tiny bytes -> compute bound
    r = roofline(0.1, 10**6, 10**13, kind=H100)
    assert r.bound == "compute"
    assert r.achieved_tflops == 100.0
    # int8=True scores against the int8 tensor-core peak
    r8 = roofline(0.1, 10**6, 10**13, kind=H100, int8=True)
    assert (r.peak_tflops, r8.peak_tflops) == (989.0, 1979.0)


def test_peaks_table_known_kind():
    """The H100 SXM data-sheet numbers, keyed by JAX's device_kind."""
    p = chip_peaks(H100)
    assert (p.hbm_gbs, p.bf16_tflops, p.int8_tops, p.power_w) == (
        3350.0, 989.0, 1979.0, 700.0
    )
    assert set(PEAKS) == {H100}


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB"])
def test_peaks_unknown_kind_raises(kind):
    """No device gets a default peak: an unknown kind is an error (the CPU
    included, which is what chip_peaks() sees here)."""
    with pytest.raises(KeyError):
        chip_peaks(kind)
    if kind == "cpu":
        with pytest.raises(KeyError):
            chip_peaks()


def test_time_fn_blocks_and_takes_the_best():
    calls = []

    def f(x):
        calls.append(1)
        return x @ x

    x = jnp.ones((64, 64), jnp.float32)
    t = time_fn(f, x, reps=3, warmup=2)
    assert t > 0 and len(calls) == 5


def test_trace_writes_a_profile(tmp_path):
    """trace() captures a jax.profiler trace (an .xplane.pb under
    plugins/profile/) of the enclosed work."""
    with trace(str(tmp_path)):
        (jnp.ones((32, 32)) @ jnp.ones((32, 32))).block_until_ready()
    assert list(tmp_path.glob("plugins/profile/*/*.xplane.pb"))


def test_count_collectives_matches_model():
    """Megatron TP moves 2 psums/layer + 1 lm_head all-gather per forward —
    assert that census against the real sharded program's jaxpr."""
    import jax

    from eetq_tpu.dist import make_mesh, shard_model
    from eetq_tpu.dist.sharding import make_forward_fn
    from eetq_tpu.models import ModelConfig, init_caches, random_dense_params
    from eetq_tpu.utils.profiling import count_collectives

    cfg = ModelConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=8, num_kv_heads=4, head_dim=16, max_position=32,
    )
    dense = random_dense_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    mesh = make_mesh(tp=4, dp=1)
    model = shard_model(dense, cfg, mesh, quantize=False)
    fwd = make_forward_fn(model)
    toks = jnp.zeros((1, 4), jnp.int32)
    pos = jnp.arange(4, dtype=jnp.int32)[None]
    caches = init_caches(cfg, 1, 8, dtype=jnp.float32)

    counts = count_collectives(
        lambda p, t, q, c: fwd(p, t, q, c, jnp.int32(0)),
        model.params, toks, pos, caches,
    )
    psums = counts.get("psum_count", 0) + counts.get("psum2_count", 0)
    assert psums == 2 * cfg.num_layers, counts
    assert counts.get("all_gather_count", 0) == 1, counts


def test_pp_collective_census():
    """The token-ring pipeline moves ONE ring ppermute per decode tick (the
    activation+token payload) — assert it against the real pipelined
    program's jaxpr: exactly one ppermute inside the decode scan body
    (= total_ticks executions), and pp-1 boundary permutes in prefill."""
    import jax

    from eetq_tpu.dist import (
        init_pp_caches,
        make_pp_mesh,
        shard_model_pp,
    )
    from eetq_tpu.dist.pipeline import _pp_decode_jit, _pp_prefill_jit
    from eetq_tpu.models import ModelConfig, random_dense_params
    from eetq_tpu.utils.profiling import count_collectives

    cfg = ModelConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128, num_layers=2,
        num_heads=8, num_kv_heads=4, head_dim=16, max_position=32,
    )
    dense = random_dense_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    mesh = make_pp_mesh(pp=2, tp=1, dp=1)
    model = shard_model_pp(dense, cfg, mesh, quantize=False)
    caches = init_pp_caches(model, 2, 16)
    first = jnp.zeros((2,), jnp.int32)
    key = jax.random.PRNGKey(0)

    counts = count_collectives(
        lambda p, f, c, k: _pp_decode_jit(
            model, p, f, jnp.int32(4), c, 3, 2, 0.0, 0, k
        ),
        model.params, first, caches, key,
    )
    # one ring transfer per tick, traced once inside the scan: the
    # (activation, token) tuple payload lowers to one ppermute per leaf
    # (2 eqns), and its total bytes are exactly one activation and one
    # token per microbatch row (mbs*h*2 bf16 + mbs*4), plus the
    # final out-buffer psum
    assert counts.get("ppermute_count", 0) == 2, counts
    mbs, h = 1, cfg.hidden_size
    assert counts.get("ppermute", 0) == mbs * h * 2 + mbs * 4, counts
    assert counts.get("psum_count", 0) + counts.get("psum2_count", 0) >= 1, counts

    caches2 = init_pp_caches(model, 2, 16)
    toks = jnp.zeros((2, 4), jnp.int32)
    counts_p = count_collectives(
        lambda p, t, c: _pp_prefill_jit(model, p, t, c, 2),
        model.params, toks, caches2,
    )
    assert counts_p.get("ppermute_count", 0) == 1, counts_p
