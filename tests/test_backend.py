"""The one backend rule (eetq_tpu.backend), the serving defaults that hang
off it, the compile-cache location, and chip_smoke's refusal to run
without a GPU."""

import os
import sys

import jax
import jax.numpy as jnp
import pytest

from eetq_tpu import backend

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cpu_rule():
    """Here (the CPU) every choice takes its CPU side: XLA attention, one
    decode step per host round trip, no GEMV kernel."""
    assert not backend.on_gpu()
    assert backend.attention_implementation() == "xla"
    assert backend.default_decode_window() == 1
    assert not backend.use_gemv_kernel(1)


def test_gpu_rule(monkeypatch):
    """On a GPU: cuDNN attention, 8-step decode windows, and the GEMV
    kernel for decode rows only (m <= 8)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert backend.on_gpu()
    assert backend.attention_implementation() == "cudnn"
    assert backend.default_decode_window() == 8
    assert backend.use_gemv_kernel(1) and backend.use_gemv_kernel(8)
    assert not backend.use_gemv_kernel(9)


def test_no_backend_name_comparisons_outside_the_rule():
    """No module but eetq_tpu/backend.py compares backend names."""
    pkg = os.path.join(ROOT, "eetq_tpu")
    hits = []
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py") or f == "backend.py":
                continue
            text = open(os.path.join(dirpath, f)).read()
            if "default_backend()" in text or ".platform ==" in text:
                hits.append(os.path.join(dirpath, f))
    assert not hits, hits


def test_engine_defaults_follow_the_rule():
    """W8A8 prefill and int8 KV stay opt-in (no cell has decided them on
    the GPU); the decode window comes from the backend rule."""
    from eetq_tpu.models import quantize_params, random_dense_params
    from eetq_tpu.models.config import TOY
    from eetq_tpu.serve.engine import Engine

    qp = quantize_params(random_dense_params(TOY, jax.random.PRNGKey(0)))
    eng = Engine(qp, TOY, max_batch=2, max_len=1024)
    assert eng.kv_dtype == jnp.bfloat16
    assert eng._backend.a8_prefill is False
    assert eng.decode_window == backend.default_decode_window()


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_follows_the_env(monkeypatch, tmp_path,
                                       restore_cache_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is left to JAX: the helper
    reports it and sets no other path."""
    from eetq_tpu.utils.compile_cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert enable_compile_cache(str(tmp_path)) == str(tmp_path / "c")
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_in_checkout(monkeypatch, tmp_path,
                                           restore_cache_dir):
    """Unset: <checkout>/.jax_cache, a fixed path (no temp name, pid or
    time), which .gitignore lists."""
    from eetq_tpu.utils.compile_cache import CHECKOUT, enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = enable_compile_cache(str(tmp_path))
    assert path == str(tmp_path / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert CHECKOUT == ROOT
    assert ".jax_cache/" in open(os.path.join(ROOT, ".gitignore")).read()


def test_chip_smoke_refuses_the_cpu():
    """chip_smoke's device check raises SystemExit (nonzero) off the GPU,
    before any phase runs or any result is printed."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    with pytest.raises(SystemExit) as e:
        chip_smoke.require_gpu()
    assert "GPU" in str(e.value)
