"""Test configuration: the CPU backend with 8 virtual devices, so the
multi-device sharding paths run without a GPU (SURVEY.md §4).

Tests marked `chip` need an NVIDIA GPU; the `_chip_only` fixture skips
them elsewhere. Run them on the card with:

    JAX_PLATFORMS=cuda python -m pytest tests/ -m chip
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = flags + " --xla_force_host_platform_device_count=8"
if "xla_cpu_collective_timeout_seconds" not in flags:
    # XLA CPU kills the process (rendezvous.cc termination timeout, 40 s
    # default) when the 8 virtual devices' threads don't all reach a
    # psum in time — which big sharded tests on a loaded host can trip.
    flags = (
        flags
        + " --xla_cpu_collective_timeout_seconds=1200"
        + " --xla_cpu_collective_call_terminate_timeout_seconds=1200"
    )
os.environ["XLA_FLAGS"] = flags.strip()

import gc  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _chip_only(request):
    """Skip a `chip`-marked test unless JAX runs on an NVIDIA GPU. Decided
    here, when the test runs, so every pytest-xdist worker collects the
    same tests."""
    if request.node.get_closest_marker("chip") is None:
        return
    from eetq_tpu.backend import on_gpu

    if not on_gpu():
        pytest.skip(
            "needs an NVIDIA GPU: JAX_PLATFORMS=cuda python -m pytest "
            "tests/ -m chip"
        )


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop compiled executables between test modules. Full-suite runs
    accumulate hundreds of XLA CPU compilations in one process and
    eventually SEGFAULT inside `backend_compile_and_load` late in the run
    (the crash follows whatever heavy compile lands late in the process,
    not a specific program). Clearing per module bounds the live
    compiled-code footprint; the recompiles it forces are tiny-test-sized."""
    yield
    jax.clear_caches()
    gc.collect()
