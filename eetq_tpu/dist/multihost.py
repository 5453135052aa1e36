"""Multi-host initialization and (dp, tp) mesh construction.

The reference has no distributed layer at all (SURVEY.md §2.3: its only
rank-awareness is a log filter). This module is the multi-host entry:
initialize the JAX distributed runtime, then build a mesh whose
tensor-parallel axis stays within one process (the cards of one host, all
to all over NVLink) and whose data-parallel axis spans processes. Within a
host every card reaches every other at the same rate, so the mesh follows
the algorithm alone.

Typical multi-host serving setup (same program on every host):

    from eetq_tpu.dist import multihost
    multihost.initialize(coordinator_address="host0:1234",
                         num_processes=2, process_id=rank)
    mesh = multihost.make_hybrid_mesh(tp=4)     # tp within a host
    model = AutoEETQForCausalLM.from_quantized(path).shard(mesh=mesh)
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

from eetq_tpu.dist.sharding import DATA_AXIS, MODEL_AXIS
from eetq_tpu.utils.logging import get_logger

log = get_logger(__name__)


def initialize(**kwargs) -> None:
    """Initialize jax.distributed across hosts (the explicit kwargs
    jax.distributed.initialize takes: coordinator_address, num_processes,
    process_id).
    Safe no-op when already initialized or on a single process.

    Order matters: jax.distributed.initialize() must run BEFORE anything
    that initializes the XLA backend — even jax.process_count() does — so
    the only pre-checks allowed here are jax.distributed's own state."""
    if jax.distributed.is_initialized():
        return
    try:
        jax.distributed.initialize(**kwargs)
        log.info(
            "jax.distributed initialized: process %d/%d",
            jax.process_index(), jax.process_count(),
        )
    except (RuntimeError, ValueError) as e:
        if "backend" in str(e).lower() or "initialize" in str(e).lower():
            # XLA already started (e.g. user touched jax.devices() first):
            # surface it — on multi-process setups this silently degrades
            # to per-host single-process execution.
            log.warning("jax.distributed.initialize failed: %s", e)
        else:
            # no coordinator configured: genuine single-process run
            log.debug("jax.distributed not initialized (%s); single-process", e)


def make_hybrid_mesh(
    tp: int | None = None,
    dp: int | None = None,
    devices=None,
) -> Mesh:
    """(dp, tp) mesh with the tp axis inside one process.

    Defaults: tp = devices per process (one host's cards), dp = process
    count. On a single host this is dist.make_mesh.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if tp is None:
        tp = max(1, jax.local_device_count())
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp = {dp}*{tp} != device count {n}")
    # group each process's devices together so the model axis stays on
    # intra-host links and dp crosses processes
    ordered = sorted(devices, key=lambda d: (d.process_index, d.id))
    return Mesh(np.asarray(ordered).reshape(dp, tp), (DATA_AXIS, MODEL_AXIS))
