"""70B-shape multi-device validation (BASELINE config 5):
shard the REAL Llama-2-70B dimensions (GQA 64q/8kv heads, hidden 8192,
intermediate 28672, vocab 32000) — truncated to 2 layers so it fits a CPU
test — over the 8-device virtual mesh, and prove:

- every sharded axis divides exactly at tp=8 (8 q heads + 1 kv head,
  3584-row row-parallel down shards, 4000-column lm_head shards);
- the sharded forward matches the single-device forward at these dims
  (dense bf16 — the quantized matmul's numerics are dim-independent and
  covered by test_sharding/test_w8a16_matmul);
- per-shard quantization at 70B dims produces the right structures:
  stacked [tp, ...] qweights, per-shard scale rows on row-parallel
  layers, a column-split QUANTIZED lm_head;
- per-device weight memory at the FULL 80 layers fits an 80 GB H100 at
  tp=4 (the serving plan the 70B preset exists for) with room for caches,
  and stays under 16 GB per device at tp=8.

The heavy checks (2.2B-param fixture + sharded forwards) run in a CLEAN
subprocess (tests/seventy_b_checks.py): XLA CPU hard-aborts the process
when 8 one-core device threads miss a collective rendezvous within its
40 s kill timeout (rendezvous.cc) — the subprocess raises the timeout and
isolates a worst-case abort from the rest of the suite.
"""

import os
import subprocess
import sys

import pytest

from eetq_tpu.models.config import LLAMA2_70B

TP = 8


def test_70b_dims_divide_at_tp8():
    cfg = LLAMA2_70B
    assert cfg.num_heads % TP == 0 and cfg.num_heads // TP == 8
    assert cfg.num_kv_heads % TP == 0 and cfg.num_kv_heads // TP == 1
    assert cfg.intermediate_size % TP == 0  # 3584-row down shards
    assert cfg.vocab_size % TP == 0  # column-parallel lm_head
    assert cfg.qkv_out == (64 + 2 * 8) * 128  # fused qkv columns


@pytest.mark.parametrize(
    "tp,weight_budget,total_budget",
    [
        (4, 20e9, 60e9),  # four H100s: JAX's 60 GB share of each 80 GB card
        (8, 11e9, 15e9),  # eight 16 GB devices
    ],
)
def test_70b_per_device_memory_fits_the_card(tp, weight_budget, total_budget):
    """int8 weight bytes per device at the FULL 80 layers, plus an int8 KV
    cache for batch 8 x 4096 tokens with kv heads sharded, fit the card."""
    cfg = LLAMA2_70B
    h, inter, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    per_layer = (
        h * cfg.qkv_out  # qkv (column-parallel)
        + cfg.num_heads * cfg.head_dim * h  # o_proj (row-parallel)
        + h * 2 * inter  # gateup
        + inter * h  # down
    )
    weight_bytes = cfg.num_layers * per_layer  # int8: 1 byte/weight
    embed_bytes = v * h * 2  # bf16 embed (replicated)
    head_bytes = h * v  # int8 quantized lm_head (column-parallel)
    per_device = weight_bytes / tp + embed_bytes + head_bytes / tp
    assert per_device < weight_budget, per_device
    kv = 80 * 2 * 8 * 4096 * (cfg.num_kv_heads // tp) * cfg.head_dim
    assert per_device + kv < total_budget, (per_device, kv)


@pytest.mark.slow
def test_70b_heavy_checks_subprocess():
    """Sharded-forward parity + per-shard quantized structure at true 70B
    dims, in a fresh process (see module docstring for why)."""
    script = os.path.join(os.path.dirname(__file__), "seventy_b_checks.py")
    proc = subprocess.run(
        [sys.executable, "-u", script],
        capture_output=True,
        text=True,
        timeout=2400,
    )
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-2000:])
    assert "ALL 70B CHECKS PASS" in proc.stdout, proc.stdout[-2000:]
