"""HTTP serving walkthrough: the last-mile endpoint the reference leaves
to TGI/LoRAX (`/root/reference/README.md:88-101`), built over the engine.

Starts the dependency-free `EngineServer` on a local port, issues a
non-streamed completion and a streamed (SSE) one from a client thread,
and prints the per-window token events as they arrive. Runs on the CPU or
an NVIDIA GPU.
"""

import http.client
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import jax
import jax.numpy as jnp

from eetq_tpu.models import ModelConfig, quantize_params, random_dense_params
from eetq_tpu.serve import Engine, EngineServer
from eetq_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()  # a restarted server finds its compiled programs

cfg = ModelConfig(
    vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
    num_heads=8, num_kv_heads=4, head_dim=32, max_position=1024,
)
params = quantize_params(
    random_dense_params(cfg, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
)

eng = Engine(params, cfg, max_batch=4, max_len=256, prompt_buckets=(32,))
srv = EngineServer(eng, port=0)  # port=0: pick a free port
srv.start()
print(f"serving on http://{srv.host}:{srv.port}")

conn = http.client.HTTPConnection(srv.host, srv.port, timeout=600)

# ---- non-streamed completion -------------------------------------------
body = {"prompt": [3, 17, 42, 9], "max_new_tokens": 12}
conn.request("POST", "/v1/completions", json.dumps(body),
             {"Content-Type": "application/json"})
resp = json.loads(conn.getresponse().read())
print("completion:", resp["tokens"])

# ---- streamed completion (SSE): tokens arrive per decode window --------
body["stream"] = True
conn.request("POST", "/v1/completions", json.dumps(body),
             {"Content-Type": "application/json"})
r = conn.getresponse()
streamed = []
buf = b""
while True:
    chunk = r.read1(65536)
    if not chunk:
        break
    buf += chunk
    while b"\n\n" in buf:
        line, buf = buf.split(b"\n\n", 1)
        if not line.startswith(b"data: "):
            continue
        ev = json.loads(line[len(b"data: "):])
        print("stream event:", ev)
        streamed.extend(ev["tokens"])
        if ev["done"]:
            break

assert streamed == resp["tokens"], "streamed != non-streamed greedy output"
print("streamed output matches the non-streamed completion")

# ---- health -------------------------------------------------------------
conn.request("GET", "/health")
print("health:", json.loads(conn.getresponse().read()))

srv.shutdown()
print("ok")
