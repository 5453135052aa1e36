"""Bring-up check of the W8A16 serving path on NVIDIA GPUs.

    python chip_smoke.py                # one card: phases 1-3 below
    python chip_smoke.py --four-cards   # four cards: tensor-parallel 70B path

One card:
  1. Device: the card's name and power limit (nvidia-smi), JAX's device
     kind and count. Anything but a GPU is an error.
  2. Ops at llama2-7b widths, each compared with a plain float32 reference
     computed at "highest" matmul precision (a float32 product may
     otherwise run in TF32 on this card): the quantized projections (int8
     per-channel, int4 group-128, W8A8, the int8 lm_head) at m = 1, 8 and
     1024; prefill attention (causal, GQA with a sliding window, ALiBi);
     decode and 8-token verify attention over a 2048-slot cache, dense and
     paged.
  3. Serve: llama2-7b at full width and depth with random weights from
     --seed, quantized to W8A16, saved and reloaded through
     save_quantized / from_quantized, served by Engine + EngineServer over
     HTTP to four prompts (one more request streams), and checked against
     serve.generate and a float32 forward of the same dequantized weights.

Four cards (--four-cards): llama2-70b widths, W8A16, shard_model(tp=4) ->
Engine answering a few requests, and the same model cut to 2 layers,
sharded against the unsharded model with the same quantized weights on
card 0 (logits and greedy tokens).

The last line of stdout is one JSON object, {"ok": true, "device": {...}},
printed only when every phase passed; any failure exits nonzero.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import http.client
import json
import subprocess
import tempfile
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np

HIGHEST = "highest"
# llama2-7b projections: fused qkv, o_proj, fused gate/up, down, lm_head
MATMUL_SHAPES = [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096),
                 (4096, 32000)]
LM_HEAD = (4096, 32000)
ROWS = (1, 8, 1024)
ATTN_SEQ, ATTN_DIM, CACHE_SLOTS, BLOCK = 1024, 128, 2048, 256
SERVE_MODEL, TP_MODEL = "llama2-7b", "llama2-70b"
PROMPT_LENGTHS, NEW_TOKENS = (97, 311, 640, 1000), 32


def log(msg: str) -> None:
    print(msg, flush=True)


def require_gpu() -> list:
    """JAX's devices; raises SystemExit unless the first is a GPU."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke needs an NVIDIA GPU; JAX's first device is "
            f"{devs[0].platform!r} ({devs[0].device_kind})"
        )
    return devs


def phase_device(devs: list) -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    for line in smi.stdout.strip().splitlines():
        log(f"nvidia-smi: {line.strip()}")
    log(f"jax: platform={devs[0].platform} kind={devs[0].device_kind} "
        f"count={len(devs)}")


def check(name: str, got, want, tol: float, reason: str) -> None:
    """Fail unless got is finite, shaped like want, and within tol of it:
    max |got - want| <= tol * max |want|."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
    if not np.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = float(np.abs(got - want).max())
    rel = err / max(float(np.abs(want).max()), 1e-30)
    log(f"  {name}: max abs err {err:.3e}, rel {rel:.3e} <= {tol:g} "
        f"({reason})")
    if not rel <= tol:
        raise AssertionError(f"{name}: rel error {rel:.3e} > {tol:g}")


# ---- phase 2: ops at real widths --------------------------------------

MATMUL_TOL = 1e-2
MATMUL_WHY = ("same bf16 inputs; bf16 output rounding (2^-9 relative) and "
              "f32 summation order")
ATTN_TOL = 2e-2
ATTN_WHY = ("bf16 inputs; bf16 probabilities in the product with V "
            "(2^-9 relative per term) and bf16 output rounding")


def phase_ops(seed: int) -> None:
    from eetq_tpu.layout import pack_weights
    from eetq_tpu.ops import w8a16_matmul, w8a8_matmul
    from eetq_tpu.ops.linear8 import quantize_activations
    from eetq_tpu.quant import dequantize, symmetric_quantize

    w16 = jax.jit(w8a16_matmul)
    w8 = jax.jit(w8a8_matmul)
    key = jax.random.PRNGKey(seed)
    for k, n in MATMUL_SHAPES:
        key, kw = jax.random.split(key)
        w = jax.random.normal(kw, (k, n), jnp.float32) * k**-0.5
        lm_head = (k, n) == LM_HEAD
        modes = [(8, None)] if lm_head else [(8, None), (4, 128)]
        for bits, g in modes:
            q, s = symmetric_quantize(w, bits=bits, group_size=g)
            packed = pack_weights(q, bits=bits)
            wdeq = dequantize(q, s)
            for m in ROWS:
                key, kx = jax.random.split(key)
                x = jax.random.normal(kx, (m, k), jnp.bfloat16)
                got = w16(x, packed, s)
                with jax.default_matmul_precision(HIGHEST):
                    want = x.astype(jnp.float32) @ wdeq
                tag = "int8" if g is None else f"int4 g{g}"
                check(f"w{bits}a16 {tag} m={m} {k}->{n}", got, want,
                      MATMUL_TOL, MATMUL_WHY)
                if bits == 8 and m == ROWS[-1] and not lm_head:
                    xq, sx = quantize_activations(x)
                    got8 = w8(x, packed, s)
                    with jax.default_matmul_precision(HIGHEST):
                        want8 = (xq.astype(jnp.float32) * sx[:, None]) @ wdeq
                    check(f"w8a8 m={m} {k}->{n}", got8, want8, MATMUL_TOL,
                          "the reference quantizes the same activations; "
                          "bf16 output rounding and f32 summation order")
        del w
    phase_attention(key)


def _ref_attention(q, k, v, qpos, lengths=None, window=None, slopes=None):
    """f32 attention: q [B, S, Hq, D] at positions qpos [B, S], keys
    k/v [B, L, Hkv, D] at positions 0..L-1 (valid below lengths [B])."""
    with jax.default_matmul_precision(HIGHEST):
        b, s, hq, d = q.shape
        hkv, l = k.shape[2], k.shape[1]
        qf = q.astype(jnp.float32).reshape(b, s, hkv, hq // hkv, d)
        sc = jnp.einsum("bskgd,blkd->bkgsl", qf, k.astype(jnp.float32))
        sc = sc / np.sqrt(d)
        j = jnp.arange(l)[None, None, None, None, :]
        qp = qpos[:, None, None, :, None]
        if slopes is not None:
            sc = sc + slopes.reshape(1, hkv, hq // hkv, 1, 1) * (j - qp)
        mask = j <= qp
        if lengths is not None:
            mask &= j < lengths[:, None, None, None, None]
        if window is not None:
            mask &= j > qp - window
        p = jax.nn.softmax(jnp.where(mask, sc, -jnp.inf), axis=-1)
        out = jnp.einsum("bkgsl,blkd->bskgd", p, v.astype(jnp.float32))
        return out.reshape(b, s, hq, d)


def phase_attention(key) -> None:
    from eetq_tpu.modules.attention import (
        attention_decode,
        attention_prefill,
        attention_verify,
        init_kv_cache,
        update_cache,
    )
    from eetq_tpu.modules.paged import (
        init_paged_kv_cache,
        paged_attention_decode,
        paged_attention_verify,
        paged_insert_dense,
    )
    from eetq_tpu.ops import alibi_slopes

    s, d = ATTN_SEQ, ATTN_DIM
    # (name, q heads, kv heads, window, alibi): llama2-7b; mistral-7b's GQA
    # with a window cut to 256 so it bites at S=1024; baichuan-13b's ALiBi
    for name, hq, hkv, window, alibi in [
        ("causal 32 heads", 32, 32, None, False),
        ("GQA 32/8 window 256", 32, 8, 256, False),
        ("ALiBi 40 heads", 40, 40, None, True),
    ]:
        key, k1, k2, k3 = jax.random.split(key, 4)
        q = jax.random.normal(k1, (1, s, hq, d), jnp.bfloat16)
        k = jax.random.normal(k2, (1, s, hkv, d), jnp.bfloat16)
        v = jax.random.normal(k3, (1, s, hkv, d), jnp.bfloat16)
        slopes = jnp.asarray(alibi_slopes(hq)) if alibi else None
        got = attention_prefill(q, k, v, window=window, slopes=slopes)
        want = _ref_attention(q, k, v, jnp.arange(s)[None], window=window,
                              slopes=slopes)
        check(f"prefill attention {name} S={s}", got, want, ATTN_TOL,
              ATTN_WHY)

    b, hq, hkv, slots, bs = 4, 32, 32, CACHE_SLOTS, BLOCK
    key, k1, k2, k3 = jax.random.split(key, 4)
    kf = jax.random.normal(k1, (b, slots, hkv, d), jnp.bfloat16)
    vf = jax.random.normal(k2, (b, slots, hkv, d), jnp.bfloat16)
    dense = update_cache(init_kv_cache(b, slots, hkv, d), kf, vf, 0)
    nb = slots // bs
    perm = np.random.default_rng(0).permutation(b * nb) + 1  # 0 = trash
    table = jnp.asarray(perm.reshape(b, nb), jnp.int32)
    paged = init_paged_kv_cache(b * nb + 1, bs, hkv, d, b, nb)
    paged = dataclasses.replace(paged, table=table)
    for r in range(b):
        paged = paged_insert_dense(paged, dense, jnp.int32(r), table[r], nb)
    for sq in (1, 8):
        qd = jax.random.normal(k3, (b, sq, hq, d), jnp.bfloat16)
        lengths = jnp.asarray([sq, slots // 7, slots * 3 // 4, slots],
                              jnp.int32)
        qpos = lengths[:, None] - sq + jnp.arange(sq)[None]
        want = _ref_attention(qd, kf, vf, qpos, lengths=lengths)
        kind = "decode" if sq == 1 else f"verify S={sq}"
        if sq == 1:
            got = attention_decode(qd, dense, lengths)
            got_p = paged_attention_decode(qd, paged, lengths)
        else:
            got = attention_verify(qd, dense, lengths, None, d**-0.5)
            got_p = paged_attention_verify(qd, paged, lengths)
        check(f"{kind} attention, dense {slots}-slot cache", got, want,
              ATTN_TOL, ATTN_WHY)
        check(f"{kind} attention, paged {slots}-slot cache", got_p, want,
              ATTN_TOL, ATTN_WHY)


# ---- phase 3: serve llama2-7b --------------------------------------------


def reference_logits(params, cfg, tokens) -> jax.Array:
    """Plain float32 forward of a quantized llama model: every projection
    uses its dequantized weight, every product runs at "highest"
    precision. tokens [S] -> logits [S, V]."""
    from eetq_tpu.layout import unpack_weights
    from eetq_tpu.quant import dequantize

    s = tokens.shape[0]
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def proj(x, lin):
        w = dequantize(unpack_weights(lin.qweight), lin.scales)
        y = x @ w
        return y if lin.bias is None else y + lin.bias.astype(jnp.float32)

    def norm(x, g):
        return x * jax.lax.rsqrt(jnp.mean(x * x, -1, keepdims=True)
                                 + cfg.rms_eps) * g

    inv = 1.0 / cfg.rope_theta ** (jnp.arange(0, d, 2) / d)
    ang = jnp.arange(s)[:, None] * inv[None]
    cos, sin = jnp.cos(ang)[:, None], jnp.sin(ang)[:, None]

    def rope(x):  # NeoX split-half rotation, x [S, H, D]
        x1, x2 = x[..., : d // 2], x[..., d // 2:]
        return jnp.concatenate([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    @jax.jit
    def layer(x, lp):
        with jax.default_matmul_precision(HIGHEST):
            qkv = proj(norm(x, lp.input_norm), lp.qkv)
            q, k, v = jnp.split(qkv, [hq * d, (hq + hkv) * d], axis=-1)
            q = rope(q.reshape(s, hq, d))
            k = rope(k.reshape(s, hkv, d))
            v = v.reshape(s, hkv, d)
            att = _ref_attention(q[None], k[None], v[None],
                                 jnp.arange(s)[None])[0]
            x = x + proj(att.reshape(s, hq * d), lp.o_proj)
            gate, up = jnp.split(proj(norm(x, lp.post_norm), lp.gateup), 2,
                                 axis=-1)
            return x + proj(jax.nn.silu(gate) * up, lp.down)

    x = params.embed[tokens].astype(jnp.float32)
    for lp in params.layers:
        x = layer(x, lp)
    with jax.default_matmul_precision(HIGHEST):
        x = norm(x, params.final_norm)
        return x @ params.lm_head.weight.astype(jnp.float32)


def _post(host, port, body: dict, out: dict, key) -> None:
    conn = http.client.HTTPConnection(host, port, timeout=900)
    conn.request("POST", "/v1/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    if resp.status != 200:
        out[key] = RuntimeError(f"HTTP {resp.status}: {resp.read()!r}")
        return
    if not body.get("stream"):
        out[key] = json.loads(resp.read())["tokens"]
        return
    toks, buf, done = [], b"", False
    while not done:
        chunk = resp.read1(65536)
        if not chunk:
            break
        buf += chunk
        while b"\n\n" in buf and not done:
            line, buf = buf.split(b"\n\n", 1)
            if line.startswith(b"data: "):
                ev = json.loads(line[len(b"data: "):])
                toks.extend(ev["tokens"])
                done = ev["done"]
    out[key] = toks


def serve_requests(server, prompts, new_tokens: int, stream_index: int):
    """POST every prompt (non-streamed) plus prompts[stream_index] once
    more as a stream, all at once; returns (token lists, streamed)."""
    out: dict = {}
    threads = [
        threading.Thread(target=_post, args=(
            server.host, server.port,
            {"prompt": p, "max_new_tokens": new_tokens}, out, i))
        for i, p in enumerate(prompts)
    ]
    threads.append(threading.Thread(target=_post, args=(
        server.host, server.port,
        {"prompt": prompts[stream_index], "max_new_tokens": new_tokens,
         "stream": True}, out, "stream")))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for v in out.values():
        if isinstance(v, Exception):
            raise v
    return [out[i] for i in range(len(prompts))], out["stream"]


GREEDY_TOL = 0.05
GREEDY_WHY = ("two programs that sum bf16 activations in different orders "
              "(other shapes, batch rows, attention kernels) move a logit by "
              "up to a few hundredths")


def check_greedy(name, params, prompt, got, want, fwd) -> None:
    """got (greedy tokens of the system under test) against want (another
    path's greedy tokens for the same prompt). Every token of got must be a
    near-argmax of the model's own logits, teacher-forced on prompt +
    got[:t] (top logit minus got[t]'s logit <= GREEDY_TOL); got and want
    must agree up to their first difference, where the model's top-2
    margin must be below GREEDY_TOL (a near-tie either order may break)."""
    p = len(prompt)
    seq = jnp.asarray(list(prompt) + list(got), jnp.int32)[None]
    logits = np.asarray(fwd(params, seq)[0], np.float32)[p - 1 : p - 1 + len(got)]
    gaps = logits.max(-1) - logits[np.arange(len(got)), np.asarray(got)]
    t = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    same = len(got) if t is None else t
    log(f"  {name}: {same}/{len(got)} tokens equal; every token within "
        f"{gaps.max():.3e} of the teacher-forced argmax <= {GREEDY_TOL:g} "
        f"({GREEDY_WHY})")
    if not gaps.max() <= GREEDY_TOL:
        raise AssertionError(f"{name}: token {int(gaps.argmax())} is not "
                             f"a greedy choice (gap {gaps.max():.3e})")
    if t is not None:
        top2 = np.sort(logits[t])[-2:]
        margin = float(top2[1] - top2[0])
        log(f"  {name}: at token {t} the top-2 margin is {margin:.3e}")
        if not margin <= GREEDY_TOL:
            raise AssertionError(f"{name}: diverged at {t} without a tie")


def logit_agreement(name, got, want) -> None:
    """Mean KL(want || got) and top-1 agreement over positions, bounded as
    tests/test_accuracy.py bounds int8 end to end (KL < 0.005, top-1 >
    0.85) — here the reference uses the same dequantized weights, so only
    bf16 activations separate the two."""
    pw = jax.nn.log_softmax(jnp.asarray(want, jnp.float32), -1)
    pg = jax.nn.log_softmax(jnp.asarray(got, jnp.float32), -1)
    kl = float(jnp.mean(jnp.sum(jnp.exp(pw) * (pw - pg), -1)))
    top1 = float(jnp.mean(jnp.argmax(pw, -1) == jnp.argmax(pg, -1)))
    log(f"  {name}: KL {kl:.3e} < 0.005, top-1 agreement {top1:.4f} > 0.85")
    if not (np.isfinite(kl) and kl < 0.005 and top1 > 0.85):
        raise AssertionError(f"{name}: KL {kl} / top-1 {top1} out of bounds")


def _model_logits(params, cfg):
    from eetq_tpu.models.transformer import forward

    def fwd(p, toks):
        pos = jnp.arange(toks.shape[1], dtype=jnp.int32)[None]
        return forward(p, cfg, toks, pos, None, jnp.int32(0))[0]

    return fwd


def phase_serve(seed: int) -> None:
    from eetq_tpu import AutoEETQForCausalLM
    from eetq_tpu.models import PRESETS, init_caches, random_quantized_params
    from eetq_tpu.models.hf import save_quantized
    from eetq_tpu.serve import Engine, EngineServer, generate
    from eetq_tpu.serve.generate import decode_loop, prefill
    from eetq_tpu.utils.profiling import time_fn

    cfg = PRESETS[SERVE_MODEL]
    t0 = time.perf_counter()
    params = random_quantized_params(cfg, seed, bits=8)
    log(f"  built {SERVE_MODEL} W8A16 ({cfg.num_layers} layers) on the device "
        f"in {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        save_quantized(params, cfg, ckpt)
        del params
        gc.collect()
        served = AutoEETQForCausalLM.from_quantized(ckpt)
        log(f"  save_quantized -> from_quantized in "
            f"{time.perf_counter() - t0:.1f} s")
    params, cfg = served.params, served.cfg

    rng = np.random.default_rng(seed)
    new = NEW_TOKENS
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in PROMPT_LENGTHS]
    eng = Engine(params, cfg, max_batch=4, max_len=2048,
                 prompt_buckets=(128, 512, 1024))
    server = EngineServer(eng, port=0)
    server.start()
    try:
        t0 = time.perf_counter()
        outs, streamed = serve_requests(server, prompts, new, stream_index=0)
        log(f"  served {len(prompts)} requests + 1 streamed over HTTP in "
            f"{time.perf_counter() - t0:.1f} s (compilation included)")
    finally:
        server.shutdown()
    for i, toks in enumerate(outs):
        if len(toks) != new:
            raise AssertionError(f"request {i}: {len(toks)} tokens != {new}")
    if streamed != outs[0]:
        raise AssertionError("streamed output != non-streamed output")
    log(f"  every request returned {new} tokens; streamed == non-streamed")
    del eng
    gc.collect()

    fwd = jax.jit(_model_logits(params, cfg))
    want = generate(params, cfg, jnp.asarray(prompts[0])[None], new)[0]
    check_greedy("engine vs serve.generate", params, prompts[0], outs[0],
                 np.asarray(want).tolist(), fwd)

    toks = jnp.asarray(prompts[-1], jnp.int32)
    got = fwd(params, toks[None])[0]
    ref = reference_logits(params, cfg, toks)
    logit_agreement(f"prefill logits vs float32 forward, S={toks.shape[0]}",
                    got, ref)
    del got, ref

    # smoke readings (not benchmark cells): prefill of the longest prompt,
    # then 64 greedy decode steps behind it
    s = toks.shape[0]
    caches = init_caches(cfg, 1, 2048)
    t_pre = time_fn(lambda: prefill(params, cfg, toks[None], caches), reps=3)

    def decode():
        c = init_caches(cfg, 1, 2048)
        jax.block_until_ready(c)
        first = jnp.zeros((1,), jnp.int32)
        t = time.perf_counter()
        jax.block_until_ready(decode_loop(params, cfg, first, jnp.int32(s),
                                          c, 64))
        return time.perf_counter() - t

    decode()
    t_dec = min(decode() for _ in range(3)) / 63
    log(f"  smoke reading: {SERVE_MODEL} W8A16 prefill S={s} "
        f"{t_pre * 1e3:.2f} ms, decode b=1 {t_dec * 1e3:.3f} ms/step")


# ---- four cards: tensor-parallel llama2-70b widths -------------------------


def phase_four_cards(seed: int, layers: int) -> None:
    from eetq_tpu.dist.sharding import make_forward_fn, make_mesh, shard_model
    from eetq_tpu.models import PRESETS, init_caches, random_dense_params
    from eetq_tpu.serve import Engine
    from eetq_tpu.surgery.tp_reshard import quantize_params_tp

    full = PRESETS[TP_MODEL]
    mesh = make_mesh(tp=4)
    cfg = dataclasses.replace(full, num_layers=layers)
    log(f"  {TP_MODEL} widths, {layers} of {full.num_layers} layers (cut "
        f"for run time: compilation grows with the unrolled layer count)")
    t0 = time.perf_counter()
    dense = random_dense_params(cfg, jax.random.PRNGKey(seed))
    model = shard_model(dense, cfg, mesh, quantize=True)
    del dense
    gc.collect()
    log(f"  built and sharded W8A16 over 4 cards in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (50, 200, 500)]
    eng = Engine(model, max_batch=4, max_len=1024, prompt_buckets=(64, 512))
    t0 = time.perf_counter()
    outs = eng.generate_all(prompts, max_new_tokens=16)
    log(f"  Engine over tp=4 answered {len(outs)} requests in "
        f"{time.perf_counter() - t0:.1f} s (compilation included)")
    for i, o in enumerate(outs):
        if len(o) != 16:
            raise AssertionError(f"request {i}: {len(o)} tokens != 16")
    del eng, model
    gc.collect()

    # the same widths cut to 2 layers: sharded over 4 cards against the
    # unsharded model on card 0, with the same integer weights and scales
    # (shard_model quantizes each shard exactly as quantize_params_tp does)
    cfg2 = dataclasses.replace(full, num_layers=2)
    dense = random_dense_params(cfg2, jax.random.PRNGKey(seed))
    sharded = shard_model(dense, cfg2, mesh, quantize=True)
    single = jax.device_put(quantize_params_tp(dense, cfg2, tp=4),
                            jax.devices()[0])
    del dense
    prompt = prompts[2]
    toks = jnp.asarray(prompt, jnp.int32)[None]
    pos = jnp.arange(toks.shape[1], dtype=jnp.int32)[None]
    got, _ = make_forward_fn(sharded)(
        sharded.params, toks, pos, init_caches(cfg2, 1, 1024), jnp.int32(0))
    fwd = jax.jit(_model_logits(single, cfg2))
    logit_agreement("tp=4 vs one card, 2 layers", np.asarray(got)[0],
                    fwd(single, toks)[0])
    kw = dict(max_batch=1, max_len=1024, prompt_buckets=(512,))
    g_sh = Engine(sharded, **kw).generate_all([prompt], 16)[0]
    g_one = Engine(single, cfg2, **kw).generate_all([prompt], 16)[0]
    check_greedy("tp=4 greedy vs one card", single, prompt, g_sh, g_one, fwd)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the tensor-parallel path on four cards")
    ap.add_argument("--layers", type=int, default=8,
                    help="llama2-70b layers served with --four-cards")
    args = ap.parse_args()

    devs = require_gpu()
    from eetq_tpu.utils.compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    log("phase 1: device")
    phase_device(devs)
    if args.four_cards:
        if len(devs) < 4:
            raise SystemExit(f"--four-cards needs 4 GPUs, found {len(devs)}")
        log("four cards: tensor-parallel serving")
        phase_four_cards(args.seed, args.layers)
    else:
        log(f"phase 2: ops at {SERVE_MODEL} widths vs float32 references")
        phase_ops(args.seed)
        log(f"phase 3: serve {SERVE_MODEL} W8A16 over HTTP")
        phase_serve(args.seed)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)


if __name__ == "__main__":
    main()
