"""Continuous-batching engine tests: lock-step decode with mixed prompt
lengths/budgets must reproduce the standalone generate() outputs exactly
(same kernels, per-row positions/masks), and slots must recycle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from eetq_tpu.models import ModelConfig, quantize_params, random_dense_params
from eetq_tpu.serve.engine import Engine
from eetq_tpu.serve.generate import greedy_generate

CFG = ModelConfig(
    vocab_size=128,
    hidden_size=64,
    intermediate_size=128,
    num_layers=2,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    max_position=128,
)


@pytest.fixture(scope="module")
def params():
    return quantize_params(
        random_dense_params(CFG, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    )


def _ref_greedy(params, prompt, n):
    out = greedy_generate(
        params, CFG, jnp.asarray(np.asarray(prompt, np.int32)[None]), n
    )
    return [int(t) for t in np.asarray(out[0])]


def test_single_request_matches_generate(params):
    prompt = [3, 17, 42, 9]
    eng = Engine(params, CFG, max_batch=4, max_len=64, prompt_buckets=(8, 16))
    uid = eng.add_request(prompt, max_new_tokens=8)
    eng.run()
    assert eng.result(uid) == _ref_greedy(params, prompt, 8)


def test_mixed_lengths_and_budgets(params):
    prompts = [[5, 6, 7], [11] * 10, [1, 2], [99, 42, 7, 7, 7, 7]]
    budgets = [6, 3, 9, 5]
    eng = Engine(params, CFG, max_batch=4, max_len=64, prompt_buckets=(4, 16))
    uids = [eng.add_request(p, n) for p, n in zip(prompts, budgets)]
    eng.run()
    for uid, p, n in zip(uids, prompts, budgets):
        assert eng.result(uid) == _ref_greedy(params, p, n), (p, n)


def test_more_requests_than_slots_recycles(params):
    """8 requests through 2 slots: continuous batching must admit new
    requests as slots free up and produce exact per-request outputs."""
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, CFG.vocab_size, size=rng.integers(2, 12)))
               for _ in range(8)]
    eng = Engine(params, CFG, max_batch=2, max_len=64, prompt_buckets=(16,))
    uids = [eng.add_request(p, 5) for p in prompts]
    eng.run()
    for uid, p in zip(uids, prompts):
        assert eng.result(uid) == _ref_greedy(params, p, 5)


def test_late_arrival(params):
    """A request added mid-flight joins the running batch."""
    eng = Engine(params, CFG, max_batch=4, max_len=64, prompt_buckets=(8,))
    u1 = eng.add_request([4, 8, 15], max_new_tokens=10)
    for _ in range(4):
        eng.step()
    u2 = eng.add_request([16, 23, 42], max_new_tokens=6)
    eng.run()
    assert eng.result(u1) == _ref_greedy(params, [4, 8, 15], 10)
    assert eng.result(u2) == _ref_greedy(params, [16, 23, 42], 6)


def test_eos_frees_slot(params):
    prompt = [3, 17, 42, 9]
    full = _ref_greedy(params, prompt, 8)
    eos = full[3]  # force an early stop (at its FIRST occurrence)
    stop = full.index(eos) + 1
    eng = Engine(params, CFG, max_batch=1, max_len=64, prompt_buckets=(8,))
    uid = eng.add_request(prompt, max_new_tokens=8, eos_token_id=eos)
    eng.run()
    assert eng.result(uid) == full[:stop]
    assert not eng.has_work


def test_many_kv_heads_small_bucket():
    """Regression: _insert_rows must slice the SEQUENCE axis of the
    [B, H, L, D] cache, not the head axis. With num_kv_heads (8) larger than
    the prompt bucket (4), a head-axis slice silently drops heads >= 4 from
    the prefilled cache and diverges from greedy_generate immediately."""
    cfg = ModelConfig(
        vocab_size=128,
        hidden_size=64,
        intermediate_size=128,
        num_layers=2,
        num_heads=8,
        num_kv_heads=8,
        head_dim=8,
        max_position=128,
    )
    p = quantize_params(
        random_dense_params(cfg, jax.random.PRNGKey(1), dtype=jnp.bfloat16)
    )
    prompt = [3, 17, 42]
    eng = Engine(p, cfg, max_batch=2, max_len=64, prompt_buckets=(4, 16))
    uid = eng.add_request(prompt, max_new_tokens=6)
    eng.run()
    ref = greedy_generate(
        p, cfg, jnp.asarray(np.asarray(prompt, np.int32)[None]), 6
    )
    assert eng.result(uid) == [int(t) for t in np.asarray(ref[0])]


def test_overflow_rejected(params):
    eng = Engine(params, CFG, max_batch=1, max_len=32)
    with pytest.raises(ValueError):
        eng.add_request(list(range(1, 30)), max_new_tokens=10)
    with pytest.raises(ValueError):
        eng.add_request([], max_new_tokens=1)


def test_sampled_request_deterministic_seeded(params):
    eng1 = Engine(params, CFG, max_batch=2, max_len=64, seed=7)
    eng2 = Engine(params, CFG, max_batch=2, max_len=64, seed=7)
    for eng in (eng1, eng2):
        eng.add_request([5, 6, 7], 6, temperature=0.8, top_k=20)
    eng1.run()
    eng2.run()
    assert eng1.result(0) == eng2.result(0)
    assert all(0 <= t < CFG.vocab_size for t in eng1.result(0))


def test_sharded_engine_tp(params):
    """Continuous batching over a TP-sharded model: same requests, outputs
    agree with the single-device engine (up to shard_map summation-order
    jitter, which can flip argmax on a random tiny model's sub-1e-2
    margins — allow a small mismatch tail)."""
    import dataclasses

    from eetq_tpu.dist import make_mesh
    from eetq_tpu.models import random_dense_params
    from eetq_tpu.surgery.tp_reshard import quantize_params_tp, shard_quantized

    tp = 2
    if len(jax.devices()) < tp:
        pytest.skip("needs >= 2 devices")
    dense = random_dense_params(CFG, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    qp = quantize_params_tp(dense, CFG, tp=tp)
    mesh = make_mesh(tp=tp, dp=1)
    model = shard_quantized(qp, CFG, mesh)

    prompts = [[5, 6, 7], [11] * 10, [1, 2]]
    eng_sh = Engine(model, max_batch=2, max_len=64, prompt_buckets=(16,))
    outs_sh = eng_sh.generate_all(prompts, max_new_tokens=6)

    eng_local = Engine(qp, CFG, max_batch=2, max_len=64, prompt_buckets=(16,))
    outs_local = eng_local.generate_all(prompts, max_new_tokens=6)

    total = mismatches = 0
    for a, b in zip(outs_sh, outs_local):
        assert len(a) == len(b) == 6
        for x, y in zip(a, b):
            total += 1
            mismatches += x != y
    assert mismatches <= total // 3, (outs_sh, outs_local)


def test_sharded_engine_dp2(params):
    """dp=2 x tp=2 serving: the slot batch shards over the data axis, and
    admission prefills up to dp requests per round (the
    round-1 engine required dp=1)."""
    from eetq_tpu.dist import make_mesh
    from eetq_tpu.models import random_dense_params
    from eetq_tpu.surgery.tp_reshard import quantize_params_tp, shard_quantized

    if len(jax.devices()) < 4:
        pytest.skip("needs >= 4 devices")
    dense = random_dense_params(CFG, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    qp = quantize_params_tp(dense, CFG, tp=2)
    model = shard_quantized(qp, CFG, make_mesh(tp=2, dp=2))

    prompts = [[5, 6, 7], [11] * 10, [1, 2], [9, 9]]
    eng_sh = Engine(model, max_batch=4, max_len=64, prompt_buckets=(16,))
    outs_sh = eng_sh.generate_all(prompts, max_new_tokens=6)

    eng_local = Engine(qp, CFG, max_batch=4, max_len=64, prompt_buckets=(16,))
    outs_local = eng_local.generate_all(prompts, max_new_tokens=6)

    total = mismatches = 0
    for a, b in zip(outs_sh, outs_local):
        assert len(a) == len(b) == 6
        for x, y in zip(a, b):
            total += 1
            mismatches += x != y
    # tiny-random-model argmax margins flip under shard_map summation-order
    # jitter; require broad agreement
    assert mismatches <= total // 3, (outs_sh, outs_local)

    with pytest.raises(ValueError):  # max_batch must divide by dp
        Engine(model, max_batch=3, max_len=64)


def test_multi_step_decode_window(params):
    """decode_window > 1 must produce exactly the same outputs as the
    single-step engine (greedy lock-step scan vs per-step dispatch),
    including eos early-stop and budget edges mid-window."""
    prompts = [[5, 6, 7], [11] * 10, [1, 2]]
    budgets = [6, 9, 5]
    eng1 = Engine(params, CFG, max_batch=4, max_len=64, prompt_buckets=(16,),
                  decode_window=1)
    engw = Engine(params, CFG, max_batch=4, max_len=64, prompt_buckets=(16,),
                  decode_window=4)
    u1 = [eng1.add_request(p, n) for p, n in zip(prompts, budgets)]
    uw = [engw.add_request(p, n) for p, n in zip(prompts, budgets)]
    eng1.run()
    engw.run()
    for a, b in zip(u1, uw):
        assert eng1.result(a) == engw.result(b)

    # eos mid-window
    ref = _ref_greedy(params, [3, 17, 42, 9], 8)
    eos = ref[3]
    stop = ref.index(eos) + 1
    engE = Engine(params, CFG, max_batch=1, max_len=64, prompt_buckets=(8,),
                  decode_window=8)
    uid = engE.add_request([3, 17, 42, 9], max_new_tokens=8, eos_token_id=eos)
    engE.run()
    assert engE.result(uid) == ref[:stop]


def test_warmup_then_serve(params):
    """warmup() pre-compiles the serving programs and leaves no visible
    state: post-warmup results match a cold engine exactly (greedy and
    sampled paths, dense and paged)."""
    for paged in (False, True):
        kw = dict(max_batch=2, max_len=64, prompt_buckets=(8, 16),
                  decode_window=4)
        if paged:
            kw.update(paged_blocks=4, paged_block_size=128)
        cold = Engine(params, CFG, **kw)
        u0 = cold.add_request([3, 17, 42], 7)
        cold.run()

        warm = Engine(params, CFG, **kw)
        warm.warmup()
        assert not warm.has_work and not warm.requests
        u1 = warm.add_request([3, 17, 42], 7)
        warm.run()
        assert warm.result(u1) == cold.result(u0), paged
    # sampled warmup compiles the sampled variants without error
    eng = Engine(params, CFG, max_batch=2, max_len=64, prompt_buckets=(8,),
                 decode_window=4)
    eng.warmup(temperature=0.7)
    u = eng.add_request([5, 6], 5, temperature=0.7, top_k=8)
    eng.run()
    assert len(eng.result(u)) == 5


def test_decode_window_chaining(params):
    """Window CHAINING (r3): when the batch is full, the queue is empty,
    and no active request can hit EOS, step() runs several decode windows
    back-to-back with the carry on device — outputs must be identical to
    the unchained engine, and the chained engine must finish in strictly
    fewer step() calls (proof the chain actually engaged)."""
    prompts = [[5, 6, 7], [11] * 10]
    budgets = [33, 40]  # large budgets so several windows chain

    def run(max_chain):
        eng = Engine(params, CFG, max_batch=2, max_len=64,
                     prompt_buckets=(16,), decode_window=4,
                     max_chain=max_chain)
        uids = [eng.add_request(p, n) for p, n in zip(prompts, budgets)]
        steps = 0
        while eng.has_work:
            eng.step()
            steps += 1
        return [eng.result(u) for u in uids], steps

    ref, steps1 = run(1)
    out, stepsC = run(8)
    assert out == ref
    assert stepsC < steps1, (stepsC, steps1)


def test_chaining_disabled_by_eos_or_queue(params):
    """Chaining preconditions: an EOS-capable request or a non-empty queue
    must fall back to single windows (retirement is not host-predictable),
    and outputs stay exact."""
    ref = _ref_greedy(params, [3, 17, 42, 9], 12)
    eos = ref[5]
    stop = ref.index(eos) + 1
    eng = Engine(params, CFG, max_batch=1, max_len=64, prompt_buckets=(8,),
                 decode_window=4, max_chain=8)
    uid = eng.add_request([3, 17, 42, 9], 12, eos_token_id=eos)
    # queue a second request behind the single slot: also blocks chaining
    uid2 = eng.add_request([1, 2, 3], 5)
    eng.run()
    assert eng.result(uid) == ref[:stop]
    assert eng.result(uid2) == _ref_greedy(params, [1, 2, 3], 5)


def test_chaining_sampled_terminates(params):
    """Sampled slots ride chained windows: correct lengths, valid tokens."""
    eng = Engine(params, CFG, max_batch=2, max_len=64, prompt_buckets=(16,),
                 decode_window=4, max_chain=4, seed=3)
    uids = [eng.add_request([7, 8, 9], 21, temperature=0.8, top_k=20),
            eng.add_request([4] * 6, 25, temperature=0.5, top_k=8)]
    eng.run(max_steps=60)
    for u, n in zip(uids, (21, 25)):
        out = eng.result(u)
        assert len(out) == n
        assert all(0 <= t < CFG.vocab_size for t in out)


def test_a8_prefill_engine(params):
    """Engine with W8A8 prefill completes and stays close to the W8A16
    engine (same decode path; prefill uses int8 activations)."""
    eng16 = Engine(params, CFG, max_batch=2, max_len=64, prompt_buckets=(16,))
    eng8 = Engine(params, CFG, max_batch=2, max_len=64, prompt_buckets=(16,),
                  a8_prefill=True)
    prompts = [[5, 6, 7, 8], [9, 10]]
    o16 = eng16.generate_all(prompts, max_new_tokens=4)
    o8 = eng8.generate_all(prompts, max_new_tokens=4)
    # argmax tokens may differ on a random model's tiny margins; shape and
    # validity must hold, and usually they agree
    for a, b in zip(o16, o8):
        assert len(a) == len(b) == 4
        assert all(0 <= t < CFG.vocab_size for t in b)


def test_batched_local_prefill_rows(params):
    """prefill_rows > 1 on the local backend: several requests admitted in
    one grouped prefill dispatch; outputs identical to single-admission."""
    prompts = [[5, 6, 7], [11] * 10, [1, 2], [9, 9, 9, 9]]
    eng = Engine(params, CFG, max_batch=4, max_len=64, prompt_buckets=(16,),
                 prefill_rows=4)
    outs = eng.generate_all(prompts, max_new_tokens=6)
    for p, got in zip(prompts, outs):
        assert got == _ref_greedy(params, p, 6), (p, got)


def test_chunked_prefill_engine(params):
    """prefill_chunk: long prompts prefill one chunk per scheduler step,
    decode advancing between chunks; outputs identical to the unchunked
    engine and to greedy_generate."""
    rng = np.random.default_rng(3)
    long_prompt = list(rng.integers(1, CFG.vocab_size, size=30))
    short = [5, 6, 7]
    ref_long = _ref_greedy(params, long_prompt, 6)
    ref_short = _ref_greedy(params, short, 8)

    eng = Engine(params, CFG, max_batch=2, max_len=96, prompt_buckets=(8, 32),
                 prefill_chunk=8)
    u_short = eng.add_request(short, 8)
    # let the short one start decoding before the long prompt arrives
    for _ in range(3):
        eng.step()
    u_long = eng.add_request(long_prompt, 6)
    eng.run()
    assert eng.result(u_short) == ref_short
    assert eng.result(u_long) == ref_long


def test_chunked_prefill_not_bypassed_behind_short_prompt(params):
    """A chunk-eligible long prompt QUEUED BEHIND a short one must still
    take the chunked path. Regression: step() only classified the queue
    HEAD, so the grouped-admission loop swallowed the long prompt into one
    full-bucket prefill — stalling every running slot for the whole prompt
    and running a grouped program warmup() never compiled."""
    rng = np.random.default_rng(5)
    long_prompt = list(rng.integers(1, CFG.vocab_size, size=30))
    short = [5, 6, 7]
    eng = Engine(params, CFG, max_batch=4, max_len=96, prompt_buckets=(8, 32),
                 prefill_chunk=8, decode_window=2)
    u1 = eng.add_request(short, 5)
    u2 = eng.add_request(long_prompt, 6)  # behind the short one
    started = []
    orig = eng._start_chunked
    eng._start_chunked = lambda slot, req: (started.append(req), orig(slot, req))[1]
    eng.run()
    assert [r.prompt for r in started] == [long_prompt]
    assert eng.result(u1) == _ref_greedy(params, short, 5)
    assert eng.result(u2) == _ref_greedy(params, long_prompt, 6)


def test_chunked_prefill_engine_interleaves(params):
    """The long prompt must NOT stall the running slot: its decode count
    grows while the chunked prefill is in flight."""
    rng = np.random.default_rng(4)
    long_prompt = list(rng.integers(1, CFG.vocab_size, size=31))
    eng = Engine(params, CFG, max_batch=2, max_len=96, prompt_buckets=(8, 32),
                 prefill_chunk=8, decode_window=1)
    u_short = eng.add_request([5, 6, 7], 12)
    eng.step()  # prefill short
    u_long = eng.add_request(long_prompt, 4)
    progressed = []
    for _ in range(4):  # 4 chunks of the long prefill
        before = len(eng.requests[u_short].out_tokens)
        eng.step()
        progressed.append(len(eng.requests[u_short].out_tokens) > before)
    # decode advanced during every chunked-prefill step
    assert all(progressed), progressed
    eng.run()
    assert eng.result(u_long) == _ref_greedy(params, long_prompt, 4)


def test_prompt_longer_than_largest_bucket(params):
    """max_len > max(prompt_buckets): add_request accepts prompts longer
    than the largest bucket (_bucket_for returns max_len), so the shared
    prefill scratch must grow past max(buckets) instead of crashing at
    trace time (round-2 advisor regression). Covers both the plain-prefill
    and chunked-prefill paths."""
    long_prompt = list(np.random.default_rng(7).integers(1, CFG.vocab_size,
                                                         size=40))
    ref = _ref_greedy(params, long_prompt, 5)
    # plain prefill path: bucket = max_len = 96 > max(buckets) = 16
    eng = Engine(params, CFG, max_batch=2, max_len=96, prompt_buckets=(8, 16))
    short_uid = eng.add_request([3, 4, 5], 4)  # small-bucket prefill first
    eng.step()
    uid = eng.add_request(long_prompt, 5)
    eng.run()
    assert eng.result(uid) == ref
    assert eng.result(short_uid) == _ref_greedy(params, [3, 4, 5], 4)
    # chunked prefill path (bucket=max_len=96, chunk=8 divides it)
    eng = Engine(params, CFG, max_batch=2, max_len=96, prompt_buckets=(8, 16),
                 prefill_chunk=8)
    uid = eng.add_request(long_prompt, 5)
    eng.run()
    assert eng.result(uid) == ref


def test_sampled_window_topk1_matches_greedy(params):
    """Sampled slots now ride the multi-step window (device-side per-slot
    PRNG/temperature/top-k in the scan). top_k=1 keeps only the argmax
    token, so a sampled request with top_k=1 must reproduce the greedy
    reference exactly — a sharp end-to-end check of the in-scan top-k
    threshold — while a greedy slot in the SAME window stays exact."""
    prompts = [[5, 6, 7], [11] * 10]
    ref = [_ref_greedy(params, p, 8) for p in prompts]
    eng = Engine(params, CFG, max_batch=2, max_len=64, prompt_buckets=(16,),
                 decode_window=4)
    u_sampled = eng.add_request(prompts[0], 8, temperature=0.9, top_k=1)
    u_greedy = eng.add_request(prompts[1], 8)
    eng.run()
    assert eng.result(u_sampled) == ref[0]
    assert eng.result(u_greedy) == ref[1]


def test_sampled_window_deterministic_and_valid(params):
    """Same-seed engines with a windowed sampled request agree run-to-run,
    and mixed greedy slots in the window still match the reference."""
    greedy_ref = _ref_greedy(params, [1, 2], 10)
    outs = []
    for _ in range(2):
        eng = Engine(params, CFG, max_batch=2, max_len=64,
                     prompt_buckets=(16,), decode_window=4, seed=11)
        us = eng.add_request([5, 6, 7], 10, temperature=0.8, top_k=20)
        ug = eng.add_request([1, 2], 10)
        eng.run()
        assert eng.result(ug) == greedy_ref
        assert all(0 <= t < CFG.vocab_size for t in eng.result(us))
        outs.append(eng.result(us))
    assert outs[0] == outs[1]


def test_topk_cap_validation(params):
    eng = Engine(params, CFG, max_batch=1, max_len=64, topk_cap=8)
    with pytest.raises(ValueError):
        eng.add_request([1, 2], 4, temperature=0.7, top_k=9)
    # top_k >= vocab is a no-op filter, accepted and treated as 0
    uid = eng.add_request([1, 2], 4, temperature=0.7, top_k=CFG.vocab_size)
    eng.run()
    assert len(eng.result(uid)) == 4


# ---- speculative (n-gram) decode windows ---------------------------------


def test_spec_engine_single_matches_generate(params):
    """spec_ngram engine output is token-for-token the greedy reference
    (acceptance only changes speed, never tokens)."""
    prompt = [3, 17, 42, 9, 3, 17]  # repeated bigram: some drafts accept
    eng = Engine(params, CFG, max_batch=2, max_len=64, prompt_buckets=(8,),
                 decode_window=4, spec_ngram=3)
    uid = eng.add_request(prompt, max_new_tokens=12)
    eng.run()
    assert eng.result(uid) == _ref_greedy(params, prompt, 12)


def test_spec_engine_mixed_lengths_recycles(params):
    """Continuous batching with spec windows: mixed prompts/budgets through
    fewer slots than requests, exact per-request outputs."""
    prompts = [[5, 6, 7], [11] * 10, [1, 2], [99, 42, 7, 7, 7, 7],
               [2, 4, 6, 8], [13, 13, 13]]
    budgets = [6, 3, 9, 5, 7, 4]
    eng = Engine(params, CFG, max_batch=2, max_len=64,
                 prompt_buckets=(4, 16), decode_window=4, spec_ngram=3)
    uids = [eng.add_request(p, n) for p, n in zip(prompts, budgets)]
    eng.run()
    for uid, p, n in zip(uids, prompts, budgets):
        assert eng.result(uid) == _ref_greedy(params, p, n), (p, n)


def test_spec_engine_eos_mid_window(params):
    """EOS inside a speculative window retires the slot and truncates the
    committed tokens exactly like the plain window."""
    prompt = [3, 17, 42]
    full = _ref_greedy(params, prompt, 12)
    eos = full[4]  # stop at the 5th generated token
    eng = Engine(params, CFG, max_batch=1, max_len=64, prompt_buckets=(8,),
                 decode_window=4, spec_ngram=3)
    uid = eng.add_request(prompt, max_new_tokens=12, eos_token_id=eos)
    eng.run()
    assert eng.result(uid) == full[:5]


def test_spec_engine_exact_at_cache_brim(params):
    """A request that fills the cache to the BRIM stays greedy-exact under
    spec windows. Regression: the n-gram verify writes k+1 draft KV
    entries at lengths+m; without the engine's spec KV slack
    (_kv_len > max_len) those writes clamp (dynamic_update_slice) onto
    committed KV near max_len and corrupt the attention reads — r5 review
    reproduced divergence at token 116/120 with max_len=128, k=7."""
    prompt = [3, 17, 42, 9, 3, 17, 42, 11]
    budget = 120  # prompt + budget == max_len: zero slack in max_len itself
    eng = Engine(params, CFG, max_batch=1, max_len=128, prompt_buckets=(8,),
                 decode_window=8, spec_ngram=7)
    uid = eng.add_request(prompt, max_new_tokens=budget)
    eng.run()
    assert eng.result(uid) == _ref_greedy(params, prompt, budget)


def test_spec_engine_paged_exact_at_cache_brim(params):
    """Same brim regression through the PAGED path: the per-row block
    tables must cover the draft overshoot (lengths + window + k + 1) —
    _max_seq_blocks is sized from _kv_len, not max_len."""
    prompt = [3, 17, 42, 9, 3, 17, 42, 11]
    budget = 120
    eng = Engine(params, CFG, max_batch=1, max_len=128, prompt_buckets=(8,),
                 decode_window=8, spec_ngram=7, paged_blocks=8,
                 paged_block_size=128)
    uid = eng.add_request(prompt, max_new_tokens=budget)
    eng.run()
    assert eng.result(uid) == _ref_greedy(params, prompt, budget)


def test_spec_engine_validation(params):
    with pytest.raises(ValueError):
        Engine(params, CFG, max_batch=1, max_len=64, spec_ngram=9)
    # sampled requests are ACCEPTED by spec engines since r5 (positional
    # target sampling); the static top_k cap still applies
    eng = Engine(params, CFG, max_batch=1, max_len=64, spec_ngram=3,
                 topk_cap=8)
    with pytest.raises(ValueError):
        eng.add_request([1, 2], 4, temperature=0.7, top_k=9)


def test_spec_engine_sampled_window_invariance(params):
    """Sampled requests in a spec engine (r5): target tokens are drawn
    with per-request POSITIONAL keys, so a request's sampled stream is
    IDENTICAL across engines that differ only in decode_window — and
    greedy requests in the same mixed batch still match the greedy
    reference exactly."""
    prompts = [[3, 17, 42, 9, 3, 17], [11] * 8]
    kw = [dict(temperature=0.8, top_k=8), dict()]  # sampled + greedy

    def run(window):
        eng = Engine(params, CFG, max_batch=2, max_len=64,
                     prompt_buckets=(8,), decode_window=window, spec_ngram=3,
                     seed=5)
        uids = [eng.add_request(p, 10, **k) for p, k in zip(prompts, kw)]
        eng.run()
        return [eng.result(u) for u in uids]

    a = run(3)
    b = run(5)
    assert a == b, (a, b)
    # greedy row unchanged by the sampled neighbor
    assert a[1] == _ref_greedy(params, prompts[1], 10)
    # sampled row actually sampled (differs from its greedy decode)
    assert a[0] != _ref_greedy(params, prompts[0], 10)


def test_spec_engine_sampled_seed_and_topk(params):
    """Different seeds give different sampled spec streams; top_k respects
    the engine's static cap validation."""
    prompt = [3, 17, 42, 9]
    outs = []
    for seed in (0, 1):
        eng = Engine(params, CFG, max_batch=1, max_len=64,
                     prompt_buckets=(8,), decode_window=4, spec_ngram=3,
                     seed=seed)
        u = eng.add_request(prompt, 12, temperature=1.0, top_k=8)
        eng.run()
        outs.append(eng.result(u))
    assert outs[0] != outs[1]
    eng = Engine(params, CFG, max_batch=1, max_len=64, spec_ngram=3)
    with pytest.raises(ValueError):
        eng.add_request(prompt, 4, temperature=0.7,
                        top_k=eng.topk_cap + 1)


def test_spec_engine_sharded_backend(params):
    """spec × sharded backend (r5): the n-gram speculative window runs as
    a shard_map'd while_loop over the (data, model) mesh
    (dist.sharding.make_spec_window_fn). Outputs must agree with the
    plain (non-spec) engine on the SAME sharded model — identical TP
    numerics up to the verify-vs-sequential matmul-shape summation
    jitter, which can flip argmax on a random tiny model's margins."""
    from eetq_tpu.dist import make_mesh
    from eetq_tpu.models import random_dense_params
    from eetq_tpu.surgery.tp_reshard import quantize_params_tp, shard_quantized

    tp = 2
    if len(jax.devices()) < tp:
        pytest.skip("needs >= 2 devices")
    dense = random_dense_params(CFG, jax.random.PRNGKey(0), dtype=jnp.bfloat16)
    qp = quantize_params_tp(dense, CFG, tp=tp)
    mesh = make_mesh(tp=tp, dp=1)
    model = shard_quantized(qp, CFG, mesh)

    prompts = [[3, 17, 42, 9, 3, 17], [11] * 10, [5, 6, 7]]
    eng_spec = Engine(model, max_batch=2, max_len=64, prompt_buckets=(16,),
                      decode_window=4, spec_ngram=3)
    outs_spec = eng_spec.generate_all(prompts, max_new_tokens=6)

    model2 = shard_quantized(qp, CFG, mesh)
    eng_plain = Engine(model2, max_batch=2, max_len=64, prompt_buckets=(16,),
                       decode_window=4)
    outs_plain = eng_plain.generate_all(prompts, max_new_tokens=6)

    total = mismatches = 0
    for a, b in zip(outs_spec, outs_plain):
        assert len(a) == len(b) == 6
        for x, y in zip(a, b):
            total += 1
            mismatches += x != y
    assert mismatches <= total // 3, (outs_spec, outs_plain)


def test_spec_engine_paged_matches_generate(params):
    """spec × paged KV (r5): the speculative window's verify rides the
    multi-query PAGED attention path (writes through the block table,
    per-row causal attention over pool blocks) and stays token-for-token
    greedy-exact — including slot recycling through the block allocator."""
    prompts = [[3, 17, 42, 9, 3, 17], [11] * 10, [5, 6, 7], [2, 4, 6, 8]]
    budgets = [12, 5, 8, 6]
    eng = Engine(params, CFG, max_batch=2, max_len=64,
                 prompt_buckets=(4, 16), decode_window=4, spec_ngram=3,
                 paged_blocks=12, paged_block_size=128)
    uids = [eng.add_request(p, n) for p, n in zip(prompts, budgets)]
    eng.run()
    for uid, p, n in zip(uids, prompts, budgets):
        assert eng.result(uid) == _ref_greedy(params, p, n), (p, n)


def test_spec_engine_streaming_poll(params):
    """poll() sees spec-window token bursts and concatenates exactly."""
    eng = Engine(params, CFG, max_batch=1, max_len=64, prompt_buckets=(8,),
                 decode_window=4, spec_ngram=3)
    uid = eng.add_request([3, 17, 42, 9], max_new_tokens=10)
    got, done = [], False
    while eng.has_work:
        eng.step()
        new, done = eng.poll(uid)
        got.extend(new)
    assert done and got == _ref_greedy(params, [3, 17, 42, 9], 10)
