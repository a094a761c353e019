"""The port's generation and serving (tpudist_torch.generate,
tpudist_torch.serve) against the JAX reference and against itself.

- greedy ``generate()`` tokens equal JAX ``generate()`` on the same
  weights (f32), through the dense path and the decode kernels' CPU path;
- the paged engine with ``attn_impl="fused"`` (the paged kernel's CPU
  path) streams exactly JAX's paged kernel engine's greedy tokens;
- the port's engine equals the port's ``generate()`` (the reference's
  bit-identity bar), contiguous and paged, under staggered arrivals, slot
  pressure, stop tokens and a preemption/replay cycle;
- scheduler units mirrored from tests/test_serve.py and
  tests/test_serve_paged.py;
- the sampling-stream contract: a slot's gumbel field depends only on
  ``(seed, request_id, token_index)``.

JAX's compile-count pins have no PyTorch counterpart (eager execution).
"""

import collections
import json

import jax
import numpy as np
import pytest
import torch
from flax.core import meta

from tpudist.generate import generate as jax_generate
from tpudist.models.gpt2 import GPT2 as JGPT2
from tpudist.serve import ServeEngine as JServeEngine
from tpudist_torch.generate import (
    generate, gumbel_field, row_keys, sample_logits, sample_logits_per_row,
)
from tpudist_torch.interop import gpt2_params_from_flax
from tpudist_torch.models.gpt2 import GPT2
from tpudist_torch.serve import (
    BlockPool, PagedSlotPool, Prefiller, PrefixCache, QueueFull, ServeEngine,
    SlotPool,
)
from tpudist_torch.serve.blocks import GARBAGE_BLOCK
from tpudist_torch.serve.engine import Request
from tpudist_torch.telemetry import TelemetrySink
from torch_threads import two_torch_threads  # noqa: F401

GEOM = dict(vocab_size=64, max_seq_len=64, hidden_dim=32, depth=2, num_heads=4)


def _flax_params(seed):
    params = JGPT2(**GEOM).init(
        jax.random.key(seed), np.zeros((1, 8), np.int32), train=False
    )["params"]
    return jax.tree_util.tree_map(np.asarray, meta.unbox(params))


def _model(seed=0, attn_impl="xla", max_seq_len=64):
    geom = dict(GEOM, max_seq_len=max_seq_len)
    return GPT2(**geom, attn_impl=attn_impl, device="cpu", seed=seed)


def _converted(params, attn_impl="xla"):
    m = GPT2(**GEOM, attn_impl=attn_impl, device="cpu")
    m.load_state_dict(gpt2_params_from_flax(params))
    return m


def _prompts(lens, vocab=64, seed=0):
    rng = np.random.Generator(np.random.PCG64(seed))
    return [rng.integers(0, vocab, (p,)).astype(np.int32) for p in lens]


def _pool_clean(engine):
    pool = engine.pool.blocks
    held = np.nonzero(pool.refcount > 0)[0]
    cached = (set() if engine.pool.prefix is None else
              {e.block for e in engine.pool.prefix._entries.values()})
    assert set(held.tolist()) == cached
    assert all(pool.refcount[b] == 1 for b in cached)


# ---------------------------------------------------------------------------
# against the JAX reference


@pytest.mark.parametrize("attn_impl", ["xla", "fused"])
def test_greedy_generate_matches_jax(attn_impl):
    params = _flax_params(1)
    prompts = np.stack(_prompts([6, 6, 6], seed=1))
    want = jax_generate(JGPT2(**GEOM, attn_impl=attn_impl), params, prompts,
                        10, temperature=0.0)
    got = generate(_converted(params, attn_impl), prompts, 10, temperature=0.0)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_greedy_generate_eos_lengths_match_jax():
    params = _flax_params(2)
    pr = _prompts([5], seed=3)[0][None]
    probe = jax_generate(JGPT2(**GEOM), params, pr, 4, temperature=0.0)
    eos = int(probe[0, 2])
    want, wl = jax_generate(JGPT2(**GEOM), params, pr, 8, temperature=0.0,
                            eos_id=eos, return_lengths=True)
    got, gl = generate(_converted(params), pr, 8, temperature=0.0,
                       eos_id=eos, return_lengths=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(gl, np.asarray(wl))


def test_paged_kernel_engine_greedy_matches_jax_engine():
    """Mirrors tests/test_serve_paged.py::test_paged_kernel_engine_greedy_
    matches_static on both sides: the paged engine over the paged kernel
    (Pallas interpret mode / the port's plain version) on converted
    weights — the streams are identical."""
    params = _flax_params(1)
    prompts = _prompts([5, 9, 12], seed=6)
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, params)
    jeng = JServeEngine(JGPT2(**GEOM, attn_impl="fused"), jparams,
                        max_slots=3, seed=0, paged=True, block_size=8,
                        watermark_blocks=2)
    jr = [jeng.submit(p, 8) for p in prompts]
    jout = jeng.run()
    peng = ServeEngine(_converted(params, "fused"), max_slots=3, seed=0,
                       paged=True, block_size=8, watermark_blocks=2)
    pr = [peng.submit(p, 8) for p in prompts]
    pout = peng.run()
    for a, b in zip(jr, pr):
        assert pout[b] == jout[a]
    _pool_clean(peng)


# ---------------------------------------------------------------------------
# engine == generate (the reference's bit-identity bar)


@pytest.mark.parametrize("paged", [False, True])
def test_greedy_engine_matches_generate_under_slot_pressure(paged):
    model = _model(1, "fused")
    prompts = np.stack(_prompts([6, 6, 6, 6], seed=1))
    static = generate(model, prompts, 10, temperature=0.0)
    kw = dict(paged=True, block_size=8, watermark_blocks=2) if paged else {}
    eng = ServeEngine(model, max_slots=2, seed=0, **kw)
    rids = [eng.submit(prompts[i], 10) for i in range(2)]
    for _ in range(3):  # staggered arrivals mid-decode
        eng.step()
    rids += [eng.submit(prompts[i], 10) for i in (2, 3)]
    out = eng.run()
    for i in range(4):
        np.testing.assert_array_equal(out[rids[i]], static[i])
    if paged:
        _pool_clean(eng)


def test_paged_mixed_lengths_eos_sweep():
    model = _model(2, "fused")
    prompts = _prompts([3, 6, 5, 9, 12, 17], seed=3)
    eos = 7
    oracle = {}
    for i, pr in enumerate(prompts):
        toks, lens = generate(model, pr[None], 12, temperature=0.0,
                              eos_id=eos, return_lengths=True)
        oracle[i] = toks[0, : lens[0]].tolist()
    eng = ServeEngine(model, max_slots=3, seed=0, paged=True, block_size=8,
                      watermark_blocks=2)
    rids = [eng.submit(prompts[i], 12, eos_id=eos) for i in range(3)]
    for _ in range(2):
        eng.step()
    rids += [eng.submit(prompts[i], 12, eos_id=eos) for i in (3, 4, 5)]
    out = eng.run()
    for i in range(6):
        assert out[rids[i]] == oracle[i], i
    _pool_clean(eng)


def test_paged_eviction_cycle_bit_identical():
    """A pool sized so mid-decode growth runs it dry: a slot is preempted
    to the queue and replayed, and every greedy stream still equals
    generate()."""
    model = _model(1, "fused")
    prompts = _prompts([6, 6, 6], seed=5)
    static = {i: generate(model, p[None], 12, temperature=0.0)[0].tolist()
              for i, p in enumerate(prompts)}
    eng = ServeEngine(model, max_slots=3, seed=0, paged=True, block_size=8,
                      n_blocks=8, watermark_blocks=0, prefix_cache=False)
    rids = [eng.submit(p, 12) for p in prompts]
    out = eng.run()
    for i in range(3):
        assert out[rids[i]] == static[i], i
    assert eng.stats.preemptions > 0
    assert eng.pool.blocks.n_free == eng.pool.blocks.n_usable
    _pool_clean(eng)


def test_prefix_hit_cow_matches_cold_runs():
    """Two requests sharing a 24-token system prompt: the second admission
    hits the prefix cache, maps the shared blocks (not copies), and its
    tokens equal a cold generate()."""
    model = _model(1, "fused")
    system = _prompts([24], seed=9)[0]
    full = [np.concatenate([system, t]) for t in _prompts([4, 7], seed=11)]
    cold = {i: generate(model, p[None], 8, temperature=0.0)[0].tolist()
            for i, p in enumerate(full)}
    eng = ServeEngine(model, max_slots=4, seed=0, paged=True, block_size=8,
                      watermark_blocks=2)
    r0 = eng.submit(full[0], 8)
    out0 = eng.run()
    assert len(eng.pool.prefix) == 3
    r1 = eng.submit(full[1], 8)
    eng._admit()
    slot = int(np.nonzero(eng.pool.active)[0][0])
    cached = {e.block for e in eng.pool.prefix._entries.values()}
    mapped = set(eng.pool.tables[slot][: int(eng.pool.fill[slot])].tolist())
    assert len(cached & mapped) == 3
    out1 = eng.run()
    assert out0[r0] == cold[0] and out1[r1] == cold[1]
    assert eng.stats.prefix_hit_rate > 0
    _pool_clean(eng)


def test_full_hit_replay_resumes_without_prefill():
    model = _model(1, "fused")
    prompt = _prompts([16], seed=11)[0]
    static = generate(model, prompt[None], 12, temperature=0.0)[0].tolist()
    eng = ServeEngine(model, max_slots=2, seed=0, paged=True, block_size=8)
    warm = eng.submit(np.concatenate([prompt, np.asarray(static[:8], np.int32)]), 2)
    eng.run()
    assert len(eng.result(warm)) == 2
    rid = eng._next_id
    eng._next_id += 1
    req = Request(rid, prompt, 12, replay_tokens=tuple(static[:9]))
    eng._lanes.setdefault(0, collections.deque()).append(req)
    eng._counts[rid] = 9
    eng._live_toks[rid] = list(static[:9])
    eng._results[rid] = list(static[:9])
    eng.stats.on_submit(rid)
    eng._t_submit[rid] = eng.stats._clock()
    assert eng.run()[rid] == static
    _pool_clean(eng)


# ---------------------------------------------------------------------------
# scheduler units


def test_admission_respects_max_active():
    eng = ServeEngine(_model(), max_slots=4, max_active=2)
    for pr in _prompts([4] * 4):
        eng.submit(pr, 6)
    seen = []
    while eng.pending:
        eng.step()
        seen.append(eng.pool.n_active)
    assert max(seen) == 2 and eng.pool.n_free == 4


def test_queue_overflow_raises():
    eng = ServeEngine(_model(), max_slots=1, max_queue=2)
    pr = _prompts([4])[0]
    eng.submit(pr, 4)
    eng.submit(pr, 4)
    with pytest.raises(QueueFull, match="max_queue"):
        eng.submit(pr, 4)
    eng.run()
    eng.submit(pr, 4)


def test_slot_reuse_recycles_released_slots():
    eng = ServeEngine(_model(), max_slots=2)
    rids = [eng.submit(pr, 5) for pr in _prompts([4] * 6, seed=5)]
    out = eng.run()
    assert all(len(out[r]) == 5 for r in rids)
    assert eng.pool.n_active == 0 and eng.pool.n_free == 2
    assert (eng.pool.positions == 0).all()


def test_stop_token_frees_slot_for_queued_request():
    model = _model(4)
    prompts = _prompts([5, 5], seed=6)
    eos = int(generate(model, prompts[0][None], 2, temperature=0.0)[0, 1])
    eng = ServeEngine(model, max_slots=1)
    early = eng.submit(prompts[0], 10, eos_id=eos)
    later = eng.submit(prompts[1], 4)
    out = eng.run()
    assert out[early][-1] == eos and len(out[early]) <= 2
    assert len(out[later]) == 4


def test_budget_one_finishes_at_admission():
    eng = ServeEngine(_model(), max_slots=2)
    a = eng.submit(_prompts([4])[0], 3)
    b = eng.submit(_prompts([4], seed=9)[0], 1)
    events = eng.step()
    done_now = [e for e in events if e.request_id == b]
    assert done_now and done_now[-1].done and eng.pool.n_active == 1
    out = eng.run()
    assert len(out[a]) == 3 and len(out[b]) == 1


def test_streaming_callback_sees_every_token_in_order():
    got = []
    eng = ServeEngine(_model(), max_slots=2, on_token=got.append)
    rids = [eng.submit(pr, 4) for pr in _prompts([4, 4, 4], seed=7)]
    out = eng.run()
    for r in rids:
        stream = [e for e in got if e.request_id == r]
        assert [e.index for e in stream] == list(range(len(out[r])))
        assert [e.token for e in stream] == out[r]
        assert [e.done for e in stream] == [False] * (len(stream) - 1) + [True]


def test_submit_validates_kv_fit():
    eng = ServeEngine(_model(max_seq_len=16), max_slots=1)
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit(_prompts([10])[0], 8)
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(_prompts([4])[0], 0)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(np.zeros((0,), np.int32), 4)
    paged = ServeEngine(_model(), max_slots=2, paged=True, block_size=8,
                        n_blocks=4)
    with pytest.raises(ValueError, match="raise n_blocks"):
        paged.submit(_prompts([20])[0], 10)


def test_delayed_pipeline_runs_one_step_behind():
    eng = ServeEngine(_model(), max_slots=1)
    rid = eng.submit(_prompts([4])[0], 3)
    assert [e.index for e in eng.step()] == [0]
    assert eng._inflight is not None
    assert [e.index for e in eng.step()] == [1]
    out = eng.run()
    assert len(out[rid]) == 3 and eng._inflight is None and not eng.pending


def test_streaming_mode_drops_completed_state():
    got = {}
    eng = ServeEngine(
        _model(), max_slots=2, retain_results=False,
        on_token=lambda ev: got.setdefault(ev.request_id, []).append(ev.token),
    )
    oracle = ServeEngine(_model(), max_slots=2)
    rids = [eng.submit(pr, 4) for pr in _prompts([4, 4, 4], seed=7)]
    oids = [oracle.submit(pr, 4) for pr in _prompts([4, 4, 4], seed=7)]
    assert eng.run() == {}
    want = oracle.run()
    assert not eng._results and not eng._counts
    for r, o in zip(rids, oids):
        assert got[r] == want[o]
        with pytest.raises(KeyError):
            eng.result(r)


def test_block_budget_admission_stalls_then_drains():
    eng = ServeEngine(_model(), max_slots=4, paged=True, block_size=8,
                      n_blocks=6, watermark_blocks=1, prefix_cache=False)
    a = eng.submit(_prompts([10], seed=1)[0], 6)
    b = eng.submit(_prompts([10], seed=2)[0], 6)
    eng.step()
    c = eng.submit(_prompts([16], seed=3)[0], 4)
    while eng.pending:
        eng.step()
    assert {r: len(eng.result(r)) for r in (a, b, c)} == {a: 6, b: 6, c: 4}
    _pool_clean(eng)


def test_idle_pool_waives_watermark():
    eng = ServeEngine(_model(), max_slots=4, paged=True, block_size=8,
                      n_blocks=8, watermark_blocks=6, prefix_cache=False)
    rid = eng.submit(_prompts([10], seed=2)[0], 6)
    assert len(eng.run()[rid]) == 6
    _pool_clean(eng)


def test_priority_lanes_and_ttft_aging():
    t = [0.0]
    clock = lambda: t[0]
    pr = _prompts([4])[0]
    eng = ServeEngine(_model(), max_slots=1, clock=clock)
    eng.submit(pr, 3, priority=0)
    hi = eng.submit(pr, 3, priority=5)
    assert eng._peek_next()[1].request_id == hi
    eng.run()
    eng2 = ServeEngine(_model(), max_slots=1, clock=clock, ttft_slo_s=1.0)
    lo = eng2.submit(pr, 3, priority=0)
    t[0] += 5.0
    eng2.submit(pr, 3, priority=5)
    assert eng2._peek_next()[1].request_id == lo
    eng2.run()


def test_block_pool_refcount_rules():
    pool = BlockPool(6)
    assert pool.n_usable == 5
    b = pool.alloc()
    assert b != GARBAGE_BLOCK and pool.refcount[b] == 1
    pool.incref(b)
    pool.decref(b)
    assert pool.n_free == 4
    pool.decref(b)
    assert pool.n_free == 5
    with pytest.raises(RuntimeError, match="double free"):
        pool.decref(b)
    with pytest.raises(RuntimeError, match="unallocated"):
        pool.incref(b)
    got = [pool.alloc() for _ in range(6)]
    assert got[-1] is None and all(g is not None for g in got[:-1])


def test_prefix_cache_chain_hash_and_lru_leaf_eviction():
    pool = BlockPool(12)
    cache = PrefixCache(pool, block_size=4)
    toks = np.arange(12, dtype=np.int32)
    blocks = [pool.alloc() for _ in range(3)]
    cache.insert(toks, blocks, 0)
    assert cache.lookup(toks, 12) == blocks
    fork = toks.copy()
    fork[5] = 63
    assert cache.lookup(fork, 12) == blocks[:1]
    assert cache.lookup(toks, 11) == blocks[:2]  # capped at the limit
    assert cache.evict(3) == 0  # slots still map every block
    for b in blocks:
        pool.decref(b)
    assert cache.evict(1) == 1  # the chain's tail leaf goes first
    assert cache.lookup(toks, 12) == blocks[:2]
    assert cache.evict(5) == 2
    assert pool.n_free == pool.n_usable


def test_refcount_torture_interleaved_admit_retire_evict():
    eng = ServeEngine(_model(), max_slots=4, paged=True, block_size=8,
                      n_blocks=24, watermark_blocks=1)
    rng = np.random.Generator(np.random.PCG64(42))
    shared = _prompts([16], seed=77)[0]
    for _ in range(40):
        roll = rng.random()
        if roll < 0.5:
            plen = int(rng.integers(3, 20))
            pr = rng.integers(0, 64, (plen,)).astype(np.int32)
            if rng.random() < 0.5:
                pr = np.concatenate([shared, pr])
            try:
                eng.submit(pr, int(rng.integers(1, 12)))
            except ValueError:
                pass
        elif roll < 0.8:
            eng.step()
        else:
            eng.pool.evict_prefix(int(rng.integers(1, 3)))
        pool = eng.pool.blocks
        assert pool.n_free + int((pool.refcount > 0).sum()) == pool.n_usable
    eng.run()
    _pool_clean(eng)
    eng.pool.prefix.evict(10_000)
    assert eng.pool.blocks.n_free == eng.pool.blocks.n_usable


def test_paged_pool_utilization_and_validation():
    model = _model()
    pool = PagedSlotPool(model, 4, n_blocks=9, block_size=8, prefix_cache=False)
    pool.insert(Prefiller(model)(_prompts([48])[0])[0], 48)
    assert pool.utilization == pytest.approx(6 / 8)
    with pytest.raises(ValueError, match="block_size"):
        PagedSlotPool(model, 2, n_blocks=8, block_size=7)
    with pytest.raises(ValueError, match="n_blocks"):
        PagedSlotPool(model, 2, n_blocks=1, block_size=8)


def test_write_slot_touches_only_target_slot():
    model = _model()
    pool = SlotPool(model, 3)
    before = [l["k"].clone() for l in pool.cache["layers"]]
    row, _ = Prefiller(model)(_prompts([5])[0])
    slot = pool.insert(row, 5)
    others = [s for s in range(3) if s != slot]
    for b, layer in zip(before, pool.cache["layers"]):
        assert torch.equal(b[others], layer["k"][others])
    assert pool.positions[slot] == 5 and pool.active[slot]
    pool.release(slot)
    with pytest.raises(RuntimeError, match="twice"):
        pool.release(slot)


def test_prefill_chunk_plan_matches_reference_buckets():
    pf = Prefiller(_model(max_seq_len=256), chunk=64)
    assert pf.chunk_plan(5) == [(5, 8)]
    assert pf.chunk_plan(100) == [(64, 64), (36, 64)]
    assert pf.chunk_plan(130) == [(64, 64), (64, 64), (2, 8)]
    pf2 = Prefiller(_model(max_seq_len=200), chunk=60)
    assert pf2.chunk_plan(199) == [(60, 60), (60, 60), (60, 60), (19, 20)]


def test_multi_chunk_prefill_logits_match_full_forward():
    model = _model(15, max_seq_len=200)
    prompt = _prompts([150], seed=15)[0]
    _, logits = Prefiller(model, chunk=60)(prompt)
    ref = model(torch.from_numpy(prompt[None]).long()).detach()[0, -1]
    np.testing.assert_allclose(logits.numpy(), ref.numpy(), atol=2e-5)


def test_serve_rows_schema_and_pool_fields(tmp_path):
    path = tmp_path / "job_serve_0.jsonl"
    sink = TelemetrySink(path)
    eng = ServeEngine(_model(), max_slots=2, sink=sink, stats_every=1,
                      paged=True, block_size=8)
    system = _prompts([16], seed=6)[0]
    rids = [eng.submit(np.concatenate([system, t]), 4)
            for t in _prompts([3, 5], seed=8)]
    eng.run()
    sink.close()
    rows = [json.loads(l) for l in path.read_text().splitlines()]
    serve = [r for r in rows if r["kind"] == "serve"]
    summary = [r for r in rows if r["kind"] == "serve_summary"]
    assert serve and len(summary) == 1
    for r in serve + summary:
        assert {"v", "t", "rank", "step", "tokens_per_sec", "ttft_p50",
                "tpot_p95", "pool_occupancy", "prefix_hit_rate",
                "preemptions", "queue_p50"} <= set(r)
    s = summary[0]
    assert s["completed"] == 2
    assert s["tokens"] == sum(len(eng.result(r)) for r in rids)
    assert s["pool_occupancy"] is not None and s["preemptions"] == 0


# ---------------------------------------------------------------------------
# sampling


def test_per_row_greedy_matches_scalar_and_filters_per_row():
    rng = np.random.Generator(np.random.PCG64(0))
    logits = torch.from_numpy((rng.standard_normal((5, 48)) * 3).astype(np.float32))
    keys = row_keys(0, torch.arange(5), torch.zeros(5, dtype=torch.long))
    out = sample_logits_per_row(logits, keys, temperature=torch.zeros(5),
                                top_k=torch.zeros(5, dtype=torch.int32),
                                top_p=torch.ones(5))
    assert torch.equal(out, sample_logits(logits, temperature=0.0))
    probs = np.array([0.5, 0.3, 0.15, 0.05])
    logits = torch.from_numpy(np.log(probs).astype(np.float32)).repeat(3, 1)
    temp = torch.tensor([0.0, 5.0, 1.0])
    topk = torch.tensor([0, 2, 0], dtype=torch.int32)
    topp = torch.tensor([1.0, 1.0, 0.7])
    seen = {0: set(), 1: set(), 2: set()}
    for i in range(80):
        keys = row_keys(i, torch.arange(3), torch.zeros(3, dtype=torch.long))
        out = sample_logits_per_row(logits, keys, temperature=temp,
                                    top_k=topk, top_p=topp)
        for r in range(3):
            seen[r].add(int(out[r]))
    assert seen[0] == {0}
    assert seen[1] == {0, 1}
    assert seen[2] <= {0, 1} and len(seen[2]) == 2


def test_gumbel_stream_depends_only_on_seed_request_and_index():
    """The contract that replaces JAX's fold_in keys: a row's field is a
    function of (seed, request_id, token_index) alone — the same in any
    batch position and next to any neighbours — and a change in any of
    the three gives a different field. The noise is standard gumbel."""
    rid = torch.tensor([3, 9, 4])
    idx = torch.tensor([0, 5, 2])
    g = gumbel_field(row_keys(1, rid, idx), 512)
    perm = torch.tensor([2, 0, 1])
    g_perm = gumbel_field(row_keys(1, rid[perm], idx[perm]), 512)
    assert torch.equal(g_perm, g[perm])
    alone = gumbel_field(row_keys(1, rid[1:2], idx[1:2]), 512)
    assert torch.equal(alone[0], g[1])
    for seed, r, i in ((2, 9, 5), (1, 10, 5), (1, 9, 6)):
        other = gumbel_field(row_keys(seed, torch.tensor([r]), torch.tensor([i])), 512)
        assert not torch.equal(other[0], g[1])
    big = gumbel_field(row_keys(0, torch.arange(64), torch.zeros(64, dtype=torch.long)), 4096)
    assert abs(float(big.mean()) - 0.5772) < 0.01  # Euler-Mascheroni
    assert abs(float(big.var()) - np.pi ** 2 / 6) < 0.03


def test_sampled_engine_stream_independent_of_neighbours():
    """A sampled request's stream is the same alone, beside neighbours, and
    admitted late into another slot behind higher-priority traffic: its
    draws key on (seed, request id, token index) only."""
    model = _model(3)
    target, *others = _prompts([5, 7, 6], seed=21)
    kw = dict(temperature=1.0, top_k=20, top_p=0.95)

    def run(max_slots, neighbours, priority=0):
        eng = ServeEngine(model, max_slots=max_slots, seed=4)
        rid = eng.submit(target, 8, priority=0, **kw)  # request id 0
        for pr in neighbours:
            eng.submit(pr, 8, priority=priority, **kw)
        return eng.run()[rid]

    alone = run(3, [])
    assert len(alone) == 8
    assert run(3, others) == alone
    assert run(1, others, priority=5) == alone
