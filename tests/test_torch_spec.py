"""Speculative decoding in the port (tpudist_torch.serve.spec, the
engine's ``draft_model`` path, ``generate.per_row_log_probs``), the
multi-token decode windows it runs, and the telemetry sink's segment
rotation, against the JAX reference on the same inputs (numpy draws from
a seed; flax params carried over by ``interop``), float32 on the CPU.

- ``per_row_log_probs`` against the reference's: f32, 1e-6 absolute;
- ``speculative_accept`` at temperature 0 against the reference's: the
  same ``emit`` and ``n_emit``; the reference's distribution check (b 4000,
  K 2, V 12, T 0.9, top-k 6, top-p 0.92): total variation under 0.03
  against the warped target, some windows longer than one token, and
  ``n_spec = 0`` one plain draw;
- engines: GPT-2 (2 slots, 4 staggered requests, ``spec_k`` 3) equal to the
  port's static ``generate()`` and to the reference's speculative
  engine, with the spec fields on the ``serve`` rows; Llama with a
  per-request stop token equal to the plain engine; paged starvation
  (preemption, replay) equal to the plain engine; sampled streams within
  budget, before their stop token, with the host cursor at prompt +
  emitted - 1 after every tick; full acceptance when the draft is the
  target;
- the helpers: ``ensure_to``, ``draft_equivalent_blocks`` and
  ``cache_bytes`` against the reference's, ``early_exit_draft``'s shared
  storage and depth check, ``write_row``, the headless prefiller, the
  engine's refusals;
- the decode windows: ``K + 1`` tokens at per-row positions through the
  contiguous and the paged cache equal the full forward, both families;
  ``return_hidden`` returns the final hidden state;
- ``TelemetrySink(max_bytes=)``: the same rows through both sinks give the
  same segment names, the same split and the same JSON (one clock), and
  numbering resumes past the highest segment.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from tpudist.generate import per_row_log_probs as jax_log_probs
from tpudist.models.gpt2 import GPT2 as JGPT2
from tpudist.models.llama import Llama as JLlama
from tpudist.serve import ServeEngine as JServeEngine
from tpudist.serve.blocks import draft_equivalent_blocks as jax_equivalent
from tpudist.serve.spec import cache_bytes as jax_cache_bytes
from tpudist.serve.spec import early_exit_draft as jax_early_exit
from tpudist.serve.spec import speculative_accept as jax_accept
from tpudist.telemetry import TelemetrySink as JSink
from tpudist_torch.generate import (
    fold_keys, generate, per_row_log_probs, row_keys, sample_logits_per_row,
)
from tpudist_torch.interop import gpt2_params_from_flax, llama_params_from_flax
from tpudist_torch.models.gpt2 import GPT2
from tpudist_torch.models.llama import Llama
from tpudist_torch.serve import (
    Prefiller, ServeEngine, SlotPool, draft_equivalent_blocks,
    early_exit_draft, speculative_accept,
)
from tpudist_torch.serve.blocks import PagedSlotPool
from tpudist_torch.serve.spec import cache_bytes
from tpudist_torch.telemetry import TelemetrySink

GPT2_GEOM = dict(vocab_size=64, max_seq_len=64, hidden_dim=32, depth=2,
                 num_heads=4)
LLAMA_GEOM = dict(GPT2_GEOM, num_kv_heads=2, ffn_dim=64)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _flax(family, seed):
    jm = JGPT2(**GPT2_GEOM) if family == "gpt2" else JLlama(**LLAMA_GEOM)
    params = jm.init(jax.random.key(seed), np.zeros((1, 8), np.int32),
                     train=False)["params"]
    return jm, params


def _port(family, params, attn_impl="xla"):
    if family == "gpt2":
        m = GPT2(**GPT2_GEOM, attn_impl=attn_impl, device="cpu")
        convert = gpt2_params_from_flax
    else:
        m = Llama(**LLAMA_GEOM, attn_impl=attn_impl, device="cpu")
        convert = llama_params_from_flax
    m.load_state_dict(convert(jax.tree_util.tree_map(
        np.asarray, meta.unbox(params))))
    return m


def _prompts(lens, vocab=64, seed=0):
    rng = np.random.Generator(np.random.PCG64(seed))
    return [rng.integers(0, vocab, (p,)).astype(np.int32) for p in lens]


def _params(b, seed=0):
    rng = np.random.Generator(np.random.PCG64(seed))
    temperature = np.where(rng.random(b) < 0.3, 0.0,
                           rng.uniform(0.5, 1.5, b)).astype(np.float32)
    top_k = np.where(rng.random(b) < 0.5, 0, rng.integers(1, 12, b))
    top_p = np.where(rng.random(b) < 0.5, 1.0,
                     rng.uniform(0.5, 0.99, b)).astype(np.float32)
    return temperature, top_k.astype(np.int32), top_p


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


# ---------------------------------------------------------------------------
# the acceptance rule


def test_per_row_log_probs_matches_the_reference():
    rng = np.random.Generator(np.random.PCG64(0))
    b, v = 24, 40
    logits = rng.normal(0, 2, (b, v)).astype(np.float32)
    temperature, top_k, top_p = _params(b)
    want = np.asarray(jax_log_probs(
        jnp.asarray(logits), temperature=jnp.asarray(temperature),
        top_k=jnp.asarray(top_k), top_p=jnp.asarray(top_p)))
    t, k, p = _t(temperature, top_k, top_p)
    got = per_row_log_probs(torch.from_numpy(logits), temperature=t,
                            top_k=k, top_p=p).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, rtol=1e-5)


def _draft(d_logits, keys, temperature, top_k, top_p):
    """Proposals as the engine draws them: step ``i`` from the warped
    draft row with salt ``i``."""
    return torch.stack([
        sample_logits_per_row(d_logits[:, i], fold_keys(keys, i),
                              temperature=temperature, top_k=top_k,
                              top_p=top_p)
        for i in range(d_logits.shape[1])], 1)


def test_speculative_accept_greedy_matches_the_reference():
    rng = np.random.Generator(np.random.PCG64(1))
    b, k, v = 24, 3, 32
    t_logits = rng.normal(0, 1.5, (b, k + 1, v)).astype(np.float32)
    d_logits = rng.normal(0, 1.5, (b, k, v)).astype(np.float32)
    d_logits[: b // 2] = t_logits[: b // 2, :k]  # half the drafts agree
    d_toks = d_logits.argmax(-1).astype(np.int32)
    n_spec = rng.integers(0, k + 1, b).astype(np.int32)
    zeros, top_k, top_p = (np.zeros(b, np.float32), np.zeros(b, np.int32),
                           np.ones(b, np.float32))
    jkeys = jax.vmap(jax.random.fold_in, (None, 0))(jax.random.key(9),
                                                    jnp.arange(b))
    want = jax_accept(jnp.asarray(t_logits), jnp.asarray(d_logits),
                      jnp.asarray(d_toks), jnp.asarray(n_spec), jkeys,
                      temperature=jnp.asarray(zeros),
                      top_k=jnp.asarray(top_k), top_p=jnp.asarray(top_p))
    t, kk, p = _t(zeros, top_k, top_p)
    got = speculative_accept(
        torch.from_numpy(t_logits), torch.from_numpy(d_logits),
        torch.from_numpy(d_toks), torch.from_numpy(n_spec),
        row_keys(0, torch.arange(b), 1), temperature=t, top_k=kk, top_p=p)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    # the agreeing half with every draft eligible emits K + 1
    full = n_spec[: b // 2] == k
    assert (got[1].numpy()[: b // 2][full] == k + 1).all()


def test_speculative_accept_keeps_the_target_distribution():
    rng = np.random.Generator(np.random.PCG64(7))
    b, k, v = 4000, 2, 12
    t_row = rng.normal(0, 1.2, (k + 1, v)).astype(np.float32)
    d_row = rng.normal(0, 1.2, (k, v)).astype(np.float32)
    t_logits = torch.from_numpy(t_row).expand(b, k + 1, v)
    d_logits = torch.from_numpy(d_row).expand(b, k, v)
    keys = row_keys(3, torch.arange(b), 1)
    temperature = torch.full((b,), 0.9)
    top_k = torch.full((b,), 6, dtype=torch.int32)
    top_p = torch.full((b,), 0.92)
    d_toks = _draft(d_logits, keys, temperature, top_k, top_p)
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    emit, n_emit = speculative_accept(
        t_logits, d_logits, d_toks, torch.full((b,), k, dtype=torch.int32),
        keys, **kw)
    p0 = np.exp(np.asarray(jax_log_probs(
        jnp.asarray(t_row[:1]), temperature=jnp.asarray([0.9]),
        top_k=jnp.asarray([6]), top_p=jnp.asarray([0.92])))[0])
    emp = np.bincount(emit[:, 0].numpy(), minlength=v) / b
    assert 0.5 * np.abs(emp - p0).sum() < 0.03
    assert int(n_emit.max()) > 1
    emit0, n_emit0 = speculative_accept(
        t_logits, d_logits, d_toks, torch.zeros(b, dtype=torch.int32), keys,
        **kw)
    assert (n_emit0 == 1).all()
    emp0 = np.bincount(emit0[:, 0].numpy(), minlength=v) / b
    assert 0.5 * np.abs(emp0 - p0).sum() < 0.03


# ---------------------------------------------------------------------------
# engines


def test_spec_engine_greedy_matches_static_and_the_reference(tmp_path):
    """GPT-2, 2 slots, 4 requests, the last two arriving mid-decode: the
    speculative engine's streams equal the port's static ``generate()``
    and the reference's speculative engine; the ``serve`` rows carry the
    spec fields."""
    jm, params = _flax("gpt2", 1)
    model = _port("gpt2", params)
    prompts = np.stack(_prompts([6, 6, 6, 6], seed=1))
    static = generate(model, prompts, 10, temperature=0.0)

    def run(eng):
        rids = [eng.submit(prompts[i], 10) for i in range(2)]
        for _ in range(3):
            eng.step()
        rids += [eng.submit(prompts[i], 10) for i in (2, 3)]
        out = eng.run()
        return [list(out[r]) for r in rids]

    sink = TelemetrySink(tmp_path / "s.jsonl")
    eng = ServeEngine(model, max_slots=2, seed=0, sink=sink, stats_every=1,
                      draft_model=early_exit_draft(model, 1), spec_k=3)
    got = run(eng)
    jdraft, jdparams = jax_early_exit(jm, params, 1)
    want = run(JServeEngine(jm, params, max_slots=2, seed=0,
                            draft_model=jdraft, draft_params=jdparams,
                            spec_k=3))
    assert got == [list(r) for r in static]
    assert got == want
    sink.close()
    rows = [json.loads(line) for line in open(tmp_path / "s.jsonl")]
    serve = [r for r in rows if r["kind"] == "serve"]
    assert serve and all({"spec_drafted", "spec_accepted",
                          "spec_acceptance_rate"} <= set(r) for r in serve)
    summary = [r for r in rows if r["kind"] == "serve_summary"][-1]
    assert summary["spec_drafted"] >= summary["spec_accepted"] > 0
    assert 0 < summary["spec_acceptance_rate"] <= 1.0


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_spec_engine_llama_with_eos_matches_the_plain_engine(paged):
    _, params = _flax("llama", 2)
    model = _port("llama", params, attn_impl="fused")
    prompts = _prompts([3, 6, 5, 9], seed=3)

    def run(eos, **kw):
        eng = ServeEngine(model, max_slots=2, seed=0, paged=paged,
                          block_size=8, **kw)
        rids = [eng.submit(pr, 12, eos_id=eos) for pr in prompts[:3]]
        for _ in range(2):
            eng.step()
        rids.append(eng.submit(prompts[3], 12, eos_id=eos))
        out = eng.run()
        return [out[r] for r in rids]

    # the stop token: one the streams emit mid-window
    eos = run(None)[3][5]
    plain = run(eos)
    assert any(len(s) < 12 for s in plain)
    assert run(eos, draft_model=early_exit_draft(model, 1), spec_k=4) == plain


def test_spec_paged_preemption_torture_keeps_greedy_identity():
    _, params = _flax("gpt2", 3)
    model = _port("gpt2", params, attn_impl="fused")
    prompts = _prompts([9, 11, 8, 12, 10, 7], seed=5)
    plain = ServeEngine(model, max_slots=3, seed=0)
    rids = [plain.submit(pr, 20) for pr in prompts]
    out = plain.run()
    want = [out[r] for r in rids]
    eng = ServeEngine(model, max_slots=3, seed=0, paged=True, block_size=4,
                      n_blocks=13, watermark_blocks=1,
                      draft_model=early_exit_draft(model, 1), spec_k=3)
    rids = [eng.submit(pr, 20) for pr in prompts]
    out = eng.run()
    assert [out[r] for r in rids] == want
    assert eng.stats.preemptions > 0


def test_spec_sampled_budget_eos_and_cursor_invariant():
    _, params = _flax("gpt2", 1)
    model = _port("gpt2", params)
    eng = ServeEngine(model, max_slots=3, seed=5, spec_k=3,
                      draft_model=early_exit_draft(model, 1))
    prompts = _prompts([4, 7, 5, 9, 6], seed=11)
    rids = [eng.submit(pr, 9, temperature=0.9, top_k=20, top_p=0.95,
                       eos_id=5) for pr in prompts]
    plens = {r: len(p) for r, p in zip(rids, prompts)}
    while eng.pending:
        eng.step()
        for slot in np.nonzero(eng.pool.active)[0]:
            rid = int(eng._req[slot])
            if rid < 0 or rid not in eng._counts:
                continue
            assert eng.pool.positions[slot] == plens[rid] + eng._counts[rid] - 1
    for r in rids:
        toks = eng.result(r)
        assert 1 <= len(toks) <= 9
        assert all(t != 5 for t in toks[:-1])


def test_spec_full_acceptance_emits_windows_in_order():
    """The draft is the target: every proposal is accepted, each tick a
    slot emits ``spec_k + 1`` tokens, each its own event in order."""
    _, params = _flax("gpt2", 1)
    model = _port("gpt2", params)
    seen = []
    eng = ServeEngine(model, max_slots=2, seed=0, draft_model=model,
                      spec_k=3, on_token=lambda ev: seen.append(
                          (ev.request_id, ev.index, ev.done)))
    rids = [eng.submit(pr, 9) for pr in _prompts([4, 6], seed=4)]
    streamed = list(eng.events())
    assert [(e.request_id, e.index, e.done) for e in streamed] == seen
    for r in rids:
        assert [e.index for e in streamed if e.request_id == r] == list(range(9))
        assert [e.done for e in streamed if e.request_id == r] == [False] * 8 + [True]
    snap = eng.stats.snapshot()
    assert snap["spec_acceptance_rate"] == 1.0
    assert snap["spec_accepted"] == snap["spec_drafted"] > 0


def test_spec_engine_refusals():
    model = GPT2(**GPT2_GEOM, attn_impl="fused", device="cpu")
    draft = early_exit_draft(model, 1)
    with pytest.raises(ValueError, match="spec_k"):
        ServeEngine(model, draft_model=draft, spec_k=0)
    with pytest.raises(ValueError, match="vocab"):
        ServeEngine(model, draft_model=GPT2(
            **dict(GPT2_GEOM, vocab_size=32, depth=1), device="cpu"))
    with pytest.raises(ValueError, match="max_seq_len"):
        ServeEngine(model, draft_model=GPT2(**dict(GPT2_GEOM, max_seq_len=32),
                                            device="cpu"))
    # the verify pass takes spec_k + 1 query rows, the paged kernel 16
    with pytest.raises(ValueError, match="at most 16"):
        ServeEngine(model, draft_model=draft, spec_k=16, paged=True,
                    block_size=8)
    ServeEngine(model, draft_model=draft, spec_k=15, paged=True, block_size=8)


# ---------------------------------------------------------------------------
# helpers


def test_early_exit_draft_shares_storage_and_validates():
    for family in ("gpt2", "llama"):
        _, params = _flax(family, 0)
        model = _port(family, params)
        draft = early_exit_draft(model, 1)
        assert draft.depth == 1 and model.depth == 2
        sd, msd = draft.state_dict(), model.state_dict()
        assert set(sd) < set(msd)
        assert all(sd[k].data_ptr() == msd[k].data_ptr() for k in sd)
        assert not any(".1." in k or "layer_1" in k for k in sd)
        for depth in (0, model.depth):
            with pytest.raises(ValueError, match="depth"):
                early_exit_draft(model, depth)
    assert len(model.blocks) == 2  # the target keeps its blocks


def test_draft_bytes_match_the_reference():
    for family in ("gpt2", "llama"):
        jm, _ = _flax(family, 0)
        model = _port(family, _flax(family, 0)[1])
        draft = early_exit_draft(model, 1)
        assert cache_bytes(model, 3) == jax_cache_bytes(jm, 3)
        assert cache_bytes(draft, 4) == jax_cache_bytes(jm.clone(depth=1), 4)
        assert draft_equivalent_blocks(model, draft, 4, 8) == jax_equivalent(
            jm, jm.clone(depth=1), max_slots=4, block_size=8)


def test_ensure_to_maps_the_whole_window():
    model = GPT2(**GPT2_GEOM, device="cpu")
    pool = PagedSlotPool(model, 2, n_blocks=6, block_size=8)
    slot = pool.insert(model.init_cache(1), 5,
                       prompt=np.arange(5, dtype=np.int32))
    assert pool.ensure_to(slot, 20) and int(pool.fill[slot]) == 3
    assert pool.ensure_to(slot, 20) and int(pool.fill[slot]) == 3
    assert not pool.ensure_to(slot, 64)  # 8 blocks > 5 usable
    assert int(pool.fill[slot]) == 5  # what was mapped stays mapped


def test_write_row_pins_a_slot():
    model = GPT2(**GPT2_GEOM, device="cpu")
    pool = SlotPool(model, 2)
    row = model.init_cache(1)
    for layer in row["layers"]:
        layer["k"].fill_(1.0)
    pool.write_row(row, 1)
    assert pool.n_active == 0
    assert (pool.cache["layers"][0]["k"][1] == 1.0).all()
    assert (pool.cache["layers"][0]["k"][0] == 0.0).all()
    with pytest.raises(ValueError, match="slot"):
        pool.write_row(row, 2)


def test_headless_prefill_holds_the_same_kv():
    model = GPT2(**GPT2_GEOM, device="cpu", seed=2)
    prompt = _prompts([13])[0]
    cache, logits = Prefiller(model, chunk=8)(prompt)
    hcache, none = Prefiller(model, chunk=8, head=False)(prompt)
    assert none is None and logits.shape == (64,)
    for a, b in zip(cache["layers"], hcache["layers"]):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])


@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("impl", ["xla", "fused"])
def test_decode_windows_at_per_row_positions(family, impl):
    """Rows at different cursors feed a window of 4 tokens through the
    contiguous and the paged cache: each row's logits equal the full
    forward's at those positions; ``return_hidden`` stops before the
    head."""
    model = _port(family, _flax(family, 4)[1], attn_impl=impl)
    seqs = _prompts([20, 20, 20], seed=6)
    lens = [5, 11, 8]
    full = model(torch.from_numpy(np.stack(seqs)).long())
    window = torch.from_numpy(np.stack([s[n:n + 4] for s, n in zip(seqs, lens)]))
    pos = torch.tensor(lens, dtype=torch.int32)
    want = torch.stack([full[i, n:n + 4] for i, n in enumerate(lens)])
    pf = Prefiller(model, chunk=8)
    contiguous = SlotPool(model, 3)
    paged = PagedSlotPool(model, 3, n_blocks=13, block_size=8,
                          prefix_cache=False)
    for s, n in zip(seqs, lens):
        row, _ = pf(s[:n])
        contiguous.insert(row, n)
        slot = paged.insert(row, n)
        assert paged.ensure_to(slot, n + 4)
    got = model(window.long(), cache=contiguous.cache, positions=pos)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    got = model(window.long(), cache=paged.cache, positions=pos,
                block_tables=torch.from_numpy(paged.tables))
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    hidden = model(window.long(), cache=contiguous.cache, positions=pos,
                   return_hidden=True)
    assert hidden.shape == (3, 4, model.hidden_dim)


# ---------------------------------------------------------------------------
# the sink's segments


def test_sink_rotation_matches_the_reference(tmp_path):
    rows = [dict(kind="serve", step=i, tokens=i * 7, note="é" * (i % 5))
            for i in range(40)]
    for name, cls in (("port", TelemetrySink), ("ref", JSink)):
        (tmp_path / name).mkdir()
        sink = cls(tmp_path / name / "X.jsonl", clock=lambda: 1.5,
                   max_bytes=400, run_id="r")
        for r in rows:
            sink.write(**r)
        segs = [p.name for p in sink.segments()]
        sink.close()
        if name == "port":
            port_segs = segs
        else:
            assert segs == port_segs and len(segs) > 3
    for seg in port_segs:
        assert ((tmp_path / "port" / seg).read_bytes()
                == (tmp_path / "ref" / seg).read_bytes()), seg


def test_sink_numbering_resumes_past_the_highest_segment(tmp_path):
    path = tmp_path / "X.jsonl"
    (tmp_path / "X.jsonl.5").write_text("")
    (tmp_path / "X.jsonl.2").write_text("")
    (tmp_path / "X.jsonl.old").write_text("")  # not a segment
    sink = TelemetrySink(path, max_bytes=120)
    for i in range(6):
        sink.write("serve", step=i)
    names = [p.name for p in sink.segments()]
    sink.close()
    assert names[:2] == ["X.jsonl.2", "X.jsonl.5"]
    assert names[2] == "X.jsonl.6" and names[-1] == "X.jsonl"
    assert all(p.stat().st_size <= 120 for p in tmp_path.glob("X.jsonl*"))
