"""The port's resilience layer (tpudist_torch.resilience) against the JAX
reference's (tpudist.resilience), on the same inputs: the exit-code
contract, the supervisor's decisions, backoff delays and rolling budget
over the same exit-code and clock sequences, the chaos grammar over a
list of specs (good and bad), the injector's firing rules, the NaN burst,
the preemption guard, and the resume geometry guard. Every comparison is
exact: these are integer and string decisions, and the backoff delays
are the same float operations on the same ``random.Random`` draws."""

import itertools
import os
import random
import signal

import numpy as np
import pytest

from tpudist import resilience as ref
from tpudist.resilience import chaos as ref_chaos
from tpudist.resilience import elastic as ref_elastic
from tpudist_torch import resilience as port
from tpudist_torch.resilience import chaos as port_chaos
from tpudist_torch.resilience import elastic as port_elastic


@pytest.mark.parametrize("name", [
    "EXIT_OK", "EXIT_CRASH", "EXIT_PREEMPTED", "EXIT_HANG", "EXIT_REPAIR",
    "EXIT_INTERRUPT", "RESTARTABLE", "GENERATION_ENV", "EXIT_HISTORY_ENV",
    "RUN_ID_ENV"])
def test_exit_code_constants_equal_the_references(name):
    assert getattr(port, name) == getattr(ref, name)


@pytest.mark.parametrize("rc", [0, 1, 9, 75, 76, 77, 78, 130, -9, -15])
def test_classify_and_restartable_equal_the_references(rc):
    assert port.classify(rc) == ref.classify(rc)
    assert port.is_restartable(rc) == ref.is_restartable(rc)


@pytest.mark.parametrize("environ", [
    {}, {"TPUDIST_RESTART_GENERATION": "3"},
    {"TPUDIST_RESTART_GENERATION": "garbage"},
    {"TPUDIST_RUN_ID": "  "}, {"TPUDIST_RUN_ID": "abc123"},
    {"TPUDIST_EXIT_HISTORY": "75,1,x,,76"}, {"TPUDIST_EXIT_HISTORY": ""},
], ids=lambda e: repr(e))
def test_environment_readers_equal_the_references(environ):
    # a non-empty mapping, or the readers fall back to os.environ
    env = {"OTHER": "1", **environ}
    assert port.restart_generation(env) == ref.restart_generation(env)
    assert port.run_id(env) == ref.run_id(env)
    assert port.exit_history(env) == ref.exit_history(env)
    mine, theirs = dict(env), dict(env)
    got = port.ensure_run_id(mine)
    want = ref.ensure_run_id(theirs)
    if ref.run_id(env) is not None:
        assert got == want == ref.run_id(env)
    else:  # minted: a fresh 12-hex id, exported
        assert len(got) == len(want) == 12 and mine["TPUDIST_RUN_ID"] == got


def _drive(mod, rcs, *, stop_after=None, **kw):
    """Run ``mod``'s Supervisor over the exit-code sequence ``rcs`` with a
    fake sleep, a seeded rng, a fake clock and a captured log; an
    operator stop lands after world number ``stop_after``."""
    rcs = iter(rcs)
    seen, sleeps, logs = [], [], []
    clock = {"t": 0.0}
    stop = {"on": False}

    def run_world(generation):
        seen.append(generation)
        clock["t"] += 7.0
        if stop_after is not None and len(seen) > stop_after:
            stop["on"] = True
        return next(rcs)

    env = {}
    budget = kw.pop("budget", None)
    if budget is not None:
        budget = mod.RestartBudget(*budget, clock=lambda: clock["t"])
    sup = mod.Supervisor(
        run_world, sleep=sleeps.append, rng=random.Random(5),
        log=lambda m: logs.append(m.split(": ", 1)[1]), environ=env,
        stop=lambda: stop["on"], budget=budget,
        backoff=mod.BackoffPolicy(*kw.pop("backoff", (1.0, 60.0))), **kw)
    rc = sup.run()
    return rc, seen, sleeps, logs, sup.exit_history, env


@pytest.mark.parametrize("rcs,kw", [
    ([75, 76, 0], dict(max_restarts=0, budget=(10, 600.0))),
    ([9, 9, 9], dict(max_restarts=2)),
    ([9, 9, 9, 9, 9, 9], dict(max_restarts=5, backoff=(0.5, 2.0))),
    ([9, 75, 9, 0], dict(max_restarts=1)),
    ([1, 0], dict(max_restarts=3, budget=(1, 10.0))),
    (itertools.repeat(75), dict(max_restarts=0, budget=(3, 600.0))),
    (itertools.repeat(1), dict(max_restarts=9, budget=(2, 600.0))),
    (itertools.repeat(75), dict(max_restarts=0, budget=(2, 10.0),
                                stop_after=6)),
    ([130, 0], dict(max_restarts=5)),
    ([-9, 0], dict(max_restarts=1)),
    ([75, 0], dict(max_restarts=0, stop_after=0)),
], ids=lambda v: repr(v)[:60])
def test_supervisor_decisions_equal_the_references(rcs, kw):
    a, b = itertools.tee(rcs) if not isinstance(rcs, list) else (rcs, rcs)
    got = _drive(port, a, **dict(kw))
    want = _drive(ref, b, **dict(kw))
    assert got == want
    assert got[1]  # at least one world ran


@pytest.mark.parametrize("base,cap,jitter", [(1.0, 60.0, 0.5),
                                             (0.25, 3.0, 0.5),
                                             (2.0, 10.0, 0.0), (0.0, 5.0, 0.5)])
def test_backoff_delays_equal_the_references(base, cap, jitter):
    pa = port.BackoffPolicy(base, cap, jitter)
    pb = ref.BackoffPolicy(base, cap, jitter)
    ra, rb = random.Random(11), random.Random(11)
    got = [pa.delay_s(n, ra) for n in range(-1, 12)]
    want = [pb.delay_s(n, rb) for n in range(-1, 12)]
    assert got == want
    for n, d in zip(range(-1, 12), got):
        if n > 0 and base > 0:
            nominal = min(base * 2.0 ** (n - 1), cap)
            assert nominal * (1 - jitter) <= d <= nominal * (1 + jitter)


@pytest.mark.parametrize("limit,window", [(3, 10.0), (1, 5.0), (0, 10.0),
                                          (2, 0.0)])
def test_restart_budget_equals_the_references(limit, window):
    times = [0.0, 1.0, 2.0, 2.5, 9.0, 11.5, 12.0, 30.0, 30.1, 30.2]
    out = []
    for mod in (port, ref):
        clock = {"t": 0.0}
        budget = mod.RestartBudget(limit, window, clock=lambda: clock["t"])
        trace = []
        for t in times:
            clock["t"] = t
            ok = budget.allow()
            if ok:
                budget.record()
            trace.append((ok, budget.used()))
        out.append(trace)
    assert out[0] == out[1]


CHAOS_SPECS = [
    "crash@12", "sigterm@5@1", "hang:30@7@*", "hang@2", "corrupt@4",
    "nanburst:3@20", "nanburst@1@*", "bitflip@10", "bitflip@10,nanburst:3@20",
    "crash@5@*, sigterm@9", "crash@0@2",
    # refused, by both
    "boom@3", "crash", "crash:5@3", "crash@x", "nanburst:0@3", "sigterm@3@x",
    "crash@1@2@3", "", " , ", "hang:abc@2",
]


@pytest.mark.parametrize("spec", CHAOS_SPECS)
def test_parse_chaos_equals_the_references(spec):
    def parse(mod):
        try:
            return [vars(s) if hasattr(s, "__dict__") else s
                    for s in mod.parse_chaos(spec)]
        except ValueError as e:
            return ("ValueError", str(e))

    import dataclasses

    got = parse(port_chaos)
    want = parse(ref_chaos)
    if isinstance(want, tuple):
        assert got == want
    else:
        assert [dataclasses.astuple(s) for s in port_chaos.parse_chaos(spec)] \
            == [dataclasses.astuple(s) for s in ref_chaos.parse_chaos(spec)]


def test_bitflip_parses_but_an_injector_refuses_it():
    specs = port.parse_chaos("bitflip@3,crash@5")
    assert [s.kind for s in specs] == ["bitflip", "crash"]
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 #8"):
        port.make_injector("bitflip@3")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 #8"):
        port.ChaosInjector(specs)


@pytest.mark.parametrize("spec,generation", [
    ("crash@5", 0), ("crash@5", 1), ("crash@5@*", 4), ("crash@5@2", 2),
    ("hang:12@2", 0), ("sigterm@3", 0), ("sigterm@3@1", 0),
    ("corrupt@6", 1), ("hang:1@1,sigterm@3,crash@4", 0)])
def test_injector_fires_as_the_references(spec, generation):
    """The same boundaries through both injectors: what fires, when, and
    what it does (a crash, a sleep, a SIGTERM to this process)."""
    traces = []
    for mod in (port_chaos, ref_chaos):
        events = []
        inj = mod.ChaosInjector(mod.parse_chaos(spec), generation=generation,
                                sleep=lambda s: events.append(("sleep", s)),
                                kill=lambda pid, sig: events.append(
                                    ("kill", pid == os.getpid(), sig)))
        for step in range(8):
            try:
                events.append((step, inj.maybe_fire(step)))
            except mod.ChaosCrash as e:
                events.append((step, "crash", str(e)))
                break
        events.append(("fired", inj.fired))
        traces.append(events)
    assert traces[0] == traces[1]


def test_corrupt_drill_truncates_the_newest_step(tmp_path):
    """The port's drill against the port's layout: settle the save in
    flight, halve every file of the newest step, crash; the walk-back
    then has a step to fall back to."""
    for step, size in ((4, 100), (8, 64)):
        d = tmp_path / str(step)
        d.mkdir()
        (d / ".metadata").write_bytes(b"m" * size)
        (d / "__0_0.distcp").write_bytes(b"d" * (2 * size))
    (tmp_path / "12.partial").mkdir()  # a write in flight is not a step
    settled = []
    inj = port.make_injector("corrupt@3").bind(tmp_path,
                                               wait=lambda: settled.append(1))
    with pytest.raises(port.ChaosCrash, match="corrupted newest"):
        inj.maybe_fire(3)
    assert settled == [1]
    assert (tmp_path / "8" / ".metadata").stat().st_size == 32
    assert (tmp_path / "8" / "__0_0.distcp").stat().st_size == 64
    assert (tmp_path / "4" / ".metadata").stat().st_size == 100
    with pytest.raises(port.ChaosCrash, match="needs a checkpoint_dir"):
        port.corrupt_latest_checkpoint(None)


def test_nanburst_poisons_the_same_batches_as_the_references():
    r = np.random.Generator(np.random.PCG64(0))
    batches = [{"image": r.standard_normal((2, 3)).astype(np.float32),
                "label": np.arange(2, dtype=np.int32)} for _ in range(8)]
    outs = []
    for mod in (port_chaos, ref_chaos):
        inj = mod.ChaosInjector(mod.parse_chaos("nanburst:3@4"), generation=0)
        outs.append(list(inj.wrap_batches(iter(batches), 2)))
    for a, b, orig in zip(*outs, batches):
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["label"], b["label"])
    poisoned = [i for i, a in enumerate(outs[0])
                if np.isnan(a["image"]).any()]
    assert poisoned == [3, 4, 5]  # steps 5, 6, 7 of a stream from step 2
    tokens = [{"tokens": np.zeros((2, 4), np.int32)}]
    with pytest.raises(port.ChaosCrash, match="no float batch leaf"):
        list(port.make_injector("nanburst@0").wrap_batches(iter(tokens), 1))


def test_preempted_is_systemexit_75():
    e = port.Preempted(signal.SIGTERM, 7, state="s", losses=[1.0])
    assert isinstance(e, SystemExit) and e.code == 75
    assert (e.step, e.state, e.losses) == (7, "s", [1.0])
    assert str(e) == str(ref.Preempted(signal.SIGTERM, 7))


def test_preemption_guard_traps_absorbs_and_restores():
    before = signal.getsignal(signal.SIGTERM)
    with port.PreemptionGuard() as guard:
        assert guard.active and guard.tripped is None
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.tripped == signal.SIGTERM
        for _ in range(port.PreemptionGuard.MAX_ABSORBED - 1):
            os.kill(os.getpid(), signal.SIGTERM)  # absorbed
        assert guard.tripped == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) == before


def test_preemption_guard_escalates_past_the_absorbed_signals():
    """Past MAX_ABSORBED the displaced handler is restored and called:
    a wedged graceful path stays killable."""
    calls = []
    before = signal.signal(signal.SIGTERM, lambda s, f: calls.append(s))
    try:
        with port.PreemptionGuard(signals=(signal.SIGTERM,)) as guard:
            for _ in range(port.PreemptionGuard.MAX_ABSORBED + 1):
                os.kill(os.getpid(), signal.SIGTERM)
            assert guard.tripped == signal.SIGTERM
            assert calls == [signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, before)


def test_preemption_guard_disabled_is_inert():
    before = signal.getsignal(signal.SIGTERM)
    with port.PreemptionGuard(enabled=False) as guard:
        assert not guard.active and guard.tripped is None
        assert signal.getsignal(signal.SIGTERM) == before


_META = {"steps_per_epoch": 6, "batch_size": 8, "world_size": 1,
         "grad_accum": 1, "fsdp_world": 1, "tensor_world": 1, "pipe_world": 1}


@pytest.mark.parametrize("change", [
    {}, {"batch_size": 16}, {"world_size": 2, "steps_per_epoch": 3},
    {"grad_accum": 2}, {"fsdp_world": 2}, {"tensor_world": 4},
    {"reduce": "quantized"}, {"data_world": 2}, {"steps_per_epoch": None},
], ids=lambda c: repr(c))
@pytest.mark.parametrize("legacy", [False, True])
def test_geometry_guard_equals_the_references(change, legacy):
    saved = dict(_META)
    if legacy:  # a meta written before the model-axis keys
        for k in ("fsdp_world", "tensor_world", "pipe_world"):
            saved.pop(k)
    run = {**_META, **change}
    for fn in ("meta_matches", "refusal_reason", "elastic_mismatch",
               "comparable_meta"):
        assert getattr(port_elastic, fn)(saved, run) == \
            getattr(ref_elastic, fn)(saved, run), fn
    assert issubclass(port.ElasticRefusal, ValueError)
