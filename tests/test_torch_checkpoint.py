"""tpudist_torch.checkpoint and fit's resume, on the CPU.

- Round trips of the training state through the checkpointer for every
  optimizer state (fused AdamW with a bf16 compute copy behind the
  ``--amp`` guard included): the restore copies into the live tensors,
  so the fused kernel's table still holds the live tensors, and the next
  step after a restore is bit-identical to the uninterrupted next step.
- The directory rules: retention with the anchor, ``save`` refusing a
  saved step, the corrupt-newest walk-back (its event, ``_failed/``),
  ``resume=False`` on a used directory, a changed batch size refused with
  the guard's hint, ``iter_from`` against the reference's.
- Against the reference on the same weights (``interop``): the JAX
  ``fit(checkpoint_dir=...)`` and the port's write the same
  ``tpudist_meta.json``, and a run stopped at step 5 of 12 (mid-epoch) and
  resumed continues the same loss trajectory, within
  ``test_torch_train.py``'s bar (1e-4 relative, at Adam 1e-4), with the host
  ``--augment`` stream too: in both packages a resumed run's host
  augmentation starts its stream afresh (``iter_from`` skips the
  transform), so the port's resumed run is held to the reference's
  resumed run, not to the uninterrupted one.
- Why Adam 1e-4 there: at 1e-3 the two packages' uninterrupted 12-step
  runs of this model part by ~1e-2 relative in float32, with no resume
  involved. The same 12 steps in float64 agree within the bar, and the
  reference's own float32 run parts from its float64 run as far: the
  drift is float32 rounding, which this trajectory amplifies (ROADMAP
  Queue 3), not a port fault.

Bit-identity is exact equality (``torch.equal``) in float32 and in the
bf16 copy."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpudist import mesh as mesh_lib
from tpudist.data.cifar import to_tensor as jax_to_tensor
from tpudist.data.loader import DataLoader as JaxLoader
from tpudist.models import resnet18 as jax_resnet18
from tpudist.resilience import Preempted as JaxPreempted
from tpudist.train import create_train_state as jax_create_train_state
from tpudist.train import fit as jax_fit
from tpudist.train import make_train_step as jax_make_train_step
from tpudist_torch.checkpoint import (FAILED_DIR, Checkpointer, latest_step,
                                      read_step)
from tpudist_torch.data import transforms as T
from tpudist_torch.data.cifar import synthetic_cifar, to_tensor
from tpudist_torch.data.lm import TokenWindowLoader
from tpudist_torch.data.loader import DataLoader
from tpudist_torch.interop import resnet_params_from_flax
from tpudist_torch.models.resnet import resnet18
from tpudist_torch.optim import make_optimizer
from tpudist_torch.resilience import GENERATION_ENV, Preempted
from tpudist_torch.train import create_train_state, fit, make_train_step


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _batches(n=4, rows=8, seed=1):
    data = to_tensor(synthetic_cifar(n * rows, num_classes=10, seed=seed))
    return [{k: torch.from_numpy(np.array(v[i * rows:(i + 1) * rows]))
             for k, v in data.items()} for i in range(n)]


OPTIMIZERS = {
    "fused_bf16_amp": lambda: make_optimizer(
        1e-3, fused=True, compute_dtype=torch.bfloat16,
        skip_nonfinite_updates=True),
    "fused_f32": lambda: make_optimizer(1e-3, fused=True, weight_decay=0.1),
    "adam": lambda: make_optimizer(1e-3, weight_decay=0.1, clip_norm=1.0),
    "sgd": lambda: make_optimizer(0.1, optimizer="sgd", weight_decay=1e-4),
    "lamb": lambda: make_optimizer(1e-3, optimizer="lamb", weight_decay=0.1),
    "lion": lambda: make_optimizer(1e-4, optimizer="lion"),
    "muon": lambda: make_optimizer(1e-3, optimizer="muon",
                                   skip_nonfinite_updates=True),
}


def _build(opt):
    tx = OPTIMIZERS[opt]()
    dtype = getattr(tx, "compute_dtype", None) or torch.float32
    model = resnet18(num_filters=8, num_classes=10, small_inputs=True,
                     dtype=dtype, device="cpu")
    state = create_train_state(model, tx)
    fused = "optimizer" if getattr(tx, "fused", False) else None
    return state, make_train_step(model, tx, fused=fused)


def _tensors(state):
    """Every tensor the step reads or writes: the module's parameters
    (the compute copy under the fused optimizer), the optimizer state's
    tensors, the BN buffers."""
    out = {f"module.{k}": v.detach().clone()
           for k, v in state.model.state_dict().items()}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            elif isinstance(v, torch.Tensor):
                out[f"{prefix}{k}"] = v.detach().clone()
            else:
                out[f"{prefix}{k}"] = v

    walk(state.state_dict(), "")
    return out


def _assert_identical(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if isinstance(w, torch.Tensor):
            assert torch.equal(got[k], w), k
        else:
            assert got[k] == w, k


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_round_trip_then_the_next_step_is_bit_identical(opt, tmp_path):
    batches = _batches()
    state, step = _build(opt)
    for b in batches[:2]:
        state, _ = step(state, b)
    ckpt = Checkpointer(tmp_path, keep_last=2)
    assert ckpt.save(state) is True
    ckpt.wait()
    assert ckpt.save(state) is False  # this step is saved already
    state, metrics = step(state, batches[2])
    want, want_loss = _tensors(state), float(metrics["loss"])

    other, other_step = _build(opt)
    other, _ = other_step(other, batches[3])  # some other history first
    live = {k: t.data_ptr() for k, t in other.model.state_dict().items()}
    ckpt.restore(other)
    assert other.step == 2
    # in place: nothing the step (or the fused kernel's table) points at moved
    assert live == {k: t.data_ptr() for k, t in other.model.state_dict().items()}
    other, metrics = other_step(other, batches[2])
    assert float(metrics["loss"]) == want_loss
    _assert_identical(_tensors(other), want)
    ckpt.close()


def test_fused_table_still_holds_the_live_tensors(tmp_path):
    """The fused kernel's table keeps the tensors it was built on; a
    restore must write into exactly those (the card's kernel reads their
    raw pointers), and the bf16 copy is derived from the restored
    masters."""
    batches = _batches()
    state, step = _build("fused_bf16_amp")
    state, _ = step(state, batches[0])
    ckpt = Checkpointer(tmp_path)
    ckpt.save(state, wait=True)
    saved = read_step(tmp_path, 1)
    # the copy is not stored; every master, m and v is, once
    assert not [k for k in saved if k.startswith("params.")]
    assert {k.split(".")[2] for k in saved if k.startswith("opt.inner.")} == {
        "count", "master", "mu", "nu"}
    assert saved["opt.inner.count"] == 1 and saved["opt.skipped"] == 0

    other, _ = _build("fused_bf16_amp")
    inner = other.opt_state.inner
    table = inner.table
    before = [(t.data_ptr(), id(t)) for t in table.m + table.v + table.p]
    ckpt.restore(other)
    assert before == [(t.data_ptr(), id(t))
                      for t in table.m + table.v + table.p]
    names = inner.names
    params = dict(other.model.named_parameters())
    for i, k in enumerate(names):
        assert table.m[i] is inner.mu[k] and table.v[i] is inner.nu[k]
        assert table.p[i] is inner.master[k]
        assert table.copy[i] is params[k]
        assert params[k].dtype == torch.bfloat16
        assert torch.equal(params[k].detach(),
                           inner.master[k].to(torch.bfloat16))
        assert torch.equal(inner.master[k], saved[f"opt.inner.master.{k}"])
    ckpt.close()


def test_keep_last_spares_the_anchor(tmp_path):
    state, step = _build("adam")
    ckpt = Checkpointer(tmp_path, keep_last=2)
    batches = _batches(n=6)
    for i, b in enumerate(batches):
        state, _ = step(state, b)
        ckpt.save(state)
        if state.step == 2:
            ckpt.wait()
            ckpt.write_anchor(2)
    ckpt.wait()
    assert ckpt.all_steps() == [2, 5, 6]
    assert ckpt.read_anchor() == 2 and latest_step(tmp_path) == 6
    ckpt.close()
    default = Checkpointer(tmp_path / "default")  # KEEP_LAST, 3
    for b in batches[:1]:
        state, _ = step(state, b)
    for s in range(4):
        state.step += 1
        default.save(state)
    default.wait()
    assert default.all_steps() == [state.step - 2, state.step - 1, state.step]
    default.close()


def _loader(n=48, batch=8, augment=False, seed=3):
    data = synthetic_cifar(n, num_classes=10, seed=seed)
    transform = (T.standard_cifar_augment(seed=0, dataset="cifar10")
                 if augment else to_tensor)
    return DataLoader(data, batch, transform=transform)


def _fit_port(tmp_path, model_fn, tx_fn, *, ckpt, chaos=None, epochs=2,
              fused="optimizer", loader=None, **kw):
    return fit(model_fn(), tx_fn(), loader or _loader(), epochs=epochs,
               profile=False, log_dir=str(tmp_path), fused=fused,
               checkpoint_dir=None if ckpt is None else str(ckpt),
               checkpoint_every=4, chaos=chaos, **kw)


def _resnet_bf16():
    return resnet18(num_filters=8, num_classes=10, small_inputs=True,
                    dtype=torch.bfloat16, device="cpu")


def _fused_amp():
    return make_optimizer(1e-3, fused=True, compute_dtype=torch.bfloat16,
                          skip_nonfinite_updates=True)


def test_corrupt_newest_falls_back_and_resumes(tmp_path, monkeypatch, capsys):
    """--chaos corrupt@10: the newest step (8) is truncated and the run
    crashes; the next life reports the walk-back, sets step 8 aside and
    resumes from 4, ending bit-identical to an uninterrupted run."""
    from tpudist_torch.resilience import ChaosCrash

    monkeypatch.delenv(GENERATION_ENV, raising=False)
    full, full_losses = _fit_port(tmp_path, _resnet_bf16, _fused_amp,
                                  ckpt=tmp_path / "full")
    with pytest.raises(ChaosCrash, match="corrupted newest"):
        _fit_port(tmp_path, _resnet_bf16, _fused_amp, ckpt=tmp_path / "c",
                  chaos="corrupt@10")
    assert latest_step(tmp_path / "c") == 8
    monkeypatch.setenv(GENERATION_ENV, "1")
    capsys.readouterr()
    state, losses = _fit_port(tmp_path, _resnet_bf16, _fused_amp,
                              ckpt=tmp_path / "c", chaos="corrupt@10")
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("checkpoint_fallback: ")]
    assert len(lines) == 1
    event = json.loads(lines[0].split(": ", 1)[1])
    assert (event["failed_step"], event["next_step"]) == (8, 4)
    assert (tmp_path / "c" / FAILED_DIR / "8").is_dir()
    assert losses == full_losses[4:]
    _assert_identical(read_step(tmp_path / "c", 12),
                      read_step(tmp_path / "full", 12))


def test_every_step_failing_raises_the_last_error(tmp_path):
    state, step = _build("adam")
    ckpt = Checkpointer(tmp_path)
    for b in _batches(n=2):
        state, _ = step(state, b)
        ckpt.save(state, wait=True)
    for s in (1, 2):
        for f in (tmp_path / str(s)).iterdir():
            f.write_bytes(b"")
    events = []
    with pytest.raises(BaseException, match="CheckpointException|metadata"):
        ckpt.restore(state, fallback=True, on_event=events.append)
    assert [e["failed_step"] for e in events] == [2, 1]
    assert [e["next_step"] for e in events] == [1, None]
    with pytest.raises(FileNotFoundError):
        Checkpointer(tmp_path / "empty").restore(state)
    ckpt.close()


def test_resume_false_refuses_a_used_directory(tmp_path):
    _fit_port(tmp_path, _resnet_bf16, _fused_amp, ckpt=tmp_path / "c",
              epochs=1)
    with pytest.raises(ValueError, match="resume=False"):
        _fit_port(tmp_path, _resnet_bf16, _fused_amp, ckpt=tmp_path / "c",
                  resume=False)


def test_changed_batch_size_is_refused_with_the_hint(tmp_path):
    _fit_port(tmp_path, _resnet_bf16, _fused_amp, ckpt=tmp_path / "c",
              epochs=1)
    with pytest.raises(ValueError, match=r"different geometry.*pure world "
                       r"resize|different geometry.*differ") as ei:
        _fit_port(tmp_path, _resnet_bf16, _fused_amp, ckpt=tmp_path / "c",
                  loader=_loader(batch=4))
    assert "'batch_size': 8" in str(ei.value)
    with pytest.raises(ValueError, match="grad_accum"):
        _fit_port(tmp_path, _resnet_bf16, _fused_amp, ckpt=tmp_path / "c",
                  loader=_loader(batch=8), grad_accum=2)


@pytest.mark.parametrize("start", [0, 1, 3, 5, 6])
def test_iter_from_equals_the_references(start):
    from tpudist.data.lm import TokenWindowLoader as JaxWindows

    data = synthetic_cifar(50, num_classes=10, seed=2)
    for drop in (True, False):
        mine = list(DataLoader(data, 8, drop_remainder=drop).iter_from(start))
        ref = list(JaxLoader(data, 8, drop_remainder=drop,
                             native=False).iter_from(start))
        assert len(mine) == len(ref)
        for a, b in zip(mine, ref):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    flat = np.arange(700, dtype=np.int32) % 97
    mine = TokenWindowLoader(flat, 4, 16, seed=1)
    ref = JaxWindows(flat, 4, 16, seed=1)
    for loader in (mine, ref):
        loader.sampler.set_epoch(1)
    got, want = list(mine.iter_from(start)), list(ref.iter_from(start))
    assert len(got) == len(want) == max(len(mine) - start, 0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


# -- against the reference ---------------------------------------------------

#: the comparison's Adam rate (module docstring)
LR = 1e-4

def _jax_init(seed=0):
    mesh = mesh_lib.create_mesh(devices=jax.devices()[:1])
    jm = jax_resnet18(num_filters=8, num_classes=10, small_inputs=True)
    js = jax_create_train_state(jm, seed, jnp.zeros((1, 32, 32, 3)),
                                optax.adam(LR), mesh)
    params = jax.tree_util.tree_map(np.asarray, js.params)
    stats = jax.tree_util.tree_map(np.asarray, js.batch_stats)
    return mesh, jm, params, resnet_params_from_flax(params, stats)


def _jax_loader(augment):
    from tpudist.data.transforms import standard_cifar_augment

    data = synthetic_cifar(48, num_classes=10, seed=3)
    transform = (standard_cifar_augment(seed=0, dataset="cifar10")
                 if augment else jax_to_tensor)
    return JaxLoader(data, 8, transform=transform, native=False)


@pytest.mark.parametrize("augment", [False, True])
def test_meta_and_resumed_trajectory_match_the_reference(augment, tmp_path,
                                                         monkeypatch):
    """Both packages train the same tiny ResNet-18 (the reference's init,
    carried over by interop), stop at step 5 of 12 on ``sigterm@5`` (an
    emergency checkpoint, exit 75) and resume in generation 1: the same
    ``tpudist_meta.json``, the same steps checkpointed, and the resumed
    losses within 1e-4 relative (``test_torch_train.py``'s bar)."""
    mesh, jm, jparams, init = _jax_init()

    def jrun(d):
        return jax_fit(jm, optax.adam(LR), _jax_loader(augment), epochs=2,
                       mesh=mesh, job_id="J", batch_size=8, world_size=1,
                       log_dir=str(tmp_path), profile=False,
                       checkpoint_dir=str(d), checkpoint_every=4,
                       chaos="sigterm@5", init_params=jparams)

    def prun(d):
        model = resnet18(num_filters=8, num_classes=10, small_inputs=True,
                         device="cpu")
        model.load_state_dict(init)
        return fit(model, make_optimizer(LR), _loader(augment=augment),
                   epochs=2, profile=False, log_dir=str(tmp_path),
                   checkpoint_dir=str(d), checkpoint_every=4,
                   chaos="sigterm@5")

    monkeypatch.delenv(GENERATION_ENV, raising=False)
    with pytest.raises(JaxPreempted) as je:
        jrun(tmp_path / "jax")
    with pytest.raises(Preempted) as pe:
        prun(tmp_path / "port")
    assert je.value.step == pe.value.step == 5
    assert je.value.code == pe.value.code == 75
    np.testing.assert_allclose(pe.value.losses, je.value.losses, rtol=1e-4)
    meta = json.loads((tmp_path / "port" / "tpudist_meta.json").read_text())
    assert meta == json.loads(
        (tmp_path / "jax" / "tpudist_meta.json").read_text())
    assert meta["steps_per_epoch"] == 6 and meta["batch_size"] == 8

    monkeypatch.setenv(GENERATION_ENV, "1")
    _, jlosses = jrun(tmp_path / "jax")
    _, plosses = prun(tmp_path / "port")
    assert len(plosses) == len(jlosses) == 7
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-4)
    assert latest_step(tmp_path / "port") == latest_step(tmp_path / "jax") == 12


def _jax_adam_losses(jm, params, stats, batches, lr):
    """The reference's train step (``tpudist/train.py`` at
    ``grad_accum=1``: one ``value_and_grad`` with the BN statistics as the
    aux output, ``optax.adam``, ``apply_updates``) written out, so it runs
    in the precision of its inputs; the losses of ``batches`` in order."""
    from tpudist.train import cross_entropy_loss as jax_ce

    tx = optax.adam(lr)

    @jax.jit
    def step(p, s, o, b):
        def loss(p):
            logits, upd = jm.apply({"params": p, "batch_stats": s},
                                   b["image"], train=True,
                                   mutable=["batch_stats"])
            return jax_ce(logits, b["label"]), upd["batch_stats"]

        (l, s), g = jax.value_and_grad(loss, has_aux=True)(p)
        up, o = tx.update(g, o, p)
        return optax.apply_updates(p, up), s, o, l

    opt, losses = tx.init(params), []
    for b in batches:
        params, stats, opt, l = step(params, stats, opt, b)
        losses.append(float(l))
    return np.array(losses)


def test_adam_1e3_drift_is_float32_rounding_not_the_port(capsys):
    """The witness for the Adam rate above. The 12 steps of the resume
    test's uninterrupted run (the same init and batches) at Adam 1e-3:
    the written-out step equals the reference's ``make_train_step`` in
    float32; in float64 the port holds ``test_torch_train.py``'s 1e-4
    bar over all 12 (measured 7.7e-6; the head computes in float32 on
    both sides, as flax's ``Dense(dtype=float32)`` does); in float32 the
    reference parts from its own float64 run by more than ten times the
    bar (measured 1.03e-2), and the port no farther than the reference
    (2.4e-3). The drifts print under ``-s``."""
    lr = 1e-3
    mesh = mesh_lib.create_mesh(devices=jax.devices()[:1])
    jm = jax_resnet18(num_filters=8, num_classes=10, small_inputs=True)
    js = jax_create_train_state(jm, 0, jnp.zeros((1, 32, 32, 3)),
                                optax.adam(lr), mesh)
    as_ = lambda t, dt: jax.tree_util.tree_map(lambda a: np.asarray(a, dt), t)
    params, stats = as_(js.params, np.float32), as_(js.batch_stats, np.float32)
    batches = [{k: np.asarray(v) for k, v in b.items()}
               for _ in range(2) for b in _loader()]
    assert len(batches) == 12

    real = []
    step = jax_make_train_step(jm, optax.adam(lr), mesh)
    for b in batches:
        js, metrics = step(js, b)
        real.append(float(metrics["loss"]))
    np.testing.assert_allclose(
        _jax_adam_losses(jm, params, stats, batches, lr), real, rtol=1e-6)
    b64 = [{"image": b["image"].astype(np.float64), "label": b["label"]}
           for b in batches]
    with jax.enable_x64(True):
        ref64 = _jax_adam_losses(jm.clone(dtype=jnp.float64),
                                 as_(params, np.float64),
                                 as_(stats, np.float64), b64, lr)

    def port(dtype, data):
        npdt = np.float64 if dtype == torch.float64 else np.float32
        model = resnet18(num_filters=8, num_classes=10, small_inputs=True,
                         dtype=dtype, device="cpu")
        model.load_state_dict(resnet_params_from_flax(as_(params, npdt),
                                                      as_(stats, npdt)))
        model = model.to(dtype)
        tx = make_optimizer(lr)
        state, step = create_train_state(model, tx), make_train_step(model, tx)
        losses = []
        for b in data:
            state, metrics = step(state, {k: torch.from_numpy(v)
                                          for k, v in b.items()})
            losses.append(float(metrics["loss"]))
        return np.array(losses)

    rel = lambda a, b: float(np.max(np.abs(a - b) / np.abs(b)))
    port64, port32 = port(torch.float64, b64), port(torch.float32, batches)
    drift = {"port64_vs_ref64": rel(port64, ref64),
             "ref32_vs_ref64": rel(np.array(real), ref64),
             "port32_vs_ref64": rel(port32, ref64),
             "port32_vs_ref32": rel(port32, np.array(real))}
    print(json.dumps(drift))
    assert drift["port64_vs_ref64"] < 1e-4
    assert drift["ref32_vs_ref64"] > 1e-3
    assert drift["port32_vs_ref64"] < drift["ref32_vs_ref64"]
