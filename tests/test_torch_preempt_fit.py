"""Preemption and recovery inside the port's ``fit``, on the CPU, in
process: a chaos-injected SIGTERM at step k makes ``fit`` finish the step,
write a synchronous checkpoint at exactly k and raise ``Preempted`` (exit
75); a crash takes the crash path; the next life (generation 1, the same
arguments, chaos included) resumes at k+1. Every resumed run is held
BIT-identical (``torch.equal``, float32 and the bf16 copy) to a run that
was never stopped, in its losses and in every tensor of its final
checkpoint:

- ResNet-18 with ``--fused optimizer --amp`` (the bf16 compute copy and
  the guard), stopped mid-epoch by ``sigterm`` and by ``crash``;
- a tiny GPT-2 with dropout 0.1 and ``grad_accum`` 2 (the masks are keyed
  by step, so a resumed step draws its own);
- the ``DeviceCachedLoader`` (the gather in the step, ``iter_from`` on
  indices).

Also: the time cadence, a SIGTERM while the input is stalled, a preemption
without checkpoints, ``preempt=False``, and ``nanburst`` behind the guard."""

import signal
import threading
import time

import numpy as np
import pytest
import torch
from torch import nn

from tpudist_torch.amp import skipped_steps
from tpudist_torch.checkpoint import latest_step, read_step
from tpudist_torch.data.cifar import synthetic_cifar, to_tensor
from tpudist_torch.data.device_cache import DeviceCachedLoader
from tpudist_torch.data.lm import TokenWindowLoader
from tpudist_torch.data.loader import DataLoader
from tpudist_torch.data.sampler import DistributedSampler
from tpudist_torch.models.gpt2 import GPT2
from tpudist_torch.models.resnet import resnet18
from tpudist_torch.optim import make_optimizer
from tpudist_torch.resilience import GENERATION_ENV, ChaosCrash, Preempted
from tpudist_torch.train import fit, lm_loss


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _first_generation(monkeypatch):
    monkeypatch.delenv(GENERATION_ENV, raising=False)


def _identical(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k, v in a.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, b[k]), k
        else:
            assert v == b[k], k


def _resumed_equals_uninterrupted(tmp_path, monkeypatch, run, *, chaos, k,
                                  total, last=None):
    """``run(ckpt_dir, chaos)`` trains to the end; stopped by ``chaos`` at
    step k, then resumed in generation 1, it must give the uninterrupted
    run's losses from step k+1 and the same final checkpoint."""
    _, full = run(tmp_path / "full", None)
    assert len(full) == total
    kind = chaos.split("@")[0]
    if kind == "sigterm":
        with pytest.raises(Preempted) as ei:
            run(tmp_path / "cut", chaos)
        assert (ei.value.code, ei.value.step, ei.value.signum) == (
            75, k, signal.SIGTERM)
        assert ei.value.losses == full[:k]
        assert latest_step(tmp_path / "cut") == k  # the emergency save
    else:
        with pytest.raises(ChaosCrash):
            run(tmp_path / "cut", chaos)
        k = latest_step(tmp_path / "cut")  # the last cadence save
    monkeypatch.setenv(GENERATION_ENV, "1")
    state, rest = run(tmp_path / "cut", chaos)
    assert state.step == total and rest == full[k:]
    _identical(read_step(tmp_path / "cut", last or total),
               read_step(tmp_path / "full", last or total))


def _resnet_run(tmp_path):
    data = synthetic_cifar(48, num_classes=10, seed=4)

    def run(ckpt, chaos):
        model = resnet18(num_filters=8, num_classes=10, small_inputs=True,
                         dtype=torch.bfloat16, device="cpu")
        tx = make_optimizer(1e-3, fused=True, compute_dtype=torch.bfloat16,
                            skip_nonfinite_updates=True)
        return fit(model, tx, DataLoader(data, 8, transform=to_tensor),
                   epochs=2, fused="optimizer", profile=False,
                   log_dir=str(tmp_path), checkpoint_dir=str(ckpt),
                   checkpoint_every=4, chaos=chaos)

    return run


@pytest.mark.parametrize("chaos", ["sigterm@7", "crash@7"])
def test_resnet_fused_amp_resumes_bit_identical(chaos, tmp_path, monkeypatch):
    """Step 7 of 12 is mid-epoch (6 steps an epoch): the resume starts
    epoch 1 at batch 1 (sigterm) or epoch 0 at batch 4 (crash, from the
    step-4 save)."""
    _resumed_equals_uninterrupted(tmp_path, monkeypatch, _resnet_run(tmp_path),
                                  chaos=chaos, k=7, total=12)


def test_gpt2_dropout_grad_accum_resumes_bit_identical(tmp_path, monkeypatch):
    rng = np.random.Generator(np.random.PCG64(0))
    tokens = rng.integers(0, 64, 16 * 12 * 4 + 1).astype(np.int32)

    def run(ckpt, chaos):
        model = GPT2(vocab_size=64, max_seq_len=16, hidden_dim=32, depth=2,
                     num_heads=2, dropout=0.1, device="cpu", seed=1)
        tx = make_optimizer(1e-3, weight_decay=0.1, clip_norm=1.0,
                            fused=True)
        loader = TokenWindowLoader(tokens, 4, 16, seed=2)  # 2 x 2 microbatches
        return fit(model, tx, loader, epochs=2, loss_fn=lm_loss,
                   input_key="tokens", label_key="tokens", grad_accum=2,
                   fused="all", seed=5, profile=False, log_dir=str(tmp_path),
                   checkpoint_dir=str(ckpt), checkpoint_every=3, chaos=chaos)

    _resumed_equals_uninterrupted(tmp_path, monkeypatch, run,
                                  chaos="sigterm@10", k=10, total=24)


def test_device_cached_loader_resumes_bit_identical(tmp_path, monkeypatch):
    data = synthetic_cifar(40, num_classes=10, seed=6)

    def run(ckpt, chaos):
        model = resnet18(num_filters=8, num_classes=10, small_inputs=True,
                         device="cpu")
        loader = DeviceCachedLoader(data, 8, device="cpu",
                                    sampler=DistributedSampler(40, seed=3))
        post = loader.input_transform(
            lambda x: x.float() / torch.full((), 255.0))
        return fit(model, make_optimizer(1e-3), loader, epochs=2,
                   input_transform=post, profile=False,
                   log_dir=str(tmp_path), checkpoint_dir=str(ckpt),
                   checkpoint_every=4, chaos=chaos)

    _resumed_equals_uninterrupted(tmp_path, monkeypatch, run,
                                  chaos="sigterm@6", k=6, total=10)


class _TinyMlp(nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.a = nn.Parameter(torch.randn(13, 37, generator=g) * 0.3)
        self.b = nn.Parameter(torch.randn(37, 10, generator=g) * 0.3)

    def forward(self, x):
        return torch.relu(x @ self.a) @ self.b


def _mlp_data(n=64):
    rng = np.random.default_rng(0)
    return {"image": rng.normal(size=(n, 13)).astype(np.float32),
            "label": (rng.random(n) * 10).astype(np.int32)}


def _mlp_fit(tmp_path, loader=None, **kw):
    return fit(_TinyMlp(), make_optimizer(1e-2), loader or DataLoader(
        _mlp_data(), 16), epochs=kw.pop("epochs", 2), profile=False,
        log_dir=str(tmp_path), **kw)


def test_sigterm_without_checkpoints_still_exits_75_with_the_state(tmp_path):
    with pytest.raises(Preempted) as ei:
        _mlp_fit(tmp_path, chaos="sigterm@3")
    assert ei.value.code == 75 and ei.value.step == 3
    assert ei.value.state.step == 3 and len(ei.value.losses) == 3


def test_crash_takes_the_crash_path(tmp_path):
    with pytest.raises(ChaosCrash, match="after step 2"):
        _mlp_fit(tmp_path, chaos="crash@2", checkpoint_dir=str(tmp_path / "c"),
                 checkpoint_every=1)
    # the async save of step 2 was made durable on the way out
    assert latest_step(tmp_path / "c") == 2
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL


def test_time_cadence_saves_on_the_clock(tmp_path):
    _mlp_fit(tmp_path, checkpoint_dir=str(tmp_path / "c"),
             checkpoint_every_s=1e-9, keep_last=100)
    assert sorted(int(p.name) for p in (tmp_path / "c").iterdir()
                  if p.name.isdigit()) == list(range(1, 9))


def test_sigterm_during_a_stalled_input_still_preempts(tmp_path):
    """The notice lands while the loop waits on a wedged data source: the
    prefetch wait polls the flag, ends the stream, and fit takes the
    emergency-checkpoint path instead of waiting for the stall."""
    import os

    stalled = threading.Event()

    class StallingLoader(DataLoader):
        def iter_from(self, start_batch):
            for i, b in enumerate(super().iter_from(start_batch)):
                if i == 2:
                    stalled.set()
                    time.sleep(60)
                yield b

    def kill_once_blocked():
        stalled.wait(60)
        for _ in range(600):
            if (latest_step(tmp_path / "c") or 0) >= 1:
                break
            time.sleep(0.05)
        os.kill(os.getpid(), signal.SIGTERM)

    threading.Thread(target=kill_once_blocked, daemon=True).start()
    t0 = time.monotonic()
    with pytest.raises(Preempted) as ei:
        _mlp_fit(tmp_path, loader=StallingLoader(_mlp_data(), 16),
                 checkpoint_dir=str(tmp_path / "c"), checkpoint_every=1,
                 prefetch_depth=1)
    assert time.monotonic() - t0 < 30
    assert ei.value.code == 75
    # the steps the prefetch had staged before the stall ran; the last one
    # is the checkpoint
    assert ei.value.state.step == latest_step(tmp_path / "c") >= 1


def test_preempt_false_keeps_the_default_disposition(tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    seen = []

    class SpyLoader(DataLoader):
        def iter_from(self, start_batch):
            seen.append(signal.getsignal(signal.SIGTERM))
            return super().iter_from(start_batch)

    _mlp_fit(tmp_path, loader=SpyLoader(_mlp_data(32), 16), epochs=1,
             preempt=False)
    assert seen and all(h == before for h in seen)
    _mlp_fit(tmp_path, loader=SpyLoader(_mlp_data(32), 16), epochs=1)
    assert seen[-1] != before  # the default installs the guard
    assert signal.getsignal(signal.SIGTERM) == before


def test_nanburst_is_skipped_by_the_guard(tmp_path):
    """nanburst:3@2 poisons the batches of steps 3..5; behind --amp's
    guard each is a counted no-op."""
    tx = make_optimizer(1e-2, skip_nonfinite_updates=True)
    state, losses = fit(_TinyMlp(), tx, DataLoader(_mlp_data(), 16), epochs=2,
                        profile=False, log_dir=str(tmp_path),
                        chaos="nanburst:3@2")
    assert [np.isnan(x) for x in losses] == [False] * 2 + [True] * 3 + [
        False] * 3
    assert skipped_steps(state.opt_state) == 3
    assert state.opt_state.inner.count == 5
