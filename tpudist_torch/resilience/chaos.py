"""Fault injection: a deterministic crash, hang, SIGTERM or corruption at a step.

Counterpart of :mod:`tpudist.resilience.chaos`, the same grammar
(``ChaosSpec.parse``; ``parse_chaos`` takes a comma-separated list)::

    <kind>[:<n>]@<step>[@<generation>]

    crash@12        raise ChaosCrash after step 12 completes (gen 0 only)
    sigterm@12      SIGTERM self after step 12 (the preemption drill)
    hang:600@12     block the loop 600 s after step 12
    corrupt@12      truncate the NEWEST checkpoint's files after step 12,
                    then crash: the die-mid-write drill that
                    ``Checkpointer.restore``'s fallback walk must absorb
    nanburst:3@12   poison the input batches of steps 13..15 with NaNs
    crash@5@*       crash at step 5 in EVERY generation: the deterministic
                    crash that must exhaust the supervisor's budget
    bitflip@12      parses; its consumer is the replica-divergence probe,
                    which is not ported yet, so an injector refuses it

The generation field defaults to ``0``: an injected incident happens once,
in the first life of the job, and the relaunched generation (which
resumes at the trigger step) does not fire it again; ``*`` fires in every
generation. :func:`tpudist_torch.train.fit` calls
:meth:`ChaosInjector.maybe_fire` with the number of completed steps at
each boundary, before it dispatches the next step, so ``sigterm@k``
gives an emergency checkpoint at step ``k`` on one rank and a resume at
``k+1``; ``nanburst`` rides :meth:`ChaosInjector.wrap_batches` around the
host batches instead.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import sys
import time

from tpudist_torch.resilience.exitcodes import restart_generation

__all__ = ["ChaosCrash", "ChaosSpec", "ChaosInjector", "make_injector",
           "parse_chaos", "corrupt_latest_checkpoint"]

KINDS = ("crash", "hang", "sigterm", "corrupt", "bitflip", "nanburst")
#: kinds that fire at a step boundary through maybe_fire (nanburst wraps
#: the input stream)
BOUNDARY_KINDS = ("crash", "hang", "sigterm", "corrupt")
DEFAULT_HANG_S = 3600.0


class ChaosCrash(RuntimeError):
    """The injected deterministic crash: a real exception through the
    real crash path (fit's handler, the launcher's non-restartable
    exit)."""


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    kind: str
    step: int
    duration_s: float = DEFAULT_HANG_S
    generation: int | None = 0  # None = every generation ("*")
    count: int = 1  # nanburst only: consecutive poisoned steps

    @classmethod
    def parse(cls, spec: str) -> "ChaosSpec":
        parts = str(spec).strip().split("@")
        if len(parts) not in (2, 3):
            raise ValueError(
                f"chaos spec {spec!r} is not '<kind>[:<n>]@<step>"
                f"[@<generation>|@*]'"
            )
        head, step_s = parts[0], parts[1]
        kind, _, dur = head.partition(":")
        if kind not in KINDS:
            raise ValueError(
                f"chaos kind {kind!r} not in {KINDS} (spec {spec!r})"
            )
        duration = float(dur) if dur and kind == "hang" else DEFAULT_HANG_S
        count = 1
        if kind == "nanburst" and dur:
            count = int(dur)
            if count < 1:
                raise ValueError(
                    f"nanburst count must be >= 1 (spec {spec!r})"
                )
        if dur and kind not in ("hang", "nanburst"):
            raise ValueError(
                f"only 'hang' (seconds) and 'nanburst' (step count) take "
                f"a ':<n>' field (spec {spec!r})"
            )
        gen: int | None = 0
        if len(parts) == 3:
            gen = None if parts[2] == "*" else int(parts[2])
        return cls(kind=kind, step=int(step_s), duration_s=duration,
                   generation=gen, count=count)


def parse_chaos(spec: str) -> list[ChaosSpec]:
    """One ``--chaos`` string → specs. Single-spec strings parse exactly
    as before (byte-compatible grammar); commas compose several injections
    into one drill."""
    out = [ChaosSpec.parse(p) for p in str(spec).split(",") if p.strip()]
    if not out:
        raise ValueError(f"chaos spec {spec!r} names no injection")
    return out


class ChaosInjector:
    """One-shot triggers bound to this process's restart generation.

    Accepts one spec or a list (``parse_chaos``); each spec fires at most
    once in a process; ``fired`` is True once every spec has fired. A ``bitflip`` spec
    is refused here (``NotImplementedError``): its consumer, the
    replica-divergence probe, is not ported yet (ROADMAP Queue 1 #8).
    """

    def __init__(self, spec, *, generation: int | None = None,
                 sleep=time.sleep, kill=os.kill):
        specs = [spec] if isinstance(spec, ChaosSpec) else list(spec)
        if not specs:
            raise ValueError("ChaosInjector needs at least one spec")
        for sp in specs:
            if sp.kind == "bitflip":
                raise NotImplementedError(
                    "chaos kind 'bitflip' is not ported yet (ROADMAP Queue 1 "
                    "#8): its consumer is the replica-divergence probe")
        self.specs: list[ChaosSpec] = specs
        self._fired = [False] * len(specs)
        self.generation = (
            restart_generation() if generation is None else int(generation)
        )
        self._sleep = sleep
        self._kill = kill
        # the corrupt drill's target; fit() binds its checkpoint_dir
        self.checkpoint_dir = None
        self._wait = None

    @property
    def fired(self) -> bool:
        return all(self._fired)

    def _armed(self, sp: ChaosSpec) -> bool:
        return sp.generation is None or self.generation == sp.generation

    def bind(self, checkpoint_dir, wait=None) -> "ChaosInjector":
        """Attach the run's checkpoint dir (the ``corrupt`` kind's
        target) and optionally the checkpointer's ``wait`` (so the drill
        corrupts a DETERMINISTIC step: the newest save is made durable
        before the truncation, instead of racing the async commit);
        chained so ``make_injector(...).bind(dir)`` reads naturally.
        No-op for the other kinds."""
        self.checkpoint_dir = checkpoint_dir
        self._wait = wait
        return self

    def maybe_fire(self, completed_step: int) -> bool:
        """Fire due boundary-kind specs once ``completed_step`` reaches
        their step in an armed generation. Returns True if any fired
        (crash/corrupt raise instead)."""
        fired_any = False
        for i, sp in enumerate(self.specs):
            if sp.kind not in BOUNDARY_KINDS:
                continue
            if (self._fired[i] or completed_step < sp.step
                    or not self._armed(sp)):
                continue
            self._fired[i] = True
            fired_any = True
            if sp.kind == "crash":
                raise ChaosCrash(
                    f"chaos: injected crash after step {completed_step} "
                    f"(generation {self.generation})"
                )
            if sp.kind == "hang":
                self._sleep(sp.duration_s)
                continue
            if sp.kind == "corrupt":
                if self._wait is not None:
                    # settle async saves: corrupt a committed step
                    self._wait()
                corrupt_latest_checkpoint(self.checkpoint_dir)
                # then die the way a real mid-write preemption does: a
                # hard crash, so the supervisor's relaunch exercises the
                # fallback walk end to end
                raise ChaosCrash(
                    f"chaos: corrupted newest checkpoint after step "
                    f"{completed_step} (generation {self.generation})"
                )
            # sigterm: the preemption drill — the signal lands on this
            # very process; with fit()'s PreemptionGuard installed the
            # flag is set before the next step dispatches
            self._kill(os.getpid(), signal.SIGTERM)
        return fired_any

    def wrap_batches(self, batches, first_step: int):
        """The ``nanburst`` drill: wrap an epoch's batch iterator so the
        batches feeding steps ``(spec.step, spec.step + count]`` carry a
        NaN in their first float leaf: ``count`` consecutive non-finite
        steps, which ``--amp``'s guard skips one at a time.
        ``first_step`` is the step the iterator's first batch will train
        (fit passes ``global_step + 1`` when it builds each epoch's
        stream; the prefetch consuming ahead is fine, the mapping is
        positional)."""
        bursts = [
            i for i, sp in enumerate(self.specs)
            if sp.kind == "nanburst" and self._armed(sp)
        ]
        if not bursts:
            return batches

        def _gen():
            for j, batch in enumerate(batches):
                s = first_step + j  # the step this batch trains
                for i in bursts:
                    sp = self.specs[i]
                    if sp.step < s <= sp.step + sp.count:
                        self._fired[i] = True
                        batch = _poison_batch(batch, s)
                yield batch

        return _gen()


def _poison_batch(batch, step: int):
    """One NaN in the first float leaf — enough to make the loss (and the
    whole backward) non-finite. Copies the poisoned leaf only."""
    import numpy as np

    out = dict(batch)
    for k, v in batch.items():
        if k.startswith("_"):
            continue
        arr = np.asarray(v)
        if np.issubdtype(arr.dtype, np.floating):
            arr = np.array(arr, copy=True)
            arr.reshape(-1)[:1] = np.nan
            out[k] = arr
            return out
    raise ChaosCrash(
        f"chaos: nanburst at step {step} found no float batch leaf to "
        "poison (integer-token batches have no NaN representation — "
        "drill spikes on a float-input model, or use bitflip for SDCs)"
    )


def corrupt_latest_checkpoint(checkpoint_dir) -> int:
    """Truncate every file of the NEWEST step dir under
    ``checkpoint_dir`` to half its size — the torn state a preemption
    landing mid-checkpoint-write leaves behind. The dir itself survives
    (so ``latest_step`` still points at it: exactly the poisoned-resume
    scenario the fallback walk exists for). Returns the corrupted step."""
    from pathlib import Path

    from tpudist_torch.checkpoint import latest_step

    if checkpoint_dir is None:
        raise ChaosCrash(
            "chaos: corrupt@step needs a checkpoint_dir (fit binds it; "
            "standalone injectors use .bind(dir))"
        )
    step = latest_step(checkpoint_dir)
    if step is None:
        raise ChaosCrash(
            f"chaos: corrupt@step found no checkpoint under "
            f"{checkpoint_dir} to corrupt — schedule it after the first "
            "save (checkpoint_every)"
        )
    step_dir = Path(checkpoint_dir) / str(step)
    for f in sorted(p for p in step_dir.rglob("*") if p.is_file()):
        size = f.stat().st_size
        with open(f, "r+b") as fh:
            fh.truncate(size // 2)
    return step


def make_injector(chaos) -> ChaosInjector | None:
    """``fit()``'s coercion point: None | spec string (single or
    comma-separated) | ChaosSpec | list of ChaosSpecs | ready-made
    ChaosInjector."""
    if chaos is None:
        return None
    if isinstance(chaos, ChaosInjector):
        return chaos
    if isinstance(chaos, ChaosSpec):
        return ChaosInjector(chaos)
    if isinstance(chaos, (list, tuple)):
        return ChaosInjector(list(chaos))
    return ChaosInjector(parse_chaos(chaos))
