"""Graceful preemption: trap SIGTERM/SIGINT as a signal-safe flag.

Counterpart of :mod:`tpudist.resilience.preempt`. A preemption delivers
SIGTERM with a grace window; the default disposition kills the world
mid-step and loses everything since the last cadence checkpoint.
:class:`PreemptionGuard` turns the signal into a flag that
:func:`tpudist_torch.train.fit` checks at step boundaries: the in-flight
step finishes, a synchronous emergency checkpoint is written, and the
process exits with :data:`~tpudist_torch.resilience.exitcodes.EXIT_PREEMPTED`
(75), the code the supervisor restarts on.

Signal safety: the handler does nothing but assign one attribute (an
atomic bytecode under the GIL). Everything expensive happens later, on
the main thread, at a step boundary.

Escalation: repeated signals while the graceful path runs are absorbed up
to :data:`PreemptionGuard.MAX_ABSORBED`; past that the original
disposition is restored and the signal delivered again, so a wedged
shutdown can always be killed.
"""

from __future__ import annotations

import signal
import threading

from tpudist_torch.resilience.exitcodes import EXIT_PREEMPTED


class Preempted(SystemExit):
    """Raised by ``fit()`` after a completed graceful-preemption shutdown
    (emergency checkpoint durable).

    A :class:`SystemExit` subclass carrying ``code == EXIT_PREEMPTED``:
    un-caught, the interpreter exits 75 and the supervisor resumes the
    job — ``main.py`` and the example trainers need no handler at all.
    Library callers catch it explicitly: ``state`` and ``losses`` carry
    the final train state and per-step loss history (what ``fit`` would
    have returned), so a notebook run interrupted WITHOUT a
    ``checkpoint_dir`` still hands the trained state back instead of
    losing it with the exception.
    """

    def __init__(self, signum: int | None = None, step: int | None = None,
                 *, state=None, losses=None):
        super().__init__(EXIT_PREEMPTED)
        self.signum = signum
        self.step = step
        self.state = state
        self.losses = losses

    def __str__(self) -> str:
        name = (
            signal.Signals(self.signum).name
            if self.signum is not None else "signal"
        )
        return (
            f"preempted by {name} at step {self.step}; emergency state "
            f"persisted, exiting {EXIT_PREEMPTED} for a supervised resume"
        )


class PreemptionGuard:
    """Context manager installing the flag-setting handlers.

    ``signals`` defaults to (SIGTERM, SIGINT) — the scheduler's preemption
    notice and the operator's Ctrl-C both mean "stop cleanly, keep the
    work". Installation only succeeds on the main thread (CPython's
    constraint); elsewhere — or with ``enabled=False`` — the guard is
    inert and :attr:`tripped` stays ``None`` forever, so ``fit()`` can
    hold one code path for both cases.
    """

    MAX_ABSORBED = 3

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT), *,
                 enabled: bool = True):
        self._signals = tuple(signals)
        self._enabled = enabled
        self._previous: dict[int, object] = {}
        self._hits = 0
        self.tripped: int | None = None
        self.active = False

    # the handler body: one attribute store each — async-signal-safe by
    # construction (no locks, no allocation beyond the int boxing)
    def _handle(self, signum, frame):
        self._hits += 1
        if self.tripped is None:
            self.tripped = signum
            return
        if self._hits > self.MAX_ABSORBED:
            # a wedged graceful path must stay killable: restore whatever
            # disposition we displaced and re-deliver
            old = self._previous.get(signum, signal.SIG_DFL)
            signal.signal(signum, old)
            if callable(old):
                old(signum, frame)
            else:
                signal.raise_signal(signum)

    def __enter__(self) -> "PreemptionGuard":
        if not self._enabled:
            return self
        if threading.current_thread() is not threading.main_thread():
            return self  # signal.signal would raise ValueError; stay inert
        try:
            for s in self._signals:
                self._previous[s] = signal.signal(s, self._handle)
        except (ValueError, OSError):
            # partially installed (embedded interpreter, exotic platform):
            # roll back what went in and stay inert
            self._restore()
            return self
        self.active = True
        return self

    def _restore(self) -> None:
        for s, old in self._previous.items():
            try:
                signal.signal(s, old)
            except (ValueError, OSError):
                pass
        self._previous.clear()
        self.active = False

    def __exit__(self, *exc) -> None:
        self._restore()
