"""Supervised restart: backoff, restart budget, generation accounting.

Counterpart of :mod:`tpudist.resilience.supervisor`: the policy half of
``tpudist_torch.launch`` (the spawn/reap half stays in
``tpudist_torch/launch.py``):

- **restartable fast path**: exit codes in
  :data:`~tpudist_torch.resilience.exitcodes.RESTARTABLE` (75 preempted,
  76 hang, 77 repair) mean the trainer persisted its state and asked to
  be relaunched: they restart at once whatever ``--max_restarts`` says,
  bounded only by the budget below;
- **crash path**: any other non-zero exit restarts only while the
  ``max_restarts`` attempt counter allows, with exponential backoff and
  jitter between attempts;
- **restart budget**: at most N restarts (of either kind) per rolling
  window of M seconds, so a job that crashes deterministically (or is
  preempted again at once) exhausts its budget instead of spinning;
- **generation counter**: the n-th world launched gets ``n`` exported as
  ``TPUDIST_RESTART_GENERATION``.

The policy objects (:class:`BackoffPolicy`, :class:`RestartBudget`,
:func:`classify`) are deterministic and injectable for tests; the
:class:`Supervisor` loop takes the world-runner as a callable.
"""

from __future__ import annotations

import collections
import dataclasses
import random
import sys
import time
from typing import Callable

from tpudist_torch.resilience.exitcodes import (
    EXIT_HISTORY_ENV,
    EXIT_INTERRUPT,
    EXIT_OK,
    is_restartable,
)

__all__ = [
    "BackoffPolicy",
    "RestartBudget",
    "Supervisor",
    "classify",
]


def classify(rc: int) -> str:
    """``"ok"`` | ``"stop"`` (operator interrupt) | ``"restartable"``
    (deliberate checkpoint-and-exit) | ``"crash"`` (everything else,
    including signal deaths, which ``Popen`` reports as negative)."""
    if rc == EXIT_OK:
        return "ok"
    if rc == EXIT_INTERRUPT:
        return "stop"
    if is_restartable(rc):
        return "restartable"
    return "crash"


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """``base · 2^(attempt-1)`` capped at ``max_s``, with ±``jitter``
    multiplicative noise (a fleet of launchers restarting in lockstep
    would otherwise stampede the rendezvous port every cycle)."""

    base_s: float = 1.0
    max_s: float = 60.0
    jitter: float = 0.5

    def delay_s(self, attempt: int, rng: random.Random) -> float:
        """Seconds to sleep before crash-restart number ``attempt``
        (1-based); 0 for attempt <= 0."""
        if attempt <= 0 or self.base_s <= 0:
            return 0.0
        d = min(self.base_s * (2.0 ** (attempt - 1)), self.max_s)
        return d * (1.0 + self.jitter * (2.0 * rng.random() - 1.0))


class RestartBudget:
    """At most ``max_restarts`` restarts per rolling ``window_s`` seconds.

    ``allow()`` prunes expired entries and answers; ``record()`` charges
    one restart. ``max_restarts <= 0`` or ``window_s <= 0`` disables the
    budget (always allowed) — the launcher's legacy behavior."""

    def __init__(self, max_restarts: int, window_s: float, *,
                 clock: Callable[[], float] = time.monotonic):
        self.max_restarts = int(max_restarts)
        self.window_s = float(window_s)
        self._clock = clock
        self._stamps: collections.deque[float] = collections.deque()

    def _prune(self) -> None:
        now = self._clock()
        while self._stamps and now - self._stamps[0] > self.window_s:
            self._stamps.popleft()

    def allow(self) -> bool:
        if self.max_restarts <= 0 or self.window_s <= 0:
            return True
        self._prune()
        return len(self._stamps) < self.max_restarts

    def record(self) -> None:
        self._stamps.append(self._clock())

    def used(self) -> int:
        self._prune()
        return len(self._stamps)


class Supervisor:
    """Drive ``run_world(generation) -> rc`` until done.

    ``stop`` is polled between generations (the launcher's SIGTERM flag):
    an operator stop returns the last rc without restarting, whatever the
    code said. ``sleep``/``rng`` are injectable for tests; ``log`` writes
    one line per decision (stderr by default — the launcher's channel).
    """

    def __init__(
        self,
        run_world: Callable[[int], int],
        *,
        max_restarts: int = 0,
        budget: RestartBudget | None = None,
        backoff: BackoffPolicy | None = None,
        stop: Callable[[], bool] | None = None,
        first_generation: int = 0,
        sleep: Callable[[float], None] = time.sleep,
        rng: random.Random | None = None,
        log: Callable[[str], None] | None = None,
        environ=None,
    ):
        self._run_world = run_world
        self.max_restarts = int(max_restarts)
        self.budget = budget or RestartBudget(0, 0.0)
        self.backoff = backoff or BackoffPolicy()
        self._stop = stop or (lambda: False)
        self.generation = int(first_generation)
        self._sleep = sleep
        self._rng = rng or random.Random()
        self._log = log or (
            lambda m: print(m, file=sys.stderr, flush=True)
        )
        # the per-generation exit-code record, oldest first — exported to
        # every RELAUNCHED world as TPUDIST_EXIT_HISTORY so the run
        # report can reconstruct the incident timeline in one file
        import os

        self._environ = os.environ if environ is None else environ
        self.exit_history: list[int] = []

    def run(self) -> int:
        crash_attempt = 0
        while True:
            rc = self._run_world(self.generation)
            self.exit_history.append(int(rc))
            kind = classify(rc)
            if kind in ("ok", "stop") or self._stop():
                return rc
            if not self.budget.allow():
                self._log(
                    f"tpudist_torch.launch: restart budget exhausted "
                    f"({self.budget.used()} restarts in the last "
                    f"{self.budget.window_s:.0f}s window); giving up rc={rc}"
                )
                return rc
            if kind == "restartable":
                # the trainer persisted state and asked to come back: no
                # backoff (real preemptions are minutes apart; a tight
                # 75-loop is what the budget window is for), and the
                # crash streak resets — a clean preempt is not a crash
                crash_attempt = 0
                delay = 0.0
                self._log(
                    f"tpudist_torch.launch: world exited rc={rc} (restartable); "
                    f"restarting generation {self.generation + 1}"
                )
            else:  # crash
                if crash_attempt >= self.max_restarts:
                    return rc
                crash_attempt += 1
                delay = self.backoff.delay_s(crash_attempt, self._rng)
                # message shape predates this module — keep it: operators
                # (and tests) grep for "restarting (a/N)"
                self._log(
                    f"tpudist_torch.launch: world exited rc={rc}; restarting "
                    f"({crash_attempt}/{self.max_restarts})"
                    + (f" after {delay:.1f}s backoff" if delay else "")
                )
            self.budget.record()
            if delay > 0:
                self._sleep(delay)
            if self._stop():
                # an operator stop that landed during the backoff sleep
                # must win over the pending restart
                return rc
            self.generation += 1
            # export the record BEFORE the relaunch: _run_world copies
            # the environment into each child, so the next generation's
            # run report sees every predecessor's exit code
            self._environ[EXIT_HISTORY_ENV] = ",".join(
                str(c) for c in self.exit_history
            )
