"""The process exit-code contract between the trainer and the supervisor.

Counterpart of :mod:`tpudist.resilience.exitcodes`, the same codes and
environment names. A planned interrupt (a preemption or a maintenance
event) arrives as SIGTERM with a grace window, and the one bit the dying
process can hand its supervisor is its exit code. The trainer
(:func:`tpudist_torch.train.fit` through
:mod:`tpudist_torch.resilience.preempt`) exits with one of these codes,
and the supervisor (``tpudist_torch.launch`` through
:mod:`tpudist_torch.resilience.supervisor`) restarts at once only the
codes that say "resume me":

- ``EXIT_PREEMPTED`` (75, BSD's EX_TEMPFAIL): the run trapped
  SIGTERM/SIGINT, finished its in-flight step, wrote a synchronous
  emergency checkpoint and exited on purpose: relaunch and resume.
- ``EXIT_HANG`` (76, EX_PROTOCOL): a hang watchdog ended a wedged
  process: relaunch from the last checkpoint.
- ``EXIT_REPAIR`` (77): an in-process repair loop asked for a fresh
  process: relaunch.
- ``EXIT_INTERRUPT`` (130, 128+SIGINT): operator Ctrl-C at the launcher,
  never restarted.
- anything else non-zero is a crash, restarted only within
  ``--max_restarts`` attempts (with backoff).

75/76/77 sit in the 64..78 sysexits range, clear of shell conventions
(126/127), signal deaths (128+N) and ordinary ``sys.exit(1)`` crashes.
"""

from __future__ import annotations

import os

EXIT_OK = 0
EXIT_CRASH = 1
EXIT_PREEMPTED = 75
EXIT_HANG = 76
EXIT_REPAIR = 77
EXIT_INTERRUPT = 130

#: codes whose meaning is "state is durable, relaunch me" — the trainer
#: exited deliberately after persisting what it could
RESTARTABLE = frozenset({EXIT_PREEMPTED, EXIT_HANG, EXIT_REPAIR})

#: the supervisor exports each world's generation under this name; rank
#: telemetry reads it so heartbeats/reports are attributable across the
#: lives of one logical job (0 = first launch)
GENERATION_ENV = "TPUDIST_RESTART_GENERATION"

#: the supervisor exports the exit codes of every PREVIOUS generation of
#: this job under this name (comma-separated, oldest first; unset/empty on
#: a first launch) — the run report records it, so one file reconstructs
#: the incident timeline across the lives of the job
EXIT_HISTORY_ENV = "TPUDIST_EXIT_HISTORY"

#: one stable id per logical job, minted once at launcher bring-up and
#: exported to every rank and every relaunched generation — telemetry rows
#: carry it so offline stitching (``tools/tracelens.py``) can group the
#: segments of a multi-generation incident without filename heuristics
RUN_ID_ENV = "TPUDIST_RUN_ID"


def is_restartable(rc: int) -> bool:
    """True iff ``rc`` is a deliberate checkpoint-and-exit code (signal
    deaths arrive as negative codes from ``Popen`` and are crashes)."""
    return rc in RESTARTABLE


def restart_generation(environ=None) -> int:
    """This process's restart generation (``TPUDIST_RESTART_GENERATION``,
    default 0). Tolerant of garbage values: telemetry must not die on a
    malformed environment."""
    raw = (environ or os.environ).get(GENERATION_ENV, "0")
    try:
        return int(raw)
    except (TypeError, ValueError):
        return 0


def run_id(environ=None) -> str | None:
    """The job's stable run id (``TPUDIST_RUN_ID``), or ``None`` when no
    launcher/caller exported one. Whitespace-only values count as unset —
    telemetry must not die on a malformed environment."""
    raw = (environ or os.environ).get(RUN_ID_ENV)
    if raw is None:
        return None
    raw = str(raw).strip()
    return raw or None


def ensure_run_id(environ=None) -> str:
    """Read-or-mint the job's run id and EXPORT it into ``environ`` so
    every child process (all ranks, all relaunched generations — the
    supervisor spawns children with a copy of this environment) inherits
    the same id. The launcher calls this once at bring-up; everything
    else only *reads* via :func:`run_id`."""
    import uuid

    env = environ if environ is not None else os.environ
    existing = run_id(env)
    if existing is not None:
        return existing
    minted = uuid.uuid4().hex[:12]
    env[RUN_ID_ENV] = minted
    return minted


def exit_history(environ=None) -> list[int]:
    """The exit codes of this job's previous generations
    (``TPUDIST_EXIT_HISTORY``, oldest first; ``[]`` on a first launch or
    under a supervisor that predates the variable). Garbage entries are
    dropped, not fatal — accounting, never a crash source."""
    raw = (environ or os.environ).get(EXIT_HISTORY_ENV, "")
    out = []
    for part in str(raw).split(","):
        part = part.strip()
        if not part:
            continue
        try:
            out.append(int(part))
        except ValueError:
            continue
    return out
