"""Process launcher: the ``torch.distributed.launch`` of the port.

Counterpart of :mod:`tpudist.launch`, the same command line::

    python -m tpudist_torch.launch --nproc_per_node=N \
        [--nnode=M --node_rank=r --master_addr=A --master_port=P] \
        [--max_restarts K] tpudist_torch/main.py --batch_size 128 --JobID Job0

It spawns ``nproc_per_node`` local processes, exports ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` to each
(the ``env://`` contract :func:`tpudist_torch.distributed.init_from_env`
reads) and injects ``--local_rank=i`` into its argv. One process drives
one card. The checkout's root is put on the children's ``PYTHONPATH``, so
``tpudist_torch/main.py`` and ``tpudist_torch/train_gpt2.py`` run as
script paths from a checkout that is not installed.

Beyond fail-fast (one dead rank drains the world), the launcher is a
supervisor (:mod:`tpudist_torch.resilience.supervisor`): exit codes 75
(preempted), 76 (hang) and 77 (repair) mean the trainer persisted its
state and asked to be relaunched, and restart at once whatever
``--max_restarts`` says, bounded by the ``--restart_budget`` /
``--restart_window`` rolling window; any other non-zero exit is a crash,
restarted only within ``--max_restarts`` attempts with exponential backoff
and jitter. Every generation gets ``TPUDIST_RESTART_GENERATION``, and
SIGTERM to the launcher is forwarded to the children (their graceful
preemption trigger) and stops the restart loop.

``--emulate-devices`` gives a JAX process fake CPU devices; PyTorch has no
counterpart (the port's CPU world is ranks with ``--device cpu`` on
gloo), so only ``0`` is accepted.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpudist_torch.launch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    # flag names match torch.distributed.launch as used in README.md:14,28,34
    p.add_argument("--nproc_per_node", type=int, default=1)
    p.add_argument("--nnode", "--nnodes", type=int, default=1, dest="nnode")
    p.add_argument("--node_rank", type=int, default=0)
    p.add_argument("--master_addr", type=str, default="127.0.0.1")
    p.add_argument("--master_port", type=int, default=29500)
    p.add_argument(
        "--emulate-devices", type=str, default="0",
        help="fake CPU devices for a JAX process; PyTorch has none, so only "
        "0 is accepted (run ranks with the trainer's --device cpu instead)",
    )
    p.add_argument("--no_python", action="store_true",
                   help="run the script as an executable instead of `python script`")
    p.add_argument(
        "--max_restarts", type=int, default=0,
        help="relaunch this node's processes up to N times after a CRASH "
        "(any non-zero exit other than the restartable codes 75/76/77) — "
        "recovery beyond fail-fast; pair with the trainer's "
        "--checkpoint_dir so the relaunched run resumes from the last "
        "checkpoint. 0 = fail fast on crashes. Restartable exits (preempted=75, watchdog hang=76, repair-restart=77) "
        "restart regardless, bounded only by the restart budget.",
    )
    p.add_argument(
        "--restart_budget", type=int, default=10,
        help="circuit breaker: at most N restarts (of any kind) per "
        "--restart_window seconds, then give up with the world's exit "
        "code — a deterministically-crashing or instantly-re-preempted "
        "job exhausts its budget instead of spinning. 0 = unlimited.",
    )
    p.add_argument(
        "--restart_window", type=float, default=600.0,
        help="the rolling window (seconds) the restart budget counts in",
    )
    p.add_argument(
        "--backoff_base", type=float, default=1.0,
        help="first crash-restart delay (seconds); doubles per consecutive "
        "crash up to --backoff_max, with ±50%% jitter so a fleet of "
        "launchers never stampedes the rendezvous port in lockstep. "
        "Restartable exits (75/76/77) relaunch without backoff.",
    )
    p.add_argument(
        "--backoff_max", type=float, default=60.0,
        help="crash-restart backoff ceiling (seconds, pre-jitter)",
    )
    p.add_argument(
        "--term_grace", type=float, default=30.0,
        help="seconds to wait for a terminated child to exit before "
        "SIGKILL. Also the voluntary-exit window granted to siblings when "
        "a rank exits with a restartable code: they likely received the "
        "same preemption signal and are mid-emergency-checkpoint — a "
        "SIGTERM now would escalate past their graceful handler. Raise "
        "it for models whose emergency save takes longer.",
    )
    p.add_argument("script", type=str)
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    return p


def _check_emulate(args) -> None:
    if any(v.strip() not in ("", "0")
           for v in str(args.emulate_devices).split(",")):
        raise NotImplementedError(
            f"--emulate-devices={args.emulate_devices}: fake CPU devices are "
            "a JAX mechanism with no PyTorch counterpart; a CPU world here is "
            "ranks of the trainer with --device cpu on gloo")


def _children_pythonpath(environ) -> str:
    """``PYTHONPATH`` with the checkout's root in front, so a child that
    runs ``tpudist_torch/main.py`` as a script (``sys.path[0]`` is then
    ``tpudist_torch/``) imports the package from an uninstalled
    checkout."""
    root = str(Path(__file__).resolve().parent.parent)
    parts = [p for p in environ.get("PYTHONPATH", "").split(os.pathsep) if p]
    return os.pathsep.join([root] + [p for p in parts if p != root])


def main(argv: list[str] | None = None) -> int:
    from tpudist_torch.resilience.exitcodes import ensure_run_id
    from tpudist_torch.resilience.supervisor import (
        BackoffPolicy, RestartBudget, Supervisor,
    )

    args = build_parser().parse_args(argv)
    _check_emulate(args)
    # one stable run id for the job's whole life: minted here (or inherited
    # from an outer launcher), exported via the environment every child —
    # all ranks, all restart generations — is spawned with, so telemetry
    # rows from one logical job stitch without filename heuristics
    ensure_run_id(os.environ)
    # one handler for the launcher's whole life, closing over the CURRENT
    # generation's procs: a SIGTERM landing between generations (previous
    # world dead, next one mid-spawn) still sets the stop flag and
    # terminates whatever is alive, so the restart loop can never spawn or
    # keep a world past an operator stop. The children's SIGTERM is their
    # graceful-preemption trigger (tpudist_torch.resilience.preempt) — they get
    # --term_grace to write their emergency checkpoints before any KILL.
    stop = {"terminated": False, "procs": []}

    def _kill(signum, frame):
        stop["terminated"] = True
        for p in stop["procs"]:
            if p.poll() is None:
                p.terminate()

    signal.signal(signal.SIGTERM, _kill)
    sup = Supervisor(
        lambda generation: _run_world(args, stop, generation=generation),
        max_restarts=args.max_restarts,
        budget=RestartBudget(args.restart_budget, args.restart_window),
        backoff=BackoffPolicy(args.backoff_base, args.backoff_max),
        stop=lambda: stop["terminated"],
    )
    return sup.run()


def _drain_world(procs: list[subprocess.Popen], grace_s: float, *,
                 voluntary_s: float = 0.0) -> None:
    """Reap EVERY child before returning — the launcher must never hand
    the next restart generation a world whose predecessors still hold
    ``MASTER_PORT`` or the checkpoint-dir locks (a terminated child is
    not a dead child until ``wait()`` says so).

    ``voluntary_s`` first waits that long for children to exit on their
    own with NO signal sent: a preempted world's siblings received the
    same SIGTERM the exiting rank did and are mid-emergency-checkpoint —
    terminating them now would escalate past their graceful handler and
    lose exactly the state the preemption path exists to save. Then the
    sweep: SIGTERM, up to ``grace_s`` to finish, SIGKILL stragglers, and
    an unconditional ``wait()`` on every child.
    """
    if voluntary_s > 0:
        deadline = time.monotonic() + voluntary_s
        while (any(p.poll() is None for p in procs)
               and time.monotonic() < deadline):
            time.sleep(0.05)
    for p in procs:
        if p.poll() is None:
            p.terminate()
    deadline = time.monotonic() + max(grace_s, 0.0)
    while (any(p.poll() is None for p in procs)
           and time.monotonic() < deadline):
        time.sleep(0.05)
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def _run_world(args, stop: dict | None = None, generation: int = 0) -> int:
    """Spawn, supervise, and fully REAP one generation of this node's
    processes (every exit path drains the world — no child outlives the
    return)."""
    from tpudist_torch.resilience.exitcodes import GENERATION_ENV, is_restartable

    if stop is None:
        stop = {"terminated": False, "procs": []}
    world_size = args.nnode * args.nproc_per_node
    procs: list[subprocess.Popen] = stop["procs"]
    procs.clear()
    for local_rank in range(args.nproc_per_node):
        if stop["terminated"]:
            break  # operator stop arrived mid-spawn; don't widen the world
        rank = args.node_rank * args.nproc_per_node + local_rank
        env = dict(os.environ)
        env.update(
            MASTER_ADDR=args.master_addr,
            MASTER_PORT=str(args.master_port),
            RANK=str(rank),
            WORLD_SIZE=str(world_size),
            LOCAL_RANK=str(local_rank),
        )
        # which life of the job this is: telemetry stamps heartbeats and
        # the run report with it, goodput aggregates across it
        env[GENERATION_ENV] = str(generation)
        env["PYTHONPATH"] = _children_pythonpath(env)
        cmd = [] if args.no_python else [sys.executable, "-u"]
        cmd = cmd + [args.script, f"--local_rank={local_rank}"] + args.script_args
        procs.append(subprocess.Popen(cmd, env=env))

    rc = 0
    try:
        # poll all children: the first non-zero exit drains the rest so a
        # dead rank can't leave the world hung in a collective (a static
        # world, fail-fast) — and the drain WAITS on every terminated child, so the next restart generation
        # can never race still-dying processes for MASTER_PORT or the
        # checkpoint-dir locks
        live = list(procs)
        while live:
            if stop["terminated"]:
                # operator stop: the signal handler already SIGTERM'd the
                # world (the children's graceful trigger); grant the grace
                # window before the kill sweep, and reap everything
                _drain_world(procs, args.term_grace,
                             voluntary_s=args.term_grace)
                for p in procs:
                    if p.returncode and rc == 0:
                        rc = p.returncode
                return rc
            for p in list(live):
                code = p.poll()
                if code is None:
                    continue
                live.remove(p)
                if code != 0 and rc == 0:
                    rc = code
            if rc != 0 and live:
                # restartable exit: the siblings most likely trapped the
                # same preemption signal and are writing their own
                # emergency checkpoints — give them the voluntary window
                # before any terminate. A crash exit keeps fail-fast:
                # terminate immediately (grace, then kill).
                _drain_world(
                    live, args.term_grace,
                    voluntary_s=args.term_grace if is_restartable(rc) else 0.0,
                )
                live = []
            if live:
                time.sleep(0.2)
    except KeyboardInterrupt:
        _drain_world(procs, args.term_grace)
        rc = 130
    return rc


if __name__ == "__main__":
    sys.exit(main())
