"""Resilience: the layer that turns failures into bounded-cost events.

Counterpart of :mod:`tpudist.resilience`, for what the port runs:

- :mod:`~tpudist_torch.resilience.exitcodes`: the trainer-supervisor
  exit-code contract (75 preempted, 76 hang, 77 repair, else a crash);
- :mod:`~tpudist_torch.resilience.preempt`: SIGTERM/SIGINT trapped as a
  signal-safe flag; :func:`tpudist_torch.train.fit` finishes the
  in-flight step, writes a synchronous emergency checkpoint and raises
  :class:`Preempted` (exit 75);
- :mod:`~tpudist_torch.resilience.supervisor`: the restart policy of
  ``tpudist_torch.launch`` (the restartable fast path, backoff with
  jitter for crashes, a rolling restart budget, the generation counter);
- :mod:`~tpudist_torch.resilience.chaos`: deterministic crash, hang,
  SIGTERM, checkpoint corruption and NaN injection at a step;
- :mod:`~tpudist_torch.resilience.elastic`: the geometry guard a resume
  applies to the saved ``tpudist_meta.json``, and the elastic reshard
  onto another data world (``fit(elastic=True)``).

Not ported yet: goodput accounting and the repair loop (ROADMAP Queue 1
#8).
"""

from tpudist_torch.resilience.chaos import (
    ChaosCrash,
    ChaosInjector,
    ChaosSpec,
    corrupt_latest_checkpoint,
    make_injector,
    parse_chaos,
)
from tpudist_torch.resilience.elastic import ElasticRefusal, elastic_mismatch
from tpudist_torch.resilience.exitcodes import (
    EXIT_CRASH,
    EXIT_HANG,
    EXIT_HISTORY_ENV,
    EXIT_INTERRUPT,
    EXIT_OK,
    EXIT_PREEMPTED,
    EXIT_REPAIR,
    GENERATION_ENV,
    RESTARTABLE,
    RUN_ID_ENV,
    ensure_run_id,
    exit_history,
    is_restartable,
    restart_generation,
    run_id,
)
from tpudist_torch.resilience.preempt import Preempted, PreemptionGuard
from tpudist_torch.resilience.supervisor import (
    BackoffPolicy,
    RestartBudget,
    Supervisor,
    classify,
)

__all__ = [
    "EXIT_OK",
    "EXIT_CRASH",
    "EXIT_PREEMPTED",
    "EXIT_HANG",
    "EXIT_REPAIR",
    "EXIT_INTERRUPT",
    "RESTARTABLE",
    "GENERATION_ENV",
    "EXIT_HISTORY_ENV",
    "RUN_ID_ENV",
    "is_restartable",
    "restart_generation",
    "exit_history",
    "run_id",
    "ensure_run_id",
    "Preempted",
    "PreemptionGuard",
    "BackoffPolicy",
    "RestartBudget",
    "Supervisor",
    "classify",
    "ChaosCrash",
    "ChaosSpec",
    "ChaosInjector",
    "make_injector",
    "parse_chaos",
    "corrupt_latest_checkpoint",
    "ElasticRefusal",
    "elastic_mismatch",
]
