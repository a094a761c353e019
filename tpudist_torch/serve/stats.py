"""Latency-SLO accounting for the serving engine: counterpart of
:mod:`tpudist.serve.stats`, with the same ``serve`` / ``serve_summary``
row schema (docs/OBSERVABILITY.md), written through
:class:`tpudist_torch.telemetry.sink.TelemetrySink`. TTFT, TPOT, queue
depth, slot utilization, decode throughput.

The two latency SLOs a serving deployment is actually held to:

- **TTFT** (time to first token): submit → the request's first streamed
  token. Under continuous batching this is queue wait + one prefill + one
  sample; under static batching it includes waiting for the whole batch
  to assemble — the number the bench leg's comparison shows collapsing.
- **TPOT** (time per output token): the mean inter-token gap AFTER the
  first token, ``(t_done - t_first) / (n_tokens - 1)`` — the streaming
  cadence a reader experiences.

Percentiles are computed over a sliding window of the most recent
``SLO_WINDOW`` samples (p50/p95 via numpy) — bounded memory and a bounded
per-row percentile pass on a server that lives for millions of requests;
interval quantities (tokens/s, utilization) reset at each ``serve`` row
so the stream shows the live state, not a lifetime average.
"""

from __future__ import annotations

import collections
import time

import numpy as np

# sliding-window size for the TTFT/TPOT percentile samples: recent-enough
# to be an SLO signal, bounded so a long-lived server neither grows the
# sample lists nor pays an ever-larger percentile sort per telemetry row
SLO_WINDOW = 4096


def _pct(xs, q) -> float | None:
    return None if not xs else round(float(np.percentile(list(xs), q)), 6)


def fmt_s(x, scale: float = 1.0, digits: int = 3) -> str:
    """Human-display helper for snapshot fields that are ``None`` until
    the first sample lands (percentiles before any completion, utilization
    before any decode step): ``n/a`` instead of a format TypeError."""
    return "n/a" if x is None else f"{x * scale:.{digits}f}"


class ServeStats:
    """Host-side SLO bookkeeping, driven by the engine: ``on_submit`` /
    ``on_first_token`` / ``on_done`` per request, ``on_decode_step`` per
    compiled step, ``on_tick`` once per scheduler tick (writes the cadence
    row). ``sink=None`` keeps full accounting with no stream (the bench
    and the notebook path read :meth:`snapshot` directly)."""

    def __init__(self, *, slots: int, sink=None, every: int = 50,
                 clock=time.perf_counter, paged: bool = False,
                 tensor_world: int = 1):
        self.slots = slots
        self.sink = sink
        self.every = max(int(every), 0)
        self._clock = clock
        self.paged = paged
        # tensor-parallel world of the engine (1 = single chip): rides
        # every serve row so per-chip readings (pool_occupancy on a
        # sharded block pool is of each chip's 1/T byte slice) carry
        # their denominator — docs/OBSERVABILITY.md §1
        self.tensor_world = int(tensor_world)
        self.t_start = clock()
        self.submitted = 0
        self.completed = 0
        self.tokens = 0
        # paged-pool telemetry (zero/None on a contiguous engine): the
        # engine drives on_preempt / on_prefix; pool occupancy rides each
        # on_tick so the serve row shows the live block budget
        self.preemptions = 0
        self._prefix_hit_blocks = 0
        self._prefix_lookup_blocks = 0
        self._pool_occupancy: float | None = None
        self.ttft: collections.deque[float] = collections.deque(
            maxlen=SLO_WINDOW
        )
        self.tpot: collections.deque[float] = collections.deque(
            maxlen=SLO_WINDOW
        )
        # queue-wait samples (submit → first prefill dispatch): the slice
        # of TTFT spent waiting for admission — invisible inside the TTFT
        # number alone, and the first thing to saturate under overload.
        # Same bounded-deque sampling as ttft/tpot.
        self.queue_wait: collections.deque[float] = collections.deque(
            maxlen=SLO_WINDOW
        )
        self._arrival: dict[int, float] = {}
        self._first: dict[int, float] = {}
        # interval accumulators (reset at each serve row)
        self._win_t0 = self.t_start
        self._win_tokens = 0
        self._win_active = 0
        self._win_steps = 0
        # lifetime slot-occupancy accumulators (never reset — snapshot())
        self._life_active = 0
        self._life_steps = 0
        # speculative-decoding counters (zero on a non-spec engine): the
        # engine drives on_spec once per processed verify sweep; the
        # acceptance rate is the live health reading of the draft — when
        # it sags, speculation is burning draft FLOPs for nothing and the
        # rate on the serve row says so (docs/OBSERVABILITY.md §1)
        self.spec_drafted = 0
        self.spec_accepted = 0
        self._win_spec_drafted = 0
        self._win_spec_accepted = 0

    # -- per-request lifecycle --------------------------------------------

    def on_submit(self, request_id: int) -> float:
        """Returns the arrival timestamp so the engine's TTFT-SLO aging
        runs on the same clock reading TTFT is measured against."""
        self.submitted += 1
        t = self._clock()
        self._arrival[request_id] = t
        return t

    def on_prefill_start(self, request_id: int) -> float:
        """The request's FIRST prefill dispatch: closes the queue-wait
        sample (submit → here). Replay re-admissions after a preemption
        don't re-sample (the arrival entry is gone by then — first-token
        pops it); the preemption gap is accounted separately by the span
        layer. Returns the clock reading so the tracer's queued-phase span
        ends on the exact timestamp the sample was taken at."""
        t = self._clock()
        arrival = self._arrival.get(request_id)
        if arrival is not None and request_id not in self._first:
            self.queue_wait.append(t - arrival)
        return t

    def on_first_token(self, request_id: int) -> float:
        """Returns the first-token timestamp — the tracer's prefill-phase
        span ends on the same reading the TTFT sample was computed from,
        so span-derived TTFT is bit-equal to the SLO sample."""
        t = self._clock()
        self._first[request_id] = t
        self.ttft.append(t - self._arrival.pop(request_id, t))
        # the first token comes from prefill, not a decode step — count it
        # here so throughput covers every emitted token
        self.tokens += 1
        self._win_tokens += 1
        return t

    def on_done(self, request_id: int, n_tokens: int) -> float:
        """Returns the retire timestamp (same contract as
        :meth:`on_first_token`: the tracer reuses the exact reading the
        TPOT sample was computed from)."""
        t = self._clock()
        self.completed += 1
        first = self._first.pop(request_id, None)
        if first is not None and n_tokens > 1:
            self.tpot.append((t - first) / (n_tokens - 1))
        return t

    def on_preempt(self, request_id: int) -> float:
        """A live request was evicted back to the queue (pool ran dry);
        its blocks freed, its prompt+progress replay at re-admission.
        Returns the eviction timestamp for the span layer."""
        self.preemptions += 1
        return self._clock()

    def on_prefix(self, hit_blocks: int, lookup_blocks: int) -> None:
        """One admission's prefix-cache outcome, in BLOCK units (hit rate
        = hit blocks / full prompt blocks looked up — token-weighted, so
        one long shared system prompt counts for what it saves)."""
        self._prefix_hit_blocks += hit_blocks
        self._prefix_lookup_blocks += lookup_blocks

    @property
    def prefix_hit_rate(self) -> float | None:
        if not self._prefix_lookup_blocks:
            return None
        return round(self._prefix_hit_blocks / self._prefix_lookup_blocks, 4)

    # -- per-step drive ----------------------------------------------------

    def on_spec(self, drafted: int, accepted: int) -> None:
        """One verify sweep's outcome across the batch: ``drafted`` =
        eligible draft proposals scored, ``accepted`` = how many survived
        the ratio test (bonus/correction tokens are NOT counted here —
        they'd be emitted by a plain engine too, so counting them would
        flatter the rate)."""
        self.spec_drafted += drafted
        self.spec_accepted += accepted
        self._win_spec_drafted += drafted
        self._win_spec_accepted += accepted

    @staticmethod
    def _rate(accepted: int, drafted: int) -> float | None:
        return None if not drafted else round(accepted / drafted, 4)

    def on_decode_step(self, active: int, emitted: int) -> None:
        self.tokens += emitted
        self._win_tokens += emitted
        self._win_active += active
        self._win_steps += 1
        self._life_active += active
        self._life_steps += 1

    def on_tick(self, step: int, *, queue_depth: int, active: int,
                pool_occupancy: float | None = None) -> None:
        self._pool_occupancy = pool_occupancy
        if self.sink is None or not self.every or step % self.every:
            return
        self.sink.write("serve", step, **self._window_row(queue_depth, active))
        self._win_t0 = self._clock()
        self._win_tokens = self._win_active = self._win_steps = 0
        self._win_spec_drafted = self._win_spec_accepted = 0

    # -- readouts ----------------------------------------------------------

    def _window_row(self, queue_depth: int, active: int) -> dict:
        dt = max(self._clock() - self._win_t0, 1e-9)
        return {
            "queue_depth": queue_depth,
            "active": active,
            "slots": self.slots,
            "tensor_world": self.tensor_world,
            "slot_utilization": (
                round(self._win_active / (self.slots * self._win_steps), 4)
                if self._win_steps else 0.0
            ),
            "tokens_per_sec": round(self._win_tokens / dt, 2),
            "submitted": self.submitted,
            "completed": self.completed,
            "ttft_p50": _pct(self.ttft, 50),
            "ttft_p95": _pct(self.ttft, 95),
            "tpot_p50": _pct(self.tpot, 50),
            "tpot_p95": _pct(self.tpot, 95),
            # paged-pool fields (docs/OBSERVABILITY.md §1): block-pool
            # occupancy (null on a contiguous engine, where
            # slot_utilization above IS the capacity truth — under paged
            # admission it keeps its slot-count meaning but no longer
            # measures free bytes), prefix-cache hit rate (block-
            # weighted, null before any lookup), lifetime preempt count
            "pool_occupancy": (
                None if self._pool_occupancy is None
                else round(self._pool_occupancy, 4)
            ),
            "prefix_hit_rate": self.prefix_hit_rate,
            "preemptions": self.preemptions,
            # speculative fields (docs/OBSERVABILITY.md §1): window-scoped
            # like tokens_per_sec — the LIVE acceptance rate, not a
            # lifetime average that smooths over a draft going stale
            "spec_drafted": self._win_spec_drafted,
            "spec_accepted": self._win_spec_accepted,
            "spec_acceptance_rate": self._rate(
                self._win_spec_accepted, self._win_spec_drafted
            ),
            # queue-wait percentiles (submit → first prefill dispatch),
            # appended after existing fields (the append-only schema
            # discipline): the admission-pressure slice of TTFT
            "queue_p50": _pct(self.queue_wait, 50),
            "queue_p95": _pct(self.queue_wait, 95),
        }

    def snapshot(self) -> dict:
        """Lifetime totals (the bench record's fields)."""
        wall = max(self._clock() - self.t_start, 1e-9)
        return {
            "wall_s": round(wall, 6),
            "tensor_world": self.tensor_world,
            "tokens": self.tokens,
            "tokens_per_sec": round(self.tokens / wall, 2),
            "submitted": self.submitted,
            "completed": self.completed,
            "slot_utilization": (
                round(self._life_active / (self.slots * self._life_steps), 4)
                if self._life_steps else None
            ),
            "ttft_p50": _pct(self.ttft, 50),
            "ttft_p95": _pct(self.ttft, 95),
            "tpot_p50": _pct(self.tpot, 50),
            "tpot_p95": _pct(self.tpot, 95),
            "pool_occupancy": (
                None if self._pool_occupancy is None
                else round(self._pool_occupancy, 4)
            ),
            "prefix_hit_rate": self.prefix_hit_rate,
            "preemptions": self.preemptions,
            "spec_drafted": self.spec_drafted,
            "spec_accepted": self.spec_accepted,
            "spec_acceptance_rate": self._rate(
                self.spec_accepted, self.spec_drafted
            ),
            "queue_p50": _pct(self.queue_wait, 50),
            "queue_p95": _pct(self.queue_wait, 95),
        }

    def write_summary(self, step: int) -> None:
        if self.sink is not None:
            self.sink.write("serve_summary", step, **self.snapshot())
