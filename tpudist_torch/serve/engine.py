"""Continuous-batching inference engine: counterpart of
:mod:`tpudist.serve.engine`.

One scheduler **tick** (:meth:`ServeEngine.step`):

1. **admit** — while a slot is free, the active count is under
   ``max_active`` and the budget holds (slot count on the contiguous
   pool; BLOCK budget on the paged pool): pop the most urgent queued
   request, run its bucketed chunked prefill (resumed past any
   prefix-cache hit), sample its FIRST token from the prefill logits,
   and map its K/V into a slot;
2. **dispatch** — ONE masked decode step over the FULL slot batch
   (per-slot cursors, plus per-slot block tables in paged mode; non-live
   slots ride along masked): write each fed token's K/V at its slot's
   cursor, sample each slot's next token with its own params and rng
   stream, apply the shared stop rule;
3. **process** — fetch the PREVIOUS tick's step, stream its tokens, and
   retire finished slots.

The decode loop is **one-step-delayed**: step ``k`` is enqueued on the
card BEFORE step ``k-1``'s tokens are read, and each step's samples feed
the next step on the device (a carried ``[S]`` token tensor, overridden
per slot at admission). A step's tokens come back through a
non-blocking copy into pinned host memory and a CUDA event; the host
waits on that event one tick later, while the card already runs the next
step. Host lanes become device arguments through a FRESH pinned copy
every tick: reusing one pinned buffer would race the asynchronous copy
(the reference's aliasing hazard, in PyTorch's form).

**Paged mode** (``paged=True``): block-budget admission with a
``watermark_blocks`` decode headroom, the prefix cache, and
preempt-to-queue when the pool runs dry mid-decode (the newest
lowest-priority slot goes back to the FRONT of its lane and replays its
prompt plus progress at re-admission; its stream continues bit-identical).
**Priority lanes** with TTFT-deadline aging (``ttft_slo_s``).

**Speculative mode** (``draft_model=``, e.g.
:func:`tpudist_torch.serve.spec.early_exit_draft`): each tick the draft
proposes ``spec_k`` tokens per live slot (``spec_k`` single-token steps
plus one priming step, on a second, contiguous draft pool pinned to the
target's slots), and ONE target pass scores the window ``[last, d_1..d_K]``
at per-row positions; on the paged pool that pass launches the paged
decode kernel once per layer at ``s_q = spec_k + 1``.
Acceptance-rejection (:func:`tpudist_torch.serve.spec.speculative_accept`)
keeps the target's distribution exactly, so greedy output is the plain
engine's token for token. The cursor becomes device-carried (only the
card knows how many tokens a pass accepted; the host's copy syncs at
each delayed fetch, at most two passes behind), one clamp ``limit =
prompt_len + max_new_tokens`` bounds sequence end and budget on the card,
and rejected drafts' K/V is left above the cursor, where the causal mask
never admits it before it is overwritten.

Left out of this slice (see ROADMAP.md): tensor-sharded serving
(``mesh``), the AOT compile cache, program anatomy, span tracing and the
metrics endpoint.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from tpudist_torch.generate import (
    eos_retire, fold_keys, row_keys, sample_logits_per_row,
)
from tpudist_torch.ops.decode import PAGED_MAX_SQ
from tpudist_torch.serve.prefill import Prefiller
from tpudist_torch.serve.slots import SlotPool
from tpudist_torch.serve.stats import ServeStats

NO_EOS = -1  # token ids are non-negative, so -1 never matches


class QueueFull(RuntimeError):
    """Admission control: the request queue is at ``max_queue``."""


@dataclasses.dataclass(frozen=True)
class Request:
    request_id: int
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_id: int = NO_EOS
    priority: int = 0
    # a preempted request re-queues with the tokens it already emitted:
    # re-admission rebuilds its K/V (prompt + replay[:-1]) and feeds
    # replay[-1] as the next step's input
    replay_tokens: tuple | None = None


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One streamed token: ``index`` is its 0-based position in the
    request's generated sequence; ``done`` marks the request's last."""

    request_id: int
    token: int
    index: int
    done: bool


@dataclasses.dataclass
class _Inflight:
    """A dispatched-but-unfetched step: its tokens and stop flags on their
    way to the host (``host`` ``[2, S]`` int32, complete once ``event``
    has fired) plus the host snapshot of which slots were live and who
    owned them at dispatch."""

    host: torch.Tensor
    event: torch.cuda.Event | None
    live: np.ndarray
    rid: np.ndarray


@dataclasses.dataclass
class _SpecInflight:
    """A dispatched-but-unfetched speculative pass: ``host`` ``[S, K+5]``
    int32 on its way to the host (the emitted window ``[:, :K+1]``, then
    ``n_emit``, ``n_spec``, the advanced cursor and the stop flag), with
    the same ownership snapshot as :class:`_Inflight`."""

    host: torch.Tensor
    event: torch.cuda.Event | None
    live: np.ndarray
    rid: np.ndarray


def _to_host(packed: torch.Tensor):
    """Start a step's results toward the host: a non-blocking copy into
    pinned memory and an event the host waits on one tick later."""
    if not packed.is_cuda:
        return packed, None
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


class ServeEngine:
    """Continuous-batching engine over a model with the decode contract
    (the port's GPT-2 and Llama). Runs on the model's device, on the
    model's ``compute_copy()``.

    ``max_slots`` sizes the decode batch, ``max_active`` caps concurrent
    requests below it, ``max_queue`` bounds admission (:class:`QueueFull`).
    ``sink`` (a :class:`tpudist_torch.telemetry.TelemetrySink`) receives
    ``serve`` rows every ``stats_every`` ticks; ``on_token`` is called with
    each :class:`TokenEvent`. Paged knobs: ``block_size`` (divides
    ``max_seq_len``), ``n_blocks`` (default: the contiguous pool's bytes
    plus the garbage block), ``prefix_cache``, ``watermark_blocks``
    (default ``max_slots``). ``retain_results=False`` drops a request's
    tokens once it completes (stream through ``on_token``/``events()``).

    ``draft_model`` (same vocabulary, ``max_seq_len`` at least the
    target's) turns on speculative decoding with ``spec_k`` proposals a
    tick (module docstring); a draft made by
    :func:`tpudist_torch.serve.spec.early_exit_draft` of ``model`` is
    rebuilt on the engine's compute copy, so it still shares the target's
    weights. On a paged engine whose attention is the kernel the verify
    pass takes ``spec_k + 1`` query rows, so ``spec_k + 1`` must be at most
    the kernel's ``PAGED_MAX_SQ``."""

    def __init__(self, model, *, max_slots: int = 8,
                 max_active: int | None = None, max_queue: int = 256,
                 prefill_chunk: int = 512, seed: int = 0, sink=None,
                 stats_every: int = 50, on_token=None,
                 retain_results: bool = True, clock=time.perf_counter,
                 paged: bool = False, block_size: int = 32,
                 n_blocks: int | None = None, prefix_cache: bool = True,
                 watermark_blocks: int | None = None,
                 ttft_slo_s: float | None = None, draft_model=None,
                 spec_k: int = 4):
        source = model
        # the engine serves a copy held in the compute dtype: the model's
        # float32 masters would be cast at every use of every decode step
        self.model = model = model.compute_copy()
        self.device = model.device
        self.spec = draft_model is not None
        self.spec_k = int(spec_k)
        if self.spec:
            draft_model = self._check_draft(source, draft_model, paged)
        self.seed = int(seed)
        self.max_active = max_slots if max_active is None else max_active
        if not 1 <= self.max_active <= max_slots:
            raise ValueError(
                f"max_active {self.max_active} outside [1, {max_slots}]"
            )
        self.max_queue = max_queue
        self.paged = bool(paged)
        if self.paged:
            from tpudist_torch.serve.blocks import PagedSlotPool

            if n_blocks is None:
                n_blocks = max_slots * (model.max_seq_len // block_size) + 1
            self.pool = PagedSlotPool(
                model, max_slots, n_blocks=n_blocks, block_size=block_size,
                prefix_cache=prefix_cache,
            )
            self.watermark = (
                max_slots if watermark_blocks is None else int(watermark_blocks)
            )
        else:
            self.pool = SlotPool(model, max_slots)
            self.watermark = 0
        self.prefiller = Prefiller(model, chunk=prefill_chunk)
        self.draft = draft_model
        if self.spec:
            # the draft's own contiguous pool, a row per target slot (its
            # cursors are the engine's lane), and a headless prefiller
            self._draft_pool = SlotPool(draft_model, max_slots)
            self._draft_prefiller = Prefiller(draft_model, chunk=prefill_chunk,
                                              head=False)
        self.on_token = on_token
        self.ttft_slo_s = ttft_slo_s
        self.stats = ServeStats(
            slots=max_slots, sink=sink, every=stats_every, clock=clock,
            paged=self.paged,
        )
        self._lanes: dict[int, collections.deque[Request]] = {}
        self._t_submit: dict[int, float] = {}
        self.retain_results = retain_results
        self._results: dict[int, list[int]] = {}
        self._counts: dict[int, int] = {}  # emitted per LIVE request
        self._live_toks: dict[int, list[int]] = {}  # emitted values (replay)
        self._next_id = 0
        self._step = 0
        #: decode steps dispatched (each runs every layer's attention once)
        self.decode_steps = 0
        s = max_slots
        # per-slot request state (host side; shipped each tick). A slot's
        # row is meaningful iff pool.active[slot].
        self._req = np.full(s, -1, np.int64)
        self._dispatched = np.zeros(s, np.int32)  # tokens dispatched so far
        self._budget = np.zeros(s, np.int32)
        self._temp = np.zeros(s, np.float32)
        self._topk = np.zeros(s, np.int32)
        self._topp = np.ones(s, np.float32)
        self._eos = np.full(s, NO_EOS, np.int32)
        self._slot_prio = np.zeros(s, np.int32)
        self._admit_seq = np.zeros(s, np.int64)  # victim choice: newest first
        self._seq = 0
        self._slot_req: dict[int, Request] = {}
        # the device-carried token feedback and the admission overrides
        self._prev_tok = torch.zeros(s, dtype=torch.int32, device=self.device)
        self._override: dict[int, int] = {}
        # speculative: the device-carried cursor lane and the per-slot
        # emission limit (prompt_len + max_new_tokens)
        self._pos_dev = torch.zeros(s, dtype=torch.int32, device=self.device)
        self._limit = np.zeros(s, np.int32)
        self._inflight: _Inflight | _SpecInflight | None = None
        self._drained_events: list[TokenEvent] = []

    def _check_draft(self, source, draft, paged: bool):
        """Validate a draft model; returns the one the engine runs."""
        model = self.model
        if self.spec_k < 1:
            raise ValueError(f"spec_k must be >= 1, got {self.spec_k}")
        if getattr(draft, "vocab_size", None) != model.vocab_size:
            raise ValueError(
                f"draft vocab {getattr(draft, 'vocab_size', None)} != target "
                f"vocab {model.vocab_size}: the acceptance ratio compares "
                "the two distributions token by token")
        if draft.max_seq_len < model.max_seq_len:
            raise ValueError(
                f"draft max_seq_len {draft.max_seq_len} < target's "
                f"{model.max_seq_len}: the draft pool rides the target's "
                "cursor lane")
        if paged and model.attn_impl != "xla" \
                and self.spec_k + 1 > PAGED_MAX_SQ:
            raise ValueError(
                f"spec_k {self.spec_k}: the verify pass takes spec_k + 1 = "
                f"{self.spec_k + 1} query rows, the paged decode kernel at "
                f"most {PAGED_MAX_SQ}")
        parent = getattr(draft, "early_exit_of", None)
        if parent is not None and parent[0] is source:
            from tpudist_torch.serve.spec import early_exit_draft

            return early_exit_draft(model, draft.depth)
        return draft.compute_copy()

    # -- submission --------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int, *, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0,
               eos_id: int | None = None, priority: int = 0) -> int:
        """Enqueue a request; returns its id. Per-request sampling params
        (``temperature=0`` greedy, ``top_k<=0`` / ``top_p>=1`` off) and
        priority lane. Raises :class:`QueueFull` past ``max_queue`` and
        ``ValueError`` when the request can never fit the KV budget."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if prompt.size + max_new_tokens > self.model.max_seq_len:
            raise ValueError(
                f"prompt {prompt.size} + {max_new_tokens} new tokens exceeds "
                f"max_seq_len {self.model.max_seq_len} (the per-slot KV size)"
            )
        if self.paged:
            worst = self.pool.blocks_for(prompt.size + max_new_tokens)
            if worst > self.pool.blocks.n_usable:
                raise ValueError(
                    f"request needs up to {worst} blocks but the pool has "
                    f"{self.pool.blocks.n_usable}; raise n_blocks"
                )
        if self.queue_depth >= self.max_queue:
            raise QueueFull(
                f"request queue at max_queue={self.max_queue}; shed load"
            )
        rid = self._next_id
        self._next_id += 1
        req = Request(
            rid, prompt, int(max_new_tokens), float(temperature),
            int(top_k or 0), float(1.0 if top_p is None else top_p),
            NO_EOS if eos_id is None else int(eos_id), int(priority),
        )
        self._lanes.setdefault(req.priority, collections.deque()).append(req)
        self._counts[rid] = 0
        if self.paged:
            self._live_toks[rid] = []
        if self.retain_results:
            self._results[rid] = []
        self._t_submit[rid] = self.stats.on_submit(rid)
        return rid

    # -- scheduler ---------------------------------------------------------

    @property
    def pending(self) -> bool:
        return (self.queue_depth > 0 or self.pool.n_active > 0
                or self._inflight is not None)

    @property
    def queue_depth(self) -> int:
        return sum(len(d) for d in self._lanes.values())

    @torch.no_grad()
    def step(self) -> list[TokenEvent]:
        """One scheduler tick: admit, dispatch, process. Returns the tokens
        emitted this tick (also delivered to ``on_token``)."""
        events = self._admit()
        self._drained_events = []
        new_inflight = self._dispatch()
        # a preemption inside _dispatch force-fetched the in-flight step
        events.extend(self._drained_events)
        if self._inflight is not None:
            events.extend(self._process(self._inflight))
        self._inflight = new_inflight
        self._step += 1
        self.stats.on_tick(
            self._step, queue_depth=self.queue_depth,
            active=self.pool.n_active,
            pool_occupancy=(
                self.pool.blocks.occupancy if self.paged else None
            ),
        )
        if self.on_token is not None:
            for e in events:
                self.on_token(e)
        return events

    def run(self) -> dict[int, list[int]]:
        """Drain queue and slots; returns ``{request_id: tokens}`` and
        writes the ``serve_summary`` row."""
        while self.pending:
            self.step()
        self.stats.write_summary(self._step)
        return {r: list(t) for r, t in self._results.items()}

    def events(self):
        """Generator of :class:`TokenEvent` until the engine drains."""
        while self.pending:
            yield from self.step()
        self.stats.write_summary(self._step)

    def result(self, request_id: int) -> list[int]:
        return list(self._results[request_id])

    def reset_stats(self) -> None:
        """Fresh SLO accounting on a warm engine."""
        s = self.stats
        self.stats = ServeStats(
            slots=self.pool.max_slots, sink=s.sink, every=s.every,
            clock=s._clock, paged=self.paged,
        )

    # -- internals ---------------------------------------------------------

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        """A host lane as a device argument, through a FRESH copy: pinned
        memory from PyTorch's caching host allocator (which holds a block
        until the copy that read it has completed) and a non-blocking
        copy, so the host never waits on the card here and never mutates
        memory an in-flight copy still reads."""
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _emit(self, rid: int, token: int, done: bool) -> TokenEvent:
        ev = TokenEvent(rid, token, self._counts[rid], done)
        self._counts[rid] += 1
        if self.paged:
            self._live_toks[rid].append(token)
        if self.retain_results:
            self._results[rid].append(token)
        return ev

    def _finish(self, rid: int) -> None:
        n_tokens = self._counts.pop(rid)
        self.stats.on_done(rid, n_tokens)
        self._live_toks.pop(rid, None)
        self._t_submit.pop(rid, None)
        if not self.retain_results:
            self._results.pop(rid, None)

    def _peek_next(self) -> tuple[int, Request] | None:
        """The lane/request admission would serve next: the highest
        non-empty lane's head, unless ``ttft_slo_s`` aging promotes an
        overdue lower lane's head (oldest overdue first)."""
        heads = [(lane, dq[0]) for lane, dq in self._lanes.items() if dq]
        if not heads:
            return None
        if self.ttft_slo_s is not None:
            now = self.stats._clock()
            overdue = [
                (lane, r) for lane, r in heads
                if now - self._t_submit.get(r.request_id, now) > self.ttft_slo_s
            ]
            if overdue:
                return min(
                    overdue,
                    key=lambda lr: self._t_submit.get(
                        lr[1].request_id, float("inf")
                    ),
                )
        return max(heads, key=lambda lr: lr[0])

    def _first_token(self, logits, req: Request) -> int:
        """Token index 0 of a just-prefilled request, from its prefill
        logits ``[V]`` (one host sync per admission, as in the
        reference)."""
        dev = logits.device
        keys = row_keys(self.seed, torch.tensor([req.request_id], device=dev),
                        torch.zeros(1, dtype=torch.int64, device=dev))
        tok = sample_logits_per_row(
            logits[None], keys,
            temperature=torch.tensor([req.temperature], device=dev),
            top_k=torch.tensor([req.top_k], device=dev),
            top_p=torch.tensor([req.top_p], device=dev),
        )
        return int(tok[0])

    def _admit(self) -> list[TokenEvent]:
        events: list[TokenEvent] = []
        while self.pool.n_free > 0 and self.pool.n_active < self.max_active:
            picked = self._peek_next()
            if picked is None:
                break
            lane, req = picked
            replay = req.replay_tokens
            # the K/V the slot must hold before its first dispatch: the
            # prompt, or prompt + all-but-the-last emitted token on replay
            if replay is not None:
                kv_tokens = np.concatenate(
                    [req.prompt, np.asarray(replay[:-1], np.int32)]
                )
            else:
                kv_tokens = req.prompt
            hit_blocks: list[int] = []
            lookup_blocks = 0
            if self.paged:
                bs = self.pool.block_size
                worst = self.pool.blocks_for(len(kv_tokens))
                # a fresh request re-runs its LAST prompt token (its logits
                # are the first sample); a replay needs no logits
                limit = (len(kv_tokens) if replay is not None
                         else len(kv_tokens) - 1)
                max_hits = (
                    0 if self.pool.prefix is None
                    else max(min(limit, len(kv_tokens)), 0) // bs
                )
                # the watermark is headroom against OTHER live slots'
                # growth; an idle pool waives it (no head-of-line livelock)
                wm = self.watermark if self.pool.n_active else 0
                if self.pool.free_after_evict() < worst - max_hits + wm:
                    break
                if self.pool.prefix is not None:
                    hit_blocks = self.pool.prefix.lookup(kv_tokens, limit)
                    lookup_blocks = max_hits
                    # PIN the hits until insert takes its own refs, so a
                    # budget eviction cannot free them
                    for blk in hit_blocks:
                        self.pool.blocks.incref(int(blk))
                budget = worst - len(hit_blocks) + wm
                if self.pool.free_after_evict() < budget:
                    for blk in hit_blocks:
                        self.pool.blocks.decref(int(blk))
                    break
                if self.pool.blocks.n_free < budget:
                    self.pool.evict_prefix(budget - self.pool.blocks.n_free)
            self._lanes[lane].popleft()
            self.stats.on_prefill_start(req.request_id)
            if self.paged and self.pool.prefix is not None:
                # counted for COMMITTED admissions only
                self.stats.on_prefix(len(hit_blocks), lookup_blocks)
            n_hit_tokens = len(hit_blocks) * (
                self.pool.block_size if self.paged else 0
            )
            if self.paged and hit_blocks:
                if n_hit_tokens < len(kv_tokens):
                    row_cache, last_logits = self.prefiller.resume(
                        self.pool.gather_row(hit_blocks), kv_tokens,
                        n_hit_tokens,
                    )
                else:
                    # full-hit replay: every block is shared, nothing to
                    # prefill or scatter
                    row_cache, last_logits = None, None
            else:
                row_cache, last_logits = self.prefiller(kv_tokens)
            if replay is None:
                tok = self._first_token(last_logits, req)
                self.stats.on_first_token(req.request_id)
                done = tok == req.eos_id or req.max_new_tokens == 1
                events.append(self._emit(req.request_id, tok, done))
                if done:
                    # never occupies a slot: release the prefix pins
                    for blk in hit_blocks:
                        self.pool.blocks.decref(int(blk))
                    self._finish(req.request_id)
                    continue
                override, n_disp = tok, 1
            else:
                override, n_disp = int(replay[-1]), len(replay)
            if self.paged:
                slot = self.pool.insert(
                    row_cache, len(kv_tokens), prompt=kv_tokens,
                    hit_blocks=hit_blocks,
                )
                for blk in hit_blocks:  # insert holds its own refs now
                    self.pool.blocks.decref(int(blk))
            else:
                slot = self.pool.insert(row_cache, len(kv_tokens))
            if self.spec:
                # the draft's K/V of the same tokens in the same slot's row
                # (no prefix cache on the draft side: always a prefill)
                d_row, _ = self._draft_prefiller(kv_tokens)
                self._draft_pool.write_row(d_row, slot)
                self._limit[slot] = len(req.prompt) + req.max_new_tokens
            self._req[slot] = req.request_id
            self._dispatched[slot] = n_disp
            self._budget[slot] = req.max_new_tokens
            self._temp[slot] = req.temperature
            self._topk[slot] = req.top_k
            self._topp[slot] = req.top_p
            self._eos[slot] = req.eos_id
            self._slot_prio[slot] = req.priority
            self._seq += 1
            self._admit_seq[slot] = self._seq
            self._slot_req[slot] = req
            self._override[slot] = override
        return events

    def _choose_victim(self) -> int | None:
        """Lowest priority first, newest admission within a priority."""
        cands = np.nonzero(self.pool.active)[0]
        if cands.size == 0:
            return None
        return int(min(
            cands, key=lambda s: (self._slot_prio[s], -self._admit_seq[s]),
        ))

    def _preempt(self, victim: int) -> None:
        """Evict a live slot back to its lane's FRONT; its request replays
        at re-admission (the caller drained the in-flight step first)."""
        rid = int(self._req[victim])
        req = dataclasses.replace(
            self._slot_req[victim],
            replay_tokens=tuple(self._live_toks.get(rid, ())),
        )
        self._lanes.setdefault(req.priority, collections.deque()).appendleft(req)
        self._override.pop(victim, None)
        self._slot_req.pop(victim, None)
        self.pool.release(victim)
        self._req[victim] = -1
        self.stats.on_preempt(rid)

    def _live_rows(self) -> np.ndarray:
        """Rows a decode step runs: the occupied slots, in the plain
        engine only those with budget left (the speculative pass enforces
        the budget on the card by its ``limit`` clamp)."""
        if self.spec:
            return self.pool.active.copy()
        return self.pool.active & (self._dispatched < self._budget)

    def _tokens_to_map(self, slot: int) -> int:
        """Positions the slot's table must cover before the next dispatch:
        a plain step writes the cursor's one; a verify pass writes up to
        ``spec_k + 1`` past a cursor the host knows one fetch late (the
        pass in flight may have moved it ``spec_k + 1`` more), capped at
        the row's limit, which ``submit`` checked fits the pool."""
        pos = int(self.pool.positions[slot])
        if not self.spec:
            return pos + 1
        return min(pos + 2 * (self.spec_k + 1), int(self._limit[slot]))

    def _ensure_blocks(self, live: np.ndarray) -> np.ndarray:
        """Paged pre-dispatch pass: every live slot maps the blocks its
        next step writes. A dry pool escalates: force-fetch the in-flight
        step, evict a cold prefix leaf, preempt the newest lowest-priority
        slot."""
        for slot in np.nonzero(live)[0]:
            while live[slot] and not self.pool.ensure_to(
                    slot, self._tokens_to_map(slot)):
                if self._inflight is not None:
                    self._drained_events.extend(self._process(self._inflight))
                    self._inflight = None
                    live &= self._live_rows()
                    continue
                if self.pool.evict_prefix(1):
                    continue
                victim = self._choose_victim()
                if victim is None:
                    live[slot] = False
                    break
                self._preempt(victim)
                live[victim] = False
        return live

    def _overrides(self):
        """The admission overrides as lanes: token, flag (and cursor)."""
        s = self.pool.max_slots
        override_tok = np.zeros(s, np.int32)
        use_override = np.zeros(s, np.int32)
        override_pos = np.zeros(s, np.int32)
        for slot, tok in self._override.items():
            override_tok[slot] = tok
            use_override[slot] = 1
            override_pos[slot] = self.pool.positions[slot]
        self._override.clear()
        return override_tok, use_override, override_pos

    def _dispatch_spec(self) -> _SpecInflight | None:
        """The speculative :meth:`_dispatch`: live rows are the occupied
        slots (the budget is enforced on the card by the ``limit`` clamp,
        which emits nothing for an exhausted row); the cursor lane chains
        through the passes on the card, and an admission splices a fresh
        slot's cursor in as it splices its first token."""
        live = self._live_rows()
        if self.paged and live.any():
            live = self._ensure_blocks(live)
        if not live.any():
            return None
        override_tok, use_override, override_pos = self._overrides()
        ints = self._to_device(np.stack([
            override_tok, use_override, override_pos,
            (~live).astype(np.int32), self._req.astype(np.int32),
            self._topk, self._eos, self._limit,
        ]))
        floats = self._to_device(np.stack([self._temp, self._topp]))
        tables = self._to_device(self.pool.tables) if self.paged else None
        (o_tok, use_o, o_pos, done, req_ids, top_k, eos,
         limit) = ints.unbind(0)
        use_o = use_o.bool()
        tok0 = torch.where(use_o, o_tok, self._prev_tok)
        pos = torch.where(use_o, o_pos, self._pos_dev)
        emit, n_emit, n_spec, new_pos, done_out = self._spec_pass(
            tok0, pos, done.bool(), req_ids, floats[0], top_k, floats[1],
            eos, limit, tables)
        self._pos_dev = new_pos
        last = emit.gather(1, (n_emit.long() - 1).clamp(min=0)[:, None])[:, 0]
        self._prev_tok = torch.where(n_emit > 0, last, tok0)
        packed = torch.cat([emit, torch.stack(
            [n_emit, n_spec, new_pos, done_out.to(torch.int32)], 1)], 1)
        host, event = _to_host(packed)
        self.decode_steps += 1
        return _SpecInflight(host, event, live, self._req.copy())

    def _spec_pass(self, tok0, pos, done, req_ids, temperature, top_k, top_p,
                   eos, limit, tables):
        """One speculative pass on the card over the whole slot batch:
        ``spec_k`` draft steps and the priming step, the target's verify
        pass over ``[tok0, d_1..d_K]``, acceptance and the first-stop cut.
        ``allowed = limit - 1 - pos`` tokens a row may still emit, and
        ``n_spec = clip(allowed - 1, 0, K)`` drafts are eligible, so
        ``n_emit <= allowed``: the card never overshoots a budget."""
        from tpudist_torch.serve.spec import speculative_accept

        k = self.spec_k
        dev = tok0.device
        pos = pos.to(torch.int32)
        allowed = limit - 1 - pos
        n_spec = torch.clamp(allowed - 1, 0, k).to(torch.int32)
        alive = (~done) & (allowed > 0)
        keys = row_keys(self.seed, req_ids, pos)
        # the draft rides the target's cursors; a position past its last
        # slot (a row's draft tail near max_seq_len, never consumed) is
        # clamped onto that slot, whose K/V no consumed proposal reads
        d_last = self.draft.max_seq_len - 1
        d_cache = self._draft_pool.cache
        cur, d_toks, d_logits = tok0, [], []
        for i in range(k):
            dl = self.draft(cur[:, None].long(), cache=d_cache,
                            positions=torch.clamp(pos + i, max=d_last))[:, -1]
            cur = sample_logits_per_row(
                dl, fold_keys(keys, i), temperature=temperature, top_k=top_k,
                top_p=top_p)
            d_toks.append(cur)
            d_logits.append(dl)
        # prime d_K's draft K/V (no head): after a fully accepted window
        # the next pass feeds the bonus token, and the draft attends d_K
        self.draft(cur[:, None].long(), cache=d_cache,
                   positions=torch.clamp(pos + k, max=d_last),
                   return_hidden=True)
        d_toks = torch.stack(d_toks, 1)
        window = torch.cat([tok0[:, None], d_toks], 1)
        t_logits = self.model(window.long(), cache=self.pool.cache,
                              positions=pos, block_tables=tables)
        emit, n_emit = speculative_accept(
            t_logits, torch.stack(d_logits, 1), d_toks, n_spec, keys,
            temperature=temperature, top_k=top_k, top_p=top_p)
        # the first-stop cut: keep through the first stop token and flag
        # the row for retirement
        cols = torch.arange(k + 1, device=dev)[None, :]
        is_eos = ((emit == eos[:, None]) & (eos >= 0)[:, None]
                  & (cols < n_emit[:, None]))
        first = torch.where(is_eos, cols, k + 1).amin(1).to(torch.int32)
        n_emit = torch.minimum(n_emit, first + 1)
        eos_hit = first < n_emit
        n_emit = torch.where(alive, n_emit, 0).to(torch.int32)
        n_spec = torch.where(alive, n_spec, 0).to(torch.int32)
        emit = torch.where(cols < n_emit[:, None], emit, 0).to(torch.int32)
        done_out = done | (alive & eos_hit)
        return emit, n_emit, n_spec, (pos + n_emit).to(torch.int32), done_out

    def _dispatch(self) -> _Inflight | _SpecInflight | None:
        """Enqueue the next decode step without waiting on the previous
        one. Live rows = occupied slots with budget left; a slot whose
        stop token sits in the unfetched step rides one masked zombie row
        (discarded at process time by the ownership guard)."""
        if self.spec:
            return self._dispatch_spec()
        live = self._live_rows()
        if self.paged and live.any():
            live = self._ensure_blocks(live)
        if not live.any():
            return None
        override_tok, use_override, _ = self._overrides()
        # every host lane travels as a fresh copy (see _to_device): two
        # packed transfers plus the block tables per tick
        ints = self._to_device(np.stack([
            override_tok, use_override, self.pool.positions,
            (~live).astype(np.int32), self._req.astype(np.int32),
            self._dispatched, self._topk, self._eos,
        ]))
        floats = self._to_device(np.stack([self._temp, self._topp]))
        tables = (self._to_device(self.pool.tables) if self.paged else None)
        (o_tok, use_o, pos, done, req_ids, tok_idx, top_k, eos) = ints.unbind(0)
        tok = torch.where(use_o.bool(), o_tok, self._prev_tok)
        logits = self.model(
            tok[:, None].long(), cache=self.pool.cache, positions=pos,
            block_tables=tables,
        )
        # per-slot rng streams: (request id, token index) key the draw
        keys = row_keys(self.seed, req_ids, tok_idx)
        nxt = sample_logits_per_row(
            logits[:, -1], keys, temperature=floats[0], top_k=top_k,
            top_p=floats[1],
        )
        nxt, done = eos_retire(nxt, done.bool(), eos, 0)
        self._prev_tok = nxt
        # the step's results start for the host now; read one tick later
        host, event = _to_host(torch.stack([nxt, done.to(torch.int32)]))
        for slot in np.nonzero(live)[0]:
            self.pool.advance(slot)
            self._dispatched[slot] += 1
        self.decode_steps += 1
        return _Inflight(host, event, live, self._req.copy())

    def _retire(self, rid: int, slot: int) -> None:
        self._finish(rid)
        self.pool.release(slot)
        self._req[slot] = -1
        self._slot_req.pop(slot, None)

    def _process_spec(self, prev: _SpecInflight) -> list[TokenEvent]:
        """Fetch a speculative pass: stream each owned row's window in
        order (a :class:`TokenEvent` per token), sync the host cursor from
        the card's, and retire on the stop flag or on the budget, which
        the card's clamp lands exactly on a window's last token."""
        if prev.event is not None:
            prev.event.synchronize()
        out = prev.host.numpy()
        k1 = self.spec_k + 1
        emit = out[:, :k1]
        n_emit, n_spec, pos, done = out[:, k1:].T
        events: list[TokenEvent] = []
        drafted = accepted = 0
        for slot in np.nonzero(prev.live)[0]:
            rid = int(prev.rid[slot])
            if self._req[slot] != rid or rid not in self._counts:
                continue  # a zombie pass: the ownership guard
            self.pool.positions[slot] = int(pos[slot])
            m = int(n_emit[slot])
            if m == 0:
                continue
            # drafted counts the ELIGIBLE proposals (a clamped window is
            # not a rejection); accepted leaves out the correction token
            drafted += int(n_spec[slot])
            accepted += m - 1
            for j in range(m):
                n = self._counts[rid]
                finished = ((bool(done[slot]) and j == m - 1)
                            or n + 1 >= int(self._budget[slot]))
                events.append(self._emit(rid, int(emit[slot, j]), finished))
                if finished:
                    self._retire(rid, slot)
                    break
        self.stats.on_decode_step(int(prev.live.sum()), len(events))
        self.stats.on_spec(drafted, accepted)
        return events

    def _process(self, prev) -> list[TokenEvent]:
        """Fetch a dispatched step's tokens (the one host wait per tick,
        one step behind the card) and stream/retire."""
        if isinstance(prev, _SpecInflight):
            return self._process_spec(prev)
        if prev.event is not None:
            prev.event.synchronize()
        tok, done = prev.host.numpy()
        events: list[TokenEvent] = []
        for slot in np.nonzero(prev.live)[0]:
            rid = int(prev.rid[slot])
            # ownership guard: a zombie row (its request retired between
            # dispatch and fetch) is discarded
            if self._req[slot] != rid or rid not in self._counts:
                continue
            n = self._counts[rid]
            finished = bool(done[slot]) or n + 1 >= int(self._budget[slot])
            events.append(self._emit(rid, int(tok[slot]), finished))
            if finished:
                self._retire(rid, slot)
        self.stats.on_decode_step(int(prev.live.sum()), len(events))
        return events
