"""Chunked, bucketed prompt prefill: counterpart of
:mod:`tpudist.serve.prefill`.

A new request's prompt runs through the model's bulk decode path on a
fresh batch-1 cache, in chunks of at most ``chunk`` tokens with the
final partial chunk padded to a power-of-two bucket
(:func:`tpudist_torch.generate.bucket_length`). PyTorch has no compile
cache to bound, but the chunk plan is part of the function: a prompt
that fits one chunk runs the same padded pass as ``generate()``'s
prefill, which is what makes greedy serving output bit-identical to the
static path.
"""

from __future__ import annotations

import numpy as np
import torch

from tpudist_torch.generate import bucket_length, reset_cursors, zero_cache


class Prefiller:
    """Callable turning a prompt into ``(row_cache, last_logits)``: a
    batch-1 cache holding the prompt's K/V and the f32 logits ``[V]``
    after the prompt's LAST real token. ``head=False`` skips the LM head
    on the final chunk too and returns ``(row_cache, None)``: the
    speculative draft's prefill, whose prompt-end logits nobody reads
    (its first proposal follows the target's first token)."""

    def __init__(self, model, *, chunk: int = 512, minimum: int = 8,
                 head: bool = True):
        self.model = model
        self.chunk = min(int(chunk), model.max_seq_len)
        self.minimum = minimum
        self.head = head
        if self.chunk < 1:
            raise ValueError(f"prefill chunk must be >= 1, got {chunk}")

    def chunk_plan(self, p: int, start: int = 0) -> list[tuple[int, int]]:
        """The ``(real, padded)`` chunk lengths a ``p``-token prompt runs
        as (full chunks, then the remainder's bucket), planning only
        ``tokens[start:]``. The bucket is capped by the chunk size and by
        the cache space left: the cursor advances by PADDED lengths."""
        plan, off = [], start
        while off < p:
            n = min(self.chunk, p - off)
            plan.append((n, bucket_length(
                n, cap=min(self.chunk, self.model.max_seq_len - off),
                minimum=self.minimum,
            )))
            off += n
        return plan

    def __call__(self, prompt):
        return self.resume(zero_cache(self.model, 1), prompt, 0)

    @torch.no_grad()
    def resume(self, cache: dict, prompt, start: int):
        """Prefill only ``prompt[start:]`` against a batch-1 cache whose
        K/V already hold positions ``[0, start)`` (a prefix-cache hit).
        ``start`` must be < len(prompt): the last prompt token always
        re-runs so the final chunk yields its logits."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        p = prompt.shape[0]
        if not 0 < p <= self.model.max_seq_len:
            raise ValueError(
                f"prompt length {p} outside (0, {self.model.max_seq_len}]"
            )
        if not 0 <= start < p:
            raise ValueError(f"resume start {start} outside [0, {p})")
        if start:
            reset_cursors(cache, start)
        plan = self.chunk_plan(p, start)
        off, logits, last = start, None, 0
        for i, (n, padded) in enumerate(plan):
            toks = np.zeros((1, padded), np.int64)
            toks[0, :n] = prompt[off:off + n]
            toks = torch.from_numpy(toks).to(self.model.device)
            final = i + 1 == len(plan) and self.head
            # earlier chunks only feed the cache: no LM head for them
            out = self.model(toks, cache=cache, return_hidden=not final)
            if final:
                logits = out
            off += n
            last = n - 1
        # the cursors now sit past p (padded final chunk); the pool copy
        # moves only K/V and the engine owns the slot's true length
        return cache, None if logits is None else logits[0, last]
