"""Serving subsystem of the PyTorch port: continuous batching over the
decode path (counterpart of :mod:`tpudist.serve`).

- :mod:`tpudist_torch.serve.slots` — contiguous slot-pooled KV cache;
- :mod:`tpudist_torch.serve.blocks` — paged KV cache: refcounted block
  pool, per-slot block tables, chain-hashed prefix cache;
- :mod:`tpudist_torch.serve.prefill` — chunked, bucketed prefill;
- :mod:`tpudist_torch.serve.engine` — the scheduler (priority lanes,
  block-budget admission, preempt-to-queue, one-step-delayed fetch,
  speculative decoding);
- :mod:`tpudist_torch.serve.spec` — the acceptance rule, early-exit
  drafts, the draft pool's bytes;
- :mod:`tpudist_torch.serve.stats` — TTFT/TPOT SLO rows.

Quick start::

    from tpudist_torch.models.gpt2 import GPT2
    from tpudist_torch.serve import ServeEngine
    model = GPT2(dtype=torch.bfloat16, attn_impl="fused")   # on cuda
    engine = ServeEngine(model, max_slots=8, paged=True, block_size=32)
    engine.submit(prompt_ids, max_new_tokens=64, temperature=0.7, top_k=50)
    results = engine.run()
"""

from tpudist_torch.serve.blocks import (
    BlockPool, PagedSlotPool, PrefixCache, draft_equivalent_blocks,
)
from tpudist_torch.serve.engine import (
    NO_EOS,
    QueueFull,
    Request,
    ServeEngine,
    TokenEvent,
)
from tpudist_torch.serve.prefill import Prefiller
from tpudist_torch.serve.slots import SlotPool, write_slot
from tpudist_torch.serve.spec import early_exit_draft, speculative_accept
from tpudist_torch.serve.stats import ServeStats

__all__ = [
    "ServeEngine",
    "Request",
    "TokenEvent",
    "QueueFull",
    "NO_EOS",
    "Prefiller",
    "SlotPool",
    "write_slot",
    "BlockPool",
    "PagedSlotPool",
    "PrefixCache",
    "ServeStats",
    "early_exit_draft",
    "speculative_accept",
    "draft_equivalent_blocks",
]
