"""The chunked LM loss: counterpart of :mod:`tpudist.models.lm_utils`'s
``chunked_head_reduce`` / ``tied_head_logits_fn`` / ``chunked_ce_sum`` /
``chunked_lm_forward``.

The plain path's f32 ``[B, S, V]`` logits are the memory high-water mark
at long context (B 4, S 4096, V 50257: 3.3 GB, twice that with their
gradient). This loss runs the blocks once, then the LM head (GPT-2's
tied ``wte``, Llama's ``lm_head``: :func:`lm_head_weight`) and the softmax
cross-entropy over sequence chunks, each chunk's body under
``torch.utils.checkpoint`` (non-reentrant), so live logits stay bounded
by ``[B, chunk, V]`` in the forward AND the backward, which recomputes
each chunk's logits instead of storing them.

Under context parallelism (:func:`seq_shard_lm`) a rank scores only its
chunk of each sequence, against labels taken from the whole row: its last
position's label is the next chunk's first token, and the sequence's last
position has none. Under a tensor axis (a model built on a layout with
one) each chunk's logits are this rank's vocabulary columns and its loss
is :func:`tpudist_torch.parallel.tp.vocab_parallel_cross_entropy`: no
rank holds a whole ``[B, chunk, V]``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from tpudist_torch.models.gpt2 import tied_head
from tpudist_torch.parallel import tp as tp_lib


def _chunk_ce_sum(logits_fn, hc, tc, mc, model=None):
    logits = logits_fn(hc)
    flat, target = logits.reshape(-1, logits.shape[-1]), tc.reshape(-1)
    if model is not None:
        ce = tp_lib.vocab_parallel_cross_entropy(flat, target, model.layout,
                                                 model.vocab_size)
    else:
        ce = F.cross_entropy(flat, target, reduction="none")
    return (ce * mc.reshape(-1)).sum()


def chunked_head_reduce(logits_fn: Callable, h, targets, pos_mask,
                        chunk: int, model=None):
    """The masked softmax-CE sum of a position-wise head over sequence
    chunks. ``logits_fn``: ``[B, chunk, D]`` hidden -> ``[B, chunk, V]``
    f32 logits; ``h [B, S, D]``; ``targets``/``pos_mask`` ``[B, S]``
    (``pos_mask`` broadcastable). S is padded to a multiple of ``chunk``
    with a zero position mask, as the reference pads it. ``model``: a
    tensor-parallel LM whose vocabulary-local logits ``logits_fn`` gives
    (the loss is then the vocabulary-parallel CE)."""
    b, s, _ = h.shape
    pad = -s % chunk
    pos_mask = torch.broadcast_to(pos_mask, (b, s)).float()
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        pos_mask = F.pad(pos_mask, (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, s + pad, chunk):
        total = total + checkpoint(
            _chunk_ce_sum, logits_fn, h[:, c:c + chunk],
            targets[:, c:c + chunk], pos_mask[:, c:c + chunk], model,
            use_reentrant=False)
    return total


def tied_head_logits_fn(head_w, layout=None) -> Callable:
    """``logits_fn`` for :func:`chunked_head_reduce`: the head against a
    ``[V, D]`` table (tied or not, the reference's one head function), cast to the hidden's dtype inside the chunk
    (so a float32 master's gradient sums over the chunks in float32, as
    the reference's scan sums it), with f32 logits
    (:func:`tpudist_torch.models.gpt2.tied_head`)."""

    def logits_fn(hc):
        if layout is not None:
            hc = tp_lib.copy_to_tensor(hc, layout)
        return tied_head(hc, head_w.to(hc.dtype))

    return logits_fn


def lm_head_weight(model) -> torch.Tensor:
    """The ``[V, D]`` output projection of an LM, whichever family (the
    reference's ``lm_head_weight`` rule): Llama's untied ``lm_head``, else
    GPT-2's tied ``wte``, else a tied Llama's ``embed``."""
    for name in ("lm_head", "wte", "embed"):
        w = getattr(model, name, None)
        if isinstance(w, torch.Tensor):
            return w
    raise ValueError(f"no LM head weight on {type(model).__name__}")


def chunked_ce_sum(head_w, h, targets, pos_mask, chunk: int, model=None):
    """The masked softmax-CE sum under the head ``head_w [V, D]`` (this
    rank's vocabulary rows when ``model`` is tensor-parallel)."""
    if model is None or tp_lib.tensor_size(model.layout) == 1:
        return chunked_head_reduce(tied_head_logits_fn(head_w), h, targets,
                                   pos_mask, chunk)
    return chunked_head_reduce(tied_head_logits_fn(head_w, model.layout), h,
                               targets, pos_mask, chunk, model=model)


def seq_shard(x, layout):
    """This seq rank's chunk of ``[B, S, ...]`` rows."""
    s = x.shape[1]
    if s % layout.seq:
        raise ValueError(f"sequence {s} not divisible by the seq axis "
                         f"{layout.seq}")
    w = s // layout.seq
    return x[:, layout.seq_idx * w:(layout.seq_idx + 1) * w]


def seq_shard_lm(tokens, layout):
    """This seq rank's chunk of the token rows ``[B, S]`` and the
    next-token labels of its positions, ``-100`` where there is none (the
    sequence's last position): ``(tokens [B, S/n], labels [B, S/n])``."""
    local = seq_shard(tokens, layout)
    b, w = local.shape
    lo = layout.seq_idx * w
    labels = torch.full((b, w), -100, dtype=torch.long, device=tokens.device)
    nxt = tokens[:, lo + 1:lo + w + 1]
    labels[:, :nxt.shape[1]] = nxt
    return local, labels


def chunked_lm_forward(model, chunk: int = 256, layout=None) -> Callable:
    """A ``forward_loss(module, batch)`` for
    :func:`tpudist_torch.train.make_train_step`: the next-token CE of
    ``batch["tokens"]`` that never materializes the ``[B, S, V]``
    logits. ``module`` (``model``, or ``model`` under DDP) runs the blocks
    with ``return_hidden=True``; the chunked head reads the model's head
    weight (:func:`lm_head_weight`: GPT-2's tied ``wte``, Llama's
    ``lm_head`` or tied ``embed``) outside that forward, and autograd sums
    a tied weight's two uses into one gradient before DDP's hook on it
    fires. Mean CE over the ``B (S - 1)`` predicted positions: the same
    function as ``lm_loss`` on full logits.
    The model's ``fused_ln`` attribute is read at each call, so no rebuild
    is needed when ``make_train_step(fused="ln")`` sets it. With a
    ``layout`` of more than one seq rank the loss is this rank's share:
    its chunk's CE sum (:func:`seq_shard_lm`) over the replica's ``B (S -
    1)``, which the seq group's ranks add up (``make_train_step(layout=)``
    takes such a loss and no other). An MoE model's (``has_aux_loss``)
    aux losses of the blocks' pass are added to the chunked CE, as the
    reference collects its sowed ``losses``."""
    if getattr(model, "dropout", 0.0):
        raise ValueError(
            "chunked_lm_forward does not support dropout (the fused path "
            "has no rng stream); use the default forward")
    if getattr(model, "router_jitter", 0.0):
        raise ValueError(
            "chunked_lm_forward does not support router_jitter (the fused "
            "path has no rng stream); use the default forward")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if getattr(model, "has_aux_loss", False):
        from tpudist_torch.parallel.ep import moe_losses

        aux = lambda: moe_losses(model)  # noqa: E731
    else:
        aux = lambda: 0.0  # noqa: E731

    def forward_loss(module, batch):
        tokens = batch["tokens"].long()
        if sharded:
            b, s = tokens.shape
            local, labels = seq_shard_lm(tokens, layout)
            hidden = module(local, return_hidden=True)
            return chunked_ce_sum(lm_head_weight(model), hidden,
                                  labels.clamp(min=0), labels >= 0,
                                  chunk, model=model) / (b * (s - 1))
        hidden = module(tokens, return_hidden=True)
        h, targets = hidden[:, :-1], tokens[:, 1:]
        b, s, _ = h.shape
        mask = torch.ones((b, s), device=h.device)
        return chunked_ce_sum(lm_head_weight(model), h, targets, mask,
                              chunk, model=model) / (b * s) + aux()

    sharded = layout is not None and layout.seq > 1
    forward_loss.layout = layout if sharded else None
    return forward_loss
