"""Tensor parallelism: the Megatron layers over a layout's tensor group.

Counterpart of :mod:`tpudist.parallel.tp`. The reference annotates its
parameters with ``nn.with_partitioning`` over the ``tensor`` mesh axis
and lets GSPMD insert the collectives; here each rank holds its shards
and the layers call the collectives themselves, over
``layout.tensor_group`` (:class:`tpudist_torch.mesh.RankLayout`):

- :func:`copy_to_tensor`: identity forward, all-reduce backward (the input
  of a column-parallel layer, replicated on every tensor rank);
- :func:`reduce_from_tensor`: all-reduce forward, identity backward (the
  output of a row-parallel layer, whose ranks each hold a partial sum);
- :func:`gather_from_tensor`: the vocabulary-sharded logits gathered along
  the last dim (serving samples from the whole row);
- :class:`ColumnParallel` / :class:`RowParallel`: the port's ``Dense``
  over a column shard (its input copied in) or a row shard (its partial
  products all-reduced, the replicated bias added once, after the sum);
- :func:`vocab_parallel_embedding`: a masked local lookup, then the sum;
- :func:`vocab_parallel_cross_entropy`: Megatron's loss, the row max and
  sum-exp all-reduced over ``tensor`` and the target logit taken from the
  rank that owns it, so no rank builds the whole ``[.., V]`` logits.

Every collective is a no-op when the layout has one tensor rank.
Half-precision sums go over the wire in float32 and are rounded once: a
row-parallel rank's partial product is kept in float32
(:func:`row_partial`), so the sum over the ranks is rounded once, where
the unsharded product rounds its one sum (and gloo has no bfloat16 sum on
every build).

:func:`tensor_spec` is the reference's annotations as a table, by a
parameter's name in the port's state dict: each family's own
(``GPT2_SPECS``, ``LLAMA_SPECS``, ``VIT_SPECS``, ``BERT_SPECS``,
``T5_SPECS``), which its model names as ``tensor_specs``;
:func:`shard_state_dict` and :func:`gather_state_dict` carry whole
weights to a rank's shards and back.
A replicated leaf that a rank reads only in part (BERT's MLM bias over
the rank's vocabulary, T5's relative-bias tables over its heads) is read
through :func:`copy_to_tensor`, whose backward sums the ranks' partial
gradients over the tensor group, so every rank's copy takes the whole
gradient and the copies stay equal. Two splits are not a contiguous slab
of one dim:

- GPT-2's ``qkv.weight`` ``[3d, d]`` orders its out features ``(3, H,
  dh)``: a rank's shard is heads ``[h0, h1)`` of each of q, k and v (spec
  ``(0, 3)``: dim 0 viewed as ``[3, d]``, its second factor split);
- the vocabulary (``wte``, ``embed``, ``lm_head``; T5's
  ``lm_head.weight``) splits by ``torch.chunk`` semantics, ``ceil(V /
  T)`` rows a rank and the last rank shorter (GPT-2's 50257 divides by
  neither 2 nor 4), which a ``DTensor`` with ``Shard(0)`` describes
  exactly.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

__all__ = [
    "tensor_size", "copy_to_tensor", "reduce_from_tensor",
    "gather_from_tensor", "ColumnParallel", "RowParallel", "RowLinear",
    "vocab_range", "vocab_parallel_embedding", "vocab_parallel_cross_entropy",
    "vocab_parallel_argmax",
    "tensor_spec", "shard_tensor", "gather_tensor", "shard_state_dict",
    "gather_state_dict", "full_shape", "shard_model", "check_heads",
    "check_model", "GPT2_SPECS", "LLAMA_SPECS", "LM_SPECS", "VIT_SPECS",
    "BERT_SPECS", "BERT_CLASSIFIER_SPECS", "T5_SPECS",
]


def tensor_size(layout) -> int:
    """The tensor world of ``layout`` (1 without one)."""
    return getattr(layout, "tensor", 1) if layout is not None else 1


def _group(layout):
    return layout.tensor_group


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it goes over the wire for a sum: float32 for half
    precision (module docstring), a private copy otherwise."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.float()
    return x.clone(memory_format=torch.contiguous_format)


def _all_reduce(x: torch.Tensor, layout) -> torch.Tensor:
    buf = _wire(x)
    dist.all_reduce(buf, group=_group(layout))
    return buf.to(x.dtype)


class _CopyToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout):
        ctx.layout = layout
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.layout), None


class _ReduceFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout):
        return _all_reduce(x, layout)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tensor(x, layout):
    """Identity forward, all-reduce of the gradient over the tensor group
    backward: the replicated input of a column-parallel layer, whose
    every rank's gradient is a partial sum."""
    if tensor_size(layout) == 1:
        return x
    return _CopyToTensor.apply(x, layout)


def reduce_from_tensor(x, layout):
    """All-reduce (sum) over the tensor group forward, identity backward:
    the partial products of a row-parallel layer."""
    if tensor_size(layout) == 1:
        return x
    return _ReduceFromTensor.apply(x, layout)


def _all_gather_last(x: torch.Tensor, sizes: list[int], layout):
    """The tensor ranks' ``x`` (``sizes[r]`` wide along the last dim)
    concatenated along it; shorter shards are padded on the wire."""
    width = max(sizes)
    pad = width - x.shape[-1]
    buf = F.pad(x, (0, pad)) if pad else x.contiguous()
    parts = [torch.empty_like(buf) for _ in sizes]
    dist.all_gather(parts, buf, group=_group(layout))
    return torch.cat([p[..., :n] for p, n in zip(parts, sizes)], dim=-1)


class _GatherFromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sizes, layout):
        ctx.lo = sum(sizes[:layout.tensor_idx])
        ctx.n = x.shape[-1]
        return _all_gather_last(x, sizes, layout)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.lo:ctx.lo + ctx.n].contiguous(), None, None


def gather_from_tensor(x, layout, full: int | None = None):
    """The tensor ranks' shards of the last dim gathered whole, in rank
    order (backward: this rank's slice of the gradient). ``full`` is the
    whole width when the shards are the vocabulary's uneven split
    (:func:`vocab_range`); without it they are equal."""
    t = tensor_size(layout)
    if t == 1:
        return x
    if full is None:
        sizes = [x.shape[-1]] * t
    else:
        sizes = [b - a for a, b in (vocab_range(full, t, r)
                                    for r in range(t))]
    return _GatherFromTensor.apply(x, sizes, layout)


# -- the layers ----------------------------------------------------------------


class ColumnParallel(nn.Module):
    """The port's ``Dense`` over a column shard: ``weight [out/T, in]``,
    ``bias`` of the local out features (``bias_shape``: its local shape,
    default ``[out/T]``), the input through :func:`copy_to_tensor`.
    ``layout`` None (or one tensor rank) is the plain ``Dense``."""

    def __init__(self, n_in: int, n_out: int, *, bias_shape=None,
                 device=None, layout=None):
        super().__init__()
        t = tensor_size(layout)
        self.layout = layout
        self.weight = nn.Parameter(torch.empty(n_out // t, n_in,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(bias_shape or (n_out // t,),
                                             device=device))

    def forward(self, x):
        x = copy_to_tensor(x, self.layout)
        return F.linear(x, self.weight.to(x.dtype),
                        self.bias.reshape(-1).to(x.dtype))


def _mm_f32(a, b):
    return torch.mm(a, b, out_dtype=torch.float32)


class _RowPartialF32(torch.autograd.Function):
    """``x2 @ w^T`` of half-precision operands with float32 output (a
    row-parallel rank's partial product, summed over the ranks in float32
    and rounded once after the sum, as the unsharded layer rounds its one
    product); the backward rounds the cotangent to the operands' dtype,
    the unsharded layer's half-precision cotangent."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return _mm_f32(x2, w.t())

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        gh = g.to(x2.dtype)
        return gh @ w, gh.t() @ x2


def row_partial(x, w):
    """This rank's float32 partial product ``x @ w^T`` of a row-parallel
    layer (half-precision operands multiply into float32 sums: on the
    card through cuBLAS, on the CPU upcast)."""
    if x.dtype not in (torch.bfloat16, torch.float16):
        return F.linear(x, w)
    if not x.is_cuda:
        return F.linear(x.float(), w.float())
    flat = _RowPartialF32.apply(x.reshape(-1, x.shape[-1]), w)
    return flat.reshape(*x.shape[:-1], w.shape[0])


def _row_forward(layer, x, bias):
    """A row-parallel layer's output: the ranks' float32 partial products
    summed over the tensor group, the replicated ``bias`` added once,
    rounded once to ``x``'s dtype."""
    y = reduce_from_tensor(row_partial(x, layer.weight.to(x.dtype)),
                           layer.layout)
    if bias is not None:
        y = y + bias.to(x.dtype).float()
    return y.to(x.dtype)


class RowParallel(nn.Module):
    """The port's ``Dense`` over a row shard: ``weight [out, in/T]`` times
    this rank's slice of the input features, the partial products summed
    over the tensor group (:func:`reduce_from_tensor`), then the
    replicated ``bias [out]`` added once: added on every rank before the
    sum it would count T times."""

    def __init__(self, n_in: int, n_out: int, *, device=None, layout=None):
        super().__init__()
        self.layout = layout
        self.weight = nn.Parameter(torch.empty(
            n_out, n_in // tensor_size(layout), device=device))
        self.bias = nn.Parameter(torch.zeros(n_out, device=device))

    def forward(self, x):
        if tensor_size(self.layout) == 1:
            return F.linear(x, self.weight.to(x.dtype),
                            self.bias.to(x.dtype))
        return _row_forward(self, x, self.bias)


class RowLinear(nn.Module):
    """:class:`RowParallel` without a bias (Llama's ``o_proj`` and
    ``down_proj``)."""

    def __init__(self, n_in: int, n_out: int, *, device=None, layout=None):
        super().__init__()
        self.layout = layout
        self.weight = nn.Parameter(torch.empty(
            n_out, n_in // tensor_size(layout), device=device))

    def forward(self, x):
        if tensor_size(self.layout) == 1:
            return F.linear(x, self.weight.to(x.dtype))
        return _row_forward(self, x, None)


# -- the vocabulary ------------------------------------------------------------


def vocab_range(vocab: int, tensor: int, rank: int) -> tuple[int, int]:
    """Rows ``[v0, v1)`` of a ``vocab``-row table on tensor rank ``rank``:
    ``torch.chunk`` semantics, ``ceil(vocab / tensor)`` rows a rank, the
    last rank shorter."""
    c = -(-vocab // tensor)
    return min(rank * c, vocab), min((rank + 1) * c, vocab)


def check_vocab(vocab: int, tensor: int) -> None:
    """Refuse a vocabulary that leaves a tensor rank no row."""
    if tensor > 1 and vocab_range(vocab, tensor, tensor - 1)[0] >= vocab:
        raise ValueError(
            f"vocab_size {vocab} leaves tensor rank {tensor - 1} of "
            f"{tensor} no row (ceil(V/T) rows a rank)")


def vocab_parallel_embedding(tokens, weight, layout, vocab: int):
    """``weight[tokens]`` of a vocabulary-sharded table (this rank's rows
    ``[v0, v1)``): each rank looks up the tokens it holds, zeros the
    others, and the ranks' rows are summed (exact: one rank contributes
    each row)."""
    t = tensor_size(layout)
    if t == 1:
        return weight[tokens]
    v0, v1 = vocab_range(vocab, t, layout.tensor_idx)
    outside = (tokens < v0) | (tokens >= v1)
    rows = weight[(tokens - v0).masked_fill(outside, 0)]
    rows = rows.masked_fill(outside[..., None], 0)
    return reduce_from_tensor(rows, layout)


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, target, v0, layout, ignore_index):
        group = _group(layout)
        logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
        m = logits.max(-1).values
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        z = logits - m[:, None]
        e = torch.exp(z)
        n = logits.shape[-1]
        valid = target != ignore_index
        mine = valid & (target >= v0) & (target < v0 + n)
        idx = (target - v0).clamp(0, n - 1)
        zt = torch.where(mine, z.gather(1, idx[:, None])[:, 0], 0.0)
        sums = torch.stack([e.sum(-1), zt])
        dist.all_reduce(sums, group=group)
        loss = torch.where(valid, torch.log(sums[0]) - sums[1], 0.0)
        e.div_(sums[0][:, None])
        ctx.save_for_backward(e, idx, mine, valid)
        return loss

    @staticmethod
    def backward(ctx, g):
        p, idx, mine, valid = ctx.saved_tensors
        grad = p.clone()
        rows = torch.arange(grad.shape[0], device=grad.device)
        grad[rows, idx] -= mine.to(grad.dtype)
        grad.mul_(torch.where(valid, g, 0.0)[:, None])
        return grad, None, None, None, None


def vocab_parallel_cross_entropy(logits, target, layout, vocab: int, *,
                                 ignore_index: int = -100):
    """Per-row softmax CE of vocabulary-sharded logits ``[N, V_local]``
    (in f32, or f64 for f64 logits) against whole-vocabulary ``target
    [N]``, 0 where ``target`` is ``ignore_index`` (Megatron's loss: module
    docstring). One rank is ``F.cross_entropy(..., reduction="none")``."""
    t = tensor_size(layout)
    if t == 1:
        return F.cross_entropy(
            logits.to(torch.promote_types(logits.dtype, torch.float32)),
            target, reduction="none", ignore_index=ignore_index)
    v0, _ = vocab_range(vocab, t, layout.tensor_idx)
    return _VocabParallelCE.apply(logits, target, v0, layout, ignore_index)


def vocab_parallel_argmax(logits, layout, vocab: int):
    """``torch.argmax(-1)`` of the whole rows of vocabulary-sharded logits
    ``[N, V_local]``: each rank's first maximum and its value, gathered
    over the tensor group, the first rank holding the global maximum wins,
    so a tie keeps ``torch.argmax``'s lowest index. Whole-vocabulary ids
    ``[N]``, the same on every tensor rank."""
    t = tensor_size(layout)
    if t == 1:
        return logits.argmax(-1)
    v0, _ = vocab_range(vocab, t, layout.tensor_idx)
    idx = logits.argmax(-1)
    best = logits.gather(-1, idx[:, None])[:, 0]
    best = best.to(torch.promote_types(best.dtype, torch.float32))
    vals = [torch.empty_like(best) for _ in range(t)]
    ids = [torch.empty_like(idx) for _ in range(t)]
    dist.all_gather(vals, best.contiguous(), group=_group(layout))
    dist.all_gather(ids, (idx + v0).contiguous(), group=_group(layout))
    vals, ids = torch.stack(vals), torch.stack(ids)
    first = (vals == vals.max(0).values).int().argmax(0)
    return ids.gather(0, first[None])[0]


# -- the placement table -------------------------------------------------------

#: Each family's placement table: a leaf's name below its block (the name
#: past its block index, ``h.3.qkv.weight`` -> ``qkv.weight``,
#: ``layer_3.q_proj.weight`` -> ``q_proj.weight``; a top-level leaf by its
#: whole name) -> ``(dim, outer)``, dim ``dim`` viewed as ``[outer, n]``
#: and its second factor split over the tensor ranks, or ``VOCAB``, the
#: vocabulary's split on dim 0 by ``torch.chunk``. The reference's
#: ``nn.with_partitioning`` annotations of tpudist/models/gpt2.py,
#: llama.py, vit.py, bert.py and t5.py; a model names its table as
#: ``tensor_specs``.
VOCAB = ("vocab", 0)
_MEGATRON_MHA = {
    "qkv.weight": (0, 3), "qkv.bias": (1, 1), "out.weight": (1, 1),
}
#: an MoE block's stacked experts (:mod:`tpudist_torch.parallel.ep`):
#: ``w1``, ``w_gate`` and ``w_up`` ``[E, d, ff]`` split on their ffn
#: columns, ``w2`` and ``w_down`` ``[E, ff, d]`` on their ffn rows; the
#: router stays whole
MOE_SPECS = {"moe.w1": (2, 1), "moe.w_gate": (2, 1), "moe.w_up": (2, 1),
             "moe.w2": (1, 1), "moe.w_down": (1, 1)}
GPT2_SPECS = {**_MEGATRON_MHA, "wte": VOCAB, "mlp_fc.weight": (0, 1),
              "mlp_fc.bias": (0, 1), "mlp_proj.weight": (1, 1),
              **MOE_SPECS}
LLAMA_SPECS = {
    "embed": VOCAB, "lm_head": VOCAB,
    "q_proj.weight": (0, 1), "k_proj.weight": (0, 1),
    "v_proj.weight": (0, 1), "o_proj.weight": (1, 1),
    "gate_proj.weight": (0, 1), "up_proj.weight": (0, 1),
    "down_proj.weight": (1, 1), **MOE_SPECS,
}
#: the table of a call that names none: the LMs' (their names do not meet)
LM_SPECS = {**GPT2_SPECS, **LLAMA_SPECS}
VIT_SPECS = {**_MEGATRON_MHA, "mlp.fc.weight": (0, 1),
             "mlp.fc.bias": (0, 1), "mlp.proj.weight": (1, 1)}
#: BERT's blocks carry GPT-2's names
BERT_SPECS = GPT2_SPECS
#: BertClassifier's: the encoder under ``bert.``
BERT_CLASSIFIER_SPECS = {**{k: v for k, v in BERT_SPECS.items()
                            if k != "wte"}, "bert.wte": VOCAB}
T5_SPECS = {
    "wte": VOCAB, "lm_head.weight": VOCAB,
    **{f"{attn}.{p}.weight": (0, 1)
       for attn in ("attn", "self_attn", "cross_attn") for p in "qkv"},
    **{f"{attn}.out.weight": (1, 1)
       for attn in ("attn", "self_attn", "cross_attn")},
    "mlp.wi_0.weight": (0, 1), "mlp.wi_1.weight": (0, 1),
    "mlp.wo.weight": (1, 1),
}


def _block_name(name: str) -> str:
    parts = name.split(".")
    idx = [i for i, p in enumerate(parts)
           if p.isdigit() or (p.startswith("layer_") and p[6:].isdigit())]
    return ".".join(parts[idx[-1] + 1:]) if idx else name


def tensor_spec(name: str, shape=None, *, table: dict | None = None):
    """How the leaf ``name`` of a model's state dict is placed over the
    tensor axis: ``None`` (replicated), ``("vocab", 0)`` (the vocabulary's
    uneven split on dim 0) or ``(dim, outer)`` (dim ``dim`` viewed as
    ``[outer, n]``, its second factor split evenly), by the family's
    ``table`` (``model.tensor_specs``; None: ``LM_SPECS``). ``shape`` is
    accepted for the reference's signature and unused."""
    return (LM_SPECS if table is None else table).get(_block_name(name))


def full_shape(name: str, local_shape, tensor: int, vocab: int | None, *,
               table: dict | None = None) -> tuple:
    """The whole leaf's shape from this rank's shard of it."""
    spec = tensor_spec(name, table=table)
    out = list(local_shape)
    if spec is None or tensor == 1:
        return tuple(out)
    if spec[0] == "vocab":
        out[0] = vocab
    else:
        out[spec[0]] *= tensor
    return tuple(out)


def shard_tensor(name: str, full: torch.Tensor, tensor: int, rank: int, *,
                 table: dict | None = None):
    """Tensor rank ``rank``'s shard of the whole leaf ``full`` (a view
    where the split is a slab, a copy for the grouped ``qkv`` split)."""
    spec = tensor_spec(name, table=table)
    if spec is None or tensor == 1:
        return full
    if spec[0] == "vocab":
        v0, v1 = vocab_range(full.shape[0], tensor, rank)
        return full[v0:v1]
    dim, outer = spec
    n = full.shape[dim] // outer
    if n % tensor:
        raise ValueError(f"{name}: dim {dim} ({full.shape[dim]}"
                         f"{f' = {outer} x {n}' if outer > 1 else ''}) does "
                         f"not divide over tensor={tensor}")
    w = n // tensor
    if outer == 1:
        return full.narrow(dim, rank * w, w)
    shape = list(full.shape)
    view = full.reshape(*shape[:dim], outer, n, *shape[dim + 1:])
    part = view.narrow(dim + 1, rank * w, w)
    return part.reshape(*shape[:dim], outer * w, *shape[dim + 1:])


def gather_tensor(name: str, local: torch.Tensor, layout, vocab: int | None,
                  *, table: dict | None = None):
    """The whole leaf from every tensor rank's shard (a collective over
    the tensor group: every rank calls it)."""
    spec = tensor_spec(name, table=table)
    t = tensor_size(layout)
    if spec is None or t == 1:
        return local
    if spec[0] == "vocab":
        moved = local.movedim(0, -1)
        return gather_from_tensor(moved.detach(), layout,
                                  full=vocab).movedim(-1, 0).contiguous()
    dim, outer = spec
    parts = [torch.empty_like(local) for _ in range(t)]
    dist.all_gather(parts, local.detach().contiguous(), group=_group(layout))
    if outer == 1:
        return torch.cat(parts, dim=dim)
    shape = list(local.shape)
    w = shape[dim] // outer
    views = [p.reshape(*shape[:dim], outer, w, *shape[dim + 1:])
             for p in parts]
    whole = torch.cat(views, dim=dim + 1)
    return whole.reshape(*shape[:dim], outer * w * t, *shape[dim + 1:])


def shard_state_dict(full_sd: dict, layout, *,
                     table: dict | None = None) -> dict:
    """This rank's shards of a whole state dict (:func:`tensor_spec` under
    the family's ``table``; replicated leaves as they are), each a
    contiguous copy; under an expert axis the stacked expert leaves keep
    this rank's experts too (:func:`tpudist_torch.parallel.ep.
    shard_experts`)."""
    from tpudist_torch.parallel.ep import shard_experts

    t = tensor_size(layout)
    r = layout.tensor_idx if t > 1 else 0
    return shard_experts({k: shard_tensor(k, v, t, r, table=table).clone(
                              memory_format=torch.contiguous_format)
                          if tensor_spec(k, table=table) is not None
                          and t > 1 else v
                          for k, v in full_sd.items()}, layout)


def gather_state_dict(shard_sd: dict, layout, vocab: int | None, *,
                      table: dict | None = None) -> dict:
    """The whole state dict from every tensor rank's shards (every rank
    calls it, with its dict in the same order), and every expert of the
    stacked expert leaves under an expert axis."""
    from tpudist_torch.parallel.ep import gather_expert_sd

    return gather_expert_sd({k: gather_tensor(k, v, layout, vocab,
                                              table=table)
                             for k, v in shard_sd.items()}, layout)


# -- whole models --------------------------------------------------------------


def check_heads(num_heads: int, num_kv_heads: int | None, tensor: int,
                name: str = "model") -> None:
    """The reference engine's refusal, before any weight moves: the head
    counts must divide over the tensor world (each rank runs its share of
    the heads; an LM's KV pools shard on their KV-head dim and the decode
    kernels run on each rank's heads). ``num_kv_heads`` None: a model
    without grouped K/V (ViT, BERT, T5)."""
    if num_kv_heads is None:
        if num_heads % tensor:
            raise ValueError(
                f"{name}: num_heads={num_heads} not divisible by "
                f"tensor={tensor} — each tensor rank runs num_heads / tensor "
                "heads (column-parallel q/k/v, row-parallel out); pick a "
                "smaller tensor=")
        return
    if num_heads % tensor or num_kv_heads % tensor:
        raise ValueError(
            f"{name}: num_heads={num_heads} / num_kv_heads={num_kv_heads} "
            f"not divisible by tensor={tensor} — the KV pool shards on the "
            "KV-head dim and the paged kernel runs per-shard, so BOTH head "
            "counts must divide the tensor world (GQA: the KV heads are the "
            "binding constraint); pick a smaller tensor= or serve unsharded "
            "(mesh=None)")


def check_model(model, tensor: int) -> None:
    """The refusals of a model over ``tensor`` ranks: its head counts
    (:func:`check_heads`), and its vocabulary where it has one."""
    if tensor == 1:
        return
    check_heads(model.num_heads, getattr(model, "num_kv_heads", None),
                tensor)
    vocab = getattr(model, "vocab_size", None)
    if vocab is not None:
        check_vocab(vocab, tensor)


def shard_model(model: nn.Module, layout) -> nn.Module:
    """``model`` (a whole GPT-2, Llama, ViT, BERT or T5) with this rank's
    shards of its weights and ``layout`` set on it and every module that
    reads one; a copy when ``model`` would be changed, ``model`` itself
    when it already is on ``layout``. Its forward then computes the whole
    model's function (the serving engine's ``mesh=``)."""
    t = tensor_size(layout)
    if t == 1 or model.layout is layout:
        return model
    if tensor_size(model.layout) > 1:
        raise ValueError("the model is already sharded over another "
                         "tensor layout")
    check_model(model, t)
    import copy

    table = model.tensor_specs
    held = copy.deepcopy(model)
    with torch.no_grad():
        for k, p in held.named_parameters():
            if tensor_spec(k, table=table) is not None:
                p.data = shard_tensor(k, p.data, t, layout.tensor_idx,
                                      table=table).clone(
                    memory_format=torch.contiguous_format)
    for m in held.modules():
        if hasattr(m, "layout"):
            m.layout = layout
    return held


def sharded_names(model: nn.Module) -> list[str]:
    """The parameters of ``model`` held as tensor shards."""
    if tensor_size(getattr(model, "layout", None)) == 1:
        return []
    table = model.tensor_specs
    return [k for k, _ in model.named_parameters()
            if tensor_spec(k, table=table) is not None]


def init_sharded(p: torch.Tensor, name: str, draw, layout,
                 vocab: int | None, *, table: dict | None = None) -> None:
    """Write this rank's shard of ``draw(whole shape)`` into ``p`` (the
    random init of a sharded model: each leaf drawn whole from the seeded
    generator, in the unsharded model's order, then sliced, so a sharded
    model is the unsharded one's function)."""
    t = tensor_size(layout)
    if t == 1 or tensor_spec(name, table=table) is None:
        p.copy_(draw(tuple(p.shape)))
        return
    whole = draw(full_shape(name, p.shape, t, vocab, table=table))
    p.copy_(shard_tensor(name, whole, t, layout.tensor_idx, table=table))
