"""BERT in PyTorch: counterpart of :mod:`tpudist.models.bert`.

A bidirectional encoder with the masked-LM objective: learned token,
position and segment embeddings behind a LayerNorm, post-LN blocks
(``ln(x + branch)``, eps 1e-12) with bidirectional attention and an erf
GELU MLP, and the MLM head (dense, GELU, LayerNorm, then the decode tied to
``wte`` with a free f32 bias). The parameters keep the reference's names
and shapes: ``wte``, ``wpe``, ``wty``, ``ln_embed``, ``h.{i}.{qkv, out,
ln_attn, mlp_fc, mlp_proj, ln_mlp}`` (``qkv``'s bias ``[3, heads, dh]``,
which the weight-decay mask reads) and ``mlm_head.{transform, ln,
bias}``; :func:`tpudist_torch.interop.bert_params_from_flax` carries a flax
tree across, unrolled or stacked under ``hs/block``.

Routing, as the reference's:

- ``fused_ln`` (the attribute that ``make_train_step(fused="ln")`` sets)
  sends ``ln_embed`` through the fused LayerNorm kernel's plain
  composition and both post-LNs of every block through its post-norm
  composition (:func:`~tpudist_torch.ops.layernorm.fused_layernorm` with
  the residual and ``return_residual=False``: the sum is normed, never
  written); the MLM head's LayerNorm stays dense.
- ``attn_impl`` ``"xla"``, ``"vmem"``, ``"flash"`` and ``"auto"`` go
  through :func:`~tpudist_torch.ops.attention.multi_head_attention` at
  ``causal=False``; an ``attention_mask [B, S]`` (1 = real token) becomes
  the ``[B, 1, 1, S]`` key mask and takes the dense path.
- ``"ring"``, ``"ulysses"`` and ``"ulysses_flash"`` go through
  :mod:`tpudist_torch.parallel.cp` at ``causal=False`` over the model's
  ``layout`` (this rank's chunk of every sequence, ``wpe`` read at the
  chunk's global positions); they refuse an ``attention_mask``.

The tied decode is GPT-2's head (:func:`~tpudist_torch.models.gpt2.
tied_head`: f32 logits, and on the card the f32 cotangent carried as hi +
lo bf16 halves) with the f32 bias added after it. ``scan_layers`` and
``remat_layers`` are the reference's fields: eager PyTorch has no trace to
shorten, so the blocks stay unrolled and ``remat_layers`` checkpoints each
one in full.

:func:`mlm_forward` is the training loss (the global masked-CE mean, see
there) and :func:`mlm_transform` the host-side 80/10/10 corruption, a
numpy copy of the reference's that gives the same draws for a seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tpudist_torch import remat as remat_lib
from tpudist_torch.device import resolve_device
from tpudist_torch.distributed import group_up
from tpudist_torch.models.gpt2 import (
    _TRUNC_STD, Dense, LayerNorm, check_attn_impl, dropout, seq_offset,
    site_key, tied_head, train_key,
)
from tpudist_torch.models.lm_utils import chunked_head_reduce, seq_shard
from tpudist_torch.ops.attention import multi_head_attention
from tpudist_torch.ops.layernorm import fused_layernorm
from tpudist_torch.parallel.cp import CP_IMPLS, context_parallel_attention
from tpudist_torch.rng import generator

#: BERT's LayerNorm epsilon, every norm of the family
EPS = 1e-12


def _gelu(x):
    """The exact (erf) GELU, BERT's convention."""
    return F.gelu(x, approximate="none")


class EncoderBlock(nn.Module):
    """Post-LN bidirectional block: the residual sum is normed."""

    def __init__(self, hidden_dim: int, num_heads: int, *, dtype, attn_impl,
                 device, dropout: float = 0.0, layout=None):
        super().__init__()
        d = hidden_dim
        self.num_heads = num_heads
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.layout = layout
        self.dropout = dropout
        self.qkv = Dense(d, 3 * d, bias_shape=(3, num_heads, d // num_heads),
                         device=device)
        self.out = Dense(d, d, device=device)
        self.ln_attn = LayerNorm(d, eps=EPS, device=device)
        self.mlp_fc = Dense(d, 4 * d, device=device)
        self.mlp_proj = Dense(4 * d, d, device=device)
        self.ln_mlp = LayerNorm(d, eps=EPS, device=device)

    def _post_ln(self, ln, x, y, fused: bool):
        if fused:
            return fused_post_ln(ln, x, y, self.dtype)
        return ln(x + y, self.dtype)

    def forward(self, x, attention_mask=None, fused_ln: bool = False,
                dropout_key: int | None = None):
        b, s, d = x.shape
        h = self.num_heads
        q, k, v = self.qkv(x).view(b, s, 3, h, d // h).unbind(2)
        if self.attn_impl in CP_IMPLS:
            if attention_mask is not None:
                raise ValueError(
                    f"attention_mask is not supported with attn_impl="
                    f"{self.attn_impl!r} (the context-parallel paths assume "
                    "dense fixed-length windows); pad-free batches or the "
                    "xla/flash impls")
            attn = context_parallel_attention(
                q, k, v, self.attn_impl, self.layout.seq_group, causal=False)
        else:
            key_mask = (None if attention_mask is None
                        else attention_mask[:, None, None, :].bool())
            attn = multi_head_attention(q, k, v, causal=False, mask=key_mask,
                                        impl=self.attn_impl)
        y = dropout(self.out(attn.reshape(b, s, d)), self.dropout,
                    site_key(dropout_key, 0))
        x = self._post_ln(self.ln_attn, x, y, fused_ln)
        y = self.mlp_proj(_gelu(self.mlp_fc(x)))
        y = dropout(y, self.dropout, site_key(dropout_key, 1))
        return self._post_ln(self.ln_mlp, x, y, fused_ln)


def fused_post_ln(ln: LayerNorm, x, y, dtype):
    """The reference's ``FusedLayerNorm(...)(y, residual=x,
    return_residual=False)`` over ``ln``'s parameters: the norm of ``x +
    y`` in one kernel sweep, only the normed value written."""
    return fused_layernorm(y, ln.scale, ln.bias, residual=x, eps=ln.eps,
                           out_dtype=dtype, return_residual=False)


class MlmHead(nn.Module):
    """BERT's MLM head: ``transform`` (dense, erf GELU, LayerNorm ``ln``)
    then the decode tied to the embedding table, plus the f32 ``bias``."""

    def __init__(self, hidden_dim: int, vocab_size: int, *, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.transform = Dense(hidden_dim, hidden_dim, device=device)
        self.ln = LayerNorm(hidden_dim, eps=EPS, device=device)
        self.bias = nn.Parameter(torch.zeros(vocab_size, device=device))

    def forward(self, x, wte):
        y = self.ln(_gelu(self.transform(x.to(self.dtype))), self.dtype)
        return tied_head(y, wte.to(self.dtype)) + self.bias.float()


class Bert(nn.Module):
    """BERT-base with the reference's defaults (vocab 30522, S 512, d 768,
    12 layers, 12 heads, 2 segment types). ``device`` defaults to
    ``"cuda"`` and raises without a card unless ``"cpu"`` is given;
    ``seed`` draws flax's init (N(0, 0.02) embeddings, lecun-normal
    kernels, zero biases, unit LayerNorm scales). ``layout`` serves the
    context-parallel impls (module docstring). ``mlm_head=False`` builds
    the encoder alone (the classifier's ``bert``, which has no head)."""

    def __init__(self, vocab_size: int = 30522, max_seq_len: int = 512,
                 hidden_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 type_vocab: int = 2, dtype=torch.float32,
                 attn_impl: str = "xla", *, dropout: float = 0.0,
                 scan_layers: bool = False, remat_layers: bool = False,
                 fused_ln: bool = False, layout=None, device=None,
                 seed: int = 0, mlm_head: bool = True):
        super().__init__()
        check_attn_impl(attn_impl, layout, gather=False)
        if hidden_dim % num_heads:
            raise ValueError("hidden_dim must divide into num_heads")
        if remat_layers and not scan_layers:
            raise ValueError("remat_layers requires scan_layers=True "
                             "(use make_train_step(remat=True) to checkpoint "
                             "an unrolled forward)")
        self.block_policy = "full" if remat_layers else None
        self.device = resolve_device(device)
        self.vocab_size = vocab_size
        self.max_seq_len = max_seq_len
        self.hidden_dim = hidden_dim
        self.depth = depth
        self.num_heads = num_heads
        self.type_vocab = type_vocab
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.layout = layout
        self.dropout = float(dropout)
        self.scan_layers = bool(scan_layers)
        self.fused_ln = bool(fused_ln)
        dev = self.device
        self.wte = nn.Parameter(torch.empty(vocab_size, hidden_dim, device=dev))
        self.wpe = nn.Parameter(torch.empty(max_seq_len, hidden_dim, device=dev))
        if type_vocab:
            self.wty = nn.Parameter(torch.empty(type_vocab, hidden_dim,
                                                device=dev))
        self.ln_embed = LayerNorm(hidden_dim, eps=EPS, device=dev)
        self.h = nn.ModuleList(
            EncoderBlock(hidden_dim, num_heads, dtype=dtype,
                         attn_impl=attn_impl, device=dev,
                         dropout=self.dropout, layout=layout)
            for _ in range(depth))
        if mlm_head:
            self.mlm_head = MlmHead(hidden_dim, vocab_size, dtype=dtype,
                                    device=dev)
        self.init_weights(seed)
        self.eval()

    @property
    def geometry(self) -> dict:
        """What a checkpoint of this model is bound to (the run meta)."""
        return {"arch": "bert", "vocab_size": self.vocab_size,
                "hidden_dim": self.hidden_dim, "depth": self.depth,
                "num_heads": self.num_heads}

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        g = generator(int(seed), self.device)
        for name, p in self.named_parameters():
            if p.ndim == 2 and name.endswith("weight"):
                lecun_(p, p.shape[1], g)
            elif name.endswith("bias"):
                p.zero_()
            elif name.endswith("scale"):
                p.fill_(1.0)
            else:  # the embedding tables
                p.copy_(torch.randn(p.shape, device=p.device, generator=g)
                        * 0.02)

    def forward(self, tokens, *, return_hidden: bool = False,
                token_types=None, attention_mask=None,
                dropout_key: int | None = None):
        """``tokens [B, s]`` -> f32 MLM logits ``[B, s, V]`` (or the final
        hidden state in the compute dtype with ``return_hidden``).
        ``token_types`` defaults to segment 0; ``attention_mask`` ``[B, s]``
        excludes the padded keys. A context-parallel model takes this
        rank's chunk of each sequence."""
        b, s = tokens.shape
        if s > self.max_seq_len:
            raise ValueError(
                f"sequence {s} exceeds max_seq_len {self.max_seq_len}")
        dropout_key = train_key(self, dropout_key)
        tokens = tokens.long()
        off = seq_offset(self, s)
        # the reference adds the tables in their own dtype (f32 masters, the
        # compute copy's dtype under the fused optimizer), then casts
        x = self.wte[tokens] + self.wpe[off:off + s]
        if self.type_vocab:
            types = (torch.zeros_like(tokens) if token_types is None
                     else token_types.long())
            x = x + self.wty[types]
        x = x.to(self.dtype)
        fused = self.fused_ln
        x = (self.ln_embed.fused(x, self.dtype) if fused
             else self.ln_embed(x, self.dtype))
        x = dropout(x, self.dropout, site_key(dropout_key, 0))
        for i, blk in enumerate(self.h):
            run = remat_lib.checkpoint(blk, self.block_policy)
            x = run(x, attention_mask, fused_ln=fused,
                    dropout_key=site_key(dropout_key, i + 1))
        if return_hidden:
            return x
        return self.mlm_head(x, self.wte)


def lecun_(p, fan_in: int, g) -> None:
    """flax's lecun-normal into ``p``: a normal truncated at 2 sigma,
    rescaled to standard deviation ``sqrt(1 / fan_in)``."""
    t = torch.empty(p.shape, device=p.device)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
    p.copy_(t * (math.sqrt(1.0 / fan_in) / _TRUNC_STD))


class BertClassifier(nn.Module):
    """Sequence classification on the encoder (the reference's fine-tuning
    surface): the first token's hidden state through the tanh ``pooler``,
    then the f32 ``classifier`` head. The encoder lives under ``bert``, so
    :func:`classifier_params_from_mlm` grafts pretrained weights into
    it."""

    def __init__(self, num_labels: int, vocab_size: int = 30522,
                 max_seq_len: int = 512, hidden_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, type_vocab: int = 2,
                 dtype=torch.float32, attn_impl: str = "xla", *,
                 dropout: float = 0.0, device=None, seed: int = 0):
        super().__init__()
        self.bert = Bert(vocab_size, max_seq_len, hidden_dim, depth,
                         num_heads, type_vocab, dtype, attn_impl,
                         dropout=dropout, device=device, seed=seed,
                         mlm_head=False)
        dev = self.bert.device
        self.device = dev
        self.dtype = dtype
        self.dropout = float(dropout)
        self.pooler = Dense(hidden_dim, hidden_dim, device=dev)
        self.classifier = Dense(hidden_dim, num_labels, device=dev)
        g = generator(int(seed) + 1, dev)
        with torch.no_grad():
            for lin in (self.pooler, self.classifier):
                lecun_(lin.weight, hidden_dim, g)
        self.eval()

    def forward(self, tokens, *, token_types=None, attention_mask=None,
                dropout_key: int | None = None):
        """``tokens [B, S]`` -> f32 logits ``[B, num_labels]``. Padded
        variable-length batches must pass ``attention_mask``, or the pad
        tokens join every softmax."""
        dropout_key = train_key(self, dropout_key)
        hidden = self.bert(tokens, return_hidden=True, token_types=token_types,
                           attention_mask=attention_mask,
                           dropout_key=site_key(dropout_key, 0))
        pooled = torch.tanh(self.pooler(hidden[:, 0]))
        pooled = dropout(pooled, self.dropout, site_key(dropout_key, 1))
        return self.classifier(pooled.float())


def classifier_params_from_mlm(classifier_params: dict,
                               pretrained: dict) -> dict:
    """Graft a pretrained encoder (a :class:`Bert` state dict, trained or
    HF-imported) into a :class:`BertClassifier` state dict: every ``bert.*``
    entry is replaced, the pooler and classifier keep their fresh init;
    ``mlm_head.*`` is dropped. A geometry mismatch raises instead of
    grafting half a model."""
    encoder = {k: v for k, v in pretrained.items()
               if not k.startswith("mlm_head.")}
    fresh = {k[len("bert."):]: v for k, v in classifier_params.items()
             if k.startswith("bert.")}
    if set(encoder) != set(fresh):
        raise ValueError(
            f"pretrained encoder entries {sorted(set(encoder) ^ set(fresh))} "
            "do not match the classifier's")
    out = dict(classifier_params)
    for k, v in encoder.items():
        if tuple(v.shape) != tuple(fresh[k].shape):
            raise ValueError(f"{k}: pretrained {tuple(v.shape)} != "
                             f"classifier {tuple(fresh[k].shape)}")
        out[f"bert.{k}"] = v.to(fresh[k].dtype)
    return out


def bert_base(**kw) -> Bert:
    return Bert(**kw)


def bert_large(**kw) -> Bert:
    kw.setdefault("hidden_dim", 1024)
    kw.setdefault("depth", 24)
    kw.setdefault("num_heads", 16)
    return Bert(**kw)


def mlm_transform(vocab_size: int, mask_id: int, *, mask_rate: float = 0.15,
                  random_rate: float = 0.1, keep_rate: float = 0.1,
                  seed: int = 0, key: str = "tokens"):
    """Loader transform applying BERT's 80/10/10 corruption on the host,
    the reference's draws for the same seed: each position is selected
    with probability ``mask_rate``; of those, ``random_rate`` become a
    uniform id that is never ``mask_id``, ``keep_rate`` stay, the rest
    become ``mask_id``. Produces ``{"tokens": corrupted, "targets":
    originals, "mlm_mask": bool}``; the stream advances once per batch."""
    rng = np.random.Generator(np.random.PCG64(seed))

    def run(batch):
        tokens = np.asarray(batch[key])
        u = rng.random(tokens.shape)
        selected = u < mask_rate
        to_random = selected & (u < mask_rate * random_rate)
        to_keep = selected & (u >= mask_rate * (1.0 - keep_rate))
        to_mask = selected & ~to_random & ~to_keep
        corrupted = tokens.copy()
        corrupted[to_mask] = mask_id
        # over vocab_size - 1 ids, those at or above mask_id shifted up
        draw = rng.integers(0, vocab_size - 1, int(to_random.sum()))
        corrupted[to_random] = draw + (draw >= mask_id)
        out = dict(batch)
        out[key] = corrupted
        out["targets"] = tokens
        out["mlm_mask"] = selected
        return out

    return run


def mlm_head_logits_fn(model: Bert):
    """``logits_fn`` for :func:`~tpudist_torch.models.lm_utils.
    chunked_head_reduce`: the MLM head on a hidden chunk."""
    return lambda hc: model.mlm_head(hc, model.wte)


def mlm_forward(model: Bert, chunk: int | None = None, layout=None):
    """A ``forward_loss(module, batch)`` for
    :func:`tpudist_torch.train.make_train_step`: the masked CE over the
    corrupted positions of :func:`mlm_transform`'s batches (``tokens``,
    ``targets``, ``mlm_mask``), optionally through the chunked head
    (``chunk``: live logits bounded by ``[B, chunk, V]``).

    The reference divides its CE sum by the count of masked positions in
    the GLOBAL batch. Here each rank holds its share: its CE sum over that
    global count (the local counts all-reduced before the division, per
    microbatch under ``grad_accum``), times the data replicas, because
    DDP averages the ranks' gradients and the step's logged loss is the
    ranks' sum over the replicas. With a ``layout`` of more than one seq
    rank, the rank scores its chunk of every row (``tokens``, ``targets``
    and ``mlm_mask`` sliced alike, no shift), and the step's ``loss x
    seq`` backward completes the sum over the chunks."""
    if getattr(model, "dropout", 0.0):
        raise ValueError(
            "mlm_forward has no rng stream; use dropout=0 (match "
            "chunked_lm_forward's contract) or extend the default forward")
    if chunk is not None and chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    sharded = layout is not None and layout.seq > 1
    seq = layout.seq if layout is not None else 1

    def forward_loss(module, batch):
        tokens, targets = batch["tokens"].long(), batch["targets"].long()
        mask = batch["mlm_mask"].float()
        if sharded:
            tokens, targets, mask = (seq_shard(x, layout)
                                     for x in (tokens, targets, mask))
        count = mask.sum()
        data = 1
        if group_up():
            dist.all_reduce(count)
            data = dist.get_world_size() // seq
        if chunk is None:
            logits = module(tokens)
            ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                 targets.reshape(-1), reduction="none")
            total = (ce * mask.reshape(-1)).sum()
        else:
            hidden = module(tokens, return_hidden=True)
            total = chunked_head_reduce(mlm_head_logits_fn(model), hidden,
                                        targets, mask, chunk)
        return total / torch.clamp(count, min=1.0) * data

    forward_loss.layout = layout if sharded else None
    return forward_loss
