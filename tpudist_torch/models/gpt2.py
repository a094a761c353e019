"""GPT-2 decoder in PyTorch: counterpart of :mod:`tpudist.models.gpt2`.

``num_experts > 0`` makes every ``moe_every``-th block (``i % moe_every
== moe_every - 1``) a mixture of experts: its ``mlp_fc`` / ``mlp_proj``
become :class:`tpudist_torch.parallel.ep.MoEMlp` under the name ``moe``
(top-``moe_top_k`` routing, ``capacity_factor``, ``moe_dispatch``
``"einsum"`` or ``"index"``, ``router_z_loss``, ``router_jitter``; on a
layout with an expert axis a rank holds its share of the experts), in
training and on every decode path; the train step adds the layers'
aux losses to the task loss (``has_aux_loss``). :class:`PipelinedGPT2`
runs dense blocks over a layout's pipe axis
(:mod:`tpudist_torch.parallel.pp`). The decode path runs over a KV cache
(:mod:`tpudist_torch.ops.decode`) in the reference's three modes: scalar
cursor (``generate``), per-row positions (the contiguous serving pool)
and paged block tables (the paged pool). Any ``attn_impl`` other than
``"xla"`` sends decode through the kernels, as in the reference. The
non-decode forward is dense for ``"xla"`` and ``"fused"`` and goes
through :func:`tpudist_torch.ops.attention.multi_head_attention` for
``"vmem"`` (the whole-row kernel), ``"flash"`` (the blockwise kernel) and
``"auto"`` (by sequence length, the reference's routing).

The context-parallel impls ``"ring"``, ``"ulysses"`` and
``"ulysses_flash"`` (:mod:`tpudist_torch.parallel.cp`) need the model's
``layout`` (a :class:`tpudist_torch.mesh.RankLayout`, the reference's
``mesh``): the forward takes this rank's chunk of every sequence, the
positions ``seq_idx * s ..`` of the global row (``wpe`` read there), and
the attention runs over the layout's seq group. Under a layout whose seq
axis is larger than 1 the other impls (``"xla"``, ``"vmem"``, ``"flash"``,
``"auto"``) take the same chunk and positions and attend over the whole
sequence, gathered over the seq group
(:func:`tpudist_torch.parallel.cp.gathered_attention`): the reference's
GSPMD runs them replicated over the sequence. A seq-sharded model has no
decode path and raises there, as the reference does.

Under a layout with a tensor axis (:mod:`tpudist_torch.parallel.tp`, the
reference's ``nn.with_partitioning`` annotations) each rank holds
``num_heads / T`` heads: ``qkv`` (its grouped ``(3, H, dh)`` split) and
``mlp_fc`` are column-parallel, ``out`` and ``mlp_proj`` row-parallel,
``wte`` is split over the vocabulary (the embedding a masked lookup and a
sum, the tied head this rank's logit columns), and ``wpe`` and the
LayerNorms stay whole, on whole rows. The random init draws every leaf
whole from the seeded generator, then keeps this rank's shard, so a
sharded model computes the unsharded one's function. With a seq axis too
each attention (ring, Ulysses, the gathered one) runs over the seq group
on the rank's heads. Training reads the
vocabulary-local logits (``forward(vocab_local=True)``, for
:func:`tpudist_torch.parallel.tp.vocab_parallel_cross_entropy`); every
other forward, decode included, gathers them whole.

``fused_ln`` (an attribute, which ``make_train_step(fused="ln")`` sets)
swaps in the fused residual-add + LayerNorm kernel
(:mod:`tpudist_torch.ops.layernorm`) where the reference's knob does:
``ln_1`` plain, ``ln_2`` pre-norm with the residual stream, ``ln_f``
plain, never on decode. The parameters are the same either way: each
:class:`LayerNorm` holds ``scale`` and ``bias`` and runs either path.

Numerics follow the flax model at ``dtype``: every parameter is a
float32 master cast to ``dtype`` at each use, as flax does (under the
fused optimizer's compute copy the parameters already are ``dtype`` and
the casts are no-ops); :func:`compute_copy` gives the serving engine a
copy held in ``dtype``. LayerNorm keeps f32 statistics with flax's fast
variance ``E[x^2] - E[x]^2``, GELU is the tanh approximation (flax
``nn.gelu``), and the tied LM head returns f32 logits.

``dropout`` is the reference's: on the embedding sum and on each
residual branch before its add, in train mode, with masks drawn from the
``dropout_key`` the training step passes (:func:`dropout`). The memory
levers are the reference's fields: ``remat_policy`` checkpoints each
block under a :mod:`tpudist_torch.remat` policy, and ``remat_layers``
(which requires ``scan_layers``) means ``"full"``. ``scan_layers`` exists
in JAX so that the compiler traces one block instead of ``depth`` and
stores the parameters stacked; eager PyTorch has no trace to shorten, so
here it builds the same unrolled blocks (``interop.gpt2_params_from_flax``
unstacks a scanned tree) and only keeps the reference's refusals. The
decode path never remats and never drops.
"""

from __future__ import annotations

import copy
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from tpudist_torch import remat as remat_lib
from tpudist_torch.device import resolve_device
from tpudist_torch.ops.attention import multi_head_attention
from tpudist_torch.ops.decode import (
    cached_kv, decode_attention, paged_decode_attention,
)
from tpudist_torch.ops.layernorm import fused_layernorm
from tpudist_torch.parallel.cp import (
    CP_IMPLS, context_parallel_attention, gathered_attention_local,
)
from tpudist_torch.parallel import pp as pp_lib
from tpudist_torch.parallel import tp as tp_lib
from tpudist_torch.parallel.ep import MoEMlp
from tpudist_torch.parallel.tp import (
    ColumnParallel, RowParallel, copy_to_tensor, tensor_size,
)
from tpudist_torch.rng import fold_in, generator

ATTN_IMPLS = ("xla", "fused", "vmem", "auto", "flash", *CP_IMPLS)
# flax's lecun_normal: truncated normal on [-2, 2] rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def dropout(x, rate: float, key: int | None):
    """flax ``nn.Dropout(rate)`` in train mode: each element kept with
    probability ``1 - rate`` and divided by it (in ``x``'s dtype), else 0,
    the mask drawn from a generator seeded with ``key`` at this call (so a
    checkpoint's recompute draws it again). ``key=None`` returns ``x``."""
    if key is None or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    u = torch.rand(x.shape, generator=generator(key, x.device), device=x.device)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def check_attn_impl(attn_impl: str, layout, *, gather: bool = True) -> None:
    """Refuse an unknown ``attn_impl``, a context-parallel one without a
    ``layout`` (the reference's refusal of a CP impl without its
    ``mesh``), and, for a model without the gathered path (``gather=
    False``), a non-context-parallel one under a seq axis."""
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}")
    if attn_impl in CP_IMPLS and layout is None:
        raise ValueError(
            f"attn_impl={attn_impl!r} needs the model's layout= (a "
            "tpudist_torch.mesh.RankLayout: the attention runs over its seq "
            "group)")
    if not gather and attn_impl not in CP_IMPLS and layout is not None \
            and layout.seq > 1:
        raise ValueError(
            f"a seq axis of {layout.seq} needs a sequence-parallel "
            "attention: attn_impl ring, ulysses or ulysses_flash")


def check_tensor(model) -> int:
    """The tensor world of ``model``'s layout, after the reference's
    checks: both head counts and the vocabulary must divide over it."""
    t = tensor_size(model.layout)
    tp_lib.check_model(model, t)
    return t


def lm_logits(model, x, head_w, vocab_local: bool):
    """The LM head over ``x`` with the ``[V, D]`` table ``head_w`` (this
    rank's vocabulary rows under a tensor axis): f32 logits
    (:func:`tied_head`), whole unless ``vocab_local`` asks for this rank's
    columns."""
    layout = model.layout
    if tensor_size(layout) == 1:
        return tied_head(x, head_w)
    local = tied_head(copy_to_tensor(x, layout), head_w)
    if vocab_local:
        return local
    return tp_lib.gather_from_tensor(local, layout, full=model.vocab_size)


def gathers_sequence(model) -> bool:
    """Whether ``model`` runs a non-context-parallel attention over the
    sequence gathered from its seq group (a layout with a seq axis > 1)."""
    layout = model.layout
    return (model.attn_impl not in CP_IMPLS and layout is not None
            and layout.seq > 1)


def refuse_cp_decode(model) -> None:
    if model.attn_impl in CP_IMPLS:
        raise ValueError(f"attn_impl={model.attn_impl!r} has no decode path; "
                         "generate with the xla/flash model")
    if gathers_sequence(model):
        raise ValueError("a model laid out over a seq axis has no decode "
                         "path; generate with a model without one")


def seq_offset(model, s: int) -> int:
    """The global position of a seq-sharded model's first local position
    (0 otherwise)."""
    if model.attn_impl in CP_IMPLS or gathers_sequence(model):
        return model.layout.seq_idx * s
    return 0


def site_key(key: int | None, *path: int) -> int | None:
    """The key of one dropout site below ``key`` (None stays None)."""
    return None if key is None else fold_in(key, *path)


def train_key(model: nn.Module, key: int | None) -> int | None:
    """The key ``model``'s forward draws its masks (and its routers'
    jitter) from: ``key`` in train mode with ``dropout > 0`` or
    ``router_jitter > 0``, else None (eval mode drops nothing). In train
    mode a dropout model without a key raises, as the reference's needs a
    'dropout' rng (a jitter model raises in its MoE layers)."""
    jitter = getattr(model, "router_jitter", 0.0)
    if not (model.training and (model.dropout or jitter)):
        return None
    if key is None and model.dropout:
        raise ValueError(
            f"dropout={model.dropout} in train mode needs a dropout_key "
            "(make_train_step passes one); call eval() to score")
    return key


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=1e-5)``: f32 statistics with the fast
    variance, ``(x - mu) * (rsqrt(var + eps) * scale) + bias`` in f32,
    cast to the compute dtype."""

    def __init__(self, dim: int, *, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x, dtype):
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mu * mu, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mu) * mul + self.bias).to(dtype)

    def fused(self, x, dtype, residual=None):
        """The reference's ``FusedLayerNorm`` over these parameters: the
        kernel's direct variance, ``n`` in ``dtype``; with ``residual``,
        the pre-norm composition returning ``(n, x + residual)``."""
        return fused_layernorm(x, self.scale, self.bias, residual=residual,
                               eps=self.eps, out_dtype=dtype)


class Dense(nn.Module):
    """A linear layer with a float32 master ``weight [out, in]`` and
    ``bias``, cast to the input's dtype at each use (flax's
    ``Dense(dtype=...)``). ``bias_shape`` keeps the reference's bias shape
    (``qkv``'s ``[3, heads, dh]``), which the weight-decay mask reads:
    only 1-D leaves escape decay."""

    def __init__(self, n_in: int, n_out: int, *, bias_shape=None,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in, device=device))
        self.bias = nn.Parameter(torch.zeros(bias_shape or (n_out,),
                                             device=device))

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype),
                        self.bias.reshape(-1).to(x.dtype))


class Block(nn.Module):
    """A GPT-2 block; ``num_experts > 0`` swaps its MLP for an
    :class:`~tpudist_torch.parallel.ep.MoEMlp` named ``moe`` (``moe``:
    that layer's other keywords)."""

    def __init__(self, hidden_dim: int, num_heads: int, *, dtype, attn_impl,
                 device, dropout: float = 0.0, layout=None,
                 num_experts: int = 0, moe: dict | None = None):
        super().__init__()
        d = hidden_dim
        self.num_heads = num_heads
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.layout = layout
        self.dropout = dropout
        t = tensor_size(layout)
        col = lambda i, o, **kw: ColumnParallel(i, o, device=device,
                                                layout=layout, **kw)
        row = lambda i, o: RowParallel(i, o, device=device, layout=layout)
        self.ln_1 = LayerNorm(d, device=device)
        # out features ordered (3, heads, dh): a rank holds its heads of
        # each of q, k and v
        self.qkv = col(d, 3 * d, bias_shape=(3, num_heads // t,
                                             d // num_heads))
        self.out = row(d, d)           # in features ordered (heads, dh)
        self.ln_2 = LayerNorm(d, device=device)
        if num_experts:
            self.moe = MoEMlp(d, num_experts, dtype=dtype, layout=layout,
                              device=device, **(moe or {}))
        else:
            self.mlp_fc = col(d, 4 * d)
            self.mlp_proj = row(4 * d, d)

    def forward(self, x, cache=None, positions=None, block_tables=None,
                fused_ln: bool = False, dropout_key: int | None = None):
        """``dropout_key``: this block's key (None: no dropout); the
        attention branch draws from site 0, the MLP branch from site 1, an
        MoE router's jitter from site 2."""
        b, s, d = x.shape
        # this rank's heads (all of them without a tensor axis)
        h = self.num_heads // tensor_size(self.layout)
        dh = d // self.num_heads
        fused = fused_ln and cache is None
        y = self.ln_1.fused(x, self.dtype) if fused else self.ln_1(x, self.dtype)
        qkv = self.qkv(y).view(b, s, 3, h, dh)
        q, k, v = qkv.unbind(2)
        if cache is not None:
            keys, values, mask, pos = cached_kv(
                cache, k, v, positions=positions, block_tables=block_tables,
            )
            kernel = self.attn_impl != "xla"
            if block_tables is not None:
                # paged decode: keys/values are the shared block pool and
                # `mask` carries the per-row block tables
                attn = paged_decode_attention(
                    q.contiguous(), keys, values, mask, pos,
                    impl="paged" if kernel else "xla",
                )
            else:
                attn = decode_attention(
                    q.contiguous(), keys, values, mask, pos,
                    impl="fused" if kernel else "xla",
                )
        elif self.attn_impl in CP_IMPLS:
            attn = context_parallel_attention(
                q, k, v, self.attn_impl, self.layout.seq_group, causal=True,
                layout=self.layout)
        elif gathers_sequence(self):
            attn = gathered_attention_local(
                q, k, v, group=self.layout.seq_group, causal=True,
                attn_fn=functools.partial(multi_head_attention,
                                          impl=self.attn_impl))
        else:
            attn = multi_head_attention(q, k, v, causal=True,
                                        impl=self.attn_impl)
        y = dropout(self.out(attn.reshape(b, s, h * dh)), self.dropout,
                    site_key(dropout_key, 0))
        if fused:
            # one kernel sweep: the residual add and the norm, both the
            # normed value and the updated residual stream come back
            y, x = self.ln_2.fused(y, self.dtype, residual=x)
        else:
            x = x + y
            y = self.ln_2(x, self.dtype)
        if hasattr(self, "moe"):
            y = self.moe(y, train=self.training and cache is None,
                         jitter_key=site_key(dropout_key, 2))
        else:
            y = self.mlp_proj(F.gelu(self.mlp_fc(y), approximate="tanh"))
        return x + dropout(y, self.dropout, site_key(dropout_key, 1))


class GPT2(nn.Module):
    """GPT-2 with the reference's defaults (124M: vocab 50257, S 1024,
    d 768, 12 layers, 12 heads). ``device`` defaults to ``"cuda"`` and
    raises without a card unless ``"cpu"`` is given; ``seed`` draws the
    random init from a ``torch.Generator`` on that device (flax's
    distributions: lecun-normal kernels, N(0, 0.02) ``wte``, N(0, 0.01)
    ``wpe``, zero biases, unit LayerNorm scales). ``dropout``,
    ``scan_layers``, ``remat_layers`` and ``remat_policy`` are the
    reference's fields, and ``layout`` is the context-parallel impls',
    the tensor axis's and the expert axis's (module docstring), as are
    the MoE fields ``num_experts`` (0: dense), ``moe_every``,
    ``moe_top_k``, ``capacity_factor``, ``moe_dispatch``,
    ``router_z_loss`` and ``router_jitter``."""

    tensor_specs = tp_lib.GPT2_SPECS
    #: the train step's default loss under a tensor axis: the next-token
    #: CE on the vocabulary-local logits (``train.tp_lm_loss``)
    causal_lm = True

    def __init__(self, vocab_size: int = 50257, max_seq_len: int = 1024,
                 hidden_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 dtype=torch.float32, attn_impl: str = "xla", *,
                 dropout: float = 0.0, scan_layers: bool = False,
                 remat_layers: bool = False, remat_policy=None,
                 fused_ln: bool = False, layout=None, device=None,
                 seed: int = 0, num_experts: int = 0, moe_every: int = 2,
                 moe_top_k: int = 2, capacity_factor: float = 1.25,
                 moe_dispatch: str = "einsum", router_z_loss: float = 0.0,
                 router_jitter: float = 0.0):
        super().__init__()
        check_attn_impl(attn_impl, layout)
        if hidden_dim % num_heads:
            raise ValueError("hidden_dim must divide into num_heads")
        if num_experts and scan_layers:
            raise ValueError(
                "scan_layers supports dense training only (no num_experts: "
                "the MoE blocks need the unrolled layout)")
        if remat_layers and not scan_layers:
            raise ValueError("remat_layers requires scan_layers=True "
                             "(set remat_policy to checkpoint the unrolled "
                             "blocks, or make_train_step(remat=...) for a "
                             "whole-forward checkpoint)")
        self.block_policy = remat_policy or ("full" if remat_layers else None)
        remat_lib.resolve(self.block_policy)  # an unknown name raises here
        self.device = resolve_device(device)
        self.vocab_size = vocab_size
        self.max_seq_len = max_seq_len
        self.hidden_dim = hidden_dim
        self.depth = depth
        self.num_heads = num_heads
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.layout = layout
        self.dropout = float(dropout)
        self.scan_layers = bool(scan_layers)
        self.fused_ln = bool(fused_ln)
        self.num_experts, self.moe_every = int(num_experts), int(moe_every)
        self.router_jitter = float(router_jitter)
        moe = dict(top_k=moe_top_k, capacity_factor=capacity_factor,
                   dispatch_impl=moe_dispatch, router_z_loss=router_z_loss,
                   router_jitter=router_jitter)
        t = check_tensor(self)
        dev = self.device
        v0, v1 = tp_lib.vocab_range(vocab_size, t, layout.tensor_idx
                                    if t > 1 else 0)
        self.wte = nn.Parameter(torch.empty(v1 - v0, hidden_dim, device=dev))
        self.wpe = nn.Parameter(torch.empty(max_seq_len, hidden_dim, device=dev))
        self.h = nn.ModuleList(
            Block(hidden_dim, num_heads, dtype=dtype, attn_impl=attn_impl,
                  device=dev, dropout=self.dropout, layout=layout,
                  num_experts=self.num_experts if self.moe_here(i) else 0,
                  moe=moe)
            for i in range(depth)
        )
        self.ln_f = LayerNorm(hidden_dim, device=dev)
        self.init_weights(seed)
        self.eval()

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads

    def moe_here(self, i: int) -> bool:
        """Whether block ``i`` is an MoE block (the reference's rule)."""
        return self.num_experts > 0 and i % self.moe_every == self.moe_every - 1

    @property
    def has_aux_loss(self) -> bool:
        """The model adds aux losses (its MoE layers') to the task loss."""
        return self.num_experts > 0

    @property
    def num_kv_heads(self) -> int:
        """GPT-2 has no grouped K/V: its heads."""
        return self.num_heads

    @property
    def cache_heads(self) -> int:
        """The decode cache's heads on this rank (its share under a tensor
        axis)."""
        return self.num_kv_heads // tensor_size(self.layout)

    @property
    def geometry(self) -> dict:
        """What a checkpoint of this model is bound to (the run meta)."""
        geo = {"arch": "gpt2", "vocab_size": self.vocab_size,
               "hidden_dim": self.hidden_dim, "depth": self.depth,
               "num_heads": self.num_heads}
        if self.num_experts:
            geo.update(num_experts=self.num_experts,
                       moe_every=self.moe_every)
        return geo

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        g = generator(int(seed), self.device)
        dev, layout, vocab = self.device, self.layout, self.vocab_size

        def lecun(name, p, fan_in):
            def draw(shape):
                t = torch.empty(shape, device=dev)
                nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=g)
                return t * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)
            if name is None:
                draw(tuple(p.shape))
                return
            tp_lib.init_sharded(p, name, draw, layout, vocab,
                                table=self.tensor_specs)

        def normal(name, p, std):
            tp_lib.init_sharded(
                p, name, lambda shape: torch.randn(
                    shape, device=dev, generator=g) * std, layout, vocab,
                table=self.tensor_specs)

        d = self.hidden_dim
        normal("wte", self.wte, 0.02)
        normal("wpe", self.wpe, 0.01)
        for i in range(self.depth):
            blk = self._held_block(i)
            mlp = ((("mlp_fc", (4 * d, d), d), ("mlp_proj", (d, 4 * d), 4 * d))
                   if blk is None or not hasattr(blk, "moe") else ())
            for name, shape, fan_in in (("qkv", (3 * d, d), d),
                                        ("out", (d, d), d), *mlp):
                if blk is None:
                    # a block another stage holds: drawn all the same, so
                    # the generator reaches the next leaf where it would
                    lecun(None, torch.empty(shape, device=dev), fan_in)
                    continue
                lin = getattr(blk, name)
                lecun(f"h.{i}.{name}.weight", lin.weight, fan_in)
                lin.bias.zero_()
            if blk is None:
                continue
            if hasattr(blk, "moe"):
                blk.moe.init_weights(g)
            for ln in (blk.ln_1, blk.ln_2):
                ln.scale.fill_(1.0)
                ln.bias.zero_()
        self.ln_f.scale.fill_(1.0)
        self.ln_f.bias.zero_()

    def _held_block(self, i: int):
        """Block ``i`` (None where this rank does not hold it)."""
        return self.h[i]

    def init_cache(self, batch_size: int) -> dict:
        """Zeroed decode cache for ``batch_size`` rows — the serving
        engine's slot-pool allocation hook."""
        from tpudist_torch.generate import zero_cache

        return zero_cache(self, batch_size)

    def compute_copy(self) -> "GPT2":
        """The serving engine's copy (:func:`compute_copy`)."""
        return compute_copy(self)

    def forward(self, tokens, *, cache=None, positions=None,
                block_tables=None, return_hidden: bool = False,
                dropout_key: int | None = None, vocab_local: bool = False):
        """``tokens [B, s]`` -> f32 logits ``[B, s, V]`` (or the final
        hidden state with ``return_hidden``). With ``cache`` the decode
        path runs: scalar cursor, per-row ``positions`` or paged
        ``block_tables``, and the cache is updated in place — without
        autograd, as the reference's KV-cache step has no backward. The
        ``fused_ln`` attribute takes the fused LN kernel on the non-decode
        path. In train mode a model with ``dropout > 0`` needs
        ``dropout_key`` (the training step's; the embedding draws from
        site 0, block ``i`` from site ``i + 1``), as the reference needs a
        'dropout' rng; in eval mode nothing is dropped. A context-parallel
        model takes this rank's chunk of the sequence. Under a tensor axis
        ``vocab_local`` returns this rank's vocabulary columns of the
        logits (the training loss's input) instead of the whole row."""
        if cache is not None:
            refuse_cp_decode(self)
            if self.scan_layers:
                raise ValueError(
                    "scan_layers has no decode path (the KV cache needs "
                    "per-layer variables); generate with scan_layers=False")
            with torch.no_grad():
                return self._forward(tokens, cache, positions, block_tables,
                                     return_hidden, False, None, False)
        return self._forward(tokens, None, None, None, return_hidden,
                             self.fused_ln, train_key(self, dropout_key),
                             vocab_local)

    def _forward(self, tokens, cache, positions, block_tables, return_hidden,
                 fused, dropout_key, vocab_local):
        b, s = tokens.shape
        if tokens.dtype != torch.int64:
            tokens = tokens.long()
        if cache is not None and positions is not None:
            # per-ENTRY overrun: row b's entry i sits at pos_b + i. Entries
            # past max_seq_len NaN-poison individually (a speculative verify
            # tail); a fully-overrun row fails loudly when the check costs
            # no device sync (positions on the host)
            row_pos = positions.long()[:, None] + torch.arange(
                s, device=positions.device)[None, :]
            overrun = row_pos + 1 > self.max_seq_len
            if positions.device.type == "cpu" and bool(overrun[:, 0].any()):
                raise ValueError(
                    f"per-slot decode past max_seq_len {self.max_seq_len} "
                    f"(positions {positions.tolist()}); the KV cache and wpe "
                    "table end there"
                )
            pos = self.wpe[row_pos.clamp(max=self.max_seq_len - 1)]
            pos = torch.where(overrun[:, :, None], float("nan"), pos)
        elif cache is not None:
            cursor = int(cache["position"])
            if cursor + s > self.max_seq_len:
                raise ValueError(
                    f"incremental decode past max_seq_len {self.max_seq_len} "
                    f"(cursor {cursor} + chunk {s}); the KV cache and wpe "
                    "table end there"
                )
            pos = self.wpe[cursor:cursor + s][None]
            cache["position"] = cursor + s
        else:
            off = seq_offset(self, s)
            pos = self.wpe[off:off + s][None]
        x = (tp_lib.vocab_parallel_embedding(tokens, self.wte, self.layout,
                                             self.vocab_size).to(self.dtype)
             + pos.to(self.dtype))
        x = dropout(x, self.dropout, site_key(dropout_key, 0))
        layers = cache["layers"] if cache is not None else [None] * self.depth
        policy = self.block_policy if cache is None else None
        for i, (blk, layer) in enumerate(zip(self.h, layers)):
            run = remat_lib.checkpoint(blk, policy)
            x = run(x, layer, positions=positions, block_tables=block_tables,
                    fused_ln=fused, dropout_key=site_key(dropout_key, i + 1))
        x = self.ln_f.fused(x, self.dtype) if fused else self.ln_f(x, self.dtype)
        if return_hidden:
            return x
        return lm_logits(self, x, self.wte.to(self.dtype), vocab_local)


def tied_head_grads(g, x2, wte, mm):
    """The f32 sums ``(g @ wte, g^T @ x2)`` of the tied head's backward for
    the f32 logits cotangent ``g [N, V]`` and half-precision ``x2 [N, D]``,
    ``wte [V, D]``: the reference's f32 products of the f32 ``g`` (its
    ``jax.grad`` of ``einsum(..., preferred_element_type=f32)``), which the
    caller rounds once to the operands' dtype. ``mm(a, b)`` multiplies two
    half-precision operands into f32 sums, so ``g`` is carried as ``hi =
    half(g)`` and ``lo = half(g - hi)`` (about 2^-17 relative), each
    multiplied, the two sums added in f32: one half-precision ``g`` would
    round the cotangent itself (2^-9)."""
    hi = g.to(x2.dtype)
    lo = (g - hi).to(x2.dtype)
    return (mm(hi, wte) + mm(lo, wte), mm(hi.t(), x2) + mm(lo.t(), x2))


def _mm_f32(a, b):
    return torch.mm(a, b, out_dtype=torch.float32)


class _TiedHeadF32(torch.autograd.Function):
    """``x @ wte^T`` of two half-precision operands with float32 output
    (cuBLAS accumulates in f32); the backward multiplies the f32
    cotangent at f32 precision on the tensor cores
    (:func:`tied_head_grads`) and rounds each gradient once."""

    @staticmethod
    def forward(ctx, x2, wte):
        ctx.save_for_backward(x2, wte)
        return _mm_f32(x2, wte.t())

    @staticmethod
    def backward(ctx, g):
        x2, wte = ctx.saved_tensors
        dx, dwte = tied_head_grads(g, x2, wte, _mm_f32)
        return dx.to(x2.dtype), dwte.to(wte.dtype)


def tied_head(x, wte):
    """The weight-tied LM head with f32 logits (the reference's
    ``preferred_element_type=f32``): a bf16 product would round the logits
    to bf16 and change greedy choices. ``wte`` is in x's dtype."""
    if x.dtype == torch.float32:
        return x @ wte.t()
    if x.is_cuda:
        flat = _TiedHeadF32.apply(x.reshape(-1, x.shape[-1]), wte)
        return flat.reshape(*x.shape[:-1], wte.shape[0])
    return x.float() @ wte.float().t()


def compute_copy(model: GPT2) -> GPT2:
    """``model`` with its matmul weights, biases and embeddings held in
    its compute dtype, the values every forward casts them to, so an
    inference step pays no per-use cast (the serving engine's copy: on
    the H100 a GPT-2 124M bf16 decode step took 9.1-10.8 ms on it and
    11.9-15.7 ms on the masters, ``lm_kernels_bench --decode_ab``);
    LayerNorm parameters stay float32. The copy is a snapshot: later
    updates of ``model``'s weights do not reach it. Returns ``model``
    itself when it computes in float32 or already holds its weights in
    its dtype."""
    if model.dtype == torch.float32 or model.wte.dtype == model.dtype:
        return model
    held = copy.deepcopy(model)
    with torch.no_grad():
        for p in (held.wte, held.wpe):
            p.data = p.data.to(held.dtype)
        for m in held.modules():
            if isinstance(m, (Dense, ColumnParallel, RowParallel)):
                m.weight.data = m.weight.data.to(held.dtype)
                m.bias.data = m.bias.data.to(held.dtype)
            elif isinstance(m, MoEMlp):
                # the experts in the compute dtype; the router stays
                # float32, the input of its float32 product
                for name in m.expert_leaves:
                    w = getattr(m, name)
                    w.data = w.data.to(held.dtype)
    return held


def gpt2_124m(**kw) -> GPT2:
    return GPT2(**kw)


class PipelinedGPT2(GPT2):
    """GPT-2 with its blocks run through the pipeline over ``layout``'s
    pipe axis (:func:`tpudist_torch.parallel.pp.pipeline_apply`): the
    counterpart of :class:`tpudist.models.gpt2.PipelinedGPT2`. A rank
    holds its stage's blocks under their global names (``h.{i}``, so a
    checkpoint and a converted tree name the same leaf) and the
    replicated ``wte``, ``wpe`` and ``ln_f``; the embedding, the final
    LayerNorm and the tied head run on every pipe rank, the head on the
    last stage's outputs, which every stage receives. Under a tensor axis
    too the stage's blocks are PR 20's column / row layers
    (``tensor_specs``, GPT-2's).

    The init draws every leaf whole from ``seed`` in the unrolled model's
    order and keeps this rank's (the reference initializes its unrolled
    twin and re-stacks it), so the same seed gives :class:`GPT2`'s
    function. ``num_micro`` splits a rank's batch; ``schedule`` is
    ``"gpipe"`` or ``"1f1b"`` (the same function; 1F1B keeps only each
    microbatch's stage input for the backward). Attention is the dense
    path (``attn_impl="xla"``, the reference's refusal otherwise); there
    is no ``fused_ln`` knob, no dropout and no decode path."""

    def __init__(self, layout=None, *, num_micro: int,
                 vocab_size: int = 50257, max_seq_len: int = 1024,
                 hidden_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 dtype=torch.float32, attn_impl: str = "xla",
                 schedule: str = "gpipe", device=None, seed: int = 0,
                 num_experts: int = 0):
        nn.Module.__init__(self)
        if num_experts:
            raise ValueError(
                "--pipe composes with --tensor and data parallelism and "
                "runs XLA attention; MoE/context-parallel/kernel "
                "attention are not pipelined")
        self.num_experts = 0
        pipe = pp_lib.pipe_size(layout)
        if depth % pipe:
            raise ValueError(f"depth {depth} not divisible by pipe={pipe}")
        if attn_impl != "xla":
            raise ValueError(
                f"attn_impl={attn_impl!r} does not compose with the GPipe "
                "schedule yet; the pipelined model runs XLA attention "
                "(attn_impl='xla')")
        pp_lib.check_schedule(schedule)
        if hidden_dim % num_heads:
            raise ValueError("hidden_dim must divide into num_heads")
        self.device = resolve_device(device)
        self.vocab_size = vocab_size
        self.max_seq_len = max_seq_len
        self.hidden_dim = hidden_dim
        self.depth = depth
        self.num_heads = num_heads
        self.dtype = dtype
        self.attn_impl = attn_impl
        self.layout = layout
        self.num_micro = int(num_micro)
        self.schedule = schedule
        t = check_tensor(self)
        dev = self.device
        v0, v1 = tp_lib.vocab_range(vocab_size, t, layout.tensor_idx
                                    if t > 1 else 0)
        self.wte = nn.Parameter(torch.empty(v1 - v0, hidden_dim, device=dev))
        self.wpe = nn.Parameter(torch.empty(max_seq_len, hidden_dim,
                                            device=dev))
        self.layers = pp_lib.stage_layers(
            depth, pipe, layout.pipe_idx if pipe > 1 else 0)
        self.h = nn.ModuleDict({
            str(i): Block(hidden_dim, num_heads, dtype=dtype,
                          attn_impl=attn_impl, device=dev, layout=layout)
            for i in self.layers})
        self.ln_f = LayerNorm(hidden_dim, device=dev)
        self.init_weights(seed)
        self.eval()

    def _held_block(self, i: int):
        return self.h[str(i)] if i in self.layers else None

    def init_cache(self, batch_size: int) -> dict:
        raise ValueError("PipelinedGPT2 has no decode path (the reference "
                         "refuses --generate under --pipe); generate with "
                         "GPT2")

    def _stage(self, x):
        for blk in self.h.values():
            x = blk(x)
        return x

    def forward(self, tokens, *, cache=None, positions=None,
                block_tables=None, return_hidden: bool = False,
                dropout_key: int | None = None, vocab_local: bool = False):
        """``tokens [B, s]`` (this rank's rows) -> f32 logits ``[B, s,
        V]`` (this rank's vocabulary columns with ``vocab_local`` under a
        tensor axis), or the final hidden state with ``return_hidden``;
        the blocks run through the pipeline in ``num_micro``
        microbatches."""
        if cache is not None:
            self.init_cache(0)
        b, s = tokens.shape
        if tokens.dtype != torch.int64:
            tokens = tokens.long()
        x = (tp_lib.vocab_parallel_embedding(tokens, self.wte, self.layout,
                                             self.vocab_size).to(self.dtype)
             + self.wpe[:s][None].to(self.dtype))
        params = [p for blk in self.h.values() for p in blk.parameters()]
        x = pp_lib.pipeline_apply(self._stage, x, self.layout,
                                  num_micro=self.num_micro,
                                  schedule=self.schedule, params=params)
        x = self.ln_f(x, self.dtype)
        if return_hidden:
            return x
        return lm_logits(self, x, self.wte.to(self.dtype), vocab_local)
