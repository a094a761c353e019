"""Expert parallelism: Mixture-of-Experts with GShard-style routing, two
dispatch formulations and the ``expert`` axis of a rank layout.

Counterpart of :mod:`tpudist.parallel.ep`, with its rules:

- **Static shapes.** Each expert has ``capacity`` slots
  (:func:`expert_capacity`); a choice past it is dropped (its
  contribution is zero, the residual carries the token on). Routing is
  one function (:func:`top_k_routing`): argmax choices, slot positions
  by an int32 cumsum in token order, every k-th choice placed after all
  (k-1)-th ones (GShard's priority), top-1 keeping the raw gate and
  top-k >= 2 renormalizing with ``+ 1e-9``. What differs is how tokens
  reach their slots:

  - ``dispatch_impl="einsum"``: the dense one-hot ``[.., t, E, C]``
    dispatch and combine tensors (:func:`_one_hot_dispatch`),
    contracted with ``torch.einsum``: the oracle;
  - ``dispatch_impl="index"``: each kept (token, choice) gets its flat
    slot ``e * C + pos`` (:func:`_flat_dest`, a dropped one the garbage
    slot ``E * C``); a scatter of token ids builds the slot -> token map
    and one ``index_select`` fills the slots (:func:`_index_dispatch`,
    an empty slot reading a zero row); the combine gathers each choice's
    output and adds them in choice order (:func:`_index_combine`). The
    gather's backward is ``index_add_``, a scatter-add with atomics on
    the card: at most ``top_k`` commutative adds into a zero a token,
    so exact and deterministic for top-1 and top-2 (no bit-identity is
    claimed for top-k >= 3).

- **The router** is a float32 ``[d, E]`` parameter applied to the input
  upcast to float32 (under the fused optimizer's compute copy it is the
  bf16 copy upcast, as the reference's einsum promotes it); the Switch
  aux loss ``E * sum(f * P)`` is scaled by ``aux_loss_weight`` and
  averaged over groups; ``router_z_loss`` adds ``w * mean(lse^2)``;
  ``router_jitter`` multiplies the router's input by uniform noise in
  ``[1 - j, 1 + j]``, in training only, drawn from the key the caller
  passes (the train step's dropout stream). :attr:`MoEMlp.losses` holds
  the last forward's scaled losses (the train step adds them to the task
  loss) and :meth:`MoEMlp.stats` the router's load, dropped share and
  unscaled aux.

- **The expert axis.** On a layout with ``expert > 1`` a rank holds
  ``E / expert`` experts (dim 0 of every expert leaf); with a tensor
  axis too each expert's FFN is split Megatron-style (``w1``, ``w_gate``,
  ``w_up`` on their ffn columns, ``w2``, ``w_down`` on their ffn rows,
  the partial products summed over the tensor group in float32, as
  :mod:`tpudist_torch.parallel.tp`'s row layers do). Tokens are
  replicated over the expert group (the batch splits over ``data x
  fsdp`` alone), so a rank fills its own experts' slots from its local
  tokens, runs its FFNs, and one ``all_gather`` of the slot outputs over
  the expert group gives every rank every expert's outputs to combine
  locally (the reference's ``_sharded_index_forward``). The einsum
  dispatch over an expert axis moves its slots the same way: its
  dispatch one-hot's slice of this rank's experts fills the slots, the
  combine contracts the gathered outputs with the whole one-hot. Every
  rank of the group computes the same cotangent for the gathered outputs,
  so the gather's backward keeps this rank's slice (no sum: a
  reduce-scatter would count it ``expert`` times), and the tokens'
  gradient through a rank's own slots is a partial sum, all-reduced over
  the expert group (:func:`copy_to_expert`). In the port each rank holds
  its own rows, so the sharded formulation serves any batch; it computes
  the local formulation's function.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tpudist_torch.parallel import tp as tp_lib
from tpudist_torch.parallel.tp import copy_to_tensor, tensor_size
from tpudist_torch.rng import generator

__all__ = [
    "expert_capacity", "top_k_routing", "top_k_dispatch", "MoEMlp",
    "expert_size", "copy_to_expert", "gather_experts", "EXPERT_LEAVES",
    "is_expert_leaf", "expert_names", "shard_experts", "gather_expert_sd",
    "moe_losses",
]

#: the stacked expert leaves of an ``MoEMlp`` (dim 0: the experts)
EXPERT_LEAVES = ("w1", "w2", "w_gate", "w_up", "w_down")
# flax's lecun_normal: truncated normal on [-2, 2] rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


def expert_capacity(num_tokens: int, num_experts: int, *, top_k: int,
                    capacity_factor: float) -> int:
    """Per-expert slot count: ``ceil(top_k * T / E) * capacity_factor``,
    rounded up (the reference's)."""
    base = (top_k * num_tokens + num_experts - 1) // num_experts
    return max(1, math.ceil(base * capacity_factor))


def top_k_routing(probs: torch.Tensor, top_k: int, capacity: int):
    """Router probabilities ``[..., T, E]`` -> ``(idx, gates, pos, keep,
    aux)``: ``idx [..., T, k]`` int32 choices, ``gates`` the
    (renormalized) gate weights, ``pos`` int32 slot positions within the
    chosen expert, ``keep`` bool capacity survival, and the Switch aux
    loss ``[...]`` (1.0 at perfect balance) of each leading index. The
    reference's one routing function (module docstring), batched over the
    leading dims."""
    E = probs.shape[-1]
    gates, idxs, masks = [], [], []
    p = probs
    for _ in range(top_k):
        idx = torch.argmax(p, dim=-1)
        m = F.one_hot(idx, E).to(probs.dtype)
        gates.append(torch.sum(p * m, dim=-1))
        idxs.append(idx.to(torch.int32))
        masks.append(m)
        p = p * (1.0 - m)
    # aux from the primary choices: E * sum_e (token fraction)(mean prob)
    f = torch.mean(masks[0], dim=-2)
    pr = torch.mean(probs, dim=-2)
    aux = E * torch.sum(f * pr, dim=-1)
    if top_k > 1:
        denom = sum(gates) + 1e-9
        gates = [g / denom for g in gates]
    poss, keeps = [], []
    # slots consumed by earlier choices
    counts = torch.zeros((*probs.shape[:-2], 1, E), dtype=torch.int32,
                         device=probs.device)
    for m in masks:
        mi = m.to(torch.int32)
        pos = torch.cumsum(mi, dim=-2, dtype=torch.int32) - mi + counts
        pos_t = torch.sum(pos * mi, dim=-1, dtype=torch.int32)
        keep = (pos_t < capacity) & (torch.sum(mi, dim=-1) > 0)
        poss.append(pos_t)
        keeps.append(keep)
        counts = counts + torch.sum(mi, dim=-2, keepdim=True,
                                    dtype=torch.int32)
    return (torch.stack(idxs, -1), torch.stack(gates, -1),
            torch.stack(poss, -1), torch.stack(keeps, -1), aux)


def _one_hot_dispatch(idx, gates, pos, keep, num_experts: int,
                      capacity: int, dtype):
    """Routing decisions -> dense one-hot ``(dispatch, combine)``
    ``[..., E, C]``, sequential adds in choice order (the reference's op
    order). A dropped choice's position may pass the capacity; its slot
    one-hot is then zero, as ``jax.nn.one_hot`` gives out of range."""
    shape = (*idx.shape[:-1], num_experts, capacity)
    dispatch = torch.zeros(shape, dtype=dtype, device=idx.device)
    combine = torch.zeros(shape, dtype=dtype, device=idx.device)
    slots = torch.arange(capacity, device=idx.device)
    for j in range(idx.shape[-1]):
        m = F.one_hot(idx[..., j].long(), num_experts).to(dtype)
        slot = (pos[..., j, None] == slots).to(dtype)
        d = (m[..., :, None] * slot[..., None, :]
             * keep[..., j, None, None].to(dtype))
        dispatch = dispatch + d
        combine = combine + d * gates[..., j, None, None]
    return dispatch, combine


def top_k_dispatch(probs: torch.Tensor, top_k: int, capacity: int):
    """Router probabilities -> ``(dispatch, combine, aux)``, the einsum
    oracle's dense form built from :func:`top_k_routing`."""
    idx, gates, pos, keep, aux = top_k_routing(probs, top_k, capacity)
    dispatch, combine = _one_hot_dispatch(idx, gates, pos, keep,
                                          probs.shape[-1], capacity,
                                          probs.dtype)
    return dispatch, combine, aux


def _flat_dest(idx, pos, keep, capacity: int, num_experts: int):
    """Each (token, choice)'s flat slot ``e * C + pos``; a dropped choice
    points at the one-past-the-end garbage slot ``E * C``."""
    return torch.where(keep, idx * capacity + pos,
                       torch.full_like(idx, num_experts * capacity))


def _row_offsets(lead: tuple, width: int, device) -> torch.Tensor:
    """The first row of each leading index in a ``[*lead, width, d]``
    tensor flattened to rows, shaped ``[*lead, 1]``."""
    n = math.prod(lead)
    return (torch.arange(n, device=device) * width).reshape(*lead, 1)


def _index_dispatch(tokens, dest, num_experts: int, capacity: int):
    """Tokens ``[..., t, d]`` -> slots ``[..., E, C, d]`` by slot index.
    ``dest [..., t, k]``: flat slot ids (:func:`_flat_dest`). A scatter of
    token ids builds the slot -> token map (kept destinations are unique,
    dropped ones collide harmlessly on the garbage slot), then one gather
    fills the slots; an empty slot reads the appended zero row."""
    *lead, t, d = tokens.shape
    lead = tuple(lead)
    k = dest.shape[-1]
    n_slots = num_experts * capacity
    token_ids = torch.arange(t, device=tokens.device).repeat_interleave(k)
    slot_token = torch.full((*lead, n_slots + 1), t, dtype=torch.long,
                            device=tokens.device)
    slot_token.scatter_(-1, dest.reshape(*lead, t * k).long(),
                        token_ids.expand(*lead, t * k))
    pad = torch.cat([tokens, tokens.new_zeros((*lead, 1, d))], dim=-2)
    rows = slot_token[..., :n_slots] + _row_offsets(lead, t + 1,
                                                    tokens.device)
    slots = pad.reshape(-1, d).index_select(0, rows.reshape(-1))
    return slots.reshape(*lead, num_experts, capacity, d)


def _index_combine(out, dest, gates, keep, dtype):
    """Expert outputs ``[..., E, C, d]`` -> the per-token mix ``[..., t,
    d]``: ``y = sum_j dtype(gate_j keep_j) out[dest_j]``, added in choice
    order; a dropped choice gathers the appended zero row."""
    *lead, E, C, d = out.shape
    lead = tuple(lead)
    pad = torch.cat([out.reshape(*lead, E * C, d),
                     out.new_zeros((*lead, 1, d))], dim=-2).reshape(-1, d)
    w = (gates * keep.to(gates.dtype)).to(dtype)
    off = _row_offsets(lead, E * C + 1, out.device)
    t = dest.shape[-2]
    y = torch.zeros((*lead, t, d), dtype=dtype, device=out.device)
    for j in range(dest.shape[-1]):
        rows = pad.index_select(0, (dest[..., j].long() + off).reshape(-1))
        y = y + w[..., j, None] * rows.reshape(*lead, t, d)
    return y


# -- the expert group ----------------------------------------------------------


def expert_size(layout) -> int:
    """The expert world of ``layout`` (1 without one)."""
    return getattr(layout, "expert", 1) if layout is not None else 1


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous (NCCL refuses other strides; gloo copies them) in
    tensor parallelism's wire format: half precision as float32, exact
    (gloo has no bf16 sum on every build), anything else a private copy."""
    return tp_lib._wire(x.contiguous())


class _CopyToExpert(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout):
        ctx.layout = layout
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        buf = _wire(g)
        dist.all_reduce(buf, group=ctx.layout.expert_group)
        return buf.to(g.dtype), None


def copy_to_expert(x, layout):
    """Identity forward, the gradient summed over the expert group
    backward: the replicated tokens a rank dispatches to its own experts
    (its gradient through them is a partial sum)."""
    if expert_size(layout) == 1:
        return x
    return _CopyToExpert.apply(x, layout)


class _GatherExperts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, layout):
        ctx.lo = layout.expert_idx * out.shape[1]
        ctx.n = out.shape[1]
        wire = _wire(out)
        parts = [torch.empty_like(wire) for _ in range(layout.expert)]
        dist.all_gather(parts, wire, group=layout.expert_group)
        return torch.cat(parts, dim=1).to(out.dtype)

    @staticmethod
    def backward(ctx, g):
        return g[:, ctx.lo:ctx.lo + ctx.n].contiguous(), None


def gather_experts(out, layout):
    """The expert ranks' slot outputs ``[G, E / expert, C, d]`` gathered
    along dim 1 in rank order; backward: this rank's slice of the
    cotangent, which every rank of the group computes alike."""
    if expert_size(layout) == 1:
        return out
    return _GatherExperts.apply(out, layout)


# -- the layer -----------------------------------------------------------------


class MoEMlp(nn.Module):
    """Mixture-of-experts FFN, a drop-in for a block's dense MLP:
    ``x [b, s, d] -> [b, s, d]``, top-``top_k`` routing into
    ``num_experts`` FFNs of width ``ffn_dim`` (default ``mlp_ratio * d``),
    grouped GShard routing (``num_groups`` 0: one group a batch row;
    capacity is per group). ``expert_act`` ``"gelu"`` (``w1 [E, d,
    ff]``, ``w2 [E, ff, d]``, flax's tanh GELU) or ``"swiglu"``
    (``w_gate``, ``w_up``, ``w_down``); the experts have no biases. On a
    ``layout`` with an expert or tensor axis the leaves hold this rank's
    experts and ffn shard (module docstring). The parameters are the
    reference's leaves in its shapes."""

    def __init__(self, hidden_dim: int, num_experts: int, *, top_k: int = 2,
                 capacity_factor: float = 1.25, mlp_ratio: int = 4,
                 ffn_dim: int | None = None, expert_act: str = "gelu",
                 aux_loss_weight: float = 0.01, num_groups: int = 0,
                 dispatch_impl: str = "einsum", router_z_loss: float = 0.0,
                 router_jitter: float = 0.0, dtype=torch.float32,
                 layout=None, device=None):
        super().__init__()
        if dispatch_impl not in ("einsum", "index"):
            raise ValueError(f"dispatch_impl must be 'einsum' or 'index', "
                             f"got {dispatch_impl!r}")
        if expert_act not in ("gelu", "swiglu"):
            raise ValueError(f"unknown expert_act {expert_act!r}")
        E, d = num_experts, hidden_dim
        ff = ffn_dim or mlp_ratio * d
        ep, t = expert_size(layout), tensor_size(layout)
        if E % ep:
            raise ValueError(f"num_experts={E} not divisible by the mesh's "
                             f"expert={ep} axis")
        if ff % t:
            raise ValueError(f"the experts' ffn width {ff} not divisible by "
                             f"tensor={t}")
        self.hidden_dim, self.num_experts, self.ffn_dim = d, E, ff
        self.top_k, self.capacity_factor = top_k, capacity_factor
        self.expert_act, self.aux_loss_weight = expert_act, aux_loss_weight
        self.num_groups, self.dispatch_impl = num_groups, dispatch_impl
        self.router_z_loss = float(router_z_loss)
        self.router_jitter = float(router_jitter)
        self.dtype, self.layout = dtype, layout
        e_loc, f_loc = E // ep, ff // t
        self.router = nn.Parameter(torch.empty(d, E, device=device))
        names = (("w_gate", "w_up", "w_down") if expert_act == "swiglu"
                 else ("w1", "w2"))
        for name in names:
            shape = ((e_loc, f_loc, d) if name in ("w2", "w_down")
                     else (e_loc, d, f_loc))
            setattr(self, name, nn.Parameter(torch.empty(shape,
                                                         device=device)))
        self.expert_leaves = names
        #: the last forward's scaled losses (``aux``, and ``z`` with a
        #: z-loss weight); None before a forward
        self.losses = None
        self._routed = None

    def whole_shape(self, name: str) -> tuple:
        """The whole leaf's shape (all experts, the whole ffn width)."""
        E, d, ff = self.num_experts, self.hidden_dim, self.ffn_dim
        if name == "router":
            return (d, E)
        return (E, ff, d) if name in ("w2", "w_down") else (E, d, ff)

    @torch.no_grad()
    def init_weights(self, g: torch.Generator) -> None:
        """flax's ``lecun_normal`` of each whole leaf in the reference's
        order (``router``, then the expert leaves; a stacked ``[E, n_in,
        n_out]`` leaf's fan-in ``E * n_in``, flax's fans of a 3-D kernel),
        drawn from ``g`` and kept to this rank's experts and ffn shard."""
        dev = self.router.device
        for name in ("router", *self.expert_leaves):
            shape = self.whole_shape(name)
            fan_in = math.prod(shape[:-1])
            w = torch.empty(shape, device=dev)
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=g)
            w = w * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)
            getattr(self, name).copy_(self.shard_leaf(name, w))

    def shard_leaf(self, name: str, whole: torch.Tensor) -> torch.Tensor:
        """This rank's part of the whole leaf ``name``: its experts' rows,
        then its ffn shard."""
        if name == "router":
            return whole
        ep, t = expert_size(self.layout), tensor_size(self.layout)
        if ep > 1:
            n = whole.shape[0] // ep
            whole = whole[self.layout.expert_idx * n:][:n]
        if t > 1:
            whole = tp_lib.shard_tensor(f"moe.{name}", whole, t,
                                        self.layout.tensor_idx,
                                        table=tp_lib.MOE_SPECS)
        return whole

    def forward(self, x, *, train: bool = False, jitter_key: int | None = None):
        """``train`` enables the router jitter, drawn from ``jitter_key``
        (a train-mode call with jitter and no key raises, as the
        reference needs its 'dropout' rng)."""
        b, s, d = x.shape
        E = self.num_experts
        G = self.num_groups or b
        T = b * s
        if T % G:
            raise ValueError(f"{T} tokens not divisible into {G} groups")
        t = T // G
        tokens = x.reshape(G, t, d)
        rin = tokens.float()
        if self.router_jitter > 0.0 and train:
            if jitter_key is None:
                raise ValueError(
                    "router_jitter > 0 needs a dropout_key at train time "
                    "(make_train_step passes one); pass dropout_key= or set "
                    "router_jitter=0")
            j = self.router_jitter
            u = torch.rand(rin.shape, generator=generator(jitter_key,
                                                           rin.device),
                           device=rin.device)
            rin = rin * ((1.0 - j) + (2.0 * j) * u)
        logits = rin @ self.router.float()
        probs = torch.softmax(logits, dim=-1)
        capacity = expert_capacity(t, E, top_k=self.top_k,
                                   capacity_factor=self.capacity_factor)
        idx, gates, pos, keep, aux = top_k_routing(probs, self.top_k,
                                                   capacity)
        losses = {"aux": self.aux_loss_weight * torch.mean(aux)}
        if self.router_z_loss > 0.0:
            z = torch.logsumexp(logits, dim=-1)
            losses["z"] = self.router_z_loss * torch.mean(z * z)
        self.losses = losses
        self._routed = (idx.detach(), keep.detach(), aux.detach())
        ep = expert_size(self.layout)
        lo = self.layout.expert_idx * (E // ep) if ep > 1 else 0
        e_loc = E // ep
        if self.dispatch_impl == "index":
            if ep > 1:
                # choices on this rank's experts, re-based locally; the
                # rest collide on the local garbage slot
                mine = keep & (idx >= lo) & (idx < lo + e_loc)
                dest_l = torch.where(mine, (idx - lo) * capacity + pos,
                                     torch.full_like(idx, e_loc * capacity))
            else:
                dest_l = _flat_dest(idx, pos, keep, capacity, E)
            slots = _index_dispatch(
                copy_to_expert(tokens.to(self.dtype), self.layout), dest_l,
                e_loc, capacity)
            out = gather_experts(self._expert_ffn(slots), self.layout)
            y = _index_combine(out, _flat_dest(idx, pos, keep, capacity, E),
                               gates, keep, self.dtype)
        else:
            dispatch, combine = _one_hot_dispatch(idx, gates, pos, keep, E,
                                                  capacity, probs.dtype)
            slots = torch.einsum(
                "gtec,gtd->gecd",
                dispatch[:, :, lo:lo + e_loc].to(self.dtype),
                copy_to_expert(tokens.to(self.dtype), self.layout))
            out = gather_experts(self._expert_ffn(slots), self.layout)
            y = torch.einsum("gtec,gecd->gtd", combine.to(self.dtype), out)
        return y.reshape(b, s, d)

    def _expert_ffn(self, slots):
        """Each local expert's FFN over its slots ``[G, E_loc, C, d]``;
        under a tensor axis on this rank's ffn shard, the row products'
        float32 partials summed over the tensor group and rounded once."""
        dt = self.dtype
        G, e, C, d = slots.shape
        x = copy_to_tensor(slots.transpose(0, 1).reshape(e, G * C, d),
                           self.layout)
        if self.expert_act == "swiglu":
            h = (F.silu(torch.bmm(x, self.w_gate.to(dt)))
                 * torch.bmm(x, self.w_up.to(dt)))
            w_out = self.w_down
        else:
            h = F.gelu(torch.bmm(x, self.w1.to(dt)), approximate="tanh")
            w_out = self.w2
        if tensor_size(self.layout) == 1:
            out = torch.bmm(h, w_out.to(dt))
        else:
            w_out = w_out.to(dt)
            partial = torch.stack([tp_lib.row_partial(h[i], w_out[i].t())
                                   for i in range(e)])
            out = tp_lib.reduce_from_tensor(partial, self.layout).to(dt)
        return out.reshape(e, G, C, d).transpose(0, 1)

    @torch.no_grad()
    def stats(self) -> dict:
        """The last forward's router observability (the reference's
        ``moe_stats``): ``load [E]``, the share of routed (token, choice)
        pairs each expert kept (their sum is ``1 - dropped``); ``dropped``,
        the dropped share; ``aux``, the unscaled aux loss (mean over
        groups). Device tensors; None before a forward."""
        if self._routed is None:
            return None
        idx, keep, aux = self._routed
        kept = keep.float()
        load = torch.mean(F.one_hot(idx.long(), self.num_experts).float()
                          * kept[..., None], dim=(0, 1, 2))
        return {"load": load, "dropped": 1.0 - torch.mean(kept),
                "aux": torch.mean(aux)}


def moe_layers(model: nn.Module) -> list[MoEMlp]:
    return [m for m in model.modules() if isinstance(m, MoEMlp)]


def moe_losses(model: nn.Module):
    """The sum of every MoE layer's scaled losses from ``model``'s last
    forward (aux, and z-loss where on), in block order; 0.0 without
    one."""
    total = 0.0
    for m in moe_layers(model):
        if m.losses is not None:
            for v in m.losses.values():
                total = total + v
    return total


# -- expert leaves in state dicts ----------------------------------------------


def is_expert_leaf(name: str) -> bool:
    """Whether ``name`` (a state-dict key) is a stacked expert leaf."""
    parts = name.split(".")
    return len(parts) >= 2 and parts[-2] == "moe" and parts[-1] in EXPERT_LEAVES


def expert_names(model: nn.Module) -> list[str]:
    """The parameters of ``model`` held as expert shards (none without an
    expert axis)."""
    if expert_size(getattr(model, "layout", None)) == 1:
        return []
    return [k for k, _ in model.named_parameters() if is_expert_leaf(k)]


def shard_experts(sd: dict, layout) -> dict:
    """This rank's experts (dim 0) of every expert leaf of a state dict
    holding all of them; the rest as it is."""
    ep = expert_size(layout)
    if ep == 1:
        return sd
    out = {}
    for k, v in sd.items():
        if is_expert_leaf(k):
            n = v.shape[0] // ep
            v = v[layout.expert_idx * n:][:n].clone(
                memory_format=torch.contiguous_format)
        out[k] = v
    return out


def gather_expert_sd(sd: dict, layout) -> dict:
    """Every expert of each expert leaf of ``sd`` from the expert ranks'
    (a collective over the expert group: every rank calls it, with its
    dict in the same order)."""
    ep = expert_size(layout)
    if ep == 1:
        return sd
    out = {}
    for k, v in sd.items():
        if is_expert_leaf(k):
            wire = _wire(v.detach())
            parts = [torch.empty_like(wire) for _ in range(ep)]
            dist.all_gather(parts, wire, group=layout.expert_group)
            v = torch.cat(parts, 0).to(v.dtype)
        out[k] = v
    return out
