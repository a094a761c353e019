"""Device-memory accounting: byte budgets before training, live stats after.

The port's copy of :mod:`tpudist.memory` (with :mod:`tpudist.utils.tree`'s
``tree_bytes`` / ``tree_size``). Three layers:

1. per-tree bytes, exact: :func:`tree_bytes` / :func:`tree_size` over
   state dicts, modules, optimizer states or any nesting of them;
   :func:`per_device_bytes` / :func:`state_bytes` under the port's
   placement records (:func:`plan_placements`: a leaf's shard dim and
   its world over the tensor axis, FSDP's and ZeRO-1's, or a list of
   them applied in turn; a ZeRO-1 pad leaf is ``[world, cols]`` split on
   dim 0);
2. an activation estimate, analytic: :func:`transformer_activation_bytes`
   is the reference's word for word;
3. live stats: :func:`device_memory_stats` reads the caching allocator
   (``torch.cuda.memory_stats``) under the reference's keys, and is None
   on the CPU; ``fit`` logs it as the TSV's ``HBM`` rows.

:func:`train_state_budget` assembles 1 and 2 into the reference's
fits-or-not report, building the model and its optimizer state on the
``meta`` device (no memory anywhere); its budget is the card's memory
(``total_memory``) unless one is given. There is no compiler reservation
on this path: :func:`budget_columns`' ``xla_static_bytes`` is None, the
reference's fail-soft value for a source that reports nothing.
"""

from __future__ import annotations

from typing import Any, Mapping

import torch

__all__ = [
    "tree_bytes",
    "tree_size",
    "per_device_bytes",
    "state_bytes",
    "transformer_activation_bytes",
    "train_state_budget",
    "device_memory_stats",
    "budget_columns",
    "format_budget",
]


def _leaves(tree) -> list[torch.Tensor]:
    """The tensors of ``tree``: a tensor, a module (its parameters and
    buffers), a mapping, a sequence, or an object with a ``__dict__`` (an
    optimizer state), nested; scalars and None hold no bytes. A tensor
    reached twice (a tied weight) counts once."""
    out, seen = [], set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if id(x) not in seen:
                seen.add(id(x))
                out.append(x)
        elif isinstance(x, torch.nn.Module):
            for t in x.state_dict(keep_vars=True).values():
                walk(t)
        elif isinstance(x, Mapping):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif hasattr(x, "__dict__") and not isinstance(x, type):
            for v in vars(x).values():
                walk(v)

    walk(tree)
    return out


def tree_size(tree) -> int:
    """Total elements of ``tree``'s tensors."""
    return sum(t.numel() for t in _leaves(tree))


def tree_bytes(tree) -> int:
    """Total bytes of ``tree``'s tensors."""
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _shard_shape(shape, record) -> tuple:
    """The largest shard one device holds of a leaf of ``shape`` under
    ``record``: None (replicated), ``(dim, world)`` (ceil division, the
    padded shard an allocator reserves), ``(dim, world, axis)`` over
    ``data``, ``fsdp``, ``pipe`` (a stacked leaf's layers), ``expert`` (a
    stacked expert leaf's experts) or ``tensor``, or a list of them
    applied in turn (a rank's tensor shard sliced over data; an FSDP
    shard sliced again over data; an expert leaf's experts and its ffn
    shard); an axis the port does not lay out raises."""
    if record is None:
        return tuple(shape)
    if isinstance(record, list):
        for r in record:
            shape = _shard_shape(shape, r)
        return tuple(shape)
    dim, world, *axis = record
    if axis and axis[0] not in ("data", "fsdp", "pipe", "expert", "tensor"):
        raise ValueError(f"a placement over {axis[0]!r}: the port lays out "
                         "data, fsdp, pipe, expert and tensor")
    out = list(shape)
    out[dim] = -(-out[dim] // int(world))
    return tuple(out)


def param_record(record):
    """The part of a state record that places the parameter itself (its
    fsdp, tensor or expert shard; ZeRO-1's data slices place the state
    only)."""
    parts = record if isinstance(record, list) else [record]
    kept = [r for r in parts if r is not None and r[2] != "data"]
    if not kept:
        return None
    return kept[0] if len(kept) == 1 else kept


def per_device_bytes(tree, shardings=None) -> int:
    """Bytes one device holds for ``tree``. ``shardings``: the placement
    record of each leaf (:func:`_shard_shape`), a dict keyed as ``tree``
    when it is a dict of tensors, else a sequence aligned with its
    leaves; None: every leaf replicated."""
    if shardings is None:
        return tree_bytes(tree)
    if isinstance(tree, dict) and all(isinstance(v, torch.Tensor)
                                      for v in tree.values()):
        pairs = [(t, shardings.get(k)) for k, t in tree.items()]
    else:
        leaves = _leaves(tree)
        shardings = list(shardings)
        if len(shardings) != len(leaves):
            raise ValueError(f"{len(shardings)} placement records for "
                             f"{len(leaves)} leaves")
        pairs = list(zip(leaves, shardings))
    total = 0
    for t, rec in pairs:
        n = 1
        for d in _shard_shape(tuple(t.shape), rec):
            n *= d
        total += n * t.element_size()
    return total


def _zero1_record(shape, data: int, min_size: int):
    """ZeRO-1's record of a leaf of ``shape`` over ``data`` replicas (a pad
    leaf's record carries its ``cols``: it is stored ``[world, cols]``)."""
    from tpudist_torch.optim import _zero1_layout

    mode, info = _zero1_layout(tuple(shape), data, min_size)
    if mode == "shard":
        return (info, data, "data")
    if mode == "pad":
        return (0, data, "data", info)
    return None


def plan_placements(params: dict, *, fsdp: int = 1, data: int = 1,
                    zero1: bool = False, min_size: int = 1024,
                    tensor: int = 1, table: dict | None = None,
                    expert: int = 1) -> dict:
    """The placement record of each leaf's optimizer state under a plan
    (:func:`param_record` of it places the parameter), from the whole
    parameters ``params``:

    - a leaf the tensor axis places (``table``, the family's
      ``tensor_specs``, when ``tensor > 1``) is its tensor shard; under
      ZeRO-1 without an fsdp axis its state is that shard sliced over
      ``data`` (the port's placement; the reference slices the whole
      leaf over data and replicates the slices over tensor); beside an
      fsdp axis it stays as it is;
    - every other leaf takes its ``fsdp`` shard dim (the plan's rule),
      under ZeRO-1 sliced again over ``data`` where ``fsdp x data``
      divides the dim (the reference's ``(fsdp, data)`` overlay);
    - what FSDP leaves whole takes its ``data`` slice under ZeRO-1;
    - a stacked expert leaf (:func:`tpudist_torch.parallel.ep.
      is_expert_leaf`) under ``expert > 1`` holds its rank's experts
      (dim 0), and its ffn shard under a tensor axis; ZeRO-1 leaves its
      state as the parameter is (the reference's ``wrap_zero1`` exempts
      the expert leaves)."""
    from tpudist_torch.mesh import largest_divisible_dim
    from tpudist_torch.parallel.ep import is_expert_leaf
    from tpudist_torch.parallel.tp import tensor_spec

    out = {}
    for k, p in params.items():
        shape = tuple(p.shape)
        spec = tensor_spec(k, table=table) if tensor > 1 else None
        if expert > 1 and is_expert_leaf(k):
            rec = (0, expert, "expert")
            if spec is not None:
                rec = [(spec[0], tensor, "tensor"), rec]
            out[k] = rec
            continue
        if spec is not None:
            rec = (0 if spec[0] == "vocab" else spec[0], tensor, "tensor")
            z = (_zero1_record(_shard_shape(shape, rec), data, min_size)
                 if zero1 and fsdp == 1 else None)
            out[k] = rec if z is None else [rec, z]
            continue
        dim = largest_divisible_dim(shape, fsdp, min_size=min_size)
        if dim is not None:
            rec = (dim, fsdp, "fsdp")
            if zero1 and data > 1 and shape[dim] % (fsdp * data) == 0:
                rec = [rec, (dim, data, "data")]
            out[k] = rec
            continue
        out[k] = _zero1_record(shape, data, min_size) if zero1 else None
    return out


def state_bytes(state, shardings=None) -> dict[str, dict[str, int]]:
    """``{component: {"global", "per_device"}}`` for a
    :class:`tpudist_torch.train.TrainState`'s ``params`` (the float32
    masters), ``opt_state`` and ``batch_stats``, plus ``total``.
    ``shardings``: ``{"params": records, "opt_state": records}`` as
    :func:`per_device_bytes` takes them (a component without one is
    replicated)."""
    parts = {"params": state.params(), "opt_state": state.opt_state,
             "batch_stats": state.batch_stats()}
    shardings = shardings or {}
    out: dict[str, dict[str, int]] = {}
    total = total_d = 0
    for name, sub in parts.items():
        b = tree_bytes(sub)
        d = per_device_bytes(sub, shardings.get(name))
        out[name] = {"global": b, "per_device": d}
        total += b
        total_d += d
    out["total"] = {"global": total, "per_device": total_d}
    return out


def transformer_activation_bytes(
    batch: int,
    seq: int,
    hidden: int,
    depth: int,
    *,
    num_heads: int | None = None,
    remat_policy: str | bool | None = "none",
    dtype_bytes: int = 2,
    ffn_mult: int = 4,
    attention_scores: bool = False,
) -> int:
    """ESTIMATED live activation bytes of one transformer microbatch's
    forward, as held for backward under ``remat_policy``.

    Coarse per-token-per-layer accounting (bf16 default), stated so the
    numbers are auditable rather than mysterious:

    - ``none``: every block internal is saved — residual in + 2 norms +
      qkv (3H) + attn out + proj in + mlp up (ffn_mult·H) + gelu
      (ffn_mult·H) + proj ≈ ``(8 + 2·ffn_mult)·H`` per layer;
    - ``dots_saveable``: dot/MXU outputs only — qkv (3H) + attn out +
      mlp up (ffn_mult·H) + proj ≈ ``(5 + ffn_mult)·H``;
    - ``full`` / ``save_nothing`` (per-block checkpoint): the inter-block
      residual stream (1·H per layer) plus ONE block's internals live
      during its recompute.

    ``attention_scores=True`` adds the [B, heads, S, S] score matrix per
    layer (the XLA-attention path; the fused kernels never materialize
    it). Plus the embedding output once. This is an estimate for budget
    tables — the measured check is :func:`device_memory_stats`.
    """
    per_tok = {
        "none": (8 + 2 * ffn_mult) * hidden,
        "dots_saveable": (5 + ffn_mult) * hidden,
        "full": hidden,
        "save_nothing": hidden,
    }
    key = {False: "none", None: "none", True: "full"}.get(
        remat_policy, remat_policy
    )
    if key not in per_tok:
        raise ValueError(f"unknown remat policy {remat_policy!r}")
    tokens = batch * seq
    per_layer = per_tok[key] * tokens
    if attention_scores and key in ("none", "dots_saveable"):
        per_layer += (num_heads or 1) * batch * seq * seq
    total = depth * per_layer + tokens * hidden  # + embedding output
    if key in ("full", "save_nothing"):
        # one block's internals, alive during its backward recompute
        total += (8 + 2 * ffn_mult) * hidden * tokens
    return int(total) * dtype_bytes


def train_state_budget(
    model_fn,
    tx,
    *,
    batch: int,
    seq: int,
    world_size: int = 1,
    remat_policy: str | bool | None = "none",
    grad_dtype_bytes: int = 4,
    hbm_budget_bytes: int | None = None,
    workspace_fraction: float = 0.08,
    plan=None,
) -> dict[str, Any]:
    """The reference's pre-training fits-or-not report for one transformer
    training configuration.

    ``model_fn(device)`` builds the model; it is called with the ``meta``
    device, and ``tx.init`` (a :mod:`tpudist_torch.optim` optimizer) runs
    on its parameters there, so the parameter and optimizer-state bytes
    are exact and nothing is allocated. ``params_bytes`` are the
    parameters as the step holds them (under a fused optimizer's compute
    copy, the copy; its float32 masters count with the optimizer state).
    Activations come from :func:`transformer_activation_bytes` with the
    model's ``hidden_dim``,
    ``depth`` and ``num_heads`` (the ``[B, H, S, S]`` scores counted
    unless ``attn_impl`` names a kernel that never holds them: vmem,
    flash); gradients count one parameter-sized tree of
    ``grad_dtype_bytes``; ``workspace_fraction`` is the allocator's
    scratch. ``hbm_budget_bytes`` defaults to the card's memory
    (``torch.cuda.get_device_properties(...).total_memory``) and is
    required without a card. ``plan`` (a :class:`tpudist_torch.parallel.
    plan.ParallelPlan`, or anything with ``data``/``fsdp``/``tensor``/
    ``pipe``/``expert``) makes the parameters and gradients their largest
    single-rank shard and the optimizer state per device under the plan's
    placement (:func:`plan_placements` over the model's ``tensor_specs``;
    ZeRO-1 when ``tx`` is :func:`tpudist_torch.optim.shard_state`'s), and
    scales the activation estimate as the reference does: its batch
    ``batch / (data * fsdp)``, ``depth / pipe`` layers, the whole divided
    by ``tensor``. Under a pipe axis a rank holds one stage's blocks and
    the replicated rest (:func:`tpudist_torch.parallel.pp.stage_names`,
    stage 0's: every stage holds as many), so the per-device parameters,
    gradients and optimizer state count those leaves alone. ``model_fn``
    builds the whole model (no layout): only the axis sizes are read, so
    no world is needed. Under an expert axis a rank holds ``1 /
    expert`` of each stacked expert leaf (:func:`plan_placements`); the
    activations are counted as the dense model's (the reference's
    estimate: each token's FFN runs once a choice).

    Returns the reference's keys: per-component bytes, the per-chip total,
    ``fits`` and ``bytes_per_param``."""
    if hbm_budget_bytes is None:
        if not torch.cuda.is_available():
            raise ValueError("hbm_budget_bytes is required without a card "
                             "(it defaults to the card's total memory)")
        hbm_budget_bytes = torch.cuda.get_device_properties(
            torch.cuda.current_device()).total_memory
    model = model_fn(torch.device("meta"))
    params = dict(model.named_parameters())
    n_params = tree_size(params)
    from tpudist_torch.optim import ShardedStateOptimizer

    zero1 = isinstance(tx, ShardedStateOptimizer)
    inner_tx = tx.inner if zero1 else tx
    opt_state = inner_tx.init(params)
    # what the step holds: the parameters as the model keeps them after
    # init (a fused optimizer's compute copy: bf16) and what the state
    # adds (moments; the float32 masters of a compute copy)
    own = {id(p) for p in model.parameters()}
    params_bytes = tree_bytes(dict(model.named_parameters()))
    opt_leaves = [t for t in _leaves(opt_state) if id(t) not in own]
    opt_bytes = sum(t.numel() * t.element_size() for t in opt_leaves)
    params_global = params_bytes
    opt_per_chip, grads_per_chip, act_batch = opt_bytes, None, batch
    tensor = int(getattr(plan, "tensor", 1)) if plan is not None else 1
    depth = int(getattr(model, "depth", 0) or 0)
    pipe = int(getattr(plan, "pipe", 1)) if plan is not None else 1
    act_depth = depth
    if plan is not None or zero1:
        fsdp = int(getattr(plan, "fsdp", 1)) if plan is not None else 1
        data = (int(getattr(plan, "data", 1)) if plan is not None
                else int(tx.world))
        recs = plan_placements(params, fsdp=fsdp, data=data, zero1=zero1,
                               min_size=getattr(plan, "fsdp_min_size", 1024)
                               if plan is not None else tx.min_size,
                               tensor=tensor,
                               table=getattr(model, "tensor_specs", None),
                               expert=int(getattr(plan, "expert", 1))
                               if plan is not None else 1)
        named = dict(model.named_parameters())
        if pipe > 1:
            from tpudist_torch.optim import _named_leaves
            from tpudist_torch.parallel.pp import stage_names

            held = stage_names(named, depth, pipe, 0)
            away = {id(t) for k in named if k not in held
                    for t in _named_leaves(opt_state, k)}
            named = {k: named[k] for k in held}
            opt_leaves = [t for t in opt_leaves if id(t) not in away]
            act_depth = -(-depth // pipe) if depth else depth
        placed = {k: param_record(recs[k]) for k in named}
        params_bytes = per_device_bytes(named, placed)
        grads_per_chip = per_device_bytes(
            {k: torch.empty(p.shape, device="meta", dtype=torch.uint8)
             for k, p in named.items()}, placed) * grad_dtype_bytes
        opt_per_chip = _state_per_device(opt_state, opt_leaves, recs)
        act_batch = -(-batch // (fsdp * data))
    acts = transformer_activation_bytes(
        act_batch, seq, int(getattr(model, "hidden_dim", 0) or 0),
        act_depth,
        num_heads=getattr(model, "num_heads", None),
        remat_policy=remat_policy,
        attention_scores=getattr(model, "attn_impl", "xla") in ("xla", "auto"),
    ) // max(tensor, 1)
    grads = (n_params * grad_dtype_bytes if grads_per_chip is None
             else grads_per_chip)
    subtotal = params_bytes + opt_per_chip + acts + grads
    per_chip_total = int(subtotal * (1.0 + workspace_fraction))
    out = {
        "n_params": int(n_params),
        "world_size": int(world_size),
        "remat_policy": str(remat_policy),
        "params_bytes": int(params_bytes),
        "opt_state_bytes_global": int(opt_bytes),
        "opt_state_bytes_per_chip": int(opt_per_chip),
        "grad_bytes": int(grads),
        "activation_bytes_est": int(acts),
        "workspace_bytes_est": int(per_chip_total - subtotal),
        "per_chip_total_bytes": per_chip_total,
        "hbm_budget_bytes": int(hbm_budget_bytes),
        "fits": bool(per_chip_total <= hbm_budget_bytes),
        "bytes_per_param": round(per_chip_total / max(n_params, 1), 2),
    }
    if plan is not None:
        # the reference's plan keys
        worlds = {f"{a}_world": int(getattr(plan, a, 1))
                  for a in ("fsdp", "tensor", "pipe", "expert")}
        out["params_bytes_global"] = int(params_global)
        out["plan"] = (plan.describe() if hasattr(plan, "describe") else
                       f"ParallelPlan(data={int(getattr(plan, 'data', 1))}, "
                       f"fsdp={worlds['fsdp_world']}, "
                       f"pipe={worlds['pipe_world']}, "
                       f"tensor={worlds['tensor_world']}, "
                       f"expert={worlds['expert_world']})")
        out.update(worlds)
    return out


def _state_per_device(opt_state, leaves: list, recs: dict) -> int:
    """Per-device bytes of an optimizer state's ``leaves``: one stored
    under a parameter's name takes that parameter's record (a ZeRO-1 pad
    record its ``cols``), any other is replicated."""
    from tpudist_torch.optim import _named_leaves

    owner = {}
    for k in recs:
        for t in _named_leaves(opt_state, k):
            owner.setdefault(id(t), k)
    total = 0
    for t in leaves:
        rec = recs.get(owner.get(id(t)))
        last = rec[-1] if isinstance(rec, list) else rec
        if last is not None and len(last) == 4:
            total += last[3] * t.element_size()
            continue
        n = 1
        for d in _shard_shape(tuple(t.shape), rec):
            n *= d
        total += n * t.element_size()
    return total


def budget_columns(report: Mapping[str, Any] | None = None, *,
                   device=None) -> dict[str, int | None]:
    """The reference's three-source comparison row: the pre-training
    ESTIMATE (``report``'s per-chip total), the compiler's static
    reservation (always None: eager PyTorch has no compiled program that
    reserves memory) and the LIVE allocator peak of ``device`` (None on
    the CPU)."""
    live = device_memory_stats(device)
    return {
        "estimate_bytes": (None if report is None
                           else report.get("per_chip_total_bytes")),
        "xla_static_bytes": None,
        "live_peak_bytes": (None if live is None
                            else live.get("peak_bytes_in_use")),
    }


def format_budget(report: Mapping[str, Any], *,
                  xla_static_bytes: int | None = None,
                  live_peak_bytes: int | None = None) -> str:
    """One human line per component, GB with the fits verdict — what the
    bench leg and PERF table print. ``xla_static_bytes`` /
    ``live_peak_bytes`` (from :func:`budget_columns`) append the measured
    columns next to the estimate when a compiled program / a reporting
    backend is at hand; ``None`` (the default, and what fail-soft sources
    return) leaves the line byte-identical to the estimate-only form."""
    gb = 1024**3

    def f(k):
        return f"{report[k] / gb:.2f}"

    line = (
        f"params {f('params_bytes')} GB + opt_state "
        f"{f('opt_state_bytes_per_chip')} GB/chip "
        f"(global {f('opt_state_bytes_global')}) + grads {f('grad_bytes')} "
        f"GB + acts~{f('activation_bytes_est')} GB (remat="
        f"{report['remat_policy']}) + ws~{f('workspace_bytes_est')} GB = "
        f"{f('per_chip_total_bytes')} GB/chip vs {f('hbm_budget_bytes')} GB"
        f" -> {'FITS' if report['fits'] else 'DOES NOT FIT'} "
        f"({report['bytes_per_param']} B/param, world={report['world_size']})"
    )
    if xla_static_bytes is not None:
        line += f" | xla-static {xla_static_bytes / gb:.2f} GB"
    if live_peak_bytes is not None:
        line += f" | live-peak {live_peak_bytes / gb:.2f} GB"
    return line


def device_memory_stats(device=None) -> dict[str, int] | None:
    """Live allocator stats of one card under the reference's keys:
    ``bytes_in_use`` and ``peak_bytes_in_use`` (the caching allocator's
    current and peak allocated bytes, ``torch.cuda.memory_stats``) and
    ``bytes_limit`` (the card's total memory); None on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(
                device).total_memory)}
