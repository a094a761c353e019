"""Device-memory accounting: byte budgets before training, live stats after.

The port's copy of :mod:`tpudist.memory` (with :mod:`tpudist.utils.tree`'s
``tree_bytes`` / ``tree_size``). Three layers:

1. per-tree bytes, exact: :func:`tree_bytes` / :func:`tree_size` over
   state dicts, modules, optimizer states or any nesting of them;
   :func:`per_device_bytes` / :func:`state_bytes` (replicated only: the
   port's training is data-parallel, and another placement is ROADMAP
   Queue 1 #7);
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


def _replicated_only(shardings) -> None:
    if shardings is not None:
        raise NotImplementedError(
            "per-device bytes under a sharded placement are not ported yet "
            "(ROADMAP Queue 1 #7)")


def per_device_bytes(tree, shardings=None) -> int:
    """Bytes one device holds for ``tree``: all of it, every leaf
    replicated. A ``shardings`` tree raises (Queue 1 #7)."""
    _replicated_only(shardings)
    return tree_bytes(tree)


def state_bytes(state, shardings=None) -> dict[str, dict[str, int]]:
    """``{component: {"global", "per_device"}}`` for a
    :class:`tpudist_torch.train.TrainState`'s ``params`` (the float32
    masters), ``opt_state`` and ``batch_stats``, plus ``total``."""
    _replicated_only(shardings)
    parts = {"params": state.params(), "opt_state": state.opt_state,
             "batch_stats": state.batch_stats()}
    out: dict[str, dict[str, int]] = {}
    total = 0
    for name, sub in parts.items():
        b = tree_bytes(sub)
        out[name] = {"global": b, "per_device": b}
        total += b
    out["total"] = {"global": total, "per_device": total}
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
    required without a card. ``plan=`` (a sharded placement) raises:
    ROADMAP Queue 1 #7.

    Returns the reference's keys: per-component bytes, the per-chip total,
    ``fits`` and ``bytes_per_param``."""
    if plan is not None:
        raise NotImplementedError(
            "train_state_budget(plan=...) is not ported yet (ROADMAP Queue "
            "1 #7)")
    if hbm_budget_bytes is None:
        if not torch.cuda.is_available():
            raise ValueError("hbm_budget_bytes is required without a card "
                             "(it defaults to the card's total memory)")
        hbm_budget_bytes = torch.cuda.get_device_properties(
            torch.cuda.current_device()).total_memory
    model = model_fn(torch.device("meta"))
    params = dict(model.named_parameters())
    n_params = tree_size(params)
    opt_state = tx.init(params)
    # what the step holds: the parameters as the model keeps them after
    # init (a fused optimizer's compute copy: bf16) and what the state
    # adds (moments; the float32 masters of a compute copy)
    own = {id(p) for p in model.parameters()}
    params_bytes = tree_bytes(dict(model.named_parameters()))
    opt_bytes = sum(t.numel() * t.element_size() for t in _leaves(opt_state)
                    if id(t) not in own)
    acts = transformer_activation_bytes(
        batch, seq, int(getattr(model, "hidden_dim", 0) or 0),
        int(getattr(model, "depth", 0) or 0),
        num_heads=getattr(model, "num_heads", None),
        remat_policy=remat_policy,
        attention_scores=getattr(model, "attn_impl", "xla") in ("xla", "auto"),
    )
    grads = n_params * grad_dtype_bytes
    subtotal = params_bytes + opt_bytes + acts + grads
    per_chip_total = int(subtotal * (1.0 + workspace_fraction))
    return {
        "n_params": int(n_params),
        "world_size": int(world_size),
        "remat_policy": str(remat_policy),
        "params_bytes": int(params_bytes),
        "opt_state_bytes_global": int(opt_bytes),
        "opt_state_bytes_per_chip": int(opt_bytes),
        "grad_bytes": int(grads),
        "activation_bytes_est": int(acts),
        "workspace_bytes_est": int(per_chip_total - subtotal),
        "per_chip_total_bytes": per_chip_total,
        "hbm_budget_bytes": int(hbm_budget_bytes),
        "fits": bool(per_chip_total <= hbm_budget_bytes),
        "bytes_per_param": round(per_chip_total / max(n_params, 1), 2),
    }


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
