"""Elastic restart: resume a checkpoint on another data world.

Counterpart of :mod:`tpudist.resilience.elastic`. The guard every resume
uses: :func:`meta_matches` decides whether a saved ``tpudist_meta.json``
describes this run's geometry, and :func:`refusal_reason` says why a
mismatch is not a pure world resize (the world-shaped keys may differ;
the semantic ones, ``reduce`` and ``shard_opt_state``, and the model
axes may not). ``fit(elastic=True)`` turns a pure resize into a reshard
(:func:`reshard_restore`):

- a leaf whose saved global shape is the live one loads directly (DCP
  places a DTensor's global array on the new world's shards);
- a ZeRO-1 pad leaf (``[world, cols]``) or a leaf whose ZeRO-1
  classification changed is read whole at its saved shape, relaid by its
  flat prefix (re-padded with zeros, exact because the pad region is
  zero by construction) and sliced for this rank;
- the error-feedback residual is world-bound per-replica error: it
  restarts as zeros (one step of uncompensated quantization noise);
- the step counter, the data position, is remapped by the
  steps-per-epoch ratio, rounding down (:func:`remap_step`).
"""

from __future__ import annotations

__all__ = [
    "ELASTIC_KEYS",
    "MODEL_AXIS_KEYS",
    "ElasticRefusal",
    "refusal_reason",
    "comparable_meta",
    "elastic_mismatch",
    "meta_matches",
    "remap_step",
    "reshard_restore",
]


class ElasticRefusal(ValueError):
    """A geometry/structure mismatch that is NOT a world resize — a
    decision, not damage: the corrupt-checkpoint fallback walk must
    propagate it instead of trying older steps (they would refuse
    identically)."""

#: geometry-meta keys a world resize is ALLOWED to change. Everything
#: else in the meta is run semantics (reduction method, ZeRO-1 on/off,
#: future keys default-deny) and still refuses loudly.
ELASTIC_KEYS = frozenset(
    {"world_size", "data_world", "steps_per_epoch", "batch_size",
     "grad_accum"}
)

#: the composed-parallelism axis worlds (tpudist.parallel.plan): every
#: placement in the checkpoint — fsdp scatter, Megatron tensor splits,
#: stacked pipe stages — is bound to these sizes, and unlike a data
#: resize there is no layout algebra here yet (ROADMAP: FSDP reshard is
#: the named follow-on), so resizing any of them is DEFAULT-DENIED with
#: a hint naming the fix. Metas written before this layer carry none of
#: the keys and mean 1 (:func:`comparable_meta`).
MODEL_AXIS_KEYS = ("fsdp_world", "tensor_world", "pipe_world",
                   "expert_world")


def refusal_reason(saved_meta: dict, run_meta: dict) -> str | None:
    """Why this meta mismatch is NOT a valid elastic resize — or ``None``
    when every differing key is world-shaped and the reshard may proceed.
    Keys missing on either side count as differing (default-deny: a
    future semantic key must refuse until this list learns about it).
    Model-axis resizes get a precise hint: which axis moved, and that
    only the ``data`` axis is elastic."""
    # the legacy-default normalization first: an old meta without the
    # appended axis keys vs a live run with all axes at 1 must not turn a
    # legitimate pure-data resize into a spurious model-axis refusal
    run_meta = comparable_meta(saved_meta, run_meta)
    bad = sorted(
        k
        for k in set(saved_meta) | set(run_meta)
        if saved_meta.get(k) != run_meta.get(k) and k not in ELASTIC_KEYS
    )
    if not bad:
        return None
    axes = [k for k in bad if k in MODEL_AXIS_KEYS]
    if axes:
        # absent = the pre-composition default of 1, so the hint reads
        # "fsdp_world 1 -> 2", not "None -> 2"
        moved = ", ".join(
            f"{k} {saved_meta.get(k, 1)} -> {run_meta.get(k, 1)}"
            for k in axes
        )
        want = ", ".join(
            f"{k.split('_')[0]}={saved_meta.get(k, 1)}"
            for k in MODEL_AXIS_KEYS
        )
        rest = [k for k in bad if k not in MODEL_AXIS_KEYS]
        more = f"; keys {rest} differ too" if rest else ""
        legacy = [k for k in axes if k not in saved_meta]
        if legacy:
            # a meta that PREDATES axis recording can only be read as
            # axes=1 — but a pre-upgrade TP/pipe run really did train
            # split, and its unchanged-geometry resume must not be
            # bricked: name the one-line adoption fix
            more += (
                f"; note {legacy} are absent from the saved meta (written "
                "before model-axis recording) — if the checkpoint really "
                "was trained under THIS run's axes, adopt it by adding "
                "the keys with this run's values to tpudist_meta.json"
            )
        return (
            f"model-parallel axes resized ({moved}): only the data axis "
            "is elastic — the fsdp/tensor/pipe placements the checkpoint "
            "was written under have no reshard path; relaunch with the "
            f"checkpoint's plan (MeshConfig({want})) or start a fresh "
            f"checkpoint_dir{more}"
        )
    return (
        f"keys {bad} differ beyond a world resize "
        f"({ {k: saved_meta.get(k) for k in bad} } != "
        f"{ {k: run_meta.get(k) for k in bad} })"
    )


def comparable_meta(saved_meta: dict, run_meta: dict) -> dict:
    """``run_meta`` as it should be COMPARED against ``saved_meta``:
    ``data_world`` was introduced by the elastic layer, so a checkpoint
    written before it carries no such key — a legacy meta that matches on
    everything else is the SAME geometry (``world_size`` already pins the
    world it knew about), not a mismatch that refuses (or, worse,
    gratuitously reshard-commits) a resume on unchanged hardware.

    The composed-parallelism axis worlds (:data:`MODEL_AXIS_KEYS`) were
    appended later still, with an explicit legacy default of 1: a key the
    saved meta lacks compares equal when the live run's value is 1 (the
    only geometry an old checkpoint can have been written under) and
    DIFFERS — default-deny, precise hint — when the live run actually
    splits that axis."""
    drop = {
        k for k in ("data_world",)
        if k in run_meta and k not in saved_meta
    }
    drop |= {
        k for k in MODEL_AXIS_KEYS
        if k in run_meta and k not in saved_meta and run_meta[k] == 1
    }
    if drop:
        return {k: v for k, v in run_meta.items() if k not in drop}
    return run_meta


def meta_matches(saved_meta: dict, run_meta: dict) -> bool:
    """Geometry equality with the legacy-``data_world`` allowance —
    the ONE comparison both ``fit()``'s guard and
    ``Checkpointer.restore(reshard=True)`` apply."""
    return saved_meta == comparable_meta(saved_meta, run_meta)


def elastic_mismatch(saved_meta: dict, run_meta: dict) -> bool:
    """True iff the metas differ AND the difference is a pure world
    resize (every differing key in :data:`ELASTIC_KEYS`)."""
    return (not meta_matches(saved_meta, run_meta)
            and refusal_reason(saved_meta, run_meta) is None)


def remap_step(step: int, saved_meta: dict, run_meta: dict) -> tuple[int, bool]:
    """The saved optimizer-step counter in the new world's steps,
    keeping the data position (``step / steps_per_epoch`` epochs): ``(new
    step, exact)``; an inexact ratio rounds down (a partial batch is
    consumed again, never skipped)."""
    old = saved_meta.get("steps_per_epoch")
    new = run_meta.get("steps_per_epoch")
    step = int(step)
    if not old or not new or old == new:
        return step, True
    return (step * new) // old, (step * new) % old == 0


def _flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dicts -> ``{"a.b.c": leaf}`` (DCP's names)."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, f"{name}."))
        else:
            out[name] = v
    return out


def relayout(old, new_shape) -> "torch.Tensor":
    """Old stored layout -> new: the flat prefix copied, the tail
    zero-(re)padded."""
    import math

    import torch

    n = math.prod(new_shape)
    flat = old.reshape(-1)
    if flat.numel() >= n:
        flat = flat[:n]
    else:
        flat = torch.cat([flat, flat.new_zeros(n - flat.numel())])
    return flat.reshape(new_shape)


def _local_part(full, like):
    """This rank's part of the global ``full`` as ``like`` (a DTensor, or
    a plain tensor: all of it) holds it."""
    if not hasattr(like, "to_local"):
        return full
    mesh = like.device_mesh
    for i, pl in enumerate(like.placements):
        if pl.is_shard():
            full = full.chunk(mesh.size(i), pl.dim)[mesh.get_local_rank(i)]
    return full


def reshard_restore(ckpt, like, step: int, *, saved_meta: dict,
                    run_meta: dict, on_event=None):
    """Restore checkpoint ``step`` into ``like`` (a
    :class:`~tpudist_torch.train.TrainState` built for the new world, its
    residual zeroed) in place, resharding the world-bound leaves (module
    docstring). Emits one ``reshard`` event through ``on_event``."""
    import torch

    reason = refusal_reason(saved_meta, run_meta)
    if reason is not None:
        raise ElasticRefusal(
            f"checkpoint at {ckpt.directory} cannot be elastically resumed: "
            f"{reason} — resume with the original settings or start a "
            "fresh checkpoint_dir")
    saved = ckpt.saved_metadata(step)
    sd = like.state_dict()
    live = {k: v for k, v in _flatten(sd).items()
            if isinstance(v, torch.Tensor)}
    if set(saved) != set(live):
        missing = sorted(set(live) - set(saved))[:3]
        extra = sorted(set(saved) - set(live))[:3]
        raise ElasticRefusal(
            f"checkpoint at {ckpt.directory} has a different train-state "
            f"STRUCTURE than the live run (missing {missing}, extra {extra})"
            " — this is not a world resize; resume with the original "
            "settings")
    load = {}
    resharded, flushed = [], False
    for name, t in live.items():
        old_shape, old_dtype = saved[name]
        if name == "comm_residual":
            flushed = True   # the live state's zeros are the flushed bank
            continue
        if old_dtype != t.dtype:
            raise ElasticRefusal(f"leaf {name} changed dtype ({old_dtype} != "
                                 f"{t.dtype}) — not a world resize")
        if old_shape == tuple(t.shape):
            load[name] = t
        else:
            load[name] = torch.empty(old_shape, dtype=old_dtype)
            resharded.append(name)
    # what is read: the entries of sd (counters included), each tensor
    # replaced by its load target, the flushed residual left out
    def targets(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            name = f"{prefix}{k}"
            if isinstance(v, dict):
                out[k] = targets(v, f"{name}.")
            elif not isinstance(v, torch.Tensor):
                out[k] = v
            elif name in load:
                out[k] = load[name]
        return out

    nested = targets(sd)
    ckpt.raw_restore(nested, step)

    def merge(tree, got, prefix=""):
        for k, v in got.items():
            name = f"{prefix}{k}"
            if isinstance(v, dict):
                merge(tree[k], v, f"{name}.")
            elif name in resharded:
                t = tree[k]
                dev = (t.to_local() if hasattr(t, "to_local") else t).device
                tree[k] = _local_part(
                    relayout(v, tuple(t.shape)).to(dev), t)
            elif not isinstance(v, torch.Tensor):
                tree[k] = v

    merge(sd, nested)
    if flushed:
        sd.pop("comm_residual", None)
    like.load_state_dict(sd)
    new_step, exact = remap_step(like.step, saved_meta, run_meta)
    like.step = new_step
    if on_event is not None:
        on_event({
            "tag": "reshard",
            "old_world": saved_meta.get("data_world",
                                        saved_meta.get("world_size")),
            "new_world": run_meta.get("data_world",
                                      run_meta.get("world_size")),
            "step_old": int(step), "step_new": int(new_step),
            "cursor_exact": bool(exact),
            "resharded_leaves": len(resharded),
            "resharded": resharded[:16],
            "residual_flushed": flushed,
        })
    return like
