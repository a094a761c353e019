"""The geometry guard of a resume: which checkpoint metas a run may take.

Part of :mod:`tpudist.resilience.elastic`, the functions every resume's
guard uses (``tpudist/train.py``'s bring-up): :func:`meta_matches` decides
whether a saved ``tpudist_meta.json`` describes this run's geometry, and
:func:`refusal_reason` says why a mismatch is not a pure world resize;
that text is the hint of the error a refused resume raises. The elastic
reshard itself (``reshard_restore``, ``remap_step``, ``fit(elastic=True)``)
is not ported yet (ROADMAP Queue 1 #7/#9): its world-bound layouts are
ZeRO-1's and the quantized reducer's, which the port does not have yet.
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
