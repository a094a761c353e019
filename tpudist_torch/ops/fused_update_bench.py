"""Device time of one fused-AdamW optimizer step over all of ResNet-50's leaves.

    python -m tpudist_torch.ops.fused_update_bench                # on the card
    python -m tpudist_torch.ops.fused_update_bench --ab OLD.cu    # another revision's kernel, in turns
    python -m tpudist_torch.ops.fused_update_bench --guard        # the --amp guard at ViT-B's leaves

The timed unit is what ``--fused optimizer --bf16`` runs each step:
``FusedAdamW.step`` over all of ResNet-50's 161 leaves (25,557,032
elements, in the model's own layouts), with bf16 gradients and a bf16
compute copy: one multi-tensor launch. Beside it: the plain version of
the same step, the per-leaf structure the step had before the
multi-tensor launch (the kernel in leaf mode for each leaf of at least
``MIN_KERNEL_ELEMS`` elements, then ``master += u``, the smaller leaves
through the eager plain formula), and one library call computing an Adam
update over the same leaves, ``torch.optim.Adam(fused=True).step()`` on
float32 parameters and gradients, as a yardstick only (the port never
calls it).

``--ab OLD.cu`` builds another revision's ``fused_update.cu`` whose C
entry point is the per-leaf ``tpudist_fused_adamw`` (the parent's, e.g.
``git show HEAD~1:tpudist_torch/csrc/fused_update.cu > scratch_chip/OLD.cu``)
and times its step, in that per-leaf structure, as A against this
checkout's step as B, in turns (A, B, B, A), each side held bit-equal to
the plain step first.

Each time is the median of ``n`` runs between two CUDA events, with the
card held busy by a spin kernel while the host enqueues the run (the
plain step is thousands of small launches, milliseconds of host time) and
the L2 flushed before each; the spin is sized from :func:`enqueue_check` to
outlast the enqueue three times over (:func:`spin_for`). A run of more
launches than the launch queue holds ahead of the card still leaves the
card waiting on the host between them, so each run's busy time
(:func:`busy_ms`, from a profiler trace) is printed too: for the
one-launch step the two agree, for the per-leaf structure and the plain
step the busy time is their device work.

``--guard`` runs the non-finite update guard (``--amp``) over ViT-B/16's
152 leaves (:func:`guard_check`): a step fed one inf leaves every state
tensor bit-identical and is counted as skipped, the next finite step is
bit-identical to an optimizer that never saw the bad batch, and the
guarded step's device time (the check launch and the update) stands
beside the unguarded one's and the check's alone.

The bound is the larger of the bytes one step must move (g 2 B, m, v, p
12 B read; m', v', p' 12 B, copy 2 B written: 28 B per element) over the
H100 SXM's 3.35 TB/s and its float32 operations (14 per element without
weight decay, 16 with) over 67 TFLOP/s.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import statistics
import subprocess
import time
from pathlib import Path

import torch

from tpudist_torch.ops import decode_bench as DB
from tpudist_torch.ops import fused_update as FU

#: about 50 ms at the H100's clock, the unit of :func:`spin_for`
SPIN_CYCLES = 100_000_000
HP = dict(b1=0.9, b2=0.999, eps=1e-8)
SCALARS = (1e-3, 0.271, 0.002997)  # lr, b1c, b2c of an early step


def resnet50_leaves() -> list[torch.Tensor]:
    """All of ResNet-50's parameters on the card, in the training path's
    layouts (channels-last conv weights)."""
    from tpudist_torch.models.resnet import resnet50

    return [p.detach() for p in resnet50(device="cuda").parameters()]


def gpt2_leaves() -> list[torch.Tensor]:
    """All of GPT-2 124M's parameters on the card."""
    from tpudist_torch.models.gpt2 import GPT2

    return [p.detach() for p in GPT2(device="cuda").parameters()]


def vit_leaves(depth: int = 12) -> list[torch.Tensor]:
    """ViT-B/16's parameters on the card as ``main.py --model vit_b16``
    builds it (4-pixel patches, 32x32 images: 152 leaves at depth 12)."""
    from tpudist_torch.models.vit import vit_b16

    return [p.detach() for p in vit_b16(patch_size=4, image_size=32,
                                        depth=depth,
                                        device="cuda").parameters()]


def random_state(leaves, gen: torch.Generator, *, g_dtype, copy_dtype,
                 wd: float) -> dict:
    """Random gradients, moments and masters in each leaf's layout, a
    zeroed copy of ``copy_dtype`` (or None), and each leaf's decay: ``wd``
    on leaves of more than one dimension, 0 on the rest (``decay_mask``)."""
    def like(p, dtype, scale=1.0, positive=False):
        t = torch.empty_like(p, dtype=torch.float32)
        src = torch.rand if positive else torch.randn
        t.copy_(src(p.shape, generator=gen, device=p.device) * scale)
        return t.to(dtype)

    return dict(
        g=[like(p, g_dtype, 0.1) for p in leaves],
        m=[like(p, torch.float32, 0.01) for p in leaves],
        v=[like(p, torch.float32, 1e-3, positive=True) for p in leaves],
        p=[like(p, torch.float32) for p in leaves],
        copy=[None if copy_dtype is None else
              torch.zeros_like(p, dtype=copy_dtype) for p in leaves],
        wd=[wd if p.ndim > 1 else 0.0 for p in leaves])


def table(state: dict) -> FU.AdamWTable:
    """An :class:`FU.AdamWTable` over fresh clones of ``state``'s moments,
    masters and copies (so several tables start from the same values)."""
    clone = lambda ts: [None if t is None else t.clone() for t in ts]
    return FU.AdamWTable(clone(state["m"]), clone(state["v"]),
                         clone(state["p"]), clone(state["copy"]),
                         state["wd"])


def compare(got: FU.AdamWTable, want: FU.AdamWTable) -> tuple[bool, float]:
    """``(bit-equal, max abs difference)`` over every leaf's m, v, master
    and copy."""
    torch.cuda.synchronize()
    equal, err = True, 0.0
    for name in ("m", "v", "p", "copy"):
        for a, b in zip(getattr(got, name), getattr(want, name)):
            if a is None:
                continue
            equal &= bool(torch.equal(a, b))
            err = max(err, float((a.float() - b.float()).abs().max()))
    return equal, err


#: phase 7's ragged list: leaf sizes around the vector width and the
#: per-leaf threshold; :func:`step_parity` adds a leaf that starts one
#: element into its buffers
RAGGED = (1, 7, 1023, 1027, 9001)


def ragged_leaves(dev) -> list[torch.Tensor]:
    """Leaves of :data:`RAGGED` elements and a last one of 37 x 111 (a
    decayed leaf, for :func:`step_parity`'s ``misalign_last``)."""
    return [torch.empty(n, device=dev) for n in RAGGED] + [
        torch.empty(37, 111, device=dev)]


def long_leaves(dev, gen: torch.Generator, n: int = 600) -> list[torch.Tensor]:
    """``n`` leaves of 1..5000 elements: more than one launch's table."""
    sizes = torch.randint(1, 5001, (n,), generator=gen, device=dev).tolist()
    return [torch.empty(k, device=dev) for k in sizes]


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """``t``'s values in a view that starts one element into its buffer."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return buf[1:].view(t.shape).copy_(t)


def step_parity(leaves, gen, *, g_dtype, copy_dtype, wd: float,
                misalign_last: bool = False) -> dict:
    """One optimizer-mode step of the kernel against the plain step from
    the same state: bit-equality of m', v', the master and the copy, the
    largest difference and the launches it took. ``misalign_last``: the
    last leaf's tensors start one element into their buffers (its
    element-wise path)."""
    state = random_state(leaves, gen, g_dtype=g_dtype, copy_dtype=copy_dtype,
                         wd=wd)
    kt, pt = table(state), table(state)
    if misalign_last:
        for tab in (kt, pt):
            for name in ("m", "v", "p", "copy"):
                ts = getattr(tab, name)
                if ts[-1] is not None:
                    ts[-1] = _misaligned(ts[-1])
        state["g"][-1] = _misaligned(state["g"][-1])
        kt, pt = (FU.AdamWTable(t.m, t.v, t.p, t.copy, t.wd)
                  for t in (kt, pt))
    FU.reset_launch_counts()
    FU.fused_adamw_step_cuda(kt, state["g"], *SCALARS, **HP)
    counts = dict(FU.launch_counts)
    FU.fused_adamw_step_plain(pt, state["g"], *SCALARS, **HP)
    equal, err = compare(kt, pt)
    return dict(equal=equal, err=err, **counts)


def per_leaf_step(tab: FU.AdamWTable, grads, kernel) -> None:
    """The optimizer step as it ran before the multi-tensor launch: for a
    leaf of at least ``MIN_KERNEL_ELEMS`` elements ``kernel(g, m, v, p,
    copy, wd)`` launches a per-leaf kernel that writes m', v' and the copy
    in place and returns u, for a smaller one the eager plain formula;
    then ``master += u`` for each."""
    for g, m, v, p, c, wd in zip(grads, tab.m, tab.v, tab.p, tab.copy,
                                 tab.wd):
        if p.numel() >= FU.MIN_KERNEL_ELEMS:
            u = kernel(g, m, v, p, c, wd)
        else:
            u, m2, v2, cp = FU.fused_leaf_update_plain(
                g, m, v, p, *SCALARS, wd=wd,
                compute_dtype=None if c is None else c.dtype, **HP)
            m.copy_(m2)
            v.copy_(v2)
            if c is not None:
                c.copy_(cp)
        p.add_(u)


def leaf_kernel(g, m, v, p, c, wd):
    """This checkout's kernel in leaf mode, as :func:`per_leaf_step`'s
    ``kernel``."""
    return FU.fused_leaf_update_cuda(g, m, v, p, *SCALARS, wd=wd, m_out=m,
                                     v_out=v, copy_out=c, **HP)[0]


def old_kernel(source: Path):
    """:func:`per_leaf_step`'s ``kernel`` built from another revision's
    ``fused_update.cu`` with the per-leaf entry point
    ``tpudist_fused_adamw(g_dtype, copy_dtype, g, m, v, p, u, m_out, v_out,
    copy, n, b1, 1 - b1, b2, 1 - b2, eps, wd, lr, b1c, b2c, stream)``."""
    from tpudist_torch.csrc import build

    lib = build.load(str(source.resolve()))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tpudist_fused_adamw.argtypes = [
        I, I, P, P, P, P, P, P, P, P, ctypes.c_longlong, *[F] * 9, P]
    lib.tpudist_fused_adamw.restype = I

    def kernel(g, m, v, p, c, wd):
        u = torch.empty_like(p)
        rc = lib.tpudist_fused_adamw(
            FU._G_CODE[g.dtype], FU._COPY_CODE[None if c is None else c.dtype],
            g.data_ptr(), m.data_ptr(), v.data_ptr(), p.data_ptr(),
            u.data_ptr(), m.data_ptr(), v.data_ptr(),
            None if c is None else c.data_ptr(), p.numel(), HP["b1"],
            1.0 - HP["b1"], HP["b2"], 1.0 - HP["b2"], HP["eps"], wd,
            *SCALARS, torch.cuda.current_stream().cuda_stream)
        build.check(lib, rc, "fused_adamw (A)")
        return u
    return kernel


def step_case(leaves, gen: torch.Generator, *, g_dtype=torch.bfloat16,
              copy_dtype=torch.bfloat16, wd: float = 0.0) -> dict:
    """Callables that each run one optimizer step over every leaf, from
    the same random state, each on its own tables: ``kernel`` is
    ``FusedAdamW.step`` (one multi-tensor launch), ``plain`` its plain
    version, ``per_leaf`` the per-leaf structure with this checkout's
    kernel in leaf mode, ``library`` ``torch.optim.Adam(fused=True)``;
    with the parity of the kernel's step against the plain step, the
    bytes and the bound."""
    from tpudist_torch.optim import fused_adamw

    state = random_state(leaves, gen, g_dtype=g_dtype, copy_dtype=copy_dtype,
                         wd=wd)
    params = {str(i): p.clone() for i, p in enumerate(state["p"])}
    tx = fused_adamw(SCALARS[0], weight_decay=wd, compute_dtype=copy_dtype,
                     mask=(lambda ps: {k: t.ndim > 1 for k, t in ps.items()})
                     if wd else None)
    opt = tx.init(params)
    grads = dict(zip(params, state["g"]))
    parity = step_parity(leaves, gen, g_dtype=g_dtype, copy_dtype=copy_dtype,
                         wd=wd)
    plain_tab, leaf_tab = table(state), table(state)

    lib_params = [p.clone().requires_grad_() for p in state["p"]]
    for lp, g in zip(lib_params, state["g"]):
        lp.grad = g.float()
    adam = torch.optim.Adam(lib_params, lr=SCALARS[0], betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=0.0, fused=True)

    n = sum(p.numel() for p in leaves)
    per_elem = 12 + 12 + g_dtype.itemsize + (
        0 if copy_dtype is None else copy_dtype.itemsize)
    return dict(
        kernel=lambda: tx.step(opt, params, grads),
        plain=lambda: FU.fused_adamw_step_plain(plain_tab, state["g"],
                                                *SCALARS, **HP),
        per_leaf=lambda: per_leaf_step(leaf_tab, state["g"], leaf_kernel),
        library=adam.step, state=state, leaves=len(leaves), elements=n,
        bytes=n * per_elem, parity=parity,
        shape=f"all {len(leaves)} leaves of ResNet-50 ({n} elements), g "
              f"{str(g_dtype).split('.')[-1]}, copy "
              f"{str(copy_dtype).split('.')[-1]}, wd {wd}",
        **DB.bound(n * per_elem, n * (16 if wd else 14)),
    )


def guard_check(leaves, gen: torch.Generator, flush=None) -> dict:
    """The ``--amp`` guard around the fused optimizer over ``leaves`` (bf16
    gradients and copy, decay 0.1 masked off 1-D leaves): a step whose
    gradients hold one inf, then a finite one, against an unguarded
    optimizer fed only the finite step. Returns whether the skipped step
    left m, v, the masters and the copy bit-identical, the skip count and
    the step count after it, the launches it took, whether the next step
    equals the unguarded one to the bit, and with ``flush`` the device ms
    of the guarded step, the unguarded step and the check launch alone,
    with the check's byte bound."""
    from tpudist_torch.amp import skipped_steps
    from tpudist_torch.optim import make_optimizer

    state = random_state(leaves, gen, g_dtype=torch.bfloat16,
                         copy_dtype=None, wd=0.0)
    kw = dict(fused=True, weight_decay=0.1, compute_dtype=torch.bfloat16)
    guarded = make_optimizer(SCALARS[0], skip_nonfinite_updates=True, **kw)
    unguarded = make_optimizer(SCALARS[0], **kw)
    params = {f"l{i}": p.clone() for i, p in enumerate(state["p"])}
    clean = {k: p.clone() for k, p in params.items()}
    st, cst = guarded.init(params), unguarded.init(clean)
    good = dict(zip(params, state["g"]))
    bad = dict(good)
    k_bad = list(params)[len(params) // 2]
    bad[k_bad] = good[k_bad].clone()
    bad[k_bad].view(-1)[bad[k_bad].numel() // 3] = float("inf")

    def snapshot():
        inner = st.inner
        return [t.clone() for d in (inner.mu, inner.nu, inner.master, params)
                for t in d.values()]

    before = snapshot()
    FU.reset_launch_counts()
    guarded.step(st, params, bad)
    launches = dict(FU.launch_counts)
    torch.cuda.synchronize()
    unchanged = all(torch.equal(a, b) for a, b in zip(snapshot(), before))
    skipped, count = skipped_steps(st), st.inner.count
    guarded.step(st, params, good)
    unguarded.step(cst, clean, good)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(
        [*st.inner.mu.values(), *st.inner.nu.values(),
         *st.inner.master.values(), *params.values()],
        [*cst.mu.values(), *cst.nu.values(), *cst.master.values(),
         *clean.values()]))
    out = dict(unchanged=unchanged, skipped=skipped, count=count,
               launches=launches, next_equal=same,
               skipped_after=skipped_steps(st), count_after=st.inner.count)
    if flush is not None:
        grads = [good[k] for k in st.inner.names]
        n = sum(g.numel() for g in grads)
        out.update(
            guarded_ms=timed_ms(lambda: guarded.inner.step(
                st.inner, params, good, guard=True), flush),
            unguarded_ms=timed_ms(lambda: unguarded.step(cst, clean, good),
                                  flush),
            check_ms=timed_ms(lambda: FU.nonfinite_check_cuda(
                st.inner.table, grads, st.inner.nonfinite), flush),
            check_bound=DB.bound(2 * n, n), elements=n)
    return out


def enqueue_check(fn, spin_cycles: int = SPIN_CYCLES) -> tuple[float, float]:
    """``(host ms to enqueue one fn(), device ms of the spin)``: the spin
    must be the longer for :func:`DB.device_ms` to time device work only."""
    torch.cuda.synchronize()
    hosts = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        hosts.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    start.record()
    torch.cuda._sleep(spin_cycles)
    end.record()
    torch.cuda.synchronize()
    return statistics.median(hosts), start.elapsed_time(end)


def busy_ms(fn) -> tuple[float, int]:
    """``(ms the card is busy during one fn(), device activities)``: the
    union of the kernel, copy and fill intervals of a ``torch.profiler``
    trace of the call. Unlike :func:`DB.device_ms` it leaves out the gaps
    in which the card waits for the host, which a call of more launches
    than the launch queue holds ahead of the card has even behind the
    spin."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, len(spans)


def spin_for(host_ms: float, spin_ms: float) -> int:
    """Spin cycles that outlast ``host_ms`` of enqueue three times over,
    in whole multiples of :data:`SPIN_CYCLES` (which spun ``spin_ms``):
    the host's time to enqueue thousands of launches varies run to run."""
    return SPIN_CYCLES * max(1, math.ceil(3 * host_ms / spin_ms))


def timed_ms(fn, flush) -> float:
    """:func:`DB.device_ms` of ``fn`` behind a spin sized to outlast its
    enqueue (:func:`spin_for`)."""
    return DB.device_ms(fn, flush, spin_cycles=spin_for(*enqueue_check(fn)))


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def ab(old: Path, flush) -> dict:
    """The step built from ``old`` in the per-leaf structure (A) against
    this checkout's ``FusedAdamW.step`` (B), in turns (A, B, B, A), each
    held bit-equal to the plain step from the same state first."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    leaves = resnet50_leaves()
    state = random_state(leaves, gen, g_dtype=torch.bfloat16,
                         copy_dtype=torch.bfloat16, wd=0.0)
    kernel_a = old_kernel(old)
    want = table(state)
    FU.fused_adamw_step_plain(want, state["g"], *SCALARS, **HP)
    tabs = {"A": table(state), "B": table(state)}
    steps = {"A": lambda: per_leaf_step(tabs["A"], state["g"], kernel_a),
             "B": lambda: FU.fused_adamw_step(tabs["B"], state["g"],
                                              *SCALARS, **HP)}
    equal = {}
    for who, fn in steps.items():
        fn()
        equal[who] = compare(tabs[who], want)[0]
    ms = {"A": [], "B": []}
    for who in "ABBA":
        ms[who].append(timed_ms(steps[who], flush))
    return dict(ms=ms, equal=equal, leaves=len(leaves),
                busy={who: busy_ms(fn) for who, fn in steps.items()})


def guard_ok(r: dict) -> bool:
    return (r["unchanged"] and r["skipped"] == 1 and r["count"] == 0
            and r["launches"]["fused_adamw"] == 1
            and r["launches"]["fused_adamw_check"] == 1 and r["next_equal"]
            and r["skipped_after"] == 1 and r["count_after"] == 1)


def guard_line(r: dict, smi: str) -> str:
    line = (f"guard: the step with one inf left m, v, masters and copy "
            f"bit-identical {r['unchanged']}, skipped {r['skipped']}, count "
            f"{r['count']}, launches {r['launches']}; the next step "
            f"bit-identical to an optimizer that never saw it "
            f"{r['next_equal']} (skipped {r['skipped_after']}, count "
            f"{r['count_after']})")
    if "guarded_ms" in r:
        b = r["check_bound"]
        line += (f"\n  step over {r['elements']} elements, bf16 g and copy: "
                 f"guarded {r['guarded_ms']:.4f} ms, unguarded "
                 f"{r['unguarded_ms']:.4f} ms, the check alone "
                 f"{r['check_ms']:.4f} ms (bound {b['bound_ms']:.4f} ms, "
                 f"{b['bound_by']})  [{smi}]")
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpudist_torch.ops.fused_update_bench")
    ap.add_argument("--ab", type=Path, default=None, metavar="OLD.cu",
                    help="only another revision's per-leaf step (A) against "
                    "this checkout's (B), in turns")
    ap.add_argument("--guard", action="store_true",
                    help="only the --amp guard at ViT-B/16's leaves")
    args = ap.parse_args(argv)
    smi = card()
    print(smi)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    if args.guard:
        r = guard_check(vit_leaves(), torch.Generator(device="cuda").manual_seed(2),
                        flush)
        print(guard_line(r, smi))
        return 0 if guard_ok(r) else 1
    if args.ab:
        r = ab(args.ab, flush)
        a, b = r["ms"]["A"], r["ms"]["B"]
        print(f"fused_adamw step over ResNet-50's {r['leaves']} leaves, bf16 "
              f"g and copy: {args.ab} per-leaf (A) {a[0]:.4f} / {a[1]:.4f} "
              f"ms, this checkout (B) {b[0]:.4f} / {b[1]:.4f} ms (turns A B B "
              f"A); A / B {sum(a) / sum(b):.2f}x; bit-equal to the plain "
              f"step: {r['equal']}  [{smi}]")
        print("  card busy over one call (profiler): " + ", ".join(
            f"{w} {b:.4f} ms in {k} activities"
            for w, (b, k) in r["busy"].items()))
        return 0 if all(r["equal"].values()) else 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    case = step_case(resnet50_leaves(), gen)
    par = case["parity"]
    names = ("kernel", "per_leaf", "plain", "library")
    times = {name: timed_ms(case[name], flush) for name in names}
    busy = {name: busy_ms(case[name]) for name in names}
    print(f"fused_adamw [{case['shape']}]: step {times['kernel']:.4f} ms "
          f"({par['fused_adamw']} launch, {par['fused_adamw_leaves']} "
          f"leaves), bound {case['bound_ms']:.4f} ms ({case['bound_by']}), "
          f"per-leaf structure {times['per_leaf']:.4f} ms, plain "
          f"{times['plain']:.4f} ms, library {times['library']:.4f} ms; "
          f"bit-equal to the plain step {par['equal']} (max_abs_err "
          f"{par['err']:.3e})  [{smi}]")
    print("  card busy over one call (profiler): " + ", ".join(
        f"{n} {b:.4f} ms in {k} activities" for n, (b, k) in busy.items()))
    return 0 if par["equal"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
