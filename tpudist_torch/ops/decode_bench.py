"""Device times of the decode-attention kernels at the serving path's shapes.

    python -m tpudist_torch.ops.decode_bench               # this checkout's kernels
    python -m tpudist_torch.ops.decode_bench --ab OLD.cu   # A/B against another
                                                           # source of the same C interface
    python -m tpudist_torch.ops.decode_bench --sweep       # over cursors, L2 cold and warm
    python -m tpudist_torch.ops.decode_bench --parity      # chip_smoke.py's phase 2 cases

The timed shapes are the main path's (the paged kernel at the served
batch's cursors, the contiguous kernel at ``generate()``'s last step) and
cursor 1023 (eight paged rows, and B 4 contiguous), each beside its bound
and SDPA.

Each time is the median of ``n`` launches, each between two CUDA events.
Before every launch a spin kernel holds the card while the host enqueues
an L2 flush, the start event, the launch and the end event, so the window
holds device time only — never the Python wrapper's host time, which is
longer than these kernels — and each launch finds its K/V cold in HBM, as
a decode step does (12 layers' weights and caches pass between two
launches on the same layer's cache). The A/B runs the two builds in turns
(A, B, B, A) on the same inputs.

The bound of a call is the larger of the bytes it must move (q, the K/V
slots up to each cursor, the block-table entries walked, the output) over
the H100 SXM's 3.35 TB/s and its f32 operations over 67 TFLOP/s (NVIDIA
data sheet, dense).
"""

from __future__ import annotations

import argparse
import functools
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from tpudist_torch.ops import decode as D

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
SPIN_CYCLES = 2_000_000  # about 1 ms at the H100's clock: longer than any enqueue
N_TIMED = 50
VOCAB = 50257


def smoke_prompts(seed: int = 0, n: int = 8) -> list[np.ndarray]:
    """The served batch of ``chip_smoke.py``: ``n`` prompts of 16..128
    tokens drawn from ``seed``."""
    rng = np.random.Generator(np.random.PCG64(seed))
    lens = rng.integers(16, 129, n)
    return [rng.integers(0, VOCAB, (int(k),)).astype(np.int32) for k in lens]


def device_ms(fn, flush, n: int = N_TIMED,
              spin_cycles: int = SPIN_CYCLES) -> float:
    """Median device time of ``fn()`` over ``n`` launches (module
    docstring); ``spin_cycles`` must outlast the host's enqueue of
    ``fn``."""
    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    for s, e in zip(starts, ends):
        torch.cuda._sleep(spin_cycles)
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def bound(nbytes: int, flops: int) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def paged_case(gen, cursors, *, dtype=torch.bfloat16, heads=12, dh=64,
               bs=32, max_len=1024, s_q=1) -> dict:
    """One decode tick of the paged engine: q ``[B, s_q, H, dh]`` at the
    given cursors (``s_q`` 1 for a decode step, ``spec_k + 1`` for a
    speculative verify pass, causal within the window), a pool of the
    engine's default size (``B`` slots of ``max_len`` plus the garbage
    block), random permuted tables."""
    dev = torch.device("cuda")
    b, mb = len(cursors), max_len // bs
    n_pool = b * mb + 1
    rnd = lambda *shape: torch.randn(*shape, generator=gen).to(dev, dtype)
    kp, vp = rnd(n_pool, heads, bs, dh), rnd(n_pool, heads, bs, dh)
    q = rnd(b, s_q, heads, dh)
    tables = (torch.randperm(n_pool - 1, generator=gen)[: b * mb] + 1) \
        .reshape(b, mb).to(dev, torch.int32)
    cur = np.asarray(cursors, np.int64)
    pos = torch.from_numpy(cur.astype(np.int32)).to(dev)
    item = q.element_size()
    # each row reads K/V up to its window's last position once; query row
    # i scores cursor + i + 1 slots
    slots = int((cur + s_q).sum())
    scored = int(sum((c + i + 1) for c in cur for i in range(s_q)))
    walked = int(((cur + s_q - 1) // bs + 1).sum())
    nbytes = (2 * heads * slots * dh * item + 2 * q.numel() * item
              + 4 * (walked + b))
    # the library yardstick: SDPA over each row's gathered window, masked
    kwin = kp[tables.long()].transpose(1, 2).reshape(b, heads, max_len, dh)
    vwin = vp[tables.long()].transpose(1, 2).reshape(b, heads, max_len, dh)
    rows = pos[:, None].long() + torch.arange(s_q, device=dev)[None, :]
    mask = (torch.arange(max_len, device=dev)[None, None, :]
            <= rows[:, :, None])[:, None]
    qh = q.transpose(1, 2)
    args = (q, kp, vp, tables, pos)
    return dict(
        name="paged_decode_attention", args=args,
        kernel=lambda lib=None: D.paged_fused_attention_cuda(*args, lib=lib),
        plain=lambda: D.paged_fused_attention_plain(*args),
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kwin, vwin, attn_mask=mask),
        shape=f"B {b}, H {heads}, dh {dh}, bs {bs}, {n_pool}-block pool, "
              f"{f's_q {s_q}, ' if s_q > 1 else ''}cursors {cur.tolist()}",
        **bound(nbytes, 4 * dh * heads * scored),
    )


def contiguous_case(gen, *, b=4, pos=95, dtype=torch.bfloat16, heads=12,
                    dh=64, max_len=1024) -> dict:
    """One ``generate()`` decode step: q ``[B, 1, H, dh]`` over the
    contiguous ``[B, H, max_len, dh]`` cache at cursor ``pos``."""
    dev = torch.device("cuda")
    rnd = lambda *shape: torch.randn(*shape, generator=gen).to(dev, dtype)
    k, v = rnd(b, heads, max_len, dh), rnd(b, heads, max_len, dh)
    q = rnd(b, 1, heads, dh)
    item = q.element_size()
    nbytes = 2 * b * heads * (pos + 1) * dh * item + 2 * q.numel() * item
    qh = q.transpose(1, 2)
    kwin, vwin = k[:, :, :pos + 1], v[:, :, :pos + 1]
    return dict(
        name="fused_decode_attention", args=(q, k, v, pos),
        kernel=lambda lib=None: D.fused_decode_attention_cuda(q, k, v, pos, lib=lib),
        plain=lambda: D.fused_decode_attention_plain(q, k, v, pos),
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kwin, vwin),
        shape=f"B {b}, H {heads}, dh {dh}, S {max_len}, pos {pos}",
        **bound(nbytes, 4 * dh * heads * b * (pos + 1)),
    )


def long_cases(seed: int = 0) -> list[dict]:
    """Both kernels at GPT-2's full context: eight paged rows at cursor
    1023, and B 4 contiguous at pos 1023."""
    gen = torch.Generator(device="cpu").manual_seed(seed + 1)
    return [paged_case(gen, [1023] * 8), contiguous_case(gen, pos=1023)]


def parity_cases(seed: int = 0):
    """Yield ``(name, kernel, plain)`` for every parity case of
    ``chip_smoke.py`` phase 2: contiguous B 8, H 12, S 1024 at pos 0 / 31 /
    1023, GQA H_kv 6, B 4 at pos 1023, dh 20, 80 (H_kv 4) and 128; paged
    bs 32 over a 1025-block pool with permuted tables, cursors at block
    start / end / mid-block / the table's end, GQA H_kv 6, s_q 5 and 16,
    dh 20, 80 (H_kv 4, s_q 3) and 128, and eight rows all at cursor 1023;
    float32 and bfloat16 throughout. Then the launch's other choices and
    limits: grids that fill the card (contiguous B 32 at pos 1023, one
    part a row; paged B 32 at s_q 16 over 4096-slot tables, whose scores
    fit only in two parts), a cursor past 40k (contiguous B 1, pos 65535)
    and pool blocks of 1024 slots at dh 256 and s_q 16."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    dev = torch.device("cuda")
    h, s_len, bs = 12, 1024, 32
    mb, n_pool = s_len // bs, 1025

    def rnd(*shape, dtype):
        return torch.randn(*shape, generator=gen).to(dev, dtype)

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for b, h_kv, dh, cursors in ((8, h, 64, (0, 31, 1023)),
                                     (8, h // 2, 64, (0, 31, 1023)),
                                     (4, h, 64, (1023,)),
                                     (8, h, 20, (31, 1023)),
                                     (8, 4, 80, (500,)),
                                     (8, h, 128, (95, 1023))):
            k = rnd(b, h_kv, s_len, dh, dtype=dtype)
            v = rnd(b, h_kv, s_len, dh, dtype=dtype)
            q = rnd(b, 1, h, dh, dtype=dtype)
            for pos in cursors:
                yield (f"contiguous {dn} B={b} H_kv={h_kv} dh={dh} pos={pos}",
                       functools.partial(D.fused_decode_attention_cuda,
                                         q, k, v, pos),
                       functools.partial(D.fused_decode_attention_plain,
                                         q, k, v, pos))
        for h_kv, s_q, dh, at_end in ((h, 1, 64, False), (h // 2, 1, 64, False),
                                      (h, 5, 64, False), (h, 16, 64, False),
                                      (h, 1, 20, False), (4, 3, 80, False),
                                      (h, 1, 128, False), (h, 1, 64, True)):
            kp = rnd(n_pool, h_kv, bs, dh, dtype=dtype)
            vp = rnd(n_pool, h_kv, bs, dh, dtype=dtype)
            q = rnd(8, s_q, h, dh, dtype=dtype)
            perm = torch.randperm(n_pool - 1, generator=gen)[: 8 * mb] + 1
            tables = perm.reshape(8, mb).to(dev, torch.int32)
            # block start, block end, mid-block, first and last slot
            cur = ([1023] * 8 if at_end
                   else [0, 31, 32, 63, 500, 777, 1023 - s_q + 1, 15])
            pos = torch.tensor(cur, dtype=torch.int32, device=dev)
            args = (q, kp, vp, tables, pos)
            yield (f"paged {dn} H_kv={h_kv} s_q={s_q} dh={dh} cursors="
                   f"{'1023 x 8' if at_end else 'mixed'}",
                   functools.partial(D.paged_fused_attention_cuda, *args),
                   functools.partial(D.paged_fused_attention_plain, *args))
        for b, n_slots in ((32, 1024), (1, 65536)):
            pos = n_slots - 1
            k = rnd(b, h, n_slots, 64, dtype=dtype)
            v = rnd(b, h, n_slots, 64, dtype=dtype)
            q = rnd(b, 1, h, 64, dtype=dtype)
            yield (f"contiguous {dn} B={b} S={n_slots} pos={pos}",
                   functools.partial(D.fused_decode_attention_cuda,
                                     q, k, v, pos),
                   functools.partial(D.fused_decode_attention_plain,
                                     q, k, v, pos))
        for b, hq, h_kv, dh, bsz, mbz, fixed in (
                (32, h, h, 64, 32, 128, [0, 31, 32, 63, 500, 1008, 4080]),
                (2, 4, 2, 256, 1024, 4, [1500, 4080])):
            n_blk = b * mbz + 1
            kp = rnd(n_blk, h_kv, bsz, dh, dtype=dtype)
            vp = rnd(n_blk, h_kv, bsz, dh, dtype=dtype)
            q = rnd(b, 16, hq, dh, dtype=dtype)
            perm = torch.randperm(n_blk - 1, generator=gen)[: b * mbz] + 1
            tables = perm.reshape(b, mbz).to(dev, torch.int32)
            cur = fixed + torch.randint(0, mbz * bsz - 15, (b - len(fixed),),
                                        generator=gen).tolist()
            args = (q, kp, vp, tables,
                    torch.tensor(cur, dtype=torch.int32, device=dev))
            yield (f"paged {dn} B={b} H={hq} H_kv={h_kv} s_q=16 dh={dh} "
                   f"bs={bsz} max_blocks={mbz} cursors=mixed",
                   functools.partial(D.paged_fused_attention_cuda, *args),
                   functools.partial(D.paged_fused_attention_plain, *args))


def main_path_cases(seed: int = 0, new_tokens: int = 32) -> list[dict]:
    """The two kernels' timed shapes: the paged kernel at the served
    batch's cursors on its last decode tick, the contiguous kernel at
    ``generate()``'s last step (B 4, prompt 64)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    cursors = [len(p) + new_tokens - 1 for p in smoke_prompts(seed)]
    return [paged_case(gen, cursors),
            contiguous_case(gen, pos=64 + new_tokens - 1)]


#: the largest share of bf16 output elements that may differ from the
#: plain version (``chip_smoke.py`` phase 2): order-only differences of
#: the f32 score sums flip a rounding of p in about 0.02% of them, while
#: p rounded against another max than the function's moves ~40%
SHARE_BAR = 0.01


def parity(seed: int = 0) -> list[dict]:
    """Every :func:`parity_cases` case, the kernel against its plain
    version: the max abs error, the bar (the parity rule; for bf16 also
    ``lm_kernels_bench``'s element bar and at most :data:`SHARE_BAR` of
    elements differing), the share of differing elements and, for bf16,
    the error in ulps."""
    from tpudist_torch.ops import lm_kernels_bench as LB

    out = []
    for name, kernel, plain in parity_cases(seed):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err, ok = LB.max_err(got, want, elem=True)
        share = float((got != want).float().mean())
        bf16 = want.dtype == torch.bfloat16
        if bf16:
            ok = ok and share <= SHARE_BAR
        out.append(dict(name=name, err=err, ok=ok, share=share,
                        reading=LB.elem_reading(got, want) if bf16 else ""))
    return out


def repeat_identical(seed: int = 0) -> dict:
    """Whether two calls of each kernel at its main-path shape give
    bit-identical outputs (no atomics, fixed orders)."""
    return {c["name"]: bool(torch.equal(c["kernel"](), c["kernel"]()))
            for c in main_path_cases(seed)}


def build_report() -> tuple[list[str], list[str]]:
    """The decode kernels' registers and spills from the build's
    ``-Xptxas -v`` log, and the bf16 kernels that spill."""
    from tpudist_torch.csrc import build

    build.load()
    lines, spilled = [], []
    for k in build.register_report("decode_attention.cu"):
        lines.append(f"{k['kernel']}: {k['registers']} registers, "
                     f"{k.get('spill_stores', 0)} bytes spill stores, "
                     f"{k.get('spill_loads', 0)} bytes spill loads")
        if "bf16" in k["kernel"] and (k.get("spill_stores", 0)
                                      or k.get("spill_loads", 0)):
            spilled.append(k["kernel"])
    return lines, spilled


def in_turns(fa, fb, flush, n: int) -> tuple[list[float], list[float]]:
    """Device times of ``fa`` and ``fb`` in turns, A B B A."""
    ta, tb = [], []
    for who in "ABBA":
        t = device_ms(fa if who == "A" else fb, flush, n)
        (ta if who == "A" else tb).append(t)
    return ta, tb


def main(argv=None) -> int:
    from tpudist_torch.csrc import build

    ap = argparse.ArgumentParser()
    ap.add_argument("--ab", default=None,
                    help="another .cu source with the same C interface; "
                    "timed in turns against this checkout's kernels")
    ap.add_argument("--sweep", action="store_true",
                    help="time both kernels over cursors 0..1023 with the "
                    "L2 flushed and warm, beside the library call")
    ap.add_argument("--parity", action="store_true",
                    help="chip_smoke.py's phase 2: every parity case, the "
                    "build report and the repeat check")
    ap.add_argument("-n", type=int, default=N_TIMED)
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    if args.parity:
        lines, spilled = build_report()
        print("\n".join(lines))
        res = parity()
        for r in res:
            print(f"{r['name']}: max_abs_err {r['err']:.3e}, {r['share']:.4%} "
                  f"of elements differ {r['reading']} "
                  f"{'ok' if r['ok'] else 'FAIL'}")
        same = repeat_identical()
        print(f"two calls bit-identical: {same}  [{card}]")
        return 0 if all(r["ok"] for r in res) and all(same.values()) \
            and not spilled else 1
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    if args.sweep:
        return sweep(card, flush, args.n)
    other = build.load(str(Path(args.ab).resolve())) if args.ab else None
    for case in main_path_cases() + long_cases():
        want = case["plain"]()
        err = float((case["kernel"]().float() - want.float()).abs().max())
        line = (f"{case['name']} [{case['shape']}]: bound "
                f"{case['bound_ms'] * 1e3:.3f} us ({case['bound_by']}), "
                f"max_abs_err {err:.3e}")
        if other is None:
            t = device_ms(case["kernel"], flush, args.n)
            line += (f", kernel {t * 1e3:.2f} us, library "
                     f"{device_ms(case['library'], flush, args.n) * 1e3:.2f} us")
        else:
            err_b = float((case["kernel"](other).float() - want.float())
                          .abs().max())
            ta, tb = in_turns(case["kernel"], lambda: case["kernel"](other),
                              flush, args.n)
            line += (f", this checkout {[round(t * 1e3, 2) for t in ta]} us, "
                     f"{args.ab} {[round(t * 1e3, 2) for t in tb]} us "
                     f"(max_abs_err {err_b:.3e})")
        print(line + f"  [{card}]")
    return 0


def sweep(card: str, flush, n: int) -> int:
    """Kernel time against the cursor, with the L2 flushed (cold) and not
    (warm: a 1 KB "flush"), beside the library call and the bound; first
    the floor of the method, the time of a one-element kernel."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    warm = torch.empty(1024, dtype=torch.uint8, device="cuda")
    tiny = torch.empty(1, device="cuda")
    print(f"floor: one one-element zero_() between the same events "
          f"{device_ms(tiny.zero_, flush, n) * 1e3:.2f} us  [{card}]")
    cases = [contiguous_case(gen, pos=p) for p in (0, 95, 511, 1023)]
    cases += [paged_case(gen, [p] * 8) for p in (0, 31, 511, 1023)]
    for case in cases:
        cold = device_ms(case["kernel"], flush, n)
        hot = device_ms(case["kernel"], warm, n)
        lib = device_ms(case["library"], flush, n)
        print(f"{case['name']} [{case['shape']}]: kernel cold "
              f"{cold * 1e3:.2f} us, warm {hot * 1e3:.2f} us, library cold "
              f"{lib * 1e3:.2f} us, bound {case['bound_ms'] * 1e3:.3f} us "
              f"({case['bound_by']})  [{card}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
