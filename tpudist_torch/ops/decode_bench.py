"""Device times of the decode-attention kernels at the serving path's shapes.

    python -m tpudist_torch.ops.decode_bench               # this checkout's kernels
    python -m tpudist_torch.ops.decode_bench --ab OLD.cu   # A/B against another
                                                           # source of the same C interface
    python -m tpudist_torch.ops.decode_bench --sweep       # over cursors, L2 cold and warm

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
               bs=32, max_len=1024) -> dict:
    """One decode tick of the paged engine: q ``[B, 1, H, dh]`` at the
    given cursors, a pool of the engine's default size (``B`` slots of
    ``max_len`` plus the garbage block), random permuted tables."""
    dev = torch.device("cuda")
    b, mb = len(cursors), max_len // bs
    n_pool = b * mb + 1
    rnd = lambda *shape: torch.randn(*shape, generator=gen).to(dev, dtype)
    kp, vp = rnd(n_pool, heads, bs, dh), rnd(n_pool, heads, bs, dh)
    q = rnd(b, 1, heads, dh)
    tables = (torch.randperm(n_pool - 1, generator=gen)[: b * mb] + 1) \
        .reshape(b, mb).to(dev, torch.int32)
    cur = np.asarray(cursors, np.int64)
    pos = torch.from_numpy(cur.astype(np.int32)).to(dev)
    item = q.element_size()
    slots = int((cur + 1).sum())
    walked = int((cur // bs + 1).sum())
    nbytes = (2 * heads * slots * dh * item + 2 * q.numel() * item
              + 4 * (walked + b))
    # the library yardstick: SDPA over each row's gathered window, masked
    kwin = kp[tables.long()].transpose(1, 2).reshape(b, heads, max_len, dh)
    vwin = vp[tables.long()].transpose(1, 2).reshape(b, heads, max_len, dh)
    mask = (torch.arange(max_len, device=dev)[None, :]
            <= pos[:, None].long())[:, None, None, :]
    qh = q.transpose(1, 2)
    args = (q, kp, vp, tables, pos)
    return dict(
        name="paged_decode_attention", args=args,
        kernel=lambda lib=None: D.paged_fused_attention_cuda(*args, lib=lib),
        plain=lambda: D.paged_fused_attention_plain(*args),
        library=lambda: torch.nn.functional.scaled_dot_product_attention(
            qh, kwin, vwin, attn_mask=mask),
        shape=f"B {b}, H {heads}, dh {dh}, bs {bs}, {n_pool}-block pool, "
              f"cursors {cur.tolist()}",
        **bound(nbytes, 4 * dh * heads * slots),
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


def main_path_cases(seed: int = 0, new_tokens: int = 32) -> list[dict]:
    """The two kernels' timed shapes: the paged kernel at the served
    batch's cursors on its last decode tick, the contiguous kernel at
    ``generate()``'s last step (B 4, prompt 64)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    cursors = [len(p) + new_tokens - 1 for p in smoke_prompts(seed)]
    return [paged_case(gen, cursors),
            contiguous_case(gen, pos=64 + new_tokens - 1)]


def main(argv=None) -> int:
    from tpudist_torch.csrc import build

    ap = argparse.ArgumentParser()
    ap.add_argument("--ab", default=None,
                    help="another .cu source with the same C interface; "
                    "timed in turns against this checkout's kernels")
    ap.add_argument("--sweep", action="store_true",
                    help="time both kernels over cursors 0..1023 with the "
                    "L2 flushed and warm, beside the library call")
    ap.add_argument("-n", type=int, default=N_TIMED)
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    if args.sweep:
        return sweep(card, flush, args.n)
    other = build.load(str(Path(args.ab).resolve())) if args.ab else None
    for case in main_path_cases():
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
            ta, tb = [], []
            for who in "ABBA":
                lib = None if who == "A" else other
                t = device_ms(lambda: case["kernel"](lib), flush, args.n)
                (ta if who == "A" else tb).append(t)
            line += (f", this checkout {[round(t * 1e3, 2) for t in ta]} us, "
                     f"{args.ab} {[round(t * 1e3, 2) for t in tb]} us "
                     f"(max_abs_err {err_b:.3e})")
        print(line + f"  [{card}]")
    return 0


def sweep(card: str, flush, n: int) -> int:
    """Kernel time against the cursor, with the L2 flushed (cold) and not
    (warm: a 1 KB "flush"), beside the library call and the bound."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    warm = torch.empty(1024, dtype=torch.uint8, device="cuda")
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
