"""Device time of the fused-AdamW kernel over one ResNet-50 optimizer step.

    python -m tpudist_torch.ops.fused_update_bench     # on the card

The timed unit is what ``--fused optimizer --bf16`` runs each step: one
launch for each of ResNet-50's 76 leaves of at least ``MIN_KERNEL_ELEMS``
elements (25,533,632 elements, in the model's own layouts), with a bf16
gradient and a bf16 compute copy. Beside it: the plain version over the
same leaves, and one library call computing an Adam update over them,
``torch.optim.Adam(fused=True).step()`` on float32 parameters and
gradients, as a yardstick only (the port never calls it).

Each time is the median of ``n`` runs between two CUDA events, with the
card held busy by a spin kernel while the host enqueues the run (76
wrapper calls take milliseconds of host time) and the L2 flushed before
each; :func:`enqueue_check` shows the spin outlasts the enqueue.

The bound is the larger of the bytes one step must move (g 2 B, m, v, p
12 B read; u, m', v' 12 B, copy 2 B written: 28 B per element) over the
H100 SXM's 3.35 TB/s and its float32 operations (14 per element without
weight decay, 16 with) over 67 TFLOP/s.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

from tpudist_torch.ops import decode_bench as DB
from tpudist_torch.ops import fused_update as FU

#: about 50 ms at the H100's clock: longer than enqueueing the plain
#: version's ~1,000 small launches
SPIN_CYCLES = 100_000_000
HP = dict(b1=0.9, b2=0.999, eps=1e-8)
SCALARS = (1e-3, 0.271, 0.002997)  # lr, b1c, b2c of an early step


def resnet50_leaves() -> list[torch.Tensor]:
    """ResNet-50's kernel-eligible parameters on the card, in the
    training path's layouts (channels-last conv weights)."""
    from tpudist_torch.models.resnet import resnet50

    model = resnet50(device="cuda")
    return [p.detach() for p in model.parameters()
            if p.numel() >= FU.MIN_KERNEL_ELEMS]


def step_case(leaves, gen: torch.Generator, *, g_dtype=torch.bfloat16,
              copy_dtype=torch.bfloat16, wd: float = 0.0) -> dict:
    """Inputs for every leaf, and ``kernel``/``plain``/``library``
    callables that each update them all once. ``kernel`` and ``plain``
    return the ``(u, m', v', copy)`` of every leaf; they write separate
    outputs, so repeated calls see the same inputs."""
    def like(p, dtype, scale=1.0, positive=False):
        t = torch.empty_like(p, dtype=torch.float32)
        src = torch.rand if positive else torch.randn
        t.copy_(src(p.shape, generator=gen) * scale)
        return t.to(dtype)

    sets = []
    for p in leaves:
        s = dict(g=like(p, g_dtype, 0.1), m=like(p, torch.float32, 0.01),
                 v=like(p, torch.float32, 1e-3, positive=True),
                 p=like(p, torch.float32))
        s["m_out"], s["v_out"] = torch.empty_like(s["m"]), torch.empty_like(s["v"])
        s["copy"] = (None if copy_dtype is None
                     else torch.empty_like(s["p"], dtype=copy_dtype))
        sets.append(s)

    def kernel():
        return [FU.fused_leaf_update_cuda(
            s["g"], s["m"], s["v"], s["p"], *SCALARS, wd=wd, m_out=s["m_out"],
            v_out=s["v_out"], copy_out=s["copy"], **HP) for s in sets]

    def plain():
        return [FU.fused_leaf_update_plain(
            s["g"], s["m"], s["v"], s["p"], *SCALARS, wd=wd,
            compute_dtype=copy_dtype, **HP) for s in sets]

    lib_params = [s["p"].clone().requires_grad_() for s in sets]
    for lp, s in zip(lib_params, sets):
        lp.grad = s["g"].float()
    adam = torch.optim.Adam(lib_params, lr=SCALARS[0], betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=0.0, fused=True)

    n = sum(p.numel() for p in leaves)
    per_elem = 12 + 12 + g_dtype.itemsize + (
        0 if copy_dtype is None else copy_dtype.itemsize)
    return dict(
        kernel=kernel, plain=plain, library=adam.step, leaves=len(leaves),
        elements=n, bytes=n * per_elem,
        shape=f"ResNet-50's {len(leaves)} leaves >= {FU.MIN_KERNEL_ELEMS} "
              f"elements ({n} elements), g {str(g_dtype).split('.')[-1]}, "
              f"copy {str(copy_dtype).split('.')[-1]}, wd {wd}",
        **DB.bound(n * per_elem, n * (16 if wd else 14)),
    )


def max_err(got, want) -> float:
    """Largest absolute difference over every leaf's u, m' and v'."""
    return max(float((a.float() - b.float()).abs().max())
               for g, w in zip(got, want) for a, b in zip(g[:3], w[:3]))


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


def main() -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    case = step_case(resnet50_leaves(), gen)
    err = max_err(case["kernel"](), case["plain"]())
    times = {}
    for name in ("kernel", "plain", "library"):
        host, spin = enqueue_check(case[name])
        if host >= spin:
            raise RuntimeError(f"{name}: enqueue {host:.1f} ms outlasts the "
                               f"{spin:.1f} ms spin")
        times[name] = DB.device_ms(case[name], flush,
                                   spin_cycles=SPIN_CYCLES)
    print(f"fused_adamw [{case['shape']}]: kernel {times['kernel']:.4f} ms "
          f"({times['kernel'] / case['leaves'] * 1e3:.2f} us per launch), "
          f"bound {case['bound_ms']:.4f} ms ({case['bound_by']}), plain "
          f"{times['plain']:.4f} ms, library {times['library']:.4f} ms, "
          f"max_abs_err {err:.3e}  [{card}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
