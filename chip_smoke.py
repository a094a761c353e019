#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (tpudist_torch) on one NVIDIA H100.

    python3 chip_smoke.py            # from the root of a checkout, one card

Phases, each fatal on failure:

1. card — refuse without CUDA; print the card's name and power limit
   (nvidia-smi); build every kernel from the checkout's sources (one nvcc
   per source, all started together) and print the build seconds;
2. kernel parity at the main path's shapes — each kernel against its plain
   PyTorch version on the card (contiguous: B 8, H 12, dh 64, S 1024,
   pos 0 / 31 / 1023; paged: bs 32, a 1025-block pool, permuted tables,
   cursors at block start / end / mid-block; f32 and bf16; a GQA case and
   an s_q = 5 chunk). Tolerance: the repo's kernel-parity rule, 2e-5
   absolute + relative in f32, 2% of the reference's max magnitude in bf16;
3. times — median CUDA-event time of each kernel over 50 launches with
   the L2 flushed before each, beside its byte/operation bound, its plain
   version and one PyTorch library call computing the same function
   (scaled_dot_product_attention on the gathered windows, same mask);
4. the main path, served — GPT-2 124M at full width, bf16, random init
   from a seed, attn_impl="fused", ServeEngine(paged=True, block_size=32,
   max_slots=8): 8 requests (prompts 16..128 tokens, 32 new tokens, 6
   greedy and 2 sampled); the paged kernel must have run 12 times per
   decode step dispatched;
5. the static path — generate() on B 4, prompt 64, 32 new tokens, greedy;
   the contiguous kernel must have run 12 x 32 times;
6. agreement — in f32, the paged engine with attn_impl="fused" and with
   "xla" (the dense path, on the card) gives identical greedy streams; the
   smallest top-2 logit gap along the streams is printed;
7. fused-AdamW parity — the kernel against its plain version at each of
   ResNet-50's 76 kernel-eligible leaf shapes (channels-last layouts) and
   at 1024, 1027 and 9001 elements; f32 and bf16 grads, no copy and a
   bf16 copy, wd 0 and 0.1. u, m' and v' hold the parity rule; the copy
   is bit-identical to ``(p + u).to(bf16)`` of the kernel's own u;
8. fused-AdamW times — one ResNet-50 optimizer step (76 launches, bf16
   grads and copy): device time (median of 50, card held busy, L2
   flushed) and time per launch, beside the byte bound, the plain
   version and ``torch.optim.Adam(fused=True).step()`` over the same leaves;
9. the main path, trained — a 1-rank NCCL group (env://), then
   ``tpudist_torch.main.main`` with ResNet-50, synthetic CIFAR (2048
   images), batch 128, 1 epoch, --bf16 --fused optimizer, the profiler
   on: 16 steps under DDP; the kernel must have run 76 x 16 times (the
   count of the model's own eligible leaves), the TSV must have rows at
   g_step 5, 10 and 15 and the TrainTime row, the losses must be finite
   and fall, and a trace must be under log_<JobID>; from that trace, the
   kernels and the card's busy time per step and the top kernels;
10. agreement — in f32 with cudnn.deterministic, four steps of
    --fused optimizer and of --fused none from the same init on the same
    batches: losses and params within 1e-5 relative;
11. fused LayerNorm parity — the forward and backward kernels against
    their plain versions at GPT-2's 8192 x 768 rows and a ragged
    1000 x 200, the three compositions, RMS on and off, f32 and bf16: n,
    r, dx = dy, dscale, dbias under the parity rule of phase 2 and, for
    bf16 outputs, element by element within 2 bf16 ulps plus 2^-12 of the
    largest magnitude (lm_kernels_bench.ELEM_ULPS / ELEM_ATOL);
12. vmem attention parity — the forward and backward kernels against their
    plain versions: B 8, H 12, S 1024, D 64 causal (strided q, k, v views
    of one qkv tensor, the main path's case), S 197 non-causal, kv_len < S
    causal and not, GQA with H_kv 4, head dims 128, 80 and 32; f32 and
    bf16; o, lse, dq, dk, dv under the bars of phase 11; then
    multi_head_attention(impl="auto") at S 256 launches the kernel once at
    D 32, 64 and 128 and raises ValueError at D 200 (never dense);
13. times — the four kernels at the training path's shapes in bf16
    (tpudist_torch/ops/lm_kernels_bench.py): median device time of 50
    calls, L2 flushed, beside the bound, the plain version and the library
    call (F.layer_norm, aten.native_layer_norm_backward,
    scaled_dot_product_attention forward and backward);
14. the main path, trained — a 1-rank NCCL group, then
    ``tpudist_torch.train_gpt2.main`` with GPT-2 124M at full width and
    depth, --bf16 --fused all --attn auto, batch 8, S 1024, 16 steps on a
    byte-token file made from the checkout's own text (uniform random
    tokens cannot fall below ln V): the launch counts per step (LN forward
    25, LN backward 25 plus 25 reductions, attention forward 12 and
    backward 12, fused AdamW 74, each counted on the model), TSV rows at
    g_step 5, 10 and 15 and TrainTime, finite and falling losses, the
    tokens/sec line, and the trace's kernels and busy share per step;
15. agreement — in f32, four steps of --fused all --attn vmem and of
    --fused none --attn xla from the same init on the same batches: the
    two differ in their variance form and attention arithmetic, so they
    are not bit-equal; held to 1e-5 relative on the losses and 1e-5 on
    the parameters (LOSS_BAR, PARAM_BAR), except the key slice of the qkv
    biases, whose gradient is zero in exact arithmetic (Adam turns its
    rounding into a full step of either sign): on both runs it stays
    within 1.5 x steps x the peak lr of its zero init; the gaps are
    printed;
16. a ``{"kernels": [...]}`` line with all seven kernels; then the last
    line, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

SEED = 0
VOCAB, NEW = 50257, 32
FAILURES: list[str] = []
#: phase 15's bars on the f32 kernel and dense paths after 4 steps, set
#: from their readings (PERF.md): relative on the losses, absolute on the
#: parameters
LOSS_BAR, PARAM_BAR = 1e-5, 1e-5
REPLACES = {"paged_decode_attention": "tpudist/ops/decode.py:358",
            "fused_decode_attention": "tpudist/ops/decode.py:216",
            "fused_adamw": "tpudist/ops/fused_update.py:96",
            "layernorm_fwd": "tpudist/ops/layernorm.py:189",
            "layernorm_bwd": "tpudist/ops/layernorm.py:215",
            "vmem_attention_fwd": "tpudist/ops/vmem_attention.py:233",
            "vmem_attention_bwd": "tpudist/ops/vmem_attention.py:264"}
SOURCES = {"paged_decode_attention": "tpudist_torch/csrc/decode_attention.cu",
           "fused_decode_attention": "tpudist_torch/csrc/decode_attention.cu",
           "fused_adamw": "tpudist_torch/csrc/fused_update.cu",
           "layernorm_fwd": "tpudist_torch/csrc/layernorm.cu",
           "layernorm_bwd": "tpudist_torch/csrc/layernorm.cu",
           "vmem_attention_fwd": "tpudist_torch/csrc/vmem_attention.cu",
           "vmem_attention_bwd": "tpudist_torch/csrc/vmem_attention.cu"}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(name, got, want, *, elem: bool = False) -> float:
    """Hold ``got`` to ``want`` under the repo's kernel-parity rule
    (``lm_kernels_bench.parity_tol``); with ``elem`` a bf16 output is also
    held element by element (``lm_kernels_bench.max_err``)."""
    import torch

    from tpudist_torch.ops import lm_kernels_bench as LB

    torch.cuda.synchronize()
    atol, rtol = LB.parity_tol(want)
    err, ok = LB.max_err(got, want, elem=elem)
    extra = (f", {LB.elem_reading(got, want)}"
             if elem and want.dtype == torch.bfloat16 else "")
    print(f"  {name}: max_abs_err {err:.3e} (atol {atol:.3e}, rtol {rtol:g})"
          f"{extra} {'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(name)
    return err


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (HERE / "tpudist_torch").is_dir():
        print("chip_smoke: run from a checkout of the repo (tpudist_torch/ "
              "is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    from tpudist_torch.csrc import build
    from tpudist_torch.generate import generate
    from tpudist_torch.models.gpt2 import GPT2
    from tpudist_torch.ops import decode as D
    from tpudist_torch.ops import decode_bench as DB
    from tpudist_torch.serve import ServeEngine

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    # -- 1. card --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print("== 1. card")
    print(smi)
    t0 = time.perf_counter()
    build.build_all()
    print(f"  kernels built in {time.perf_counter() - t0:.2f} s")
    for src, info in build.build_info.items():
        print(f"  {src}: nvcc {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print("    " + line.strip())

    g = torch.Generator(device="cpu").manual_seed(SEED)

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=g).to(dev, dtype)

    B, H, DH, S, BS = 8, 12, 64, 1024, 32
    MB, NBLK = S // BS, 1025

    # -- 2. parity --------------------------------------------------------
    print("== 2. kernel parity at the main path's shapes")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for h_kv in (H, H // 2):
            k = randn(B, h_kv, S, DH, dtype=dtype)
            v = randn(B, h_kv, S, DH, dtype=dtype)
            q = randn(B, 1, H, DH, dtype=dtype)
            for pos in (0, 31, 1023):
                check(f"contiguous {dn} H_kv={h_kv} pos={pos}",
                      D.fused_decode_attention_cuda(q, k, v, pos),
                      D.fused_decode_attention_plain(q, k, v, pos))
        for h_kv, s_q in ((H, 1), (H // 2, 1), (H, 5)):
            kp = randn(NBLK, h_kv, BS, DH, dtype=dtype)
            vp = randn(NBLK, h_kv, BS, DH, dtype=dtype)
            q = randn(B, s_q, H, DH, dtype=dtype)
            perm = torch.randperm(NBLK - 1, generator=g)[: B * MB] + 1
            tables = perm.reshape(B, MB).to(dev, torch.int32)
            # block start, block end, mid-block, first and last slot
            pos = torch.tensor([0, 31, 32, 63, 500, 777, 1023 - s_q + 1, 15],
                               dtype=torch.int32, device=dev)
            check(f"paged {dn} H_kv={h_kv} s_q={s_q}",
                  D.paged_fused_attention_cuda(q, kp, vp, tables, pos),
                  D.paged_fused_attention_plain(q, kp, vp, tables, pos))
    if FAILURES:
        fail(f"kernel parity: {FAILURES}")

    # -- 3. times ---------------------------------------------------------
    print("== 3. kernel times (median of 50 device times, L2 flushed; bf16)")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    kernels = []
    for case in DB.main_path_cases(SEED, NEW):
        err = check(f"{case['name']} timed config", case["kernel"](),
                    case["plain"]())
        kernels.append(dict(
            name=case["name"], route="cuda", source=SOURCES[case["name"]],
            replaces=REPLACES[case["name"]],
            ms=DB.device_ms(case["kernel"], flush),
            plain_ms=DB.device_ms(case["plain"], flush),
            library_ms=DB.device_ms(case["library"], flush),
            max_abs_err=err, bound_ms=case["bound_ms"],
            bound_by=case["bound_by"],
        ))
        print(f"  {case['name']} [{case['shape']}]")
        k = kernels[-1]
        print(f"    kernel {k['ms'] * 1e3:.2f} us, bound {k['bound_ms'] * 1e3:.3f}"
              f" us ({k['bound_by']}), plain {k['plain_ms'] * 1e3:.1f} us, "
              f"library {k['library_ms'] * 1e3:.2f} us  [{smi}]")
    if FAILURES:
        fail(f"timed-config parity: {FAILURES}")
    del flush

    # -- 4. the main path, served -------------------------------------------
    print("== 4. GPT-2 124M, bf16, paged engine through the kernels")
    prompts = DB.smoke_prompts(SEED)
    rng = np.random.Generator(np.random.PCG64(SEED + 1))
    model = GPT2(dtype=torch.bfloat16, attn_impl="fused", device="cuda",
                 seed=SEED)
    eng = ServeEngine(model, max_slots=8, paged=True, block_size=32, seed=SEED)
    warm = eng.submit(prompts[0][:20], 4)
    eng.run()  # warm-up: cuBLAS handles, allocator pools, the pinned pool
    if len(eng.result(warm)) != 4:
        fail("warm-up request did not complete")
    eng.reset_stats()
    steps0 = eng.decode_steps
    sampling = [dict(temperature=0.0)] * 6 + [
        dict(temperature=1.0, top_k=50, top_p=0.95)] * 2
    D.reset_launch_counts()
    rids = [eng.submit(p, NEW, **opts) for p, opts in zip(prompts, sampling)]
    torch.cuda.synchronize()
    out = eng.run()
    torch.cuda.synchronize()
    served_launches = dict(D.launch_counts)
    steps = eng.decode_steps - steps0
    for r in rids:
        toks = out[r]
        if len(toks) != NEW or not all(0 <= t < VOCAB for t in toks):
            fail(f"request {r}: {len(toks)} tokens, want {NEW} in-vocab")
    if served_launches["paged_decode_attention"] != model.depth * steps:
        fail(f"paged kernel launched {served_launches['paged_decode_attention']} "
             f"times for {steps} decode steps x {model.depth} layers")
    snap = eng.stats.snapshot()
    print(f"  8 requests x {NEW} tokens served, {steps} decode steps, paged "
          f"kernel launches {served_launches['paged_decode_attention']} "
          f"(= {model.depth} x {steps})")
    print(f"  TTFT p50 {snap['ttft_p50']} s p95 {snap['ttft_p95']} s, TPOT "
          f"p50 {snap['tpot_p50']} s p95 {snap['tpot_p95']} s, "
          f"{snap['tokens_per_sec']} tok/s, wall {snap['wall_s']} s  [{smi}]")
    print("  serve_summary " + json.dumps(snap))

    # -- 5. the static path -----------------------------------------------------
    print("== 5. generate(): B 4, prompt 64, 32 new tokens, greedy")
    batch = np.stack([rng.integers(0, VOCAB, (64,)).astype(np.int32)
                      for _ in range(4)])
    generate(model, batch[:, :16], 2, temperature=0.0)  # warm-up
    D.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = generate(model, batch, NEW, temperature=0.0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    static_launches = dict(D.launch_counts)
    if toks.shape != (4, NEW) or not ((toks >= 0) & (toks < VOCAB)).all():
        fail(f"generate() returned {toks.shape}")
    if static_launches["fused_decode_attention"] != model.depth * NEW:
        fail(f"contiguous kernel launched "
             f"{static_launches['fused_decode_attention']} times, want "
             f"{model.depth} x {NEW}")
    print(f"  contiguous kernel launches {static_launches['fused_decode_attention']}"
          f" (= {model.depth} x {NEW}); {gen_s:.3f} s for 4 x {NEW} tokens  [{smi}]")
    del model, eng

    # -- 6. agreement in f32 --------------------------------------------------
    print("== 6. f32: attn_impl='fused' vs 'xla' greedy streams")
    streams = {}
    for impl in ("fused", "xla"):
        m = GPT2(dtype=torch.float32, attn_impl=impl, device="cuda", seed=SEED)
        e = ServeEngine(m, max_slots=8, paged=True, block_size=32, seed=SEED)
        ids = [e.submit(p, NEW) for p in prompts]
        res = e.run()
        streams[impl] = [res[i] for i in ids]
        if impl == "xla":
            gap = top2_gap(m, prompts, streams[impl])
        del m, e
    same = streams["fused"] == streams["xla"]
    print(f"  streams identical: {same}; smallest top-2 logit gap along the "
          f"streams {gap:.3e}")
    if not same:
        fail("f32 kernel and dense greedy streams differ")

    kernels.append(train_phases(smi, dev))
    kernels.extend(lm_phases(smi, dev))

    # -- 16. result ---------------------------------------------------------------
    launches = {"paged_decode_attention": served_launches["paged_decode_attention"],
                "fused_decode_attention": static_launches["fused_decode_attention"]}
    for kr in kernels:
        kr.setdefault("launches", launches.get(kr["name"]))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{k: kr[k] for k in keys} for kr in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


def train_phases(smi: str, dev) -> dict:
    """Phases 7-10: the fused-AdamW kernel and the ResNet-50 training path.
    Returns the kernel's entry of the ``kernels`` line."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tpudist_torch import main as M
    from tpudist_torch.ops import decode_bench as DB
    from tpudist_torch.ops import fused_update as FU
    from tpudist_torch.ops import fused_update_bench as FB
    from tpudist_torch.ops.lm_kernels_bench import parity_tol

    hp = dict(b1=0.9, b2=0.999, eps=1e-8)
    g = torch.Generator(device="cpu").manual_seed(SEED + 7)
    gd = torch.Generator(device=dev).manual_seed(SEED + 7)

    # -- 7. fused-AdamW parity ---------------------------------------------------
    print("== 7. fused-AdamW parity: ResNet-50's leaf shapes + 1024/1027/9001")
    leaves = FB.resnet50_leaves()
    shapes = [p for p in leaves] + [torch.empty(n, device=dev)
                                    for n in (1024, 1027, 9001)]
    for gdt in (torch.float32, torch.bfloat16):
        for cdt in (None, torch.bfloat16):
            for wd in (0.0, 0.1):
                errs, atol_fail, copy_exact, plain_exact = [], [], True, True
                for ref in shapes:
                    def like(dtype, scale=1.0, positive=False):
                        src = torch.rand if positive else torch.randn
                        t = torch.empty_like(ref, dtype=torch.float32)
                        t.copy_(src(ref.shape, generator=gd, device=dev) * scale)
                        return t.to(dtype)
                    args = (like(gdt, 0.1), like(torch.float32, 0.01),
                            like(torch.float32, 1e-3, positive=True),
                            like(torch.float32), *FB.SCALARS)
                    ku, km, kv, kc = FU.fused_leaf_update_cuda(
                        *args, wd=wd, compute_dtype=cdt, **hp)
                    pu, pm, pv, pc = FU.fused_leaf_update_plain(
                        *args, wd=wd, compute_dtype=cdt, **hp)
                    torch.cuda.synchronize()
                    for got, want in ((ku, pu), (km, pm), (kv, pv)):
                        atol, rtol = parity_tol(want)
                        d = (got - want).abs()
                        errs.append(float(d.max()))
                        if not bool((d <= atol + rtol * want.abs()).all()):
                            atol_fail.append(tuple(ref.shape))
                        plain_exact &= bool(torch.equal(got, want))
                    if cdt is not None:
                        copy_exact &= bool(torch.equal(
                            kc, (args[3] + ku).to(cdt)))
                name = (f"g {str(gdt).split('.')[-1]}, copy "
                        f"{str(cdt).split('.')[-1]}, wd {wd}")
                ok = not atol_fail and copy_exact
                print(f"  {name}: {len(shapes)} shapes, max_abs_err "
                      f"{max(errs):.3e}, bit-equal to plain {plain_exact}, "
                      f"copy bit-exact {copy_exact} {'ok' if ok else 'FAIL'}")
                if not ok:
                    FAILURES.append(f"fused_adamw {name} {atol_fail[:3]}")
    if FAILURES:
        fail(f"fused-AdamW parity: {FAILURES}")

    # -- 8. fused-AdamW times --------------------------------------------------
    print("== 8. fused-AdamW times: one ResNet-50 optimizer step")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    case = FB.step_case(leaves, g)
    err = FB.max_err(case["kernel"](), case["plain"]())
    if not err <= 2e-5:  # the f32 parity rule's absolute part
        fail(f"fused-AdamW timed config: max_abs_err {err:.3e}")
    times = {}
    for name in ("kernel", "plain", "library"):
        host_ms, spin_ms = FB.enqueue_check(case[name])
        print(f"  {name}: enqueue {host_ms:.2f} ms on the host, spin "
              f"{spin_ms:.1f} ms on the card")
        if host_ms >= spin_ms:
            fail(f"{name}: the host enqueue outlasts the spin; its time "
                 "would include host time")
        times[name] = DB.device_ms(case[name], flush,
                                   spin_cycles=FB.SPIN_CYCLES)
    del flush
    print(f"  [{case['shape']}]")
    print(f"    kernel {times['kernel']:.4f} ms ({times['kernel'] / case['leaves'] * 1e3:.2f}"
          f" us per launch), bound {case['bound_ms']:.4f} ms ({case['bound_by']}), "
          f"plain {times['plain']:.4f} ms, library (torch.optim.Adam fused) "
          f"{times['library']:.4f} ms, max_abs_err {err:.3e}  [{smi}]")
    entry = dict(name="fused_adamw", route="cuda", source=SOURCES["fused_adamw"],
                 replaces=REPLACES["fused_adamw"], ms=times["kernel"],
                 plain_ms=times["plain"], library_ms=times["library"],
                 max_abs_err=err, bound_ms=case["bound_ms"],
                 bound_by=case["bound_by"])
    del case, leaves

    # -- 9. the main path, trained ---------------------------------------------
    print("== 9. ResNet-50, bf16, --fused optimizer, 16 steps under DDP (NCCL)")
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                      RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    dist.init_process_group("nccl", init_method="env://")
    with tempfile.TemporaryDirectory() as log_dir:
        FU.reset_launch_counts()
        torch.cuda.synchronize()
        state, losses = M.main([
            "--model", "resnet50", "--dataset", "synthetic",
            "--synthetic_size", "2048", "--batch_size", "128", "--epochs", "1",
            "--bf16", "--fused", "optimizer", "--JobID", "Smoke",
            "--log_dir", log_dir])
        torch.cuda.synchronize()
        launches = FU.launch_counts["fused_adamw"]
        if not isinstance(state.module, torch.nn.parallel.DistributedDataParallel):
            fail("the training step did not run under DDP")
        dist.destroy_process_group()
        eligible = sum(p.numel() >= FU.MIN_KERNEL_ELEMS
                       for p in state.model.parameters())
        rows = (Path(log_dir) / "Smoke_128_0.log").read_text().splitlines()
        traces = list((Path(log_dir) / "log_Smoke").glob("*.pt.trace.json"))
        window = trace_breakdown(traces[0]) if traces else None
    del state
    steps = len(losses)
    print(f"  {steps} steps, fused-AdamW launches {launches} (= {eligible} "
          f"eligible leaves x {steps}); losses {losses[0]:.4f} -> {losses[-1]:.4f}")
    if steps != 16 or launches != eligible * steps or eligible != 76:
        fail(f"{steps} steps, {launches} launches, {eligible} eligible leaves")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"losses {losses}")
    g_steps = [r.split("\t")[1] for r in rows[1:] if not r.startswith("TrainTime")]
    if g_steps != ["5", "10", "15"] or not rows[-1].startswith("TrainTime\t"):
        fail(f"TSV rows {rows}")
    if not traces:
        fail("no profiler trace under log_Smoke")
    train_s = float(rows[-1].split("\t")[1])
    eps15 = float(rows[3].split("\t")[4])
    step_ms = 128 / eps15 * 1e3
    print(f"  TSV: rows at g_step 5/10/15 + TrainTime {train_s:.3f} s; step at "
          f"g_step 15 {step_ms:.2f} ms ({eps15:.1f} images/s); "
          f"{steps * 128 / train_s:.1f} images/s over the run (profiler window "
          f"and first step included); trace {traces[0].name}  [{smi}]")
    if not window["steps"] or not window["kernels_per_step"]:
        fail(f"the profiler trace holds no device work: {window}")
    print(f"  profiler window ({window['steps']} steps, profiled): "
          f"{window['kernels_per_step']:.0f} kernels/step, device busy "
          f"{window['device_ms_per_step']:.2f} ms/step of "
          f"{window['window_ms_per_step']:.2f} ms/step wall; busy share of the "
          f"unprofiled g_step-15 step {window['device_ms_per_step'] / step_ms:.3f}")
    for name, ms, count in window["top"]:
        print(f"    {ms:8.3f} ms/step  {count:5.0f}/step  {name}")

    # -- 10. agreement in f32 ----------------------------------------------------
    print("== 10. f32: --fused optimizer vs --fused none, 4 steps, deterministic cuDNN")
    torch.backends.cudnn.deterministic = True
    runs = {}
    for fused in ("optimizer", "none"):
        with tempfile.TemporaryDirectory() as log_dir:
            st, ls = M.main([
                "--model", "resnet50", "--dataset", "synthetic",
                "--synthetic_size", "512", "--batch_size", "128",
                "--epochs", "1", "--fused", fused, "--no_profiler",
                "--log_dir", log_dir])
        runs[fused] = (ls, {k: v.float().cpu() for k, v in st.params().items()})
        del st
    torch.backends.cudnn.deterministic = False
    (lf, pf), (ln, pn) = runs["optimizer"], runs["none"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lf, ln))
    param_rel = max(float((pf[k] - pn[k]).abs().max() / pn[k].abs().max())
                    for k in pn)
    print(f"  losses {lf} vs {ln}: max rel {loss_rel:.3e}; params max rel "
          f"{param_rel:.3e}")
    if len(lf) != 4 or loss_rel > 1e-5 or param_rel > 1e-5:
        fail("f32 fused and unfused training disagree")
    entry["launches"] = launches
    return entry


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def lm_phases(smi: str, dev) -> list[dict]:
    """Phases 11-15: the fused LayerNorm and vmem attention kernels and the
    GPT-2 training path. Returns their four entries of the ``kernels``
    line, launches filled in."""
    import contextlib
    import io

    import numpy as np
    import torch
    import torch.distributed as dist

    from tpudist_torch import train_gpt2 as TG
    from tpudist_torch.ops import fused_update as FU
    from tpudist_torch.ops import layernorm as LN
    from tpudist_torch.ops import lm_kernels_bench as LB
    from tpudist_torch.ops import vmem_attention as VA

    gen = torch.Generator(device=dev).manual_seed(SEED + 11)

    # -- 11, 12. parity ---------------------------------------------------------
    print("== 11. fused LayerNorm parity: 8192x768 and 1000x200, three "
          "compositions, rms on/off, f32/bf16")
    for name, got, want in LB.ln_parity(gen):
        check(name, got, want, elem=True)
    if FAILURES:
        fail(f"fused LayerNorm parity: {FAILURES}")
    print("== 12. vmem attention parity: o, lse, dq, dk, dv")
    for name, got, want in LB.attn_parity(gen):
        check(name, got, want, elem=True)
    if FAILURES:
        fail(f"vmem attention parity: {FAILURES}")
    # the model's router on the card: auto reaches the kernel at every
    # head dim it takes and raises past them, never going dense
    from tpudist_torch.ops.attention import multi_head_attention

    for d in (32, 64, 128, 200):
        q, k, v, _ = LB.attn_inputs(gen, 2, 256, 4, 4, torch.bfloat16, d=d)
        VA.reset_launch_counts()
        try:
            got = multi_head_attention(q, k, v, causal=True, impl="auto")
        except ValueError as e:
            routed = f"ValueError ({e})"
        else:
            check(f"auto D {d}", got, VA.vmem_fwd_plain(
                q, k, v, causal=True, kv_len=256, scale=VA._scale(d))[0],
                elem=True)
            routed = f"{VA.launch_counts['vmem_attention_fwd']} kernel launch"
        print(f"  auto at D {d}, S 256: {routed}")
        if not (routed == "1 kernel launch" if d <= VA.MAX_HEAD_DIM
                else routed.startswith("ValueError")):
            FAILURES.append(f"auto D {d}: {routed}")
    if FAILURES:
        fail(f"vmem attention routing: {FAILURES}")

    # -- 13. times ------------------------------------------------------------------
    print("== 13. GPT-2 training kernel times (median of 50 device times, L2 "
          "flushed; bf16)")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    entries = []
    for case in LB.timing_cases(gen):
        t = LB.time_case(case, flush)
        lib = ("n/a" if t["library_ms"] is None
               else f"{t['library_ms'] * 1e3:.2f} us")
        print(f"  {case['name']} [{case['shape']}]: kernel "
              f"{t['kernel_ms'] * 1e3:.2f} us, bound {case['bound_ms'] * 1e3:.2f}"
              f" us ({case['bound_by']}), plain {t['plain_ms'] * 1e3:.1f} us, "
              f"library {lib}, max_abs_err {case['max_abs_err']:.3e}  [{smi}]")
        if case["name"] in REPLACES:
            entries.append(dict(
                name=case["name"], route="cuda", source=SOURCES[case["name"]],
                replaces=REPLACES[case["name"]], ms=t["kernel_ms"],
                plain_ms=t["plain_ms"], library_ms=t["library_ms"],
                max_abs_err=case["max_abs_err"], bound_ms=case["bound_ms"],
                bound_by=case["bound_by"]))
    del flush

    # -- 14. the main path, trained -----------------------------------------------
    print("== 14. GPT-2 124M, bf16, --fused all --attn auto, 16 steps under "
          "DDP (NCCL)")
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                      RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    dist.init_process_group("nccl", init_method="env://")
    with tempfile.TemporaryDirectory() as log_dir:
        tokens = LB.token_file(Path(log_dir) / "text.bin", 16 * 8 * 1024)
        for mod in (LN, VA, FU):
            mod.reset_launch_counts()
        out = io.StringIO()
        torch.cuda.synchronize()
        with contextlib.redirect_stdout(out):
            state, losses = TG.main([
                "--bf16", "--fused", "all", "--attn", "auto",
                "--batch_size", "8", "--seq_len", "1024", "--tokens",
                str(tokens), "--JobID", "Smoke", "--log_dir", log_dir])
        torch.cuda.synchronize()
        counts = {**LN.launch_counts, **VA.launch_counts, **FU.launch_counts}
        printed = out.getvalue()
        print("  " + "\n  ".join(printed.strip().splitlines()[-3:]))
        if not isinstance(state.module, torch.nn.parallel.DistributedDataParallel):
            fail("the training step did not run under DDP")
        dist.destroy_process_group()
        model = state.model
        rows = (Path(log_dir) / "Smoke_8_0.log").read_text().splitlines()
        traces = list((Path(log_dir) / "log_Smoke").glob("*.pt.trace.json"))
        window = trace_breakdown(traces[0]) if traces else None
    steps = len(losses)
    depth = model.depth
    eligible = sum(p.numel() >= FU.MIN_KERNEL_ELEMS for p in model.parameters())
    want = {"layernorm_fwd": 2 * depth + 1, "layernorm_bwd": 2 * depth + 1,
            "layernorm_bwd_reduce": 2 * depth + 1, "vmem_attention_fwd": depth,
            "vmem_attention_bwd": depth, "fused_adamw": eligible}
    print(f"  {steps} steps; launches {counts} (per step {want}); losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    del state, model
    if steps != 16 or eligible != 74 or any(
            counts[k] != n * steps for k, n in want.items()):
        fail(f"{steps} steps, launches {counts}, want {want} per step")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"losses {losses}")
    line = [ln for ln in printed.splitlines() if ln.startswith("tokens/sec: ")]
    if len(line) != 1 or f"steps={steps} " not in line[0]:
        fail(f"no tokens/sec line for {steps} steps in the run's output")
    g_steps = [r.split("\t")[1] for r in rows[1:] if not r.startswith("TrainTime")]
    if g_steps != ["5", "10", "15"] or not rows[-1].startswith("TrainTime\t"):
        fail(f"TSV rows {rows}")
    if not traces or not window["steps"] or not window["kernels_per_step"]:
        fail(f"no device work in a profiler trace under log_Smoke: {window}")
    train_s = float(rows[-1].split("\t")[1])
    eps15 = float(rows[3].split("\t")[4])
    step_ms = 8 / eps15 * 1e3
    print(f"  TSV: rows at g_step 5/10/15 + TrainTime {train_s:.3f} s; step at "
          f"g_step 15 {step_ms:.2f} ms ({eps15 * 1024:.1f} tokens/s); "
          f"{steps * 8 * 1024 / train_s:.1f} tokens/s over the run (profiler "
          f"window and first step included)  [{smi}]")
    print(f"  profiler window ({window['steps']} steps, profiled): "
          f"{window['kernels_per_step']:.0f} kernels/step, device busy "
          f"{window['device_ms_per_step']:.2f} ms/step of "
          f"{window['window_ms_per_step']:.2f} ms/step wall; busy share of the "
          f"unprofiled g_step-15 step {window['device_ms_per_step'] / step_ms:.3f}")
    for name, ms, count in window["top"]:
        print(f"    {ms:8.3f} ms/step  {count:5.0f}/step  {name}")

    # -- 15. agreement in f32 ------------------------------------------------------
    print("== 15. f32: --fused all --attn vmem vs --fused none --attn xla, 4 steps")
    runs = {}
    with tempfile.TemporaryDirectory() as log_dir:
        tokens = LB.token_file(Path(log_dir) / "text.bin", 4 * 8 * 1024)
        for fused, attn in (("all", "vmem"), ("none", "xla")):
            for mod in (LN, VA, FU):
                mod.reset_launch_counts()
            with contextlib.redirect_stdout(io.StringIO()):
                st, ls = TG.main([
                    "--fused", fused, "--attn", attn, "--batch_size", "8",
                    "--seq_len", "1024", "--tokens", str(tokens),
                    "--no_profiler", "--log_dir", log_dir])
            runs[fused] = (ls, {k: v.float().cpu() for k, v in st.params().items()})
            ran = {**LN.launch_counts, **VA.launch_counts, **FU.launch_counts}
            # the fused run went through every kernel, the dense run none
            if (min(ran.values()) > 0) != (fused == "all") or (
                    fused == "none" and any(ran.values())):
                fail(f"--fused {fused} --attn {attn}: launches {ran}")
            del st
    (lf, pf), (ln, pn) = runs["all"], runs["none"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lf, ln))
    gaps, key_moved = {}, 0.0
    for k in pn:
        a, b = pf[k], pn[k]
        if k.endswith("qkv.bias"):
            # the key slice, from its zero init, on both runs
            key_moved = max(key_moved, float(a[1].abs().max()),
                            float(b[1].abs().max()))
            a, b = a[[0, 2]], b[[0, 2]]
        gaps[k] = float((a - b).abs().max())
    worst = max(gaps, key=gaps.get)
    key_bound = 1.5 * len(lf) * 3e-4  # 1.5 x steps x the peak lr
    print(f"  losses {lf} vs {ln}: max rel {loss_rel:.3e}; params max abs "
          f"{gaps[worst]:.3e} ({worst}) [bar {PARAM_BAR:g}]; key slice of "
          f"the qkv biases moved at most {key_moved:.3e} [step bound "
          f"{key_bound:.2e}]")
    if (len(lf) != 4 or loss_rel > LOSS_BAR or gaps[worst] > PARAM_BAR
            or key_moved > key_bound):
        fail("f32 fused and unfused GPT-2 training disagree")
    for e in entries:
        e["launches"] = counts[e["name"]]
    return entries


def trace_breakdown(path: Path) -> dict:
    """Per-step device work in a ``torch.profiler`` Chrome trace: kernels,
    the card's busy time (the union of kernel, memcpy and memset
    intervals), the window's wall time (its ``ProfilerStep#`` spans) and
    the five kernels that take the most time."""
    import collections

    events = json.loads(path.read_text())["traceEvents"]
    steps = [e for e in events if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("ProfilerStep#")]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    n = max(len(steps), 1)
    by_name: dict = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("cat") == "kernel":
            by_name[e["name"][:70]][0] += e["dur"]
            by_name[e["name"][:70]][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return dict(
        steps=len(steps),
        kernels_per_step=sum(c for _, c in by_name.values()) / n,
        device_ms_per_step=busy / 1e3 / n,
        window_ms_per_step=sum(e["dur"] for e in steps) / 1e3 / n,
        top=[(k, v[0] / 1e3 / n, v[1] / n) for k, v in top])


def top2_gap(model, prompts, streams) -> float:
    """Smallest gap between the two largest f32 logits at every position a
    greedy stream was sampled from (a dense forward of prompt + stream)."""
    import torch

    gaps = []
    with torch.no_grad():
        for p, s in zip(prompts, streams):
            toks = torch.tensor(list(p) + s[:-1], device=model.device)[None]
            logits = model(toks.long())[0, len(p) - 1:]
            top = torch.topk(logits, 2, dim=-1).values
            gaps.append(float((top[:, 0] - top[:, 1]).min()))
    return min(gaps)


if __name__ == "__main__":
    sys.exit(main())
