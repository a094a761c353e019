#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (tpudist_torch) on one NVIDIA H100.

    python3 chip_smoke.py            # from the root of a checkout, one card

Phases, each fatal on failure:

1. card — refuse without CUDA; print the card's name and power limit
   (nvidia-smi); build every kernel from the checkout's sources (one nvcc
   per source, all started together) and print the build seconds;
2. kernel parity at the main path's shapes — the decode kernels'
   registers and spills from the build log (a spill in a bf16 kernel
   fails), then each kernel against its plain PyTorch version on the card
   (``decode_bench.parity_cases``; contiguous: B 8, H 12, dh 64, S 1024,
   pos 0 / 31 / 1023, GQA, B 4 at pos 1023, dh 20, 80 and 128; paged: bs
   32, a 1025-block pool, permuted tables, cursors at block start / end /
   mid-block / the table's end, GQA, s_q 5 and 16, dh 20, 80 and 128, and
   eight rows all at cursor 1023; then grids that fill the card (contiguous
   B 32 at pos 1023; paged B 32 at s_q 16 over 4096-slot tables), a
   contiguous cursor at 65535 and paged blocks of 1024 slots at dh 256;
   f32 and bf16). Tolerance: the repo's
   kernel-parity rule, 2e-5 absolute + relative in f32, 2% of the
   reference's max magnitude in bf16; in bf16 also lm_kernels_bench's
   element bar and at most 1% of the elements differing (a p rounded
   against another max moves ~40% of them by about one ulp); two calls at
   each main-path shape must be bit-identical;
3. times — median CUDA-event time of each kernel over 50 launches with
   the L2 flushed before each, beside its byte/operation bound, its plain
   version and one PyTorch library call computing the same function
   (scaled_dot_product_attention on the gathered windows, same mask), at
   the main path's shapes and at cursor 1023 (eight paged rows; B 4
   contiguous), each output held to phase 2's bars first;
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
7. fused-AdamW parity — leaf mode (the kernel as ``fused_leaf_update``'s
   counterpart) against its plain version at each of ResNet-50's 76
   leaf shapes of at least 1024 elements (channels-last layouts) and at
   1024, 1027 and 9001 elements: u, m' and v' hold the parity rule and the
   copy is bit-identical to ``(p + u).to(bf16)`` of the kernel's own u;
   then optimizer mode (the training step's one multi-tensor launch)
   against the plain step over all 161 ResNet-50 and all 148 GPT-2 124M
   leaves, a ragged list (1, 7, 1023, 1027, 9001 elements and a 37 x 111
   leaf that starts one element into its buffers) and 600 leaves of
   1..5000 elements (two launches): m', v', the master and the copy
   bit-equal, one launch per table of leaves; each with f32 and bf16
   grads, no copy and a bf16 copy, wd 0 and 0.1 (on leaves of more than
   one dimension);
8. fused-AdamW times — one ResNet-50 optimizer step over all 161 leaves
   (bf16 grads and copy): device time of ``FusedAdamW.step`` (median of
   50, card held busy, L2 flushed), beside the byte bound, the per-leaf
   structure the step had before (a leaf-mode launch per leaf of at
   least 1024 elements, ``master += u``, the eager plain formula for the
   rest), the plain step and ``torch.optim.Adam(fused=True).step()`` over
   the same leaves;
9. the main path, trained — a 1-rank NCCL group (env://), then
   ``tpudist_torch.main.main`` with ResNet-50, synthetic CIFAR (2048
   images), batch 128, 1 epoch, --bf16 --fused optimizer, the profiler
   on: 16 steps under DDP; the kernel must have run once a step (16
   launches) covering all 161 leaves each time, the TSV must have rows at
   g_step 5, 10 and 15 and the TrainTime row, the losses must be finite
   and fall, and a trace must be under log_<JobID>; from that trace, the
   kernels and the card's busy time per step and the top kernels;
10. agreement — in f32 with cudnn.deterministic, four steps of
    --fused optimizer and of --fused none from the same init on the same
    batches: losses and params within 1e-5 relative;
11. fused LayerNorm parity — the kernels' registers and spills from the
    build report (a spill in a bf16 forward instantiation for D 768
    fails), then the forward and backward kernels against their plain
    versions at GPT-2's 8192 x 768 rows, a ragged 1000 x 200, 1000 x 197
    (no multiple of 16 bytes: the forward's element-wise path) and 1000 x
    768 rows starting one element into their buffers (misaligned: the
    element-wise path), the three compositions, RMS on and off, f32 and
    bf16: n, r, dx = dy, dscale, dbias under the parity rule of phase 2
    and, for bf16 outputs, element by element within 2 bf16 ulps plus
    2^-14 of the largest magnitude (lm_kernels_bench.ELEM_ULPS /
    ELEM_ATOL); two bf16 forward calls at 8192 x 768, plain and pre-norm,
    must be bit-identical;
12. vmem attention parity — the forward and backward kernels against their
    plain versions: B 8, H 12, S 1024, D 64 causal (strided q, k, v views
    of one qkv tensor, the main path's case), S 197 non-causal, kv_len < S
    causal and not, GQA with H_kv 4, head dims 128, 80 and 32; f32 and
    bf16; o, lse, dq, dk, dv under the bars of phase 11, and a D 20 GQA
    case whose head stride of 20 elements sends the bf16 backward's tiles
    through element-wise loads (in bf16 the forward and backward are the
    tensor-core kernels); the forward and backward kernels' registers and
    spills from the build report (a spill in a bf16 HD 64 tensor-core
    instantiation fails); two bf16 forward calls on the main path's inputs
    must give bit-identical o and lse, and two backward calls bit-identical
    dq, dk, dv; then multi_head_attention(impl="auto") at
    S 256 launches the kernel once at D 32, 64 and 128 and raises
    ValueError at D 200 (never dense);
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
    backward 12, fused AdamW 1 covering the model's 148 leaves), TSV rows at
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
16. flash attention parity — the forward and backward kernels against
    their plain versions: B 4, H 12, S 4096, D 64 causal (strided q, k, v
    views of one qkv tensor, the long-context path's case), S 2048
    non-causal, a ragged S 2100 causal, kv_len 1900 < S 2048 causal and
    not, GQA H 12 / H_kv 4 repeated as multi_head_attention repeats it,
    head dims 128, 80, 32 and 20 (strided, head stride 20: element-wise
    loads); f32 and bf16; o, lse, dq, dk, dv under the bars of phase 11;
    the kernels' registers and spills and the repeat checks, as in phase
    12; then multi_head_attention(impl="auto") at S 2048
    launches the flash kernel once and the vmem kernel never at D 32, 64
    and 128 and with grouped K/V heads, and raises ValueError at D 200
    (never dense);
17. times — the two flash kernels at the long-context shape (B 4, H 12,
    S 4096, D 64, causal, bf16): median device time of 50 calls, L2
    flushed, beside the bound, the plain version and
    scaled_dot_product_attention forward and backward;
18. the long-context path, trained — a 1-rank NCCL group, then
    ``tpudist_torch.train_gpt2.main`` with GPT-2 124M at full width and
    depth, --seq_len 4096 --batch_size 4 --bf16 --fused all --attn auto
    --chunked_ce 256 (the reference's long-context leg), 16 steps on the
    byte-token file of phase 14: launches per step (flash forward 12 and
    backward 12, vmem 0, LN forward 25, backward 25 plus 25 reductions,
    fused AdamW 1 covering 148 leaves), TSV rows at g_step 5, 10 and 15
    and TrainTime,
    finite and falling losses, the tokens/sec line, and the trace's
    kernels and busy share per step;
19. agreement — in f32 at S 2048, depth 4 (cut for the dense path's
    memory), batch 4: four steps of --fused all --attn flash --chunked_ce
    256 and of --fused none --attn xla (full logits) from the same init on
    the same batches, held to LONG_LOSS_BAR / LONG_PARAM_BAR (set from the
    readings) with the qkv key slice held to its step bound as in phase
    15; the gaps are printed;
20. the tied LM head in bf16 at the S 1024 path's shape (x [8192, 768],
    wte [50257, 768]): the logits and the gradients of x and wte through
    ``tied_head`` (the f32 cotangent carried as hi + lo on the tensor
    cores) against the upcast plain version (f32 operands, the CPU path's
    function), from the cotangent of the mean cross-entropy on random
    targets; the logits under the f32 parity rule, the gradients under
    phase 11's element bar, each with the share of bf16 elements that
    differ; the old backward (g rounded to one bf16) printed beside them
    as a reading;
21. a ``{"kernels": [...]}`` line with all nine kernels; then the last
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
#: phase 19's bars on the f32 flash + chunked-CE and dense + full-logits
#: paths after 4 steps at S 2048, about ten times their first readings on
#: the H100 (8.8e-8 relative on the losses, 1.8e-7 on the parameters)
LONG_LOSS_BAR, LONG_PARAM_BAR = 1e-6, 2e-6
REPLACES = {"paged_decode_attention": "tpudist/ops/decode.py:358",
            "fused_decode_attention": "tpudist/ops/decode.py:216",
            "fused_adamw": "tpudist/ops/fused_update.py:96",
            "layernorm_fwd": "tpudist/ops/layernorm.py:189",
            "layernorm_bwd": "tpudist/ops/layernorm.py:215",
            "vmem_attention_fwd": "tpudist/ops/vmem_attention.py:233",
            "vmem_attention_bwd": "tpudist/ops/vmem_attention.py:264",
            "flash_attention_fwd": "tpudist/ops/flash_attention.py:127",
            "flash_attention_bwd": "tpudist/ops/flash_attention.py:307"}
SOURCES = {"paged_decode_attention": "tpudist_torch/csrc/decode_attention.cu",
           "fused_decode_attention": "tpudist_torch/csrc/decode_attention.cu",
           "fused_adamw": "tpudist_torch/csrc/fused_update.cu",
           "layernorm_fwd": "tpudist_torch/csrc/layernorm.cu",
           "layernorm_bwd": "tpudist_torch/csrc/layernorm.cu",
           "vmem_attention_fwd": "tpudist_torch/csrc/vmem_attention.cu",
           "vmem_attention_bwd": "tpudist_torch/csrc/vmem_attention.cu",
           "flash_attention_fwd": "tpudist_torch/csrc/flash_attention.cu",
           "flash_attention_bwd": "tpudist_torch/csrc/flash_attention.cu"}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(name, got, want, *, elem: bool = False,
          share_bar: float | None = None) -> float:
    """Hold ``got`` to ``want`` under the repo's kernel-parity rule
    (``lm_kernels_bench.parity_tol``); with ``elem`` a bf16 output is also
    held element by element (``lm_kernels_bench.max_err``), and with
    ``share_bar`` at most that share of its elements may differ."""
    import torch

    from tpudist_torch.ops import lm_kernels_bench as LB

    torch.cuda.synchronize()
    atol, rtol = LB.parity_tol(want)
    err, ok = LB.max_err(got, want, elem=elem)
    extra = (f", {LB.elem_reading(got, want)}"
             if elem and want.dtype == torch.bfloat16 else "")
    if share_bar is not None and want.dtype == torch.bfloat16:
        share = float((got != want).float().mean())
        extra += f", {share:.4%} of elements differ"
        ok = ok and share <= share_bar
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
        fn = None
        for line in info["log"].splitlines():
            if "Function properties for" in line:
                fn = line.split(" for ", 1)[1].strip()
            if "registers" in line or "spill" in line:
                print("    " + line.strip())
            if "spill stores" in line and " 0 bytes spill stores" not in line:
                print(f"    (the spills above are {fn}'s)")

    # -- 2. parity --------------------------------------------------------
    print("== 2. kernel parity at the main path's shapes (bf16: the 2% rule, "
          "the element bar and at most "
          f"{DB.SHARE_BAR:.0%} of elements differing)")
    lines, spilled = DB.build_report()
    print("  decode_attention.cu kernels (-Xptxas -v):")
    for line in lines:
        print("    " + line)
    if spilled:
        fail(f"bf16 decode kernels spill: {spilled}")
    for r in DB.parity(SEED):
        reading = f", {r['reading']}" if r["reading"] else ""
        print(f"  {r['name']}: max_abs_err {r['err']:.3e}, {r['share']:.4%} "
              f"of elements differ{reading} {'ok' if r['ok'] else 'FAIL'}")
        if not r["ok"]:
            FAILURES.append(r["name"])
    same = DB.repeat_identical(SEED)
    print(f"  two calls at the main-path shapes bit-identical: {same}")
    if not all(same.values()):
        fail(f"decode kernels not deterministic: {same}")
    if FAILURES:
        fail(f"kernel parity: {FAILURES}")

    # -- 3. times ---------------------------------------------------------
    print("== 3. kernel times (median of 50 device times, L2 flushed; bf16)")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    kernels = []
    for case in DB.main_path_cases(SEED, NEW):
        err = check(f"{case['name']} timed config", case["kernel"](),
                    case["plain"](), elem=True, share_bar=DB.SHARE_BAR)
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
    for case in DB.long_cases(SEED):
        check(f"{case['name']} at cursor 1023", case["kernel"](), case["plain"](),
              elem=True, share_bar=DB.SHARE_BAR)
        ms = DB.device_ms(case["kernel"], flush)
        lib_ms = DB.device_ms(case["library"], flush)
        print(f"  {case['name']} [{case['shape']}]")
        print(f"    kernel {ms * 1e3:.2f} us, bound {case['bound_ms'] * 1e3:.3f} "
              f"us ({case['bound_by']}), library {lib_ms * 1e3:.2f} us  [{smi}]")
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
    kernels.extend(long_context_phases(smi, dev))
    tied_head_phase(dev)

    # -- 21. result ---------------------------------------------------------------
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
    gd = torch.Generator(device=dev).manual_seed(SEED + 7)

    # -- 7. fused-AdamW parity ---------------------------------------------------
    print("== 7. fused-AdamW parity: leaf mode at ResNet-50's leaf shapes + "
          "1024/1027/9001; optimizer mode over ResNet-50's and GPT-2's leaves")
    leaves = FB.resnet50_leaves()
    shapes = [p for p in leaves if p.numel() >= FU.MIN_KERNEL_ELEMS] + [
        torch.empty(n, device=dev) for n in (1024, 1027, 9001)]
    combos = [(gdt, cdt, wd) for gdt in (torch.float32, torch.bfloat16)
              for cdt in (None, torch.bfloat16) for wd in (0.0, 0.1)]
    for gdt, cdt, wd in combos:
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
                copy_exact &= bool(torch.equal(kc, (args[3] + ku).to(cdt)))
        name = (f"leaf mode, g {str(gdt).split('.')[-1]}, copy "
                f"{str(cdt).split('.')[-1]}, wd {wd}")
        ok = not atol_fail and copy_exact
        print(f"  {name}: {len(shapes)} shapes, max_abs_err {max(errs):.3e}, "
              f"bit-equal to plain {plain_exact}, copy bit-exact {copy_exact} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            FAILURES.append(f"fused_adamw {name} {atol_fail[:3]}")
    # optimizer mode: m', v', the master and the copy bit-equal to the plain
    # step; a list within one table takes one launch, 600 leaves two
    lists = [("ResNet-50", leaves, False), ("GPT-2 124M", FB.gpt2_leaves(), False),
             ("ragged " + "/".join(map(str, FB.RAGGED)) + " + 37x111 misaligned",
              FB.ragged_leaves(dev), True),
             ("600 leaves of 1..5000", FB.long_leaves(dev, gd), False)]
    for label, group, misalign in lists:
        want_launches = -(-len(group) // FU.MAX_TABLE_LEAVES)
        for gdt, cdt, wd in combos:
            r = FB.step_parity(group, gd, g_dtype=gdt, copy_dtype=cdt, wd=wd,
                               misalign_last=misalign)
            ok = (r["equal"] and r["fused_adamw"] == want_launches
                  and r["fused_adamw_leaves"] == len(group))
            name = (f"step over {label} ({len(group)} leaves), g "
                    f"{str(gdt).split('.')[-1]}, copy "
                    f"{str(cdt).split('.')[-1]}, wd {wd}")
            print(f"  {name}: {r['fused_adamw']} launches covering "
                  f"{r['fused_adamw_leaves']} leaves, bit-equal to the plain "
                  f"step {r['equal']} (max_abs_err {r['err']:.3e}) "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok:
                FAILURES.append(f"fused_adamw {name}")
    del lists
    if FAILURES:
        fail(f"fused-AdamW parity: {FAILURES}")

    # -- 8. fused-AdamW times --------------------------------------------------
    print("== 8. fused-AdamW times: one ResNet-50 optimizer step")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    case = FB.step_case(leaves, gd)
    par = case["parity"]
    if not (par["equal"] and par["fused_adamw"] == 1):
        fail(f"fused-AdamW timed config: {par}")
    times = {}
    for name in ("kernel", "per_leaf", "plain", "library"):
        host_ms, spin_ms = FB.enqueue_check(case[name])
        cycles = FB.spin_for(host_ms, spin_ms)
        busy, acts = FB.busy_ms(case[name])
        print(f"  {name}: enqueue {host_ms:.2f} ms on the host, timed behind "
              f"a spin of {spin_ms * cycles / FB.SPIN_CYCLES:.1f} ms; card "
              f"busy {busy:.4f} ms in {acts} activities over one call "
              "(profiler)")
        times[name] = DB.device_ms(case[name], flush, spin_cycles=cycles)
    del flush
    print(f"  [{case['shape']}]")
    print(f"    step {times['kernel']:.4f} ms (1 launch), bound "
          f"{case['bound_ms']:.4f} ms ({case['bound_by']}), the per-leaf "
          f"structure {times['per_leaf']:.4f} ms, plain {times['plain']:.4f} "
          f"ms, library (torch.optim.Adam fused) {times['library']:.4f} ms, "
          f"bit-equal to the plain step (max_abs_err {par['err']:.3e})  [{smi}]")
    entry = dict(name="fused_adamw", route="cuda", source=SOURCES["fused_adamw"],
                 replaces=REPLACES["fused_adamw"], ms=times["kernel"],
                 plain_ms=times["plain"], library_ms=times["library"],
                 max_abs_err=par["err"], bound_ms=case["bound_ms"],
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
        covered = FU.launch_counts["fused_adamw_leaves"]
        if not isinstance(state.module, torch.nn.parallel.DistributedDataParallel):
            fail("the training step did not run under DDP")
        dist.destroy_process_group()
        n_leaves = len(list(state.model.parameters()))
        rows = (Path(log_dir) / "Smoke_128_0.log").read_text().splitlines()
        traces = list((Path(log_dir) / "log_Smoke").glob("*.pt.trace.json"))
        window = trace_breakdown(traces[0]) if traces else None
    del state
    steps = len(losses)
    print(f"  {steps} steps, fused-AdamW launches {launches} (= 1 x {steps}) "
          f"covering {covered} leaves (= {n_leaves} x {steps}); losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    if (steps != 16 or launches != steps or n_leaves != 161
            or covered != n_leaves * steps):
        fail(f"{steps} steps, {launches} launches covering {covered} of "
             f"{n_leaves} leaves a step")
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
    import torch

    from tpudist_torch.ops import lm_kernels_bench as LB
    from tpudist_torch.ops import vmem_attention as VA

    gen = torch.Generator(device=dev).manual_seed(SEED + 11)

    # -- 11, 12. parity ---------------------------------------------------------
    print("== 11. fused LayerNorm parity: 8192x768, 1000x200, 1000x197 and "
          "1000x768 at +1 element, three compositions, rms on/off, f32/bf16")
    lines, spilled = LB.ln_build()
    print("  layernorm.cu kernels (-Xptxas -v):")
    for line in lines:
        print("    " + line)
    if spilled:
        fail(f"bf16 LayerNorm forward kernels at D 768 spill: {spilled}")
    for name, got, want in LB.ln_parity(gen):
        check(name, got, want, elem=True)
    if FAILURES:
        fail(f"fused LayerNorm parity: {FAILURES}")
    same = LB.ln_repeat_identical(gen)
    print(f"  two bf16 forward calls at {LB.ROWS} x {LB.WIDTH} bit-identical: "
          f"{same}")
    if not all(same.values()):
        fail(f"the LayerNorm forward is not deterministic: {same}")
    print("== 12. vmem attention parity: o, lse, dq, dk, dv")
    attention_build("vmem_attention.cu")
    for name, got, want in LB.attn_parity(gen):
        check(name, got, want, elem=True)
    if FAILURES:
        fail(f"vmem attention parity: {FAILURES}")
    repeatable("vmem", gen, LB.B, LB.S)
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
    counts = trained_gpt2(
        ["--bf16", "--fused", "all", "--attn", "auto"], batch=8, seq=1024,
        job="Smoke", smi=smi, want=lambda depth, n_leaves: {
            "layernorm_fwd": 2 * depth + 1, "layernorm_bwd": 2 * depth + 1,
            "layernorm_bwd_reduce": 2 * depth + 1,
            "vmem_attention_fwd": depth, "vmem_attention_bwd": depth,
            "flash_attention_fwd": 0, "flash_attention_bwd": 0,
            "fused_adamw": 1, "fused_adamw_leaves": n_leaves})

    # -- 15. agreement in f32 ------------------------------------------------------
    print("== 15. f32: --fused all --attn vmem vs --fused none --attn xla, 4 steps")
    f32_agreement(
        (["--fused", "all", "--attn", "vmem"], {"flash_attention_fwd",
                                                "flash_attention_bwd"}),
        ["--fused", "none", "--attn", "xla"], batch=8, seq=1024,
        loss_bar=LOSS_BAR, param_bar=PARAM_BAR,
        what="f32 fused and unfused GPT-2 training")
    for e in entries:
        e["launches"] = counts[e["name"]]
    return entries


def long_context_phases(smi: str, dev) -> list[dict]:
    """Phases 16-19: the flash attention kernels and the long-context GPT-2
    training path. Returns their two entries of the ``kernels`` line,
    launches filled in."""
    import torch

    from tpudist_torch.ops import flash_attention as FA
    from tpudist_torch.ops import lm_kernels_bench as LB
    from tpudist_torch.ops import vmem_attention as VA
    from tpudist_torch.ops.attention import multi_head_attention, repeat_kv

    gen = torch.Generator(device=dev).manual_seed(SEED + 16)

    # -- 16. parity -----------------------------------------------------------------
    print("== 16. flash attention parity: o, lse, dq, dk, dv")
    attention_build("flash_attention.cu")
    for name, got, want in LB.flash_parity(gen):
        check(name, got, want, elem=True)
    if FAILURES:
        fail(f"flash attention parity: {FAILURES}")
    repeatable("flash", gen, LB.FB, LB.FS)
    # the model's router on the card: auto reaches the flash kernel from
    # S 2048 at every head dim it takes (grouped heads repeated first) and
    # raises past them, never going dense
    for d, h_kv in ((32, 4), (64, 4), (128, 4), (64, 2), (200, 4)):
        q, k, v, _ = LB.attn_inputs(gen, 1, 2048, 4, h_kv, torch.bfloat16, d=d)
        FA.reset_launch_counts()
        VA.reset_launch_counts()
        try:
            got = multi_head_attention(q, k, v, causal=True, impl="auto")
        except ValueError as e:
            routed = f"ValueError ({e})"
        else:
            kk, vv = repeat_kv(q, k, v)
            check(f"auto D {d} H_kv {h_kv}", got, FA.flash_fwd_plain(
                q, kk, vv, causal=True, kv_len=2048, scale=VA._scale(d))[0],
                elem=True)
            routed = (f"{FA.launch_counts['flash_attention_fwd']} flash, "
                      f"{VA.launch_counts['vmem_attention_fwd']} vmem launches")
        print(f"  auto at D {d}, H 4 / H_kv {h_kv}, S 2048: {routed}")
        if not (routed == "1 flash, 0 vmem launches" if d <= FA.MAX_HEAD_DIM
                else routed.startswith("ValueError")):
            FAILURES.append(f"auto D {d} H_kv {h_kv}: {routed}")
    if FAILURES:
        fail(f"flash attention routing: {FAILURES}")

    # -- 17. times ------------------------------------------------------------------
    print("== 17. flash attention kernel times (median of 50 device times, L2 "
          "flushed; bf16)")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    entries = []
    for case in LB.flash_timing_cases(gen):
        t = LB.time_case(case, flush)
        print(f"  {case['name']} [{case['shape']}]: kernel "
              f"{t['kernel_ms']:.4f} ms, bound {case['bound_ms']:.4f} ms "
              f"({case['bound_by']}), plain {t['plain_ms']:.4f} ms, library "
              f"(SDPA) {t['library_ms']:.4f} ms, max_abs_err "
              f"{case['max_abs_err']:.3e}  [{smi}]")
        entries.append(dict(
            name=case["name"], route="cuda", source=SOURCES[case["name"]],
            replaces=REPLACES[case["name"]], ms=t["kernel_ms"],
            plain_ms=t["plain_ms"], library_ms=t["library_ms"],
            max_abs_err=case["max_abs_err"], bound_ms=case["bound_ms"],
            bound_by=case["bound_by"]))
    del flush

    # -- 18. the long-context path, trained -----------------------------------------
    print("== 18. GPT-2 124M, bf16, S 4096, --fused all --attn auto "
          "--chunked_ce 256, 16 steps under DDP (NCCL)")
    counts = trained_gpt2(
        ["--bf16", "--fused", "all", "--attn", "auto", "--chunked_ce", "256"],
        batch=4, seq=4096, job="Long", smi=smi, want=lambda depth, n_leaves: {
            "layernorm_fwd": 2 * depth + 1, "layernorm_bwd": 2 * depth + 1,
            "layernorm_bwd_reduce": 2 * depth + 1, "vmem_attention_fwd": 0,
            "vmem_attention_bwd": 0, "flash_attention_fwd": depth,
            "flash_attention_bwd": depth, "fused_adamw": 1,
            "fused_adamw_leaves": n_leaves})

    # -- 19. agreement in f32 ------------------------------------------------------
    print("== 19. f32, S 2048, depth 4: --fused all --attn flash --chunked_ce "
          "256 vs --fused none --attn xla, 4 steps")
    f32_agreement(
        (["--fused", "all", "--attn", "flash", "--chunked_ce", "256"],
         {"vmem_attention_fwd", "vmem_attention_bwd"}),
        ["--fused", "none", "--attn", "xla"], batch=4, seq=2048,
        extra=["--depth", "4"], loss_bar=LONG_LOSS_BAR,
        param_bar=LONG_PARAM_BAR,
        what="f32 flash + chunked CE and dense + full-logits GPT-2 training")
    for e in entries:
        e["launches"] = counts[e["name"]]
    return entries


def attention_build(source: str) -> None:
    """Print the attention kernels' registers and spills, forwards and
    backward, from ``source``'s build report; fail if a bf16 HD 64
    tensor-core instantiation spills."""
    from tpudist_torch.ops import lm_kernels_bench as LB

    lines, spilled = LB.attention_build(source)
    print(f"  {source} forward and backward kernels (-Xptxas -v):")
    for line in lines:
        print("    " + line)
    if not any("fwd_mma" in ln for ln in lines):
        fail(f"no tensor-core forward in the build report of {source}")
    if spilled:
        fail(f"bf16 HD 64 tensor-core kernels spill: {spilled}")


def repeatable(kind: str, gen, b: int, s: int) -> None:
    """Fail unless two bf16 calls of ``kind``'s forward give bit-identical
    o and lse, and two of its backward bit-identical dq, dk and dv, on the
    same inputs (no atomics)."""
    from tpudist_torch.ops import lm_kernels_bench as LB

    same = LB.repeat_identical(kind, gen, b, s)
    print(f"  two bf16 forward calls at B {b}, S {s}: o, lse bit-identical: "
          f"{same['forward']}; two backward calls: dq, dk, dv "
          f"bit-identical: {same['backward']}")
    if not all(same.values()):
        fail(f"the bf16 {kind} kernels are not deterministic: {same}")


def tied_head_phase(dev) -> None:
    """Phase 20: the bf16 tied head's logits and gradients on the card
    against the upcast plain version (module docstring)."""
    import torch
    import torch.nn.functional as F

    from tpudist_torch.models.gpt2 import tied_head
    from tpudist_torch.ops import lm_kernels_bench as LB

    print("== 20. tied LM head, bf16, x [8192, 768] x wte [50257, 768]: "
          "logits, dx, dwte")
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    rows = LB.ROWS
    x = LB._rand(gen, (rows, LB.WIDTH), torch.bfloat16)
    wte = LB._rand(gen, (VOCAB, LB.WIDTH), torch.bfloat16, 0.02)
    targets = torch.randint(0, VOCAB, (rows,), generator=gen, device=dev)
    xk, wk = (t.clone().requires_grad_() for t in (x, wte))
    logits = tied_head(xk, wk)
    # the mean cross-entropy's cotangent of the logits, as training feeds it
    g = F.softmax(logits.detach(), -1)
    g[torch.arange(rows, device=dev), targets] -= 1.0
    g /= rows
    got = torch.autograd.grad(logits, (xk, wk), g)
    xp, wp = (t.clone().requires_grad_() for t in (x, wte))
    plain = xp.float() @ wp.float().t()
    check("logits (f32)", logits.detach(), plain.detach())
    want = torch.autograd.grad(plain, (xp, wp), g)
    del plain, logits
    gb = g.to(torch.bfloat16)
    old = (torch.mm(gb, wte, out_dtype=torch.float32).to(torch.bfloat16),
           torch.mm(gb.t(), x, out_dtype=torch.float32).to(torch.bfloat16))
    for name, a, o, w in zip(("dx", "dwte"), got, old, want):
        share = lambda t: float((t != w).float().mean())
        check(f"{name} (g as hi + lo), {share(a):.4%} of elements differ",
              a, w, elem=True)
        print(f"    the old backward (g as one bf16): {share(o):.4%} of "
              f"elements differ, {LB.elem_reading(o, w)}, element bar "
              f"{'held' if LB.max_err(o, w)[1] else 'missed'}")
    if FAILURES:
        fail(f"tied head: {FAILURES}")


def counted_modules():
    """The wrapper modules whose launch counts the GPT-2 phases read."""
    from tpudist_torch.ops import flash_attention as FA
    from tpudist_torch.ops import fused_update as FU
    from tpudist_torch.ops import layernorm as LN
    from tpudist_torch.ops import vmem_attention as VA

    return LN, VA, FA, FU


def launches() -> dict:
    return {k: n for mod in counted_modules()
            for k, n in mod.launch_counts.items()}


def trained_gpt2(flags, *, batch: int, seq: int, job: str, smi: str,
                 want) -> dict:
    """Phases 14 and 18: a 1-rank NCCL group, then ``train_gpt2.main``
    with GPT-2 124M at full width and depth, ``flags``, the profiler on,
    16 steps on :func:`lm_kernels_bench.token_file`'s text, every launch
    count set to 0 just before and read just after. Fails unless it ran
    under DDP, launched ``want(depth, the model's leaves)`` kernels per step
    (one fused-AdamW launch covering all 148 leaves), and wrote finite,
    falling losses, the
    tokens/sec line, the TSV rows and a trace with device work. Returns
    the launch counts."""
    import contextlib
    import io

    import numpy as np
    import torch
    import torch.distributed as dist

    from tpudist_torch import train_gpt2 as TG
    from tpudist_torch.ops import lm_kernels_bench as LB

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                      RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    dist.init_process_group("nccl", init_method="env://")
    with tempfile.TemporaryDirectory() as log_dir:
        tokens = LB.token_file(Path(log_dir) / "text.bin", 16 * batch * seq)
        for mod in counted_modules():
            mod.reset_launch_counts()
        out = io.StringIO()
        torch.cuda.synchronize()
        with contextlib.redirect_stdout(out):
            state, losses = TG.main([
                *flags, "--batch_size", str(batch), "--seq_len", str(seq),
                "--tokens", str(tokens), "--JobID", job,
                "--log_dir", log_dir])
        torch.cuda.synchronize()
        counts = launches()
        printed = out.getvalue()
        print("  " + "\n  ".join(printed.strip().splitlines()[-3:]))
        if not isinstance(state.module, torch.nn.parallel.DistributedDataParallel):
            fail("the training step did not run under DDP")
        dist.destroy_process_group()
        model = state.model
        rows = (Path(log_dir) / f"{job}_{batch}_0.log").read_text().splitlines()
        traces = list((Path(log_dir) / f"log_{job}").glob("*.pt.trace.json"))
        window = trace_breakdown(traces[0]) if traces else None
    steps = len(losses)
    n_leaves = len(list(model.parameters()))
    per_step = want(model.depth, n_leaves)
    print(f"  {steps} steps; launches {counts} (per step {per_step}); losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    del state, model
    if steps != 16 or n_leaves != 148 or any(
            counts[k] != n * steps for k, n in per_step.items()):
        fail(f"{steps} steps, launches {counts}, want {per_step} per step")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"losses {losses}")
    line = [ln for ln in printed.splitlines() if ln.startswith("tokens/sec: ")]
    if len(line) != 1 or f"steps={steps} " not in line[0]:
        fail(f"no tokens/sec line for {steps} steps in the run's output")
    g_steps = [r.split("\t")[1] for r in rows[1:] if not r.startswith("TrainTime")]
    if g_steps != ["5", "10", "15"] or not rows[-1].startswith("TrainTime\t"):
        fail(f"TSV rows {rows}")
    if not traces or not window["steps"] or not window["kernels_per_step"]:
        fail(f"no device work in a profiler trace under log_{job}: {window}")
    train_s = float(rows[-1].split("\t")[1])
    eps15 = float(rows[3].split("\t")[4])
    step_ms = batch / eps15 * 1e3
    print(f"  TSV: rows at g_step 5/10/15 + TrainTime {train_s:.3f} s; step at "
          f"g_step 15 {step_ms:.2f} ms ({eps15 * seq:.1f} tokens/s); "
          f"{steps * batch * seq / train_s:.1f} tokens/s over the run (profiler "
          f"window and first step included)  [{smi}]")
    print(f"  profiler window ({window['steps']} steps, profiled): "
          f"{window['kernels_per_step']:.0f} kernels/step, device busy "
          f"{window['device_ms_per_step']:.2f} ms/step of "
          f"{window['window_ms_per_step']:.2f} ms/step wall; busy share of the "
          f"unprofiled g_step-15 step {window['device_ms_per_step'] / step_ms:.3f}")
    for name, ms, count in window["top"]:
        print(f"    {ms:8.3f} ms/step  {count:5.0f}/step  {name}")
    return counts


def f32_agreement(kernel_path, dense_flags, *, batch: int, seq: int,
                  loss_bar: float, param_bar: float, what: str,
                  extra=()) -> None:
    """Phases 15 and 19: four float32 steps of the kernels' path
    (``kernel_path`` = (flags, the counted kernels it must NOT launch))
    and of the dense path from the same init on the same batches, one
    process. The kernels' run must launch every other counted kernel and
    the dense run none. Losses are held to ``loss_bar`` relative and
    parameters to ``param_bar`` absolute, except the key slice of the qkv
    biases, whose gradient is zero in exact arithmetic (Adam turns its
    rounding into a full step of either sign): on both runs it stays
    within 1.5 x steps x the peak lr of its zero init."""
    import contextlib
    import io

    from tpudist_torch import train_gpt2 as TG
    from tpudist_torch.ops import lm_kernels_bench as LB

    (kernel_flags, unused) = kernel_path
    runs = []
    with tempfile.TemporaryDirectory() as log_dir:
        tokens = LB.token_file(Path(log_dir) / "text.bin", 4 * batch * seq)
        for flags, kernels in ((kernel_flags, True), (dense_flags, False)):
            for mod in counted_modules():
                mod.reset_launch_counts()
            with contextlib.redirect_stdout(io.StringIO()):
                st, ls = TG.main([
                    *flags, *extra, "--batch_size", str(batch), "--seq_len",
                    str(seq), "--tokens", str(tokens), "--no_profiler",
                    "--log_dir", log_dir])
            ran = launches()
            used = {k for k, n in ran.items() if n}
            if used != (set(ran) - unused if kernels else set()):
                fail(f"{' '.join(flags)}: launches {ran}")
            runs.append((ls, {k: v.float().cpu() for k, v in st.params().items()}))
            del st
    (lf, pf), (ln, pn) = runs
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
    print(f"  losses {lf} vs {ln}: max rel {loss_rel:.3e} [bar {loss_bar:g}]; "
          f"params max abs {gaps[worst]:.3e} ({worst}) [bar {param_bar:g}]; "
          f"key slice of the qkv biases moved at most {key_moved:.3e} [step "
          f"bound {key_bound:.2e}]")
    if (len(lf) != 4 or loss_rel > loss_bar or gaps[worst] > param_bar
            or key_moved > key_bound):
        fail(f"{what} disagree")


def trace_breakdown(path: Path) -> dict:
    """Per-step device work in a ``torch.profiler`` Chrome trace: kernels,
    the card's busy time (the union of kernel, memcpy and memset
    intervals), the window's wall time (its ``ProfilerStep#`` spans) and
    the eight kernels that take the most time."""
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
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
