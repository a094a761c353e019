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
    build report (a spill in a bf16 forward instantiation for D 768, or
    in any bf16 or f32 backward instantiation for D up to 768, fails),
    then the forward and backward kernels against their plain versions
    at GPT-2's 8192 x 768 rows, a ragged 1000 x 200, 1000 x 197 (no
    multiple of 16 bytes: the element-wise paths), 1000 x 768 rows
    starting one element into their buffers (misaligned: the element-wise
    paths again), 3 x 768 (fewer rows than a backward block has warps),
    65536 x 768 (many rows a warp of the backward's persistent grid) and
    1000 x 2048 (the widest rows; the backward stages its column sums),
    the three compositions, RMS on and off, f32 and bf16: n, r, dx = dy,
    dscale, dbias under the parity rule of phase 2 and, for bf16 outputs,
    element by element within 2 bf16 ulps plus 2^-14 of the largest
    magnitude (lm_kernels_bench.ELEM_ULPS / ELEM_ATOL); two bf16 calls at
    8192 x 768, plain and pre-norm, must be bit-identical, the forward in
    n and r, the backward in dr, dscale and dbias;
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
    scaled_dot_product_attention forward and backward); the LayerNorm
    backward also at the long-context path's 16384 x 768 rows;
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
21. (no phase: the number was the result line's before phases 22-25);
22. the ViT path, trained — a 1-rank NCCL group, then
    ``tpudist_torch.main.main`` with ViT-B/16 at full width and depth on
    2048 synthetic 32x32 images (4-pixel patches: 65 tokens), batch 128,
    --bf16 --fused all, the profiler on: 16 steps under DDP; launches per
    step (LN forward 25, backward 25 plus 25 reductions, fused AdamW 1
    covering all 152 leaves, no attention kernel: ``main.py``'s ViT runs
    the dense attention, no guard check), finite losses, TSV rows at
    g_step 5, 10 and 15 and TrainTime, images/s, and the trace's kernels
    and busy share per step;
23. agreement — in f32 with cudnn.deterministic, four ViT-B/16 steps of
    --fused all and of --fused none from the same init on the same
    batches, held to VIT_LOSS_BAR / VIT_PARAM_BAR with the qkv key slice
    held to its step bound as in phase 15; then one sgd step with
    --grad_accum 2 against one flat step (--fused ln), held to
    ACCUM_LOSS_BAR / ACCUM_PARAM_BAR;
24. ViT-B/16 at the ImageNet shape through the model API (16-pixel
    patches on 224x224, batch 32, 197 tokens): bf16 forward and backward
    with fused_ln, finite, 25 launches of each LayerNorm kernel; in f32,
    fused_ln True against False and attn_impl "vmem" (non-causal, ragged
    197; 12 forward and 12 backward launches) against "xla": logits and
    every gradient under the f32 parity rule of phase 11;
25. --amp and the optimizers — fused AdamW under the guard at ViT-B's
    152 leaves (``fused_update_bench.guard_check``): a step fed one inf
    leaves m, v, the masters and the copy bit-identical, takes one check
    and one update launch, counts one skip and no step; the next finite
    step is bit-identical to an unguarded optimizer that never saw the
    bad batch; the guarded and unguarded step's device times and the
    check's alone, beside its byte bound; one step each of sgd, lamb, lion
    and muon at ViT-B's leaf shapes (depth 2), card against CPU in f32,
    the parameters' difference beyond one ulp under OPT_BARS of the
    largest update; then --amp --fused all through the CLI for 4 ViT
    steps (bf16 copy, one check launch a step, no step skipped);
26. the device-cached path, trained — a 1-rank NCCL group, then
    ``tpudist_torch.main.main`` with ResNet-50 on 2048 synthetic images
    held on the card as uint8 (``--device_cache``, 6.3 MB), batch 128,
    --bf16 --fused optimizer --augment (the crop, flip and normalization
    on the card, after the gather), the profiler on: 16 steps; one fused
    AdamW launch a step covering all 161 leaves, finite losses, TSV rows
    at g_step 5, 10 and 15 and TrainTime, images/s and the busy share, and
    from the trace the host-to-device bytes a step, held under
    CACHE_H2D_BAR (the indices and labels, never an image batch);
27. agreement — in f32 with cudnn.deterministic, four ResNet-50 steps of
    --device_cache (no augment) and of the host loader from the same init
    on the same sampler order: bit-identity printed, held to phase 10's
    1e-5;
28. the LM path with the new flags, trained — a 1-rank NCCL group, then
    ``tpudist_torch.train_gpt2.main`` with GPT-2 124M at full width and
    depth, --bf16 --fused all --attn auto --amp --dropout 0.1 --remat full,
    batch 8, S 1024, 16 steps on phase 14's text, then --eval on the
    held-out rest of that text and --generate 32 at temperature 0: launches
    a step (LN forward 50 and vmem forward 24, the whole forward twice; LN
    backward 25 plus 25 reductions, vmem backward 12, one finite check and
    one fused AdamW covering 148 leaves), finite and falling losses, the
    TSV rows and the tokens/sec line, the trace's busy share; the eval
    batches each 25 LN and 12 vmem forwards and nothing else, the val_loss
    line; --generate 12 x 32 contiguous decode launches; then the peak
    memory of 4 steps with --remat_policy full, --remat_policy
    dots_saveable and no remat, in that order or the phase fails (the
    reference's per-block order), the whole forward's (--remat full)
    beside them;
29. agreement — in f32, four steps of --dropout 0.1 --remat full and of
    --dropout 0.1 from the same init: bit-identity printed, held to phase
    15's LOSS_BAR / PARAM_BAR; --init_hf from a checkpoint that
    ``interop.save_hf_checkpoint`` wrote from a seeded model: the first
    loss within the f32 parity rule of that model's on the same batch;
    --optimizer sgd, lamb, lion and muon through the CLI at depth 2 (two
    finite steps each), and one step of each at GPT-2's leaf shapes
    (depth 2), card against CPU, under OPT_BARS as in phase 25;
30. a ``{"kernels": [...]}`` line with all nine kernels and the two wide
    LayerNorm variants; then the last line, ``{"ok": true, "device":
    {...}}`` (printed after phases 31-38);
31. recovery, ResNet-50 — ``python -m tpudist_torch.launch
    --nproc_per_node 1`` runs ``tpudist_torch.main`` (through this
    script's ``--recovery_child`` mode, which forms a 1-rank NCCL group,
    sets cudnn.deterministic, zeroes the launch counts and writes each
    life's losses and counts) with ResNet-50, --bf16 --fused optimizer
    --amp, 2048 synthetic images, batch 128, 16 steps, --checkpoint_every
    4: once uninterrupted, once with --max_restarts 1 and --chaos
    corrupt@12 (the newest step, 12, is truncated and the process
    crashes; the relaunched generation reports the fallback, sets step 12
    aside under _failed/, restores step 8 and trains steps 9..16). The
    resumed losses must equal the uninterrupted run's steps 9..16 and
    every tensor of the two runs' step-16 checkpoints (masters, moments,
    BN buffers) must be bit-identical; each life launches fused AdamW
    and its finite check once a step, covering all 161 leaves (the four
    launched runs of phases 31 and 32 start together, beside phases
    60-65's two-rank world, and are checked after it);
32. recovery, GPT-2 — the same with ``tpudist_torch.train_gpt2``, GPT-2
    124M at S 1024, batch 8, --bf16 --fused all --amp --attn auto, 16
    steps on phase 14's text, --checkpoint_every 6: uninterrupted, and
    with --chaos sigterm@8 (the first life writes the emergency checkpoint
    at step 8 and exits 75; the launcher relaunches generation 1, which
    resumes at step 9): losses and the step-16 checkpoints bit-identical,
    and in each life the launches a step of phase 14 plus the finite
    check;
33. checkpoint costs, in this process under a 1-rank NCCL group, for
    ResNet-50 (bf16 --fused optimizer --amp) and GPT-2 124M (bf16 --fused
    all --amp) after two steps, with keep_last 2: a step's bytes on disk
    (about 0.31 and 1.49 GB: float32 masters, m and v), what an
    asynchronous save blocks the loop (the host copy queued behind one
    event), its background write, an emergency ``wait=True`` save and a
    restore, with the card's name and power limit;
34. wide-row LayerNorm — the wide kernels' registers and spills (32
    instantiations, none may spill), then ``ln_fwd_wide_kernel`` and
    ``ln_bwd_wide_kernel`` (rows past 2048) against their plain versions
    at 1000 x 2560, 8192 x 4096, 1000 x 5120, 2048 x 8192 and the
    element-wise paths (1000 x 4100; 512 x 4096 one element in), plain and
    pre-norm, RMS on and off, f32 and bf16, under phase 11's bars; two
    bf16 RMS calls at 4096 x 4096 and at 2048 x 8192 bit-identical; one
    forward and one backward at D 768, 2048, 2056, 4096 and 8192 launch the
    register kernels up to 2048 and the wide ones past it; D 8200 raises
    ValueError naming the widest row; then each wide kernel's launch at
    4096 x 4096 (a Llama-3-8B step's rows) and 2048 x 8192 (blocks,
    threads, cluster size, the backward's partial rows, blocks resident an
    SM, row slots, rows a step, columns a thread), and the median device
    times there beside the byte bound, the plain version and
    ``F.rms_norm`` / ``F.layer_norm`` (and their backward through
    autograd);
35. llama_125m, trained — ``train_gpt2.main --arch llama --num_kv_heads 4
    --vocab_size 32000 --bf16 --fused all --attn auto`` (12 x 768, GQA
    12/4, SwiGLU 2048, an untied head), batch 8, S 1024, 16 steps on phase
    14's text under a 1-rank NCCL group: launches a step (RMS LN forward 25,
    backward 25 plus 25 reductions, vmem forward 12 and backward 12 over
    grouped heads, one fused AdamW over 111 leaves), and phase 14's TSV,
    tokens/sec and trace readings;
36. agreement — in f32 at depth 2, four steps of --fused all --attn vmem
    and of --fused none --attn xla from the same init, under phase 15's
    LOSS_BAR / PARAM_BAR;
37. Llama decode — llama_125m in bf16 with ``attn_impl="fused"``:
    ``generate()`` on B 4, prompt 64, 32 new tokens (the contiguous kernel
    12 x 32 times over the cache's 4 K/V heads), then
    ``ServeEngine(paged=True, block_size=32, max_slots=8)`` on 8 requests
    as phase 4 serves them (the paged kernel 12 times per decode step);
    in f32 the engine with ``"fused"`` and with ``"xla"`` gives identical
    greedy streams;
38. Llama-3-8B width at depth 2 — ``--arch llama --hidden_dim 4096
    --depth 2 --num_heads 32 --num_kv_heads 8 --ffn_dim 14336 --vocab_size
    128256 --rope_theta 500000 --bf16 --fused all --attn auto --chunked_ce
    256``, batch 2, S 2048, 16 steps (depth cut from 32 so one card holds
    the AdamW state): launches a step (the wide LN kernels 5 / 5 + 5, flash
    forward and backward 2 each at head dim 128, one fused AdamW over 21
    leaves), the TSV and trace readings, the wide LN kernels' device time
    a step from the trace and the peak device memory;
39. context-parallel attention (``tpudist_torch.parallel.cp``) at GPT-2
    124M's long-context shape, B 4, H 12, dh 64, S 4096, causal and not,
    f32 and bf16: the ring at n = 1 against the dense plain version (the
    kernel-parity rule of phase 2); the loopback ring at n = 4 (all four
    ranks' shards in this process, every hop and the backward's reverse
    ring) against n = 1, forward and q/k/v gradients, under the
    reference's CP tolerances in f32 (1e-5 forward, 1e-4 gradients,
    absolute and relative) and the parity rule in bf16; Ulysses with the
    kernel attention at n = 1 against ``flash_attention`` on the same
    inputs, forward and gradients bit-identical (the re-shard is the
    identity); the loopback Ulysses at n = 4, whose all-to-all hands the
    flash kernel (S 4096) and the vmem kernel (S 1024) contiguous ``[B, S,
    H/4, D]`` tensors, against the kernel on all heads, under phase 11's
    element bar with bit-identity printed; the ring's and flash's forward
    and forward + backward times at n = 1;
40. ``train_gpt2 --cp 1 --attn ulysses_flash`` — phase 18's configuration
    (GPT-2 124M, S 4096, batch 4, bf16, --fused all --chunked_ce 256),
    16 steps: the flash kernels 12 + 12 a step, and losses equal to phase
    18's bit for bit (at n = 1 the Ulysses body calls the same kernel on
    the same inputs); then phase 38's Llama-3-8B-width leg the same way
    (K/V heads repeated before the attention), against phase 38's losses;
41. ``train_gpt2 --cp 1 --attn ring`` — GPT-2 124M, S 1024, batch 8,
    bf16, --fused all, 16 steps, against ``--attn xla`` under
    ``RING_BF16_BAR``; no attention kernel launches on either; the step
    times and peak device memory of both (the ring saves the row
    log-sum-exp, the dense path its bf16 probabilities); then in f32 at
    depth 2, four steps of ``--fused all --attn ring`` against ``--fused
    none --attn xla`` under phase 15's bars;
42. BERT-base (12 x 768, 12 heads, model vocab 30523) — the bf16 vmem and
    flash kernels non-causal at B 32, H 12, S 512 held to their plain
    versions (o, lse, dq, dk, dv under phases 12 and 16's rule), then timed
    with SDPA, forward and forward + backward, beside their bound (bytes of
    each call, the function's six products); the MLM head's tied product at
    one 128-position chunk (4096 x 768) against V 30523 and 30528; then
    ``train_bert --bf16 --attn flash --chunked_ce 128`` at the CLI's
    defaults (S 512, batch 32), 16 steps under DDP on phase 14's text as
    uint16 ids: the flash kernels 12 + 12 a step and nothing else counted,
    finite losses, the TSV and trace readings (the head's products among
    the top entries), then ``--eval`` (12 flash forwards a batch); then the
    same model and batches through the model API, ``fit(fused="all")`` with
    ``make_optimizer(fused=True)`` (bf16 compute copy) and
    ``attn_impl="auto"``: a step launches each LN kernel 25 times (``ln_embed``
    plain, 24 post-norm compositions at eps 1e-12), vmem 12 + 12 (S 512),
    and one AdamW over all 154 leaves;
43. f32 BERT at depth 2 (bert-base width, S 512, batch 32), 4 Adam steps at
    lr 1e-4 through the model API: ``fused="all"`` with flash, then with
    vmem, against ``fused=None`` with the dense attention under
    ``BERT_LOSS_BAR`` / ``BERT_PARAM_BAR``; ``ulysses_flash`` over a
    one-rank layout bit-identical to ``attn_impl="auto"`` (losses and
    parameters); the ring over it against the dense attention under the
    same bars; an ``attention_mask`` batch on the dense path, finite;
44. T5 (t5-v1.1-small: d 512, ffn 1024, 8 + 8 layers, 6 heads of 85) —
    ``train_t5 --bf16 --eval --generate`` at its defaults (byte vocab,
    windows of 512, batch 16), 16 steps under DDP: no counted kernel and no
    decode kernel in the training, ``--eval`` or ``--generate`` (the
    relative bias keeps every attention dense), the TSV and trace readings;
    then in f32 with the
    trained weights, greedy ``generate_seq2seq`` of the span targets for 4
    windows equal to the full-forward greedy rollout;
45. ImageNet at 224x224 — packs written from ``synthetic_imagenet`` with
    numpy (2048 training rows, 308,281,344 bytes, and 512 validation rows
    of the same 1000 classes, in a temporary directory), then ``main.main
    --model resnet50 --dataset imagenet --packed P --packed_val V --bf16
    --fused optimizer --batch_size 128 --eval``, 16 steps under DDP
    (NCCL): one AdamW launch over 161 leaves a step and no other counted
    kernel, the TSV and trace readings with the ``HBM`` row, the
    host-to-device bytes a step (the 19,267,584-byte uint8 batch plus at
    most ``CACHE_H2D_BAR``), the native gather's host ms a batch and the
    top-1 line; where PIL is installed, a JPEG tree the smoke writes
    packed by ``pack_image_folder`` (equal to the eval loader's pixels)
    and streamed through ``ImageFolderLoader`` on 4 decode threads;
46. the same with ``--device_cache --augment``: host-to-device bytes a
    step under ``CACHE_H2D_BAR``;
47. the same with ``--device_cache --cache_shard_rows 512`` (4 shards of
    77,070,336 bytes, 4 steps each): the staged shards and the index
    batches follow the rotation's (seed, epoch) plan and cover every row
    once; each shard's staging, boundary wait and whether its copy was
    done at first use; the peak memory beside phases 45 and 46; then the
    rotation alone through ``prefetch_to_device``: every batch gathered on
    the card bit-identical to a host gather of its rows, every row once,
    and at most three shards (and two gathered batches) of device memory;
48. ``--model vit_b16`` at 224x224 (16-pixel patches, 197 tokens) from the
    pack, ``--bf16 --fused all``, 16 steps: LN 25 / 25 + 25 and one AdamW
    over 152 leaves a step, the TSV and trace readings;
49. ``memory.train_state_budget`` (built on the meta device) with
    ``format_budget`` beside the allocator's peak: phase 48's ViT-B/16 and
    phase 28's GPT-2 124M without remat;
50. kernel times by phase 13's method: vmem and flash, forward and each
    backward alone, at BERT-base's B 32, H 12, S 512 non-causal beside SDPA
    and the bound; the LayerNorm kernels at ViT-B/16 224's 25,216 x 768
    rows, eps 1e-6, beside ``F.layer_norm``;
51. a non-context-parallel attention over the gathered sequence
    (``parallel.cp.gathered_attention``, the ``--cp N --attn
    vmem|flash|auto`` path), loopback n = 4, bf16: the vmem kernels at GPT-2
    124M's B 8, H 12, dh 64, S 1024 causal, the flash kernels at B 4, S
    4096, and vmem over grouped K/V heads (12 / 4) at llama_125m's widths:
    o, dq, dk, dv bit-identical to the kernel on the whole sequence, the
    forward and backward launched once per rank, and the time per rank
    beside the whole-sequence call;
52. speculative serving, the main path — phase 4's configuration (GPT-2
    124M, bf16, ``ServeEngine(paged=True, block_size=32, max_slots=8)``, the
    same 8 requests) with ``early_exit_draft(model, 4)`` and ``spec_k 4``:
    the paged kernel 12 times per verify pass, every launch at ``s_q`` 5;
    drafted, accepted and the acceptance rate, TPOT p50 and tokens/s
    beside phase 4's, how many greedy streams equal phase 4's; then the
    paged kernel at the verify shape (B 8, ``s_q`` 5, phase 3's cursors)
    held to its plain version and timed beside the bound and SDPA; and
    where a speculative pass's time goes (``spec_pass_split``): the draft
    forwards, the draft's sampling, the verify forward, the K/V writes
    inside both, acceptance, each between two synchronisations, then one
    pass under the profiler for its kernel-busy time and kernel count;
53. agreement in f32: the speculative engine against the plain engine,
    paged, greedy, GPT-2 124M at full width (draft depth 4) and llama_125m
    at full width cut to depth 4 with a stop token (draft depth 2):
    identical streams; the smallest top-2 logit gap is printed;
54. the serving CLIs — ``python -m tpudist_torch.serve --full --bf16
    --paged --spec_draft 4 --spec_k 4`` and ``python -m tpudist_torch.main
    --serve --spec_draft 1`` exit 0 and their ``serve`` rows carry the
    speculative fields; a paged engine with ``spec_k`` 16 raises
    ``ValueError`` (the kernel takes at most 16 query rows);
55. the quantized ring (``comm.ring_allreduce_quantized``), loopback n = 4
    on the card: GPT-2 124M's gradient shapes flattened by
    ``BucketLayout``, each simulated rank its own random gradient,
    stochastic rounding keyed per rank: every rank's sum bit-identical,
    within ``w A / 127`` of the exact float32 sum (``A`` the ranks' amax
    summed: the bound of tests/test_torch_comm.py), int8 on the wire at
    least 3x under float32 (``wire_bytes``); one reduction's time per rank
    beside the bound of one pass over its buckets (read them, write the
    sum: 8 bytes an element);
56. ZeRO-1 through the fused AdamW kernel, loopback n = 4: over
    ResNet-50's 161 leaves and GPT-2 124M's 148, each list with two leaves
    no dim of divides by 4 added (37 x 111 and 1027 elements: every
    leaf of the two models divides), bf16 gradients and copy, wd 0.1,
    with ``shard``, ``pad`` and ``replicate`` leaves: each
    simulated rank's update is one kernel launch over its slices, and the
    four ranks' slices put together are bit-equal to the replicated
    one-launch step (m', v', the masters and the copy); under the
    ``--amp`` guard each rank adds one check launch over its slices, a
    finite step is bit-equal to the unguarded one, and a NaN in the last
    rank's slice sets that rank's flag alone (which a world sums over its
    data group), whose update then writes nothing; the kernel's time
    over one rank's slices beside the replicated launch and phase 8's
    bound (the rank's and the whole step's);
57. FSDP on the card, a 1-rank NCCL group: GPT-2 124M at full width,
    bf16, S 1024, batch 8, wrapped by ``parallel.fsdp.apply_fsdp`` (a
    layout whose fsdp group is the one rank: every leaf of 1024 elements
    or more a shard, FSDP2's gathers, its bf16 cast of the float32 master
    shards and its reductions run for real), ``fit(plan=)``
    --fused all --attn vmem: 8 steps with 25 / 25 + 25 LN, 12 + 12 vmem and
    two fused AdamW launches over the 148 leaves a step (the kernel
    launches once for each mix of gradient and copy dtypes: FSDP's shards
    take float32 gradients and FSDP's cast as their copy, the replicated
    leaves bf16 gradients and the kernel's copy; the kernels read what FSDP
    gathered; a misaligned or non-contiguous operand raises), finite
    losses, the step time beside phases 14's and 28's; then four float32
    steps wrapped and unwrapped from one init held to phase 15's bars;
58. the CLIs at one rank: ``python -m tpudist_torch.main --reduce
    quantized`` (the 1-rank reducer resolves ``none``: printed) and
    ``python -m tpudist_torch.train_gpt2 --shard_opt_state --amp`` exit 0;
    ``main --dataset digits`` raises ``ImportError`` naming scikit-learn
    where it is missing (and trains where it is installed);
59. tensor-parallel shard parity at full width, in this process: for
    GPT-2 124M (H 12, dh 64) at tensor worlds 2 and 4 and Llama-3-8B's
    width (H 32 / H_kv 8, dh 128) at 4, each rank's head slice (its
    ``H / T`` query and ``H_kv / T`` K/V heads) through the contiguous
    decode kernel (B 8, S 1024, cursor 1023), the paged kernel (8 rows at
    phase 3's cursors, bs 32), vmem forward and backward (B 8, S 1024,
    causal) and flash forward and backward (S 4096, causal; B 4, or B 1 at
    Llama's width, K/V heads repeated), in bf16: the attention kernels'
    outputs bit-identical to the same head slice of the call over every
    head; the decode kernels' held to phase 2's bars with their bit-
    identity printed (their launch splits a short grid over more SMs, so
    a rank's call may add its PV partials in another order); each shard's
    and the whole call's CUDA-event ms;
60. two ranks on the one card (this script's ``--tensor_child`` mode:
    two processes on ``cuda:0``, a gloo group over CUDA tensors), the
    tensor-sharded serving CLIs: ``python -m tpudist_torch.serve --full
    --paged --tensor 2`` (GPT-2 124M, 8 requests x 32 greedy tokens) in
    bf16, with ``--spec_draft 4 --spec_k 4``, and in f32; ``main --serve
    --tensor 2``: every rank's counts set to 0 before each run and read
    after (the paged kernel on every decode step, a verify pass at s_q
    5); the f32 streams equal the one-rank CLI's (run here), the bf16
    ones' agreement printed; the demo serves every request;
61. the same world, ``train_gpt2 --tensor 2 --fused all --attn auto``:
    GPT-2 124M, batch 8, S 1024, 4 steps in bf16 (a rank's launches a
    step: LN 25 / 25 + 25, vmem 12 + 12 on its 6 heads, one fused AdamW
    over its shards and the replicated leaves), then ``--generate 32``
    (the contiguous kernel 12 x 32 a rank, the logits gathered; rank 0
    prints), and in f32 against the one-rank run from the same seed on
    the same text under phase 15's bars (the gathered parameters; the
    qkv key slice to its step bound); then llama_125m (GQA 12 / 4: 6 / 2
    heads a rank) and the long-context leg (S 4096, batch 2,
    ``--chunked_ce 256``: flash 12 + 12 a step) in bf16, 4 steps each;
62. tensor-parallel shard parity at BERT-base's attention (B 32, S 512,
    12 heads of 64, non-causal, bf16), in this process: each rank's 6
    heads through vmem and flash, forward and backward, bit-identical to
    those heads of the call over all 12; each rank's and the whole call's
    CUDA-event ms;
63. phase 60's world, BERT-base (model vocab 30523, S 512, batch 16, 4
    steps; its tied MLM head 15262 / 15261 rows a rank):
    ``train_bert --tensor 2 --attn flash --chunked_ce 128 --eval`` in
    bf16 and in f32 (a rank's launches a step: flash 12 + 12 on its 6
    heads, and 12 forward a batch of ``--eval``; the CLI has no fused
    LN or AdamW, as the reference's has none), both ranks' losses and
    ``--eval`` equal, the f32 run against the one-rank run from the same
    seed under phase 15's bars; then the model API, ``Bert(attn_impl=
    'vmem', layout=)`` through ``fit(fused='all')`` with the bf16 compute
    copy: LN 25 / 25 + 25 at eps 1e-12, vmem 12 + 12 and one fused AdamW
    over the rank's 154 leaves a step;
64. the same world, ViT-B/16 at phase 22's 32x32 (65 tokens, 100
    classes) on ``ViT(mesh=MeshConfig(tensor=2))`` through
    ``fit(fused='all')``, 4 steps of 128 images, bf16 copy and f32: LN 25
    / 25 + 25 at eps 1e-6 on whole rows and one AdamW over 152 leaves a
    step a rank, a rank's ``qkv.weight`` its [1152, 768] shard; the f32
    run against one rank's under phase 23's bars;
65. the same world, ``train_t5 --tensor 2`` at its defaults (t5-v1.1-
    small, 3 of its 6 heads of 85 a rank, S 512, batch 16, 4 steps): no
    counted kernel (phase 44); bf16 losses fall; in f32 with ``--eval
    --generate`` both ranks' losses and ``--eval`` equal and rank 0 alone
    prints, and an unsharded t5-small holding the gathered weights gives
    the two-rank run's greedy tokens, and its ``--eval`` within
    ``T5_F32_BAR``; the witness: t5-small from the CLI's init, forward
    and backward on the CLI's first batch at two ranks and at one, in
    float32 and in float64 (attention, norms, logits and loss in
    float64): the float64 loss and gathered gradients held to one rank's
    under ``T5_F64_LOSS_BAR`` / ``T5_F64_GRAD_BAR``, the two-rank float32
    loss to the float64 one within ``T5_F32_BAR``, and each float32 run's
    distance from float64 printed; then the 4-step f32 trajectories
    against the one-rank run's (they part: float32's own gradients are
    far from float64's), the parameters within ``T5_PARAM_BAR``, Adam's
    step bound;
66. seq x tensor shard parity, in this process: the heads a ``(seq,
    tensor)`` rank holds through the kernels against the same heads of
    the call over all of them (phase 59's method, bf16): flash forward
    and backward on 3 of GPT-2 124M's 12 heads (Ulysses over ``seq 2 x
    tensor 2``) at B 4, S 4096, causal, flash and vmem on 3 of BERT-
    base's at B 32, S 512, non-causal (``ulysses_flash`` takes vmem
    there), and vmem on 6 heads at B 8, S 1024, causal (the gathered
    attention under ``tensor 2``): bit-identical, each rank's and the
    whole call's ms;
67. four ranks on the one card (this script's ``--composed_child`` mode:
    four processes on ``cuda:0``, a gloo group over CUDA tensors, started
    beside phase 60's world and phases 31-32's runs), 4 steps a leg, every
    rank's counts set to 0 before each leg and read after, each leg's
    allocator peak a rank printed beside ``train_state_budget``'s line:
    ``train_gpt2 --fsdp 2 --tensor 2 --fused all``, GPT-2 124M, S 1024,
    batch 8 a replica, in bf16 (a rank's launches a step: LN 25 / 25 +
    25, vmem 12 + 12, AdamW 2 over 148 leaves: FSDP's float32-gradient
    shards and the bf16 leaves with their copy) then ``--eval`` (one
    batch a replica) and ``--generate 32`` (the contiguous kernel 12 x
    32), and in f32 against the one-rank run on both replicas' windows
    under phase 15's bars;
68. the same world, ``train_gpt2 --tensor 2 --shard_opt_state --fused
    all`` (data 2 x tensor 2): in bf16 one AdamW launch a rank a step over
    its ZeRO-1 slices; in f32 its losses and gathered parameters bit-
    equal to the same world's run without ``--shard_opt_state``, and both
    against the one-rank run under phase 15's bars;
69. the same world, seq x tensor: ``train_gpt2 --cp 2 --tensor 2 --attn
    ulysses_flash --seq_len 4096 --chunked_ce 256 --batch_size 4`` in
    bf16 (flash 12 + 12 a rank a step on 3 heads), ``--attn ring
    --seq_len 1024`` in f32 against the one-rank ``--attn ring`` run
    under phase 15's bars, and ``train_bert --tensor 2 --cp 2 --attn
    ulysses_flash --chunked_ce 128`` at bert-base, S 512, batch 16, bf16
    (vmem 12 + 12 a rank a step). The losses agree on the ranks of each
    replica;
70. two ranks on the one card (this script's ``--composed_child pipe``
    mode, a gloo group over CUDA tensors, started beside phase 71's world
    after the worlds of phases 60-69 are done), ``train_gpt2 --pipe 2
    --num_micro 4 --batch_size 8 --fused optimizer``, GPT-2 124M, S 1024,
    4 steps a leg: in bf16 under GPipe and 1F1B (a rank's launches a step:
    one AdamW over its 76 leaves, 6 blocks x 12 + 4, and no other counted
    kernel: the pipelined blocks run the dense attention), in f32 under
    both (the first losses bit-equal, the rest within phase 15's bars;
    GPipe's checkpointed at step 2, against the one-rank ``--attn xla``
    run with the plain AdamW on the same windows under phase 15's bars),
    each leg's allocator peak a rank beside ``train_state_budget`` (1F1B's
    under GPipe's), ``--amp`` with a NaN in stage 1's gradients at step 2
    (both ranks skip it), and a resume from the step-2 checkpoint equal to
    the uninterrupted run bit for bit; both ranks log the same losses, and
    after every leg the stages' copies of ``wte``, ``wpe`` and ``ln_f``
    are bit-equal (nothing but equal bits keeps them so);
71. four ranks on the one card (beside phase 70's world): ``--pipe 2
    --tensor 2`` and ``data 2 x pipe 2`` in f32 under 1F1B against the
    one-rank ``--attn xla`` runs with the plain AdamW on their windows
    (``--grad_accum 2`` for both replicas' rows) under phase 15's bars,
    and ``--pipe 4`` in bf16 under GPipe (one AdamW a rank a step over its
    40 leaves); the stages' copies of the replicated leaves bit-equal
    after every leg, as in phase 70. The one-rank runs take ``--remat
    full`` (the same function; the card holds them beside the two
    worlds).

72. the experts, trained — ``train_gpt2 --experts 8`` (GPT-2 124M, blocks
    1, 3, .., 11 each 8 GELU experts routed top-2, capacity 1.25: 142
    leaves) at --bf16 --fused all --attn auto, batch 8, S 1024, 16 steps
    under DDP, once under ``--moe_dispatch einsum`` and once under
    ``index`` (then ``--generate 32``: the contiguous kernel 12 x 32):
    phase 14's launches a step (the MoE blocks leave LN and attention as
    they are; one AdamW over the 142 leaves), the TSV rows, falling
    losses, the step at g_step 15 and the allocator's peak beside
    ``train_state_budget``, the routed and dropped shares of the last
    step; then in f32 at depth 2 (block 1 MoE), 4 sgd steps at lr 0.1
    (``MOE_F32``: Adam would turn a gradient within rounding of zero, an
    expert row few tokens reach, into a step of either sign): --fused ln
    --attn vmem against --fused none --attn xla, and the einsum dispatch
    against the index dispatch, under phase 15's bars;
73. the experts, served — phase 4's engine and requests on the MoE GPT-2
    124M (every other block 8 experts) in bf16 under each dispatch: the
    paged kernel on every decode step, TTFT / TPOT, the streams' agreement
    between the dispatches printed; in f32 the greedy streams of the two
    dispatches equal; ``main --serve --serve_experts 8`` under each
    dispatch prints the same requests;
74. Mixtral-8x7B's width (d 4096, GQA 32/8, every block 8 SwiGLU experts
    of 14336 top-2, vocab 32000, theta 1e6) at the depth
    ``train_state_budget`` fits in 90% of the card (2, else 1), bf16,
    --fused all --attn auto --chunked_ce 256, batch 2, S 2048, 16 steps
    under DDP: the wide RMSNorm kernels 2 x depth + 1 each way, flash
    depth each way, one AdamW over the 3 + 10 x depth leaves (a stacked
    expert leaf holds 469,762,048 elements), the allocator's peak beside
    the budget;
75. four ranks on the one card (phase 71's world, after its legs):
    GPT-2 124M's width at depth 4 with ``--experts 8 --expert_axis 2
    --remat_policy full --chunked_ce 256``, 4 steps: f32 (--fused ln,
    sgd as phase 72's) on data 2 x expert 2 (index dispatch) and on
    expert 2 x tensor 2 (einsum) against the one-rank einsum run on the
    same windows (here, beside the worlds) under phase 15's bars; bf16
    (--fused all) on data 2 x expert 2 with --shard_opt_state and
    checkpoints at steps 2 and 4 (a rank's
    launches a step: LN 17 / 9 + 9, vmem 8 + 4 (each block recomputed),
    one AdamW), then a resume from step 2 bit-equal to the uninterrupted
    steps 3-4.

Phases 22-29 and 31-75 print their seconds.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
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
#: each trained CLI phase's step at g_step 15 (ms), by its JobID
STEP_MS: dict[str, float] = {}
#: phase 23's bars on the f32 ViT-B/16 kernel and plain-op paths after 4
#: steps (relative on the losses, absolute on the parameters), set from
#: the first reading on the H100 (losses 1.6e-7 apart; parameters 1.6e-4,
#: in blocks.10.mlp.proj.weight): the runs take Adam at a constant lr 1e-3
#: from step 1 (phase 15's GPT-2 warms up from 0), and Adam moves a
#: coordinate whose gradient is within rounding of zero by up to lr a step
#: either way, so the parameter bar is one step of lr
VIT_LOSS_BAR, VIT_PARAM_BAR = 1e-5, 1e-3
#: phase 23's bars on one float32 sgd step with --grad_accum 2 against one
#: flat step: the two sum each gradient in other orders (~1e-7 of it), and
#: an sgd step moves a parameter by lr x its gradient
ACCUM_LOSS_BAR, ACCUM_PARAM_BAR = 1e-6, 1e-7
#: phase 25's relative bars, card against CPU, on one step of each
#: optimizer at ViT-B's leaf shapes (the largest difference of the two
#: updated parameters beyond one float32 ulp of the parameter, over the
#: largest update): sgd and lion are element-wise (the same roundings on
#: both), lamb's trust ratio sums its norms in other orders, muon's five
#: Newton-Schulz iterations run float32 products of up to 3072 terms
#: summed in other orders
OPT_BARS = {"sgd": 1e-6, "lion": 1e-6, "lamb": 1e-5, "muon": 1e-3}
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
            "flash_attention_bwd": "tpudist/ops/flash_attention.py:307",
            "layernorm_fwd_wide": "tpudist/ops/layernorm.py:189",
            "layernorm_bwd_wide": "tpudist/ops/layernorm.py:215"}
SOURCES = {"paged_decode_attention": "tpudist_torch/csrc/decode_attention.cu",
           "fused_decode_attention": "tpudist_torch/csrc/decode_attention.cu",
           "fused_adamw": "tpudist_torch/csrc/fused_update.cu",
           "layernorm_fwd": "tpudist_torch/csrc/layernorm.cu",
           "layernorm_bwd": "tpudist_torch/csrc/layernorm.cu",
           "vmem_attention_fwd": "tpudist_torch/csrc/vmem_attention.cu",
           "vmem_attention_bwd": "tpudist_torch/csrc/vmem_attention.cu",
           "flash_attention_fwd": "tpudist_torch/csrc/flash_attention.cu",
           "flash_attention_bwd": "tpudist_torch/csrc/flash_attention.cu",
           "layernorm_fwd_wide": "tpudist_torch/csrc/layernorm.cu",
           "layernorm_bwd_wide": "tpudist_torch/csrc/layernorm.cu"}
#: phase 41's relative bar on the bf16 ring and dense losses over 16 steps:
#: the two round differently (the dense path rounds p to bf16 before the
#: value product, the ring sums p v in f32 and rounds the output once),
#: about 2^-9 of an attention output, which the warmup's small steps carry
#: into the losses; a causal leak or a wrong hop moves them by far more
RING_BF16_BAR = 1e-2
#: phase 39's bars, the reference's own CP tolerances
#: (tests/test_context_parallel.py): f32, absolute and relative
CP_FWD_TOL, CP_GRAD_TOL = 1e-5, 1e-4
#: losses of trained_cli's runs, by job: phases 40-41 compare against them
TRAINED_LOSSES: dict[str, list[float]] = {}
#: the wide-row LayerNorm kernels' counts (rows past 2048), which no GPT-2
#: or ViT path launches
WIDE_LN = frozenset({"layernorm_fwd_wide", "layernorm_bwd_wide"})
#: the Llama phases' geometry flags: llama_125m (12 x 768, GQA 12/4, SwiGLU
#: 2048) at a 32000-token vocabulary, and Llama-3-8B's width (phase 38)
LLAMA_125M = ["--arch", "llama", "--num_kv_heads", "4", "--vocab_size",
              "32000"]
LLAMA3_8B_WIDTH = ["--arch", "llama", "--hidden_dim", "4096", "--depth", "2",
                   "--num_heads", "32", "--num_kv_heads", "8", "--ffn_dim",
                   "14336", "--vocab_size", "128256", "--rope_theta",
                   "500000"]


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
    phase4 = dict(snap=snap, streams=[out[r] for r in rids],
                  sampling=sampling)
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
    vit_phases(smi, dev)
    amp_phase(smi, dev)
    device_cache_phases(smi, dev)
    lm_flag_phases(smi, dev)
    checkpoint_costs(smi)
    kernels.extend(llama_phases(smi, dev))
    cp_attention_phase(smi, dev)
    cp_training_phases(smi)
    encoder_phases(smi, dev)
    imagenet_phases(smi, dev)
    kernel_table_phase(smi, dev)
    gathered_attention_phase(smi, dev)
    spec_serving_phase(smi, dev, phase4)
    spec_agreement_phase(dev)
    serve_cli_phase(smi, dev)
    data_parallel_phases(smi, dev)
    tensor_phases(smi, dev)
    moe_phases(smi, dev)
    pipe_phases(smi)

    # -- 30. result ---------------------------------------------------------------
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
    if not traces:
        fail("no profiler trace under log_Smoke")
    run_report(rows, window, steps=steps, batch=128, unit="images", smi=smi,
               trace=traces[0].name)

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
    print("== 11. fused LayerNorm parity: 8192x768, 1000x200, 1000x197, "
          "1000x768 at +1 element, 3x768, 65536x768 and 1000x2048, three "
          "compositions, rms on/off, f32/bf16")
    lines, spilled = LB.ln_build()
    print("  layernorm.cu kernels (-Xptxas -v):")
    for line in lines:
        print("    " + line)
    if spilled:
        fail(f"LayerNorm kernels at D <= 768 spill: {spilled}")
    for name, got, want in LB.ln_parity(gen):
        check(name, got, want, elem=True)
    if FAILURES:
        fail(f"fused LayerNorm parity: {FAILURES}")
    same = LB.ln_repeat_identical(gen)
    print(f"  two bf16 calls at {LB.ROWS} x {LB.WIDTH} bit-identical (forward "
          f"n, r; backward dr, dscale, dbias): {same}")
    if not all(same.values()):
        fail(f"the LayerNorm kernels are not deterministic: {same}")
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
    counts = trained_cli(
        ["--bf16", "--fused", "all", "--attn", "auto"], batch=8, seq=1024,
        job="Smoke", smi=smi, want=lambda depth, n_leaves: {
            "layernorm_fwd": 2 * depth + 1, "layernorm_bwd": 2 * depth + 1,
            "layernorm_bwd_reduce": 2 * depth + 1,
            "vmem_attention_fwd": depth, "vmem_attention_bwd": depth,
            "flash_attention_fwd": 0, "flash_attention_bwd": 0,
            "fused_adamw": 1, "fused_adamw_leaves": n_leaves})["counts"]

    # -- 15. agreement in f32 ------------------------------------------------------
    print("== 15. f32: --fused all --attn vmem vs --fused none --attn xla, 4 steps")
    f32_agreement(
        (["--fused", "all", "--attn", "vmem"], {
            "flash_attention_fwd", "flash_attention_bwd", "fused_adamw_check"}),
        ["--fused", "none", "--attn", "xla"], run=gpt2_runner(8, 1024),
        loss_bar=LOSS_BAR, param_bar=PARAM_BAR, peak_lr=3e-4,
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
    counts = trained_cli(
        ["--bf16", "--fused", "all", "--attn", "auto", "--chunked_ce", "256"],
        batch=4, seq=4096, job="Long", smi=smi, want=lambda depth, n_leaves: {
            "layernorm_fwd": 2 * depth + 1, "layernorm_bwd": 2 * depth + 1,
            "layernorm_bwd_reduce": 2 * depth + 1, "vmem_attention_fwd": 0,
            "vmem_attention_bwd": 0, "flash_attention_fwd": depth,
            "flash_attention_bwd": depth, "fused_adamw": 1,
            "fused_adamw_leaves": n_leaves})["counts"]

    # -- 19. agreement in f32 ------------------------------------------------------
    print("== 19. f32, S 2048, depth 4: --fused all --attn flash --chunked_ce "
          "256 vs --fused none --attn xla, 4 steps")
    f32_agreement(
        (["--fused", "all", "--attn", "flash", "--chunked_ce", "256"],
         {"vmem_attention_fwd", "vmem_attention_bwd", "fused_adamw_check"}),
        ["--fused", "none", "--attn", "xla"],
        run=gpt2_runner(4, 2048, extra=["--depth", "4"]),
        loss_bar=LONG_LOSS_BAR, param_bar=LONG_PARAM_BAR, peak_lr=3e-4,
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



def vit_phases(smi: str, dev) -> None:
    """Phases 22-24: ViT-B/16 trained through ``main.main`` (the kernels
    of its path: the fused LayerNorm forward and backward and fused
    AdamW), its f32 agreement with the plain-op path and of
    ``--grad_accum 2`` with a flat step, and the ImageNet shape through
    the model API."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from tpudist_torch import main as M
    from tpudist_torch.models.vit import vit_b16
    from tpudist_torch.ops import layernorm as LN
    from tpudist_torch.ops import lm_kernels_bench as LB
    from tpudist_torch.ops import vmem_attention as VA

    # -- 22. the main path, trained ------------------------------------------------
    t0 = time.perf_counter()
    print("== 22. ViT-B/16, bf16, --fused all, batch 128 of 32x32 images (65 "
          "tokens), 16 steps under DDP (NCCL)")
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                      RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    dist.init_process_group("nccl", init_method="env://")
    with tempfile.TemporaryDirectory() as log_dir:
        for mod in counted_modules():
            mod.reset_launch_counts()
        torch.cuda.synchronize()
        state, losses = M.main([
            "--model", "vit_b16", "--dataset", "synthetic",
            "--synthetic_size", "2048", "--batch_size", "128", "--epochs", "1",
            "--bf16", "--fused", "all", "--JobID", "Vit", "--log_dir", log_dir])
        torch.cuda.synchronize()
        counts = launches()
        if not isinstance(state.module, torch.nn.parallel.DistributedDataParallel):
            fail("the training step did not run under DDP")
        dist.destroy_process_group()
        depth = state.model.depth
        n_leaves = len(list(state.model.parameters()))
        rows = (Path(log_dir) / "Vit_128_0.log").read_text().splitlines()
        traces = list((Path(log_dir) / "log_Vit").glob("*.pt.trace.json"))
        window = trace_breakdown(traces[0]) if traces else None
    del state
    steps = len(losses)
    per_step = {"layernorm_fwd": 2 * depth + 1, "layernorm_bwd": 2 * depth + 1,
                "layernorm_bwd_reduce": 2 * depth + 1,
                "layernorm_fwd_wide": 0, "layernorm_bwd_wide": 0,
                "vmem_attention_fwd": 0, "vmem_attention_bwd": 0,
                "flash_attention_fwd": 0, "flash_attention_bwd": 0,
                "fused_adamw": 1, "fused_adamw_leaves": n_leaves,
                "fused_adamw_check": 0}
    print(f"  {steps} steps; launches {counts} (per step {per_step}); losses "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    if steps != 16 or n_leaves != 152 or counts != {
            k: n * steps for k, n in per_step.items()}:
        fail(f"{steps} steps, launches {counts}, want {per_step} per step")
    if not np.isfinite(losses).all():
        fail(f"losses {losses}")
    if not traces:
        fail("no profiler trace under log_Vit")
    run_report(rows, window, steps=steps, batch=128, unit="images", smi=smi,
               trace=traces[0].name)
    print(f"  phase 22: {time.perf_counter() - t0:.1f} s")

    # -- 23. agreement in f32 ------------------------------------------------------
    t0 = time.perf_counter()
    print("== 23. f32 ViT-B/16: --fused all vs --fused none, 4 steps; "
          "--grad_accum 2 vs one flat sgd step")
    torch.backends.cudnn.deterministic = True
    f32_agreement(
        (["--fused", "all"], {"vmem_attention_fwd", "vmem_attention_bwd",
                              "flash_attention_fwd", "flash_attention_bwd",
                              "fused_adamw_check"}),
        ["--fused", "none"], run=vit_runner(), loss_bar=VIT_LOSS_BAR,
        param_bar=VIT_PARAM_BAR, peak_lr=1e-3,
        what="f32 fused and unfused ViT training")
    runs = []
    with tempfile.TemporaryDirectory() as log_dir:
        for accum in ("2", "1"):
            st, ls = vit_runner(128)(["--optimizer", "sgd", "--fused", "ln",
                                      "--grad_accum", accum], log_dir)
            runs.append((ls, {k: v.float().cpu() for k, v in st.params().items()}))
            del st
    torch.backends.cudnn.deterministic = False
    (la, pa), (lf, pf) = runs
    loss_rel = abs(la[0] - lf[0]) / abs(lf[0])
    gaps = {k: float((pa[k] - pf[k]).abs().max()) for k in pf}
    worst = max(gaps, key=gaps.get)
    print(f"  --grad_accum 2 loss {la} vs flat {lf}: rel {loss_rel:.3e} [bar "
          f"{ACCUM_LOSS_BAR:g}]; params max abs {gaps[worst]:.3e} ({worst}) "
          f"[bar {ACCUM_PARAM_BAR:g}]")
    if len(la) != 1 or loss_rel > ACCUM_LOSS_BAR or gaps[worst] > ACCUM_PARAM_BAR:
        fail("--grad_accum 2 and the flat step disagree")
    print(f"  phase 23: {time.perf_counter() - t0:.1f} s")

    # -- 24. the ImageNet shape, through the model API --------------------------
    t0 = time.perf_counter()
    print("== 24. ViT-B/16 at 224x224 (16-pixel patches, 197 tokens), batch "
          "32, through the model API")
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    x = torch.rand(32, 224, 224, 3, generator=gen, device=dev)
    y = torch.randint(0, 1000, (32,), generator=gen, device=dev)

    def forward_backward(model):
        model.zero_grad(set_to_none=True)
        logits = model(x)
        F.cross_entropy(logits, y).backward()
        torch.cuda.synchronize()
        return logits.detach(), {k: p.grad for k, p in model.named_parameters()}

    LN.reset_launch_counts()
    logits, grads = forward_backward(vit_b16(
        patch_size=16, image_size=224, dtype=torch.bfloat16, fused_ln=True,
        device=dev))
    ln_counts = dict(LN.launch_counts)
    finite = bool(torch.isfinite(logits).all()) and all(
        bool(torch.isfinite(g).all()) for g in grads.values())
    print(f"  bf16, fused_ln: logits {tuple(logits.shape)} {logits.dtype}, "
          f"finite logits and gradients {finite}; LayerNorm launches "
          f"{ln_counts}")
    if (logits.shape != (32, 1000) or logits.dtype != torch.float32
            or not finite or ln_counts != {
                "layernorm_fwd": 25, "layernorm_bwd": 25,
                "layernorm_bwd_reduce": 25, "layernorm_fwd_wide": 0,
                "layernorm_bwd_wide": 0}):
        fail("bf16 ViT-B/16 at 224x224")
    base = vit_b16(patch_size=16, image_size=224, device=dev)
    want = forward_backward(base)
    base.fused_ln = True
    fused = forward_backward(base)
    vmem = vit_b16(patch_size=16, image_size=224, attn_impl="vmem", device=dev)
    vmem.load_state_dict(base.state_dict())
    VA.reset_launch_counts()
    by_vmem = forward_backward(vmem)
    vmem_counts = dict(VA.launch_counts)
    for name, (got_logits, got_grads) in (("fused_ln True vs False", fused),
                                          ("attn vmem vs xla", by_vmem)):
        check(f"f32 logits, {name}", got_logits, want[0])
        errs = {k: LB.max_err(got_grads[k], want[1][k], elem=False)
                for k in want[1]}
        worst = max(errs, key=lambda k: errs[k][0])
        ok = all(e[1] for e in errs.values())
        print(f"  f32 gradients, {name}: {len(errs)} leaves within the parity "
              f"rule {ok}, worst {worst} max_abs_err {errs[worst][0]:.3e}")
        if not ok:
            FAILURES.append(f"f32 gradients, {name}")
    print(f"  vmem launches {vmem_counts} (12 forward, 12 backward)")
    if vmem_counts != {"vmem_attention_fwd": 12, "vmem_attention_bwd": 12}:
        FAILURES.append(f"vmem launches {vmem_counts}")
    if FAILURES:
        fail(f"ViT-B/16 at 224x224: {FAILURES}")
    print(f"  phase 24: {time.perf_counter() - t0:.1f} s")


def amp_phase(smi: str, dev) -> None:
    """Phase 25: the --amp guard around fused AdamW, the four other
    optimizers card against CPU, and --amp through the CLI."""
    import torch

    from tpudist_torch.amp import skipped_steps
    from tpudist_torch.models.vit import vit_b16
    from tpudist_torch.ops import fused_update_bench as FB

    t0 = time.perf_counter()
    print("== 25. --amp and the optimizers")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    r = FB.guard_check(FB.vit_leaves(), torch.Generator(device=dev).manual_seed(
        SEED + 25), flush)
    del flush
    print("  " + FB.guard_line(r, smi))
    if not FB.guard_ok(r):
        fail("the --amp guard around fused AdamW")

    # one step of each optimizer at ViT-B's leaf shapes (depth cut to 2:
    # every distinct shape), card against CPU
    optimizer_agreement(vit_b16(patch_size=4, image_size=32, depth=2,
                                device=dev), dev, SEED + 26)

    # --amp through the CLI
    with tempfile.TemporaryDirectory() as log_dir:
        for mod in counted_modules():
            mod.reset_launch_counts()
        state, losses = vit_runner()(["--amp", "--fused", "all"], log_dir)
        counts = launches()
    skipped = skipped_steps(state.opt_state)
    bf16 = all(p.dtype == torch.bfloat16 for p in state.model.parameters())
    del state
    print(f"  --amp --fused all, 4 ViT-B/16 steps: losses {losses}, skipped "
          f"{skipped}, bf16 compute copy {bf16}; launches {counts}")
    if (len(losses) != 4 or not all(map(math.isfinite, losses)) or skipped
            or not bf16 or counts["fused_adamw_check"] != 4
            or counts["fused_adamw"] != 4):
        fail("--amp through the CLI")
    print(f"  phase 25: {time.perf_counter() - t0:.1f} s")


def optimizer_agreement(model, dev, seed: int) -> None:
    """Phases 25 and 29: one step of each of sgd, lamb, lion and muon over
    ``model``'s leaves with the same random gradients on the card and on
    the CPU (weight decay 0.1), in f32; the parameters' difference beyond
    one ulp of the parameter is held to ``OPT_BARS`` of the largest
    update."""
    import torch

    from tpudist_torch.optim import make_optimizer

    gen = torch.Generator(device=dev).manual_seed(seed)
    p0 = {k: p.detach().clone() for k, p in model.named_parameters()}
    g = {k: torch.randn(p.shape, generator=gen, device=dev) * 0.1
         for k, p in p0.items()}
    for name, bar in OPT_BARS.items():
        news = []
        for where in (dev, torch.device("cpu")):
            params = {k: p.to(where, copy=True) for k, p in p0.items()}
            tx = make_optimizer(1e-3, optimizer=name, weight_decay=0.1)
            tx.step(tx.init(params), params, {k: t.to(where) for k, t in g.items()})
            news.append({k: t.cpu() for k, t in params.items()})
        card, cpu = news
        gap, excess, top = 0.0, 0.0, 0.0
        for k, want in cpu.items():
            d = (card[k] - want).abs()
            # an update that differs in its last bits can round p + u one
            # ulp of p apart: that ulp is the rounding of the sum, not the
            # optimizer's arithmetic
            ulp = torch.nextafter(want.abs(), torch.full_like(want, math.inf)) \
                - want.abs()
            gap = max(gap, float(d.max()))
            excess = max(excess, float((d - ulp).clamp_min(0).max()))
            top = max(top, float((want - p0[k].cpu()).abs().max()))
        print(f"  {name}: {len(cpu)} leaves, card against CPU: parameters "
              f"{gap:.3e} apart at most, {excess:.3e} beyond one ulp of the "
              f"parameter; largest update {top:.3e}, rel {excess / top:.3e} "
              f"[bar {bar:g}]")
        if not excess <= bar * top:
            FAILURES.append(f"{name} card against CPU")
    if FAILURES:
        fail(f"optimizers: {FAILURES}")



#: phase 28's held-out text: the bytes of lm_kernels_bench.TEXT_FILES past
#: the 16 x 8 x 1024 the training run reads (10 windows of 1024: batches of
#: 8 and 2)
HELD_OUT = 16 * 8 * 1024
#: phase 26's ceiling on the host-to-device bytes of a device-cached step:
#: its 128 indices and labels are 1 KiB; one uint8 image batch is 384 KiB
CACHE_H2D_BAR = 64 << 10


def device_cache_phases(smi: str, dev) -> None:
    """Phases 26-27: ResNet-50 on the device cache with the device
    augmentation through ``main.main``, then its f32 agreement with the
    host loader."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tpudist_torch import main as M
    from tpudist_torch.ops import fused_update as FU

    # -- 26. the device-cached path, trained ----------------------------------
    t0 = time.perf_counter()
    print("== 26. ResNet-50, bf16, --fused optimizer --device_cache --augment, "
          "16 steps under DDP (NCCL)")
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                      RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    dist.init_process_group("nccl", init_method="env://")
    with tempfile.TemporaryDirectory() as log_dir:
        for mod in counted_modules():
            mod.reset_launch_counts()
        torch.cuda.synchronize()
        state, losses = M.main([
            "--model", "resnet50", "--dataset", "synthetic",
            "--synthetic_size", "2048", "--batch_size", "128", "--epochs", "1",
            "--bf16", "--fused", "optimizer", "--device_cache", "--augment",
            "--JobID", "Cache", "--log_dir", log_dir])
        torch.cuda.synchronize()
        counts = launches()
        if not isinstance(state.module, torch.nn.parallel.DistributedDataParallel):
            fail("the training step did not run under DDP")
        dist.destroy_process_group()
        n_leaves = len(list(state.model.parameters()))
        rows = (Path(log_dir) / "Cache_128_0.log").read_text().splitlines()
        traces = list((Path(log_dir) / "log_Cache").glob("*.pt.trace.json"))
        window = trace_breakdown(traces[0]) if traces else None
        h2d = h2d_per_step(traces[0]) if traces else None
    del state
    steps = len(losses)
    print(f"  {steps} steps; launches {counts}; losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}")
    if (steps != 16 or n_leaves != 161 or counts["fused_adamw"] != steps
            or counts["fused_adamw_leaves"] != n_leaves * steps):
        fail(f"{steps} steps, launches {counts}, want one fused AdamW launch "
             f"covering {n_leaves} leaves a step")
    if not np.isfinite(losses).all():
        fail(f"losses {losses}")
    if not traces:
        fail("no profiler trace under log_Cache")
    run_report(rows, window, steps=steps, batch=128, unit="images", smi=smi,
               trace=traces[0].name)
    print(f"  host-to-device per profiled step: {h2d['bytes']:.0f} bytes in "
          f"{h2d['copies']:.1f} copies (trace; the image batch would be "
          f"{128 * 32 * 32 * 3} bytes of uint8) [bar {CACHE_H2D_BAR}]")
    if not (h2d["steps"] and h2d["copies"] and h2d["has_bytes"]
            and h2d["bytes"] <= CACHE_H2D_BAR):
        fail(f"host-to-device copies of the cached path: {h2d}")
    print(f"  phase 26: {time.perf_counter() - t0:.1f} s")

    # -- 27. agreement in f32 ------------------------------------------------------
    t0 = time.perf_counter()
    print("== 27. f32: --device_cache vs the host loader, 4 steps, "
          "deterministic cuDNN")
    torch.backends.cudnn.deterministic = True
    runs = []
    for flags in (["--device_cache"], []):
        with tempfile.TemporaryDirectory() as log_dir:
            with contextlib.redirect_stdout(io.StringIO()):
                st, ls = M.main([
                    "--model", "resnet50", "--dataset", "synthetic",
                    "--synthetic_size", "512", "--batch_size", "128",
                    "--epochs", "1", "--fused", "optimizer", "--no_profiler",
                    "--log_dir", log_dir, *flags])
        runs.append((ls, {k: v.float().cpu() for k, v in st.params().items()}))
        del st
    torch.backends.cudnn.deterministic = False
    (lc, pc), (lh, ph) = runs
    same = lc == lh and all(torch.equal(pc[k], ph[k]) for k in ph)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lc, lh))
    param_rel = max(float((pc[k] - ph[k]).abs().max() / ph[k].abs().max())
                    for k in ph)
    print(f"  losses {lc} vs {lh}: bit-identical (losses and parameters) "
          f"{same}; max rel {loss_rel:.3e}, params max rel {param_rel:.3e} "
          "[bar 1e-5]")
    if len(lc) != 4 or loss_rel > 1e-5 or param_rel > 1e-5:
        fail("the device-cached and host-loader paths disagree")
    print(f"  phase 27: {time.perf_counter() - t0:.1f} s")


def h2d_per_step(path: Path) -> dict:
    """Host-to-device copies in a ``torch.profiler`` Chrome trace, per
    ``ProfilerStep#`` span: their bytes (the ``bytes`` argument of each
    ``gpu_memcpy`` event) and their number."""
    events = json.loads(path.read_text())["traceEvents"]
    steps = sum(1 for e in events if e.get("cat") == "user_annotation"
                and str(e.get("name", "")).startswith("ProfilerStep#"))
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in str(e.get("name", ""))]
    n = max(steps, 1)
    return dict(steps=steps, copies=len(copies) / n,
                has_bytes=all("bytes" in e.get("args", {}) for e in copies),
                bytes=sum(e.get("args", {}).get("bytes", 0)
                          for e in copies) / n)


@contextlib.contextmanager
def leg_counts(legs: dict, after=None):
    """While a training CLI runs, read the launch counts (the decode
    kernels' too) at its after-training legs, the ``(module, name)`` pairs
    of ``after`` (by default train_gpt2's ``generate`` and
    ``evaluate_lm``): ``legs["train"]`` the counts and ``legs["peak_gb"]``
    the peak memory at the first leg's entry (training done), and under
    each leg's name its own counts, every count set to 0 at its entry,
    with its seconds."""
    import torch

    import tpudist_torch.generate as G
    import tpudist_torch.train as TR
    from tpudist_torch.ops import decode as D

    mods = (*counted_modules(), D)

    def counts():
        return {k: n for m in mods for k, n in m.launch_counts.items()}

    def wrap(module, name):
        inner = getattr(module, name)

        def run(*args, **kwargs):
            torch.cuda.synchronize()
            legs.setdefault("train", counts())
            legs.setdefault("peak_gb", torch.cuda.max_memory_allocated() / 1e9)
            for m in mods:
                m.reset_launch_counts()
            t = time.perf_counter()
            out = inner(*args, **kwargs)
            torch.cuda.synchronize()
            legs[name + "_s"] = time.perf_counter() - t
            legs[name] = counts()
            return out

        setattr(module, name, run)
        return module, name, inner

    saved = [wrap(m, n) for m, n in (after or ((G, "generate"),
                                               (TR, "evaluate_lm")))]
    try:
        yield legs
    finally:
        for module, name, inner in saved:
            setattr(module, name, inner)


def peak_gb(run, flags) -> float:
    """Peak device memory (GB) over ``run(flags)``'s steps, from a reset."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as log_dir:
        st, losses = run(flags, log_dir)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
    del st
    if not all(map(math.isfinite, losses)):
        fail(f"{' '.join(flags)}: losses {losses}")
    return peak


def lm_flag_phases(smi: str, dev) -> None:
    """Phases 28-29: GPT-2 124M through ``train_gpt2.main`` with --amp,
    --dropout and --remat, its memory by remat policy, --eval and
    --generate; then f32 remat against none with dropout, --init_hf and
    the four other optimizers at GPT-2's leaves."""
    import numpy as np
    import torch

    from tpudist_torch import train_gpt2 as TG
    from tpudist_torch.data.lm import TokenWindowLoader, encode_bytes
    from tpudist_torch.interop import save_hf_checkpoint
    from tpudist_torch.models.gpt2 import GPT2
    from tpudist_torch.ops import lm_kernels_bench as LB
    from tpudist_torch.train import lm_loss

    flags = ["--bf16", "--fused", "all", "--attn", "auto", "--amp",
             "--dropout", "0.1"]

    # -- 28. the LM path with the new flags, trained --------------------------
    t0 = time.perf_counter()
    print("== 28. GPT-2 124M, bf16, --fused all --attn auto --amp --dropout 0.1 "
          "--remat full, 16 steps under DDP (NCCL); --eval, --generate 32")
    legs: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        text = b"".join((HERE / n).read_bytes() for n in LB.TEXT_FILES)
        val = Path(tmp) / "val.bin"
        encode_bytes(text)[HELD_OUT:].astype(np.uint16).tofile(val)
        n_val = len(TokenWindowLoader(str(val), 8, 1024, shuffle=False,
                                      drop_remainder=False))
        torch.cuda.reset_peak_memory_stats()
        with leg_counts(legs):
            trained_cli(
                [*flags, "--remat", "full", "--eval", "--val_tokens", str(val),
                 "--generate", str(NEW), "--temperature", "0"],
                batch=8, seq=1024, job="Remat", smi=smi, legs=legs,
                want=lambda depth, n_leaves: {
                    "layernorm_fwd": 2 * (2 * depth + 1),
                    "layernorm_bwd": 2 * depth + 1,
                    "layernorm_bwd_reduce": 2 * depth + 1,
                    "vmem_attention_fwd": 2 * depth,
                    "vmem_attention_bwd": depth,
                    "flash_attention_fwd": 0, "flash_attention_bwd": 0,
                    "fused_adamw": 1, "fused_adamw_leaves": n_leaves,
                    "fused_adamw_check": 1})
    gen, ev = legs.get("generate", {}), legs.get("evaluate_lm", {})
    print(f"  --generate {NEW}: launches {gen} in {legs.get('generate_s', 0):.3f}"
          f" s; --eval over {n_val} batches: launches {ev} in "
          f"{legs.get('evaluate_lm_s', 0):.3f} s  [{smi}]")
    if gen.get("fused_decode_attention") != 12 * NEW:
        fail(f"--generate launched the contiguous decode kernel "
             f"{gen.get('fused_decode_attention')} times, want 12 x {NEW}")
    if (ev.get("layernorm_fwd") != 25 * n_val
            or ev.get("vmem_attention_fwd") != 12 * n_val
            or ev.get("layernorm_bwd") or ev.get("vmem_attention_bwd")):
        fail(f"--eval launches {ev}, want 25 LN and 12 vmem forwards a batch")
    # the policies' order is the reference's per-block contract; the
    # whole forward's checkpoint recomputes every activation at the head's
    # backward, before any is freed, so its peak is no-remat's (printed)
    run = gpt2_runner(8, 1024)
    peaks = {"whole forward": legs["peak_gb"]}
    for name, extra in (("whole forward, 4 steps", ["--remat", "full"]),
                        ("full", ["--remat_policy", "full"]),
                        ("dots_saveable", ["--remat_policy", "dots_saveable"]),
                        ("none", [])):
        peaks[name] = peak_gb(run, [*flags, *extra])
    PEAKS["gpt2_none"] = peaks["none"] * 1e9
    print("  peak memory (torch.cuda.max_memory_allocated, GB), 4 steps each: "
          f"per block (--remat_policy) full {peaks['full']:.3f}, dots_saveable "
          f"{peaks['dots_saveable']:.3f}; no remat {peaks['none']:.3f}; the "
          f"whole forward (--remat full) {peaks['whole forward, 4 steps']:.3f}"
          f" ({peaks['whole forward']:.3f} over the 16-step run under DDP)  "
          f"[{smi}]")
    if not peaks["full"] <= peaks["dots_saveable"] <= peaks["none"]:
        fail(f"peak memory out of order (full <= dots_saveable <= none): {peaks}")
    print(f"  phase 28: {time.perf_counter() - t0:.1f} s")

    # -- 29. agreement in f32, --init_hf, the optimizers -----------------------
    t0 = time.perf_counter()
    print("== 29. f32: --dropout 0.1 --remat full vs --dropout 0.1, 4 steps; "
          "--init_hf; sgd / lamb / lion / muon at GPT-2's leaves (depth 2)")
    runs = []
    with tempfile.TemporaryDirectory() as log_dir:
        for extra in (["--remat", "full"], []):
            st, ls = run(["--fused", "all", "--attn", "vmem", "--dropout", "0.1",
                          *extra], log_dir)
            runs.append((ls, {k: v.float().cpu() for k, v in st.params().items()}))
            del st
    (lr_, pr), (ln, pn) = runs
    same = lr_ == ln and all(torch.equal(pr[k], pn[k]) for k in pn)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lr_, ln))
    gap = max(float((pr[k] - pn[k]).abs().max()) for k in pn)
    print(f"  losses {lr_} vs {ln}: bit-identical (losses and parameters) "
          f"{same}; max rel {loss_rel:.3e} [bar {LOSS_BAR:g}], params max abs "
          f"{gap:.3e} [bar {PARAM_BAR:g}]")
    if len(lr_) != 4 or loss_rel > LOSS_BAR or gap > PARAM_BAR:
        fail("f32 GPT-2 with and without --remat disagree under dropout")

    with tempfile.TemporaryDirectory() as tmp:
        model = GPT2(attn_impl="vmem", device=dev, seed=SEED + 29)
        save_hf_checkpoint(model.state_dict(), tmp, arch="gpt2",
                           depth=model.depth)
        tokens = LB.token_file(Path(tmp) / "first.bin", 4 * 8 * 1024)
        first = next(iter(TokenWindowLoader(str(tokens), 8, 1024)))["tokens"]
        with torch.no_grad():
            x = torch.from_numpy(first).to(dev)
            want = float(lm_loss(model.train()(x), x))
        del model
        st, ls = run(["--init_hf", tmp, "--fused", "none", "--attn", "vmem"],
                     tmp)
        del st
    err = abs(ls[0] - want)
    print(f"  --init_hf: first loss {ls[0]:.7f}, the saved model's {want:.7f} "
          f"on the same batch: abs {err:.3e} [f32 rule 2e-5 + 2e-5 rel]")
    if err > 2e-5 + 2e-5 * abs(want):
        fail("--init_hf did not start from the saved weights")

    for name in OPT_BARS:
        with tempfile.TemporaryDirectory() as log_dir:
            with contextlib.redirect_stdout(io.StringIO()):
                st, ls = TG.main(["--depth", "2", "--seq_len", "128",
                                  "--batch_size", "2", "--synthetic_tokens",
                                  "512", "--optimizer", name, "--warmup_steps",
                                  "0", "--no_profiler",
                                  "--log_dir", log_dir])
            del st
        print(f"  --optimizer {name} through the CLI (depth 2, S 128): losses "
              f"{ls}")
        if len(ls) != 2 or not all(map(math.isfinite, ls)):
            fail(f"--optimizer {name} through the CLI")
    optimizer_agreement(GPT2(depth=2, device=dev), dev, SEED + 30)
    print(f"  phase 29: {time.perf_counter() - t0:.1f} s")


def llama_phases(smi: str, dev) -> list[dict]:
    """Phases 34-38: the wide-row LayerNorm kernels and the Llama paths.
    Returns the wide kernels' two entries of the ``kernels`` line, their
    launches from phase 38 (the Llama-3-8B-width leg)."""
    entries = wide_ln_phase(smi, dev)
    llama_training_phases(smi)
    llama_decode_phase(smi, dev)
    counts = llama_wide_phase(smi)
    for e in entries:
        e["launches"] = counts[e["name"]]
    return entries


def wide_ln_phase(smi: str, dev) -> list[dict]:
    """Phase 34 (module docstring)."""
    import torch

    from tpudist_torch.ops import layernorm as LN
    from tpudist_torch.ops import lm_kernels_bench as LB

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 34)
    print("== 34. wide-row LayerNorm parity: D 2560, 4096 (8192 rows), 5120, "
          "8192, 4100 and 4096 one element in; plain and pre-norm, rms on/off, "
          "f32/bf16")
    from tpudist_torch.csrc import build

    wide = [r for r in build.register_report("layernorm.cu")
            if "_wide_kernel<" in r["kernel"]]
    print("  the wide kernels (-Xptxas -v):")
    for r in wide:
        print(f"    {r['kernel']}: {r['registers']} registers, "
              f"{r['spill_stores']} / {r['spill_loads']} bytes spill stores / "
              "loads")
    spilled = [r["kernel"] for r in wide if r["spill_stores"] or r["spill_loads"]]
    # each two dtypes x two dtypes x V 8 / 1, x 8 / 16 columns a thread
    # (forward) or x clusters of 1 / 2 blocks (backward)
    if len(wide) != 32 or spilled:
        fail(f"wide LayerNorm kernels: {len(wide)} built, spills {spilled}")
    for name, got, want in LB.ln_parity(gen, LB.WIDE_CASES, ("plain", "pre")):
        check(name, got, want, elem=True)
    if FAILURES:
        fail(f"wide-row LayerNorm parity: {FAILURES}")
    same = LB.wide_repeat_identical(gen)
    print(f"  two bf16 RMS calls at 4096 x 4096 and 2048 x 8192 "
          f"bit-identical: {same}")
    if not all(same.values()):
        fail(f"the wide LayerNorm kernels are not deterministic: {same}")
    # D <= 2048 keeps the register kernels, one launch each; past it the
    # wide ones; past the widest the wrapper raises naming it
    routes = {}
    for d in (768, 2048, 2056, 4096, 8192):
        t = LB.ln_inputs(gen, 64, d, torch.bfloat16)
        LN.reset_launch_counts()
        LN.layernorm_fwd_cuda(t["x"], None, t["scale"], None, eps=LB.EPS,
                              rms=True, out_dtype=torch.bfloat16,
                              want_residual=False)
        LN.layernorm_bwd_cuda(t["x"], t["g"], None, t["scale"], eps=LB.EPS,
                              rms=True)
        routes[d] = {k: n for k, n in LN.launch_counts.items() if n}
        kind = "_wide" if d > LN.MAX_REG_D else ""
        if routes[d] != {f"layernorm_fwd{kind}": 1, f"layernorm_bwd{kind}": 1,
                         "layernorm_bwd_reduce": 1}:
            fail(f"D {d} launched {routes[d]}")
    print(f"  launches by width (one forward and one backward each): {routes}")
    t = LB.ln_inputs(gen, 4, 8200, torch.bfloat16)
    try:
        LN.layernorm_fwd_cuda(t["x"], None, t["scale"], None, eps=LB.EPS,
                              rms=True, out_dtype=torch.bfloat16,
                              want_residual=False)
    except ValueError as e:
        print(f"  D 8200: ValueError ({e})")
        if "8192" not in str(e):
            fail("the width limit's error does not name it")
    else:
        fail("D 8200 did not raise")

    for rows, d in LB.WIDE_TIMED:
        for kind, g in LB.wide_geometry(rows, d).items():
            parts = (f", {g['parts']} partial rows" if kind == "backward"
                     else "")
            print(f"  {kind} at {rows} x {d} bf16: {g['blocks']} blocks of "
                  f"{g['threads']} threads in clusters of {g['cluster']}"
                  f"{parts}, {g['per_sm']} resident an SM, a ring of "
                  f"{g['slots']} row slots, {g['rows_a_step']} rows a step, "
                  f"{g['columns_a_thread']} columns a thread")
    print("  times (median of 50 device times, L2 flushed; bf16):")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    entries = []
    for case in LB.wide_timing_cases(gen):
        tm = LB.time_case(case, flush)
        lib = ("n/a" if tm["library_ms"] is None
               else f"{tm['library_ms'] * 1e3:.2f} us")
        print(f"  {case['name']} [{case['shape']}]: kernel "
              f"{tm['kernel_ms'] * 1e3:.2f} us, bound {case['bound_ms'] * 1e3:.2f}"
              f" us ({case['bound_by']}), plain {tm['plain_ms'] * 1e3:.1f} us, "
              f"library {lib}, max_abs_err {case['max_abs_err']:.3e}  [{smi}]")
        if case["name"] in REPLACES:
            entries.append(dict(
                name=case["name"], route="cuda", source=SOURCES[case["name"]],
                replaces=REPLACES[case["name"]], ms=tm["kernel_ms"],
                plain_ms=tm["plain_ms"], library_ms=tm["library_ms"],
                max_abs_err=case["max_abs_err"], bound_ms=case["bound_ms"],
                bound_by=case["bound_by"]))
    del flush
    print(f"  phase 34: {time.perf_counter() - t0:.1f} s")
    return entries


def llama_training_phases(smi: str) -> None:
    """Phases 35-36 (module docstring)."""
    t0 = time.perf_counter()
    print("== 35. llama_125m, bf16, --fused all --attn auto, 16 steps under "
          "DDP (NCCL)")
    trained_cli(
        [*LLAMA_125M, "--bf16", "--fused", "all", "--attn", "auto"], batch=8,
        seq=1024, job="Llama", smi=smi, leaves=3 + 9 * 12,
        want=lambda depth, n_leaves: {
            "layernorm_fwd": 2 * depth + 1, "layernorm_bwd": 2 * depth + 1,
            "layernorm_bwd_reduce": 2 * depth + 1, "layernorm_fwd_wide": 0,
            "layernorm_bwd_wide": 0, "vmem_attention_fwd": depth,
            "vmem_attention_bwd": depth, "flash_attention_fwd": 0,
            "flash_attention_bwd": 0, "fused_adamw": 1,
            "fused_adamw_leaves": n_leaves})
    print(f"  phase 35: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print("== 36. f32, llama_125m at depth 2: --fused all --attn vmem vs "
          "--fused none --attn xla, 4 steps")
    f32_agreement(
        (["--fused", "all", "--attn", "vmem"], {
            "flash_attention_fwd", "flash_attention_bwd", "fused_adamw_check"}),
        ["--fused", "none", "--attn", "xla"],
        run=gpt2_runner(8, 1024, extra=[*LLAMA_125M, "--depth", "2"]),
        loss_bar=LOSS_BAR, param_bar=PARAM_BAR, peak_lr=3e-4,
        what="f32 fused and unfused Llama training")
    print(f"  phase 36: {time.perf_counter() - t0:.1f} s")


def llama_decode_phase(smi: str, dev) -> None:
    """Phase 37 (module docstring)."""
    import numpy as np
    import torch

    from tpudist_torch.generate import generate
    from tpudist_torch.models.llama import llama_125m
    from tpudist_torch.ops import decode as D
    from tpudist_torch.serve import ServeEngine

    t0 = time.perf_counter()
    vocab = 32000
    rng = np.random.Generator(np.random.PCG64(SEED + 37))
    prompts = [rng.integers(0, vocab, (int(n),)).astype(np.int32)
               for n in rng.integers(16, 129, 8)]
    print("== 37. llama_125m decode, bf16, attn_impl='fused': generate() "
          "B 4, prompt 64, 32 new tokens; paged engine, 8 requests")
    model = llama_125m(vocab_size=vocab, max_seq_len=1024,
                       dtype=torch.bfloat16, attn_impl="fused", device=dev,
                       seed=SEED + 37)
    cache = model.init_cache(1)
    if cache["layers"][0]["k"].shape[1] != model.num_kv_heads:
        fail(f"the decode cache holds {cache['layers'][0]['k'].shape[1]} "
             f"heads, not the {model.num_kv_heads} K/V heads")
    batch = np.stack([rng.integers(0, vocab, (64,)).astype(np.int32)
                      for _ in range(4)])
    generate(model, batch[:, :16], 2, temperature=0.0)  # warm-up
    D.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    toks = generate(model, batch, NEW, temperature=0.0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    static = dict(D.launch_counts)
    if toks.shape != (4, NEW) or not ((toks >= 0) & (toks < vocab)).all():
        fail(f"Llama generate() returned {toks.shape}")
    if static != {"fused_decode_attention": model.depth * NEW,
                  "paged_decode_attention": 0}:
        fail(f"Llama generate() launched {static}, want {model.depth} x {NEW}"
             " contiguous")
    print(f"  generate(): contiguous kernel launches "
          f"{static['fused_decode_attention']} (= {model.depth} x {NEW}), "
          f"H 12 / H_kv 4 read in place; {gen_s:.3f} s for 4 x {NEW} tokens"
          f"  [{smi}]")
    eng = ServeEngine(model, max_slots=8, paged=True, block_size=32, seed=SEED)
    warm = eng.submit(prompts[0][:20], 4)
    eng.run()
    if len(eng.result(warm)) != 4:
        fail("Llama warm-up request did not complete")
    eng.reset_stats()
    steps0 = eng.decode_steps
    sampling = [dict(temperature=0.0)] * 6 + [
        dict(temperature=1.0, top_k=50, top_p=0.95)] * 2
    D.reset_launch_counts()
    rids = [eng.submit(p, NEW, **o) for p, o in zip(prompts, sampling)]
    torch.cuda.synchronize()
    out = eng.run()
    torch.cuda.synchronize()
    served = dict(D.launch_counts)
    steps = eng.decode_steps - steps0
    for r in rids:
        if len(out[r]) != NEW or not all(0 <= x < vocab for x in out[r]):
            fail(f"Llama request {r}: {len(out[r])} tokens")
    if served != {"paged_decode_attention": model.depth * steps,
                  "fused_decode_attention": 0}:
        fail(f"the Llama engine launched {served} for {steps} decode steps")
    snap = eng.stats.snapshot()
    print(f"  paged engine: 8 requests x {NEW} tokens, {steps} decode steps, "
          f"paged kernel launches {served['paged_decode_attention']} (= "
          f"{model.depth} x {steps}); TTFT p50 {snap['ttft_p50']} s, TPOT "
          f"p50 {snap['tpot_p50']} s, {snap['tokens_per_sec']} tok/s  [{smi}]")
    del model, eng
    streams = {}
    for impl in ("fused", "xla"):
        m = llama_125m(vocab_size=vocab, max_seq_len=1024, attn_impl=impl,
                       device=dev, seed=SEED + 37)
        e = ServeEngine(m, max_slots=8, paged=True, block_size=32, seed=SEED)
        ids = [e.submit(p, NEW) for p in prompts]
        res = e.run()
        streams[impl] = [res[i] for i in ids]
        if impl == "xla":
            gap = top2_gap(m, prompts, streams[impl])
        del m, e
    same = streams["fused"] == streams["xla"]
    print(f"  f32: attn_impl='fused' vs 'xla' greedy streams identical: "
          f"{same}; smallest top-2 logit gap {gap:.3e}")
    if not same:
        fail("f32 Llama kernel and dense greedy streams differ")
    print(f"  phase 37: {time.perf_counter() - t0:.1f} s")


def llama_wide_phase(smi: str) -> dict:
    """Phase 38 (module docstring). Returns its launch counts."""
    import torch

    t0 = time.perf_counter()
    print("== 38. Llama-3-8B width at depth 2 (d 4096, GQA 32/8, ffn 14336, "
          "vocab 128256, theta 5e5), bf16, S 2048, batch 2, --fused all "
          "--attn auto --chunked_ce 256, 16 steps under DDP (NCCL)")
    torch.cuda.reset_peak_memory_stats()
    counts = trained_cli(
        [*LLAMA3_8B_WIDTH, "--bf16", "--fused", "all", "--attn", "auto",
         "--chunked_ce", "256"], batch=2, seq=2048, job="Llama8B", smi=smi,
        leaves=3 + 9 * 2, want=lambda depth, n_leaves: {
            "layernorm_fwd": 0, "layernorm_bwd": 0,
            "layernorm_fwd_wide": 2 * depth + 1,
            "layernorm_bwd_wide": 2 * depth + 1,
            "layernorm_bwd_reduce": 2 * depth + 1, "vmem_attention_fwd": 0,
            "vmem_attention_bwd": 0, "flash_attention_fwd": depth,
            "flash_attention_bwd": depth, "fused_adamw": 1,
            "fused_adamw_leaves": n_leaves},
        trace_kernels=("ln_fwd_wide_kernel", "ln_bwd_wide_kernel",
                       "ln_bwd_reduce"))["counts"]
    print(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB (torch.cuda.max_memory_allocated)  [{smi}]")
    print(f"  phase 38: {time.perf_counter() - t0:.1f} s")
    return counts


def cp_close(name: str, got, want, tol: float) -> None:
    """Hold a float32 ``got`` to ``want`` within ``tol`` absolute plus
    ``tol`` relative (``torch.allclose``'s rule)."""
    import torch

    err = float((got.float() - want.float()).abs().max())
    ok = bool(torch.allclose(got.float(), want.float(), atol=tol, rtol=tol))
    print(f"  {name}: max_abs_err {err:.3e} (atol = rtol = {tol:g}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        FAILURES.append(name)


def event_ms(fn, reps: int = 5) -> float:
    """Median of ``reps`` CUDA-event times of ``fn()`` after one warm-up."""
    import statistics

    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cp_attention_phase(smi: str, dev, shape=(4, 12, 64, 4096)) -> None:
    """Phase 39 (module docstring) at ``shape`` = (B, H, dh, S), GPT-2
    124M's long-context shape by default; the vmem leg takes the first
    min(S, 1024) positions."""
    import torch

    from tpudist_torch.ops import flash_attention as FA
    from tpudist_torch.ops import vmem_attention as VA
    from tpudist_torch.ops.attention import dot_product_attention, kernel_attention
    from tpudist_torch.parallel import cp

    t0 = time.perf_counter()
    (b, h, dh, s), n = shape, 4
    print(f"== 39. context-parallel attention at B {b}, H {h}, dh {dh}, S {s}: "
          f"the ring at n = 1 and, loopback, n = {n}; Ulysses through the "
          "kernels")
    gen = torch.Generator(device=dev).manual_seed(SEED + 39)

    def grads(fn, q, k, v, g):
        qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
        out = fn(qq, kk, vv)
        out.backward(g)
        return [out.detach(), qq.grad, kk.grad, vv.grad]

    names = ("o", "dq", "dk", "dv")
    for dtype in (torch.float32, torch.bfloat16):
        for causal in (True, False):
            tag = f"{str(dtype)[6:]} {'causal' if causal else 'full'}"
            q, k, v, g = (torch.randn(b, s, h, dh, generator=gen, device=dev)
                          .to(dtype) for _ in range(4))
            with torch.no_grad():
                check(f"ring n=1 vs dense, {tag}",
                      cp.ring_attention_local(q, k, v, causal=causal),
                      dot_product_attention(q, k, v, causal=causal))
            one = grads(lambda *x: cp.ring_attention_local(
                *x, causal=causal), q, k, v, g)
            four = grads(lambda *x: cp.ring_attention_loopback(
                *x, n, causal=causal), q, k, v, g)
            for name, a, w in zip(names, four, one):
                what = f"ring n={n} vs n=1 {name}, {tag}"
                if dtype == torch.float32:
                    cp_close(what, a, w, CP_FWD_TOL if name == "o"
                             else CP_GRAD_TOL)
                else:
                    check(what, a, w)
            del one, four
            FA.reset_launch_counts()
            uly = grads(lambda *x: cp.ulysses_attention_local(
                *x, causal=causal, attn_fn=kernel_attention), q, k, v, g)
            flash = grads(lambda *x: FA.flash_attention(*x, causal=causal),
                          q, k, v, g)
            same = [torch.equal(a, w) for a, w in zip(uly, flash)]
            print(f"  ulysses_flash n=1 vs flash_attention, {tag}: o, dq, dk, "
                  f"dv bit-identical {same}; flash launches "
                  f"{dict(FA.launch_counts)}")
            if not all(same) or FA.launch_counts["flash_attention_fwd"] != 2:
                FAILURES.append(f"ulysses_flash n=1, {tag}")
            del uly, flash
            if dtype == torch.float32:
                continue
            # the all-to-all hands the kernels contiguous [B, S, H/n, D]
            for kind, seq, mod, ref in (
                    ("flash", s, FA, FA.flash_attention),
                    ("vmem", min(s, 1024), VA, VA.vmem_attention)):
                qs, ks, vs, gs = (x[:, :seq].contiguous() for x in (q, k, v, g))
                mod.reset_launch_counts()
                got = grads(lambda *x: cp.ulysses_attention_loopback(
                    *x, n, causal=causal, attn_fn=kernel_attention),
                    qs, ks, vs, gs)
                launched = dict(mod.launch_counts)
                want = grads(lambda *x: ref(*x, causal=causal), qs, ks, vs, gs)
                for name, a, w in zip(names, got, want):
                    check(f"ulysses n={n} through {kind} (S {seq}) {name}, "
                          f"{tag}", a, w, elem=True)
                print(f"    bit-identical {[torch.equal(a, w) for a, w in zip(got, want)]}"
                      f"; {kind} launches {launched}")
                if launched[f"{kind}_attention_fwd"] != 1:
                    FAILURES.append(f"ulysses n={n} {kind} launches {launched}")
    if FAILURES:
        fail(f"context-parallel attention: {FAILURES}")
    q, k, v, g = (torch.randn(b, s, h, dh, generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(4))
    qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
    for name, fn in (("ring n=1", lambda *x: cp.ring_attention_local(
            *x, causal=True)), ("flash", lambda *x: FA.flash_attention(
                *x, causal=True))):
        with torch.no_grad():
            fwd = event_ms(lambda: fn(q, k, v))
        both = event_ms(lambda: fn(qq, kk, vv).backward(g))
        print(f"  {name}, bf16 causal: forward {fwd:.3f} ms, forward + "
              f"backward {both:.3f} ms (CUDA events, median of 5)  [{smi}]")
    print(f"  phase 39: {time.perf_counter() - t0:.1f} s")


def cp_training_phases(smi: str) -> None:
    """Phases 40-41 (module docstring)."""
    import gc

    import torch

    t0 = time.perf_counter()
    print("== 40. GPT-2 124M, bf16, S 4096, --fused all --cp 1 --attn "
          "ulysses_flash --chunked_ce 256, 16 steps under DDP (NCCL)")
    long_flags = ["--bf16", "--fused", "all", "--chunked_ce", "256"]
    counts = trained_cli(
        [*long_flags, "--cp", "1", "--attn", "ulysses_flash"], batch=4,
        seq=4096, job="LongCP", smi=smi, want=lambda depth, n_leaves: {
            "layernorm_fwd": 2 * depth + 1, "layernorm_bwd": 2 * depth + 1,
            "layernorm_bwd_reduce": 2 * depth + 1, "vmem_attention_fwd": 0,
            "vmem_attention_bwd": 0, "flash_attention_fwd": depth,
            "flash_attention_bwd": depth, "fused_adamw": 1,
            "fused_adamw_leaves": n_leaves})["counts"]
    print(f"  flash launches a step: forward "
          f"{counts['flash_attention_fwd'] / 16:g}, backward "
          f"{counts['flash_attention_bwd'] / 16:g}")
    same = TRAINED_LOSSES["LongCP"] == TRAINED_LOSSES["Long"]
    print(f"  losses equal phase 18's (--attn auto: flash) bit for bit: {same}")
    if not same:
        fail(f"--cp 1 --attn ulysses_flash losses {TRAINED_LOSSES['LongCP']} "
             f"!= --attn flash {TRAINED_LOSSES['Long']}")
    print("  Llama-3-8B width at depth 2, bf16, S 2048, batch 2, --fused all "
          "--cp 1 --attn ulysses_flash --chunked_ce 256, 16 steps")
    trained_cli(
        [*LLAMA3_8B_WIDTH, *long_flags, "--cp", "1", "--attn",
         "ulysses_flash"], batch=2, seq=2048, job="Llama8BCP", smi=smi,
        leaves=3 + 9 * 2, want=lambda depth, n_leaves: {
            "layernorm_fwd": 0, "layernorm_bwd": 0,
            "layernorm_fwd_wide": 2 * depth + 1,
            "layernorm_bwd_wide": 2 * depth + 1,
            "layernorm_bwd_reduce": 2 * depth + 1, "vmem_attention_fwd": 0,
            "vmem_attention_bwd": 0, "flash_attention_fwd": depth,
            "flash_attention_bwd": depth, "fused_adamw": 1,
            "fused_adamw_leaves": n_leaves})
    same = TRAINED_LOSSES["Llama8BCP"] == TRAINED_LOSSES["Llama8B"]
    print(f"  losses equal phase 38's bit for bit: {same}")
    if not same:
        fail(f"Llama --cp 1 --attn ulysses_flash losses "
             f"{TRAINED_LOSSES['Llama8BCP']} != {TRAINED_LOSSES['Llama8B']}")
    print(f"  phase 40: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    print("== 41. GPT-2 124M, bf16, S 1024, batch 8, --fused all: --cp 1 "
          "--attn ring vs --attn xla, 16 steps under DDP (NCCL)")
    peaks = {}
    for attn in ("ring", "xla"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        trained_cli(
            ["--bf16", "--fused", "all", "--cp", "1", "--attn", attn],
            batch=8, seq=1024, job=f"Ring_{attn}", smi=smi,
            want=lambda depth, n_leaves: {
                "layernorm_fwd": 2 * depth + 1, "layernorm_bwd": 2 * depth + 1,
                "layernorm_bwd_reduce": 2 * depth + 1,
                "vmem_attention_fwd": 0, "vmem_attention_bwd": 0,
                "flash_attention_fwd": 0, "flash_attention_bwd": 0,
                "fused_adamw": 1, "fused_adamw_leaves": n_leaves})
        peaks[attn] = torch.cuda.max_memory_allocated() / 1e9
    ring, dense = TRAINED_LOSSES["Ring_ring"], TRAINED_LOSSES["Ring_xla"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(ring, dense))
    print(f"  losses ring {ring[0]:.4f} -> {ring[-1]:.4f}, xla {dense[0]:.4f} "
          f"-> {dense[-1]:.4f}: max rel {rel:.3e} [bar {RING_BF16_BAR:g}]")
    print(f"  peak device memory: ring {peaks['ring']:.3f} GB (saves the row "
          f"log-sum-exp), xla {peaks['xla']:.3f} GB (saves bf16 "
          "probabilities) (torch.cuda.max_memory_allocated)  "
          f"[{smi}]")
    if rel > RING_BF16_BAR:
        fail("bf16 ring and dense training disagree")
    print("  f32, depth 2: --fused all --cp 1 --attn ring vs --fused none "
          "--attn xla, 4 steps")
    f32_agreement(
        (["--fused", "all", "--cp", "1", "--attn", "ring"],
         {"vmem_attention_fwd", "vmem_attention_bwd", "flash_attention_fwd",
          "flash_attention_bwd", "fused_adamw_check"}),
        ["--fused", "none", "--attn", "xla"],
        run=gpt2_runner(8, 1024, extra=["--depth", "2"]),
        loss_bar=LOSS_BAR, param_bar=PARAM_BAR, peak_lr=3e-4,
        what="f32 ring and dense GPT-2 training")
    print(f"  phase 41: {time.perf_counter() - t0:.1f} s")


#: phase 43's bars, set before its first run: the f32 BERT kernel paths
#: against the dense path after 4 Adam steps at a constant lr 1e-4 from
#: step 1, phase 15's relative loss bar, and VIT_PARAM_BAR's rule on the
#: parameters (Adam moves a coordinate whose gradient is within rounding
#: of zero by up to lr a step either way: one step of lr)
BERT_LOSS_BAR, BERT_PARAM_BAR, BERT_LR = 1e-5, 1e-4, 1e-4


def bert_leaves(depth: int) -> int:
    """A BERT's leaves: the three tables, ln_embed, 12 a block, and the MLM
    head's transform, LayerNorm and bias (154 for BERT-base)."""
    return 3 + 2 + 12 * depth + 5


def t5_leaves(enc_depth: int, dec_depth: int) -> int:
    """A T5's leaves: the shared table, two relative-bias tables, the two
    final norms and the untied head, 9 an encoder block and 14 a decoder
    block (190 for t5-small)."""
    return 6 + 9 * enc_depth + 14 * dec_depth


def encoder_phases(smi: str, dev, *, bert=None, t5=None) -> None:
    """Phases 42-44 (module docstring). ``bert`` / ``t5`` (batch, seq,
    geometry) cut the shapes for a rehearsal on the CPU; None runs the
    phases' own."""
    bert_training_phase(smi, dev, *(bert or ()))
    bert_agreement_phase(dev, *(bert or ())[:2])
    t5_phase(smi, dev, *(t5 or ()))


def check_counts(what: str, counts: dict, per_step: dict,
                 steps: int = 16) -> None:
    """Fail unless every count of ``per_step`` is that times ``steps``
    and every other counted kernel stayed at 0."""
    if set(per_step) - set(counts):
        fail(f"{what}: no such counts {sorted(set(per_step) - set(counts))}")
    want = {k: per_step.get(k, 0) * steps for k in counts}
    print(f"  {what}: launches {counts} (per step {per_step})")
    if counts != want:
        fail(f"{what}: launches {counts}, want {want}")


def attention_times(smi: str, dev, b=32, h=12, s=512, dh=64) -> None:
    """vmem and flash, bf16 non-causal at BERT-base's shape: each held to
    its plain version on the inputs it is timed on (o and lse, then dq,
    dk, dv from the kernel's own o and lse, under phases 12 and 16's
    rule), then forward and forward + backward timed beside SDPA and the
    bound: the bytes of each call's inputs read and outputs written once
    (the backward reads o and lse back), and the forward's two products
    and the backward's four (the recomputed q k^T is the kernels' choice,
    not the function's work)."""
    import torch
    import torch.nn.functional as F

    from tpudist_torch.ops import flash_attention as FA
    from tpudist_torch.ops import lm_kernels_bench as LB
    from tpudist_torch.ops import vmem_attention as VA

    gen = torch.Generator(device=dev).manual_seed(SEED + 42)
    q, k, v, g = (torch.randn(b, s, h, dh, generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(4))
    kw = dict(causal=False, kv_len=s, scale=VA._scale(dh))
    for name, fwd_cuda, fwd_plain, bwd_cuda, bwd_plain in (
            ("vmem", VA.vmem_fwd_cuda, VA.vmem_fwd_plain, VA.vmem_bwd_cuda,
             VA.vmem_bwd_plain),
            ("flash", FA.flash_fwd_cuda, FA.flash_fwd_plain, FA.flash_bwd_cuda,
             FA.flash_bwd_plain)):
        tag = f"{name} non-causal B {b} H {h} S {s} dh {dh} bf16"
        ko, kl = fwd_cuda(q, k, v, **kw)
        po, pl = fwd_plain(q, k, v, **kw)
        check(f"{tag} o", ko, po, elem=True)
        check(f"{tag} lse", kl, pl, elem=True)
        del po, pl
        kg = bwd_cuda(q, k, v, ko, g, kl, **kw)
        pg = bwd_plain(q, k, v, ko, g, kl, **kw)
        for gname, got, want in zip(("dq", "dk", "dv"), kg, pg):
            check(f"{tag} {gname}", got, want, elem=True)
        del ko, kl, kg, pg
    if FAILURES:
        fail(f"attention parity at BERT-base's shape: {FAILURES}")
    qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
    io_bytes = b * s * h * dh * 2
    fwd_bound = LB.bound(4 * io_bytes + b * h * s * 4,
                         4 * b * h * s * s * dh, torch.bfloat16)
    both_bound = LB.bound(12 * io_bytes + 2 * b * h * s * 4,
                          12 * b * h * s * s * dh, torch.bfloat16)
    sdpa = lambda x, y, z: F.scaled_dot_product_attention(
        x.transpose(1, 2), y.transpose(1, 2), z.transpose(1, 2)).transpose(1, 2)
    for name, fn in (("vmem", VA.vmem_attention), ("flash", FA.flash_attention),
                     ("sdpa", sdpa)):
        kw = {} if name == "sdpa" else {"causal": False}
        with torch.no_grad():
            fwd = event_ms(lambda: fn(q, k, v, **kw))
        both = event_ms(lambda: fn(qq, kk, vv, **kw).backward(g))
        print(f"  {name}, bf16 non-causal B {b} H {h} S {s} dh {dh}: forward "
              f"{fwd:.4f} ms (bound {fwd_bound['bound_ms']:.4f}, "
              f"{fwd_bound['bound_by']}), forward + backward {both:.4f} ms "
              f"(bound {both_bound['bound_ms']:.4f}, {both_bound['bound_by']})"
              f" (CUDA events, median of 5)  [{smi}]")


def head_times(smi: str, dev, rows: int = 32 * 128, d: int = 768) -> None:
    """The MLM head's tied product at one --chunked_ce 128 chunk of BERT-base
    (rows x d against V x d, bf16, f32 out) and its backward, at the CLI's
    vocabulary of 30523 (no row 16-byte aligned) beside 30528."""
    import torch

    from tpudist_torch.models.gpt2 import tied_head

    gen = torch.Generator(device=dev).manual_seed(SEED + 43)
    x = torch.randn(rows, d, generator=gen, device=dev).to(torch.bfloat16)
    for vocab in (30523, 30528):
        w = (torch.randn(vocab, d, generator=gen, device=dev) * 0.02).to(
            torch.bfloat16)
        xx, ww = x.detach().requires_grad_(), w.detach().requires_grad_()
        g = torch.randn(rows, vocab, generator=gen, device=dev)
        with torch.no_grad():
            fwd = event_ms(lambda: tied_head(x, w))
        both = event_ms(lambda: tied_head(xx, ww).backward(g))
        print(f"  MLM head product {rows} x {d} x V {vocab}: forward "
              f"{fwd:.4f} ms, forward + backward {both:.4f} ms (CUDA events, "
              f"median of 5)  [{smi}]")


def bert_training_phase(smi: str, dev, batch: int = 32, seq: int = 512,
                        geom: dict | None = None) -> None:
    """Phase 42 (module docstring); ``geom`` (hidden_dim, depth, num_heads)
    narrows BERT-base for a rehearsal."""
    import torch
    import torch.distributed as dist

    import tpudist_torch.train_bert as TB
    from tpudist_torch.data.lm import TokenWindowLoader
    from tpudist_torch.models.bert import Bert, mlm_forward, mlm_transform
    from tpudist_torch.ops import lm_kernels_bench as LB
    from tpudist_torch.optim import make_optimizer, run_schedule
    from tpudist_torch.train import fit

    t0 = time.perf_counter()
    geom = geom or {}
    width = [f for k, v in geom.items() for f in (f"--{k}", str(v))]
    print("== 42. BERT-base (12 x 768, 12 heads, S 512, batch 32, model vocab "
          "30523), bf16: train_bert --attn flash --chunked_ce 128, 16 steps "
          "under DDP (NCCL), then --eval")
    attention_times(smi, dev, b=batch, s=seq)
    head_times(smi, dev, rows=batch * 128)
    depth = geom.get("depth", 12)
    legs: dict = {}
    with leg_counts(legs, [(TB, "evaluate_mlm")]):
        run = trained_cli(
            ["--bf16", "--attn", "flash", "--chunked_ce", "128", "--eval",
             *width], main=TB.main, batch=batch, seq=seq, job="Bert",
            smi=smi, legs=legs, leaves=bert_leaves(depth),
            want=lambda depth, _: {"flash_attention_fwd": depth,
                                   "flash_attention_bwd": depth},
            trace_kernels=("gemm", "indexing_backward", "flash_fwd",
                           "attn_dkdv", "attn_dq", "elementwise", "reduce"))
    # --eval reads the training tokens again: 16 batches
    check_counts("--eval", legs["evaluate_mlm"],
                 {"flash_attention_fwd": depth}, steps=16)
    if "masked_accuracy: " not in run["printed"]:
        fail("no --eval line")
    del run
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tokens = LB.token_file(Path(tmp) / "text.bin", 16 * batch * seq)
        print("  the model API: Bert(attn_impl='auto') + fit(fused='all') + "
              "make_optimizer(fused=True, compute copy bf16), mlm_forward("
              "chunk=128), 16 steps under DDP (NCCL)")
        os.environ.update(MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(free_port()), RANK="0",
                          WORLD_SIZE="1", LOCAL_RANK="0")
        dist.init_process_group("nccl", init_method="env://")
        try:
            model = Bert(vocab_size=30523, max_seq_len=seq,
                         dtype=torch.bfloat16, attn_impl="auto",
                         device="cuda", seed=SEED, **geom)
            loader = TokenWindowLoader(
                tokens, batch, seq, vocab_size=30522,
                transform=mlm_transform(30523, 30522, seed=SEED))
            tx = make_optimizer(run_schedule(1e-4, total_steps=16,
                                             warmup_steps=0),
                                fused=True, compute_dtype=torch.bfloat16)
            for mod in counted_modules():
                mod.reset_launch_counts()
            torch.cuda.synchronize()
            with contextlib.redirect_stdout(io.StringIO()):
                state, losses = fit(
                    model, tx, loader, epochs=1, job_id="BertAPI",
                    input_key="tokens", label_key="targets", fused="all",
                    forward_loss=mlm_forward(model, chunk=128),
                    profile=False, log_dir=tmp)
            torch.cuda.synchronize()
            counts = launches()
            rows = (Path(tmp) / f"BertAPI_{batch}_0.log").read_text(
            ).splitlines()
        finally:
            dist.destroy_process_group()
    n_leaves = len(list(state.model.parameters()))
    rows = [r for r in rows if not r.startswith("HBM\t")]
    api_ms = batch / float(rows[3].split("\t")[4]) * 1e3
    print(f"  16 steps; losses {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"{n_leaves} leaves; step at g_step 15 {api_ms:.2f} ms (TSV, "
          f"profiler off)  [{smi}]")
    if len(losses) != 16 or not all(math.isfinite(x) for x in losses):
        fail(f"model API losses {losses}")
    if n_leaves != bert_leaves(depth):
        fail(f"the BERT has {n_leaves} leaves, want {bert_leaves(depth)}")
    ln = 2 * depth + 1  # ln_embed plain, two post-norms a block
    check_counts("fit(fused='all'), attn auto (vmem at S 512)", counts, {
        "layernorm_fwd": ln, "layernorm_bwd": ln, "layernorm_bwd_reduce": ln,
        "vmem_attention_fwd": depth, "vmem_attention_bwd": depth,
        "fused_adamw": 1, "fused_adamw_leaves": n_leaves})
    del state, model
    torch.cuda.empty_cache()
    print(f"  phase 42: {time.perf_counter() - t0:.1f} s")


def bert_runner(batch: int = 32, seq: int = 512, depth: int = 2):
    """``run(flags, log_dir) -> (state, losses)``: 4 float32 steps of a
    BERT-base-width encoder at ``depth`` through the model API, one
    process: ``--fused all|none`` (fused LN and fused AdamW, or neither),
    ``--attn IMPL`` (a CP impl over a one-rank layout); the same init
    (seed 0), batches and corruption every call."""
    import torch

    from tpudist_torch.data.lm import TokenWindowLoader
    from tpudist_torch.mesh import MeshConfig, create_layout
    from tpudist_torch.models.bert import Bert, mlm_forward, mlm_transform
    from tpudist_torch.ops import lm_kernels_bench as LB
    from tpudist_torch.optim import make_optimizer, run_schedule
    from tpudist_torch.train import fit

    def run(flags, log_dir):
        opts = dict(zip(flags[::2], flags[1::2]))
        fused = opts["--fused"] == "all"
        layout = create_layout(MeshConfig(data=-1, seq=1))
        model = Bert(vocab_size=30523, max_seq_len=seq, depth=depth,
                     attn_impl=opts["--attn"], layout=layout, device="cuda",
                     seed=SEED)
        tokens = LB.token_file(Path(log_dir) / "text.bin", 4 * batch * seq)
        loader = TokenWindowLoader(tokens, batch, seq, vocab_size=30522,
                                   transform=mlm_transform(30523, 30522,
                                                           seed=SEED))
        tx = make_optimizer(run_schedule(BERT_LR, total_steps=4,
                                         warmup_steps=0), fused=fused)
        with contextlib.redirect_stdout(io.StringIO()):
            return fit(model, tx, loader, epochs=1, input_key="tokens",
                       label_key="targets", fused="all" if fused else None,
                       forward_loss=mlm_forward(model, chunk=128),
                       profile=False, log_dir=log_dir)

    return run


def bert_agreement_phase(dev, batch: int = 32, seq: int = 512) -> None:
    """Phase 43 (module docstring)."""
    import torch

    from tpudist_torch.models.bert import Bert

    t0 = time.perf_counter()
    print("== 43. f32 BERT at depth 2 (bert-base width, S 512, batch 32), "
          "4 Adam steps at lr 1e-4")
    run = bert_runner(batch, seq)
    attn_kernels = {"vmem": {"vmem_attention_fwd", "vmem_attention_bwd"},
                    "flash": {"flash_attention_fwd", "flash_attention_bwd"}}
    for attn, other in (("flash", "vmem"), ("vmem", "flash")):
        print(f"  --fused all --attn {attn} vs --fused none --attn xla")
        f32_agreement(
            (["--fused", "all", "--attn", attn],
             attn_kernels[other] | {"fused_adamw_check"}),
            ["--fused", "none", "--attn", "xla"], run=run,
            loss_bar=BERT_LOSS_BAR, param_bar=BERT_PARAM_BAR,
            peak_lr=BERT_LR, what=f"f32 BERT {attn} and dense training")
    results = {}
    with tempfile.TemporaryDirectory() as log_dir:
        for attn in ("ulysses_flash", "auto"):
            for mod in counted_modules():
                mod.reset_launch_counts()
            st, ls = run(["--fused", "none", "--attn", attn], log_dir)
            results[attn] = (ls, {k: v.float().cpu()
                                  for k, v in st.params().items()},
                             launches())
            del st
    (lu, pu, cu), (la, pa, ca) = results["ulysses_flash"], results["auto"]
    same = lu == la and all(torch.equal(pu[k], pa[k]) for k in pa)
    print(f"  --cp 1 --attn ulysses_flash vs attn_impl='auto': losses and "
          f"params bit-identical {same}; vmem launches {cu['vmem_attention_fwd']}"
          f" / {ca['vmem_attention_fwd']} forward")
    if not same or cu["vmem_attention_fwd"] != 4 * 2 or cu != ca:
        fail("ulysses_flash at one seq rank is not attn_impl='auto'")
    print("  --cp 1 --attn ring vs --attn xla (no kernel on either)")
    f32_agreement((["--fused", "none", "--attn", "ring"], set(launches())),
                  ["--fused", "none", "--attn", "xla"], run=run,
                  loss_bar=BERT_LOSS_BAR, param_bar=BERT_PARAM_BAR,
                  peak_lr=BERT_LR, what="f32 ring and dense BERT training")
    model = Bert(vocab_size=30523, max_seq_len=seq, depth=2, device="cuda",
                 seed=SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED + 43)
    tokens = torch.randint(0, 30522, (4, seq), generator=gen, device=dev)
    mask = torch.ones(4, seq, dtype=torch.long, device=dev)
    mask[1, seq // 5:] = 0
    mask[2, seq // 2:] = 0
    with torch.no_grad():
        logits = model(tokens, attention_mask=mask)
    finite = bool(torch.isfinite(logits).all())
    print(f"  attention_mask batch on the dense path: logits "
          f"{tuple(logits.shape)}, finite {finite}")
    if not finite:
        fail("attention_mask logits not finite")
    print(f"  phase 43: {time.perf_counter() - t0:.1f} s")


def t5_phase(smi: str, dev, batch: int = 16, seq: int = 512,
             geom: dict | None = None) -> None:
    """Phase 44 (module docstring); ``geom`` (hidden_dim, ffn_dim,
    enc_depth, dec_depth, num_heads) narrows t5-small for a rehearsal."""
    import numpy as np
    import torch

    import tpudist_torch.generate as G
    import tpudist_torch.train_t5 as TT
    from tpudist_torch.generate import generate_seq2seq
    from tpudist_torch.models.t5 import (
        T5, span_corrupt_transform, span_corruption_plan,
    )
    from tpudist_torch.ops import decode as D
    from tpudist_torch.ops import lm_kernels_bench as LB

    t0 = time.perf_counter()
    geom = {"hidden_dim": 512, "ffn_dim": 1024, "enc_depth": 8,
            "dec_depth": 8, "num_heads": 6, **(geom or {})}
    print("== 44. T5 (t5-v1.1-small: d 512, ffn 1024, 8 + 8 layers, 6 heads "
          "of 85), bf16: train_t5 at its defaults (vocab 256, S 512, batch "
          "16), 16 steps under DDP (NCCL), then --eval and --generate")
    legs: dict = {}
    with leg_counts(legs, [(TT, "evaluate_spans"), (G, "generate_seq2seq")]):
        run = trained_cli(
            ["--bf16", "--eval", "--generate",
             *(f for k, v in geom.items() for f in (f"--{k}", str(v)))],
            main=TT.main, batch=batch, seq=seq, job="T5", smi=smi, legs=legs,
            leaves=t5_leaves(geom["enc_depth"], geom["dec_depth"]),
            want=lambda *_: {})
    for leg in ("evaluate_spans", "generate_seq2seq"):
        check_counts(f"{leg} (dense attention with the relative bias)",
                     legs[leg], {}, steps=1)
    if "generation_span_match: " not in run["printed"]:
        fail("no --generate line")
    _, spans, _, dec_len = span_corruption_plan(seq)
    model = T5(vocab_size=256 + spans + 1, max_decode_len=dec_len + 1,
               device="cuda", **geom)
    model.load_state_dict(run.pop("model").state_dict())
    with tempfile.TemporaryDirectory() as tmp:
        window = np.fromfile(LB.token_file(Path(tmp) / "text.bin", 4 * seq),
                             np.uint16).astype(np.int32).reshape(4, seq)
    demo = span_corrupt_transform(model.vocab_size, seed=SEED)(
        {"tokens": window}, 0, 0)
    D.reset_launch_counts()
    out = generate_seq2seq(model, demo["enc_tokens"], dec_len,
                           temperature=0.0)
    decode_launches = dict(D.launch_counts)
    enc = torch.from_numpy(demo["enc_tokens"]).to(model.device)
    dec = torch.zeros(4, 1, dtype=torch.long, device=model.device)
    gaps = []
    with torch.no_grad():
        for _ in range(dec_len):
            logits = model(enc, dec)[:, -1]
            top = torch.topk(logits, 2, dim=-1).values
            gaps.append(float((top[:, 0] - top[:, 1]).min()))
            dec = torch.cat([dec, logits.argmax(-1, keepdim=True)], dim=1)
    rollout = dec[:, 1:].cpu().numpy().astype(np.int32)
    same = bool(np.array_equal(out, rollout))
    print(f"  f32, the trained weights: greedy generate_seq2seq ({dec_len} "
          f"tokens x 4 windows) equals the full-forward greedy rollout "
          f"{same}; smallest top-2 logit gap {min(gaps):.3e}; decode kernel "
          f"launches {decode_launches}")
    if not same or any(decode_launches.values()):
        fail("generate_seq2seq is not the full-forward rollout, or a decode "
             "kernel launched")
    print(f"  phase 44: {time.perf_counter() - t0:.1f} s")


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


def trained_cli(flags, *, batch: int, seq: int, job: str, smi: str, want,
                main=None, legs: dict | None = None,
                leaves: int = 148, trace_kernels=()) -> dict:
    """Phases 14, 18, 28, 35, 38, 40-42 and 44: a 1-rank NCCL group, then
    ``main`` (a training CLI's; ``train_gpt2.main`` unless given) with
    ``flags``, the profiler on, 16 steps of ``batch`` x ``seq`` on
    :func:`lm_kernels_bench.token_file`'s text, every launch count (the
    decode kernels' too) set to 0 just before and read just after. Fails
    unless it ran under DDP, launched ``want(depth, the model's leaves)``
    kernels per step and no other counted kernel (one fused-AdamW launch
    covering all the leaves), the model has ``leaves`` leaves (GPT-2's 148
    by default), and it wrote finite, falling losses, the tokens/sec line,
    the TSV rows and a trace with device work. With ``legs`` (filled by
    :func:`leg_counts`) the training's counts are those read before the
    after-training legs. Each name in ``trace_kernels`` gets a line with
    the device time a step of the trace's kernels whose names hold it.
    Returns ``{"counts", "printed", "model"}``: the training's counts, its
    standard output and the trained model."""

    import numpy as np
    import torch
    import torch.distributed as dist

    from tpudist_torch import train_gpt2 as TG
    from tpudist_torch.ops import decode as D
    from tpudist_torch.ops import lm_kernels_bench as LB

    main = main or TG.main
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                      RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    dist.init_process_group("nccl", init_method="env://")
    try:
        with tempfile.TemporaryDirectory() as log_dir:
            tokens = LB.token_file(Path(log_dir) / "text.bin",
                                   16 * batch * seq)
            for mod in (*counted_modules(), D):
                mod.reset_launch_counts()
            out = io.StringIO()
            torch.cuda.synchronize()
            with contextlib.redirect_stdout(out):
                state, losses = main([
                    *flags, "--batch_size", str(batch), "--seq_len",
                    str(seq), "--tokens", str(tokens), "--JobID", job,
                    "--log_dir", log_dir])
            torch.cuda.synchronize()
            counts = (legs or {}).get("train") or {**launches(),
                                                   **D.launch_counts}
            rows = (Path(log_dir) / f"{job}_{batch}_0.log").read_text(
            ).splitlines()
            traces = list((Path(log_dir) / f"log_{job}").glob(
                "*.pt.trace.json"))
            window = trace_breakdown(traces[0]) if traces else None
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    printed = out.getvalue()
    print("  " + "\n  ".join(ln for ln in printed.strip().splitlines()
                             if not ln.startswith("Epoch: ")))
    if not isinstance(state.module, torch.nn.parallel.DistributedDataParallel):
        fail("the training step did not run under DDP")
    model = state.model
    del state
    steps = len(losses)
    TRAINED_LOSSES[job] = list(losses)
    n_leaves = len(list(model.parameters()))
    print(f"  {steps} steps; {n_leaves} leaves; losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}")
    if steps != 16 or n_leaves != leaves:
        fail(f"{job}: {steps} steps and {n_leaves} leaves, want 16 and "
             f"{leaves}")
    check_counts(job, counts, want(getattr(model, "depth", None), n_leaves),
                 steps)
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"losses {losses}")
    line = [ln for ln in printed.splitlines() if ln.startswith("tokens/sec: ")]
    if len(line) != 1 or f"steps={steps} " not in line[0]:
        fail(f"no tokens/sec line for {steps} steps in the run's output")
    if not traces:
        fail(f"no profiler trace under log_{job}")
    STEP_MS[job] = run_report(rows, window, steps=steps, batch=batch,
                              per_row=seq, unit="tokens", smi=smi)
    for key in trace_kernels:
        hits = [v for k, v in window["by_name"].items() if key in k]
        print(f"  {key}: {sum(ms for ms, _ in hits):.3f} ms/step in "
              f"{sum(n for _, n in hits):.0f} launches/step (profiler window)"
              f"  [{smi}]")
    return {"counts": counts, "printed": printed, "model": model}


def run_report(rows, window, *, steps: int, batch: int, unit: str, smi: str,
               per_row: int = 1, trace: str | None = None) -> float:
    """Phases 9, 14, 18 and 22: fail unless the TSV has rows at g_step 5,
    10 and 15, the TrainTime row and one HBM row (the allocator's stats
    after bring-up; 16 steps stay under its cadence of 50), and the
    profiler window holds device work; print the step at g_step 15, the
    run's rate in ``unit`` per second (``per_row`` of them a batch row),
    the HBM row and the window's kernels, device time and busy share per
    step. Returns the g_step-15 step's milliseconds."""
    hbm = [r for r in rows if r.startswith("HBM\t")]
    rows = [r for r in rows if not r.startswith("HBM\t")]
    g_steps = [r.split("\t")[1] for r in rows[1:] if not r.startswith("TrainTime")]
    if g_steps != ["5", "10", "15"] or not rows[-1].startswith("TrainTime\t"):
        fail(f"TSV rows {rows}")
    # the bring-up row of the card's allocator (fit's memory_log_every)
    if len(hbm) != 1 or set(json.loads(hbm[0].split("\t", 1)[1])) != {
            "bytes_in_use", "peak_bytes_in_use", "bytes_limit"}:
        fail(f"TSV HBM rows {hbm}")
    if not window or not window["steps"] or not window["kernels_per_step"]:
        fail(f"the profiler trace holds no device work: {window}")
    train_s = float(rows[-1].split("\t")[1])
    eps15 = float(rows[3].split("\t")[4])
    step_ms = batch / eps15 * 1e3
    print(f"  TSV: rows at g_step 5/10/15 + TrainTime {train_s:.3f} s; step at "
          f"g_step 15 {step_ms:.2f} ms ({eps15 * per_row:.1f} {unit}/s); "
          f"{steps * batch * per_row / train_s:.1f} {unit}/s over the run "
          f"(profiler window and first step included)"
          f"{f'; trace {trace}' if trace else ''}  [{smi}]")
    print(f"  TSV {hbm[0]}")
    print(f"  profiler window ({window['steps']} steps, profiled): "
          f"{window['kernels_per_step']:.0f} kernels/step, device busy "
          f"{window['device_ms_per_step']:.2f} ms/step of "
          f"{window['window_ms_per_step']:.2f} ms/step wall; busy share of the "
          f"unprofiled g_step-15 step {window['device_ms_per_step'] / step_ms:.3f}")
    for name, ms, count in window["top"]:
        print(f"    {ms:8.3f} ms/step  {count:5.0f}/step  {name}")
    return step_ms


def gpt2_runner(batch: int, seq: int, extra=()):
    """``run(flags, log_dir) -> (state, losses)``: 4 steps of
    ``train_gpt2.main`` with ``flags`` at ``batch`` x ``seq`` on
    :func:`lm_kernels_bench.token_file`'s text, output silenced."""
    from tpudist_torch import train_gpt2 as TG
    from tpudist_torch.ops import lm_kernels_bench as LB

    def run(flags, log_dir):
        tokens = LB.token_file(Path(log_dir) / "text.bin", 4 * batch * seq)
        with contextlib.redirect_stdout(io.StringIO()):
            return TG.main([
                *flags, *extra, "--batch_size", str(batch), "--seq_len",
                str(seq), "--tokens", str(tokens), "--no_profiler",
                "--log_dir", log_dir])

    return run


def vit_runner(n_images: int = 512):
    """``run(flags, log_dir) -> (state, losses)``: ``main.main`` with
    ViT-B/16 on ``n_images`` synthetic 32x32 images, batch 128, one epoch,
    float32 unless ``flags`` say otherwise, output silenced."""
    from tpudist_torch import main as M

    def run(flags, log_dir):
        with contextlib.redirect_stdout(io.StringIO()):
            return M.main([
                "--model", "vit_b16", "--dataset", "synthetic",
                "--synthetic_size", str(n_images), "--batch_size", "128",
                "--epochs", "1", "--no_profiler", "--log_dir", log_dir,
                *flags])

    return run


def f32_agreement(kernel_path, dense_flags, *, run, loss_bar: float,
                  param_bar: float, peak_lr: float, what: str) -> None:
    """Phases 15, 19 and 23: four float32 steps of the kernels' path
    (``kernel_path`` = (flags, the counted kernels it must NOT launch))
    and of the dense path from the same init on the same batches, one
    process, each run by ``run(flags, log_dir)``. The kernels' run must
    launch every other counted kernel and the dense run none. Losses are
    held to ``loss_bar`` relative and parameters to ``param_bar``
    absolute, except the key slice of the qkv biases, whose gradient is
    zero in exact arithmetic (Adam turns its rounding into a full step of
    either sign): on both runs it stays within 1.5 x steps x
    ``peak_lr`` of its zero init."""
    (kernel_flags, unused) = kernel_path
    unused = set(unused) | WIDE_LN  # every agreement phase runs D 768
    runs = []
    with tempfile.TemporaryDirectory() as log_dir:
        for flags, kernels in ((kernel_flags, True), (dense_flags, False)):
            for mod in counted_modules():
                mod.reset_launch_counts()
            st, ls = run(flags, log_dir)
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
    key_bound = 1.5 * len(lf) * peak_lr
    diff = (pf[worst] - pn[worst]).abs()
    print(f"  losses {lf} vs {ln}: max rel {loss_rel:.3e} [bar {loss_bar:g}]; "
          f"params max abs {gaps[worst]:.3e} ({worst}: {int((diff > 1e-5).sum())}"
          f" of {diff.numel()} elements over 1e-5) [bar {param_bar:g}]; "
          f"key slice of the qkv biases moved at most {key_moved:.3e} [step "
          f"bound {key_bound:.2e}]")
    if (len(lf) != 4 or loss_rel > loss_bar or gaps[worst] > param_bar
            or key_moved > key_bound):
        fail(f"{what} disagree")


def trace_breakdown(path: Path) -> dict:
    """Per-step device work in a ``torch.profiler`` Chrome trace: kernels,
    the card's busy time (the union of kernel, memcpy and memset
    intervals), the window's wall time (its ``ProfilerStep#`` spans), the
    eight kernels that take the most time and every kernel's ms and
    launches a step (``by_name``, names cut at 70 characters)."""
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
        by_name={k: (v[0] / 1e3 / n, v[1] / n) for k, v in by_name.items()},
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


RECOVERY_CHILD = "--recovery_child"


def recovery_child(argv) -> int:
    """One rank of a launched world (phases 31-32): ``argv`` is
    ``--local_rank=i --recovery_child CLI OUT_DIR CLI_ARGS...``. Forms a
    1-rank NCCL group from the launcher's env:// variables (so the step
    runs under DDP and the checkpointer on its gloo group), makes cuDNN
    deterministic, zeroes the launch counts, runs ``tpudist_torch.<CLI>``
    and writes ``life<generation>.json`` to OUT_DIR (losses, exit code,
    launch counts) whatever way the life ends."""
    import importlib

    import torch
    import torch.distributed as dist

    i = argv.index(RECOVERY_CHILD)
    cli, out = argv[i + 1], Path(argv[i + 2])
    cli_args = argv[:i] + argv[i + 3:]
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="env://")
    module = importlib.import_module(f"tpudist_torch.{cli}")
    for mod in counted_modules():
        mod.reset_launch_counts()
    gen = int(os.environ.get("TPUDIST_RESTART_GENERATION", "0"))
    record = {"generation": gen, "code": None}
    try:
        state, losses = module.main(cli_args)
        record.update(code=0, losses=losses, step=state.step)
    except SystemExit as e:
        record.update(code=e.code, losses=getattr(e, "losses", None),
                      step=getattr(e, "step", None))
        raise
    finally:
        torch.cuda.synchronize()
        record["launches"] = launches()
        (out / f"life{gen}.json").write_text(json.dumps(record))
        dist.destroy_process_group()
    return 0


def start_launch(cli: str, args, out: Path, launcher=(), port=None) -> dict:
    """Start ``tpudist_torch.<cli>`` with ``args`` under ``python -m
    tpudist_torch.launch --nproc_per_node 1 [launcher]`` through
    :func:`recovery_child` on master port ``port``, its stdout and stderr
    to ``out/launcher.log``; :func:`finish_launch` waits for it."""
    out.mkdir()
    cmd = [sys.executable, "-m", "tpudist_torch.launch", "--nproc_per_node",
           "1", "--master_port", str(port or free_port()), *launcher,
           str(HERE / "chip_smoke.py"), RECOVERY_CHILD, cli, str(out), *args]
    with open(out / "launcher.log", "w") as log:
        proc = subprocess.Popen(cmd, cwd=HERE, stdout=log,
                                stderr=subprocess.STDOUT, text=True)
    return dict(proc=proc, out=out, what=f"{cli} {' '.join(launcher)}")


def finish_launch(run: dict, timeout: float = 600) -> tuple[str, list]:
    """Fail unless the launcher :func:`start_launch` started exits 0
    within ``timeout`` s. Returns its stdout + stderr and each life's
    record, generation order."""
    proc, out = run["proc"], run["out"]
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.terminate()  # the launcher forwards it and reaps its world
        proc.wait()
        text = (out / "launcher.log").read_text()
        fail(f"{run['what']}: launcher timed out:\n{text[-4000:]}")
    text = (out / "launcher.log").read_text()
    if proc.returncode != 0:
        fail(f"{run['what']}: launcher exited {proc.returncode}:\n"
             f"{text[-4000:]}")
    lives = [json.loads((out / f"life{g}.json").read_text())
             for g in range(len(list(out.glob("life*.json"))))]
    return text, lives


def stop_launches(runs: dict) -> None:
    """Terminate every launcher of ``runs`` still running (a phase that
    failed while they ran), and reap it."""
    for run in runs.values():
        if run["proc"].poll() is None:
            run["proc"].terminate()
            try:
                run["proc"].wait(timeout=60)
            except subprocess.TimeoutExpired:
                run["proc"].kill()
                run["proc"].wait()


def same_checkpoints(a: Path, b: Path, step: int) -> int:
    """Fail unless saved step ``step`` of the two directories holds the
    same entries, every tensor bit-identical. Returns the tensor count."""
    import torch

    from tpudist_torch.checkpoint import read_step

    sa, sb = read_step(a, step), read_step(b, step)
    if sa.keys() != sb.keys():
        fail(f"step {step} checkpoints differ in keys: "
             f"{sorted(set(sa) ^ set(sb))[:8]}")
    differ = [k for k in sa if not (
        torch.equal(sa[k], sb[k]) if isinstance(sa[k], torch.Tensor)
        else sa[k] == sb[k])]
    if differ:
        fail(f"step {step} checkpoints differ in {len(differ)} entries, "
             f"e.g. {differ[:4]}")
    return sum(isinstance(v, torch.Tensor) for v in sa.values())


def check_lives(what: str, lives: list, want_steps, per_step: dict) -> None:
    """Fail unless each life ran its steps (``want_steps[g]``) and
    launched ``per_step`` kernels a step."""
    for life, steps in zip(lives, want_steps):
        got = life["launches"]
        if any(got[k] != n * steps for k, n in per_step.items()):
            fail(f"{what} generation {life['generation']}: launches {got}, "
                 f"want {per_step} x {steps} steps")
    print(f"  {what}: " + "; ".join(
        f"generation {life['generation']} exit {life['code']}, "
        f"{steps} steps, launches "
        f"{ {k: life['launches'][k] for k in per_step} }"
        for life, steps in zip(lives, want_steps)))


def _recovery_args(tmp: Path) -> dict:
    """Phases 31 and 32's runs by name: ``(cli, its flags, the
    launcher's flags)``, the run's checkpoint directory to be added."""
    from tpudist_torch.ops import lm_kernels_bench as LB

    tokens = LB.token_file(tmp / "text.bin", 16 * 8 * 1024)
    resnet = ["--model", "resnet50", "--dataset", "synthetic",
              "--synthetic_size", "2048", "--batch_size", "128", "--epochs",
              "1", "--bf16", "--fused", "optimizer", "--amp",
              "--no_profiler", "--checkpoint_every", "4", "--log_dir",
              str(tmp)]
    gpt2 = ["--bf16", "--fused", "all", "--amp", "--attn", "auto",
            "--batch_size", "8", "--seq_len", "1024", "--tokens",
            str(tokens), "--no_profiler", "--checkpoint_every", "6",
            "--log_dir", str(tmp)]
    return {"r_full": ("main", resnet, ()),
            "r_drill": ("main", [*resnet, "--chaos", "corrupt@12"],
                        ("--max_restarts", "1", "--backoff_base", "0")),
            "g_full": ("train_gpt2", gpt2, ()),
            "g_drill": ("train_gpt2", [*gpt2, "--chaos", "sigterm@8"], ())}


def start_recovery(tmp: Path) -> dict:
    """Phases 31 and 32's four launched runs, started together (each on
    a master port of its own): ResNet-50's and GPT-2's uninterrupted runs
    and drills, checkpoints under ``tmp``."""
    runs, ports = {}, set()
    for name, (cli, args, launcher) in _recovery_args(tmp).items():
        port = free_port()
        while port in ports:
            port = free_port()
        ports.add(port)
        runs[name] = start_launch(
            cli, [*args, "--checkpoint_dir", str(tmp / name)],
            tmp / f"{name}_out", launcher, port)
    return runs


def recovery_phases(smi: str, tmp: Path, runs: dict) -> None:
    """Phases 31 and 32 (module docstring) on the runs
    :func:`start_recovery` started."""
    adamw = {"fused_adamw": 1, "fused_adamw_check": 1}
    t0 = time.perf_counter()
    print("== 31. recovery: ResNet-50 bf16 --fused optimizer --amp "
          "through tpudist_torch.launch, --chaos corrupt@12")
    _, base = finish_launch(runs["r_full"])
    text, lives = finish_launch(runs["r_drill"])
    fallback = [ln for ln in text.splitlines()
                if ln.startswith("checkpoint_fallback: ")]
    if (len(lives) != 2 or lives[0]["code"] is not None
            or lives[1]["code"] != 0 or len(fallback) != 1
            or '"failed_step": 12' not in fallback[0]
            or '"next_step": 8' not in fallback[0]
            or not (tmp / "r_drill" / "_failed" / "12").is_dir()):
        fail(f"corrupt@12: lives {[(l['generation'], l['code']) for l in lives]}"
             f", fallback lines {fallback}")
    print(f"  generation 0 crashed after truncating step 12; generation 1: "
          f"{fallback[0][:160]}...")
    resumed_at(lives[1], base[0], 8, "ResNet-50")
    check_lives("launches", [base[0], *lives], (16, 12, 8),
                {**adamw, "fused_adamw_leaves": 161})
    n = same_checkpoints(tmp / "r_full", tmp / "r_drill", 16)
    print(f"  step-16 checkpoints bit-identical: {n} tensors")

    print("== 32. recovery: GPT-2 124M S 1024 bf16 --fused all --amp "
          "through tpudist_torch.launch, --chaos sigterm@8")
    _, base = finish_launch(runs["g_full"])
    text, lives = finish_launch(runs["g_drill"])
    if (len(lives) != 2 or lives[0]["code"] != 75 or lives[0]["step"] != 8
            or lives[1]["code"] != 0
            or "exited rc=75 (restartable); restarting generation 1"
            not in text):
        fail(f"sigterm@8: lives {[(l['generation'], l['code']) for l in lives]}"
             f"\n{text[-3000:]}")
    if lives[0]["losses"] != base[0]["losses"][:8]:
        fail(f"the preempted life's losses {lives[0]['losses']} are not "
             f"the uninterrupted run's first 8 {base[0]['losses'][:8]}")
    print("  generation 0 exited 75 after its emergency checkpoint at "
          "step 8; generation 1 resumed")
    resumed_at(lives[1], base[0], 8, "GPT-2 124M")
    depth = 12
    check_lives("launches", [base[0], *lives], (16, 8, 8), {
        **adamw, "fused_adamw_leaves": 148,
        "layernorm_fwd": 2 * depth + 1, "layernorm_bwd": 2 * depth + 1,
        "layernorm_bwd_reduce": 2 * depth + 1,
        "vmem_attention_fwd": depth, "vmem_attention_bwd": depth,
        "flash_attention_fwd": 0, "flash_attention_bwd": 0})
    n = same_checkpoints(tmp / "g_full", tmp / "g_drill", 16)
    print(f"  step-16 checkpoints bit-identical: {n} tensors  [phases 31-32: "
          f"{time.perf_counter() - t0:.1f} s of checks after the two-rank "
          f"world, beside which their four runs ran]  [{smi}]")


def resumed_at(life: dict, base: dict, k: int, what: str) -> None:
    """Fail unless the resumed ``life`` trained steps k+1..16 with exactly
    the uninterrupted run's losses."""
    import numpy as np

    want = base["losses"][k:]
    if (life["step"] != 16 or life["losses"] != want
            or len(base["losses"]) != 16
            or not np.isfinite(base["losses"]).all()):
        fail(f"{what}: resumed losses {life['losses']} (step {life['step']})"
             f" against the uninterrupted run's {want}")
    print(f"  {what}: generation {life['generation']} resumed at step {k + 1};"
          f" its {len(want)} losses equal the uninterrupted run's bit for bit "
          f"({want[0]:.6f} .. {want[-1]:.6f})")


def checkpoint_costs(smi: str) -> None:
    """Phase 33 (module docstring)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tpudist_torch.checkpoint import Checkpointer
    from tpudist_torch.models import resnet
    from tpudist_torch.models.gpt2 import GPT2
    from tpudist_torch.optim import make_optimizer
    from tpudist_torch.train import create_train_state, lm_loss, make_train_step

    print("== 33. checkpoint costs (1-rank NCCL group, keep_last 2)")
    t_phase = time.perf_counter()
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                      RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    dist.init_process_group("nccl", init_method="env://")
    rng = np.random.Generator(np.random.PCG64(SEED))
    bf16 = torch.bfloat16
    cases = (
        ("ResNet-50", 0.31,
         lambda: resnet.resnet50(dtype=bf16, device="cuda"),
         dict(weight_decay=0.0), "optimizer", {},
         lambda: {"image": torch.from_numpy(rng.standard_normal(
             (128, 32, 32, 3), dtype=np.float32)).cuda(),
                  "label": torch.from_numpy(rng.integers(
                      0, 1000, 128).astype(np.int32)).cuda()}),
        ("GPT-2 124M", 1.49,
         lambda: GPT2(dtype=bf16, attn_impl="vmem", device="cuda", seed=SEED),
         dict(weight_decay=0.1, clip_norm=1.0), "all",
         dict(loss_fn=lm_loss, input_key="tokens", label_key="tokens"),
         lambda: {"tokens": torch.from_numpy(rng.integers(
             0, VOCAB, (8, 1024)).astype(np.int32)).cuda()}))
    for name, want_gb, build, opt, fused, kw, batch in cases:
        model = build()
        tx = make_optimizer(1e-4, fused=True, compute_dtype=bf16,
                            skip_nonfinite_updates=True, **opt)
        state = create_train_state(model, tx)
        step = make_train_step(model, tx, fused=fused, **kw)
        with tempfile.TemporaryDirectory() as tmp:
            ck = Checkpointer(tmp, keep_last=2)
            state, _ = step(state, batch())
            blocks, flushes, writes = [], [], []
            for _ in range(2):  # the first save also pins its host buffers
                state, _ = step(state, batch())
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ck.save(state)
                blocks.append(time.perf_counter() - t0)
                ck.wait()
                flushes.append(time.perf_counter() - t0)
                writes.append(ck.last_write_s)
            gb = ck.step_bytes(state.step) / 1e9
            state, _ = step(state, batch())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ck.save(state, wait=True)
            emergency = time.perf_counter() - t0
            masters = {k: v.clone() for k, v in state.params().items()}
            saved = state.step
            state, _ = step(state, batch())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ck.restore(state)
            torch.cuda.synchronize()
            restore = time.perf_counter() - t0
            if state.step != saved or any(not torch.equal(masters[k], v)
                                          for k, v in state.params().items()):
                fail(f"{name}: restore did not bring step {saved} back")
            kept = ck.all_steps()
            ck.close()
        print(f"  {name}: {gb:.3f} GB a step on disk (expected ~{want_gb}); "
              f"an async save blocks {blocks[1] * 1e3:.2f} ms ({blocks[0] * 1e3:.1f}"
              f" ms the first, which pins its buffers), durable after "
              f"{flushes[1]:.3f} s (background write {writes[1]:.3f} s; first "
              f"{flushes[0]:.3f} / {writes[0]:.3f} s); emergency wait=True save "
              f"{emergency:.3f} s; restore {restore:.3f} s; kept steps {kept}"
              f"  [{smi}]")
        if kept != [saved - 1, saved]:
            fail(f"{name}: keep_last 2 kept {kept}")
        if abs(gb - want_gb) > 0.05 * want_gb:
            fail(f"{name}: {gb:.3f} GB a step, expected ~{want_gb}")
        del model, state, step, tx
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    print(f"  [{time.perf_counter() - t_phase:.1f} s]")


#: phases 45-49's data: ImageNet-1k's shapes (224 x 224 x 3 uint8 rows,
#: 1000 classes), cut from its 1,281,167 training images to 2048 (16 steps
#: of 128) and its 50,000 validation images to 512
IMAGENET_ROWS, IMAGENET_VAL_ROWS, IMAGENET_SIZE = 2048, 512, 224
IMAGENET_CLASSES = [f"n{i:08d}" for i in range(1000)]
#: phase 47's shards: 512 rows (77,070,336 bytes), 4 steps of 128 each
SHARD_ROWS = 512
#: phase 28's peak device memory (bytes) without remat, for phase 49
PEAKS: dict[str, float] = {}


def write_pack(prefix: str, n: int, seed: int) -> int:
    """``synthetic_imagenet(n)`` as a pack in ``data/packed.py``'s layout,
    written through ``np.lib.format.open_memmap``; returns its bytes."""
    import numpy as np

    from tpudist_torch.data.imagenet import synthetic_imagenet

    data = synthetic_imagenet(n, image_size=IMAGENET_SIZE, seed=seed)
    images = np.lib.format.open_memmap(f"{prefix}_images.npy", mode="w+",
                                       dtype=np.uint8, shape=data["image"].shape)
    images[:] = data["image"]
    images.flush()
    nbytes = int(images.nbytes)
    del images
    np.save(f"{prefix}_labels.npy", data["label"])
    Path(f"{prefix}_meta.json").write_text(json.dumps({
        "classes": IMAGENET_CLASSES, "image_size": IMAGENET_SIZE, "n": n,
        "source_root": "synthetic_imagenet", "transform": "synthetic"}))
    return nbytes


@contextlib.contextmanager
def instances(cls, on_init=None):
    """While open, every ``cls`` built is appended to the yielded list (and
    handed to ``on_init``)."""
    made, init = [], cls.__init__

    def record(self, *args, **kwargs):
        init(self, *args, **kwargs)
        made.append(self)
        if on_init is not None:
            on_init(self)

    cls.__init__ = record
    try:
        yield made
    finally:
        cls.__init__ = init


def imagenet_cli(flags, *, job: str, smi: str, per_step: dict,
                 leaves: int) -> dict:
    """Phases 45-48: a 1-rank NCCL group, then ``main.main`` with
    ``--dataset imagenet --image_size 224 --batch_size 128 --epochs 1`` and
    ``flags``, the profiler on, every launch count set to 0 just before and
    read just after (``--eval`` included). Fails unless it ran 16 steps
    under DDP on a model of ``leaves`` leaves with ``per_step`` launches a
    step and no other counted kernel, finite losses, the TSV rows and a
    trace. Returns its losses, output, the trace's readings, its
    host-to-device bytes a step and the peak device memory."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tpudist_torch import main as M

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                      RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    dist.init_process_group("nccl", init_method="env://")
    try:
        with tempfile.TemporaryDirectory() as log_dir:
            for mod in counted_modules():
                mod.reset_launch_counts()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            out = io.StringIO()
            torch.cuda.synchronize()
            with contextlib.redirect_stdout(out):
                state, losses = M.main([
                    "--dataset", "imagenet", "--image_size", str(IMAGENET_SIZE),
                    "--batch_size", "128", "--epochs", "1", "--JobID", job,
                    "--log_dir", log_dir, *flags])
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            counts = launches()
            ddp = isinstance(state.module,
                             torch.nn.parallel.DistributedDataParallel)
            n_leaves = len(list(state.model.parameters()))
            rows = (Path(log_dir) / f"{job}_128_0.log").read_text().splitlines()
            traces = list((Path(log_dir) / f"log_{job}").glob("*.pt.trace.json"))
            window = trace_breakdown(traces[0]) if traces else None
            h2d = h2d_per_step(traces[0]) if traces else None
    finally:
        dist.destroy_process_group()
    del state
    printed = out.getvalue()
    print("  " + "\n  ".join(ln for ln in printed.strip().splitlines()
                             if not ln.startswith("Epoch: ")))
    steps = len(losses)
    print(f"  {steps} steps; {n_leaves} leaves; losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}")
    if not ddp:
        fail(f"{job}: the training step did not run under DDP")
    if steps != 16 or n_leaves != leaves:
        fail(f"{job}: {steps} steps and {n_leaves} leaves, want 16 and {leaves}")
    check_counts(job, counts, per_step, steps)
    if not np.isfinite(losses).all():
        fail(f"{job}: losses {losses}")
    if not traces:
        fail(f"no profiler trace under log_{job}")
    step_ms = run_report(rows, window, steps=steps, batch=128, unit="images",
                         smi=smi, trace=traces[0].name)
    print(f"  host-to-device per profiled step: {h2d['bytes']:.0f} bytes in "
          f"{h2d['copies']:.1f} copies (trace); peak device memory "
          f"{peak / 1e9:.3f} GB (max_memory_allocated)  [{smi}]")
    if not (h2d["steps"] and h2d["copies"] and h2d["has_bytes"]):
        fail(f"{job}: host-to-device copies {h2d}")
    return dict(losses=losses, printed=printed, window=window, h2d=h2d,
                peak=peak, step_ms=step_ms)


def imagenet_phases(smi: str, dev) -> None:
    """Phases 45-49 (module docstring)."""
    import numpy as np
    import torch

    from tpudist_torch.data import device_cache as DC
    from tpudist_torch.data import loader as L

    resnet50 = {"fused_adamw": 1, "fused_adamw_leaves": 161}
    image_bytes = IMAGENET_SIZE * IMAGENET_SIZE * 3
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        train, val = f"{tmp}/in224", f"{tmp}/in224_val"
        nbytes = write_pack(train, IMAGENET_ROWS, SEED)
        vbytes = write_pack(val, IMAGENET_VAL_ROWS, SEED + 1)
        print(f"== packs: {IMAGENET_ROWS} training rows ({nbytes} bytes) and "
              f"{IMAGENET_VAL_ROWS} validation rows ({vbytes} bytes) written "
              f"in {time.perf_counter() - t0:.1f} s")
        if nbytes != IMAGENET_ROWS * image_bytes:
            fail(f"the training pack holds {nbytes} bytes")
        data = ["--packed", train, "--packed_val", val, "--eval"]

        # -- 45. ResNet-50 on the host loader ---------------------------------
        t0 = time.perf_counter()
        print("== 45. ResNet-50 at 224x224, bf16, --fused optimizer, the pack "
              "through the host loader (native gather), --eval, 16 steps under "
              "DDP (NCCL)")
        with instances(L.DataLoader) as loaders:
            host = imagenet_cli(["--model", "resnet50", "--bf16", "--fused",
                                 "optimizer", *data], job="In45", smi=smi,
                                per_step=resnet50, leaves=161)
        gathers = [ld.gather_seconds / max(len(ld), 1) for ld in loaders]
        print(f"  native gather (host, pinned): {gathers[0] * 1e3:.2f} ms a "
              f"training batch of 128 x {image_bytes} bytes, "
              f"{gathers[1] * 1e3:.2f} ms an eval batch; the image batch is "
              f"{128 * image_bytes} bytes of uint8")
        if not 0 <= host["h2d"]["bytes"] - 128 * image_bytes <= CACHE_H2D_BAR:
            fail(f"phase 45 moved {host['h2d']['bytes']:.0f} bytes a step to "
                 f"the card, want the {128 * image_bytes}-byte image batch "
                 f"and at most {CACHE_H2D_BAR} more")
        if "Accuracy: " not in host["printed"]:
            fail("phase 45: no top-1 line")
        streaming_phase(smi)
        print(f"  phase 45: {time.perf_counter() - t0:.1f} s")

        # -- 46. ResNet-50 on the device cache --------------------------------
        t0 = time.perf_counter()
        print("== 46. the same with --device_cache --augment: the pack on the "
              "card, indices and labels a step")
        cached = imagenet_cli(["--model", "resnet50", "--bf16", "--fused",
                               "optimizer", "--device_cache", "--augment",
                               *data], job="In46", smi=smi, per_step=resnet50,
                              leaves=161)
        if cached["h2d"]["bytes"] > CACHE_H2D_BAR:
            fail(f"phase 46 moved {cached['h2d']['bytes']:.0f} bytes a step "
                 f"to the card [bar {CACHE_H2D_BAR}]")
        print(f"  phase 46: {time.perf_counter() - t0:.1f} s")

        # -- 47. ResNet-50 on the rotating device cache -----------------------
        t0 = time.perf_counter()
        print(f"== 47. the same with --device_cache --cache_shard_rows "
              f"{SHARD_ROWS}: 4 shards of {SHARD_ROWS * image_bytes} bytes")
        staged, batches = [], []

        def record(rot):
            stage, iterate = rot._stage, rot._iter_impl

            def stage_rows(rows):
                staged.append(np.array(rows))
                return stage(rows)

            def iterate_batches(start):
                for b in iterate(start):
                    batches.append(np.array(b["image"]))
                    yield b

            rot._stage, rot._iter_impl = stage_rows, iterate_batches

        with instances(DC.RotatingDeviceCache, record) as rots:
            rotated = imagenet_cli(
                ["--model", "resnet50", "--bf16", "--fused", "optimizer",
                 "--device_cache", "--cache_shard_rows", str(SHARD_ROWS),
                 *data], job="In47", smi=smi, per_step=resnet50, leaves=161)
        rot = rots[0]
        shards, orders = rot.epoch_plan()
        per_shard = SHARD_ROWS // 128
        seen = np.concatenate([staged[i // per_shard][b]
                               for i, b in enumerate(batches)])
        planned = all(np.array_equal(a, w) for a, w in zip(staged, shards))
        planned &= all(np.array_equal(b, orders[i // per_shard][
            (i % per_shard) * 128:(i % per_shard + 1) * 128])
            for i, b in enumerate(batches))
        once = np.array_equal(np.sort(seen), np.arange(IMAGENET_ROWS))
        print(f"  {len(staged)} shards staged, {len(batches)} index batches: "
              f"the (seed, epoch) plan {planned}; every row once {once}")
        for i, entry in enumerate(rot.stage_log):
            print(f"    shard {i}: staged in {entry['stage_s'] * 1e3:.1f} ms, "
                  f"the iterator waited {entry['wait_s'] * 1e3:.1f} ms at its "
                  f"boundary; copy done at first use "
                  f"{rot.ready_at_use[i] if i < len(rot.ready_at_use) else None}")
        print(f"  peak device memory {rotated['peak'] / 1e9:.3f} GB against "
              f"{host['peak'] / 1e9:.3f} on the host loader (phase 45) and "
              f"{cached['peak'] / 1e9:.3f} with the whole pack (phase 46)  "
              f"[{smi}]")
        if len(staged) != 4 or len(batches) != 16 or not (planned and once):
            fail("phase 47: the rotation did not follow its plan")
        rotation_check(train, smi, dev)
        print(f"  phase 47: {time.perf_counter() - t0:.1f} s")

        # -- 48. ViT-B/16 at 224 -------------------------------------------------
        t0 = time.perf_counter()
        print("== 48. ViT-B/16 at 224x224 (16-pixel patches, 197 tokens), bf16, "
              "--fused all, the pack through the host loader, 16 steps under "
              "DDP (NCCL)")
        vit = imagenet_cli(
            ["--model", "vit_b16", "--bf16", "--fused", "all", "--packed",
             train], job="In48", smi=smi, leaves=152,
            per_step={"layernorm_fwd": 25, "layernorm_bwd": 25,
                      "layernorm_bwd_reduce": 25, "fused_adamw": 1,
                      "fused_adamw_leaves": 152})
        print(f"  phase 48: {time.perf_counter() - t0:.1f} s")
    budget_phase(smi, vit["peak"])


def streaming_phase(smi: str) -> None:
    """Phase 45's second part: where the machine has PIL, a JPEG tree the
    smoke writes is packed (``pack_image_folder``) and streamed through
    ``ImageFolderLoader`` on 4 decode threads; the pack's rows equal the
    eval loader's pixels."""
    import numpy as np

    try:
        from PIL import Image
    except ImportError:
        print("  PIL is not installed here: the streaming loader and "
              "pack_image_folder are held by the CPU tests only")
        return
    from tpudist_torch.data.imagenet import ImageFolderLoader
    from tpudist_torch.data.packed import load_packed, pack_image_folder

    rng = np.random.Generator(np.random.PCG64(SEED + 45))
    with tempfile.TemporaryDirectory() as tmp:
        for c in range(4):
            (Path(tmp) / "train" / f"c{c}").mkdir(parents=True)
            for i in range(32):
                h, w = (int(x) for x in rng.integers(240, 400, 2))
                Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(
                    np.uint8)).save(Path(tmp) / "train" / f"c{c}" / f"{i}.jpg")
        stats = pack_image_folder(Path(tmp) / "train", f"{tmp}/jpk",
                                  image_size=IMAGENET_SIZE, workers=4)
        pack = load_packed(f"{tmp}/jpk")
        with ImageFolderLoader(Path(tmp) / "train", 128, train=False,
                               image_size=IMAGENET_SIZE, workers=4,
                               normalize=False) as ev:
            same = np.array_equal(next(iter(ev))["image"], pack["image"])
        with ImageFolderLoader(Path(tmp) / "train", 64, train=True,
                               image_size=IMAGENET_SIZE, workers=4) as tr:
            t0 = time.perf_counter()
            shapes = [b["image"].shape for b in tr]
            rate = 128 / (time.perf_counter() - t0)
    print(f"  PIL present: packed {stats['n']} JPEGs at "
          f"{stats['images_per_sec']:.0f} images/s; the pack equals the eval "
          f"loader's pixels {same}; streamed {len(shapes)} train batches of "
          f"{shapes[0]} at {rate:.0f} images/s on 4 decode threads (host)")
    if not same or shapes != [(64, IMAGENET_SIZE, IMAGENET_SIZE, 3)] * 2:
        fail("the streaming loader and its pack disagree")


def rotation_check(train: str, smi: str, dev) -> None:
    """Phase 47's check of the rotation alone, on the card: one epoch of
    ``RotatingDeviceCache`` over the pack through ``prefetch_to_device`` (as
    ``fit`` drives it), each batch gathered by its ``input_transform`` and
    held bit for bit to a host gather of the same rows; the peak device
    memory of the shards (and one gathered batch) against three shards."""
    import numpy as np
    import torch

    from tpudist_torch.data.device_cache import RotatingDeviceCache
    from tpudist_torch.data.loader import prefetch_to_device
    from tpudist_torch.data.packed import load_packed

    pack = load_packed(train)
    rot = RotatingDeviceCache({"image": pack["image"], "label": pack["label"]},
                              128, shard_rows=SHARD_ROWS, device=dev)
    gather = rot.input_transform()
    shards, orders = rot.epoch_plan()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    equal, seen = [], []
    for i, batch in enumerate(prefetch_to_device(iter(rot), dev)):
        got = gather(batch["image"], batch).cpu()
        rows = shards[i // 4][batch["image"].cpu().numpy()]
        equal.append(torch.equal(got, torch.from_numpy(
            np.asarray(pack["image"][rows]))))
        seen.append(rows)
    torch.cuda.synchronize()
    held = torch.cuda.max_memory_allocated() - base
    shard_bytes = SHARD_ROWS * pack["image"][0].nbytes
    once = np.array_equal(np.sort(np.concatenate(seen)),
                          np.arange(len(pack["label"])))
    print(f"  the rotation alone: {len(equal)} batches, each bit-identical to "
          f"a host gather of its rows {all(equal)}; every row once {once}; "
          f"peak device memory over the loop {held / 1e6:.1f} MB (3 shards "
          f"{3 * shard_bytes / 1e6:.1f} MB)  [{smi}]")
    if len(equal) != 16 or not all(equal) or not once:
        fail("the rotating cache's gathers differ from the host gather")
    if held > 3 * shard_bytes + 2 * 128 * pack["image"][0].nbytes:
        fail(f"the rotation held {held} bytes on the card, more than three "
             "shards")


def budget_phase(smi: str, vit_peak: int) -> None:
    """Phase 49: ``train_state_budget`` (built on the meta device) beside
    the allocator's peak: ViT-B/16 at phase 48's configuration, and GPT-2
    124M at phase 28's without remat."""
    import torch

    from tpudist_torch.memory import (budget_columns, device_memory_stats,
                                      format_budget, train_state_budget)
    from tpudist_torch.models.gpt2 import GPT2
    from tpudist_torch.models.vit import vit_b16
    from tpudist_torch.optim import make_optimizer

    t0 = time.perf_counter()
    print("== 49. train_state_budget (meta device) against the allocator's "
          "peak")
    bf16 = torch.bfloat16
    cases = (
        ("ViT-B/16 224, batch 128, --fused all (phase 48)",
         lambda d: vit_b16(patch_size=16, image_size=IMAGENET_SIZE, dtype=bf16,
                           device=d),
         make_optimizer(1e-3, fused=True, compute_dtype=bf16), 128, 197,
         vit_peak),
        ("GPT-2 124M, batch 8 x 1024, --fused all --amp --dropout 0.1, no "
         "remat (phase 28)",
         lambda d: GPT2(dtype=bf16, attn_impl="auto", dropout=0.1, device=d),
         make_optimizer(3e-4, fused=True, compute_dtype=bf16,
                        skip_nonfinite_updates=True), 8, 1024,
         PEAKS.get("gpt2_none")))
    stats = device_memory_stats()
    for name, build, tx, batch, seq, peak in cases:
        t = time.perf_counter()
        report = train_state_budget(build, tx, batch=batch, seq=seq)
        cols = budget_columns(report)
        share = ("not measured in this run" if peak is None else
                 f"{peak / report['per_chip_total_bytes']:.3f} of it")
        print(f"  {name}: {format_budget(report, live_peak_bytes=peak)} "
              f"(budgeted in {time.perf_counter() - t:.2f} s; estimate "
              f"{report['per_chip_total_bytes']} bytes, live peak {peak} "
              f"bytes: {share})  [{smi}]")
        if not (report["fits"] and cols["xla_static_bytes"] is None
                and report["hbm_budget_bytes"] == stats["bytes_limit"]):
            fail(f"phase 49: {report}, {cols}")
    print(f"  device_memory_stats {stats}")
    print(f"  phase 49: {time.perf_counter() - t0:.1f} s")


def kernel_table_phase(smi: str, dev) -> None:
    """Phase 50: the kernel table's readings at the encoder's and ViT-224's
    shapes, by phase 13's method (median of 50 device times, L2 flushed):
    vmem and flash, forward and backward alone, at BERT-base's B 32, H 12,
    S 512 non-causal beside SDPA and the bound; the LayerNorm kernels at
    ViT-B/16's 25,216 x 768 rows (batch 128 x 197 tokens), eps 1e-6,
    beside ``F.layer_norm``."""
    import torch

    from tpudist_torch.ops import lm_kernels_bench as LB

    t0 = time.perf_counter()
    print("== 50. kernel times at BERT-base's attention and ViT-B/16 224's "
          "LayerNorm (median of 50 device times, L2 flushed; bf16)")
    gen = torch.Generator(device=dev).manual_seed(SEED + 50)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for case in [*LB.encoder_timing_cases(gen),
                 *LB.ln_cases(gen, 128 * 197, eps=1e-6, tag="_vit224",
                              prenorm_fwd=True)]:
        t = LB.time_case(case, flush)
        lib = ("n/a" if t["library_ms"] is None
               else f"{t['library_ms'] * 1e3:.2f} us")
        print(f"  {case['name']} [{case['shape']}]: kernel "
              f"{t['kernel_ms'] * 1e3:.2f} us, bound {case['bound_ms'] * 1e3:.2f}"
              f" us ({case['bound_by']}), plain {t['plain_ms'] * 1e3:.1f} us, "
              f"library {lib}, max_abs_err {case['max_abs_err']:.3e}  [{smi}]")
    del flush
    print(f"  phase 50: {time.perf_counter() - t0:.1f} s")



#: phase 51's shapes (kernel, (B, S, H, H_kv)): GPT-2 124M at S 1024 and
#: S 4096, llama_125m's grouped heads
GATHERED_CASES = (("vmem", (8, 1024, 12, 12)), ("flash", (4, 4096, 12, 12)),
                  ("vmem", (8, 1024, 12, 4)))


def gathered_attention_phase(smi: str, dev, cases=GATHERED_CASES) -> None:
    """Phase 51 (module docstring) at ``cases``."""
    import functools

    import torch

    from tpudist_torch.ops import flash_attention as FA
    from tpudist_torch.ops import vmem_attention as VA
    from tpudist_torch.ops.attention import multi_head_attention
    from tpudist_torch.parallel import cp

    t0 = time.perf_counter()
    n = 4
    print(f"== 51. non-context-parallel attention over the gathered sequence, "
          f"loopback n = {n}, bf16 causal")
    gen = torch.Generator(device=dev).manual_seed(SEED + 51)

    def grads(fn, q, k, v, g):
        qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
        out = fn(qq, kk, vv)
        out.backward(g)
        return [out.detach(), qq.grad, kk.grad, vv.grad]

    for kind, (b, s, h, h_kv) in cases:
        mod = VA if kind == "vmem" else FA
        rnd = lambda heads: torch.randn(b, s, heads, 64, generator=gen,
                                        device=dev).to(torch.bfloat16)
        q, k, v, g = rnd(h), rnd(h_kv), rnd(h_kv), rnd(h)
        attn = functools.partial(multi_head_attention, impl=kind)
        whole = lambda *x: attn(*x, causal=True)
        gathered = lambda *x: cp.gathered_attention_loopback(
            *x, n, causal=True, attn_fn=attn)
        want = grads(whole, q, k, v, g)
        mod.reset_launch_counts()
        got = grads(gathered, q, k, v, g)
        launched = dict(mod.launch_counts)
        same = [torch.equal(a, w) for a, w in zip(got, want)]
        shape = f"B {b}, S {s}, H {h}/{h_kv}, dh 64"
        print(f"  {kind} [{shape}]: o, dq, dk, dv bit-identical to the whole "
              f"sequence {same}; launches {launched}")
        if not all(same):
            fail(f"gathered {kind} at {shape} differs from the whole call")
        if launched != {f"{kind}_attention_fwd": n,
                        f"{kind}_attention_bwd": n}:
            fail(f"gathered {kind}: launches {launched}, want {n} + {n}")
        del got, want
        qq, kk, vv = (x.detach().requires_grad_() for x in (q, k, v))
        one = event_ms(lambda: whole(qq, kk, vv).backward(g))
        ranks = event_ms(lambda: gathered(qq, kk, vv).backward(g))
        print(f"    forward + backward: whole sequence {one:.3f} ms, per rank "
              f"{ranks / n:.3f} ms ({ranks:.3f} for the {n} ranks; CUDA "
              f"events, median of 5)  [{smi}]")
    print(f"  phase 51: {time.perf_counter() - t0:.1f} s")


def spec_serving_phase(smi: str, dev, phase4: dict) -> None:
    """Phase 52 (module docstring)."""
    import numpy as np
    import torch

    from tpudist_torch.models.gpt2 import GPT2
    from tpudist_torch.ops import decode as D
    from tpudist_torch.ops import decode_bench as DB
    from tpudist_torch.serve import ServeEngine, early_exit_draft

    t0 = time.perf_counter()
    k = 4
    print(f"== 52. speculative serving: phase 4's configuration with "
          f"early_exit_draft(depth 4), spec_k {k}")
    prompts = DB.smoke_prompts(SEED)
    model = GPT2(dtype=torch.bfloat16, attn_impl="fused", device="cuda",
                 seed=SEED)
    eng = ServeEngine(model, max_slots=8, paged=True, block_size=32,
                      seed=SEED, draft_model=early_exit_draft(model, 4),
                      spec_k=k)
    warm = eng.submit(prompts[0][:20], 4)
    eng.run()
    if len(eng.result(warm)) != 4:
        fail("speculative warm-up request did not complete")
    eng.reset_stats()
    passes0 = eng.decode_steps
    widths = []
    launch = D.paged_fused_attention_cuda

    def recorded(q, *args, **kw):
        widths.append(q.shape[1])
        return launch(q, *args, **kw)

    D.reset_launch_counts()
    D.paged_fused_attention_cuda = recorded
    try:
        rids = [eng.submit(p, NEW, **opts)
                for p, opts in zip(prompts, phase4["sampling"])]
        torch.cuda.synchronize()
        out = eng.run()
        torch.cuda.synchronize()
    finally:
        D.paged_fused_attention_cuda = launch
    counts = dict(D.launch_counts)
    passes = eng.decode_steps - passes0
    for r in rids:
        toks = out[r]
        if len(toks) != NEW or not all(0 <= t < VOCAB for t in toks):
            fail(f"speculative request {r}: {len(toks)} tokens")
    paged = counts["paged_decode_attention"]
    if paged != model.depth * passes or set(widths) != {k + 1}:
        fail(f"paged kernel launched {paged} times at s_q {sorted(set(widths))}"
             f" for {passes} verify passes x {model.depth} layers")
    if counts["fused_decode_attention"]:
        fail(f"contiguous kernel launched: {counts}")
    snap, base = eng.stats.snapshot(), phase4["snap"]
    greedy = [i for i, o in enumerate(phase4["sampling"])
              if o["temperature"] == 0.0]
    equal = sum(out[rids[i]] == phase4["streams"][i] for i in greedy)
    print(f"  8 requests x {NEW} tokens, {passes} verify passes, paged kernel "
          f"launches {paged} (= {model.depth} x {passes}), every one at s_q "
          f"{k + 1}")
    print(f"  drafted {snap['spec_drafted']}, accepted {snap['spec_accepted']}, "
          f"acceptance rate {snap['spec_acceptance_rate']}")
    print(f"  TPOT p50 {snap['tpot_p50']} s against phase 4's "
          f"{base['tpot_p50']}, {snap['tokens_per_sec']} tok/s against "
          f"{base['tokens_per_sec']}, TTFT p50 {snap['ttft_p50']} s  [{smi}]")
    print(f"  greedy streams equal to phase 4's: {equal} of {len(greedy)} "
          "(bf16: a window's products round apart from one token's)")
    print("  serve_summary " + json.dumps(snap))
    spec_pass_split(eng, prompts, phase4["sampling"], smi)
    del eng, model
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 52)
    cursors = [len(p) + NEW - 1 for p in prompts]
    case = DB.paged_case(gen, cursors, s_q=k + 1)
    err = check(f"paged kernel at the verify shape [{case['shape']}]",
                case["kernel"](), case["plain"](), elem=True,
                share_bar=DB.SHARE_BAR)
    ms = DB.device_ms(case["kernel"], flush)
    plain = DB.device_ms(case["plain"], flush)
    lib = DB.device_ms(case["library"], flush)
    print(f"    kernel {ms * 1e3:.2f} us, bound {case['bound_ms'] * 1e3:.3f} us "
          f"({case['bound_by']}), plain {plain * 1e3:.1f} us, library "
          f"{lib * 1e3:.2f} us (SDPA, gathered windows, causal within the "
          f"window), max_abs_err {err:.3e}  [{smi}]")
    if FAILURES:
        fail(f"verify-shape parity: {FAILURES}")
    del flush
    print(f"  phase 52: {time.perf_counter() - t0:.1f} s")


def spec_pass_split(eng, prompts, sampling, smi: str) -> None:
    """Where a speculative pass's time goes (phase 52). The engine serves
    the prompts again with each part of its pass run between two
    synchronisations (wall time, inclusive: the K/V writes lie inside the
    forwards; "other" is the pass less its four parts), then once more
    with its third pass, unsynchronised, under ``torch.profiler``: the
    pass's wall time beside the card's busy time and its kernel count,
    and the host ops that take the most time."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpudist_torch.models import gpt2 as G
    from tpudist_torch.serve import engine as E
    from tpudist_torch.serve import spec as S

    wall, calls, stack = collections.Counter(), collections.Counter(), []

    def timed(name, fn, outer_only=False):
        def call(*a, **kw):
            if not stack and not outer_only:
                return fn(*a, **kw)
            label = name.format(outer=stack[-1] if stack else "")
            torch.cuda.synchronize()
            t = time.perf_counter()
            stack.append(label)
            try:
                out = fn(*a, **kw)
                torch.cuda.synchronize()
            finally:
                stack.pop()
            wall[label] += time.perf_counter() - t
            calls[label] += 1
            return out
        return call

    originals = (G.cached_kv, E.sample_logits_per_row, S.speculative_accept)
    eng._spec_pass = timed("pass", eng._spec_pass, outer_only=True)
    eng.draft.forward = timed("draft forward", eng.draft.forward)
    eng.model.forward = timed("verify forward", eng.model.forward)
    G.cached_kv = timed("{outer} K/V writes", G.cached_kv)
    E.sample_logits_per_row = timed("draft sampling", E.sample_logits_per_row)
    S.speculative_accept = timed("acceptance", S.speculative_accept)
    try:
        for p, opts in zip(prompts, sampling):
            eng.submit(p, NEW, **opts)
        eng.run()
    finally:
        G.cached_kv, E.sample_logits_per_row, S.speculative_accept = originals
        del eng._spec_pass, eng.draft.forward, eng.model.forward
    n = calls["pass"]
    parts = ("draft forward", "draft sampling", "verify forward",
             "acceptance")
    wall["other"] = wall["pass"] - sum(wall[x] for x in parts)
    print(f"  one speculative pass, parts synchronised ({n} passes): "
          f"{wall['pass'] / n * 1e3:.3f} ms  [{smi}]")
    for name in (*parts, "draft forward K/V writes",
                 "verify forward K/V writes", "other"):
        print(f"    {name}: {wall[name] / n * 1e3:.3f} ms a pass "
              f"({calls[name] / n:g} calls), "
              f"{100 * wall[name] / wall['pass']:.1f}%")
    if n == 0 or min(wall[x] for x in parts) <= 0:
        fail(f"the pass split timed nothing: {dict(wall)}")

    seen = [0]
    plain_pass = eng._spec_pass

    def profiled(*a, **kw):
        seen[0] += 1
        if seen[0] != 3:
            return plain_pass(*a, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            out = plain_pass(*a, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
        prof_out.update(prof=prof, ms=ms)
        return out

    prof_out: dict = {}
    eng._spec_pass = profiled
    try:
        for p, opts in zip(prompts, sampling):
            eng.submit(p, NEW, **opts)
        eng.run()
    finally:
        del eng._spec_pass
    if not prof_out:
        fail("the profiled speculative pass never ran")
    prof = prof_out["prof"]
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "pass.json"
        prof.export_chrome_trace(str(trace))
        tb = trace_breakdown(trace)
    host = sorted((e for e in prof.key_averages()
                   if e.key.startswith("aten::")),
                  key=lambda e: -e.self_cpu_time_total)[:6]
    busy = tb["device_ms_per_step"]
    print(f"    profiled pass: wall {prof_out['ms']:.3f} ms (profiler on), "
          f"card busy {busy:.3f} ms "
          f"({100 * busy / prof_out['ms']:.1f}%), "
          f"{tb['kernels_per_step']:g} kernels  [{smi}]")
    print("    host ops by self time: " + "; ".join(
        f"{e.key} x{e.count} {e.self_cpu_time_total / 1e3:.3f} ms"
        for e in host))
    print("    kernels by time: " + "; ".join(
        f"{k[:48]} x{c:g} {m:.3f} ms" for k, m, c in tb["top"][:5]))


def spec_agreement_phase(dev) -> None:
    """Phase 53 (module docstring)."""
    import torch

    from tpudist_torch.models.gpt2 import GPT2
    from tpudist_torch.models.llama import llama_125m
    from tpudist_torch.ops import decode_bench as DB
    from tpudist_torch.serve import ServeEngine, early_exit_draft

    t0 = time.perf_counter()
    print("== 53. f32: the speculative engine against the plain engine, paged,"
          " greedy")
    prompts = DB.smoke_prompts(SEED)
    for name, build, depth, stop in (
            ("GPT-2 124M", lambda: GPT2(attn_impl="fused", device="cuda",
                                        seed=SEED), 4, False),
            ("llama_125m at depth 4", lambda: llama_125m(
                vocab_size=32000, depth=4, attn_impl="fused", device="cuda",
                seed=SEED), 2, True)):
        model = build()
        toks = [p % model.vocab_size for p in prompts]

        def serve(eos=None, **kw):
            eng = ServeEngine(model, max_slots=8, paged=True, block_size=32,
                              seed=SEED, **kw)
            ids = [eng.submit(p, NEW, eos_id=eos) for p in toks]
            res = eng.run()
            return [res[i] for i in ids], eng

        eos = serve()[0][0][NEW // 2] if stop else None
        plain, _ = serve(eos)
        spec, eng = serve(eos, draft_model=early_exit_draft(model, depth),
                          spec_k=4)
        snap = eng.stats.snapshot()
        gap = top2_gap(model, toks, plain)
        cut = sum(len(s) < NEW for s in plain)
        print(f"  {name}: streams identical {spec == plain}"
              f"{f', stop token {eos} cuts {cut} of 8 streams' if stop else ''}"
              f"; acceptance rate {snap['spec_acceptance_rate']}; smallest "
              f"top-2 logit gap along the streams {gap:.3e}")
        if spec != plain:
            fail(f"{name}: f32 speculative and plain greedy streams differ")
        if stop and not cut:
            fail(f"{name}: the stop token cut no stream")
        del model, eng
    print(f"  phase 53: {time.perf_counter() - t0:.1f} s")


def serve_cli_phase(smi: str, dev) -> None:
    """Phase 54 (module docstring)."""
    import torch

    from tpudist_torch.models.gpt2 import GPT2
    from tpudist_torch.serve import ServeEngine, early_exit_draft

    t0 = time.perf_counter()
    print("== 54. the serving CLIs with a draft")
    fields = {"spec_drafted", "spec_accepted", "spec_acceptance_rate"}
    env = {**os.environ, "PYTHONPATH": str(HERE)}
    with tempfile.TemporaryDirectory() as tmp:
        # the two CLIs check exits and rows: they run together
        runs = [(job, argv, time.perf_counter(), subprocess.Popen(
            [sys.executable, "-m", *argv, "--log_dir", tmp, "--JobID", job],
            cwd=HERE, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)) for job, argv in (
                ("Serve", ["tpudist_torch.serve", "--full", "--bf16", "--paged",
                           "--spec_draft", "4", "--spec_k", "4"]),
                ("Demo", ["tpudist_torch.main", "--serve", "--spec_draft",
                          "1"]))]
        for job, argv, t1, proc in runs:
            out, err = proc.communicate(timeout=300)
            proc = subprocess.CompletedProcess(proc.args, proc.returncode,
                                               out, err)
            lines = proc.stdout.splitlines()
            if proc.returncode:
                print("\n".join(lines[-20:]) + proc.stderr[-3000:])
                fail(f"python -m {' '.join(argv)} exited {proc.returncode}")
            rows = [json.loads(r) for r in
                    open(Path(tmp) / f"{job}_serve_0.jsonl")]
            serve = [r for r in rows if r["kind"] in ("serve", "serve_summary")]
            if not serve or not all(fields <= set(r) for r in serve):
                fail(f"{argv[0]}: serve rows without the speculative fields")
            said = [x for x in lines if x.startswith(("served", "speculative"))]
            print(f"  python -m {' '.join(argv)} (beside the other): exit 0 "
                  f"in {time.perf_counter() - t1:.1f} s; {len(serve)} serve rows "
                  f"with the spec fields; " + "; ".join(said) + f"  [{smi}]")
    model = GPT2(vocab_size=256, max_seq_len=256, hidden_dim=128, depth=2,
                 num_heads=4, attn_impl="fused", device="cuda")
    try:
        ServeEngine(model, paged=True, block_size=32, spec_k=16,
                    draft_model=early_exit_draft(model, 1))
    except ValueError as e:
        print(f"  paged engine with spec_k 16: ValueError ({e})")
    else:
        fail("a paged engine with spec_k 16 did not raise")
    print(f"  phase 54: {time.perf_counter() - t0:.1f} s")


def data_parallel_phases(smi: str, dev) -> None:
    """Phases 55-58 (module docstring)."""
    ring_phase(smi, dev)
    zero1_phase(smi, dev)
    fsdp_phase(smi, dev)
    dp_cli_phase(smi)


def ring_phase(smi: str, dev, n: int = 4, model=None) -> None:
    """Phase 55 (module docstring); ``model`` replaces GPT-2 124M (a CPU
    rehearsal passes a narrow one)."""
    import torch

    from tpudist_torch import allreduce as comm
    from tpudist_torch.models.gpt2 import GPT2
    from tpudist_torch.ops import decode_bench as DB
    from tpudist_torch.rng import fold_in

    t0 = time.perf_counter()
    print(f"== 55. the quantized ring, loopback n = {n}, GPT-2 124M's "
          "gradient buckets")
    params = dict((model or GPT2(device="meta")).named_parameters())
    layout = comm.BucketLayout(params, n)
    gen = torch.Generator(device=dev).manual_seed(SEED + 55)
    x = torch.empty((n, layout.n_buckets, layout.bucket_size), device=dev)
    for r in range(n):
        grads = {k: torch.randn(p.shape, generator=gen, device=dev) * 1e-3
                 for k, p in params.items()}
        x[r] = layout.flatten(grads)
        del grads
    chunks = x.view(n, n, layout.buckets_per_chunk, layout.bucket_size)
    ring = comm.LoopbackRing(n)
    keys = [fold_in(SEED, 0, r, 0, 1) for r in range(n)]
    out = comm.ring_allreduce_quantized(chunks, ring, keys)
    same = all(bool(torch.equal(out[r], out[0])) for r in range(1, n))
    exact = x.double().sum(0).float().view_as(out[0])
    err = float((out[0] - exact).abs().max())
    bound = n * float(sum(x[r].abs().max() for r in range(n))) / 127
    ratio = layout.wire_bytes("bucketed") / layout.wire_bytes("quantized")
    print(f"  {layout.total} elements in {layout.n_buckets} buckets of "
          f"{layout.bucket_size} ({layout.buckets_per_chunk} a chunk); every "
          f"rank's sum bit-identical: {same}; max_abs_err against the exact "
          f"f32 sum {err:.3e} [bound w A / 127 = {bound:.3e}]; wire bytes a "
          f"step {layout.wire_bytes('quantized')} int8 vs "
          f"{layout.wire_bytes('bucketed')} f32 ({ratio:.2f}x)")
    if not same or err > bound or ratio < 3:
        fail(f"the quantized ring: identical {same}, err {err} (bound "
             f"{bound}), compression {ratio:.2f}x")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    ms = DB.device_ms(lambda: comm.ring_allreduce_quantized(chunks, ring, keys),
                      flush, n=10) / n
    elems = layout.padded_total
    b = DB.bound(8 * elems, 0)
    print(f"  one reduction per rank {ms:.3f} ms (the loopback's {n} ranks "
          f"/ {n}), bound {b['bound_ms']:.3f} ms ({b['bound_by']}: one read "
          f"of the rank's {elems} f32 elements and one write of the sum)  "
          f"[{smi}]")
    del x, chunks, out, exact, flush
    print(f"  phase 55: {time.perf_counter() - t0:.1f} s")


def zero1_phase(smi: str, dev, n: int = 4, lists=None) -> None:
    """Phase 56 (module docstring); ``lists`` replaces ResNet-50's and
    GPT-2 124M's leaves (a CPU rehearsal passes small ones)."""
    import torch

    from tpudist_torch import optim as O
    from tpudist_torch.amp import skip_nonfinite
    from tpudist_torch.ops import decode_bench as DB
    from tpudist_torch.ops import fused_update as FU
    from tpudist_torch.ops import fused_update_bench as FB

    t0 = time.perf_counter()
    print(f"== 56. ZeRO-1 through the fused AdamW kernel, loopback n = {n}: "
          "bf16 grads and copy, wd 0.1")
    gd = torch.Generator(device=dev).manual_seed(SEED + 56)
    bf16 = torch.bfloat16
    lists = lists or (("ResNet-50", FB.resnet50_leaves), ("GPT-2 124M",
                                                         FB.gpt2_leaves))
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def make():
        return O.fused_adamw(1e-3, weight_decay=0.1, mask=O.decay_mask,
                             compute_dtype=bf16)

    for label, leaves_fn in lists:
        # no dim of either extra leaf divides by 4: they pad (neither
        # model has such a leaf of 1024 elements or more)
        leaves = leaves_fn() + [torch.empty(37, 111, device=dev),
                                torch.empty(1027, device=dev)]
        names = [str(i) for i in range(len(leaves))]
        base = {}
        for k, p in zip(names, leaves):
            base[k] = torch.empty_like(p, dtype=torch.float32)
            base[k].copy_(torch.randn(p.shape, generator=gd, device=dev))
        # in each master's layout (channels-last conv weights), as
        # autograd gives them
        grads = {k: torch.empty_like(p, dtype=bf16).copy_(
            torch.randn(p.shape, generator=gd, device=dev) * 0.1)
            for k, p in base.items()}
        del leaves
        rep_params = {k: v.clone() for k, v in base.items()}
        rep_tx = make()
        rep = rep_tx.init(rep_params)
        FU.reset_launch_counts()
        rep_tx.step(rep, rep_params, grads)
        rep_launches = FU.launch_counts["fused_adamw"]
        ranks = []
        for r in range(n):
            z = O.ShardedStateOptimizer(make(), world=n, rank=r)
            st = z.init({k: v.clone() for k, v in base.items()})
            FU.reset_launch_counts()
            z.update(st, grads)
            ranks.append((z, st, FU.launch_counts["fused_adamw"],
                          FU.launch_counts["fused_adamw_leaves"]))
        modes = {m for m, _ in ranks[0][1].modes.values()}
        equal = True
        for k in names:
            mode, info = ranks[0][1].modes[k]
            for field in ("mu", "nu", "master"):
                want = getattr(rep, field)[k]
                parts = [getattr(st.inner, field)[k] for _, st, _, _ in ranks]
                got = parts[0] if mode == "replicate" else O._assemble(
                    parts, mode, info, want.shape)
                equal &= bool(torch.equal(got, want))
            parts = [st.slices[k] for _, st, _, _ in ranks]
            got = parts[0] if mode == "replicate" else O._assemble(
                parts, mode, info, rep_params[k].shape)
            equal &= bool(torch.equal(got, rep_params[k]))
        per_rank = [c for _, _, c, _ in ranks]
        covered = [c for _, _, _, c in ranks]
        count = {m: sum(1 for mm, _ in ranks[0][1].modes.values() if mm == m)
                 for m in ("shard", "pad", "replicate")}
        print(f"  {label} ({len(names)} leaves: {count}): launches per rank "
              f"{per_rank} covering {covered} slices; replicated step "
              f"{rep_launches} launch; m', v', masters and copy of the {n} "
              f"ranks put together bit-equal to it: {equal}")
        if (not equal or per_rank != [1] * n or rep_launches != 1
                or modes != {"shard", "pad", "replicate"}):
            fail(f"ZeRO-1 over {label}: equal {equal}, launches {per_rank}, "
                 f"modes {modes}")
        # the --amp guard (ZeRO-1 outermost): one check launch a rank over
        # its slices; a finite step writes what the unguarded one wrote,
        # and a NaN in the last rank's slice of the last (pad) leaf sets
        # that rank's flag alone and it writes nothing (a world sums the
        # flags over its data group; the loopback has none)
        poisoned = dict(grads)
        poisoned[names[-1]] = grads[names[-1]].clone()
        poisoned[names[-1]].view(-1)[-1] = float("nan")
        checks, flags, guarded, kept = [], [], True, True
        for r in range(n):
            for gr in (grads, poisoned):
                zg = O.ShardedStateOptimizer(skip_nonfinite(make()), world=n,
                                             rank=r)
                sg = zg.init({k: v.clone() for k, v in base.items()})
                FU.reset_launch_counts()
                zg.update(sg, gr)
                inner = sg.inner.inner
                if gr is grads:
                    checks.append(FU.launch_counts["fused_adamw_check"])
                    guarded &= all(torch.equal(
                        inner.master[k], ranks[r][1].inner.master[k])
                        for k in names)
                    continue
                flags.append(int(inner.nonfinite))
                kept &= all(torch.equal(inner.master[k], base[k] if
                                        sg.modes[k][0] == "replicate" else
                                        O._slice_of(base[k], *sg.modes[k],
                                                    n, r))
                            for k in names) or not flags[-1]
                del zg, sg, inner
        print(f"  {label} under the --amp guard: check launches per rank "
              f"{checks}; finite step bit-equal to the unguarded: "
              f"{guarded}; a NaN in rank {n - 1}'s slice: flags {flags}, "
              f"the flagged rank wrote nothing: {kept}")
        if (checks != [1] * n or not guarded or not kept
                or flags != [0] * (n - 1) + [1]):
            fail(f"ZeRO-1 under the guard over {label}: checks {checks}, "
                 f"equal {guarded}, flags {flags}, kept {kept}")
        del poisoned
        # the kernel alone over rank 0's slices, then over every leaf
        z, st, _, _ = ranks[0]
        gsl = [grads[k] if st.modes[k][0] == "replicate" else
               O._slice_of(grads[k], *st.modes[k], n, 0)
               for k in st.inner.names]
        sc = st.inner, rep
        lr, b1c, b2c = z.inner.scalars(1)
        rank_ms = DB.device_ms(lambda: FU.fused_adamw_step(
            sc[0].table, gsl, lr, b1c, b2c, **FB.HP), flush, n=20)
        glist = [grads[k] for k in rep.names]
        rep_ms = DB.device_ms(lambda: FU.fused_adamw_step(
            sc[1].table, glist, lr, b1c, b2c, **FB.HP), flush, n=20)
        per_elem, ops = 12 + 12 + 2 + 2, 16
        n_rank = sum(t.numel() for t in gsl)
        n_all = sum(t.numel() for t in glist)
        rb = DB.bound(n_rank * per_elem, n_rank * ops)
        ab = DB.bound(n_all * per_elem, n_all * ops)
        print(f"    rank 0's launch over {n_rank} elements {rank_ms:.4f} ms "
              f"(bound {rb['bound_ms']:.4f} ms, {rb['bound_by']}); the "
              f"replicated launch over {n_all} {rep_ms:.4f} ms (phase 8's "
              f"bound {ab['bound_ms']:.4f} ms)  [{smi}]")
        del ranks, rep, rep_params, base, grads, gsl, glist, sc, z, st
    del flush
    print(f"  phase 56: {time.perf_counter() - t0:.1f} s")


def fsdp_phase(smi: str, dev, *, batch: int = 8, seq: int = 1024,
               geom=None) -> None:
    """Phase 57 (module docstring); ``geom`` narrows GPT-2 (a CPU
    rehearsal)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from tpudist_torch.data.lm import TokenWindowLoader
    from tpudist_torch.mesh import RankLayout
    from tpudist_torch.models.gpt2 import GPT2
    from tpudist_torch.ops import lm_kernels_bench as LB
    from tpudist_torch.optim import make_optimizer, run_schedule
    from tpudist_torch.parallel.plan import ParallelPlan
    from tpudist_torch.train import fit, lm_loss

    t0 = time.perf_counter()
    print("== 57. FSDP on the card: GPT-2 124M, bf16, S 1024, 8 steps "
          "wrapped by FSDP2 over a 1-rank NCCL fsdp group, --fused all "
          "--attn vmem")
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                      RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method="env://")
    geom = geom or {}
    results = {}
    try:
        layout = RankLayout(0, 1, 1, fsdp=1, fsdp_group=dist.group.WORLD,
                            device_mesh=DeviceMesh.from_group(
                                dist.group.WORLD, dev.type,
                                mesh_dim_names=("fsdp",)))
        with tempfile.TemporaryDirectory() as log_dir:
            tokens = LB.token_file(Path(log_dir) / "text.bin",
                                   8 * batch * seq)

            def run(dtype, wrap, steps, job):
                model = GPT2(dtype=dtype, attn_impl="vmem", device=dev,
                             seed=SEED, max_seq_len=seq, **geom)
                tx = make_optimizer(
                    run_schedule(3e-4, total_steps=steps, warmup_steps=100),
                    weight_decay=0.1, clip_norm=1.0, fused=True,
                    compute_dtype=dtype if dtype != torch.float32 else None)
                loader = TokenWindowLoader(str(tokens), batch, seq,
                                           shuffle=False)
                loader = _Head(loader, steps)
                plan = ParallelPlan(layout) if wrap else None
                for mod in counted_modules():
                    mod.reset_launch_counts()
                sync()
                t1 = time.perf_counter()
                with contextlib.redirect_stdout(io.StringIO()):
                    state, losses = fit(
                        model, tx, loader, epochs=1, fused="all", plan=plan,
                        loss_fn=lm_loss, input_key="tokens",
                        label_key="tokens", profile=False, log_dir=log_dir,
                        job_id=job)
                sync()
                wall = time.perf_counter() - t1
                return state, losses, launches(), wall

            state, losses, counts, wall = run(torch.bfloat16, True, 8, "Fsdp")
            sharded = sum(1 for p in state.model.parameters()
                          if hasattr(p, "to_local"))
            n_leaves = len(list(state.model.parameters()))
            depth = state.model.depth
            rows = [r for r in (Path(log_dir) / f"Fsdp_{batch}_0.log")
                    .read_text().splitlines() if not r.startswith("HBM\t")]
            del state
            eps5 = float(rows[1].split("\t")[4])
            step_ms = batch / eps5 * 1e3
            print(f"  8 steps; {n_leaves} leaves, {sharded} sharded by FSDP2 "
                  f"(the rest below 1024 elements, replicated); losses {losses[0]:.4f} -> {losses[-1]:.4f}; "
                  f"launches {counts}")
            check_counts("FSDP", counts, {
                "layernorm_fwd": 2 * depth + 1,
                "layernorm_bwd": 2 * depth + 1,
                "layernorm_bwd_reduce": 2 * depth + 1,
                "vmem_attention_fwd": depth, "vmem_attention_bwd": depth,
                # a launch for each mix: FSDP's shards (float32 gradients,
                # no copy) and the replicated leaves (bf16, their copy)
                "fused_adamw": 2, "fused_adamw_leaves": n_leaves}, 8)
            if not np.isfinite(losses).all():
                fail(f"FSDP losses {losses}")
            print(f"  step at g_step 5 {step_ms:.2f} ms ({wall:.1f} s wall "
                  f"for the 8 steps, bring-up included); the "
                  f"unwrapped DDP runs: phase 14 {STEP_MS.get('Smoke', 0):.2f}"
                  f" ms, phase 28 (--amp --dropout 0.1 --remat full) "
                  f"{STEP_MS.get('Remat', 0):.2f} ms  [{smi}]")
            for wrap in (True, False):
                st, ls, _, _ = run(torch.float32, wrap, 4, f"F32w{int(wrap)}")
                results[wrap] = (ls, {k: v.float().cpu()
                                      for k, v in st.params().items()})
                del st
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    (lf, pf), (ln, pn) = results[True], results[False]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lf, ln))
    gap = max(float((pf[k] - pn[k]).abs().max()) for k in pn)
    print(f"  f32, 4 steps: FSDP-wrapped losses {lf} vs unwrapped {ln}: max "
          f"rel {loss_rel:.3e} [bar {LOSS_BAR:g}]; params max abs {gap:.3e} "
          f"[bar {PARAM_BAR:g}]")
    if len(lf) != 4 or loss_rel > LOSS_BAR or gap > PARAM_BAR:
        fail("FSDP-wrapped and unwrapped f32 GPT-2 training disagree")
    print(f"  phase 57: {time.perf_counter() - t0:.1f} s")


class _Head:
    """The first ``n`` batches of ``loader`` (a sized loader's prefix)."""

    def __init__(self, loader, n: int):
        self.loader, self.n = loader, n
        self.batch_size = loader.batch_size

    def __len__(self):
        return self.n

    def __iter__(self):
        return (b for _, b in zip(range(self.n), self.loader))


def sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def dp_cli_phase(smi: str) -> None:
    """Phase 58 (module docstring)."""
    import importlib.util

    from tpudist_torch.mesh import RankLayout
    from tpudist_torch.parallel.dp import resolve_method

    t0 = time.perf_counter()
    print("== 58. the data-parallel CLIs at one rank")
    print(f"  a 1-rank world's reducer: --reduce quantized resolves "
          f"{resolve_method('quantized', RankLayout(0, 1, 1))!r}")
    env = {**os.environ, "PYTHONPATH": str(HERE)}
    sklearn = importlib.util.find_spec("sklearn") is not None
    with tempfile.TemporaryDirectory() as tmp:
        # the three CLIs check exits: they run together, each in its own
        # log directory
        runs = []
        for i, (argv, want_ok) in enumerate((
                (["tpudist_torch.main", "--reduce", "quantized", "--dataset",
                  "synthetic", "--synthetic_size", "1024", "--bf16",
                  "--fused", "optimizer"], True),
                (["tpudist_torch.train_gpt2", "--shard_opt_state", "--amp",
                  "--fused", "all", "--synthetic_tokens", str(8 * 8 * 1024)],
                 True),
                (["tpudist_torch.main", "--dataset", "digits", "--model",
                  "resnet18"], sklearn))):
            log_dir = Path(tmp) / str(i)
            log_dir.mkdir()
            runs.append((argv, want_ok, time.perf_counter(), subprocess.Popen(
                [sys.executable, "-m", *argv, "--epochs", "1",
                 "--no_profiler", "--log_dir", str(log_dir)], cwd=HERE,
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        for argv, want_ok, t1, proc in runs:
            out, err = proc.communicate(timeout=600)
            proc = subprocess.CompletedProcess(proc.args, proc.returncode,
                                               out, err)
            said = " ".join(argv)
            if want_ok:
                if proc.returncode:
                    print(proc.stdout[-3000:] + proc.stderr[-3000:])
                    fail(f"python -m {said} exited {proc.returncode}")
                tail = [x for x in proc.stdout.splitlines()
                        if x.startswith(("Epoch: ", "tokens/sec"))][-1:]
                print(f"  python -m {said}: exit 0 in "
                      f"{time.perf_counter() - t1:.1f} s; {' '.join(tail)}  "
                      f"[{smi}]")
            else:
                last = (proc.stderr.strip().splitlines() or [""])[-1]
                if (proc.returncode == 0 or "ImportError" not in last
                        or "scikit-learn" not in last):
                    print(proc.stdout[-2000:] + proc.stderr[-3000:])
                    fail(f"python -m {said} without scikit-learn: exit "
                         f"{proc.returncode}, last line {last!r}")
                print(f"  python -m {said}: exit {proc.returncode}, {last}")
    print(f"  phase 58: {time.perf_counter() - t0:.1f} s")


#: phase 59's geometries: (name, query heads, K/V heads, head dim, the
#: tensor worlds it is split over)
TP_SHAPES = (("GPT-2 124M", 12, 12, 64, (2, 4)),
             ("Llama-3-8B width", 32, 8, 128, (4,)))
#: phase 59's sequence lengths: the decode cache and vmem's, flash's
TP_SEQ = (1024, 4096)
TENSOR_CHILD = "--tensor_child"


def tensor_phases(smi: str, dev) -> None:
    """Phases 59-69 (module docstring)."""
    tensor_shard_phase(smi, dev)
    encoder_shard_phase(smi, dev)
    cp_tensor_shard_phase(smi, dev)
    with tempfile.TemporaryDirectory() as tmp, \
            tempfile.TemporaryDirectory() as rtmp, \
            tempfile.TemporaryDirectory() as ctmp:
        # phases 31-32's launched runs and the four-rank world check only
        # bits and launches: they run beside the two-rank world, whose
        # timings are checks too
        runs = start_recovery(Path(rtmp))
        composed = start_composed_world(Path(ctmp))
        try:
            t0 = time.perf_counter()
            ranks = tensor_world(Path(tmp))
            world_s = time.perf_counter() - t0
            recovery_phases(smi, Path(rtmp), runs)
            cranks = finish_world(composed, Path(ctmp), "composed world")
            composed_s = time.perf_counter() - t0
        finally:
            stop_launches(runs)
            for p in composed:
                if p.poll() is None:
                    p.kill()
        print(f"  phases 31-32, the two-rank and the four-rank world: "
              f"{time.perf_counter() - t0:.1f} s together")
        tensor_serving_phase(smi, Path(tmp), ranks)
        tensor_training_phase(smi, Path(tmp), ranks)
        tensor_bert_phase(smi, Path(tmp), ranks)
        tensor_vit_phase(smi, Path(tmp), ranks)
        tensor_t5_phase(smi, Path(tmp), ranks)
        composed_phases(smi, Path(ctmp), cranks)
    print(f"  phases 60-61 and 63-65: the two-rank world {world_s:.1f} s (its "
          "start, its runs and their writes) before the phases' checks; "
          f"phases 67-69: the four-rank world done {composed_s:.1f} s after "
          "the two-rank world's start")


def _shard_cases(dev, h: int, hkv: int, dh: int, seq=TP_SEQ):
    """Phase 59's kernels as ``(name, prep, run, slicer)``: ``prep(hs,
    ks)`` gives the kernel's inputs on query heads ``hs`` and K/V heads
    ``ks`` (slices; the whole call takes every head) as a rank holds them
    (the decode caches' head slices contiguous, as a rank's pool is),
    ``run(*inputs)`` launches it, ``slicer(outputs, hs, ks)`` cuts the
    whole call's outputs to those heads. Inputs are random bf16 from a
    seeded generator."""
    import torch

    from tpudist_torch.ops import decode as D
    from tpudist_torch.ops import flash_attention as FA
    from tpudist_torch.ops import vmem_attention as VA
    from tpudist_torch.ops.decode_bench import smoke_prompts

    gen = torch.Generator(device="cpu").manual_seed(SEED + 59)
    rnd = lambda *shape: torch.randn(*shape, generator=gen).to(
        dev, torch.bfloat16)
    s_dec, s_flash = seq
    b, bs = 8, 32
    # contiguous: B 8 at cursor s - 1
    qc, kc, vc = rnd(b, 1, h, dh), rnd(b, hkv, s_dec, dh), rnd(b, hkv, s_dec, dh)
    # paged: phase 4's prompt lengths as cursors, a pool of B x S slots
    mb = s_dec // bs
    n_pool = b * mb + 1
    qp = rnd(b, 1, h, dh)
    kp, vp = rnd(n_pool, hkv, bs, dh), rnd(n_pool, hkv, bs, dh)
    tables = (torch.randperm(n_pool - 1, generator=gen)[: b * mb] + 1) \
        .reshape(b, mb).to(dev, torch.int32)
    cursors = [min(len(p) + NEW - 1, s_dec - 1) for p in smoke_prompts(SEED)]
    pos = torch.tensor(cursors, dtype=torch.int32, device=dev)
    # vmem: B 8, S 1024, causal, grouped K/V in place
    qv, kv_, vv = (rnd(b, s_dec, h, dh), rnd(b, s_dec, hkv, dh),
                   rnd(b, s_dec, hkv, dh))
    dov = rnd(b, s_dec, h, dh)
    # flash: S 4096, K/V repeated to the query heads (flash_attention's rule)
    bf = 4 if h * dh <= 768 else 1
    qf, kf, vf, dof = (rnd(bf, s_flash, h, dh), rnd(bf, s_flash, h, dh),
                       rnd(bf, s_flash, h, dh), rnd(bf, s_flash, h, dh))
    scale = VA._scale(dh)
    kw_v = dict(causal=True, kv_len=s_dec, scale=scale)
    kw_f = dict(causal=True, kv_len=s_flash, scale=scale)
    ov, lsev = VA.vmem_fwd_cuda(qv, kv_, vv, **kw_v)
    of, lsef = FA.flash_fwd_cuda(qf, kf, vf, **kw_f)
    every = (slice(None), slice(None))
    return [
        ("fused_decode_attention",
         lambda hs, ks: (qc[:, :, hs].contiguous(), kc[:, ks].contiguous(),
                         vc[:, ks].contiguous(), s_dec - 1),
         lambda *a: (D.fused_decode_attention_cuda(*a),),
         lambda out, hs, ks: (out[0][:, :, hs],)),
        ("paged_decode_attention",
         lambda hs, ks: (qp[:, :, hs].contiguous(), kp[:, ks].contiguous(),
                         vp[:, ks].contiguous(), tables, pos),
         lambda *a: (D.paged_fused_attention_cuda(*a),),
         lambda out, hs, ks: (out[0][:, :, hs],)),
        ("vmem_attention_fwd",
         lambda hs, ks: (qv[:, :, hs], kv_[:, :, ks], vv[:, :, ks]),
         lambda *a: VA.vmem_fwd_cuda(*a, **kw_v),
         lambda out, hs, ks: (out[0][:, :, hs], out[1][:, hs])),
        ("vmem_attention_bwd",
         lambda hs, ks: (qv[:, :, hs], kv_[:, :, ks], vv[:, :, ks],
                         ov[:, :, hs], dov[:, :, hs],
                         lsev[:, hs].contiguous()),
         lambda *a: VA.vmem_bwd_cuda(*a, **kw_v),
         lambda out, hs, ks: (out[0][:, :, hs], out[1][:, :, ks],
                              out[2][:, :, ks])),
        ("flash_attention_fwd",
         lambda hs, ks: (qf[:, :, hs], kf[:, :, hs], vf[:, :, hs]),
         lambda *a: FA.flash_fwd_cuda(*a, **kw_f),
         lambda out, hs, ks: (out[0][:, :, hs], out[1][:, hs])),
        ("flash_attention_bwd",
         lambda hs, ks: (qf[:, :, hs], kf[:, :, hs], vf[:, :, hs],
                         of[:, :, hs], dof[:, :, hs],
                         lsef[:, hs].contiguous()),
         lambda *a: FA.flash_bwd_cuda(*a, **kw_f),
         lambda out, hs, ks: (out[0][:, :, hs], out[1][:, :, hs],
                              out[2][:, :, hs])),
    ], every


def tensor_shard_phase(smi: str, dev, shapes=TP_SHAPES, seq=TP_SEQ) -> None:
    """Phase 59 (module docstring); ``shapes`` and ``seq`` narrow it (a
    rehearsal)."""
    import torch

    t0 = time.perf_counter()
    print("== 59. tensor-parallel shard parity: each rank's heads through "
          "the kernels, against the same heads of the call over all of them "
          "(bf16)")
    for name, h, hkv, dh, worlds in shapes:
        cases, every = _shard_cases(dev, h, hkv, dh, seq)
        shard_parity(smi, name, cases, every, h, hkv, worlds)
        del cases
        torch.cuda.empty_cache()
    if FAILURES:
        fail(f"shard parity: {FAILURES}")
    print(f"  phase 59: {time.perf_counter() - t0:.1f} s")


def shard_parity(smi: str, name: str, cases, every, h: int, hkv: int,
                 worlds) -> None:
    """Phases 59 and 62: each of ``cases`` (:func:`_shard_cases`) on every
    rank's head slice at each tensor world against the same heads of the
    call over all of them (the attention kernels bit for bit, the decode
    kernels under phase 2's bars), each rank's and the whole call's
    CUDA-event ms."""
    import torch

    from tpudist_torch.ops import decode_bench as DB

    decode = ("fused_decode_attention", "paged_decode_attention")
    for kname, prep, run, slicer in cases:
        args = prep(*every)
        whole = run(*args)
        whole_ms = event_ms(lambda: run(*args), reps=25)
        for t in worlds:
            same, times = [], []
            for r in range(t):
                hs = slice(r * h // t, (r + 1) * h // t)
                # flash takes its K/V repeated: a rank's are its heads'
                ks = (hs if kname.startswith("flash")
                      else slice(r * hkv // t, (r + 1) * hkv // t))
                shard = prep(hs, ks)
                got = run(*shard)
                want = slicer(whole, hs, ks)
                same.append(all(torch.equal(a, w)
                                for a, w in zip(got, want)))
                if kname in decode:
                    check(f"{name} T {t} rank {r} {kname}", got[0],
                          want[0].contiguous(), elem=True,
                          share_bar=DB.SHARE_BAR)
                times.append(event_ms(lambda: run(*shard), reps=25))
            print(f"  {name} T {t} {kname} ({h // t} / "
                  f"{(h if kname.startswith('flash') else hkv) // t} "
                  f"heads a rank): bit-identical {same}; ms a rank "
                  f"{[round(x, 4) for x in times]}, all heads "
                  f"{whole_ms:.4f} (25-call CUDA-event medians)  [{smi}]")
            if kname not in decode and not all(same):
                fail(f"{name} T {t} {kname}: a shard differs from its "
                     "heads of the whole call")


def _tp_legs(tmp: Path) -> list[dict]:
    """Phases 60-61's runs in the two-rank world, in order: ``cli`` (a
    module of tpudist_torch), ``argv``, and for training whether to
    gather the parameters."""
    text = str(tmp / "text.bin")
    serve = ["--full", "--paged", "--requests", "8", "--max_new", str(NEW),
             "--log_dir", str(tmp)]
    train = ["--batch_size", "8", "--seq_len", "1024", "--tokens", text,
             "--no_profiler", "--log_dir", str(tmp), "--warmup_steps", "2",
             "--total_steps", "4", "--fused", "all"]
    return [
        dict(name="serve_bf16", cli="serve", argv=[*serve, "--bf16"]),
        dict(name="serve_spec", cli="serve",
             argv=[*serve, "--bf16", "--spec_draft", "4", "--spec_k", "4"]),
        dict(name="serve_f32", cli="serve", argv=serve),
        dict(name="demo", cli="main",
             argv=["--serve", "--log_dir", str(tmp)]),
        dict(name="train_bf16", cli="train_gpt2",
             argv=[*train, "--bf16", "--attn", "auto", "--generate",
                   str(NEW), "--JobID", "TP16"]),
        dict(name="train_f32", cli="train_gpt2", gather=True,
             argv=[*train, "--attn", "vmem", "--JobID", "TP32"]),
        dict(name="llama_bf16", cli="train_gpt2",
             argv=[*train, *LLAMA_125M, "--bf16", "--attn", "auto",
                   "--JobID", "TPL"]),
        # the long-context leg (S 4096 takes flash), 4 steps of the text
        dict(name="long_bf16", cli="train_gpt2",
             argv=[*train, "--seq_len", "4096", "--batch_size", "2",
                   "--bf16", "--attn", "auto", "--chunked_ce", "256",
                   "--JobID", "TPS"]),
        *_encoder_legs(tmp),
    ]


#: phases 63-65's text: the two-rank world's 32768 tokens in windows of
#: 512, 16 a step: 4 steps of BERT-base, ViT-B/16's 4 batches of 128
#: images and t5-small's 4 steps at its CLI's batch
ENC_BATCH, ENC_SEQ = 16, 512


def _encoder_legs(tmp: Path) -> list[dict]:
    """Phases 63-65's runs in the two-rank world (after phase 61's):
    BERT-base through ``train_bert`` (flash, bf16 and f32) and the model
    API (vmem, ``fit(fused='all')``), ViT-B/16 through ``ViT(layout=)``
    and ``fit(fused='all')`` (bf16 and f32), t5-small through
    ``train_t5`` (bf16, and f32 with ``--eval --generate``), and phase
    65's float32 / float64 witness on the CLI's first batch."""
    text = str(tmp / "text.bin")
    common = ["--tokens", text, "--log_dir", str(tmp), "--no_profiler",
              "--seq_len", str(ENC_SEQ), "--batch_size", str(ENC_BATCH),
              "--warmup_steps", "2"]
    bert = [*common, "--vocab_size", "30522", "--chunked_ce", "128",
            "--attn", "flash", "--eval"]
    return [
        dict(name="bert_flash", cli="train_bert",
             argv=[*bert, "--bf16", "--JobID", "TPB16"]),
        dict(name="bert_f32", cli="train_bert", gather=True,
             argv=[*bert, "--JobID", "TPB32"]),
        dict(name="bert_vmem", cli="bert_api",
             argv=["--tokens", text, "--log_dir", str(tmp), "--bf16"]),
        dict(name="vit_bf16", cli="vit_api",
             argv=["--log_dir", str(tmp), "--bf16"]),
        dict(name="vit_f32", cli="vit_api", gather=True,
             argv=["--log_dir", str(tmp)]),
        dict(name="t5_bf16", cli="train_t5",
             argv=[*common, "--bf16", "--JobID", "TPT16"]),
        dict(name="t5_f32", cli="train_t5", gather=True,
             argv=[*common, "--eval", "--generate", "--JobID", "TPT32"]),
        dict(name="t5_witness", cli="t5_witness",
             argv=["--tokens", text, "--log_dir", str(tmp)]),
    ]


def _api_args(argv):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--tensor", default=1, type=int)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--tokens", default=None)
    p.add_argument("--log_dir", default=".")
    return p.parse_args(argv)


def bert_api_main(argv):
    """Phase 63's model-API leg, ``(state, losses)``: BERT-base
    (``Bert(attn_impl='vmem', layout=)`` over ``data x tensor``) through
    ``fit(fused='all')`` with ``make_optimizer(fused=True)`` (its compute
    copy bf16 under ``--bf16``) and ``mlm_forward(chunk=128)``, batch 16
    x S 512 of ``--tokens``, 4 steps, as phase 42's model-API run."""
    import torch

    from tpudist_torch.data.lm import TokenWindowLoader
    from tpudist_torch.mesh import MeshConfig, create_layout
    from tpudist_torch.models.bert import Bert, mlm_forward, mlm_transform
    from tpudist_torch.optim import make_optimizer, run_schedule
    from tpudist_torch.train import fit

    args = _api_args(argv)
    layout = create_layout(MeshConfig(data=-1, tensor=args.tensor))
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = Bert(vocab_size=30523, max_seq_len=ENC_SEQ, dtype=dtype,
                 attn_impl="vmem", layout=layout, device="cuda", seed=SEED)
    loader = TokenWindowLoader(
        args.tokens, ENC_BATCH, ENC_SEQ, vocab_size=30522,
        num_replicas=layout.data, rank=layout.data_idx,
        transform=mlm_transform(30523, 30522, seed=SEED))
    tx = make_optimizer(run_schedule(1e-4, total_steps=4, warmup_steps=0),
                        fused=True,
                        compute_dtype=dtype if args.bf16 else None)
    return fit(model, tx, loader, epochs=1, job_id="TPBAPI",
               input_key="tokens", label_key="targets", fused="all",
               forward_loss=mlm_forward(model, chunk=128), profile=False,
               log_dir=args.log_dir)


def vit_api_main(argv):
    """Phase 64's leg, ``(state, losses)``: ViT-B/16 at phase 22's shape
    (4-pixel patches on 32x32, 65 tokens, 100 classes) built on the
    reference's keyword ``mesh=`` (a ``MeshConfig(data=-1, tensor=T)``)
    through ``fit(fused='all')`` with ``make_optimizer(1e-3, fused=True)``
    (its compute copy bf16 under ``--bf16``), 4 steps of 128 synthetic
    images, the same batches at any world."""
    import torch

    from tpudist_torch.data.cifar import synthetic_cifar, to_tensor
    from tpudist_torch.data.loader import DataLoader
    from tpudist_torch.data.sampler import DistributedSampler
    from tpudist_torch.mesh import MeshConfig
    from tpudist_torch.models.vit import ViT
    from tpudist_torch.optim import make_optimizer
    from tpudist_torch.train import fit

    args = _api_args(argv)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = ViT(num_classes=100, patch_size=4, image_size=32, dtype=dtype,
                mesh=MeshConfig(data=-1, tensor=args.tensor), device="cuda",
                seed=SEED)
    rows = 128
    layout = model.layout
    loader = DataLoader(
        synthetic_cifar(4 * rows * layout.data, num_classes=100), rows,
        transform=to_tensor, sampler=DistributedSampler(
            4 * rows * layout.data, num_replicas=layout.data,
            rank=layout.data_idx))
    tx = make_optimizer(1e-3, fused=True,
                        compute_dtype=dtype if args.bf16 else None)
    return fit(model, tx, loader, epochs=1, job_id="TPVIT", fused="all",
               profile=False, log_dir=args.log_dir)


def t5_witness_main(argv):
    """Phase 65's witness, ``{dtype: loss}``: t5-small at ``train_t5``'s
    defaults from its init (seed 0) on its first batch (``--tokens``,
    windows of 512 corrupted as the CLI corrupts them, 16 a replica), one
    forward and backward in float32 and in float64 (the float32 init cast
    up); the gradients gathered whole, rank 0 saves them as
    ``t5_grads_<dtype>_t<T>.pt`` in ``--log_dir``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tpudist_torch.data.lm import TokenWindowLoader
    from tpudist_torch.mesh import MeshConfig, create_layout
    from tpudist_torch.models.t5 import (
        seq2seq_forward, span_corrupt_transform, span_corruption_plan,
        t5_small,
    )
    from tpudist_torch.parallel import tp

    args = _api_args(argv)
    layout = create_layout(MeshConfig(data=-1, tensor=args.tensor))
    _, spans, _, dec_len = span_corruption_plan(ENC_SEQ)
    vocab = 256 + spans + 1
    loader = TokenWindowLoader(
        args.tokens, ENC_BATCH, ENC_SEQ, vocab_size=256,
        num_replicas=layout.data, rank=layout.data_idx,
        transform=span_corrupt_transform(vocab, seed=SEED + layout.data_idx))
    loader.sampler.set_epoch(0)
    batch = {k: torch.as_tensor(np.asarray(v)).cuda()
             for k, v in next(iter(loader)).items()}
    out = {}
    for dtype in (torch.float32, torch.float64):
        model = t5_small(vocab_size=vocab, max_decode_len=dec_len + 1,
                         dtype=dtype, device="cuda", seed=SEED,
                         layout=layout).to(dtype)
        loss = seq2seq_forward(model)(model, batch)
        loss.backward()
        grads = tp.gather_state_dict(
            {k: p.grad for k, p in model.named_parameters()}, layout, vocab,
            table=model.tensor_specs)
        name = str(dtype).removeprefix("torch.")
        out[name] = float(loss.detach())
        if not dist.is_initialized() or dist.get_rank() == 0:
            torch.save({k: g.cpu() for k, g in grads.items()},
                       Path(args.log_dir) / f"t5_grads_{name}_t{args.tensor}.pt")
        del model, grads, loss
        torch.cuda.empty_cache()
    return out


#: the legs' entry points that are not a CLI's module, and the eval
#: function of a CLI whose results a leg records
API_MAINS = {"bert_api": bert_api_main, "vit_api": vit_api_main,
             "t5_witness": t5_witness_main}
EVALS = {"train_bert": "evaluate_mlm", "train_t5": "evaluate_spans"}


def run_leg(cli: str, argv):
    """One leg in this process, its output kept: ``(result, printed,
    evals)``, ``evals`` the metrics of each eval pass of the CLI."""
    import importlib

    if cli in API_MAINS:
        main_fn, mod = API_MAINS[cli], None
    else:
        mod = importlib.import_module(
            "tpudist_torch.serve.__main__" if cli == "serve"
            else f"tpudist_torch.{cli}")
        main_fn = mod.main
    evals = []
    name = EVALS.get(cli)
    if name is not None:
        inner = getattr(mod, name)

        def recorded(*a, **kw):
            evals.append(inner(*a, **kw))
            return evals[-1]

        setattr(mod, name, recorded)
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            result = main_fn(list(argv))
    finally:
        if name is not None:
            setattr(mod, name, inner)
    return result, printed.getvalue(), evals


def tensor_child(argv) -> int:
    """One rank of phases 60-61's world: ``argv`` is ``--tensor_child
    OUT_DIR``. Forms a 2-rank gloo group over CUDA tensors (both ranks on
    ``cuda:0``), then runs each of :func:`_tp_legs` with ``--tensor 2``:
    every launch count set to 0 just before and read just after, the
    printed output kept, a training run's losses (and with ``gather`` its
    parameters, gathered whole: rank 0 saves them); writes
    ``rank<r>.json``."""
    import torch
    import torch.distributed as dist

    from tpudist_torch.ops import decode as D

    out = Path(argv[argv.index(TENSOR_CHILD) + 1])
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="env://")
    rank = dist.get_rank()
    records = {}
    try:
        for leg in _tp_legs(out):
            for mod in (*counted_modules(), D):
                mod.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result, printed, evals = run_leg(leg["cli"],
                                             [*leg["argv"], "--tensor", "2"])
            torch.cuda.synchronize()
            rec = {"printed": printed, "evals": evals,
                   "counts": {**launches(), **D.launch_counts},
                   "seconds": time.perf_counter() - t0}
            if isinstance(result, tuple):
                state, losses = result
                rec["losses"] = list(losses)
                rec["leaves"] = len(list(state.model.parameters()))
                qkv = next((p for k, p in state.model.named_parameters()
                            if k.endswith("qkv.weight")), None)
                rec["qkv_shape"] = None if qkv is None else list(qkv.shape)
                if leg.get("gather"):
                    params = {k: v.float().cpu()
                              for k, v in state.params().items()}
                    if rank == 0:
                        torch.save(params, out / f"{leg['name']}.pt")
                del state
            else:
                rec["snapshot"] = result
            records[leg["name"]] = rec
            torch.cuda.empty_cache()
    finally:
        (out / f"rank{rank}.json").write_text(json.dumps(records))
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


def tensor_world(tmp: Path) -> list[dict]:
    """Phases 60-61's two ranks on the one card: :func:`tensor_child` in
    two processes (``LOCAL_RANK`` 0 both), within 900 s. Returns each
    rank's records."""
    from tpudist_torch.ops import lm_kernels_bench as LB

    LB.token_file(tmp / "text.bin", 4 * 8 * 1024)  # 4 steps of 8 x 1024
    port = free_port()
    procs = []
    for rank in range(2):
        env = {**os.environ, "PYTHONPATH": str(HERE), "MASTER_ADDR":
               "127.0.0.1", "MASTER_PORT": str(port), "RANK": str(rank),
               "WORLD_SIZE": "2", "LOCAL_RANK": "0"}
        procs.append(subprocess.Popen(
            [sys.executable, str(HERE / "chip_smoke.py"), TENSOR_CHILD,
             str(tmp)], cwd=HERE, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            log, _ = p.communicate(timeout=900)
            logs.append(log)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode:
            fail(f"tensor child rank {r} exited {p.returncode}:\n"
                 f"{log[-4000:]}")
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(2)]


def _one_rank(cli: str, argv):
    """A leg run in this process at one rank (no group), output kept:
    ``(result, printed)``."""
    result, printed, _ = run_leg(cli, argv)
    return result, printed


def _streams(printed: str) -> list[str]:
    return [ln for ln in printed.splitlines() if ln.startswith("request ")]


def _prefix(a: str, b: str) -> int:
    """The tokens two printed streams share before they differ."""
    ta = a.split("-> ", 1)[-1].strip("[]").split(", ")
    tb = b.split("-> ", 1)[-1].strip("[]").split(", ")
    return next((i for i, (x, y) in enumerate(zip(ta, tb)) if x != y),
                min(len(ta), len(tb)))


def tensor_serving_phase(smi: str, tmp: Path, ranks: list[dict]) -> None:
    """Phase 60 (module docstring)."""
    t0 = time.perf_counter()
    print("== 60. two ranks on one card (gloo over CUDA tensors): the "
          "tensor-sharded serving CLIs")
    legs = {leg["name"]: leg for leg in _tp_legs(tmp)}
    for name in ("serve_bf16", "serve_spec", "serve_f32", "demo"):
        got = [r[name] for r in ranks]
        counts = got[0]["counts"]
        snap = got[0]["snapshot"]
        paged = counts["paged_decode_attention"]
        # the demo's contiguous engine decodes per-row cursors on the dense
        # path, as the reference's does: it launches no counted kernel
        others = {k: n for k, n in counts.items()
                  if n and k != "paged_decode_attention"}
        if (not paged) != (name == "demo") or others or any(
                g["counts"] != counts for g in got):
            fail(f"{name}: launches {[g['counts'] for g in got]}")
        if snap["tensor_world"] != 2 or got[1]["printed"]:
            fail(f"{name}: tensor_world {snap['tensor_world']}, rank 1 "
                 f"printed {got[1]['printed'][:200]!r}")
        one, printed = _one_rank(legs[name]["cli"], legs[name]["argv"])
        if name == "demo":
            done = lambda out: sorted(ln for ln in out.splitlines()
                                      if ln.endswith("tokens (done)"))
            same = done(got[0]["printed"]) == done(printed)
            agree = f"every request served as at one rank: {same}"
            if not same or len(done(printed)) != 8:
                fail(f"demo: {done(got[0]['printed'])} vs {done(printed)}")
        else:
            a, b = _streams(got[0]["printed"]), _streams(printed)
            equal = sum(x == y for x, y in zip(a, b))
            agree = (f"{equal} of {len(b)} greedy streams equal the one-rank "
                     f"CLI's, tokens agreeing before the first difference "
                     f"{[_prefix(x, y) for x, y in zip(a, b)]}")
            if len(a) != 8 or len(b) != 8:
                fail(f"{name}: {len(a)} and {len(b)} streams printed")
            if name == "serve_f32" and equal != len(b):
                fail(f"{name}: the sharded f32 streams differ: {a} vs {b}")
        spec = (f"; drafted {snap['spec_drafted']}, accepted "
                f"{snap['spec_accepted']}" if name == "serve_spec" else "")
        print(f"  {name} ({' '.join(legs[name]['argv'][:6])} ... --tensor 2):"
              f" paged kernel {paged} launches a rank (every other counted "
              f"kernel 0), TPOT p50 "
              f"{snap['tpot_p50']} s, {snap['tokens_per_sec']} tok/s "
              f"(one rank here: {one['tpot_p50']} s, "
              f"{one['tokens_per_sec']} tok/s){spec}; {agree}; "
              f"{got[0]['seconds']:.1f} s  [{smi}]")
    print(f"  phase 60: {time.perf_counter() - t0:.1f} s here (the one-rank "
          "runs); the world's serving runs "
          + ", ".join(f"{n} {ranks[0][n]['seconds']:.1f} s" for n in
                      ("serve_bf16", "serve_spec", "serve_f32", "demo")))


def tensor_training_phase(smi: str, tmp: Path, ranks: list[dict]) -> None:
    """Phase 61 (module docstring)."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    print("== 61. the same world: train_gpt2 --tensor 2 --fused all")
    legs = {leg["name"]: leg for leg in _tp_legs(tmp)}
    depth = 12
    for name, attn in (("train_bf16", "vmem"), ("llama_bf16", "vmem"),
                       ("long_bf16", "flash")):
        got = [r[name] for r in ranks]
        losses = got[0]["losses"]
        counts = {k: n for k, n in got[0]["counts"].items() if n}
        # --generate's decode steps, one contiguous launch a block each
        decode = counts.pop("fused_decode_attention", 0)
        per_step = {k: n / len(losses) for k, n in counts.items()}
        want = {"layernorm_fwd": 2 * depth + 1, "layernorm_bwd": 2 * depth + 1,
                "layernorm_bwd_reduce": 2 * depth + 1,
                f"{attn}_attention_fwd": depth,
                f"{attn}_attention_bwd": depth,
                "fused_adamw": 1, "fused_adamw_leaves": got[0]["leaves"]}
        want_decode = depth * NEW if name == "train_bf16" else 0
        if (len(losses) != 4 or not np.isfinite(losses).all()
                or per_step != want or decode != want_decode
                or any(g["losses"] != losses for g in got)
                or any(g["counts"] != got[0]["counts"] for g in got)):
            fail(f"{name}: losses {[g['losses'] for g in got]}, launches a "
                 f"step {per_step} (want {want}), decode {decode} (want "
                 f"{want_decode})")
        said = [ln for ln in got[0]["printed"].splitlines()
                if ln.startswith("generated tokens")]
        print(f"  {name}: 4 steps, losses {losses[0]:.4f} -> {losses[-1]:.4f},"
              f" equal on both ranks; launches a step a rank {per_step} over "
              f"{got[0]['leaves']} leaves a rank"
              + (f"; --generate {NEW}: {decode} contiguous launches a rank "
                 f"(= {depth} x {NEW})" if decode else "")
              + f"; {got[0]['seconds']:.1f} s  [{smi}]")
        if name == "train_bf16" and (len(said) != 1 or "generated tokens"
                                     in got[1]["printed"]):
            fail(f"{name}: rank 0 alone prints the generated tokens: {said}")
    # f32 against the one-rank run from the same seed on the same text
    got = ranks[0]["train_f32"]
    sharded = torch.load(tmp / "train_f32.pt")
    (state, losses), _ = _one_rank("train_gpt2", legs["train_f32"]["argv"])
    whole = {k: v.float().cpu() for k, v in state.params().items()}
    del state
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], losses))
    gaps, key_moved = {}, 0.0
    for k, b in whole.items():
        a = sharded[k]
        if k.endswith("qkv.bias"):
            key_moved = max(key_moved, float(a[1].abs().max()),
                            float(b[1].abs().max()))
            a, b = a[[0, 2]], b[[0, 2]]
        gaps[k] = float((a - b).abs().max())
    worst = max(gaps, key=gaps.get)
    key_bound = 1.5 * 4 * 3e-4
    print(f"  f32 --tensor 2 against one rank: losses {got['losses']} vs "
          f"{losses}: max rel {loss_rel:.3e} [bar {LOSS_BAR:g}]; params max "
          f"abs {gaps[worst]:.3e} ({worst}) [bar {PARAM_BAR:g}]; key slice of "
          f"the qkv biases moved at most {key_moved:.3e} [step bound "
          f"{key_bound:.2e}]")
    if (loss_rel > LOSS_BAR or gaps[worst] > PARAM_BAR
            or key_moved > key_bound or sharded.keys() != whole.keys()):
        fail("the f32 tensor-parallel run and the one-rank run disagree")
    print(f"  phase 61: {time.perf_counter() - t0:.1f} s here (the one-rank "
          "f32 run); the world's training runs "
          + ", ".join(f"{n} {ranks[0][n]['seconds']:.1f} s" for n in
                      ("train_bf16", "train_f32", "llama_bf16", "long_bf16")))



#: phase 62's shape: BERT-base's attention (B 32, S 512, 12 heads of 64,
#: non-causal), the shape of PERF.md's BERT kernel readings
ENC_SHARD = (32, 512, 12, 64)


def _encoder_shard_cases(dev, b: int, s: int, h: int, dh: int):
    """Phase 62's kernels as :func:`_shard_cases` gives phase 59's: vmem
    and flash forward and backward, non-causal, bf16 from a seeded
    generator."""
    import torch

    from tpudist_torch.ops import flash_attention as FA
    from tpudist_torch.ops import vmem_attention as VA

    gen = torch.Generator(device="cpu").manual_seed(SEED + 62)
    q, k, v, do = (torch.randn(b, s, h, dh, generator=gen).to(
        dev, torch.bfloat16) for _ in range(4))
    kw = dict(causal=False, kv_len=s, scale=VA._scale(dh))
    ov, lsev = VA.vmem_fwd_cuda(q, k, v, **kw)
    of, lsef = FA.flash_fwd_cuda(q, k, v, **kw)
    every = (slice(None), slice(None))
    fwd = lambda hs, ks: (q[:, :, hs], k[:, :, ks], v[:, :, ks])
    fwd_out = lambda out, hs, ks: (out[0][:, :, hs], out[1][:, hs])
    bwd_out = lambda out, hs, ks: (out[0][:, :, hs], out[1][:, :, ks],
                                   out[2][:, :, ks])

    def bwd(o, lse):
        return lambda hs, ks: (q[:, :, hs], k[:, :, ks], v[:, :, ks],
                               o[:, :, hs], do[:, :, hs],
                               lse[:, hs].contiguous())

    return [
        ("vmem_attention_fwd", fwd, lambda *a: VA.vmem_fwd_cuda(*a, **kw),
         fwd_out),
        ("vmem_attention_bwd", bwd(ov, lsev),
         lambda *a: VA.vmem_bwd_cuda(*a, **kw), bwd_out),
        ("flash_attention_fwd", fwd, lambda *a: FA.flash_fwd_cuda(*a, **kw),
         fwd_out),
        ("flash_attention_bwd", bwd(of, lsef),
         lambda *a: FA.flash_bwd_cuda(*a, **kw), bwd_out),
    ], every


def encoder_shard_phase(smi: str, dev, shape=ENC_SHARD) -> None:
    """Phase 62 (module docstring); ``shape`` narrows it (a rehearsal)."""
    import torch

    t0 = time.perf_counter()
    b, s, h, dh = shape
    print(f"== 62. tensor-parallel shard parity at BERT-base's attention (B "
          f"{b}, S {s}, {h} heads of {dh}, non-causal, bf16): each rank's 6 "
          "heads through vmem and flash against the call over all 12")
    cases, every = _encoder_shard_cases(dev, b, s, h, dh)
    shard_parity(smi, "BERT-base", cases, every, h, h, (2,))
    del cases
    torch.cuda.empty_cache()
    print(f"  phase 62: {time.perf_counter() - t0:.1f} s")


def _world_leg(ranks: list[dict], name: str, want: dict, what: str):
    """A two-rank leg's records after its checks: 4 finite losses equal
    on both ranks, the same launches on both, a rank's launches ``want``
    (every other counted kernel 0). Returns rank 0's record."""
    import numpy as np

    got = [r[name] for r in ranks]
    losses = got[0]["losses"]
    counts = {k: n for k, n in got[0]["counts"].items() if n}
    if (len(losses) != 4 or not np.isfinite(losses).all()
            or any(g["losses"] != losses for g in got)
            or any(g["counts"] != got[0]["counts"] for g in got)
            or counts != {k: n for k, n in want.items() if n}):
        fail(f"{name}: losses {[g['losses'] for g in got]}, launches a rank "
             f"{[g['counts'] for g in got]} (want {want})")
    print(f"  {name} ({what}): 4 steps, losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, equal on both ranks; launches a rank "
          f"{ {k: n for k, n in want.items() if n} } over "
          f"{got[0]['leaves']} leaves a rank; {got[0]['seconds']:.1f} s")
    return got[0]


def _step_counts(per_step: dict, steps: int = 4, **extra) -> dict:
    out = {k: n * steps for k, n in per_step.items()}
    for k, n in extra.items():
        out[k] = out.get(k, 0) + n
    return out


def _against_one_rank(name: str, sharded: dict, whole: dict, losses,
                      one_losses, *, loss_bar: float, param_bar: float,
                      peak_lr: float, how: str = "--tensor 2") -> None:
    """A float32 leg's gathered parameters and losses against the
    one-rank run's from the same seed on the same data: losses
    ``loss_bar`` relative, parameters ``param_bar`` absolute, the key
    slice of a qkv bias (zero gradient in exact arithmetic) held to its
    step bound from its zero init instead (:func:`f32_agreement`'s
    rule)."""
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, one_losses))
    gaps, key_moved = {}, 0.0
    for k, b in whole.items():
        a = sharded[k]
        if k.endswith("qkv.bias"):
            key_moved = max(key_moved, float(a[1].abs().max()),
                            float(b[1].abs().max()))
            a, b = a[[0, 2]], b[[0, 2]]
        gaps[k] = float((a - b).abs().max())
    worst = max(gaps, key=gaps.get)
    key_bound = 1.5 * 4 * peak_lr
    key = (f"; key slice of the qkv biases moved at most {key_moved:.3e} "
           f"[step bound {key_bound:.2e}]"
           if any(k.endswith("qkv.bias") for k in whole) else "")
    print(f"  {name} {how} against one rank: losses {losses} vs "
          f"{one_losses}: max rel {loss_rel:.3e} [bar {loss_bar:g}]; params "
          f"max abs {gaps[worst]:.3e} ({worst}) [bar {param_bar:g}]{key}")
    if (loss_rel > loss_bar or gaps[worst] > param_bar
            or key_moved > key_bound or sharded.keys() != whole.keys()):
        fail(f"{name}: the f32 {how} run and the one-rank run disagree")


def tensor_bert_phase(smi: str, tmp: Path, ranks: list[dict]) -> None:
    """Phase 63 (module docstring)."""
    import torch

    t0 = time.perf_counter()
    print("== 63. the same world: BERT-base (12 x 768, S 512, batch 16, "
          "model vocab 30523: 15262 / 15261 rows a rank) with --tensor 2")
    legs = {leg["name"]: leg for leg in _encoder_legs(tmp)}
    depth, ln = 12, 25  # ln_embed plain, two post-norms a block
    evals_batches = 4  # --eval reads the 64 windows again, 16 a batch
    flash = {"flash_attention_fwd": depth, "flash_attention_bwd": depth}
    for name in ("bert_flash", "bert_f32"):
        _world_leg(ranks, name, _step_counts(
            flash, flash_attention_fwd=depth * evals_batches),
            f"train_bert --attn flash --chunked_ce 128 --eval, "
            f"{'bf16' if name == 'bert_flash' else 'f32'}")
        evals = [r[name]["evals"] for r in ranks]
        if len(evals[0]) != 1 or evals[0] != evals[1]:
            fail(f"{name}: --eval on the two ranks {evals}")
        print(f"    --eval on both ranks: {evals[0][0]} (flash forward "
              f"{depth} x {evals_batches} batches a rank)")
    api = _world_leg(ranks, "bert_vmem", _step_counts(
        {"layernorm_fwd": ln, "layernorm_bwd": ln, "layernorm_bwd_reduce": ln,
         "vmem_attention_fwd": depth, "vmem_attention_bwd": depth,
         "fused_adamw": 1}) | {"fused_adamw_leaves":
                               4 * bert_leaves(depth)},
        "Bert(attn_impl='vmem', layout=) + fit(fused='all'), bf16 copy")
    if api["leaves"] != bert_leaves(depth):
        fail(f"bert_vmem: {api['leaves']} leaves a rank")
    sharded = torch.load(tmp / "bert_f32.pt")
    (state, losses), printed = _one_rank("train_bert",
                                         legs["bert_f32"]["argv"])
    whole = {k: v.float().cpu() for k, v in state.params().items()}
    del state
    torch.cuda.empty_cache()
    said = lambda out: [line for line in out.splitlines()
                        if line.startswith("mlm_loss")]
    print(f"    --eval, one rank: {said(printed)}; two: "
          f"{said(ranks[0]['bert_f32']['printed'])}")
    _against_one_rank("bert_f32", sharded, whole,
                      ranks[0]["bert_f32"]["losses"], losses,
                      loss_bar=LOSS_BAR, param_bar=PARAM_BAR, peak_lr=1e-4)
    print(f"  phase 63: {time.perf_counter() - t0:.1f} s here (the one-rank "
          "f32 run); the world's runs " + ", ".join(
              f"{n} {ranks[0][n]['seconds']:.1f} s"
              for n in ("bert_flash", "bert_f32", "bert_vmem")) + f"  [{smi}]")


def tensor_vit_phase(smi: str, tmp: Path, ranks: list[dict]) -> None:
    """Phase 64 (module docstring)."""
    import torch

    t0 = time.perf_counter()
    print("== 64. the same world: ViT-B/16 at 32x32 (65 tokens) on "
          "ViT(mesh=MeshConfig(tensor=2)) through fit(fused='all')")
    legs = {leg["name"]: leg for leg in _encoder_legs(tmp)}
    ln = 25  # each block's two pre-norms (the second fused with its add), norm
    want = _step_counts({"layernorm_fwd": ln, "layernorm_bwd": ln,
                         "layernorm_bwd_reduce": ln, "fused_adamw": 1})
    for name in ("vit_bf16", "vit_f32"):
        rec = _world_leg(ranks, name, want | {"fused_adamw_leaves": 4 * 152},
                         "bf16 copy" if name == "vit_bf16" else "f32")
        if rec["leaves"] != 152 or rec["qkv_shape"] != [1152, 768]:
            fail(f"{name}: {rec['leaves']} leaves, qkv.weight "
                 f"{rec['qkv_shape']} a rank (want 152, [1152, 768])")
        print(f"    a rank's blocks.0.qkv.weight {rec['qkv_shape']} (its 6 "
              "heads of each of q, k and v)")
    sharded = torch.load(tmp / "vit_f32.pt")
    (state, losses), _ = _one_rank("vit_api", legs["vit_f32"]["argv"])
    whole = {k: v.float().cpu() for k, v in state.params().items()}
    del state
    torch.cuda.empty_cache()
    _against_one_rank("vit_f32", sharded, whole, ranks[0]["vit_f32"]["losses"],
                      losses, loss_bar=VIT_LOSS_BAR, param_bar=VIT_PARAM_BAR,
                      peak_lr=1e-3)
    print(f"  phase 64: {time.perf_counter() - t0:.1f} s here (the one-rank "
          "f32 run); the world's runs " + ", ".join(
              f"{n} {ranks[0][n]['seconds']:.1f} s"
              for n in ("vit_bf16", "vit_f32")) + f"  [{smi}]")


def t5_same_weights(sharded: dict, tmp: Path):
    """Phase 65's checks on the two-rank run's gathered weights
    ``sharded``, one process: an unsharded t5-small holding them gives
    ``(tokens, evals)``, its greedy ``generate_seq2seq`` on the CLI's
    ``--generate`` window and its ``evaluate_spans`` over the CLI's
    ``--eval`` batches."""
    import types

    import numpy as np

    from tpudist_torch.data.lm import TokenWindowLoader
    from tpudist_torch.generate import generate_seq2seq
    from tpudist_torch.models.t5 import (
        span_corrupt_transform, span_corruption_plan, t5_small,
    )
    from tpudist_torch.train_t5 import evaluate_spans

    _, spans, _, dec_len = span_corruption_plan(ENC_SEQ)
    vocab = 256 + spans + 1
    model = t5_small(vocab_size=vocab, max_decode_len=dec_len + 1,
                     device="cuda")
    model.load_state_dict(sharded)
    model.eval()
    text = np.fromfile(tmp / "text.bin", np.uint16)
    corrupt = lambda seed: span_corrupt_transform(vocab, seed=seed)
    demo = corrupt(SEED + 20_000)(
        {"tokens": text[:ENC_SEQ].astype(np.int32)[None]})
    tokens = generate_seq2seq(model, demo["enc_tokens"], dec_len,
                              temperature=0.0)[0].tolist()
    evals = evaluate_spans(types.SimpleNamespace(model=model),
                           TokenWindowLoader(
                               text, ENC_BATCH, ENC_SEQ, vocab_size=256,
                               shuffle=False, drop_remainder=True,
                               transform=corrupt(SEED + 10_000)))
    return tokens, evals


#: phase 65's bars. t5-small at its init is ill-conditioned in float32
#: (dense, un-scaled scores over 16 layers): tools/t5_tensor_witness.py
#: (CPU, batch 2 x S 512) puts one rank's float32 forward and backward
#: 1.9e-4 (relative) from the float64 loss and up to 0.27 of a leaf's
#: largest gradient from the float64 gradients, and two ranks' float64
#: 8.6e-14 and 1.5e-10 from one rank's. Float64 carries 2**29 times
#: float32's precision, so that conditioning leaves it about 3.5e-13 on
#: the loss and 5e-10 on a gradient: the float64 bars, about 20 times
#: that, hold the sharded forward and backward to one rank's.
T5_F64_LOSS_BAR, T5_F64_GRAD_BAR = 1e-11, 1e-8
#: float32's: a loss held to float64's, or to an unsharded float32 model
#: on the same weights, within five times the 1.9e-4 above
T5_F32_BAR = 1e-3
#: the 4-step float32 trajectories' parameters: the CLI's lr runs 0, 5e-4,
#: 1e-3, 5e-4 (2e-3 in all), and over 4 steps Adam's bias-corrected step
#: is at most 1.01 lr a coordinate (Cauchy-Schwarz on its moment
#: weights), so two runs whose gradients part (float32's do, by up to 0.27
#: of a leaf's scale) part by at most twice 1.01 x 2e-3; a fault of the
#: gather or the shards' order moves the weights by their own scale
T5_PARAM_BAR = 2 * 1.01 * 2e-3


def _grad_gap(got: dict, want: dict) -> tuple[float, str]:
    """The largest gap of gradients ``got`` from ``want`` over the
    leaves, each as a share of ``want``'s largest entry there."""
    gaps = {k: float((got[k].double() - w.double()).abs().max()
                     / max(float(w.double().abs().max()), 1e-300))
            for k, w in want.items()}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def t5_witness(tmp: Path, ranks: list[dict]) -> None:
    """Phase 65's witness (module docstring): the two-rank run's records
    against :func:`t5_witness_main` at one rank, in this process."""
    import torch

    legs = {leg["name"]: leg for leg in _encoder_legs(tmp)}
    two = ranks[0]["t5_witness"]["snapshot"]
    if ranks[1]["t5_witness"]["snapshot"] != two:
        fail(f"t5_witness: the ranks' losses {two} and "
             f"{ranks[1]['t5_witness']['snapshot']}")
    one, _ = _one_rank("t5_witness", legs["t5_witness"]["argv"])
    grads = {(d, t): torch.load(tmp / f"t5_grads_{d}_t{t}.pt")
             for d in ("float32", "float64") for t in (1, 2)}
    truth, want = one["float64"], grads[("float64", 1)]
    rel = lambda x: abs(x - truth) / abs(truth)
    loss64 = rel(two["float64"])
    grad64, leaf64 = _grad_gap(grads[("float64", 2)], want)
    print(f"    the witness, t5-small from the CLI's init on its first "
          f"batch: float64 loss, two ranks {two['float64']!r} against one "
          f"rank's {truth!r}, rel {loss64:.3e} [bar {T5_F64_LOSS_BAR:g}]; "
          f"float64 gradients gathered, worst leaf {leaf64} at {grad64:.3e} "
          f"of its largest [bar {T5_F64_GRAD_BAR:g}]")
    for t, what in ((1, "one rank"), (2, "two ranks")):
        loss = (one if t == 1 else two)["float32"]
        gap, leaf = _grad_gap(grads[("float32", t)], want)
        print(f"    float32 at {what}: loss {loss!r}, rel {rel(loss):.3e} "
              f"from float64's; gradients, worst leaf {leaf} at {gap:.3e} "
              "of its largest")
    if (loss64 > T5_F64_LOSS_BAR or grad64 > T5_F64_GRAD_BAR
            or rel(two["float32"]) > T5_F32_BAR
            or grads[("float64", 2)].keys() != want.keys()):
        fail("t5_witness: the two-rank t5-small and the one-rank one "
             "disagree")


def tensor_t5_phase(smi: str, tmp: Path, ranks: list[dict]) -> None:
    """Phase 65 (module docstring)."""
    import torch

    from tpudist_torch.ops import decode as D

    t0 = time.perf_counter()
    print("== 65. the same world: train_t5 --tensor 2 at its defaults "
          "(t5-v1.1-small: 6 heads of 85, 3 a rank; S 512, batch 16; no "
          "counted kernel: the relative bias keeps attention dense)")
    legs = {leg["name"]: leg for leg in _encoder_legs(tmp)}
    none = dict.fromkeys((*launches(), *D.launch_counts), 0)
    bf16 = _world_leg(ranks, "t5_bf16", none, "bf16")
    if not bf16["losses"][-1] < bf16["losses"][0]:
        fail(f"t5_bf16: losses do not fall: {bf16['losses']}")
    rec = _world_leg(ranks, "t5_f32", none, "f32, --eval --generate")
    evals = [r["t5_f32"]["evals"] for r in ranks]
    if len(evals[0]) != 1 or evals[0] != evals[1]:
        fail(f"t5_f32: --eval on the two ranks {evals}")
    if any("generated span tokens" in r["t5_f32"]["printed"]
           for r in ranks[1:]):
        fail("t5_f32: rank 1 printed the generated tokens")
    tokens = lambda out: json.loads(next(
        (line.split(": ", 1)[1] for line in out.splitlines()
         if line.startswith("generated span tokens")), "null"))
    got = tokens(rec["printed"])
    sharded = torch.load(tmp / "t5_f32.pt")
    again, same = t5_same_weights(sharded, tmp)
    ev = abs(evals[0][0]["loss"] - same["loss"]) / abs(same["loss"])
    print(f"    on the gathered weights, an unsharded t5-small: --eval "
          f"{evals[0][0]['loss']} / {evals[0][0]['accuracy']} against its "
          f"{same['loss']} / {same['accuracy']}, rel {ev:.3e} [bar "
          f"{T5_F32_BAR:g}]; --generate's {len(got or [])} greedy tokens "
          f"equal its: {again == got}")
    if got is None or again != got or ev > T5_F32_BAR:
        fail("t5_f32: the two-rank model and the unsharded one disagree on "
             "the same weights")
    t5_witness(tmp, ranks)
    (state, losses), printed = _one_rank("train_t5", legs["t5_f32"]["argv"])
    whole = {k: v.float().cpu() for k, v in state.params().items()}
    del state
    torch.cuda.empty_cache()
    gaps = {k: float((sharded[k] - w).abs().max()) for k, w in whole.items()}
    worst = max(gaps, key=gaps.get)
    one = tokens(printed)
    apart = next((i for i, (a, b) in enumerate(zip(got, one or []))
                  if a != b), None)
    print(f"    the f32 trajectories: losses {rec['losses']} against one "
          f"rank's {losses}, max rel "
          f"{max(abs(a - b) / abs(b) for a, b in zip(rec['losses'], losses)):.3e}"
          f"; parameters max abs {gaps[worst]:.3e} ({worst}) [bar "
          f"{T5_PARAM_BAR:g}]; greedy tokens equal the one-rank run's: "
          f"{one == got}" + ("" if apart is None
                             else f" (first apart at token {apart})"))
    if gaps[worst] > T5_PARAM_BAR or sharded.keys() != whole.keys():
        fail("t5_f32: the two-rank parameters part from one rank's beyond "
             "Adam's steps")
    print(f"  phase 65: {time.perf_counter() - t0:.1f} s here (the one-rank "
          "runs); the world's runs " + ", ".join(
              f"{n} {ranks[0][n]['seconds']:.1f} s"
              for n in ("t5_bf16", "t5_f32", "t5_witness")) + f"  [{smi}]")


#: phase 66's cases: (name, kernels, shape, tensor x seq ranks whose heads
#: one rank holds): the Ulysses exchange leaves a (seq, tensor) rank 12 /
#: T / seq heads over the whole sequence, the gathered attention 12 / T.
#: ``ulysses_flash`` takes the kernel by length: flash at S 4096, vmem at
#: BERT's S 512 (both run there)
CP_TP_SHARDS = (("GPT-2 124M S 4096", ("flash",), "gpt2", 4),
                ("BERT-base S 512", ("flash", "vmem"), "bert", 4),
                ("GPT-2 124M S 1024", ("vmem",), "gpt2", 2))


def cp_tensor_shard_phase(smi: str, dev, shards=CP_TP_SHARDS,
                          seq=TP_SEQ, enc=ENC_SHARD) -> None:
    """Phase 66 (module docstring); ``seq`` and ``enc`` narrow it (a
    rehearsal)."""
    import torch

    t0 = time.perf_counter()
    print("== 66. seq x tensor shard parity: the heads a (seq, tensor) rank "
          "holds through the kernels, against the same heads of the call "
          "over all of them (bf16)")
    for name, kinds, model, ranks in shards:
        if model == "gpt2":
            cases, every = _shard_cases(dev, 12, 12, 64, seq)
            h = 12
        else:
            cases, every = _encoder_shard_cases(dev, *enc)
            h = enc[2]
        cases = [c for c in cases if c[0].split("_")[0] in kinds]
        shard_parity(smi, name, cases, every, h, h, (ranks,))
        del cases
        torch.cuda.empty_cache()
    print(f"  phase 66: {time.perf_counter() - t0:.1f} s")


COMPOSED_CHILD = "--composed_child"
#: phases 67-69's token files: 4 steps of 16 x 1024 (two replicas of 8,
#: or one of 4 x 4096) and of 8 x 1024 (one replica; BERT's 16 x 512), and
#: one eval batch a replica
COMPOSED_TEXT = {"ctext.bin": 4 * 16 * 1024, "ctext1.bin": 4 * 8 * 1024,
                 "cval.bin": 16 * 1024}
#: phases 70-71's token files: 4 steps of 8 x 1024 (one replica) and of
#: 16 x 1024 (two replicas of 8)
PIPE_TEXT = {"ptext.bin": 4 * 8 * 1024, "pdtext.bin": 4 * 16 * 1024}
#: the NaN phase 70's ``--amp`` leg puts in stage 1's gradients: the leaf,
#: the step (1-based)
PIPE_NAN = ("h.11.mlp_fc.weight", 2)


def _composed_legs(tmp: Path) -> list[dict]:
    """Phases 67-69's runs in the four-rank world, in order, each with its
    own layout flags (module docstring)."""
    text, text1 = str(tmp / "ctext.bin"), str(tmp / "ctext1.bin")
    gpt = ["--no_profiler", "--log_dir", str(tmp), "--warmup_steps", "2",
           "--total_steps", "4", "--fused", "all"]
    s1024 = [*gpt, "--tokens", text, "--batch_size", "8", "--seq_len",
             "1024"]
    return [
        dict(name="fsdp_bf16", cli="train_gpt2", plan=(1, 2, 2),
             argv=[*s1024, "--fsdp", "2", "--tensor", "2", "--bf16",
                   "--attn", "auto", "--eval", "--val_tokens",
                   str(tmp / "cval.bin"), "--generate", str(NEW),
                   "--JobID", "C67B"]),
        dict(name="fsdp_f32", cli="train_gpt2", gather=True, plan=(1, 2, 2),
             argv=[*s1024, "--fsdp", "2", "--tensor", "2", "--attn", "vmem",
                   "--JobID", "C67F"]),
        dict(name="zero_bf16", cli="train_gpt2", plan=(2, 1, 2), zero1=True,
             argv=[*s1024, "--tensor", "2", "--shard_opt_state", "--bf16",
                   "--attn", "auto", "--JobID", "C68B"]),
        dict(name="zero_f32", cli="train_gpt2", gather=True, plan=(2, 1, 2),
             zero1=True,
             argv=[*s1024, "--tensor", "2", "--shard_opt_state", "--attn",
                   "vmem", "--JobID", "C68F"]),
        dict(name="tp_f32", cli="train_gpt2", gather=True, plan=(2, 1, 2),
             argv=[*s1024, "--tensor", "2", "--attn", "vmem", "--JobID",
                   "C68R"]),
        dict(name="cp_flash_bf16", cli="train_gpt2",
             argv=[*gpt, "--tokens", text, "--cp", "2", "--tensor", "2",
                   "--attn", "ulysses_flash", "--seq_len", "4096",
                   "--chunked_ce", "256", "--batch_size", "4", "--bf16",
                   "--JobID", "C69U"]),
        dict(name="cp_ring_f32", cli="train_gpt2", gather=True,
             argv=[*gpt, "--tokens", text1, "--cp", "2", "--tensor", "2",
                   "--attn", "ring", "--seq_len", "1024", "--batch_size",
                   "8", "--JobID", "C69R"]),
        dict(name="bert_cp_bf16", cli="train_bert",
             argv=["--tokens", text1, "--log_dir", str(tmp), "--no_profiler",
                   "--seq_len", "512", "--batch_size", "16", "--warmup_steps",
                   "2", "--vocab_size", "30522", "--chunked_ce", "128",
                   "--attn", "ulysses_flash", "--tensor", "2", "--cp", "2",
                   "--bf16", "--JobID", "C69B"]),
    ]


def _poisoned(build_model, leaf: str, at: int):
    """``train_gpt2.build_model`` with a NaN put in stage 1's ``leaf``
    gradient at step ``at`` (1-based)."""

    def build(args, dtype, attn, device, layout):
        model = build_model(args, dtype, attn, device, layout)
        if layout.pipe_idx == 1:
            steps = {"n": 0}
            model.register_forward_pre_hook(
                lambda *_: steps.update(n=steps["n"] + 1))
            dict(model.named_parameters())[leaf].register_hook(
                lambda g: g * float("nan") if steps["n"] == at else g)
        return model

    return build


def composed_child(argv) -> int:
    """One rank of phases 67-69's or 70's or 71's world: ``argv`` is
    ``--composed_child OUT_DIR KIND`` (``composed``: :func:`_composed_legs`;
    ``pipe``: :func:`_pipe_legs` at this world's size). Forms a gloo group
    over CUDA tensors (every rank on ``cuda:0``), then runs each leg as
    :func:`tensor_child` runs its legs, recording besides the allocator's
    peak a rank, an ``--amp`` leg's skipped steps and, under ``--pipe``,
    whether the stages' copies of the replicated leaves are bit-equal; a
    leg with ``trim`` first copies that checkpoint without its last step
    (rank 0), one with ``nan`` poisons a gradient (:func:`_poisoned`).
    Writes ``rank<r>.json``."""
    import shutil

    import torch
    import torch.distributed as dist

    from tpudist_torch import train_gpt2 as TG
    from tpudist_torch.amp import skipped_steps
    from tpudist_torch.ops import decode as D
    from tpudist_torch.parallel import pp

    i = argv.index(COMPOSED_CHILD)
    out, kind = Path(argv[i + 1]), argv[i + 2]
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="env://")
    rank = dist.get_rank()
    legs = (_composed_legs(out) if kind == "composed"
            else _pipe_legs(out, dist.get_world_size()))
    records = {}
    build_model = TG.build_model
    try:
        for leg in legs:
            # the leg's name where a dying rank leaves it (its log)
            print(f"rank {rank}: leg {leg['name']}", file=sys.stderr,
                  flush=True)
            if leg.get("trim"):
                src, dst, last = leg["trim"]
                if rank == 0:
                    shutil.copytree(src, dst)
                    shutil.rmtree(Path(dst) / str(last))
                dist.barrier()
            if leg.get("nan"):
                TG.build_model = _poisoned(build_model, *leg["nan"])
            for mod in (*counted_modules(), D):
                mod.reset_launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            try:
                (state, losses), printed, _ = run_leg(
                    leg.get("cli", "train_gpt2"), leg["argv"])
            finally:
                TG.build_model = build_model
            torch.cuda.synchronize()
            rec = {"printed": printed,
                   "counts": {**launches(), **D.launch_counts},
                   "seconds": time.perf_counter() - t0,
                   "peak": torch.cuda.max_memory_allocated(),
                   "losses": list(losses),
                   "leaves": len(list(state.model.parameters()))}
            if "--amp" in leg["argv"]:
                rec["skipped"] = skipped_steps(state.opt_state)
            if "--pipe" in leg["argv"]:
                rec["replicas_agree"] = pp.replicas_agree(
                    dict(state.model.named_parameters()), state.model.layout)
            if leg.get("gather"):
                params = {k: v.float().cpu()
                          for k, v in state.params().items()}
                if rank == 0:
                    torch.save(params, out / f"{leg['name']}.pt")
            del state
            records[leg["name"]] = rec
            torch.cuda.empty_cache()
    finally:
        (out / f"rank{rank}.json").write_text(json.dumps(records))
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


#: each kind of :func:`composed_child` world's token files
WORLD_TEXT = {"composed": COMPOSED_TEXT, "pipe": PIPE_TEXT}


def start_composed_world(tmp: Path, kind: str = "composed",
                         world: int = 4) -> list:
    """Start ``world`` ranks on the one card (:func:`composed_child`,
    ``LOCAL_RANK`` 0 all) running ``kind``'s legs, their token files
    written into ``tmp`` first; :func:`finish_world` collects them."""
    from tpudist_torch.ops import lm_kernels_bench as LB

    for name, n in WORLD_TEXT[kind].items():
        LB.token_file(tmp / name, n)
    port = free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, "PYTHONPATH": str(HERE), "MASTER_ADDR":
               "127.0.0.1", "MASTER_PORT": str(port), "RANK": str(rank),
               "WORLD_SIZE": str(world), "LOCAL_RANK": "0"}
        procs.append(subprocess.Popen(
            [sys.executable, str(HERE / "chip_smoke.py"), COMPOSED_CHILD,
             str(tmp), kind], cwd=HERE, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return procs


def finish_world(procs: list, tmp: Path, what: str,
                 timeout: float = 900) -> list[dict]:
    """Wait for a world's ranks (within ``timeout`` s) and return each
    rank's records; a rank that failed fails the phase."""
    logs = []
    try:
        for p in procs:
            log, _ = p.communicate(timeout=timeout)
            logs.append(log)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode:
            fail(f"{what} rank {r} exited {p.returncode}:\n{log[-4000:]}")
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(len(procs))]


def _composed_leg(ranks: list[dict], name: str, want: dict, what: str,
                  agree, extra: dict | None = None, budget=None) -> dict:
    """A four-rank leg's checks: 4 finite losses, equal on the ranks of
    each group ``agree`` lists (every rank of a leg without data
    replicas), the same launches on every rank, a rank's launches a step
    ``want`` plus ``extra`` (every other counted kernel 0); prints the
    allocator's peak a rank beside ``budget`` (a ``format_budget`` line).
    Returns rank 0's record."""
    import numpy as np

    got = [r[name] for r in ranks]
    losses = got[0]["losses"]
    counts = {k: n for k, n in got[0]["counts"].items() if n}
    want = {k: n for k, n in _step_counts(want, **(extra or {})).items()
            if n}
    groups_agree = all(got[a]["losses"] == got[b]["losses"]
                       for group in agree for a in group for b in group)
    if (len(losses) != 4 or any(not np.isfinite(g["losses"]).all()
                                for g in got) or not groups_agree
            or any(g["counts"] != got[0]["counts"] for g in got)
            or counts != want):
        fail(f"{name}: losses {[g['losses'] for g in got]}, launches a rank "
             f"{[g['counts'] for g in got]} (want {want})")
    peaks = [round(g["peak"] / 1e9, 3) for g in got]
    print(f"  {name} ({what}): 4 steps, losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, equal on the ranks of {agree}; launches a "
          f"rank {want} over {got[0]['leaves']} leaves a rank; allocator "
          f"peak a rank {peaks} GB"
          + (f"; budget {budget}" if budget else "")
          + f"; {got[0]['seconds']:.1f} s")
    return got[0]


def _without(argv, *flags) -> list:
    """``argv`` without each of ``flags`` and the value after it."""
    out = list(argv)
    for flag in flags:
        i = out.index(flag)
        del out[i:i + 2]
    return out


def _composed_budget(plan, zero1: bool, *, bf16: bool) -> str:
    """``train_state_budget``'s line for GPT-2 124M at batch 8 x S 1024 a
    replica under ``plan`` (data, fsdp, tensor) with the CLI's fused
    AdamW (and ZeRO-1)."""
    import types

    import torch

    from tpudist_torch.memory import format_budget, train_state_budget
    from tpudist_torch.models.gpt2 import GPT2
    from tpudist_torch.optim import make_optimizer, shard_state

    data, fsdp, tensor = plan
    dtype = torch.bfloat16 if bf16 else torch.float32
    tx = make_optimizer(3e-4, fused=True, weight_decay=0.1, clip_norm=1.0,
                        compute_dtype=dtype if bf16 else None)
    if zero1:
        tx = shard_state(tx, world=data, rank=0)
    report = train_state_budget(
        lambda d: GPT2(dtype=dtype, attn_impl="vmem", device=d), tx,
        batch=8 * data * fsdp, seq=1024, world_size=data * fsdp * tensor,
        plan=types.SimpleNamespace(data=data, fsdp=fsdp, tensor=tensor),
        hbm_budget_bytes=80 * 10 ** 9)
    return format_budget(report)


def composed_phases(smi: str, tmp: Path, ranks: list[dict]) -> None:
    """Phases 67-69 (module docstring): the four-rank world's checks and
    the one-rank float32 runs they are held against."""
    import torch

    from tpudist_torch.data.lm import TokenWindowLoader

    t0 = time.perf_counter()
    legs = {leg["name"]: leg for leg in _composed_legs(tmp)}
    depth = 12
    ln = {"layernorm_fwd": 2 * depth + 1, "layernorm_bwd": 2 * depth + 1,
          "layernorm_bwd_reduce": 2 * depth + 1}
    every = [[0, 1, 2, 3]]
    print("== 67. four ranks on one card (gloo over CUDA tensors): "
          "train_gpt2 --fsdp 2 --tensor 2 --fused all, GPT-2 124M, S 1024, "
          "batch 8 a replica")
    # a rank's eval batches (one replica of the val windows) and decode
    argv = legs["fsdp_bf16"]["argv"]
    flag = lambda f: argv[argv.index(f) + 1]
    nb = len(TokenWindowLoader(flag("--val_tokens"), int(flag("--batch_size")),
                               int(flag("--seq_len")), shuffle=False,
                               drop_remainder=False, num_replicas=2, rank=0))
    fsdp = _composed_leg(
        ranks, "fsdp_bf16",
        {**ln, "vmem_attention_fwd": depth, "vmem_attention_bwd": depth,
         "fused_adamw": 2, "fused_adamw_leaves": 148},
        "bf16, --attn auto, then --eval and --generate 32",
        [[0, 1], [2, 3]],
        extra={"layernorm_fwd": (2 * depth + 1) * nb,
               "vmem_attention_fwd": depth * nb,
               "fused_decode_attention": depth * NEW},
        budget=_composed_budget((1, 2, 2), False, bf16=True))
    said = [ln_ for ln_ in fsdp["printed"].splitlines()
            if ln_.startswith(("generated tokens", "val_loss"))]
    print(f"    rank 0 printed {said}")
    if len(said) != 2:
        fail(f"fsdp_bf16: --eval and --generate printed {said}")
    # float32: FSDP's shards and the replicated leaves are one mix (no
    # copy), one AdamW launch
    f32_step = {**ln, "vmem_attention_fwd": depth,
                "vmem_attention_bwd": depth, "fused_adamw": 1,
                "fused_adamw_leaves": 148}
    _composed_leg(ranks, "fsdp_f32", f32_step, "f32, --attn vmem",
                  [[0, 1], [2, 3]],
                  budget=_composed_budget((1, 2, 2), False, bf16=False))
    # one rank takes both replicas' rows a step: the same windows
    one_argv = _without(legs["tp_f32"]["argv"], "--tensor")
    i = one_argv.index("--batch_size") + 1
    one_argv[i] = str(2 * int(one_argv[i]))
    (state, one_losses), _ = _one_rank("train_gpt2", one_argv)
    whole = {k: v.float().cpu() for k, v in state.params().items()}
    del state
    torch.cuda.empty_cache()
    _against_one_rank("fsdp_f32 (--fsdp 2", torch.load(tmp / "fsdp_f32.pt"),
                      whole, ranks[0]["fsdp_f32"]["losses"], one_losses,
                      loss_bar=LOSS_BAR, param_bar=PARAM_BAR, peak_lr=3e-4)

    print("== 68. the same world: train_gpt2 --tensor 2 --shard_opt_state "
          "--fused all (data 2 x tensor 2)")
    _composed_leg(
        ranks, "zero_bf16",
        {**ln, "vmem_attention_fwd": depth, "vmem_attention_bwd": depth,
         "fused_adamw": 1, "fused_adamw_leaves": 148},
        "bf16, --attn auto", [[0, 1], [2, 3]],
        budget=_composed_budget((2, 1, 2), True, bf16=True))
    for name in ("zero_f32", "tp_f32"):
        _composed_leg(ranks, name, f32_step, "f32, --attn vmem",
                      [[0, 1], [2, 3]],
                      budget=_composed_budget((2, 1, 2), name == "zero_f32",
                                              bf16=False))
    zero, rep = torch.load(tmp / "zero_f32.pt"), torch.load(tmp / "tp_f32.pt")
    equal = (ranks[0]["zero_f32"]["losses"] == ranks[0]["tp_f32"]["losses"]
             and zero.keys() == rep.keys()
             and all(torch.equal(zero[k], rep[k]) for k in rep))
    print(f"    zero_f32 against tp_f32 (the same world without "
          f"--shard_opt_state): losses and parameters bit-equal: {equal}")
    if not equal:
        fail("ZeRO-1 under tensor is not the replicated step bit for bit")
    _against_one_rank("zero_f32 (data 2", zero, whole,
                      ranks[0]["zero_f32"]["losses"], one_losses,
                      loss_bar=LOSS_BAR, param_bar=PARAM_BAR, peak_lr=3e-4)

    print("== 69. the same world: seq x tensor (--cp 2 --tensor 2)")
    _composed_leg(
        ranks, "cp_flash_bf16",
        {**ln, "flash_attention_fwd": depth, "flash_attention_bwd": depth,
         "fused_adamw": 1, "fused_adamw_leaves": 148},
        "--attn ulysses_flash, S 4096, batch 4, --chunked_ce 256, bf16: "
        "flash on 3 heads a rank", every)
    # the ring's chunk products are plain matrix products (no kernel)
    _composed_leg(ranks, "cp_ring_f32",
                  {**ln, "fused_adamw": 1, "fused_adamw_leaves": 148},
                  "--attn ring, S 1024, f32", every)
    ring_argv = _without(legs["cp_ring_f32"]["argv"], "--cp", "--tensor")
    (state, ring_losses), _ = _one_rank("train_gpt2", ring_argv)
    ring_whole = {k: v.float().cpu() for k, v in state.params().items()}
    del state
    torch.cuda.empty_cache()
    _against_one_rank("cp_ring_f32 (--cp 2", torch.load(
        tmp / "cp_ring_f32.pt"), ring_whole,
        ranks[0]["cp_ring_f32"]["losses"], ring_losses, loss_bar=LOSS_BAR,
        param_bar=PARAM_BAR, peak_lr=3e-4)
    # ulysses_flash takes the kernel by length: vmem at S 512
    _composed_leg(
        ranks, "bert_cp_bf16",
        {"vmem_attention_fwd": depth, "vmem_attention_bwd": depth},
        "train_bert --tensor 2 --cp 2 --attn ulysses_flash --chunked_ce 128, "
        "bert-base, S 512, batch 16, bf16", every)
    print(f"  phases 67-69: {time.perf_counter() - t0:.1f} s here (the "
          "one-rank f32 runs); the world's runs " + ", ".join(
              f"{n} {ranks[0][n]['seconds']:.1f} s" for n in legs)
          + f"  [{smi}]")



def _pipe_legs(tmp: Path, world: int) -> list[dict]:
    """Phase 70's (``world`` 2) or 71's (4) legs, in order; a leg with
    ``trim`` copies that checkpoint without its last step (rank 0) before
    the legs after it."""
    common = ["--no_profiler", "--log_dir", str(tmp), "--warmup_steps", "2",
              "--total_steps", "4", "--seq_len", "1024", "--batch_size", "8",
              "--tokens", str(tmp / "ptext.bin"), "--fused", "optimizer",
              "--num_micro", "4"]
    if world == 2:
        p2 = [*common, "--pipe", "2"]
        ck = str(tmp / "pck")
        return [
            dict(name="gpipe_bf16", argv=[*p2, "--bf16", "--JobID", "P70G"]),
            dict(name="f1b_bf16", argv=[*p2, "--bf16", "--pipe_schedule",
                                        "1f1b", "--JobID", "P70O"]),
            dict(name="gpipe_f32", gather=True,
                 argv=[*p2, "--checkpoint_dir", ck, "--checkpoint_every",
                       "2", "--JobID", "P70F"]),
            dict(name="f1b_f32", gather=True,
                 argv=[*p2, "--pipe_schedule", "1f1b", "--JobID", "P70E"]),
            dict(name="amp", nan=PIPE_NAN,
                 argv=[*p2, "--amp", "--pipe_schedule", "1f1b", "--JobID",
                       "P70A"]),
            dict(name="resume_f32", gather=True, trim=(ck, ck + "2", 4),
                 argv=[*p2, "--checkpoint_dir", ck + "2", "--JobID",
                       "P70R"]),
        ]
    return [
        dict(name="pt_f32", gather=True,
             argv=[*common, "--pipe", "2", "--tensor", "2", "--pipe_schedule",
                   "1f1b", "--JobID", "P71T"]),
        dict(name="dp_f32", gather=True,
             argv=[*_without(common, "--tokens"), "--tokens",
                   str(tmp / "pdtext.bin"), "--pipe", "2", "--pipe_schedule",
                   "1f1b", "--JobID", "P71D"]),
        dict(name="p4_bf16",
             argv=[*common, "--pipe", "4", "--bf16", "--JobID", "P71P"]),
        *_moe_legs(tmp),
    ]


def _pipe_budget(data: int, pipe: int, tensor: int, *, bf16: bool) -> str:
    """``train_state_budget``'s line for GPT-2 124M (the dense attention)
    at batch 8 x S 1024 a replica over ``data x pipe x tensor`` with the
    CLI's fused AdamW."""
    import types

    import torch

    from tpudist_torch.memory import format_budget, train_state_budget
    from tpudist_torch.models.gpt2 import GPT2
    from tpudist_torch.optim import make_optimizer

    dtype = torch.bfloat16 if bf16 else torch.float32
    tx = make_optimizer(3e-4, fused=True, weight_decay=0.1, clip_norm=1.0,
                        compute_dtype=dtype if bf16 else None)
    report = train_state_budget(
        lambda d: GPT2(dtype=dtype, attn_impl="xla", device=d), tx,
        batch=8 * data, seq=1024, world_size=data * pipe * tensor,
        plan=types.SimpleNamespace(data=data, fsdp=1, tensor=tensor,
                                   pipe=pipe),
        hbm_budget_bytes=80 * 10 ** 9)
    return format_budget(report)


def _one_rank_xla(tmp: Path, tokens: Path, accum: int):
    """The one-rank f32 run a pipelined f32 leg is held against: the
    unpipelined GPT-2 on the same windows, ``--attn xla`` (the blocks'
    attention), ``--remat full``, ``--grad_accum accum`` (both replicas'
    rows a step at 2), with the plain AdamW (phase 1 holds the kernel
    bit-equal to it), so the legs' fused AdamW on a stage's table is held
    against the plain step. Returns ``(losses, params)``."""
    import torch

    argv = ["--no_profiler", "--log_dir", str(tmp), "--warmup_steps", "2",
            "--total_steps", "4", "--seq_len", "1024", "--batch_size", "8",
            "--tokens", str(tokens), "--attn", "xla", "--remat", "full",
            "--grad_accum", str(accum), "--JobID", f"P1{accum}"]
    (state, losses), _ = _one_rank("train_gpt2", argv)
    params = {k: v.float().cpu() for k, v in state.params().items()}
    del state
    torch.cuda.empty_cache()
    return losses, params


def pipe_phases(smi: str) -> None:
    """Phases 70-71 (module docstring)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        worlds, procs = {}, {}
        for w in (2, 4):
            (tmp / f"w{w}").mkdir()
            procs[w] = start_composed_world(tmp / f"w{w}", "pipe", w)
        try:
            # the one-rank runs beside the two worlds, on their windows
            one = {accum: _one_rank_xla(tmp, tmp / "w2" / tok, accum)
                   for accum, tok in ((1, "ptext.bin"), (2, "pdtext.bin"))}
            moe_one = {accum: _one_rank_moe(tmp, tmp / "w2" / tok, accum)
                       for accum, tok in ((1, "ptext.bin"),
                                          (2, "pdtext.bin"))}
            one_s = time.perf_counter() - t0
            for w in (2, 4):
                worlds[w] = finish_world(procs[w], tmp / f"w{w}",
                                         f"pipe world of {w}")
        finally:
            for ps in procs.values():
                for p in ps:
                    if p.poll() is None:
                        p.kill()
        worlds_s = time.perf_counter() - t0
        _pipe_two(smi, tmp / "w2", worlds[2], one[1])
        _pipe_four(smi, tmp / "w4", worlds[4], one)
        _moe_world(smi, tmp / "w4", worlds[4], moe_one)
    print(f"  phases 70-71, 75: {time.perf_counter() - t0:.1f} s (the two worlds "
          f"done {worlds_s:.1f} s after their start, the one-rank runs "
          f"{one_s:.1f} s)  [{smi}]")


def _pipe_replicas(ranks: list[dict]) -> None:
    """Fail unless, after every leg, each rank's copies of the leaves the
    stages replicate (``wte``, ``wpe``, ``ln_f``) were bit-equal to those
    of every rank of its pipe group."""
    legs = [n for n, rec in ranks[0].items() if "replicas_agree" in rec]
    bad = [(r, n) for r, rec in enumerate(ranks) for n in legs
           if not rec[n]["replicas_agree"]]
    print(f"    the stages' copies of wte, wpe and ln_f bit-equal over the "
          f"pipe group after every leg ({', '.join(legs)}): {not bad}")
    if bad:
        fail(f"the stages' replicated leaves differ (rank, leg): {bad}")


def _pipe_counts(leaves: int, steps: int = 4, check: bool = False) -> dict:
    out = {"fused_adamw": steps, "fused_adamw_leaves": leaves * steps}
    if check:
        out["fused_adamw_check"] = steps
    return out


def _pipe_two(smi: str, tmp: Path, ranks: list[dict], one) -> None:
    """Phase 70's checks (module docstring)."""
    import torch

    print("== 70. two ranks on one card (gloo over CUDA tensors): "
          "train_gpt2 --pipe 2 --num_micro 4 --fused optimizer, GPT-2 124M, "
          "S 1024, batch 8")
    legs = {}
    for name, what in (("gpipe_bf16", "bf16, GPipe"), ("f1b_bf16",
                                                       "bf16, 1F1B"),
                       ("gpipe_f32", "f32, GPipe, checkpoints at 2 and 4"),
                       ("f1b_f32", "f32, 1F1B")):
        legs[name] = _world_leg(ranks, name, _pipe_counts(76), what)
    for dtype in ("bf16", "f32"):
        a, b = legs[f"gpipe_{dtype}"], legs[f"f1b_{dtype}"]
        rel = max(abs(x - y) / abs(y) for x, y in zip(b["losses"],
                                                      a["losses"]))
        peaks = [[round(r[n]["peak"] / 1e9, 3) for r in ranks]
                 for n in (f"gpipe_{dtype}", f"f1b_{dtype}")]
        print(f"  {dtype}: 1F1B against GPipe: first losses bit-equal "
              f"{a['losses'][0] == b['losses'][0]}, max rel {rel:.3e}; "
              f"allocator peak a rank GPipe {peaks[0]} GB, 1F1B {peaks[1]} "
              f"GB; budget {_pipe_budget(1, 2, 1, bf16=dtype == 'bf16')}")
        if a["losses"][0] != b["losses"][0] or (
                dtype == "f32" and rel > LOSS_BAR):
            fail(f"{dtype}: 1F1B and GPipe disagree")
        if max(peaks[1]) >= min(peaks[0]):
            fail(f"{dtype}: 1F1B's peak {peaks[1]} is not under GPipe's "
                 f"{peaks[0]}")
    gpipe, f1b = (torch.load(tmp / f"{n}.pt") for n in ("gpipe_f32",
                                                         "f1b_f32"))
    gap = max(float((gpipe[k] - f1b[k]).abs().max()) for k in gpipe)
    print(f"    f32 parameters, 1F1B against GPipe: max abs {gap:.3e} [bar "
          f"{PARAM_BAR:g}]")
    if gap > PARAM_BAR or gpipe.keys() != f1b.keys():
        fail("f32 1F1B and GPipe parameters disagree")
    one_losses, whole = one
    for name in ("gpipe_f32", "f1b_f32"):
        _against_one_rank(name, torch.load(tmp / f"{name}.pt"), whole,
                          ranks[0][name]["losses"], one_losses,
                          loss_bar=LOSS_BAR, param_bar=PARAM_BAR,
                          peak_lr=3e-4, how="(--pipe 2)")
    _world_leg(ranks, "amp", _pipe_counts(76, check=True),
               f"bf16 --amp, 1F1B, a NaN in stage 1's {PIPE_NAN[0]} "
               f"gradient at step {PIPE_NAN[1]}")
    skipped = [r["amp"]["skipped"] for r in ranks]
    print(f"    skipped steps a rank {skipped}")
    if skipped != [1, 1]:
        fail(f"--amp: skipped {skipped}, want one step on both ranks")
    res = [r["resume_f32"] for r in ranks]
    want = ranks[0]["gpipe_f32"]["losses"][2:]
    resumed = torch.load(tmp / "resume_f32.pt")
    same = (all(r["losses"] == want for r in res)
            and resumed.keys() == gpipe.keys()
            and all(torch.equal(resumed[k], gpipe[k]) for k in gpipe))
    counts = {k: n for k, n in res[0]["counts"].items() if n}
    print(f"  resume_f32 (from gpipe_f32's step 2): steps 3-4 losses "
          f"{res[0]['losses']}, losses and parameters bit-equal to the "
          f"uninterrupted run: {same}; launches a rank {counts}; "
          f"{res[0]['seconds']:.1f} s")
    if not same or counts != _pipe_counts(76, steps=2):
        fail("the resumed --pipe 2 run is not the uninterrupted one")
    _pipe_replicas(ranks)


def _pipe_four(smi: str, tmp: Path, ranks: list[dict], one: dict) -> None:
    """Phase 71's checks (module docstring)."""
    import torch

    print("== 71. four ranks on one card: --pipe 2 --tensor 2 and data 2 x "
          "pipe 2 (f32, 1F1B), --pipe 4 (bf16, GPipe)")
    every = [[0, 1, 2, 3]]
    for name, leaves, what, plan, accum in (
            ("pt_f32", 76, "--pipe 2 --tensor 2, f32, 1F1B", (1, 2, 2), 1),
            ("dp_f32", 76, "data 2 x pipe 2, f32, 1F1B", (2, 2, 1), 2)):
        _composed_leg(ranks, name, {}, what, every,
                      extra=_pipe_counts(leaves),
                      budget=_pipe_budget(*plan, bf16=False))
        one_losses, whole = one[accum]
        _against_one_rank(name, torch.load(tmp / f"{name}.pt"), whole,
                          ranks[0][name]["losses"], one_losses,
                          loss_bar=LOSS_BAR, param_bar=PARAM_BAR,
                          peak_lr=3e-4, how=f"({what})")
    _composed_leg(ranks, "p4_bf16", {}, "--pipe 4, bf16, GPipe", every,
                  extra=_pipe_counts(40),
                  budget=_pipe_budget(1, 4, 1, bf16=True))
    _pipe_replicas(ranks)


# -- the experts (phases 72-75) -----------------------------------------------

#: GPT-2 124M with ``--experts 8``: 6 of 12 blocks swap mlp_fc / mlp_proj
#: (4 leaves) for the router and two stacked expert leaves
MOE_LEAVES = 148 - 6 * 4 + 6 * 3
#: Mixtral-8x7B's width (``models.llama.mixtral_8x7b``'s geometry), every
#: block 8 experts top-2; phase 74 picks the depth the card holds
MIXTRAL_WIDTH = ["--arch", "llama", "--hidden_dim", "4096", "--num_heads",
                 "32", "--num_kv_heads", "8", "--ffn_dim", "14336",
                 "--vocab_size", "32000", "--rope_theta", "1000000",
                 "--experts", "8"]
#: the f32 agreement runs of the MoE paths (phases 72 and 75) step with
#: sgd: an MoE routes discontinuously, and Adam turns a gradient within
#: rounding of zero (an expert's row that few tokens reach) into a step of
#: up to lr either way, as it does the qkv key bias; sgd moves each
#: parameter by lr times its gradient, so phase 15's bars hold the
#: gradients themselves (lr 0.1: a wrong gradient moves a parameter by
#: ~1e-3, a rounding difference by ~1e-9)
MOE_F32 = ["--optimizer", "sgd", "--lr", "0.1"]
#: a GPT-2 124M step's launches under --fused all --attn auto (phase 14's),
#: which the MoE blocks leave as they are
GPT2_STEP = lambda depth, n_leaves: {  # noqa: E731
    "layernorm_fwd": 2 * depth + 1, "layernorm_bwd": 2 * depth + 1,
    "layernorm_bwd_reduce": 2 * depth + 1, "vmem_attention_fwd": depth,
    "vmem_attention_bwd": depth, "flash_attention_fwd": 0,
    "flash_attention_bwd": 0, "fused_adamw": 1, "fused_adamw_leaves": n_leaves}


def moe_budget(flags, world: int = 1, *, zero1_world: int = 0) -> dict:
    """``train_state_budget``'s report for ``train_gpt2 flags`` over
    ``world`` ranks (the expert axis by the CLI's rule), on the meta
    device: the ``tools/torch_world_run.py budget`` line's report."""
    import types

    import torch

    from tpudist_torch import train_gpt2 as TG
    from tpudist_torch.memory import train_state_budget
    from tpudist_torch.optim import make_optimizer, shard_state

    _, args = TG.parse_args(list(flags))
    expert = TG.expert_axis(args, world)
    data = world // (args.tensor * expert)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    attn = TG.resolve_attn(args.attn, args.seq_len, torch.device("cuda"))
    tx = make_optimizer(3e-4, fused=args.fused in ("optimizer", "all"),
                        weight_decay=0.1, clip_norm=1.0,
                        compute_dtype=dtype if args.bf16 else None)
    if zero1_world:
        tx = shard_state(tx, world=zero1_world, rank=0)
    return train_state_budget(
        lambda d: TG.build_model(args, dtype, attn, d, None), tx,
        batch=args.batch_size * data, seq=args.seq_len, world_size=world,
        remat_policy=args.remat_policy or "none",
        plan=types.SimpleNamespace(data=data, fsdp=1, tensor=args.tensor,
                                   pipe=1, expert=expert))


def router_shares(model) -> tuple[float, float]:
    """The routed and dropped shares of the (token, choice) pairs of the
    model's last forward, over its MoE layers."""
    from tpudist_torch.parallel.ep import moe_layers

    dropped = [float(m.stats()["dropped"]) for m in moe_layers(model)]
    d = sum(dropped) / len(dropped)
    return 1.0 - d, d


def moe_phases(smi: str, dev) -> None:
    """Phases 72-74 (module docstring); 75 runs in phase 71's world."""
    moe_training_phase(smi)
    moe_serving_phase(smi, dev)
    mixtral_phase(smi)


def moe_training_phase(smi: str) -> None:
    """Phase 72 (module docstring)."""
    import torch

    from tpudist_torch.memory import format_budget

    t0 = time.perf_counter()
    print("== 72. MoE GPT-2 124M (--experts 8: blocks 1, 3, .., 11 route "
          "top-2 over 8 GELU experts, capacity 1.25), bf16, --fused all "
          "--attn auto, batch 8, S 1024, 16 steps under DDP (NCCL), einsum "
          "and index dispatch; --generate 32 after the index run")
    flags = ["--bf16", "--fused", "all", "--attn", "auto", "--experts", "8"]
    budget = moe_budget([*flags, "--batch_size", "8"])
    for impl in ("einsum", "index"):
        legs: dict = {}
        gen = (["--generate", str(NEW), "--temperature", "0"]
               if impl == "index" else [])
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with (leg_counts(legs) if gen else contextlib.nullcontext()):
            run = trained_cli([*flags, "--moe_dispatch", impl, *gen],
                              batch=8, seq=1024, job=f"Moe{impl[:2]}",
                              smi=smi, want=GPT2_STEP, leaves=MOE_LEAVES,
                              legs=legs if gen else None)
        peak = legs.get("peak_gb", torch.cuda.max_memory_allocated() / 1e9)
        print(f"  {impl}: step at g_step 15 {STEP_MS[f'Moe{impl[:2]}']:.2f} "
              f"ms; allocator peak {peak:.3f} GB (training); "
              f"train_state_budget {format_budget(budget)}  [{smi}]")
        if not gen:
            routed, dropped = router_shares(run["model"])
            print(f"  the last step's (token, choice) pairs over the 6 MoE "
                  f"layers: routed {routed:.4f}, dropped {dropped:.4f}")
        else:
            g = legs.get("generate", {})
            print(f"  --generate {NEW}: launches {g} in "
                  f"{legs.get('generate_s', 0):.3f} s  [{smi}]")
            if g.get("fused_decode_attention") != 12 * NEW:
                fail(f"--generate launched the contiguous decode kernel "
                     f"{g.get('fused_decode_attention')} times, want 12 x "
                     f"{NEW}")
        del run
    torch.cuda.empty_cache()

    print("== 72. f32 at depth 2 (block 1 MoE), 4 sgd steps (lr 0.1): "
          "--fused ln --attn vmem against --fused none --attn xla (index), "
          "and the einsum dispatch against the index dispatch (kernels)")
    runner = gpt2_runner(8, 1024, extra=["--depth", "2", "--experts", "8",
                                         *MOE_F32])
    kernel = ["--fused", "ln", "--attn", "vmem"]
    unused = {"flash_attention_fwd", "flash_attention_bwd",
              "fused_adamw_check", "fused_adamw",
              "fused_adamw_leaves"} | WIDE_LN
    runs = {}
    with tempfile.TemporaryDirectory() as log_dir:
        for name, flags_ in (
                ("kernels", [*kernel, "--moe_dispatch", "index"]),
                ("plain", ["--fused", "none", "--attn", "xla",
                           "--moe_dispatch", "index"]),
                ("einsum", [*kernel, "--moe_dispatch", "einsum"])):
            for mod in counted_modules():
                mod.reset_launch_counts()
            st, ls = runner(flags_, log_dir)
            ran = launches()
            used = {k for k, n in ran.items() if n}
            if used != (set() if name == "plain" else set(ran) - unused):
                fail(f"f32 {name}: launches {ran}")
            runs[name] = (ls, {k: v.float().cpu()
                               for k, v in st.params().items()})
            del st
    for name, how in (("plain", "(--fused none --attn xla)"),
                      ("einsum", "(--moe_dispatch einsum)")):
        _against_one_rank("f32 kernels + index", runs["kernels"][1],
                          runs[name][1], runs["kernels"][0], runs[name][0],
                          loss_bar=LOSS_BAR, param_bar=PARAM_BAR,
                          peak_lr=0.1, how=f"against {how}")
    torch.cuda.empty_cache()
    print(f"  phase 72: {time.perf_counter() - t0:.1f} s")


def moe_serving_phase(smi: str, dev) -> None:
    """Phase 73 (module docstring)."""
    import torch

    from tpudist_torch.models.gpt2 import GPT2
    from tpudist_torch.ops import decode as D
    from tpudist_torch.ops import decode_bench as DB
    from tpudist_torch.serve import ServeEngine

    t0 = time.perf_counter()
    print("== 73. MoE GPT-2 124M served: ServeEngine(paged=True, block 32, "
          "8 slots), phase 4's 8 requests x 32 tokens, bf16, einsum and "
          "index; f32 greedy streams of both; main --serve --serve_experts 8")
    prompts = DB.smoke_prompts(SEED)
    sampling = [dict(temperature=0.0)] * 6 + [
        dict(temperature=1.0, top_k=50, top_p=0.95)] * 2
    streams = {}
    for dtype in (torch.bfloat16, torch.float32):
        for impl in ("einsum", "index"):
            model = GPT2(dtype=dtype, attn_impl="fused", device="cuda",
                         seed=SEED, num_experts=8, moe_dispatch=impl)
            eng = ServeEngine(model, max_slots=8, paged=True, block_size=32,
                              seed=SEED)
            warm = eng.submit(prompts[0][:20], 4)
            eng.run()
            if len(eng.result(warm)) != 4:
                fail("warm-up request did not complete")
            eng.reset_stats()
            steps0 = eng.decode_steps
            opts = sampling if dtype == torch.bfloat16 else [
                dict(temperature=0.0)] * len(prompts)
            D.reset_launch_counts()
            torch.cuda.synchronize()
            rids = [eng.submit(p, NEW, **o) for p, o in zip(prompts, opts)]
            out = eng.run()
            torch.cuda.synchronize()
            paged = D.launch_counts["paged_decode_attention"]
            steps = eng.decode_steps - steps0
            streams[dtype, impl] = [out[r] for r in rids]
            if any(len(s) != NEW for s in streams[dtype, impl]):
                fail(f"{impl}: a request ended short")
            if paged != model.depth * steps:
                fail(f"{impl}: paged kernel launched {paged} times for "
                     f"{steps} decode steps x {model.depth} layers")
            snap = eng.stats.snapshot()
            print(f"  {str(dtype)[6:]} {impl}: {steps} decode steps, paged "
                  f"kernel launches {paged} (= {model.depth} x {steps}); "
                  f"TTFT p50 {snap['ttft_p50']} s, TPOT p50 "
                  f"{snap['tpot_p50']} s p95 {snap['tpot_p95']} s, "
                  f"{snap['tokens_per_sec']} tok/s  [{smi}]")
            del model, eng
            torch.cuda.empty_cache()
    bf = [a == b for a, b in zip(streams[torch.bfloat16, "einsum"],
                                 streams[torch.bfloat16, "index"])]
    same = (streams[torch.float32, "einsum"]
            == streams[torch.float32, "index"])
    print(f"  bf16 streams equal between the dispatches: {sum(bf[:6])} of 6 "
          f"greedy, {sum(bf[6:])} of 2 sampled (the combine rounds its sum "
          f"once under einsum, once a choice under index); f32 greedy "
          f"streams equal: {same}")
    if not same:
        fail("the f32 greedy streams of the two dispatches differ")
    printed = {}
    with tempfile.TemporaryDirectory() as tmp:
        for impl in ("einsum", "index"):
            D.reset_launch_counts()
            _, out = _one_rank("main", [
                "--serve", "--serve_experts", "8", "--serve_moe_dispatch",
                impl, "--log_dir", tmp])
            printed[impl] = [ln for ln in out.splitlines()
                             if ln.startswith("request ")]
            # the demo's contiguous engine decodes per-row cursors on the
            # dense path, as the reference's does (phase 60)
            print(f"  main --serve --serve_experts 8 --serve_moe_dispatch "
                  f"{impl}: {len(printed[impl])} requests done; decode "
                  f"launches {dict(D.launch_counts)} (the dense path)")
    if not printed["einsum"] or printed["einsum"] != printed["index"]:
        fail(f"main --serve --serve_experts: {printed}")
    print(f"  main --serve --serve_experts 8: the same output under both "
          f"dispatches: True")
    print(f"  phase 73: {time.perf_counter() - t0:.1f} s")


def mixtral_phase(smi: str) -> None:
    """Phase 74 (module docstring)."""
    import torch

    from tpudist_torch.memory import format_budget

    t0 = time.perf_counter()
    flags = [*MIXTRAL_WIDTH, "--bf16", "--fused", "all", "--attn", "auto",
             "--chunked_ce", "256"]
    card = torch.cuda.get_device_properties(0).total_memory
    depth = 1
    for d in (2, 1):
        report = moe_budget([*flags, "--depth", str(d), "--batch_size", "2",
                             "--seq_len", "2048"])
        if report["per_chip_total_bytes"] <= 0.9 * card:
            depth = d
            break
    print(f"== 74. Mixtral-8x7B width at depth {depth} (d 4096, GQA 32/8, 8 "
          f"SwiGLU experts of 14336 top-2 every block, vocab 32000, theta "
          f"1e6), bf16, --fused all --attn auto --chunked_ce 256, batch 2, "
          f"S 2048, 16 steps under DDP (NCCL); train_state_budget "
          f"{format_budget(report)}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = trained_cli(
        [*flags, "--depth", str(depth)], batch=2, seq=2048, job="Mixtral",
        smi=smi, leaves=3 + 10 * depth, want=lambda d, n_leaves: {
            "layernorm_fwd": 0, "layernorm_bwd": 0,
            "layernorm_fwd_wide": 2 * d + 1, "layernorm_bwd_wide": 2 * d + 1,
            "layernorm_bwd_reduce": 2 * d + 1, "vmem_attention_fwd": 0,
            "vmem_attention_bwd": 0, "flash_attention_fwd": d,
            "flash_attention_bwd": d, "fused_adamw": 1,
            "fused_adamw_leaves": n_leaves})
    n = sum(p.numel() for p in run["model"].parameters())
    routed, dropped = router_shares(run["model"])
    del run
    torch.cuda.empty_cache()
    print(f"  {n:,} parameters; the last step routed {routed:.4f} / dropped "
          f"{dropped:.4f}; allocator peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB against the "
          f"budget's {report['per_chip_total_bytes'] / 1e9:.2f} GB  [{smi}]")
    print(f"  phase 74: {time.perf_counter() - t0:.1f} s")


def _moe_common(tmp: Path) -> list:
    """Phase 75's flags: GPT-2 124M's width at depth 4 (blocks 1 and 3
    MoE), each block checkpointed and the chunked head (the four ranks
    hold their legs beside phase 70's world), 4 steps of batch 8 x S
    1024 a replica; the f32 legs on sgd (:data:`MOE_F32`)."""
    return ["--no_profiler", "--log_dir", str(tmp), "--warmup_steps", "2",
            "--total_steps", "4", "--seq_len", "1024", "--batch_size", "8",
            "--depth", "4", "--experts", "8", "--remat_policy", "full",
            "--chunked_ce", "256"]


#: phase 75's f32 legs and their one-rank runs
MOE_F32_LEG = ["--attn", "vmem", "--fused", "ln", *MOE_F32]


def _moe_legs(tmp: Path) -> list[dict]:
    """Phase 75's legs in phase 71's four-rank world (module docstring),
    ``--expert_axis 2``."""
    common = [*_moe_common(tmp), "--expert_axis", "2"]
    dp = [*common, "--tokens", str(tmp / "pdtext.bin")]
    ck = str(tmp / "eck")
    zero = [*dp, "--bf16", "--attn", "auto", "--fused", "all",
            "--moe_dispatch", "index", "--shard_opt_state"]
    return [
        dict(name="moe_dp_f32", gather=True,
             argv=[*dp, *MOE_F32_LEG, "--moe_dispatch", "index", "--JobID",
                   "E75D"]),
        dict(name="moe_tp_f32", gather=True,
             argv=[*common, "--tokens", str(tmp / "ptext.bin"), "--tensor",
                   "2", *MOE_F32_LEG, "--moe_dispatch", "einsum", "--JobID",
                   "E75T"]),
        dict(name="moe_zero_bf16", gather=True,
             argv=[*zero, "--checkpoint_dir", ck, "--checkpoint_every", "2",
                   "--JobID", "E75Z"]),
        dict(name="moe_resume_bf16", gather=True, trim=(ck, ck + "2", 4),
             argv=[*zero, "--checkpoint_dir", ck + "2", "--JobID", "E75R"]),
    ]


def _one_rank_moe(tmp: Path, tokens: Path, accum: int):
    """The one-rank f32 run an expert-axis leg is held against: the same
    model and flags on the same windows, the einsum dispatch, no expert
    axis, ``--grad_accum accum`` (both replicas' rows a step at 2).
    Returns ``(losses, params)``."""
    import torch

    argv = [*_moe_common(tmp), "--tokens", str(tokens), *MOE_F32_LEG,
            "--moe_dispatch", "einsum", "--grad_accum", str(accum),
            "--JobID", f"E1{accum}"]
    (state, losses), _ = _one_rank("train_gpt2", argv)
    params = {k: v.float().cpu() for k, v in state.params().items()}
    del state
    torch.cuda.empty_cache()
    return losses, params


def _moe_world(smi: str, tmp: Path, ranks: list[dict], one: dict) -> None:
    """Phase 75's checks (module docstring)."""
    import torch

    from tpudist_torch.memory import format_budget

    print("== 75. the same four ranks: GPT-2 124M width at depth 4 with "
          "--experts 8 --expert_axis 2 --remat_policy full --chunked_ce 256, "
          "data 2 x expert 2 and expert 2 x tensor 2 (f32: --fused ln, 4 sgd "
          "steps; bf16: --fused all)")
    every = [[0, 1, 2, 3]]

    def step(n_leaves):
        # each block's forward runs again in its backward (its LN and
        # attention forwards twice)
        return {**GPT2_STEP(4, n_leaves), "layernorm_fwd": 4 * 4 + 1,
                "vmem_attention_fwd": 2 * 4}

    for name, what, key in (
            ("moe_dp_f32", "data 2 x expert 2, index, f32", 2),
            ("moe_tp_f32", "expert 2 x tensor 2, einsum, f32", 1)):
        _composed_leg(ranks, name, {**step(0), "fused_adamw": 0}, what,
                      every)
        one_losses, whole = one[key]
        _against_one_rank(name, torch.load(tmp / f"{name}.pt"), whole,
                          ranks[0][name]["losses"], one_losses,
                          loss_bar=LOSS_BAR, param_bar=PARAM_BAR,
                          peak_lr=0.1, how=f"({what})")
    budget = moe_budget(["--bf16", "--fused", "all", "--attn", "auto",
                         "--experts", "8", "--expert_axis", "2", "--depth",
                         "4", "--batch_size", "8", "--remat_policy", "full"],
                        4, zero1_world=2)
    zero = _composed_leg(ranks, "moe_zero_bf16",
                         step(ranks[0]["moe_zero_bf16"]["leaves"]),
                         "data 2 x expert 2, index, bf16, --shard_opt_state, "
                         "checkpoints at 2 and 4", every,
                         budget=format_budget(budget))
    res = [r["moe_resume_bf16"] for r in ranks]
    whole = torch.load(tmp / "moe_zero_bf16.pt")
    resumed = torch.load(tmp / "moe_resume_bf16.pt")
    same = (all(r["losses"] == zero["losses"][2:] for r in res)
            and resumed.keys() == whole.keys()
            and all(torch.equal(resumed[k], whole[k]) for k in whole))
    counts = {k: n for k, n in res[0]["counts"].items() if n}
    print(f"  moe_resume_bf16 (from moe_zero_bf16's step 2): steps 3-4 "
          f"losses {res[0]['losses']}, losses and parameters bit-equal to "
          f"the uninterrupted run: {same}; launches a rank {counts}; "
          f"{res[0]['seconds']:.1f} s")
    want = {k: n for k, n in _step_counts(
        step(ranks[0]["moe_zero_bf16"]["leaves"]), steps=2).items() if n}
    if not same or counts != want:
        fail("the resumed expert-axis run is not the uninterrupted one")


if __name__ == "__main__":
    if RECOVERY_CHILD in sys.argv:
        sys.exit(recovery_child(sys.argv[1:]))
    if TENSOR_CHILD in sys.argv:
        sys.exit(tensor_child(sys.argv[1:]))
    if COMPOSED_CHILD in sys.argv:
        sys.exit(composed_child(sys.argv[1:]))
    sys.exit(main())
