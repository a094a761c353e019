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
    and its finite check once a step, covering all 161 leaves;
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
    ``ValueError`` (the kernel takes at most 16 query rows).

Phases 22-29 and 31-54 print their seconds.
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
    recovery_phases(smi)
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
    run_report(rows, window, steps=steps, batch=batch, per_row=seq,
               unit="tokens", smi=smi)
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


def launched(cli: str, args, out: Path, launcher=()) -> tuple[str, list]:
    """Run ``tpudist_torch.<cli>`` with ``args`` under ``python -m
    tpudist_torch.launch --nproc_per_node 1 [launcher]`` through
    :func:`recovery_child`; fail unless the launcher exits 0 within 600 s.
    Returns its stdout + stderr and each life's record, generation
    order."""
    out.mkdir()
    cmd = [sys.executable, "-m", "tpudist_torch.launch", "--nproc_per_node",
           "1", "--master_port", str(free_port()), *launcher,
           str(HERE / "chip_smoke.py"), RECOVERY_CHILD, cli, str(out), *args]
    proc = subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        text, _ = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.terminate()  # the launcher forwards it and reaps its world
        text, _ = proc.communicate()
        fail(f"{cli} {' '.join(launcher)}: launcher timed out:\n{text[-4000:]}")
    if proc.returncode != 0:
        fail(f"{cli} {' '.join(launcher)}: launcher exited "
             f"{proc.returncode}:\n{text[-4000:]}")
    lives = [json.loads((out / f"life{g}.json").read_text())
             for g in range(len(list(out.glob("life*.json"))))]
    return text, lives


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


def recovery_phases(smi: str) -> None:
    """Phases 31 and 32 (module docstring)."""
    from tpudist_torch.ops import lm_kernels_bench as LB

    adamw = {"fused_adamw": 1, "fused_adamw_check": 1}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        print("== 31. recovery: ResNet-50 bf16 --fused optimizer --amp "
              "through tpudist_torch.launch, --chaos corrupt@12")
        t0 = time.perf_counter()
        args = ["--model", "resnet50", "--dataset", "synthetic",
                "--synthetic_size", "2048", "--batch_size", "128", "--epochs",
                "1", "--bf16", "--fused", "optimizer", "--amp",
                "--no_profiler", "--checkpoint_every", "4", "--log_dir",
                str(tmp)]
        _, base = launched("main", [*args, "--checkpoint_dir",
                                    str(tmp / "r_full")], tmp / "r_full_out")
        text, lives = launched(
            "main", [*args, "--checkpoint_dir", str(tmp / "r_drill"),
                     "--chaos", "corrupt@12"], tmp / "r_drill_out",
            launcher=["--max_restarts", "1", "--backoff_base", "0"])
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
        print(f"  step-16 checkpoints bit-identical: {n} tensors  "
              f"[{time.perf_counter() - t0:.1f} s]")

        print("== 32. recovery: GPT-2 124M S 1024 bf16 --fused all --amp "
              "through tpudist_torch.launch, --chaos sigterm@8")
        t0 = time.perf_counter()
        tokens = LB.token_file(tmp / "text.bin", 16 * 8 * 1024)
        args = ["--bf16", "--fused", "all", "--amp", "--attn", "auto",
                "--batch_size", "8", "--seq_len", "1024", "--tokens",
                str(tokens), "--no_profiler", "--checkpoint_every", "6",
                "--log_dir", str(tmp)]
        _, base = launched("train_gpt2", [*args, "--checkpoint_dir",
                                          str(tmp / "g_full")],
                           tmp / "g_full_out")
        text, lives = launched(
            "train_gpt2", [*args, "--checkpoint_dir", str(tmp / "g_drill"),
                           "--chaos", "sigterm@8"], tmp / "g_drill_out")
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
        print(f"  step-16 checkpoints bit-identical: {n} tensors  "
              f"[{time.perf_counter() - t0:.1f} s]  [{smi}]")


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
        for job, argv in (
                ("Serve", ["tpudist_torch.serve", "--full", "--bf16", "--paged",
                           "--spec_draft", "4", "--spec_k", "4"]),
                ("Demo", ["tpudist_torch.main", "--serve", "--spec_draft",
                          "1"])):
            t1 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", *argv, "--log_dir", tmp, "--JobID",
                 job], cwd=HERE, env=env, capture_output=True, text=True,
                timeout=300)
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
            print(f"  python -m {' '.join(argv)}: exit 0 in "
                  f"{time.perf_counter() - t1:.1f} s; {len(serve)} serve rows "
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


if __name__ == "__main__":
    if RECOVERY_CHILD in sys.argv:
        sys.exit(recovery_child(sys.argv[1:]))
    sys.exit(main())
