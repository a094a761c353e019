"""Continuous-batching GPT-2 serving on the port (counterpart of
``examples/serve_gpt2.py``).

    # random-weight smoke run on the card (tiny geometry unless --full)
    python -m tpudist_torch.serve --device cuda --requests 8 --slots 4

    # GPT-2 124M at full width, bf16, paged pool through the kernels
    python -m tpudist_torch.serve --device cuda --full --bf16 --paged

    # speculative decoding: the target's first 4 blocks draft 4 tokens a
    # tick, one paged-kernel verify pass a layer scores them
    python -m tpudist_torch.serve --full --bf16 --paged --spec_draft 4 --spec_k 4

    # a local HF GPT-2 checkpoint (its geometry flags as given)
    python -m tpudist_torch.serve --init_hf /path/to/gpt2 --prompt 464,3290

    # the plain CPU path
    python -m tpudist_torch.serve --device cpu --requests 3 --max_new 6

    # tensor-sharded over 2 ranks (one process a rank; gloo on the CPU)
    torchrun --nproc_per_node 2 -m tpudist_torch.serve --full --bf16 \
        --paged --tensor 2

``--prompt`` takes comma-separated token ids (no tokenizer ships);
without any, mixed-length random prompts exercise the scheduler. The
flags are the JAX CLI's (``--trace`` and ``--metrics_port`` are not
ported: ROADMAP Queue 1 #8), plus ``--device``, ``--full``, ``--paged`` /
``--block_size`` and ``--attn_impl`` (default ``fused``: decode through
the kernels). ``--tensor N`` shards the engine over a tensor axis of the
``N`` ranks of the world that ``torchrun``'s ``env://`` variables name
(:mod:`tpudist_torch.parallel.tp`): each rank serves the same stream
with its heads, rank 0 prints and writes the telemetry; ``num_heads``
(and a Llama's K/V heads) must divide ``N``.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--init_hf", default=None, type=str,
                   help="local HF GPT-2 checkpoint to serve (implies "
                   "--full); default: random weights from --seed")
    p.add_argument("--vocab_size", default=None, type=int,
                   help="default: 50257 with --full or --init_hf, else 256")
    p.add_argument("--seq_len", default=1024, type=int)
    p.add_argument("--hidden_dim", default=768, type=int)
    p.add_argument("--depth", default=12, type=int)
    p.add_argument("--num_heads", default=12, type=int)
    p.add_argument("--small", action="store_true",
                   help="tiny random geometry (128 wide, 2 deep); implied "
                   "unless --full")
    p.add_argument("--full", action="store_true",
                   help="the geometry flags as given (GPT-2 124M by default)")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--attn_impl", default="fused", choices=("fused", "xla"))
    p.add_argument("--paged", action="store_true")
    p.add_argument("--block_size", default=32, type=int)
    p.add_argument("--prompt", action="append", default=None,
                   help="comma-separated token ids; repeatable")
    p.add_argument("--requests", default=8, type=int)
    p.add_argument("--max_new", default=32, type=int)
    p.add_argument("--slots", default=4, type=int)
    p.add_argument("--max_queue", default=256, type=int)
    p.add_argument("--temperature", default=0.0, type=float)
    p.add_argument("--top_k", default=0, type=int)
    p.add_argument("--top_p", default=1.0, type=float)
    p.add_argument("--eos_id", default=None, type=int)
    p.add_argument("--spec_draft", default=0, type=int,
                   help="speculative decoding: an early-exit draft of this "
                   "depth (the target's first N blocks, its weights; 0 = "
                   "off)")
    p.add_argument("--spec_k", default=4, type=int,
                   help="with --spec_draft: proposals a slot a tick")
    p.add_argument("--tensor", default=1, type=int,
                   help="tensor-parallel world: shard the engine (weights "
                   "by their Megatron placements, KV pools on the KV-head "
                   "dim) over this many ranks; num_heads must divide it. "
                   "1 = one card")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--log_dir", default=".", type=str)
    p.add_argument("--JobID", default="Serve", type=str)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch
    import torch.distributed as dist

    from tpudist_torch.distributed import group_up, init_from_env
    from tpudist_torch.models.gpt2 import GPT2
    from tpudist_torch.serve import ServeEngine, early_exit_draft
    from tpudist_torch.serve.stats import fmt_s
    from tpudist_torch.telemetry import TelemetrySink

    mesh = None
    formed_here = not group_up()
    if args.tensor > 1:
        from tpudist_torch.mesh import MeshConfig, create_layout

        args.device = str(init_from_env(args.device).device)
        mesh = create_layout(MeshConfig(data=-1, tensor=args.tensor))
    chief = mesh is None or mesh.rank == 0
    small = not (args.full or args.init_hf)
    model = GPT2(
        vocab_size=args.vocab_size or (256 if small else 50257),
        max_seq_len=args.seq_len,
        hidden_dim=128 if small else args.hidden_dim,
        depth=2 if small else args.depth,
        num_heads=4 if small else args.num_heads,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        attn_impl=args.attn_impl, device=args.device, seed=args.seed,
        # each rank builds its shards alone (the whole init drawn a leaf
        # at a time): no rank holds the whole model
        layout=mesh,
    )
    if args.init_hf:
        from tpudist_torch.interop import load_hf_params
        from tpudist_torch.parallel.tp import shard_state_dict

        model.load_state_dict(shard_state_dict(load_hf_params(
            args.init_hf, arch="gpt2", depth=model.depth,
            num_heads=model.num_heads), mesh, table=model.tensor_specs))
    rng = np.random.Generator(np.random.PCG64(args.seed))
    if args.prompt:
        prompts = [np.asarray([int(t) for t in s.split(",")], np.int32)
                   for s in args.prompt]
    else:
        prompts = [
            rng.integers(0, model.vocab_size, (int(rng.integers(4, 64)),))
            .astype(np.int32)
            for _ in range(args.requests)
        ]
    sink = (TelemetrySink(os.path.join(args.log_dir,
                                       f"{args.JobID}_serve_0.jsonl"))
            if chief else None)
    engine = ServeEngine(
        model, max_slots=args.slots, max_queue=args.max_queue, seed=args.seed,
        sink=sink, stats_every=10, paged=args.paged,
        block_size=args.block_size, spec_k=args.spec_k, mesh=mesh,
        draft_model=(early_exit_draft(model, args.spec_draft)
                     if args.spec_draft else None),
    )
    rids = [
        engine.submit(pr, args.max_new, temperature=args.temperature,
                      top_k=args.top_k, top_p=args.top_p, eos_id=args.eos_id)
        for pr in prompts
    ]
    for ev in engine.events():
        if chief:
            print(f"  r{ev.request_id} +{ev.token}"
                  + (" [done]" if ev.done else ""))
    snap = engine.stats.snapshot()
    if mesh is not None and formed_here:
        dist.destroy_process_group()
    if not chief:
        return snap
    for r in rids:
        print(f"request {r}: {len(engine.result(r))} tokens -> {engine.result(r)}")
    sink.close()
    dev = (torch.cuda.get_device_name(model.device)
           if model.device.type == "cuda" else "cpu")
    print(
        f"\nserved {snap['completed']} requests, {snap['tokens']} tokens in "
        f"{snap['wall_s']:.2f}s ({snap['tokens_per_sec']:.1f} tok/s) on {dev}\n"
        f"TTFT p50/p95 {fmt_s(snap['ttft_p50'])}/{fmt_s(snap['ttft_p95'])}s, "
        f"TPOT p50/p95 {fmt_s(snap['tpot_p50'], 1e3, 1)}/"
        f"{fmt_s(snap['tpot_p95'], 1e3, 1)}ms, "
        f"slot utilization {fmt_s(snap['slot_utilization'], digits=2)}"
        + (f", tensor_world {engine.tensor_world}" if mesh is not None
           else "") + "\n"
        + (f"speculative: {snap['spec_accepted']}/{snap['spec_drafted']} "
           "drafts accepted (rate "
           f"{fmt_s(snap['spec_acceptance_rate'], digits=2)})\n"
           if args.spec_draft else "")
        + f"serve telemetry: {sink.path}"
    )
    return snap


if __name__ == "__main__":
    main()
