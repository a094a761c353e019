"""T5 span-corruption pretraining: the port of ``examples/train_t5.py``.

    python -m tpudist_torch.train_t5 --tokens corpus.bin --bf16   # one card
    torchrun --nproc_per_node 2 -m tpudist_torch.train_t5 --tokens corpus.bin
    python -m tpudist_torch.train_t5 --device cpu --tokens corpus.bin \\
        --seq_len 64 --hidden_dim 64 --ffn_dim 128 --enc_depth 2 \\
        --dec_depth 2 --num_heads 4 --batch_size 2 --no_profiler \\
        --eval --generate

The reference's flags and defaults (a byte vocabulary of 256, windows of
512 before corruption, per-replica ``--batch_size`` 16, d 512, ffn 1024,
8 + 8 layers, 6 heads, Adam 1e-3), plus ``--device`` (``cuda`` by default;
``cpu`` runs the plain path and is the only way to run without a card).
The model vocabulary is the corpus's plus a block above it for the span
sentinels and EOS; each window is corrupted on the host
(:func:`tpudist_torch.models.t5.span_corrupt_transform`, seeded ``seed +
rank`` and keyed by ``(epoch, start)``, so a resume replays the same
batches) into fixed-shape (encoder, decoder, targets) triples. The model
(:mod:`tpudist_torch.models.t5`) trains data-parallel under DDP on the
mean CE of the span targets through the port's ``fit`` (TSV rows, the
windowed profiler, checkpoints and resume, SIGTERM, ``python -m
tpudist_torch.launch`` supervision), and the run ends with the
reference's ``tokens/sec: ... steps=... final_loss=...`` line. ``--amp``
is bf16 plus the non-finite update guard.

``--eval`` reports the span CE and per-token accuracy over ``--val_tokens``
(or the training stream in order), corrupted with ``seed + 10000``;
``--generate`` denoises one window greedily with
:func:`tpudist_torch.generate.generate_seq2seq` and prints the generated
span tokens beside the true ones.

``--tensor N`` lays the world out ``data x tensor``
(:mod:`tpudist_torch.parallel.tp`): each rank holds ``num_heads / N``
heads (t5-small's 6 split over 2, not 4: the model refuses a tensor world
that does not divide its heads), its column or row shard of every
projection and ``1 / N`` of the vocabulary (the shared embedding and the
untied head); the relative-bias tables stay whole. The ``N`` ranks of a
replica read and corrupt the same windows, the loss is the
vocabulary-parallel CE, ``--eval`` takes its top-1 across the shards by
``torch.argmax``'s lowest-index rule, and ``--generate`` decodes on each
rank's heads with the logits gathered, so every rank picks the same
token; rank 0 prints.
"""

from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m tpudist_torch.train_t5")
    p.add_argument("--local_rank", type=int,
                   default=int(os.environ.get("LOCAL_RANK", 0)))
    p.add_argument("--tokens", required=True,
                   help=".bin (raw little-endian) or .npy flat token stream")
    p.add_argument("--val_tokens", default=None)
    p.add_argument("--token_dtype", default="uint16")
    p.add_argument("--vocab_size", default=256, type=int,
                   help="CORPUS vocabulary; the model reserves sentinel/EOS "
                   "ids in a block ABOVE it")
    p.add_argument("--seq_len", default=512, type=int,
                   help="window length BEFORE corruption")
    p.add_argument("--density", default=0.15, type=float)
    p.add_argument("--mean_span", default=3.0, type=float)
    p.add_argument("--batch_size", default=16, type=int,
                   help="per data-parallel replica")
    p.add_argument("--hidden_dim", default=512, type=int)
    p.add_argument("--ffn_dim", default=1024, type=int)
    p.add_argument("--enc_depth", default=8, type=int)
    p.add_argument("--dec_depth", default=8, type=int)
    p.add_argument("--num_heads", default=6, type=int)
    p.add_argument("--epochs", default=1, type=int)
    p.add_argument("--total_steps", default=0, type=int)
    p.add_argument("--lr", default=1e-3, type=float)
    p.add_argument("--warmup_steps", default=0, type=int)
    p.add_argument("--optimizer", default="adam")
    p.add_argument("--weight_decay", default=0.0, type=float)
    p.add_argument("--clip_norm", default=None, type=float)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--amp", action="store_true",
                   help="bf16 + the non-finite update guard")
    p.add_argument("--grad_accum", default=1, type=int)
    p.add_argument("--tensor", default=1, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--JobID", default="T5_0", type=str)
    p.add_argument("--log_dir", default=".", type=str)
    p.add_argument("--no_profiler", action="store_true")
    p.add_argument("--checkpoint_dir", default=None, type=str)
    p.add_argument("--checkpoint_every", default=0, type=int)
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--eval", action="store_true",
                   help="span-denoising loss + in-span token accuracy on "
                   "the held-out stream (or the train stream in order)")
    p.add_argument("--generate", action="store_true",
                   help="after training, greedily denoise one held-out "
                   "window and report the generated vs true span targets")
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (the card, one per rank) or cpu (the plain "
                   "path; the only way to run without a card)")
    return p.parse_args(argv)


def evaluate_spans(state, loader) -> dict[str, float]:
    """Span CE and per-token accuracy over every batch of ``loader``,
    summed over the ranks (each scores its own windows). A tensor rank
    scores its vocabulary columns (the vocabulary-parallel CE, the top-1
    by :func:`~tpudist_torch.parallel.tp.vocab_parallel_argmax`); the
    tensor ranks score the same windows, so every sum is counted
    ``tensor`` times and the ratios not."""
    import torch
    import torch.distributed as dist

    from tpudist_torch.data.loader import prefetch_to_device
    from tpudist_torch.distributed import group_up
    from tpudist_torch.parallel import tp

    model = state.model
    model.eval()
    device = next(model.parameters()).device
    sums = torch.zeros(3, dtype=torch.float64, device=device)
    with torch.no_grad():
        for batch in prefetch_to_device(iter(loader), device):
            tgt = batch["targets"].long().reshape(-1)
            logits = model(batch["enc_tokens"], batch["dec_tokens"],
                           vocab_local=True)
            flat = logits.reshape(-1, logits.shape[-1])
            sums[0] += tp.vocab_parallel_cross_entropy(
                flat, tgt, model.layout, model.vocab_size).sum()
            sums[1] += (tp.vocab_parallel_argmax(
                flat, model.layout, model.vocab_size) == tgt).sum()
            sums[2] += tgt.numel()
    if group_up():
        dist.all_reduce(sums)
    ce, hits, count = sums.tolist()
    return {"loss": ce / max(count, 1.0), "accuracy": hits / max(count, 1.0),
            "count": count}


def main(argv=None):
    args = parse_args(argv)
    os.environ.setdefault("LOCAL_RANK", str(args.local_rank))

    import numpy as np
    import torch
    import torch.distributed as dist

    from tpudist_torch.amp import skipped_steps
    from tpudist_torch.data.lm import TokenWindowLoader, load_token_stream
    from tpudist_torch.distributed import group_up, init_from_env
    from tpudist_torch.generate import generate_seq2seq
    from tpudist_torch.mesh import MeshConfig, create_layout
    from tpudist_torch.models.t5 import (
        T5, seq2seq_forward, span_corrupt_transform, span_corruption_plan,
    )
    from tpudist_torch.optim import make_optimizer, run_schedule
    from tpudist_torch.train import fit

    formed_here = not group_up()
    ctx = init_from_env(args.device)
    try:
        # data x tensor; --batch_size, the sampler and the TSV count the
        # data replicas
        layout = create_layout(MeshConfig(data=-1, tensor=args.tensor))
        dtype = torch.bfloat16 if (args.bf16 or args.amp) else torch.float32
        # the sentinel/EOS block above the corpus vocabulary: one id a span
        # and the EOS
        _, spans, _, dec_len = span_corruption_plan(
            args.seq_len, density=args.density, mean_span=args.mean_span)
        model_vocab = args.vocab_size + spans + 1
        model = T5(vocab_size=model_vocab, hidden_dim=args.hidden_dim,
                   ffn_dim=args.ffn_dim, enc_depth=args.enc_depth,
                   dec_depth=args.dec_depth, num_heads=args.num_heads,
                   dtype=dtype, max_decode_len=dec_len + 1,
                   device=ctx.device, seed=args.seed, layout=layout)
        corrupt = lambda seed: span_corrupt_transform(
            model_vocab, density=args.density, mean_span=args.mean_span,
            seed=seed)
        loader = TokenWindowLoader(
            args.tokens, args.batch_size * args.grad_accum, args.seq_len,
            dtype=np.dtype(args.token_dtype), vocab_size=args.vocab_size,
            num_replicas=layout.data, rank=layout.data_idx,
            transform=corrupt(args.seed + layout.data_idx))
        total = args.total_steps or args.epochs * len(loader)
        tx = make_optimizer(
            run_schedule(args.lr, total_steps=total,
                         warmup_steps=args.warmup_steps),
            optimizer=args.optimizer, weight_decay=args.weight_decay,
            clip_norm=args.clip_norm, skip_nonfinite_updates=args.amp)
        t0 = time.time()
        state, losses = fit(
            model, tx, loader, epochs=args.epochs, job_id=args.JobID,
            batch_size=args.batch_size, world_size=layout.data,
            global_rank=ctx.rank, input_key="enc_tokens",
            label_key="targets", forward_loss=seq2seq_forward(model),
            grad_accum=args.grad_accum, seed=args.seed,
            profile=not args.no_profiler, log_dir=args.log_dir,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            resume=not args.no_resume)
        wall = time.time() - t0
        if losses and ctx.is_chief:
            seqs = (len(losses) * args.batch_size * layout.data
                    * args.grad_accum)
            print(f"tokens/sec: {seqs * args.seq_len / wall:.1f} (global, "
                  f"incl. the first step) steps={len(losses)} "
                  f"final_loss={losses[-1]:.4f}")
        if args.amp and ctx.is_chief:
            skipped = skipped_steps(state.opt_state)
            if skipped:
                print(f"amp: skipped {skipped} non-finite update step(s)")
        source = None
        if args.eval or args.generate:
            source = load_token_stream(args.val_tokens or args.tokens,
                                       dtype=np.dtype(args.token_dtype))
        if args.eval:
            val_loader = TokenWindowLoader(
                source, args.batch_size, args.seq_len,
                vocab_size=args.vocab_size, shuffle=False,
                drop_remainder=True, num_replicas=layout.data,
                rank=layout.data_idx, transform=corrupt(args.seed + 10_000))
            metrics = evaluate_spans(state, val_loader)
            if ctx.is_chief and metrics["count"]:
                print(f"span_loss: {metrics['loss']:.4f} "
                      f"span_accuracy: {metrics['accuracy']:.4f}")
        if args.generate:
            if len(source) < args.seq_len:
                raise SystemExit(
                    f"--generate needs a stream of >= --seq_len "
                    f"({args.seq_len}) tokens to build one window; "
                    f"{args.val_tokens or args.tokens} holds {len(source)}")
            window = np.asarray(source[:args.seq_len], np.int32)[None]
            demo = corrupt(args.seed + 20_000)({"tokens": window})
            state.model.eval()
            out = generate_seq2seq(state.model, demo["enc_tokens"], dec_len,
                                   temperature=0.0)
            tgt = demo["targets"][0]
            if ctx.is_chief:
                print(f"generated span tokens: {out[0].tolist()}")
                print(f"true span targets:     {tgt.tolist()}")
                print(f"generation_span_match: "
                      f"{float((out[0] == tgt).mean()):.4f}")
        return state, losses
    finally:
        if formed_here and group_up():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
