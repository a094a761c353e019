"""BERT masked-LM pretraining: the port of ``examples/train_bert.py``.

    python -m tpudist_torch.train_bert --tokens corpus.bin     # bert-base
    torchrun --nproc_per_node 2 -m tpudist_torch.train_bert \\
        --tokens corpus.bin --bf16 --attn flash --chunked_ce 128
    python -m tpudist_torch.train_bert --device cpu --tokens corpus.bin \\
        --vocab_size 256 --seq_len 64 --hidden_dim 64 --depth 2 \\
        --num_heads 4 --batch_size 2 --no_profiler --eval

The reference's flags and defaults (bert-base: 12 x 768, 12 heads, S
512, per-replica ``--batch_size`` 32, Adam 1e-4), plus ``--device``
(``cuda`` by default; ``cpu`` runs the plain path and is the only way to
run without a card). The model vocabulary is the corpus's ``--vocab_size``
plus one reserved [MASK] id at the top, unless ``--mask_id`` names one
inside it; each window gets the 80/10/10 corruption on the host
(:func:`tpudist_torch.models.bert.mlm_transform`, seeded ``seed +`` the
rank's data replica). The model (:mod:`tpudist_torch.models.bert`) trains
data-parallel under DDP on :func:`~tpudist_torch.models.bert.mlm_forward`,
the masked-CE mean over the global batch's masked positions, through the
port's ``fit`` (TSV rows, the windowed profiler, checkpoints and resume,
SIGTERM, ``python -m tpudist_torch.launch`` supervision), and the run ends
with the reference's ``tokens/sec: ... steps=... final_loss=...`` line.

``--attn`` ``xla`` (dense) or ``flash`` (the blockwise kernel, non-causal)
on one rank's whole sequences; ``ring``, ``ulysses`` or ``ulysses_flash``
with ``--cp N``: the world is laid out ``data x seq``, the seq ranks of a
replica read (and corrupt) the same windows and each trains on its chunk
of every row. ``--chunked_ce N`` runs the MLM head over sequence chunks
(the ``[B, S, V]`` logits never exist); ``--scan_layers`` /
``--remat_layers`` are the reference's (each block checkpointed).
``--eval`` reports the masked CE and top-1 accuracy over ``--val_tokens``
(or the training stream in order), corrupted with ``seed + 10000``;
``--init_hf DIR`` starts from a local HF ``BertForMaskedLM`` checkpoint.

``--tensor N`` lays the world out ``data x seq x tensor``
(:mod:`tpudist_torch.parallel.tp`): each rank holds ``num_heads / N``
heads, its column or row shard of every projection and ``1 / N`` of the
vocabulary (the tied MLM decode its logit columns, the MLM bias whole);
the ``N`` ranks of a replica read and corrupt the same windows, the loss
(full or ``--chunked_ce``) is the vocabulary-parallel CE over the masked
count of the replicas (and their seq chunks under ``--cp``: each attention
runs over the seq group on the rank's heads), counted once and not again
over the tensor ranks, ``--eval`` takes its top-1 across the shards by
``torch.argmax``'s lowest-index rule, and ``--init_hf`` loads the whole
checkpoint and keeps each rank's shards.
The reference's refusals are kept, in its order. The reference has no
``--fused`` here: the fused LayerNorm and AdamW kernels are reached through
the model API (``fit(..., fused="all")`` with ``make_optimizer(fused=True)``).
"""

from __future__ import annotations

import argparse
import os
import time

CP_ATTN = ("ring", "ulysses", "ulysses_flash")


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m tpudist_torch.train_bert")
    p.add_argument("--local_rank", type=int,
                   default=int(os.environ.get("LOCAL_RANK", 0)))
    p.add_argument("--tokens", required=True,
                   help=".bin (raw little-endian) or .npy flat token stream")
    p.add_argument("--val_tokens", default=None)
    p.add_argument("--token_dtype", default="uint16")
    p.add_argument("--vocab_size", default=30522, type=int,
                   help="CORPUS vocabulary; the model reserves one extra "
                   "[MASK] id above it unless --mask_id is given")
    p.add_argument("--mask_id", default=None, type=int)
    p.add_argument("--seq_len", default=512, type=int)
    p.add_argument("--batch_size", default=32, type=int,
                   help="per data-parallel replica")
    p.add_argument("--hidden_dim", default=768, type=int)
    p.add_argument("--depth", default=12, type=int)
    p.add_argument("--num_heads", default=12, type=int)
    p.add_argument("--mask_rate", default=0.15, type=float)
    p.add_argument("--epochs", default=1, type=int)
    p.add_argument("--total_steps", default=0, type=int)
    p.add_argument("--lr", default=1e-4, type=float)
    p.add_argument("--warmup_steps", default=0, type=int)
    p.add_argument("--optimizer", default="adam")
    p.add_argument("--weight_decay", default=0.0, type=float)
    p.add_argument("--clip_norm", default=None, type=float)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--grad_accum", default=1, type=int)
    p.add_argument("--chunked_ce", default=0, type=int,
                   help="run the MLM head over sequence chunks of this size")
    p.add_argument("--tensor", default=1, type=int)
    p.add_argument("--cp", default=1, type=int,
                   help="context-parallel degree (with --attn ring/ulysses/"
                   "ulysses_flash)")
    p.add_argument("--attn", default="xla",
                   choices=["xla", "flash", *CP_ATTN])
    p.add_argument("--scan_layers", action="store_true")
    p.add_argument("--remat_layers", action="store_true")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--JobID", default="Bert0", type=str)
    p.add_argument("--log_dir", default=".", type=str)
    p.add_argument("--no_profiler", action="store_true")
    p.add_argument("--checkpoint_dir", default=None, type=str)
    p.add_argument("--checkpoint_every", default=0, type=int)
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--eval", action="store_true",
                   help="masked-prediction loss + accuracy on the held-out "
                   "stream (or the train stream in order)")
    p.add_argument("--init_hf", default=None, type=str,
                   help="warm-start from a LOCAL HF BertForMaskedLM "
                   "checkpoint dir; needs --mask_id")
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (the card, one per rank) or cpu (the plain "
                   "path; the only way to run without a card)")
    return p.parse_args(argv)


def check_args(args) -> tuple[int, int]:
    """The reference's refusals, before any work, in its order (the
    mesh's first); returns ``(mask_id, model_vocab)``."""
    if args.cp > 1 and args.attn not in CP_ATTN:
        raise SystemExit("--cp needs a sequence-parallel attention: "
                         "--attn ring|ulysses|ulysses_flash")
    if args.mask_id is None:
        mask_id, model_vocab = args.vocab_size, args.vocab_size + 1
    else:
        if not 0 <= args.mask_id < args.vocab_size:
            raise SystemExit(
                f"--mask_id {args.mask_id} outside [0, {args.vocab_size})")
        mask_id, model_vocab = args.mask_id, args.vocab_size
    if args.remat_layers and not args.scan_layers:
        raise SystemExit("--remat_layers requires --scan_layers")
    if args.scan_layers and args.init_hf:
        raise SystemExit(
            "--init_hf uses the unrolled layout; convert with "
            "tpudist.models.lm_utils.stack_layers or drop --scan_layers")
    if args.init_hf and args.mask_id is None:
        raise SystemExit(
            "--init_hf needs --mask_id (the pretrained tokenizer's [MASK] "
            "id; the +1 reserved-id vocab wouldn't match the checkpoint)")
    return mask_id, model_vocab


def load_init_hf(model, args) -> None:
    """``--init_hf``: the HF encoder (and its MLM head, when the checkpoint
    has one) into ``model``; ``wpe`` cut to ``--seq_len``. Loaded whole;
    under ``--tensor`` each rank keeps its shards."""
    from tpudist_torch.interop import load_hf_params
    from tpudist_torch.parallel.tp import shard_state_dict

    sd = load_hf_params(args.init_hf, arch="bert", depth=args.depth,
                        num_heads=args.num_heads)
    if sd["wpe"].shape[0] < args.seq_len:
        raise SystemExit(f"--init_hf holds {sd['wpe'].shape[0]} positions, "
                         f"fewer than --seq_len {args.seq_len}")
    sd["wpe"] = sd["wpe"][:args.seq_len]
    sd = shard_state_dict(sd, model.layout, table=model.tensor_specs)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    if unexpected or any(not k.startswith("mlm_head.") for k in missing):
        raise SystemExit(f"--init_hf does not fit the model: missing "
                         f"{missing}, unexpected {unexpected}")


def evaluate_mlm(state, loader, *, chunk: int, layout) -> dict[str, float]:
    """Masked CE and top-1 accuracy over every window of ``loader`` (the
    reference's ``evaluate_mlm``): each rank scores its rows (its chunk of
    them under a seq axis) through the MLM head ``chunk`` positions at a
    time, so the ``[B, S, V]`` logits never exist, and the sums are added
    over the ranks: a global mean over the masked positions. A tensor
    rank scores its vocabulary columns (the vocabulary-parallel CE, the
    top-1 by :func:`~tpudist_torch.parallel.tp.vocab_parallel_argmax`);
    the tensor ranks score the same rows, so every sum is counted
    ``tensor`` times and the ratios not."""
    import torch
    import torch.distributed as dist

    from tpudist_torch.data.loader import prefetch_to_device
    from tpudist_torch.distributed import group_up
    from tpudist_torch.models.lm_utils import seq_shard
    from tpudist_torch.parallel import tp

    model = state.model
    model.eval()
    device = next(model.parameters()).device
    sums = torch.zeros(3, dtype=torch.float64, device=device)
    with torch.no_grad():
        for batch in prefetch_to_device(iter(loader), device):
            rows = [batch["tokens"].long(), batch["targets"].long(),
                    batch["mlm_mask"].bool()]
            if layout.seq > 1:
                rows = [seq_shard(x, layout) for x in rows]
            tokens, targets, mask = rows
            hidden = model(tokens, return_hidden=True)
            for c in range(0, hidden.shape[1], chunk):
                logits = model.mlm_head(hidden[:, c:c + chunk], model.wte,
                                        vocab_local=True)
                t, m = targets[:, c:c + chunk], mask[:, c:c + chunk]
                flat = logits.reshape(-1, logits.shape[-1])
                ce = tp.vocab_parallel_cross_entropy(
                    flat, t.reshape(-1), model.layout, model.vocab_size)
                top = tp.vocab_parallel_argmax(flat, model.layout,
                                               model.vocab_size)
                sums[0] += (ce * m.reshape(-1)).sum()
                sums[1] += ((top == t.reshape(-1)) & m.reshape(-1)).sum()
                sums[2] += m.sum()
    if group_up():
        dist.all_reduce(sums)
    ce, hits, count = sums.tolist()
    return {"loss": ce / max(count, 1.0), "accuracy": hits / max(count, 1.0)}


def main(argv=None):
    args = parse_args(argv)
    mask_id, model_vocab = check_args(args)
    os.environ.setdefault("LOCAL_RANK", str(args.local_rank))

    import numpy as np
    import torch
    import torch.distributed as dist

    from tpudist_torch.data.lm import TokenWindowLoader, load_token_stream
    from tpudist_torch.distributed import group_up, init_from_env
    from tpudist_torch.mesh import MeshConfig, create_layout
    from tpudist_torch.models.bert import Bert, mlm_forward, mlm_transform
    from tpudist_torch.optim import make_optimizer, run_schedule
    from tpudist_torch.train import fit

    formed_here = not group_up()
    ctx = init_from_env(args.device)
    try:
        layout = create_layout(MeshConfig(data=-1, seq=args.cp,
                                          tensor=args.tensor),
                               device_type=ctx.device.type)
        dtype = torch.bfloat16 if args.bf16 else torch.float32
        model = Bert(vocab_size=model_vocab, max_seq_len=args.seq_len,
                     hidden_dim=args.hidden_dim, depth=args.depth,
                     num_heads=args.num_heads, dtype=dtype,
                     attn_impl=args.attn, scan_layers=args.scan_layers,
                     remat_layers=args.remat_layers, layout=layout,
                     device=ctx.device, seed=args.seed)
        if args.init_hf:
            load_init_hf(model, args)
        # one corruption stream a data replica: its seq and tensor ranks
        # hold the same rows and must mask the same positions
        corruption = mlm_transform(model_vocab, mask_id,
                                   mask_rate=args.mask_rate,
                                   seed=args.seed + layout.data_idx)
        loader = TokenWindowLoader(
            args.tokens, args.batch_size * args.grad_accum, args.seq_len,
            dtype=np.dtype(args.token_dtype), vocab_size=args.vocab_size,
            num_replicas=layout.data, rank=layout.data_idx,
            transform=corruption)
        total = args.total_steps or args.epochs * len(loader)
        tx = make_optimizer(
            run_schedule(args.lr, total_steps=total,
                         warmup_steps=args.warmup_steps),
            optimizer=args.optimizer, weight_decay=args.weight_decay,
            clip_norm=args.clip_norm)
        t0 = time.time()
        state, losses = fit(
            model, tx, loader, epochs=args.epochs, job_id=args.JobID,
            batch_size=args.batch_size, world_size=layout.data,
            global_rank=ctx.rank, input_key="tokens", label_key="targets",
            forward_loss=mlm_forward(model, chunk=args.chunked_ce or None,
                                     layout=layout),
            grad_accum=args.grad_accum, seed=args.seed,
            profile=not args.no_profiler, log_dir=args.log_dir,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            resume=not args.no_resume, layout=layout)
        wall = time.time() - t0
        if losses and ctx.is_chief:
            seqs = len(losses) * args.batch_size * layout.data * args.grad_accum
            print(f"tokens/sec: {seqs * args.seq_len / wall:.1f} (global, "
                  f"incl. the first step) steps={len(losses)} "
                  f"final_loss={losses[-1]:.4f}")
        if args.eval:
            source = load_token_stream(args.val_tokens or args.tokens,
                                       dtype=np.dtype(args.token_dtype))
            val_loader = TokenWindowLoader(
                source, args.batch_size, args.seq_len,
                vocab_size=args.vocab_size, shuffle=False,
                drop_remainder=False, num_replicas=layout.data,
                rank=layout.data_idx,
                transform=mlm_transform(model_vocab, mask_id,
                                        mask_rate=args.mask_rate,
                                        seed=args.seed + 10_000))
            metrics = evaluate_mlm(state, val_loader,
                                   chunk=args.chunked_ce or args.seq_len,
                                   layout=layout)
            if ctx.is_chief:
                print(f"mlm_loss: {metrics['loss']:.4f} "
                      f"masked_accuracy: {metrics['accuracy']:.4f}")
        return state, losses
    finally:
        if formed_here and group_up():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
