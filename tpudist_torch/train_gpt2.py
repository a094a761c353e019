"""GPT-2 language-model training: the port of ``examples/train_gpt2.py``.

    python -m tpudist_torch.train_gpt2                  # GPT-2 124M, one card
    torchrun --nproc_per_node 2 -m tpudist_torch.train_gpt2 --bf16 --fused all
    python -m tpudist_torch.train_gpt2 --device cpu --vocab_size 256 \\
        --seq_len 64 --hidden_dim 64 --depth 2 --num_heads 4 \\
        --batch_size 2 --synthetic_tokens 4096 --no_profiler

The same flags and defaults as the reference (GPT-2 124M at S 1024,
per-replica ``--batch_size`` 8, AdamW 3e-4 with 100 warmup steps and a
cosine decay, weight decay 0.1 off 1-D params, clipping at 1.0,
``--attn auto``), plus ``--device`` (``cuda`` by default; ``cpu`` runs
the plain path and is the only way to run without a card). The dense
``--arch gpt2`` model trains data-parallel under DDP, one card per rank
(the world from ``torchrun``'s ``env://`` variables), on a memory-mapped
``--tokens`` file or synthetic tokens from ``PCG64(0)``. Rank 0 writes the
reference's TSV (``examples_per_sec`` counts sequences) and the run ends
with the reference's ``tokens/sec: ... steps=... final_loss=...`` line.

``--attn auto`` resolves as the reference does on its accelerator: on the
card S <= 1024 takes the whole-row vmem kernel, 1025..2047 the dense path,
from 2048 the blockwise flash kernel; off the card it is the dense path.
``--fused ln|all`` runs the fused residual-add + LayerNorm kernel in
every block, ``--fused optimizer|all`` the fused AdamW kernel (under
``--bf16`` its bf16 compute copy is the forward's parameters).
``--chunked_ce N`` trains on the chunked tied-head loss
(:func:`tpudist_torch.models.lm_utils.chunked_lm_forward`), which never
holds the ``[B, S, V]`` logits. The reference's long-context leg is

    python -m tpudist_torch.train_gpt2 --seq_len 4096 --batch_size 4 \
        --bf16 --fused all --attn auto --chunked_ce 256

Every other flag of the reference is accepted, and a value other than its
default raises ``NotImplementedError`` naming the ROADMAP item that ports
it.
"""

from __future__ import annotations

import argparse
import os
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m tpudist_torch.train_gpt2")
    p.add_argument("--local_rank", type=int,
                   default=int(os.environ.get("LOCAL_RANK", 0)))
    p.add_argument("--batch_size", default=8, type=int,
                   help="per-replica sequences per step")
    p.add_argument("--JobID", default="GPT2", type=str)
    p.add_argument("--epochs", default=1, type=int)
    p.add_argument("--lr", default=3e-4, type=float)
    p.add_argument("--warmup_steps", default=100, type=int)
    p.add_argument("--total_steps", default=0, type=int,
                   help="schedule horizon; 0 = epochs x steps_per_epoch")
    p.add_argument("--optimizer", default="adam",
                   choices=["adam", "sgd", "lamb", "lion", "muon"])
    p.add_argument("--weight_decay", default=0.1, type=float)
    p.add_argument("--clip_norm", default=1.0, type=float)
    p.add_argument("--grad_accum", default=1, type=int)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute, float32 masters")
    p.add_argument("--amp", action="store_true")
    p.add_argument("--dropout", default=0.0, type=float)
    p.add_argument("--remat", default=None, nargs="?", const="full",
                   choices=["none", "full", "dots_saveable", "save_nothing"])
    p.add_argument("--remat_policy", default=None,
                   choices=["none", "full", "dots_saveable", "save_nothing"])
    p.add_argument("--shard_opt_state", action="store_true")
    p.add_argument("--fused", default="none",
                   choices=["none", "auto", "ln", "optimizer", "all"],
                   help="'ln' = the fused residual-add + LayerNorm kernel in "
                   "every block, 'optimizer' = the fused-AdamW kernel (+ the "
                   "bf16 compute copy under --bf16), 'all' both, 'auto' "
                   "whatever the model and optimizer support")
    p.add_argument("--chunked_ce", default=0, type=int)
    p.add_argument("--arch", default="gpt2", choices=["gpt2", "llama"])
    p.add_argument("--hidden_dim", default=768, type=int)
    p.add_argument("--depth", default=12, type=int)
    p.add_argument("--num_heads", default=12, type=int)
    p.add_argument("--num_kv_heads", default=0, type=int)
    p.add_argument("--ffn_dim", default=0, type=int)
    p.add_argument("--rope_theta", default=10000.0, type=float)
    p.add_argument("--tie_embeddings", action="store_true")
    p.add_argument("--scan_layers", action="store_true")
    p.add_argument("--remat_layers", action="store_true")
    p.add_argument("--vocab_size", default=50257, type=int)
    p.add_argument("--seq_len", default=1024, type=int)
    p.add_argument("--tokens", default=None, type=str,
                   help="flat token file (.npy, or raw .bin read as "
                   "--token_dtype), memory-mapped")
    p.add_argument("--token_dtype", default="uint16", type=str)
    p.add_argument("--synthetic_tokens", default=2_000_000, type=int)
    p.add_argument("--fsdp", default=1, type=int)
    p.add_argument("--tensor", default=1, type=int)
    p.add_argument("--pipe", default=1, type=int)
    p.add_argument("--num_micro", default=8, type=int)
    p.add_argument("--pipe_schedule", default="gpipe",
                   choices=["gpipe", "1f1b"])
    p.add_argument("--cp", default=1, type=int)
    p.add_argument("--experts", default=0, type=int)
    p.add_argument("--expert_axis", default=0, type=int)
    p.add_argument("--moe_every", default=0, type=int)
    p.add_argument("--moe_top_k", default=2, type=int)
    p.add_argument("--capacity_factor", default=1.25, type=float)
    p.add_argument("--moe_dispatch", default="einsum",
                   choices=["einsum", "index"])
    p.add_argument("--router_z_loss", default=0.0, type=float)
    p.add_argument("--router_jitter", default=0.0, type=float)
    p.add_argument("--attn", default="auto",
                   choices=["auto", "xla", "vmem", "flash", "ring", "ulysses",
                            "ulysses_flash"],
                   help="auto: by sequence length on the card (module "
                   "docstring); xla: the dense path")
    p.add_argument("--init_hf", default=None, type=str)
    p.add_argument("--generate", default=0, type=int)
    p.add_argument("--temperature", default=0.0, type=float)
    p.add_argument("--top_k", default=None, type=int)
    p.add_argument("--top_p", default=None, type=float)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--val_tokens", default=None, type=str)
    p.add_argument("--no_profiler", action="store_true")
    p.add_argument("--telemetry", action="store_true")
    p.add_argument("--log_dir", default=".", type=str)
    p.add_argument("--checkpoint_dir", default=None, type=str)
    p.add_argument("--checkpoint_every", default=0, type=int)
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--elastic", action="store_true")
    p.add_argument("--compile_cache", default=None, type=str)
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (the card, one per rank) or cpu (the plain "
                   "path; the only way to run without a card)")
    return p, p.parse_args(argv)


#: flags of the reference this port does not run yet -> the ROADMAP item
_UNPORTED = {
    "amp": "Queue 1 #2", "shard_opt_state": "Queue 1 #7",
    "dropout": "Queue 1 #3", "remat": "Queue 1 #3",
    "remat_policy": "Queue 1 #3", "scan_layers": "Queue 1 #3",
    "remat_layers": "Queue 1 #3",
    "num_kv_heads": "Queue 1 #4", "ffn_dim": "Queue 1 #4",
    "rope_theta": "Queue 1 #4", "tie_embeddings": "Queue 1 #4",
    "fsdp": "Queue 1 #7", "tensor": "Queue 1 #7", "pipe": "Queue 1 #7",
    "num_micro": "Queue 1 #7", "pipe_schedule": "Queue 1 #7",
    "cp": "Queue 1 #5", "experts": "Queue 1 #7", "expert_axis": "Queue 1 #7",
    "moe_every": "Queue 1 #7", "moe_top_k": "Queue 1 #7",
    "capacity_factor": "Queue 1 #7", "moe_dispatch": "Queue 1 #7",
    "router_z_loss": "Queue 1 #7", "router_jitter": "Queue 1 #7",
    "init_hf": "Queue 1 #3", "generate": "Queue 1 #3",
    "temperature": "Queue 1 #3", "top_k": "Queue 1 #3",
    "top_p": "Queue 1 #3", "eval": "Queue 1 #3", "val_tokens": "Queue 1 #3",
    "telemetry": "Queue 1 #8", "checkpoint_dir": "Queue 1 #4",
    "checkpoint_every": "Queue 1 #4", "no_resume": "Queue 1 #4",
    "elastic": "Queue 1 #9", "compile_cache": "Queue 1 #9",
}

#: values of choice flags this port does not run yet -> the ROADMAP item
_UNPORTED_CHOICES = {
    ("arch", "llama"): "Queue 1 #4",
    ("attn", "ring"): "Queue 1 #5",
    ("attn", "ulysses"): "Queue 1 #5", ("attn", "ulysses_flash"): "Queue 1 #5",
    ("optimizer", "sgd"): "Queue 1 #2", ("optimizer", "lamb"): "Queue 1 #2",
    ("optimizer", "lion"): "Queue 1 #2", ("optimizer", "muon"): "Queue 1 #2",
}


def check_ported(parser, args) -> None:
    """Raise ``NotImplementedError`` for a flag (or a flag value) that the
    reference accepts and this port does not run yet."""
    for name, item in _UNPORTED.items():
        if getattr(args, name) != parser.get_default(name):
            raise NotImplementedError(
                f"--{name} is not ported yet (ROADMAP {item})")
    for (name, value), item in _UNPORTED_CHOICES.items():
        if getattr(args, name) == value:
            raise NotImplementedError(
                f"--{name} {value} is not ported yet (ROADMAP {item})")


def resolve_attn(attn: str, seq_len: int, device) -> str:
    """``--attn auto`` by sequence length, the reference's crossovers: on
    the card the vmem kernel up to 1024, the dense path to 2047, flash from
    2048; off the card the dense path. Other values pass through."""
    if attn != "auto":
        return attn
    if device.type != "cuda":
        return "xla"
    if seq_len <= 1024:
        return "vmem"
    return "xla" if seq_len < 2048 else "flash"


def token_source(args):
    """The flat token stream: a read-only memmap of ``--tokens`` or
    ``--synthetic_tokens`` uniform ids from ``PCG64(0)``."""
    import numpy as np

    from tpudist_torch.data.lm import load_token_stream

    if args.tokens:
        return load_token_stream(args.tokens, dtype=np.dtype(args.token_dtype))
    rng = np.random.Generator(np.random.PCG64(0))
    return rng.integers(0, args.vocab_size,
                        args.synthetic_tokens).astype(np.int32)


def main(argv=None):
    parser, args = parse_args(argv)
    check_ported(parser, args)
    os.environ.setdefault("LOCAL_RANK", str(args.local_rank))

    import torch
    import torch.distributed as dist

    from tpudist_torch.data.lm import TokenWindowLoader
    from tpudist_torch.distributed import group_up, init_from_env
    from tpudist_torch.models.gpt2 import GPT2
    from tpudist_torch.models.lm_utils import chunked_lm_forward
    from tpudist_torch.optim import make_optimizer, run_schedule
    from tpudist_torch.train import fit, lm_loss

    formed_here = not group_up()
    ctx = init_from_env(args.device)
    try:
        attn = resolve_attn(args.attn, args.seq_len, ctx.device)
        dtype = torch.bfloat16 if args.bf16 else torch.float32
        model = GPT2(vocab_size=args.vocab_size, max_seq_len=args.seq_len,
                     hidden_dim=args.hidden_dim, depth=args.depth,
                     num_heads=args.num_heads, dtype=dtype, attn_impl=attn,
                     device=ctx.device)
        # --batch_size is per replica, one replica per process; each loader
        # batch holds grad_accum microbatches of it
        loader = TokenWindowLoader(
            token_source(args), args.batch_size * args.grad_accum,
            args.seq_len, vocab_size=args.vocab_size,
            num_replicas=ctx.world_size, rank=ctx.rank)
        total = args.total_steps or args.epochs * len(loader)
        fuse_opt = args.fused in ("optimizer", "all") or (
            args.fused == "auto" and args.optimizer == "adam")
        tx = make_optimizer(
            run_schedule(args.lr, total_steps=total,
                         warmup_steps=args.warmup_steps),
            optimizer=args.optimizer, weight_decay=args.weight_decay,
            clip_norm=args.clip_norm, fused=fuse_opt,
            compute_dtype=dtype if dtype != torch.float32 else None)
        forward_loss = (chunked_lm_forward(model, chunk=args.chunked_ce)
                        if args.chunked_ce else None)
        t0 = time.time()
        state, losses = fit(
            model, tx, loader, epochs=args.epochs, job_id=args.JobID,
            batch_size=args.batch_size, world_size=ctx.world_size,
            global_rank=ctx.rank, loss_fn=lm_loss, input_key="tokens",
            label_key="tokens", grad_accum=args.grad_accum,
            forward_loss=forward_loss,
            fused=None if args.fused == "none" else args.fused,
            profile=not args.no_profiler, log_dir=args.log_dir)
        wall = time.time() - t0
        if losses and ctx.is_chief:
            seqs = len(losses) * args.batch_size * ctx.world_size * args.grad_accum
            print(f"tokens/sec: {seqs * args.seq_len / wall:.1f} (global, "
                  f"incl. the first step) steps={len(losses)} "
                  f"final_loss={losses[-1]:.4f}")
        return state, losses
    finally:
        if formed_here and group_up():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
