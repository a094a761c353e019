"""One rank of a port training CLI run on the card that reports what a
multi-card comparison reads: the rank's peak device memory and the TSV's
step times. Run from the root of the repo, one rank a card:

    torchrun --nproc_per_node 4 tools/torch_world_run.py main R4 \\
        --model resnet50 --dataset synthetic --synthetic_size 8192 \\
        --batch_size 128 --epochs 1 --bf16 --fused optimizer --reduce quantized
    torchrun --nproc_per_node 4 tools/torch_world_run.py gpt2 G4 \\
        --bf16 --fused all --batch_size 8 --synthetic_tokens 524288 --fsdp 4
    torchrun --nproc_per_node 4 tools/torch_world_run.py serve S4 \\
        --full --bf16 --paged --tensor 4
    torchrun --nproc_per_node 4 tools/torch_world_run.py bert B4 \\
        --tokens text.bin --bf16 --attn flash --chunked_ce 128 --tensor 4
    torchrun --nproc_per_node 4 tools/torch_world_run.py gpt2 FT4 \\
        --bf16 --fused all --batch_size 8 --synthetic_tokens 524288 \\
        --fsdp 2 --tensor 2
    torchrun --nproc_per_node 4 tools/torch_world_run.py gpt2 P4 \\
        --bf16 --fused optimizer --batch_size 8 --synthetic_tokens 524288 \\
        --pipe 4 --num_micro 8 --pipe_schedule 1f1b
    python tools/torch_world_run.py budget 4 --arch llama --hidden_dim 4096 \\
        --depth 32 --num_heads 32 --num_kv_heads 8 --ffn_dim 14336 \\
        --vocab_size 128256 --seq_len 2048 --batch_size 1 --bf16 \\
        --fused all --chunked_ce 256 --tensor 4
    python tools/torch_world_run.py budget 4 --bf16 --fused optimizer \\
        --pipe 2 --tensor 2
    torchrun --nproc_per_node 4 tools/torch_world_run.py gpt2 E4 \\
        --bf16 --fused all --batch_size 8 --synthetic_tokens 524288 \\
        --experts 8 --moe_dispatch index
    torchrun --nproc_per_node 4 tools/torch_world_run.py gpt2 DE4 \\
        --bf16 --fused all --batch_size 8 --synthetic_tokens 524288 \\
        --experts 8 --expert_axis 2
    python tools/torch_world_run.py budget 4 --arch llama --hidden_dim 4096 \\
        --depth 4 --num_heads 32 --num_kv_heads 8 --ffn_dim 14336 \\
        --vocab_size 32000 --seq_len 2048 --batch_size 2 --bf16 \\
        --fused optimizer --chunked_ce 256 --experts 8

The first argument names the CLI (``main``: :mod:`tpudist_torch.main`;
``gpt2``: :mod:`tpudist_torch.train_gpt2`; ``bert``:
:mod:`tpudist_torch.train_bert`; ``t5``: :mod:`tpudist_torch.train_t5`;
``serve``: :mod:`tpudist_torch.serve`), the second the job (its TSV or serving
telemetry goes to ``chiprun_out/world/<job>/``), the rest are the CLI's
flags (``--no_profiler`` is added to the training CLIs). Each rank
prints its peak memory (``torch.cuda.max_memory_allocated``) and wall
time, and a training rank its step count; rank 0 also the step at each
TSV row (``batch / examples_per_sec``) or, serving (``serve``, or
``main --serve``), the engine's TTFT, TPOT and tokens/s; under ``gpt2``
rank 0 first prints the run's ``memory.train_state_budget`` line (the
estimate a card, against the card's memory). Without a card it exits
with an error: it measures the card and nothing else. ``budget WORLD``
and ``train_gpt2``'s flags print that estimate alone for a world of
``WORLD`` ranks, built on the meta device, and need no card.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def budget_line(flags, world: int, hbm_budget_bytes=None) -> str:
    """``memory.train_state_budget``'s line for ``train_gpt2 flags`` over
    ``world`` ranks: the whole model and its optimizer state on the meta
    device, placed by the flags' plan (``--fsdp``, ``--tensor``, ZeRO-1
    under ``--shard_opt_state``, a stage's blocks under ``--pipe``, a
    rank's experts under ``--experts`` (the expert axis by
    ``train_gpt2``'s rule); the data axis the rest of the world less
    ``--cp``, ``--pipe`` and the expert axis), the batch the global
    one."""
    import types

    import torch

    from tpudist_torch import train_gpt2 as TG
    from tpudist_torch.memory import format_budget, train_state_budget
    from tpudist_torch.optim import make_optimizer, shard_state

    _, args = TG.parse_args(list(flags))
    expert = TG.expert_axis(args, world)
    data = world // (args.fsdp * args.tensor * args.cp * args.pipe * expert)
    dtype = torch.bfloat16 if (args.bf16 or args.amp) else torch.float32
    # a context-parallel attention needs its layout: the estimate takes
    # the attention each rank runs (the dense chunks, or the kernels)
    attn = {"ring": "xla", "ulysses": "xla", "ulysses_flash": "flash"}.get(
        args.attn, TG.resolve_attn(args.attn, args.seq_len,
                                   torch.device("cuda"), args.pipe))
    tx = make_optimizer(
        args.lr, optimizer=args.optimizer, weight_decay=args.weight_decay,
        clip_norm=args.clip_norm,
        fused=args.fused in ("optimizer", "all") or (
            args.fused == "auto" and args.optimizer == "adam"),
        compute_dtype=dtype if dtype != torch.float32 else None)
    if args.shard_opt_state:
        tx = shard_state(tx, world=data, rank=0)
    report = train_state_budget(
        lambda d: TG.build_model(args, dtype, attn, d, None), tx,
        batch=args.batch_size * data * args.fsdp, seq=args.seq_len,
        world_size=world, hbm_budget_bytes=hbm_budget_bytes,
        plan=types.SimpleNamespace(data=data, fsdp=args.fsdp,
                                   tensor=args.tensor, pipe=args.pipe,
                                   expert=expert))
    return format_budget(report)


def main(argv=None) -> None:
    args = sys.argv[1:] if argv is None else argv
    if args and args[0] == "budget":
        print(budget_line(args[2:], int(args[1]), 80 * 10 ** 9), flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_world_run: no CUDA device; it times the "
                         "card's steps and peak memory")
    which, job, *flags = args
    if which == "main":
        from tpudist_torch.main import main as cli
    elif which == "gpt2":
        from tpudist_torch.train_gpt2 import main as cli
    elif which == "bert":
        from tpudist_torch.train_bert import main as cli
    elif which == "t5":
        from tpudist_torch.train_t5 import main as cli
    elif which == "serve":
        from tpudist_torch.serve.__main__ import main as cli
    else:
        raise SystemExit(f"unknown CLI {which!r}: main, gpt2, bert, t5 or "
                         "serve")
    log_dir = Path("chiprun_out/world") / job
    log_dir.mkdir(parents=True, exist_ok=True)
    serving = which == "serve" or "--serve" in flags
    rank = int(os.environ.get("RANK", "0"))
    if which == "gpt2" and rank == 0:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        print(f"[{job}] budget {budget_line(flags, world)}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = cli([*flags, "--log_dir", str(log_dir), "--JobID", job,
                  *(() if which == "serve" else ("--no_profiler",))])
    wall = time.perf_counter() - t0
    peak = f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB"
    if serving:
        print(f"[{job}] rank {rank}: peak {peak}, wall {wall:.1f} s",
              flush=True)
        if rank == 0:
            print(f"[{job}] served {result['completed']} requests, "
                  f"{result['tokens']} tokens; TTFT p50 {result['ttft_p50']} "
                  f"s, TPOT p50 {result['tpot_p50']} s p95 "
                  f"{result['tpot_p95']} s, {result['tokens_per_sec']} tok/s, "
                  f"tensor_world {result['tensor_world']}", flush=True)
        return
    _, losses = result
    print(f"[{job}] rank {rank}: {len(losses)} steps, peak {peak}, wall "
          f"{wall:.1f} s", flush=True)
    if rank == 0:
        tsv = next(log_dir.glob(f"{job}_*_0.log"))
        batch = int(tsv.name.split("_")[-2])
        rows = [r.split("\t") for r in tsv.read_text().splitlines()
                if r[:1].isdigit()]
        print(f"[{job}] TSV g_steps {[r[1] for r in rows]}, step ms "
              f"{[round(batch / float(r[4]) * 1e3, 2) for r in rows]}",
              flush=True)


if __name__ == "__main__":
    main()
