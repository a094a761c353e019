"""t5-small over two tensor ranks against one, in float32 and float64.

    python tools/t5_tensor_witness.py                 # CPU, batch 2, S 512
    python tools/t5_tensor_witness.py --batch 4 --seq_len 256

t5-small at ``train_t5``'s defaults (d 512, ffn 1024, 8 + 8 layers, 6
heads of 85, the byte vocabulary and its sentinels) from its init (seed
0), one forward and backward of the mean span CE on one batch of seeded
random bytes corrupted as the CLI corrupts them: at one rank, and at
``--tensor 2`` in a gloo world of two CPU processes, in float32 and in
float64 (the float32 init cast up; attention, norms, logits and loss in
float64). Prints each run's loss and, for its gathered gradients, the
worst leaf's largest gap from the one-rank float64 gradients as a share
of that leaf's largest entry. The float64 rows show whether the sharded
model is the unsharded one's function; the float32 rows, how far float32
itself lies from it at this init.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
DTYPES = ("float32", "float64")


def run(args, out: Path) -> None:
    """One rank's runs (one rank alone without a process group); the
    first rank saves ``{dtype: (loss, gradients)}`` to ``out``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tpudist_torch.distributed import group_up, init_from_env
    from tpudist_torch.mesh import MeshConfig, create_layout
    from tpudist_torch.models.t5 import (
        seq2seq_forward, span_corrupt_transform, span_corruption_plan,
        t5_small,
    )
    from tpudist_torch.parallel import tp

    torch.set_num_threads(2)
    if "RANK" in os.environ:
        init_from_env("cpu")
    layout = create_layout(MeshConfig(data=-1, tensor=args.tensor))
    _, spans, _, dec_len = span_corruption_plan(args.seq_len)
    vocab = 256 + spans + 1
    tokens = np.random.default_rng(0).integers(
        0, 256, (args.batch, args.seq_len)).astype(np.int32)
    batch = {k: torch.from_numpy(np.asarray(v)).long() for k, v in
             span_corrupt_transform(vocab, seed=0)({"tokens": tokens}).items()}
    res = {}
    for name in DTYPES:
        dtype = getattr(torch, name)
        model = t5_small(vocab_size=vocab, max_decode_len=dec_len + 1,
                         dtype=dtype, device="cpu", seed=0,
                         layout=layout).to(dtype)
        loss = seq2seq_forward(model)(model, batch)
        loss.backward()
        grads = tp.gather_state_dict(
            {k: p.grad for k, p in model.named_parameters()}, layout, vocab,
            table=model.tensor_specs)
        res[name] = (float(loss.detach()), grads)
    if not group_up() or dist.get_rank() == 0:
        torch.save(res, out)
    if group_up():
        dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python tools/t5_tensor_witness.py")
    p.add_argument("--batch", default=2, type=int)
    p.add_argument("--seq_len", default=512, type=int)
    p.add_argument("--tensor", default=1, type=int, help=argparse.SUPPRESS)
    p.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.out is not None:
        run(args, Path(args.out))
        return 0
    import socket

    import torch

    with tempfile.TemporaryDirectory() as tmp, socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        base = [sys.executable, __file__, "--batch", str(args.batch),
                "--seq_len", str(args.seq_len)]
        env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
        procs = [subprocess.Popen([*base, "--out", f"{tmp}/one.pt"], env=env)]
        for rank in range(2):
            procs.append(subprocess.Popen(
                [*base, "--tensor", "2", "--out", f"{tmp}/two.pt"],
                env={**env, "MASTER_ADDR": "127.0.0.1",
                     "MASTER_PORT": str(port), "RANK": str(rank),
                     "WORLD_SIZE": "2", "LOCAL_RANK": "0"}))
        if any(proc.wait() for proc in procs):
            print("a rank failed", file=sys.stderr)
            return 1
        one = torch.load(f"{tmp}/one.pt")
        two = torch.load(f"{tmp}/two.pt")
    truth, want = one["float64"]

    def gap(grads):
        share = {k: float((grads[k].double() - w).abs().max()
                          / max(float(w.abs().max()), 1e-300))
                 for k, w in want.items()}
        worst = max(share, key=share.get)
        return share[worst], worst

    print(f"t5-small, batch {args.batch} x S {args.seq_len}: one forward and "
          "backward against one rank's float64")
    for what, res in (("one rank", one), ("two ranks", two)):
        for name in DTYPES:
            loss, grads = res[name]
            share, leaf = gap(grads)
            print(f"  {what:9s} {name}: loss {loss!r}, rel "
                  f"{abs(loss - truth) / abs(truth):.3e}; gradients, worst "
                  f"leaf {leaf} at {share:.3e} of its largest")
    return 0


if __name__ == "__main__":
    sys.exit(main())
