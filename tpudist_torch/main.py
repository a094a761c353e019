"""The training entry point: the port of ``main.py``'s training branch.

    python -m tpudist_torch.main --batch_size 128 --JobID Job0
    torchrun --nproc_per_node 2 -m tpudist_torch.main --dataset synthetic
    python -m tpudist_torch.launch --nproc_per_node 2 --max_restarts 1 \
        tpudist_torch/main.py --checkpoint_dir ck --checkpoint_every 4
    python -m tpudist_torch.main --device cpu --model resnet18 \\
        --dataset synthetic --synthetic_size 64 --batch_size 8 --no_profiler

Same flags and defaults as ``main.py`` (2 epochs of Adam(1e-3) on
ResNet-50 over CIFAR-100, per-replica ``--batch_size`` 128, rank-0 TSV
rows every 5 steps, a profiler window in ``{log_dir}/log_{JobID}``, the
``TrainTime`` row), plus ``--device`` (``cuda`` by default; ``cpu`` runs
the plain path and is the only way to run without a card). The world
comes from the ``env://`` variables ``torchrun`` sets, one card per rank.
``--model`` takes the ResNets and ``vit_b16`` (4-pixel patches on the
32x32 images: 65 tokens; 16-pixel patches at ``--image_size`` on
ImageNet: 197 tokens at 224); ``--optimizer`` adam, sgd, lamb, lion or muon;
``--grad_accum k`` splits each ``--batch_size`` batch into k
microbatches; ``--amp`` is bf16 compute plus the non-finite update guard,
whose skipped steps are printed after training. ``--device_cache`` holds
the whole training set on the device as uint8 and gathers each batch
there from its indices (the ToTensor runs in the step; with
``--augment`` the crop, flip and normalization do); ``--augment`` alone
is the reference's host augmentation, bit for bit.

``--dataset imagenet`` trains on ImageNet-shaped data from local files:
``--packed <prefix>`` reads a pack (``python -m tpudist_torch.data.packed
--root <tree> --out <prefix>``) as uint8 from a memmap through the C++
batcher and normalizes in the step, with ``--device_cache`` from the
card, and with ``--cache_shard_rows N`` through the rotating device cache
for a pack larger than the card; without ``--packed`` it streams
``<data_root>/train`` (JPEG decode on ``--workers`` threads, PIL needed),
and ``--eval`` scores ``--packed_val`` (its class list must be the
training pack's) or ``<data_root>/val``. On the card the TSV gets the
reference's ``HBM`` rows. ``--model gpt2``
exits pointing at ``python -m tpudist_torch.train_gpt2``, as the
reference points at its LM script.

``--serve`` runs the reference's serving demo instead of training: a
byte-vocabulary GPT-2 (128 wide, 2 deep) with random weights serves
``--serve_requests`` mixed-length requests, alternately greedy and
sampled, through the continuous-batching engine with ``--serve_slots``
slots (``--spec_draft N --spec_k K``: speculative decoding with the
target's first ``N`` blocks as the draft), writing ``serve`` rows to
``{log_dir}/{JobID}_serve_0.jsonl``.

``--checkpoint_dir`` saves every ``--checkpoint_every`` steps (and/or
``--checkpoint_every_s`` seconds) and at the end, keeps the newest
``--keep_last``, and resumes from the newest loadable step unless
``--no_resume``; SIGTERM gives a checkpoint at the last completed step
and exit 75 (:mod:`tpudist_torch.resilience`), and ``--chaos`` injects a
fault at a step. Under ``python -m tpudist_torch.launch --max_restarts N
tpudist_torch/main.py ...`` a preempted or crashed world is relaunched
and resumes.

Every other flag ``main.py`` accepts is accepted here too, and a value
other than its default raises ``NotImplementedError`` naming the ROADMAP
item that ports it.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m tpudist_torch.main")
    p.add_argument("--local_rank", type=int,
                   default=int(os.environ.get("LOCAL_RANK", 0)),
                   help="local process id on this host (launcher-injected)")
    p.add_argument("--batch_size", default=128, type=int,
                   help="per-replica batch size")
    p.add_argument("--JobID", default="Job0", type=str, help="JOB ID")
    p.add_argument("--epochs", default=2, type=int)
    p.add_argument("--lr", default=0.001, type=float)
    p.add_argument("--schedule", default="constant",
                   choices=["constant", "cosine"],
                   help="constant = the reference's fixed lr; cosine = linear "
                   "warmup + cosine decay over the run")
    p.add_argument("--warmup_steps", default=0, type=int)
    p.add_argument("--model", default="resnet50",
                   choices=["resnet18", "resnet34", "resnet50", "resnet101",
                            "resnet152", "vit_b16", "gpt2"])
    p.add_argument("--dataset", default="cifar100",
                   choices=["cifar10", "cifar100", "synthetic", "imagenet",
                            "digits"])
    p.add_argument("--data_root", default="dataset", type=str,
                   help="directory holding the extracted CIFAR archive")
    p.add_argument("--synthetic_size", default=2048, type=int)
    p.add_argument("--image_size", default=224, type=int)
    p.add_argument("--workers", default=None, type=int)
    p.add_argument("--packed", default=None, type=str)
    p.add_argument("--packed_val", default=None, type=str)
    p.add_argument("--cache_shard_rows", default=0, type=int)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute, float32 masters")
    p.add_argument("--amp", action="store_true")
    p.add_argument("--stem", default="conv7",
                   choices=["conv7", "space_to_depth"])
    p.add_argument("--optimizer", default="adam",
                   choices=["adam", "sgd", "lamb", "lion", "muon"])
    p.add_argument("--weight_decay", default=0.0, type=float,
                   help="decoupled (AdamW) weight decay, 1-D params excluded")
    p.add_argument("--clip_norm", default=None, type=float,
                   help="global gradient-norm clip")

    def _smoothing_eps(v):
        v = float(v)
        if not 0.0 <= v < 1.0:
            raise argparse.ArgumentTypeError(
                f"label smoothing must be in [0, 1), got {v}")
        return v

    p.add_argument("--label_smoothing", default=0.0, type=_smoothing_eps)
    p.add_argument("--grad_accum", default=1, type=int)
    p.add_argument("--fused", default="none",
                   choices=["none", "auto", "ln", "optimizer", "all"],
                   help="'optimizer' = the one-pass fused-AdamW kernel "
                   "(--optimizer adam; under --bf16 the forward reads its "
                   "bf16 compute copy); 'auto' = what the model and "
                   "optimizer support; 'ln'/'all' need a model with LN")
    p.add_argument("--reduce", default="none",
                   choices=("none", "bucketed", "quantized", "auto"))
    p.add_argument("--fsdp", default=1, type=int)
    p.add_argument("--augment", action="store_true")
    p.add_argument("--device_cache", action="store_true")
    p.add_argument("--telemetry", action="store_true")
    p.add_argument("--health", action="store_true")
    p.add_argument("--trace", action="store_true")
    p.add_argument("--metrics_port", default=None, type=int)
    p.add_argument("--hang_timeout", default=300.0, type=float)
    p.add_argument("--divergence_every", default=200, type=int)
    p.add_argument("--hang_action", default="report", choices=["report", "exit"])
    p.add_argument("--chaos", default=None, type=str)
    p.add_argument("--repair", action="store_true")
    p.add_argument("--skip_window", default=8, type=int)
    p.add_argument("--keep_last", default=0, type=int)
    p.add_argument("--serve", action="store_true")
    p.add_argument("--serve_requests", default=8, type=int)
    p.add_argument("--serve_slots", default=4, type=int)
    p.add_argument("--spec_draft", default=0, type=int)
    p.add_argument("--serve_experts", default=0, type=int)
    p.add_argument("--serve_moe_dispatch", default="einsum",
                   choices=["einsum", "index"])
    p.add_argument("--spec_k", default=4, type=int)
    p.add_argument("--tensor", default=1, type=int)
    p.add_argument("--no_profiler", action="store_true")
    p.add_argument("--log_dir", default=".", type=str)
    p.add_argument("--checkpoint_dir", default=None, type=str)
    p.add_argument("--checkpoint_every", default=0, type=int)
    p.add_argument("--checkpoint_every_s", default=0.0, type=float)
    p.add_argument("--no_resume", action="store_true")
    p.add_argument("--elastic", action="store_true")
    p.add_argument("--compile_cache", default=None, type=str)
    p.add_argument("--eval", action="store_true",
                   help="top-1 eval pass after training")
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (the card, one per rank) or cpu (the plain "
                   "path; the only way to run without a card)")
    return p, p.parse_args(argv)


#: flags of main.py this port does not run yet -> the ROADMAP item
_UNPORTED = {
    "reduce": "Queue 1 #7", "fsdp": "Queue 1 #7",
    "telemetry": "Queue 1 #8", "health": "Queue 1 #8", "trace": "Queue 1 #8",
    "metrics_port": "Queue 1 #8", "hang_timeout": "Queue 1 #8",
    "divergence_every": "Queue 1 #8", "hang_action": "Queue 1 #8",
    "repair": "Queue 1 #8", "skip_window": "Queue 1 #8",
    "elastic": "Queue 1 #7", "compile_cache": "Queue 1 #9",
    "serve_experts": "Queue 1 #7", "serve_moe_dispatch": "Queue 1 #7",
    "tensor": "Queue 1 #7",
}

#: values of choice flags this port does not run yet -> the ROADMAP item
_UNPORTED_CHOICES = {
    ("dataset", "digits"): "Queue 1 #1",
}


def check_ported(parser, args) -> None:
    """Raise ``NotImplementedError`` for a flag (or a flag value) that
    ``main.py`` accepts and this port does not run yet."""
    for name, item in _UNPORTED.items():
        if getattr(args, name) != parser.get_default(name):
            raise NotImplementedError(
                f"--{name} is not ported yet (ROADMAP {item})")
    for (name, value), item in _UNPORTED_CHOICES.items():
        if getattr(args, name) == value:
            extra = (" (it needs scikit-learn, which the machine with the "
                     "card does not have)" if value == "digits" else "")
            raise NotImplementedError(
                f"--{name} {value} is not ported yet (ROADMAP {item}){extra}")


def _cifar_train(args, ctx, dtype):
    """The CIFAR (or synthetic) training loader and its in-step transform:
    the host ToTensor, the host augmentation, or the device cache with
    the ToTensor or the augmentation in the step."""
    import torch

    from tpudist_torch.data import transforms as T
    from tpudist_torch.data.cifar import load_cifar, synthetic_cifar, to_tensor
    from tpudist_torch.data.device_cache import DeviceCachedLoader
    from tpudist_torch.data.loader import DataLoader
    from tpudist_torch.data.sampler import DistributedSampler

    if args.dataset == "synthetic":
        data = synthetic_cifar(args.synthetic_size, num_classes=100)
    else:
        data = load_cifar(args.data_root, dataset=args.dataset, train=True)
    sampler = DistributedSampler(len(data["label"]),
                                 num_replicas=ctx.world_size, rank=ctx.rank)
    # --batch_size is per replica, and one process drives one replica;
    # each batch holds --grad_accum microbatches
    if args.device_cache:
        # one copy of the set to the device now; the steps gather
        loader = DeviceCachedLoader(data, args.batch_size, device=ctx.device,
                                    sampler=sampler)
        if args.augment:
            mean, std = T._STATS[args.dataset]
            post = T.device_compose(T.device_random_crop_flip(),
                                    T.device_normalize(mean, std, dtype))
        else:
            # the reference's ToTensor, in the step; a tensor divisor, as
            # a CUDA kernel turns a python one into a multiply by its
            # reciprocal, which the host path's division is not
            def post(x):
                return x.to(dtype) / torch.full((), 255.0, dtype=dtype,
                                                device=x.device)
        return loader, loader.input_transform(post)
    transform = (T.standard_cifar_augment(seed=ctx.rank, dataset=args.dataset)
                 if args.augment else to_tensor)
    return DataLoader(data, args.batch_size, sampler=sampler,
                      transform=transform), None


def _cifar_val(args):
    """The whole validation set (the reference's unsharded val loader);
    eval sees the training distribution: the augmented run's statistics,
    without the crop and flip."""
    from tpudist_torch.data import transforms as T
    from tpudist_torch.data.cifar import load_cifar, synthetic_cifar, to_tensor
    from tpudist_torch.data.loader import DataLoader

    if args.dataset == "synthetic":
        val = synthetic_cifar(args.synthetic_size // 4 or 1, num_classes=100)
    else:
        val = load_cifar(args.data_root, dataset=args.dataset, train=False)
    return DataLoader(
        val, min(args.batch_size, len(val["label"])),
        transform=(T.standard_cifar_eval(dataset=args.dataset)
                   if args.augment else to_tensor),
        drop_remainder=False)


def _imagenet_train(args, ctx, dtype):
    """ImageNet's training loader, its in-step transform and its class
    list (``main.py:463-535``). ``--packed``: the pack's uint8 pixels from
    a memmap, normalized in the step (with ``--augment`` after a crop and
    flip there), through the host loader, the device cache, or with
    ``--cache_shard_rows`` the rotating device cache; otherwise the
    streaming image folder ``<data_root>/train`` (RandomResizedCrop and
    flip on the host)."""
    from tpudist_torch.data import transforms as T
    from tpudist_torch.data.sampler import DistributedSampler

    if not args.packed:
        from tpudist_torch.data.imagenet import ImageFolderLoader

        loader = ImageFolderLoader(
            os.path.join(args.data_root, "train"), args.batch_size,
            train=True, image_size=args.image_size,
            num_replicas=ctx.world_size, rank=ctx.rank, workers=args.workers)
        return loader, None, loader.classes
    from tpudist_torch.data.packed import load_packed

    packed = load_packed(args.packed)
    pdata = {"image": packed["image"], "label": packed["label"]}
    norm = T.device_normalize(T.IMAGENET_MEAN, T.IMAGENET_STD, dtype)
    if args.augment:
        # packed pixels are the eval decode: a reflect-pad crop and flip in
        # the step, fresh every step
        norm = T.device_compose(
            T.device_random_crop_flip(pad=max(args.image_size // 28, 4)), norm)
    if args.device_cache and args.cache_shard_rows:
        from tpudist_torch.data.device_cache import RotatingDeviceCache

        # a pack larger than the card: the rotation is its own sampler
        loader = RotatingDeviceCache(pdata, args.batch_size,
                                     shard_rows=args.cache_shard_rows,
                                     device=ctx.device)
        return loader, loader.input_transform(norm), packed["classes"]
    sampler = DistributedSampler(len(pdata["label"]),
                                 num_replicas=ctx.world_size, rank=ctx.rank)
    if args.device_cache:
        from tpudist_torch.data.device_cache import DeviceCachedLoader

        loader = DeviceCachedLoader(pdata, args.batch_size,
                                    device=ctx.device, sampler=sampler)
        return loader, loader.input_transform(norm), packed["classes"]
    from tpudist_torch.data.loader import DataLoader

    return (DataLoader(pdata, args.batch_size, sampler=sampler),
            norm, packed["classes"])


def _imagenet_val(args, dtype, train_classes):
    """ImageNet's validation loader and its in-step transform
    (``main.py:690-722``): ``--packed_val``, whose class list must be the
    training set's, normalized in the step; otherwise the streaming
    ``<data_root>/val`` keyed by the training classes."""
    from tpudist_torch.data.loader import DataLoader

    if args.packed_val:
        from tpudist_torch.data import transforms as T
        from tpudist_torch.data.packed import load_packed

        vdata = load_packed(args.packed_val)
        if vdata["classes"] != train_classes:
            # a val pack built without --classes_from (or from a tree
            # missing a class dir) would shift labels silently
            raise SystemExit(
                "--packed_val class list does not match the training "
                "classes — rebuild it with `python -m "
                "tpudist_torch.data.packed --classes_from <train pack>`")
        loader = DataLoader({"image": vdata["image"], "label": vdata["label"]},
                            args.batch_size, drop_remainder=False)
        return loader, T.device_normalize(T.IMAGENET_MEAN, T.IMAGENET_STD,
                                          dtype)
    from tpudist_torch.data.imagenet import ImageFolderLoader

    return ImageFolderLoader(
        os.path.join(args.data_root, "val"), args.batch_size, train=False,
        image_size=args.image_size, workers=args.workers,
        drop_remainder=False, classes=train_classes), None


def _serve_demo(args):
    """``--serve``: the reference's demo (``main.py:_serve_demo``) on the
    port's engine. Returns the SLO snapshot."""
    import numpy as np

    from tpudist_torch.models.gpt2 import GPT2
    from tpudist_torch.serve import ServeEngine, early_exit_draft
    from tpudist_torch.serve.stats import fmt_s
    from tpudist_torch.telemetry import TelemetrySink

    model = GPT2(vocab_size=256, max_seq_len=256, hidden_dim=128, depth=2,
                 num_heads=4, attn_impl="fused", device=args.device)
    sink = TelemetrySink(
        os.path.join(args.log_dir, f"{args.JobID}_serve_0.jsonl"))
    streamed: dict[int, int] = {}

    def on_token(ev):
        streamed[ev.request_id] = streamed.get(ev.request_id, 0) + 1
        if ev.done:
            print(f"request {ev.request_id}: {streamed[ev.request_id]} "
                  "tokens (done)")

    engine = ServeEngine(
        model, max_slots=args.serve_slots, sink=sink, stats_every=10,
        on_token=on_token, spec_k=args.spec_k,
        draft_model=(early_exit_draft(model, args.spec_draft)
                     if args.spec_draft else None))
    rng = np.random.Generator(np.random.PCG64(0))
    for i in range(args.serve_requests):
        # alternate greedy and sampled requests in one decode batch
        engine.submit(rng.integers(0, 256, (int(rng.integers(4, 48)),)),
                      int(rng.integers(8, 48)),
                      temperature=0.0 if i % 2 == 0 else 0.8,
                      top_k=0 if i % 2 == 0 else 50)
    engine.run()
    sink.close()
    snap = engine.stats.snapshot()
    print(
        f"served {snap['completed']} requests, {snap['tokens']} tokens in "
        f"{snap['wall_s']:.2f}s ({snap['tokens_per_sec']:.1f} tok/s); "
        f"TTFT p50/p95 {fmt_s(snap['ttft_p50'])}/{fmt_s(snap['ttft_p95'])}s, "
        f"TPOT p50 {fmt_s(snap['tpot_p50'], 1e3, 1)}ms, slot utilization "
        f"{fmt_s(snap['slot_utilization'], digits=2)}")
    if args.spec_draft:
        print(f"speculative: {snap['spec_accepted']}/{snap['spec_drafted']} "
              "drafts accepted (rate "
              f"{fmt_s(snap['spec_acceptance_rate'], digits=2)})")
    print(f"serve telemetry: {sink.path}")
    return snap


def main(argv=None):
    parser, args = parse_args(argv)
    check_ported(parser, args)
    if args.serve:
        return _serve_demo(args)
    if args.model == "gpt2":
        raise SystemExit("gpt2 training uses python -m "
                         "tpudist_torch.train_gpt2 (token data)")
    if args.cache_shard_rows and not (
            args.dataset == "imagenet" and args.packed and args.device_cache):
        # on every dataset path: the rotation backs only the packed device
        # cache, and ignoring the flag would run another memory profile
        raise SystemExit(
            "--cache_shard_rows rotates the packed HBM cache and needs "
            "--dataset imagenet --packed <prefix> --device_cache")
    os.environ.setdefault("LOCAL_RANK", str(args.local_rank))

    import torch
    import torch.distributed as dist

    from tpudist_torch.amp import policy_for, skipped_steps
    from tpudist_torch.distributed import group_up, init_from_env
    from tpudist_torch.models import resnet
    from tpudist_torch.models.vit import vit_b16
    from tpudist_torch.optim import make_optimizer, run_schedule
    from tpudist_torch.train import (
        cross_entropy_loss, evaluate, fit, smoothed_cross_entropy)

    formed_here = not group_up()
    ctx = init_from_env(args.device)
    try:
        # --amp is the bf16 policy plus the guard on the optimizer below
        dtype = policy_for(args.bf16 or args.amp).compute_dtype
        # the reference keeps the stock 1000-way head even on CIFAR
        imagenet = args.dataset == "imagenet"
        if args.model == "vit_b16":
            # 4-pixel patches keep the 32x32 images at 64 tokens (+ cls);
            # ImageNet crops take the standard 16-pixel patches
            model = vit_b16(dtype=dtype, patch_size=16 if imagenet else 4,
                            image_size=args.image_size if imagenet else 32,
                            device=ctx.device)
        else:
            model = getattr(resnet, args.model)(dtype=dtype, stem=args.stem,
                                                device=ctx.device)
        input_transform = train_classes = None
        if imagenet:
            loader, input_transform, train_classes = _imagenet_train(
                args, ctx, dtype)
        else:
            loader, input_transform = _cifar_train(args, ctx, dtype)
        lr = args.lr
        if args.schedule == "cosine":
            lr = run_schedule(args.lr, total_steps=args.epochs * len(loader),
                              warmup_steps=args.warmup_steps)
        fuse_opt = args.fused in ("optimizer", "all") or (
            args.fused == "auto" and args.optimizer == "adam")
        tx = make_optimizer(
            lr, optimizer=args.optimizer, weight_decay=args.weight_decay,
            clip_norm=args.clip_norm, skip_nonfinite_updates=args.amp,
            fused=fuse_opt,
            # the copy only pays when the model computes narrower than fp32
            compute_dtype=dtype if dtype != torch.float32 else None)
        loss_fn = (smoothed_cross_entropy(args.label_smoothing)
                   if args.label_smoothing else cross_entropy_loss)
        state, losses = fit(
            model, tx, loader, epochs=args.epochs, job_id=args.JobID,
            batch_size=args.batch_size, world_size=ctx.world_size,
            global_rank=ctx.rank, loss_fn=loss_fn, grad_accum=args.grad_accum,
            input_transform=input_transform,
            fused=None if args.fused == "none" else args.fused,
            profile=not args.no_profiler, log_dir=args.log_dir,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            checkpoint_every_s=args.checkpoint_every_s or None,
            keep_last=args.keep_last or None, resume=not args.no_resume,
            chaos=args.chaos)
        if args.amp and ctx.is_chief:
            skipped = skipped_steps(state.opt_state)
            if skipped:
                print(f"amp: skipped {skipped} non-finite update step(s)")
        if args.eval:
            # every rank scores the full validation set (the reference's
            # unsharded val loader); rank 0 reports
            if imagenet:
                val_loader, eval_transform = _imagenet_val(
                    args, dtype, train_classes)
            else:
                val_loader, eval_transform = _cifar_val(args), None
            acc = evaluate(state, val_loader, input_transform=eval_transform)
            if ctx.is_chief:
                print(f"Accuracy: {acc:.4f}")
        return state, losses
    finally:
        if formed_here and group_up():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
