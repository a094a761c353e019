"""The port's GPT-2 training path (tpudist_torch.train_gpt2 and what it
drives) against the JAX reference: three steps of a tiny GPT-2 (2 layers,
d 64, 2 heads, S 128, byte vocab) through ``make_train_step`` on
identical weights and batches, unfused, with the fused LayerNorm, with
everything fused, and with two accumulated microbatches; the weight-decay
mask on GPT-2's leaves; the token windows each rank reads; the loss; and
the CLI on the CPU, including the refusal of every flag the port does not
run yet. Then the long-context pieces: GPT-2 with ``attn_impl="flash"``
(2 layers, d 128, 2 heads of 64, S 256) against the reference's flash
model, logits, gradients and three steps of the trainer with the chunked
loss (``forward_loss``) and everything fused; and two gloo ranks with
``--chunked_ce`` equal to one process.

Flash model tolerance: logits under the repo's float32 kernel-parity rule
(2e-5 absolute and relative); gradients within 1e-4 relative plus 1e-6
absolute (float32; the attention and the loss sum in different orders on
the two sides, through two layers).

Trainer tolerance: per-step losses within 1e-5 relative, parameters
within 1e-4 relative plus 1e-4 absolute after three AdamW steps at a peak
lr of 1e-3 (float32 on both sides; the frameworks reduce in different
orders, and AdamW moves a coordinate whose gradient is within rounding of
zero by a fraction of lr either way; the bar is a tenth of one step, as
in tests/test_torch_train.py). One slice is held to the step bound
instead: the key part of the qkv bias, whose gradient is exactly zero in
exact arithmetic (adding q.b_k to every score of a row leaves its softmax
unchanged), so what each framework computes for it is rounding noise that
Adam scales to a full step of either sign."""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from tpudist import mesh as mesh_lib
from tpudist.data.lm import TokenWindowLoader as JaxTokenWindowLoader
from tpudist.models.gpt2 import GPT2 as JGPT2
from tpudist.optim import decay_mask as jax_decay_mask
from tpudist.optim import make_optimizer as jax_make_optimizer
from tpudist.optim import run_schedule as jax_run_schedule
from tpudist.train import create_train_state as jax_create_train_state
from tpudist.train import lm_loss as jax_lm_loss
from tpudist.train import make_train_step as jax_make_train_step
from tpudist.models.lm_utils import chunked_lm_forward as jax_chunked
from tpudist_torch.data.lm import TokenWindowLoader, encode_bytes
from tpudist_torch.interop import gpt2_params_from_flax
from tpudist_torch.models.gpt2 import GPT2
from tpudist_torch.models.lm_utils import chunked_lm_forward
from tpudist_torch.optim import decay_mask, make_optimizer, run_schedule
from tpudist_torch.train import create_train_state, lm_loss, make_train_step
from tpudist_torch.train_gpt2 import main, resolve_attn

REPO = Path(__file__).resolve().parent.parent
GEOM = dict(vocab_size=256, max_seq_len=128, hidden_dim=64, depth=2,
            num_heads=2)
#: the long-context pieces at a test's size: heads of GPT-2's 64
FLASH_GEOM = dict(vocab_size=256, max_seq_len=256, hidden_dim=128, depth=2,
                  num_heads=2)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # pytest-xdist runs several workers on one host; torch's default of one
    # thread per core would oversubscribe it (tests/test_torch_train.py)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _flax_params(model, seed=0):
    params = model.init(jax.random.key(seed), np.zeros((1, 8), np.int32),
                        train=False)["params"]
    return jax.tree_util.tree_map(np.asarray, meta.unbox(params))


def _stream(n=6000, seed=1):
    rng = np.random.Generator(np.random.PCG64(seed))
    return rng.integers(0, GEOM["vocab_size"], n).astype(np.int32)


@pytest.mark.parametrize("fused,attn,grad_accum", [
    (None, "xla", 1), ("ln", "xla", 1), ("all", "vmem", 1), (None, "xla", 2),
], ids=["unfused", "fused-ln", "fused-all-vmem", "grad-accum-2"])
def test_three_steps_match_the_reference(fused, attn, grad_accum):
    batch, steps = 2, 3
    loader = JaxTokenWindowLoader(_stream(), batch * grad_accum, 128)
    batches = [b for _, b in zip(range(steps), loader)]
    mesh = mesh_lib.create_mesh(devices=jax.devices()[:1])
    jm = JGPT2(**GEOM, attn_impl=attn)
    fuse_opt = fused == "all"
    opt_kw = dict(weight_decay=0.1, clip_norm=1.0, fused=fuse_opt)
    jtx = jax_make_optimizer(
        jax_run_schedule(1e-3, total_steps=steps, warmup_steps=1), **opt_kw)
    jstate = jax_create_train_state(jm, 0, jnp.zeros((1, 128), jnp.int32),
                                    jtx, mesh)
    init = gpt2_params_from_flax(
        jax.tree_util.tree_map(np.asarray, meta.unbox(jstate.params)))
    jstep = jax_make_train_step(jm, jtx, mesh, loss_fn=jax_lm_loss,
                                input_key="tokens", label_key="tokens",
                                fused=fused, grad_accum=grad_accum)
    want_losses = []
    for b in batches:
        jstate, metrics = jstep(jstate, b)
        want_losses.append(float(metrics["loss"]))

    model = GPT2(**GEOM, attn_impl=attn, device="cpu")
    model.load_state_dict(init)
    tx = make_optimizer(run_schedule(1e-3, total_steps=steps, warmup_steps=1),
                        **opt_kw)
    state = create_train_state(model, tx)
    step = make_train_step(model, tx, loss_fn=lm_loss, input_key="tokens",
                           label_key="tokens", fused=fused,
                           grad_accum=grad_accum)
    assert step.fused == {"all": {"ln", "optimizer"}, "ln": {"ln"}}.get(
        fused, set())
    losses = []
    for b in batches:
        state, metrics = step(state, {"tokens": torch.from_numpy(b["tokens"])})
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    want = gpt2_params_from_flax(
        jax.tree_util.tree_map(np.asarray, meta.unbox(jstate.params)))
    got = state.params()
    assert got.keys() == want.keys()
    for k, w in want.items():
        g, w = got[k].numpy(), w.numpy()
        if k.endswith("qkv.bias"):
            # [3, heads, dh]: queries and values held to the bar, the key
            # slice to the bound of 3 steps (|update| <= lr per step, plus
            # slack for the bias-corrected ratio)
            start = init[k].numpy()[1]
            for side in (g[1], w[1]):
                assert np.abs(side - start).max() <= 1.5 * steps * 1e-3, k
            g, w = g[[0, 2]], w[[0, 2]]
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=k)


def test_grad_accum_under_a_process_group(tmp_path):
    """Under a process group the microbatches run under DDP's no_sync and
    their float32 sums are all-reduced once per step: a one-rank gloo
    world takes that path and must end where the ungrouped step ends."""
    import torch.distributed as dist

    stream = torch.from_numpy(_stream(4 * 4 * 128).reshape(4, 4, 128))
    results = []
    for grouped in (False, True):
        if grouped:
            dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                                    rank=0, world_size=1)
        try:
            model = GPT2(**GEOM, device="cpu", seed=4)
            tx = make_optimizer(1e-3, weight_decay=0.1, clip_norm=1.0)
            state = create_train_state(model, tx)
            assert isinstance(state.module,
                              torch.nn.parallel.DistributedDataParallel) == grouped
            step = make_train_step(model, tx, loss_fn=lm_loss,
                                   input_key="tokens", label_key="tokens",
                                   grad_accum=2)
            losses = [float(step(state, {"tokens": b})[1]["loss"])
                      for b in stream]
            results.append((losses, state.params()))
        finally:
            if grouped:
                dist.destroy_process_group()
    (l0, p0), (l1, p1) = results
    assert l0 == l1
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k


WORKER = """
import sys
import torch
from tpudist_torch.train_gpt2 import main
out, batch = sys.argv[1], sys.argv[2]
state, losses = main(["--device", "cpu", "--vocab_size", "256", "--seq_len",
                      "64", "--hidden_dim", "64", "--depth", "2",
                      "--num_heads", "4", "--synthetic_tokens", "1536",
                      "--batch_size", batch, "--grad_accum", "2", "--lr",
                      "1e-3", "--no_profiler", "--log_dir", out + "_logs",
                      *sys.argv[3:]])
torch.save({"losses": losses, "params": state.params()}, out)
"""


def _launch(tmp_path, world, batch, extra=()):
    port = _free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, "PYTHONPATH": str(REPO), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "RANK": str(rank),
               "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
               "OMP_NUM_THREADS": "2"}
        out = tmp_path / f"w{world}_r{rank}.pt"
        procs.append((out, subprocess.Popen(
            [sys.executable, "-c", WORKER, str(out), str(batch), *extra],
            cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    try:
        results = []
        for out, proc in procs:
            log, _ = proc.communicate(timeout=120)
            assert proc.returncode == 0, log
            results.append(torch.load(out))
        return results
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()


def _free_port() -> int:
    from torch_ports import free_port

    return free_port()


def test_two_gloo_ranks_equal_one_process(tmp_path):
    """The CLI under DDP: two gloo ranks of 2 sequences x 2 microbatches
    each train as one process of 4 x 2 on the same windows (the sampler
    deals each rank every other window; every step's gradient is the mean
    over the same 8 sequences), the qkv key slice held to the step bound
    from its zero init as in test_three_steps_match_the_reference."""
    two = _launch(tmp_path, 2, 2)
    (one,) = _launch(tmp_path, 1, 4)
    steps = len(one["losses"])
    assert steps == 3
    for r in (*two, one):
        for k, p in r["params"].items():
            if k.endswith("qkv.bias"):
                assert np.abs(p.numpy()[1]).max() <= 1.5 * steps * 1e-3, k
    for r in two:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-5)
        for k, want in one["params"].items():
            g, w = r["params"][k].numpy(), want.numpy()
            if k.endswith("qkv.bias"):
                g, w = g[[0, 2]], w[[0, 2]]
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=k)


def test_two_gloo_ranks_with_chunked_ce_equal_one_process(tmp_path):
    """--chunked_ce under DDP: the chunked head reads wte outside the
    wrapped forward, and autograd sums its two uses into one gradient
    before DDP's hook on wte fires, so two gloo ranks still train as one
    process on the same windows (bars as in
    test_two_gloo_ranks_equal_one_process)."""
    two = _launch(tmp_path, 2, 2, ["--chunked_ce", "24"])
    (one,) = _launch(tmp_path, 1, 4, ["--chunked_ce", "24"])
    steps = len(one["losses"])
    assert steps == 3
    for r in two:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-5)
        for k, want in one["params"].items():
            g, w = r["params"][k].numpy(), want.numpy()
            if k.endswith("qkv.bias"):
                assert np.abs(g[1]).max() <= 1.5 * steps * 1e-3, k
                g, w = g[[0, 2]], w[[0, 2]]
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=k)


def test_flash_gpt2_matches_the_reference(kernel_parity):
    """attn_impl="flash" on both sides (the reference's kernel in interpret
    mode, its blockwise backward; the port's plain versions): the logits
    and every parameter's gradient of the LM loss, in float32."""
    jm = JGPT2(**FLASH_GEOM, attn_impl="flash")
    params = _flax_params(jm, seed=5)
    tokens = _stream(2 * 256, seed=6).reshape(2, 256)
    want = jm.apply({"params": params}, tokens, train=False)
    want_grads = gpt2_params_from_flax(jax.tree_util.tree_map(
        np.asarray, jax.grad(lambda p: jax_lm_loss(
            jm.apply({"params": p}, tokens, train=False), tokens))(params)))
    model = GPT2(**FLASH_GEOM, attn_impl="flash", device="cpu")
    model.load_state_dict(gpt2_params_from_flax(params))
    t = torch.from_numpy(tokens)
    got = model(t)
    lm_loss(got, t).backward()
    kernel_parity(got.detach().numpy(), np.asarray(want))
    for k, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_flash_chunked_ce_three_steps_match_the_reference():
    """The long-context leg's step at a test's size: attn_impl="flash",
    the chunked loss as forward_loss, fused LayerNorm and fused AdamW, three
    steps on both sides from the same weights (bars as in
    test_three_steps_match_the_reference)."""
    steps, batch = 3, 2
    loader = JaxTokenWindowLoader(_stream(), batch, 256)
    batches = [b for _, b in zip(range(steps), loader)]
    mesh = mesh_lib.create_mesh(devices=jax.devices()[:1])
    jm = JGPT2(**FLASH_GEOM, attn_impl="flash")
    opt_kw = dict(weight_decay=0.1, clip_norm=1.0, fused=True)
    jtx = jax_make_optimizer(
        jax_run_schedule(1e-3, total_steps=steps, warmup_steps=1), **opt_kw)
    jstate = jax_create_train_state(jm, 0, jnp.zeros((1, 256), jnp.int32),
                                    jtx, mesh)
    init = gpt2_params_from_flax(
        jax.tree_util.tree_map(np.asarray, meta.unbox(jstate.params)))
    jstep = jax_make_train_step(jm, jtx, mesh, loss_fn=jax_lm_loss,
                                input_key="tokens", label_key="tokens",
                                fused="all",
                                forward_loss=jax_chunked(jm, chunk=64))
    want_losses = []
    for b in batches:
        jstate, metrics = jstep(jstate, b)
        want_losses.append(float(metrics["loss"]))

    model = GPT2(**FLASH_GEOM, attn_impl="flash", device="cpu")
    model.load_state_dict(init)
    tx = make_optimizer(run_schedule(1e-3, total_steps=steps, warmup_steps=1),
                        **opt_kw)
    state = create_train_state(model, tx)
    step = make_train_step(model, tx, loss_fn=lm_loss, input_key="tokens",
                           label_key="tokens", fused="all",
                           forward_loss=chunked_lm_forward(model, chunk=64))
    losses = [float(step(state, {"tokens": torch.from_numpy(b["tokens"])})[1]
                    ["loss"]) for b in batches]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    want = gpt2_params_from_flax(
        jax.tree_util.tree_map(np.asarray, meta.unbox(jstate.params)))
    got = state.params()
    for k, w in want.items():
        g, w = got[k].numpy(), w.numpy()
        if k.endswith("qkv.bias"):
            start = init[k].numpy()[1]
            for side in (g[1], w[1]):
                assert np.abs(side - start).max() <= 1.5 * steps * 1e-3, k
            g, w = g[[0, 2]], w[[0, 2]]
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=k)


def test_fused_ln_forward_matches_the_reference(kernel_parity):
    """The fused_ln knob on the non-decode forward, bf16 compute: logits
    against the reference's fused model on the same weights."""
    jm = JGPT2(**GEOM, dtype=jnp.bfloat16, fused_ln=True)
    params = _flax_params(jm, seed=2)
    tokens = _stream(2 * 64, seed=3).reshape(2, 64)
    want = jm.apply({"params": params}, tokens, train=False)
    model = GPT2(**GEOM, dtype=torch.bfloat16, fused_ln=True, device="cpu")
    model.load_state_dict(gpt2_params_from_flax(params))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    # bf16 activations through two blocks: the repo's bf16 rule against
    # the logits' magnitude
    kernel_parity(got.numpy(), np.asarray(want, np.float32),
                  atol=2e-2 * float(np.abs(np.asarray(want)).max()))


def test_decay_mask_matches_the_references_leaves():
    """The reference decays every leaf of more than one dimension, which
    takes in flax's [3, heads, dh] qkv bias: the port holds that bias in
    the same shape, so the same rule decays the same leaves."""
    jm = JGPT2(**GEOM)
    params = _flax_params(jm)
    want = gpt2_params_from_flax(jax.tree_util.tree_map(
        lambda m: np.float32(m), jax_decay_mask(params)))
    model = GPT2(**GEOM, device="cpu")
    got = decay_mask(dict(model.named_parameters()))
    assert got.keys() == want.keys()
    assert {k: bool(v) for k, v in got.items()} == {
        k: bool(np.all(v.numpy())) for k, v in want.items()}
    assert got["h.0.qkv.bias"] and not got["h.0.out.bias"]


def test_gpt2_124m_leaf_split():
    """GPT-2 124M: 74 leaves of at least 1024 elements take the fused
    kernel, 74 small ones the shared formula (counted on the model's own
    leaves, without building its weights)."""
    from tpudist_torch.ops.fused_update import MIN_KERNEL_ELEMS

    with torch.device("meta"):
        model = GPT2(device="cpu")
    sizes = [p.numel() for p in model.parameters()]
    assert sum(n >= MIN_KERNEL_ELEMS for n in sizes) == 74
    assert sum(n < MIN_KERNEL_ELEMS for n in sizes) == 74
    assert sum(sizes) == 124_439_808


@pytest.mark.parametrize("replicas", [1, 2, 3])
def test_token_windows_equal_the_references(replicas):
    stream = _stream(5000)
    for rank in range(replicas):
        kw = dict(num_replicas=replicas, rank=rank, vocab_size=256)
        mine = TokenWindowLoader(stream, 3, 64, **kw)
        ref = JaxTokenWindowLoader(stream, 3, 64, **kw)
        assert len(mine) == len(ref) and mine.num_windows == ref.num_windows
        for epoch in (0, 1):
            mine.sampler.set_epoch(epoch)
            ref.sampler.set_epoch(epoch)
            got, want = list(mine), list(ref)
            assert len(got) == len(want) > 0
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_token_files_and_the_vocab_guard(tmp_path):
    from tpudist.data.lm import load_token_stream as jax_load
    from tpudist_torch.data.lm import load_token_stream

    ids = encode_bytes("the quick brown fox " * 20)
    np.testing.assert_array_equal(
        ids, np.frombuffer(b"the quick brown fox " * 20, np.uint8))
    ids.astype(np.uint16).tofile(tmp_path / "t.bin")
    np.save(tmp_path / "t.npy", ids)
    for name in ("t.bin", "t.npy"):
        np.testing.assert_array_equal(load_token_stream(tmp_path / name),
                                      jax_load(tmp_path / name))
    with pytest.raises(ValueError, match="outside"):
        next(iter(TokenWindowLoader(tmp_path / "t.bin", 2, 16,
                                    vocab_size=100)))
    with pytest.raises(ValueError, match="shorter"):
        TokenWindowLoader(ids[:10], 2, 16)


def test_lm_loss_matches_the_reference():
    rng = np.random.Generator(np.random.PCG64(4))
    logits = (rng.standard_normal((3, 17, 50)) * 3).astype(np.float32)
    tokens = rng.integers(0, 50, (3, 17)).astype(np.int32)
    want = float(jax_lm_loss(logits, tokens))
    got = float(lm_loss(torch.from_numpy(logits), torch.from_numpy(tokens)))
    np.testing.assert_allclose(got, want, rtol=2e-6)


def test_auto_resolves_like_the_reference():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert [resolve_attn("auto", s, cuda) for s in (128, 1024, 1025, 2047,
                                                    2048)] == [
        "vmem", "vmem", "xla", "xla", "flash"]
    assert resolve_attn("auto", 1024, cpu) == "xla"
    assert resolve_attn("vmem", 4096, cpu) == "vmem"


CLI = ["--device", "cpu", "--vocab_size", "256", "--seq_len", "64",
       "--hidden_dim", "64", "--depth", "2", "--num_heads", "4",
       "--batch_size", "2", "--synthetic_tokens", "2048", "--no_profiler"]


def test_cli_writes_the_tsv_and_the_tokens_line(tmp_path):
    """The command a user runs, on the CPU: the TSV header, rows every 5
    steps, the TrainTime footer and the reference's tokens/sec line."""
    proc = subprocess.run(
        [sys.executable, "-m", "tpudist_torch.train_gpt2", *CLI, "--bf16",
         "--fused", "all", "--attn", "vmem", "--log_dir", str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert re.search(r"^tokens/sec: [0-9.]+ \(global, incl\. the first step\) "
                     r"steps=16 final_loss=[0-9.]+$", proc.stdout, re.M)
    rows = (tmp_path / "GPT2_2_0.log").read_text().splitlines()
    assert rows[0] == "datetime\tg_step\tg_img\tloss_value\texamples_per_sec"
    assert [r.split("\t")[1:3] for r in rows[1:-1]] == [
        ["5", "10"], ["10", "20"], ["15", "30"]]
    assert rows[-1].startswith("TrainTime\t")


def test_cli_grad_accum_and_fused_ln(tmp_path):
    """--grad_accum 2 folds two microbatches into each of 8 steps; the
    fused-LN model trains and its loss falls on a repeated text."""
    tokens = tmp_path / "fox.bin"
    encode_bytes("the quick brown fox jumps over the lazy dog. " * 60).astype(
        np.uint16).tofile(tokens)
    state, losses = main([*CLI, "--tokens", str(tokens), "--grad_accum", "2",
                          "--fused", "ln", "--lr", "3e-3", "--epochs", "3",
                          "--log_dir", str(tmp_path)])
    assert len(losses) == 3 * 10 and np.isfinite(losses).all()
    assert losses[-1] < losses[0] - 1.0
    assert state.step == 30


#: ``--pipe`` is ported (tests/test_torch_pp_train.py runs it): in one
#: process a pipe layout needs the ranks it names, the reference's
#: refusals under it stand, and its unported compositions name #7c
_PIPE_RAISES = {
    "--pipe 2": (ValueError, "1 ranks not divisible by the fixed axes' "
                 "product 2"),
    "--tensor 2 --pipe 2": (ValueError, "1 ranks not divisible by the "
                            "fixed axes' product 4"),
    "--remat_policy full --pipe 2": (
        SystemExit, "--remat_policy is not supported with --pipe"),
    "--elastic --pipe 2": (NotImplementedError,
                           r"ROADMAP Queue 1 #7c \(remainder\)"),
}


#: ``--experts`` is ported (Queue 1 #7d); beside --fsdp it still raises
_EXPERTS_PORTED = {"--experts 4", "--shard_opt_state --experts 4",
                   "--experts 4 --arch llama"}


@pytest.mark.parametrize("flag", [
    ["--experts", "4"], ["--pipe", "2"], ["--tensor", "2", "--pipe", "2"],
    ["--fsdp", "2", "--tensor", "2", "--experts", "4"],
    ["--remat_policy", "full", "--pipe", "2"],
    ["--chaos", "bitflip@3"], ["--telemetry"], ["--elastic", "--pipe", "2"],
    ["--compile_cache", "cc"], ["--shard_opt_state", "--experts", "4"],
    ["--experts", "4", "--arch", "llama"],
], ids=lambda f: " ".join(f))
def test_unported_flags_raise(flag):
    if " ".join(flag) in _EXPERTS_PORTED:
        # ported since: the checks accept them
        # (tests/test_torch_ep_train.py trains them)
        from tpudist_torch.train_gpt2 import check_args, check_ported
        from tpudist_torch.train_gpt2 import parse_args as cli_args

        parser, args = cli_args([*CLI, *flag])
        check_ported(parser, args)
        check_args(args)
        return
    exc, match = _PIPE_RAISES.get(" ".join(flag), (
        NotImplementedError, r"ROADMAP Queue 1 #\d"))
    with pytest.raises(exc, match=match):
        main([*CLI, *flag])


@pytest.mark.parametrize("flag", [["--tensor", "2", "--cp", "2"],
                                  ["--fsdp", "2", "--tensor", "2"]],
                         ids=lambda f: " ".join(f))
def test_tensor_compositions_are_ported(flag):
    """``--tensor`` with ``--cp`` or ``--fsdp`` raised as unported until
    it was ported (tests/test_torch_tp_cp.py, test_torch_tp_fsdp.py run
    them): in one process the layout needs the 4 ranks it names."""
    with pytest.raises(ValueError,
                       match="1 ranks not divisible by the fixed axes' "
                       "product 4"):
        main([*CLI, *flag])


@pytest.mark.parametrize("flag,raises", [
    (["--cp", "2"], (ValueError, "1 ranks not divisible")),
    (["--eval", "--cp", "2"], (SystemExit, "support the non-cp")),
], ids=["--cp 2", "--eval --cp 2"])
def test_cp_with_the_default_attention_is_ported(flag, raises):
    """``--cp 2`` with the default ``--attn auto`` is the reference's
    gathered-sequence path, which raised as unported until it was
    ported: in one process it needs the 2 ranks it names, and ``--eval``
    keeps the reference's refusal."""
    with pytest.raises(raises[0], match=raises[1]):
        main([*CLI, *flag])


@pytest.mark.parametrize("flag", [
    ["--attn", "ring"], ["--attn", "ulysses"], ["--attn", "ulysses_flash"],
    ["--attn", "ring", "--arch", "llama"],
], ids=lambda f: " ".join(f))
def test_context_parallel_flags_run(flag, tmp_path):
    """The context-parallel attentions, which raised until they were
    ported, train at ``--cp 1`` (one rank, no collective; the gloo worlds
    of tests/test_torch_cp_train.py hold ``--cp 2`` to the reference)."""
    state, losses = main([*CLI, *flag, "--log_dir", str(tmp_path)])
    assert len(losses) == 16 and np.isfinite(losses).all()
    assert state.model.attn_impl == flag[1]


@pytest.mark.parametrize("flag", [
    ["--arch", "llama"], ["--arch", "llama", "--num_kv_heads", "2"],
    ["--arch", "llama", "--num_kv_heads", "1", "--ffn_dim", "96",
     "--rope_theta", "500000", "--tie_embeddings"],
    ["--num_kv_heads", "2", "--ffn_dim", "96"],
], ids=lambda f: " ".join(f))
def test_llama_flags_run(flag, tmp_path):
    """The Llama flags that raised before Llama was ported now train
    (``tests/test_torch_llama.py`` holds them to the reference); under
    ``--arch gpt2`` the reference ignores them, and so does the port."""
    state, losses = main([*CLI, *flag, "--epochs", "1", "--total_steps",
                          "16", "--log_dir", str(tmp_path)])
    assert len(losses) == 16 and np.isfinite(losses).all()
    llama = "llama" in flag
    assert type(state.model).__name__ == ("Llama" if llama else "GPT2")
    if llama:
        kv = int(flag[flag.index("--num_kv_heads") + 1]) if \
            "--num_kv_heads" in flag else 4
        assert state.model.num_kv_heads == kv
        assert state.model.tie_embeddings == ("--tie_embeddings" in flag)


@pytest.mark.parametrize("flag,error,match", [
    (["--scan_layers", "--generate", "8"], SystemExit, "--scan_layers"),
    (["--scan_layers", "--init_hf", "x"], SystemExit, "--scan_layers"),
    (["--remat_layers"], ValueError, "remat_layers requires scan_layers"),
    (["--dropout", "0.1", "--chunked_ce", "16"], ValueError, "dropout"),
    (["--generate", "64"], SystemExit, "must be < --seq_len"),
    (["--optimizer", "lion", "--fused", "all"], ValueError, "adam"),
    (["--amp", "--optimizer", "muon", "--fused", "optimizer"], ValueError,
     "adam"),
    (["--init_hf", "no/such/dir"], FileNotFoundError, "no/such/dir"),
    (["--remat", "bogus"], SystemExit, "2"),
    (["--dropout", "0.1", "--arch", "llama"], SystemExit, "dropout"),
    (["--arch", "llama", "--scan_layers", "--generate", "8"], SystemExit,
     "--scan_layers"),
    (["--generate", "8", "--top_k", "5", "--attn", "ring"], SystemExit,
     "no decode path"),
], ids=lambda f: " ".join(f) if isinstance(f, list) else "")
def test_refused_where_the_reference_refuses(flag, error, match, tmp_path):
    with pytest.raises(error, match=match):
        main([*CLI, *flag, "--log_dir", str(tmp_path)])


def test_runs_on_the_card_by_default(monkeypatch):
    """Without --device cpu the CLI wants the card and raises without one
    (it never carries on silently on the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([a for a in CLI if a not in ("--device", "cpu")])
