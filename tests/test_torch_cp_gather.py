"""A non-context-parallel attention over the gathered sequence
(tpudist_torch.parallel.cp.gathered_attention) and ``train_gpt2 --cp N``
with ``--attn xla|vmem|flash|auto``, on the CPU.

- ``gathered_attention`` through the loopback exchange (all n ranks in
  this process) at n = 2 and 4, for the dense path and the vmem and flash
  kernels' plain versions, causal and not, with grouped K/V heads (4 query
  heads over 2): the output and the q, k, v gradients of a random
  cotangent are bit-identical to one call on the whole sequence;
- the refusals: decode under a seq axis in both model families, BERT with
  a non-context-parallel attention under one, a training step whose model
  was built on another layout;
- ``--attn auto`` resolves by the global ``--seq_len``;
- ``train_gpt2 --cp 2`` in gloo worlds of 2 ranks, GPT-2 with ``--attn
  xla`` and Llama (GQA 4/2) with ``--attn vmem --chunked_ce 8``, each
  against the JAX reference's ``make_train_step`` with ``attn_impl="xla"``
  on ``MeshConfig(data=1, seq=2)`` over 2 of conftest.py's fake devices
  (tests/test_torch_cp_train.py's harness and bars: losses within 2e-5
  relative, parameters within 1e-4 absolute, float32 on both sides).
"""

import functools
import warnings

import numpy as np
import pytest
import torch

from test_torch_cp_train import (
    GEOM, LLAMA, LR, STEPS, B, S, V, _assert_params, _collect,
    _global_batches, _launch, _reference,
)
from tpudist_torch.mesh import RankLayout
from tpudist_torch.models.bert import Bert
from tpudist_torch.models.gpt2 import GPT2
from tpudist_torch.models.llama import Llama
from tpudist_torch.ops.attention import multi_head_attention
from tpudist_torch.optim import make_optimizer
from tpudist_torch.parallel import cp
from tpudist_torch.train import make_train_step
from tpudist_torch.train_gpt2 import resolve_attn


def _inputs(b=2, s=64, h=4, h_kv=2, d=16, seed=0):
    rng = np.random.Generator(np.random.PCG64(seed))
    q = rng.standard_normal((b, s, h, d), np.float32)
    k, v = (rng.standard_normal((b, s, h_kv, d), np.float32)
            for _ in range(2))
    g = rng.standard_normal((b, s, h, d), np.float32)
    return [torch.from_numpy(x) for x in (q, k, v, g)]


def _run(fn, q, k, v, g):
    """``fn``'s output and the gradients of ``sum(out * g)``."""
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    out = fn(q, k, v)
    out.backward(g)
    return [out.detach(), q.grad, k.grad, v.grad]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("impl", ["xla", "vmem", "flash"])
def test_gathered_attention_is_the_whole_sequence_call(impl, causal, n):
    q, k, v, g = _inputs()
    attn_fn = functools.partial(multi_head_attention, impl=impl)
    with warnings.catch_warnings():
        # a kernel falling back to the dense path warns: make it fail
        warnings.simplefilter("error")
        want = _run(lambda a, b, c: attn_fn(a, b, c, causal=causal),
                    q, k, v, g)
        got = _run(lambda a, b, c: cp.gathered_attention_loopback(
            a, b, c, n, causal=causal, attn_fn=attn_fn), q, k, v, g)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, name
        assert torch.equal(a, b), (name, (a - b).abs().max())


def test_gathered_attention_at_one_rank_is_the_call():
    q, k, v, g = _inputs(seed=1)
    want = _run(lambda a, b, c: multi_head_attention(a, b, c, causal=True),
                q, k, v, g)
    got = _run(lambda a, b, c: cp.gathered_attention_local(
        a, b, c, causal=True), q, k, v, g)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _seq_layout(seq=2):
    """A layout of seq ranks whose groups are never used (refusals)."""
    return RankLayout(rank=0, data=1, seq=seq)


@pytest.mark.parametrize("cls", [GPT2, Llama])
def test_decode_under_a_seq_axis_is_refused(cls):
    model = cls(vocab_size=V, max_seq_len=S, hidden_dim=32, depth=1,
                num_heads=4, attn_impl="xla", layout=_seq_layout(),
                device="cpu")
    with pytest.raises(ValueError, match="no decode path"):
        model(torch.zeros((1, 1), dtype=torch.long),
              cache=model.init_cache(1))


def test_bert_keeps_the_references_refusal():
    with pytest.raises(ValueError, match="sequence-parallel attention"):
        Bert(vocab_size=V, max_seq_len=S, hidden_dim=32, depth=1,
             num_heads=4, attn_impl="xla", layout=_seq_layout(),
             device="cpu")


def test_a_step_on_another_layout_is_refused():
    model = GPT2(vocab_size=V, max_seq_len=S, hidden_dim=32, depth=1,
                 num_heads=4, device="cpu")
    tx = make_optimizer(1e-3)
    with pytest.raises(ValueError, match="same layout"):
        make_train_step(model, tx, layout=_seq_layout())


def test_auto_resolves_by_the_global_sequence():
    """``--cp 2 --seq_len 2048``: each rank holds 1024 positions, the
    attention sees 2048, so ``auto`` takes flash, as the reference's
    resolution by the global ``--seq_len`` does."""
    cuda = torch.device("cuda")
    assert resolve_attn("auto", 2048, cuda) == "flash"
    assert resolve_attn("auto", 1024, cuda) == "vmem"
    assert resolve_attn("auto", 1536, cuda) == "xla"
    assert resolve_attn("auto", 4096, torch.device("cpu")) == "xla"


CLI_CASES = [
    ("gpt2", "xla", []),
    ("llama", "vmem", ["--chunked_ce", "8"]),
]


@pytest.mark.parametrize("arch,attn,extra", CLI_CASES,
                         ids=[f"{a}-{m}" for a, m, _ in CLI_CASES])
def test_gathered_cp_training_matches_the_reference(arch, attn, extra,
                                                    tmp_path):
    cp_n, dp = 2, 1
    chunk = 8 if "--chunked_ce" in extra else 0
    rng = np.random.Generator(np.random.PCG64(11))
    stream = rng.integers(0, V, STEPS * B * dp * S).astype(np.uint16)
    stream.tofile(tmp_path / "tokens.bin")
    geom = ["--vocab_size", str(V), "--seq_len", str(S), "--hidden_dim",
            str(GEOM["hidden_dim"]), "--depth", str(GEOM["depth"]),
            "--num_heads", str(GEOM["num_heads"])]
    if arch == "llama":
        geom += ["--arch", "llama", "--num_kv_heads",
                 str(LLAMA["num_kv_heads"]), "--ffn_dim", str(LLAMA["ffn_dim"])]
    init, reference = _reference(arch, "xla", dp, cp_n, 1, chunk, False, None)
    torch.save(init, tmp_path / "init.pt")
    ranks = _launch(tmp_path, "cp", cp_n, [
        *geom, "--tokens", str(tmp_path / "tokens.bin"), "--lr", str(LR),
        "--warmup_steps", "0", "--total_steps", str(STEPS), "--no_profiler",
        *extra, "--cp", str(cp_n), "--attn", attn, "--batch_size", str(B),
        "--log_dir", str(tmp_path / "cp"), "--JobID", "CP"])
    want_losses, want = reference(_global_batches(stream, dp, 1))
    for rank, r in enumerate(_collect(ranks)):
        np.testing.assert_allclose(r["losses"], want_losses, rtol=2e-5,
                                   err_msg=f"rank {rank}")
        _assert_params(r["params"], want, f"rank {rank}")
