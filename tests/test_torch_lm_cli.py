"""The LM CLI's newly ported legs (tpudist_torch.train_gpt2 ``--optimizer``,
``--amp``, ``--eval``, ``--generate``, ``--init_hf``) and the HF bridge
(tpudist_torch.interop) against the JAX reference, at depth 2, width 64,
S 32 on the CPU.

Both CLIs start from one HF checkpoint written here by transformers'
``GPT2LMHeadModel`` (random init), so they run the same weights:
``--optimizer sgd|lamb|lion|muon`` over three steps gives losses within
1e-5 relative and parameters within 1e-5 of ``examples/train_gpt2.main``
(whose 8 emulated devices take one sequence each of the port's batch of
8), except the key slice of the qkv biases, whose gradient is zero in
exact arithmetic (each framework's rounding noise, which sign-based and
normalized updates turn into up to a step of lr): it is held to the step
bound, as in tests/test_torch_gpt2_train.py. ``--eval`` is
``tpudist.train.evaluate_lm`` within 1e-5 with a ragged last batch, with
and without the chunked head; ``--generate`` at temperature 0 is
``tpudist.generate.generate``'s stream. The port's safetensors codec
reads and writes what the ``safetensors`` package does.

Context parallelism at the CLI: ``--attn ring|ulysses`` at ``--cp 1``
gives the reference CLI's losses within 1e-5 relative and its
parameters within 1e-4 relative plus 1e-4 absolute after three AdamW
steps at lr 1e-3 (tests/test_torch_gpt2_train.py's trainer bar: a tenth
of a step; the qkv key slice to its step bound); ``--cp 2``
runs in a world it divides (tests/test_torch_cp_train.py) and refuses
one it does not; ``--cp 2`` with a non-CP ``--attn`` names ROADMAP Queue
1 #5 (remainder); ``--generate`` with a CP attention and ``--eval`` with
``--cp 2`` exit before training, as the reference's do."""

import contextlib
import io
import re
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tpudist.data.lm import TokenWindowLoader as JaxTokenWindowLoader
from tpudist.generate import generate as jax_generate
from tpudist.interop import load_hf_params as jax_load_hf_params
from tpudist.models.gpt2 import GPT2 as JGPT2
from tpudist.train import evaluate_lm as jax_evaluate_lm
from tpudist_torch import interop
from tpudist_torch import train as train_mod
from tpudist_torch.data.lm import TokenWindowLoader, encode_bytes
from tpudist_torch.interop import gpt2_params_from_flax
from tpudist_torch.models.gpt2 import GPT2
from tpudist_torch.train import evaluate_lm
from tpudist_torch.train_gpt2 import main

REPO = Path(__file__).resolve().parent.parent
S, DEPTH, HEADS, WIDTH = 32, 2, 4, 64
GEOM = dict(vocab_size=256, max_seq_len=S, hidden_dim=WIDTH, depth=DEPTH,
            num_heads=HEADS)
ARGS = ["--vocab_size", "256", "--seq_len", str(S), "--hidden_dim",
        str(WIDTH), "--depth", str(DEPTH), "--num_heads", str(HEADS),
        "--no_profiler"]
TEXT = b"the quick brown fox jumps over the lazy dog. " * 40


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # several pytest-xdist workers share the host (tests/test_torch_train.py)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def hf(tmp_path_factory):
    """A random-init HF GPT-2 saved as safetensors and as a .bin, the
    model itself, and byte-token files: three steps of 8 windows, and a
    5-window held-out stream."""
    with pytest.MonkeyPatch.context() as mp:
        # transformers would import TensorFlow too, for nothing here
        mp.setenv("USE_TF", "0")
        from transformers import GPT2Config, GPT2LMHeadModel

    root = tmp_path_factory.mktemp("hf")
    torch.manual_seed(0)
    cfg = GPT2Config(vocab_size=256, n_positions=S, n_embd=WIDTH,
                     n_layer=DEPTH, n_head=HEADS, resid_pdrop=0.0,
                     embd_pdrop=0.0, attn_pdrop=0.0)
    model = GPT2LMHeadModel(cfg).eval()
    model.save_pretrained(root / "st", safe_serialization=True)
    model.save_pretrained(root / "bin", safe_serialization=False)
    tokens = encode_bytes(TEXT)
    tokens[:3 * 8 * S].astype(np.uint16).tofile(root / "train.bin")
    tokens[1000:1000 + 5 * S].astype(np.uint16).tofile(root / "val.bin")
    return types.SimpleNamespace(root=root, st=root / "st", bin=root / "bin",
                                 model=model, train=root / "train.bin",
                                 val=root / "val.bin")


def _port(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state, losses = main([*ARGS, "--device", "cpu", *argv])
    return state, losses, out.getvalue()


def _reference_cli(argv):
    sys.path.insert(0, str(REPO / "examples"))
    try:
        import train_gpt2 as ref
    finally:
        sys.path.pop(0)
    with contextlib.redirect_stdout(io.StringIO()):
        return ref.main([*ARGS, *argv])


def _jax_params(path):
    return jax_load_hf_params(path, arch="gpt2", depth=DEPTH, num_heads=HEADS)


@pytest.mark.parametrize("optimizer", ["sgd", "lamb", "lion", "muon"])
def test_optimizers_match_the_reference_cli(optimizer, hf, tmp_path):
    flags = ["--tokens", str(hf.train), "--init_hf", str(hf.st), "--lr",
             "3e-3", "--warmup_steps", "0", "--optimizer", optimizer,
             "--log_dir", str(tmp_path)]
    jstate, want_losses = _reference_cli([*flags, "--batch_size", "1"])
    state, losses, _ = _port([*flags, "--batch_size", "8"])
    assert len(losses) == len(want_losses) == 3
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    want = gpt2_params_from_flax(jax.tree_util.tree_map(
        np.asarray, jstate.params))
    got = state.params()
    start = interop.load_hf_params(hf.st, arch="gpt2", depth=DEPTH,
                                   num_heads=HEADS)
    for k, w in want.items():
        g, w = got[k].numpy(), w.numpy()
        if k.endswith("qkv.bias"):
            moved = np.abs(np.stack([g[1], w[1]]) - start[k].numpy()[1])
            assert moved.max() <= 1.5 * 3 * 3e-3, k
            g, w = g[[0, 2]], w[[0, 2]]
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=k)


def test_amp_skips_a_step_fed_an_inf_and_says_so(hf, tmp_path, monkeypatch):
    calls, lm_loss = [], train_mod.lm_loss

    def poisoned(logits, tokens):
        calls.append(1)
        loss = lm_loss(logits, tokens)
        return loss * float("inf") if len(calls) == 2 else loss

    monkeypatch.setattr(train_mod, "lm_loss", poisoned)
    state, losses, out = _port(["--tokens", str(hf.train), "--batch_size", "8",
                                "--amp", "--log_dir", str(tmp_path)])
    assert len(losses) == 3 and not np.isfinite(losses[1])
    assert np.isfinite([losses[0], losses[2]]).all()
    assert "amp: skipped 1 non-finite update step(s)" in out
    assert state.model.dtype == torch.bfloat16


@pytest.mark.parametrize("chunk", [0, 8], ids=["full-logits", "chunked"])
def test_eval_is_the_references_evaluate_lm(chunk, hf, tmp_path):
    state, _, out = _port(["--tokens", str(hf.train), "--init_hf", str(hf.st),
                           "--epochs", "0", "--eval", "--val_tokens",
                           str(hf.val), "--batch_size", "2", "--chunked_ce",
                           str(chunk), "--log_dir", str(tmp_path)])
    # 5 windows in batches of 2: the last batch holds one
    loader = TokenWindowLoader(np.fromfile(hf.val, np.uint16), 2, S,
                               shuffle=False, drop_remainder=False)
    assert [len(b["tokens"]) for b in loader] == [2, 2, 1]
    got = evaluate_lm(state, loader, chunk=chunk or None)
    jloader = JaxTokenWindowLoader(np.fromfile(hf.val, np.uint16), 2, S,
                                   shuffle=False, drop_remainder=False)
    want = jax_evaluate_lm(JGPT2(**GEOM), types.SimpleNamespace(
        params=_jax_params(hf.st)), jloader, chunk=chunk or None)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["perplexity"], want["perplexity"],
                               rtol=1e-5)
    assert (f"val_loss: {got['loss']:.4f} perplexity: "
            f"{got['perplexity']:.2f}") in out


def test_generate_is_the_references_greedy_stream(hf, tmp_path):
    new = 8
    state, _, out = _port(["--tokens", str(hf.train), "--init_hf", str(hf.st),
                           "--epochs", "0", "--generate", str(new),
                           "--temperature", "0", "--batch_size", "2",
                           "--log_dir", str(tmp_path)])
    got = [int(t) for t in re.search(r"generated tokens: \[([0-9, ]*)\]",
                                     out).group(1).split(",")]
    assert re.search(r"^generated text: '.*'$", out, re.M)
    prompt = np.fromfile(hf.train, np.uint16)[:min(32, S - new)].astype(
        np.int32)[None]
    want = jax_generate(JGPT2(**GEOM), _jax_params(hf.st), prompt, new,
                        temperature=0.0)[0].tolist()
    assert got == want
    # the margin the agreement stood on
    seq = torch.from_numpy(np.concatenate([prompt[0], got[:-1]]))[None].long()
    with torch.no_grad():
        logits = state.model.eval()(seq)[0, prompt.shape[1] - 1:]
    top = torch.topk(logits, 2, dim=-1).values
    print(f"smallest top-2 gap {float((top[:, 0] - top[:, 1]).min()):.3e}")


@pytest.mark.parametrize("fmt", ["st", "bin"])
def test_init_hf_loads_the_references_weights(fmt, hf):
    path = getattr(hf, fmt)
    got = interop.load_hf_params(path, arch="gpt2", depth=DEPTH,
                                 num_heads=HEADS)
    want = gpt2_params_from_flax(_jax_params(path))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_init_hf_computes_transformers_logits_and_round_trips(hf, tmp_path):
    sd = interop.load_hf_params(hf.st, arch="gpt2", depth=DEPTH,
                                num_heads=HEADS)
    model = GPT2(**GEOM, device="cpu")
    model.load_state_dict(sd)
    tokens = torch.from_numpy(encode_bytes(TEXT[:2 * S]).reshape(2, S)).long()
    with torch.no_grad():
        got = model(tokens)
        want = hf.model(tokens).logits
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4, rtol=0)
    back = interop.gpt2_params_from_hf(
        interop.gpt2_params_to_hf(sd, depth=DEPTH), depth=DEPTH,
        num_heads=HEADS)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    # written by the port, read by transformers
    interop.save_hf_checkpoint(sd, tmp_path, arch="gpt2", depth=DEPTH)
    hf.model.config.save_pretrained(tmp_path)
    from transformers import GPT2LMHeadModel

    reread = GPT2LMHeadModel.from_pretrained(tmp_path).eval()
    with torch.no_grad():
        assert torch.equal(reread(tokens).logits, want)
    # a longer position table than --seq_len: its head, as the reference
    # reads wpe[:seq_len]
    state, _, _ = _port(["--seq_len", "16", "--init_hf", str(tmp_path),
                         "--epochs", "0", "--synthetic_tokens", "256",
                         "--log_dir", str(tmp_path)])
    assert torch.equal(state.model.wpe.detach(), sd["wpe"][:16])


def _encoder_family(arch):
    """A random port model of ``arch`` at a test's size, its state dict,
    its depth and heads."""
    from tpudist_torch.models.bert import Bert
    from tpudist_torch.models.t5 import T5

    if arch == "bert":
        model = Bert(vocab_size=99, max_seq_len=32, hidden_dim=32, depth=2,
                     num_heads=4, device="cpu", seed=4)
    else:
        model = T5(vocab_size=99, hidden_dim=32, ffn_dim=48, enc_depth=2,
                   dec_depth=2, num_heads=4, device="cpu", seed=4)
    with torch.no_grad():  # no zero or unit leaf left to hide a swap
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator()
                               .manual_seed(p.numel())) * 0.1)
    return model.state_dict(), 2, 4


@pytest.mark.parametrize("arch", ["bert", "t5"])
def test_encoder_hf_bridge_round_trips_through_safetensors(arch, tmp_path):
    """The port's state dict -> an HF-layout model.safetensors -> back,
    bit for bit, every entry."""
    sd, depth, heads = _encoder_family(arch)
    interop.save_hf_checkpoint(sd, tmp_path, arch=arch, depth=depth)
    back = interop.load_hf_params(tmp_path, arch=arch, depth=depth,
                                  num_heads=heads)
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


@pytest.mark.parametrize("arch", ["bert", "t5"])
def test_encoder_hf_bridge_is_the_references(arch, tmp_path):
    """The HF state dict the port writes, read by the reference's
    converter (``tpudist.interop``) and carried across from flax, is the
    port's own reading of it; and the reference's writer gives the port's
    HF names and values."""
    from tpudist import interop as jax_interop
    from tpudist_torch.interop import bert_params_from_flax, t5_params_from_flax

    sd, depth, heads = _encoder_family(arch)
    interop.save_hf_checkpoint(sd, tmp_path, arch=arch, depth=depth)
    hf = {k: v.numpy() for k, v in interop.load_hf_state_dict(tmp_path).items()}
    if arch == "bert":
        flax = jax_interop.bert_params_from_hf(hf, depth=depth, num_heads=heads)
        want = bert_params_from_flax(flax)
        written = jax_interop.bert_params_to_hf(flax, depth=depth)
    else:
        flax = jax_interop.t5_params_from_hf(hf, enc_depth=depth,
                                             dec_depth=depth, num_heads=heads)
        want = t5_params_from_flax(flax)
        written = jax_interop.t5_params_to_hf(flax, enc_depth=depth,
                                              dec_depth=depth)
    got = interop.load_hf_params(tmp_path, arch=arch, depth=depth,
                                 num_heads=heads)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert written.keys() == hf.keys()
    for k in hf:
        np.testing.assert_array_equal(np.asarray(written[k]), hf[k], err_msg=k)


def test_unknown_arch_is_refused(tmp_path):
    with pytest.raises(ValueError, match="unknown arch 'vit'"):
        interop.load_hf_params(tmp_path, arch="vit", depth=1, num_heads=1)
    with pytest.raises(ValueError, match="unknown arch 'vit'"):
        interop.save_hf_checkpoint({}, tmp_path, arch="vit", depth=1)


def _tensors():
    g = torch.Generator().manual_seed(3)
    return {
        "f32": torch.randn(3, 5, generator=g),
        "bf16": torch.randn(7, generator=g).to(torch.bfloat16),
        "f16": torch.randn(2, 2, generator=g).to(torch.float16),
        "i64": torch.arange(-4, 5),
        "u8": torch.arange(9, dtype=torch.uint8).reshape(3, 3),
        "bool": torch.tensor([True, False, True]),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 4),
    }


def test_safetensors_codec_reads_and_writes_the_packages_format(tmp_path):
    from safetensors.torch import load_file, save_file

    tensors = _tensors()
    interop.write_safetensors(tensors, tmp_path / "mine.safetensors",
                              metadata={"format": "pt"})
    theirs = load_file(str(tmp_path / "mine.safetensors"))
    save_file(tensors, str(tmp_path / "theirs.safetensors"),
              metadata={"format": "pt"})
    mine = interop.read_safetensors(tmp_path / "theirs.safetensors")
    for got in (theirs, mine):
        assert got.keys() == tensors.keys()
        for k, t in tensors.items():
            assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    with open(tmp_path / "mine.safetensors", "rb") as f:
        assert int.from_bytes(f.read(8), "little") % 8 == 0
    (tmp_path / "short.safetensors").write_bytes(b"\x10")
    with pytest.raises(ValueError, match="too short"):
        interop.read_safetensors(tmp_path / "short.safetensors")


@pytest.mark.parametrize("attn", ["ring", "ulysses"])
def test_cp_one_matches_the_reference_cli(attn, hf, tmp_path):
    flags = ["--tokens", str(hf.train), "--init_hf", str(hf.st), "--lr",
             "1e-3", "--warmup_steps", "0", "--attn", attn, "--log_dir",
             str(tmp_path)]
    jstate, want_losses = _reference_cli([*flags, "--batch_size", "1"])
    state, losses, _ = _port([*flags, "--batch_size", "8"])
    assert len(losses) == len(want_losses) == 3
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    want = gpt2_params_from_flax(jax.tree_util.tree_map(
        np.asarray, jstate.params))
    got = state.params()
    start = interop.load_hf_params(hf.st, arch="gpt2", depth=DEPTH,
                                   num_heads=HEADS)
    for k, w in want.items():
        g, w = got[k].numpy(), w.numpy()
        if k.endswith("qkv.bias"):
            moved = np.abs(np.stack([g[1], w[1]]) - start[k].numpy()[1])
            assert moved.max() <= 1.5 * 3 * 1e-3, k
            g, w = g[[0, 2]], w[[0, 2]]
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4, err_msg=k)


def test_cp_refusals_are_the_references(tmp_path):
    base = ["--synthetic_tokens", "2048", "--log_dir", str(tmp_path)]
    # a non-context-parallel --attn under --cp attends over the gathered
    # sequence (tests/test_torch_cp_gather.py); one rank cannot hold 2
    for attn in ("flash", "ring"):
        with pytest.raises(ValueError, match="1 ranks not divisible"):
            _port([*base, "--cp", "2", "--attn", attn])
    for argv, match in ((["--generate", "8", "--attn", "ulysses"],
                         "has no decode path"),
                        (["--eval", "--cp", "2", "--attn", "ring"],
                         "support the non-cp")):
        with pytest.raises(SystemExit, match=match) as port:
            _port([*base, *argv])
        with pytest.raises(SystemExit) as ref:
            _reference_cli([*base, *argv])
        assert str(port.value) == str(ref.value)
