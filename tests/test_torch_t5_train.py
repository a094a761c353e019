"""T5 training through the port's CLI (tpudist_torch.train_t5) against
``examples/train_t5.py`` on the CPU.

One process against the reference's 8 emulated devices (a sequence
each), from one init: the reference's flax init, handed to its ``fit``
as ``init_params`` and to the port's model through
``interop.t5_params_from_flax``. A byte corpus, windows of 64 corrupted
into (encoder 58, decoder 14) by the same ``(seed, epoch, start)``
keying, d 64, ffn 128, 2 + 2 layers, 4 heads, four Adam steps at 1e-3:
the losses within 1e-5 relative, the TSV rows, the parameters within
1e-4 absolute (float32 on both sides, summed in other orders) but for at
most 0.1% of a tensor's elements, which stay within the Adam step bound
of steps x lr (a coordinate whose gradient is within rounding of zero is
moved by up to lr a step either way; the first reading had one such
element of 8192 in ``enc.0.mlp.wo``, 9.3e-4 apart), then
``--eval``'s span loss and accuracy (2e-4; against the reference model's
scores of the port's eval batches, see there) and ``--generate``'s greedy
tokens, equal. Then the refusal of ``--tensor``.
"""

import contextlib
import io
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from tpudist.models.t5 import T5 as JT5
from tpudist.models.t5 import span_corruption_plan
from tpudist_torch import interop
from tpudist_torch.data.lm import encode_bytes
from tpudist_torch.train_t5 import main

REPO = Path(__file__).resolve().parent.parent
S, STEPS = 64, 4
FLAGS = ["--seq_len", str(S), "--hidden_dim", "64", "--ffn_dim", "128",
         "--enc_depth", "2", "--dec_depth", "2", "--num_heads", "4",
         "--no_profiler"]
TEXT = b"the quick brown fox jumps over the lazy dog. " * 80


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _rows(path):
    lines = path.read_text().splitlines()
    assert lines[0] == "datetime\tg_step\tg_img\tloss_value\texamples_per_sec"
    assert lines[-1].startswith("TrainTime\t")
    return [(int(f[2]), float(f[3])) for f in
            (line.split("\t") for line in lines[1:-1])]


def _line(text, name):
    return text.split(f"{name}: ")[1].split("\n")[0]


def test_cli_matches_the_reference_cli(tmp_path, monkeypatch):
    tokens = encode_bytes(TEXT)
    tokens[:STEPS * 8 * S].astype(np.uint16).tofile(tmp_path / "train.bin")
    tokens[2000:2000 + 8 * S].astype(np.uint16).tofile(tmp_path / "val.bin")
    _, spans, enc_len, dec_len = span_corruption_plan(S)
    jm = JT5(vocab_size=256 + spans + 1, hidden_dim=64, ffn_dim=128,
             enc_depth=2, dec_depth=2, num_heads=4,
             max_decode_len=dec_len + 1)
    # the reference's init and eval forward under jax.jit: one compiled
    # program each instead of a dispatch per operation
    init = jax.tree_util.tree_map(np.asarray, meta.unbox(jax.jit(
        lambda: jm.init(jax.random.key(3), (
            jnp.zeros((1, enc_len), jnp.int32),
            jnp.zeros((1, dec_len), jnp.int32)), train=False)["params"])()))

    import tpudist.train as jax_train

    fit = jax_train.fit
    monkeypatch.setattr(jax_train, "fit",
                        lambda *a, **kw: fit(*a, init_params=init, **kw))
    sys.path.insert(0, str(REPO / "examples"))
    try:
        import train_t5 as ref
    finally:
        sys.path.pop(0)
    flags = ["--tokens", str(tmp_path / "train.bin"), "--val_tokens",
             str(tmp_path / "val.bin"), "--eval", "--generate"]
    want_out = io.StringIO()
    with contextlib.redirect_stdout(want_out):
        jstate, want_losses = ref.main(
            [*FLAGS, *flags, "--batch_size", "1", "--log_dir",
             str(tmp_path / "ref")])

    import tpudist_torch.models.t5 as MT

    T5 = MT.T5

    def loaded(*args, **kw):
        model = T5(*args, **kw)
        model.load_state_dict(interop.t5_params_from_flax(init))
        return model

    monkeypatch.setattr(MT, "T5", loaded)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        state, losses = main([*FLAGS, *flags, "--device", "cpu",
                              "--batch_size", "8", "--log_dir",
                              str(tmp_path / "port")])
    assert len(losses) == len(want_losses) == STEPS
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    got_rows = _rows(tmp_path / "port" / "T5_0_8_0.log")
    want_rows = _rows(tmp_path / "ref" / "T5_0_1_0.log")
    assert [g for g, _ in got_rows] == [g for g, _ in want_rows]
    np.testing.assert_allclose([v for _, v in got_rows],
                               [v for _, v in want_rows], rtol=1e-5)
    want = interop.t5_params_from_flax(
        jax.tree_util.tree_map(np.asarray, meta.unbox(jstate.params)))
    got = state.params()
    assert got.keys() == want.keys()
    for k, w in want.items():
        diff = np.abs(got[k].numpy() - w.numpy())
        off = diff > 1e-4
        assert off.mean() <= 1e-3 and diff.max() <= STEPS * 1e-3, k
    text, want_text = out.getvalue(), want_out.getvalue()
    assert f"steps={STEPS} " in text
    # --eval: the reference's loader batch is its per-process --batch_size
    # (1 here, 8 windows in 8 batches) and the corruption is keyed by each
    # batch's start, so its printed metrics are of other corruptions; the
    # port's are held to the reference model's scores of the port's eval
    # batches (one batch of the 8 windows, keyed at start 0)
    from tpudist.data.lm import TokenWindowLoader as JLoader
    from tpudist.models.t5 import span_corrupt_transform

    val = JLoader(str(tmp_path / "val.bin"), 8, S, dtype=np.uint16,
                  vocab_size=256, shuffle=False,
                  transform=span_corrupt_transform(jm.vocab_size,
                                                   seed=10_000))
    ce, hits, n = 0.0, 0, 0
    apply = jax.jit(lambda p, e, d: jm.apply({"params": p}, e, d,
                                             train=False))
    for b in val:
        logits = apply(jstate.params, b["enc_tokens"], b["dec_tokens"])
        logp = jax.nn.log_softmax(logits, axis=-1)
        tgt = b["targets"]
        ce -= float(np.take_along_axis(np.asarray(logp), tgt[..., None],
                                       -1).sum())
        hits += int((np.asarray(logits).argmax(-1) == tgt).sum())
        n += tgt.size
    got_loss, got_acc = (float(x) for x in _line(text, "span_loss").split()
                         [::2])
    np.testing.assert_allclose(got_loss, ce / n, atol=2e-4)
    np.testing.assert_allclose(got_acc, hits / n, atol=2e-4)
    for name in ("generated span tokens", "true span targets",
                 "generation_span_match"):
        assert _line(text, name) == _line(want_text, name), name


def test_tensor_parallel_is_refused(tmp_path):
    with pytest.raises(NotImplementedError, match=r"ROADMAP Queue 1 #7"):
        main(["--tokens", str(tmp_path / "none.bin"), "--tensor", "2",
              "--device", "cpu"])
