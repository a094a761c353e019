"""T5 over ``data x tensor`` (``T5(layout=)``, ``seq2seq_forward``,
``generate_seq2seq``, ``train_t5 --tensor``) against the JAX package's
step on a ``MeshConfig(data=2, tensor=2)`` mesh of 4 CPU devices.

- ``tensor_spec`` under ``T5_SPECS`` shards exactly the leaves the
  reference annotates with the ``tensor`` axis; the relative-bias tables
  stay replicated, as the reference leaves them.
- In one gloo world of 4 ranks:
  - at V 67 (the vocabulary's uneven split), t5-small's 6 heads of 85
    (d 512, an inner width of 510) over ``data 2 x tensor 2`` and a tiny
    T5 (d 32, 4 heads) over ``tensor 4``: the sharded model's logits and
    gathered gradients (the relative-bias tables' summed over the tensor
    group) equal the unsharded model's, and ``generate_seq2seq``'s greedy
    tokens are the unsharded model's; at t5-small's heads in float64 the
    loss and gathered gradients are the unsharded model's to float64's
    rounding;
  - at V 64, one SGD step through ``make_train_step`` and
    ``seq2seq_forward`` against the reference's step (loss and parameters
    ``atol=rtol=1e-5``, tests/test_tensor_parallel.py);
  - ``train_t5 --tensor 2 --eval --generate`` against the reference's step
    with the CLI's schedule over the global batch the ranks corrupted
    (recorded in the world): losses within ``rtol 2e-4`` after 3 Adam
    steps (tests/test_parallel_plan.py), the parameters within that bar
    with the floor of tests/test_torch_tp_train.py; both relative-bias
    tables bit-identical on the tensor ranks; ``--eval``'s loss and
    accuracy the unsharded model's over the same batches; the generated
    tokens the one-rank model's on the CLI's final weights, printed once;
  - the CLI's DCP checkpoint holds whole leaves and restores bit for bit;
    a resume at ``--tensor 4`` is refused.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn
from flax.core import meta

from tpudist import mesh as jax_mesh
from tpudist.models.t5 import T5 as JT5
from tpudist.models.t5 import seq2seq_forward as jax_seq2seq_forward
from tpudist.models.t5 import span_corruption_plan
from tpudist.optim import make_optimizer as jax_make_optimizer
from tpudist.optim import run_schedule as jax_run_schedule
from tpudist.train import create_train_state as jax_create_train_state
from tpudist.train import make_train_step as jax_make_train_step
from tpudist.train import state_shardings_of
from tpudist_torch.interop import t5_params_from_flax
from tpudist_torch.parallel import tp
from torch_threads import two_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
S, B, STEPS, LR = 32, 4, 3, 1e-3
TINY = dict(hidden_dim=32, ffn_dim=64, enc_depth=2, dec_depth=2, num_heads=4)
# t5-small's heads: 6 of 85 over d 512, cut to one layer a stack
SMALL_HEADS = dict(hidden_dim=512, ffn_dim=64, enc_depth=1, dec_depth=1,
                   num_heads=6)
_, SPANS, ENC, DEC = span_corruption_plan(S)
# the corpus vocabulary whose model vocabulary (sentinels and EOS above
# it) the tensor axis divides: 61 + 2 + 1 = 64
CORPUS_V = 64 - SPANS - 1
KEYS = ("enc_tokens", "dec_tokens", "targets")


def _unbox(tree):
    return jax.tree_util.tree_map(np.asarray, meta.unbox(tree))


def _jax_model(vocab, geom=TINY):
    return JT5(vocab_size=vocab, **geom, max_decode_len=DEC + 1)


def _boxed(vocab, geom=TINY, seed=1):
    jm = _jax_model(vocab, geom)
    return jax.jit(lambda: jm.init(jax.random.key(seed), (
        jnp.zeros((1, ENC), jnp.int32), jnp.zeros((1, DEC), jnp.int32)),
        train=False)["params"])()


def test_tensor_spec_is_the_references_annotation():
    boxed = _boxed(64)
    specs = nn.get_partition_spec(boxed)
    marks = t5_params_from_flax(jax.tree_util.tree_map(
        lambda p, s: np.full(p.shape, float(jax_mesh.TENSOR_AXIS in tuple(s)),
                             np.float32),
        _unbox(boxed), specs, is_leaf=lambda x: isinstance(x, np.ndarray)))
    sharded = {k for k, m in marks.items() if float(m.max()) == 1.0}
    assert sharded == {k for k in marks
                       if tp.tensor_spec(k, table=tp.T5_SPECS) is not None}
    assert {"wte", "lm_head.weight"} <= sharded
    assert not {"enc_rel_bias", "dec_rel_bias"} & sharded


WORKER = r"""
import contextlib, io, os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
import tpudist_torch.data.lm as LM
import tpudist_torch.models.t5 as MT
import tpudist_torch.train_t5 as TT
from tpudist_torch.checkpoint import Checkpointer
from tpudist_torch.distributed import init_from_env
from tpudist_torch.generate import generate_seq2seq
from tpudist_torch.mesh import MeshConfig, create_layout
from tpudist_torch.optim import SGD, make_optimizer, run_schedule
from tpudist_torch.parallel import tp
from tpudist_torch.train import create_train_state, make_train_step

torch.set_num_threads(1)
src, out = sys.argv[1], sys.argv[2]
ctx = init_from_env("cpu")
data = torch.load(src)
T5 = MT.T5
layouts = {2: create_layout(MeshConfig(data=-1, tensor=2)),
           4: create_layout(MeshConfig(data=-1, tensor=4))}
res = {}


def sharded(sd, lay, **kw):
    model = T5(**kw, device="cpu", layout=lay)
    model.load_state_dict(tp.shard_state_dict(sd, lay, table=tp.T5_SPECS))
    return model


def worst(grads, whole):
    return max(float((grads[k] - p.grad).abs().max()
                     / max(float(p.grad.abs().max()), 1e-30))
               for k, p in whole.named_parameters())


enc, dec, tgt = data["enc"], data["dec"], data["tgt"]
for t, lay in layouts.items():
    geom = data["geoms"][t]
    kw = dict(vocab_size=67, max_decode_len=data["dec_len"] + 1, **geom)
    whole = T5(**kw, device="cpu")
    whole.load_state_dict(data["init67"][t])
    model = sharded(data["init67"][t], lay, **kw)
    want = whole(enc, dec)
    got = model(enc, dec)
    F.cross_entropy(want.reshape(-1, 67), tgt.reshape(-1)).backward()
    local = model(enc, dec, vocab_local=True)
    tp.vocab_parallel_cross_entropy(local.reshape(-1, local.shape[-1]),
                                    tgt.reshape(-1), lay, 67).mean().backward()
    grads = tp.gather_state_dict({k: p.grad for k, p in
                                  model.named_parameters()}, lay, 67,
                                 table=tp.T5_SPECS)
    whole.eval(); model.eval()
    res[("model", t)] = {
        "logits": float((got - want).abs().max()),
        "grads": worst(grads, whole),
        "rel_bias_grads": max(float((grads[k] - getattr(whole, k).grad)
                                    .abs().max()) for k in
                              ("enc_rel_bias", "dec_rel_bias")),
        "generate": np.array_equal(
            generate_seq2seq(model, enc.numpy(), 6, temperature=0.0),
            generate_seq2seq(whole, enc.numpy(), 6, temperature=0.0))}

# t5-small's heads in float64: the loss and gradients to float64's rounding
lay, geom = layouts[2], data["geoms"][2]
kw = dict(vocab_size=67, max_decode_len=data["dec_len"] + 1,
          dtype=torch.float64, **geom)
whole = T5(**kw, device="cpu")
whole.load_state_dict(data["init67"][2])
whole = whole.double().train()
model = sharded(data["init67"][2], lay, **kw).double().train()
want = F.cross_entropy(whole(enc, dec).reshape(-1, 67), tgt.reshape(-1))
want.backward()
local = model(enc, dec, vocab_local=True)
got = tp.vocab_parallel_cross_entropy(local.reshape(-1, local.shape[-1]),
                                      tgt.reshape(-1), lay, 67).mean()
got.backward()
grads = tp.gather_state_dict({k: p.grad for k, p in
                              model.named_parameters()}, lay, 67,
                             table=tp.T5_SPECS)
res["float64"] = {"dtype": str(local.dtype),
                  "loss": float(abs(got - want) / abs(want)),
                  "grads": worst(grads, whole)}

# one SGD step through make_train_step at V 64, this replica's rows
lay = layouts[2]
model = sharded(data["init64"], lay, vocab_size=64, **data["tiny"],
                max_decode_len=data["dec_len"] + 1)
tx = SGD(0.1, momentum=0.0)
state = create_train_state(model, tx)
step = make_train_step(model, tx, input_key="enc_tokens",
                       label_key="targets",
                       forward_loss=MT.seq2seq_forward(model))
state, m = step(state, {k: v.chunk(lay.data)[lay.data_idx]
                        for k, v in data["sgd_batch"].items()})
res["sgd"] = {"losses": [float(m["loss"])], "params": state.params()}


# the CLI, its init the reference's and its batches recorded
def loaded(*args, **kw):
    model = T5(*args, **kw)
    model.load_state_dict(tp.shard_state_dict(data["init64"], kw["layout"],
                                              table=tp.T5_SPECS))
    return model


MT.T5 = loaded
batches, gather = [], LM.TokenWindowLoader._gather_batch


def recording(self, indices, start):
    batch = gather(self, indices, start)
    batches.append({k: torch.from_numpy(np.asarray(v).copy())
                    for k, v in batch.items()})
    return batch


LM.TokenWindowLoader._gather_batch = recording
destroy, dist.destroy_process_group = (dist.destroy_process_group,
                                       lambda *a, **k: None)
printed = io.StringIO()
with contextlib.redirect_stdout(printed):
    state, losses = TT.main(["--device", "cpu", *data["cli"]])
tables = {}
for k in ("enc_rel_bias", "dec_rel_bias"):
    p = getattr(state.model, k).detach()
    peers = [torch.empty_like(p) for _ in range(2)]
    dist.all_gather(peers, p, group=state.model.layout.tensor_group)
    tables[k] = all(torch.equal(q, p) for q in peers)
res[("cli", ctx.rank)] = {
    "losses": losses, "batches": list(batches), "stdout": printed.getvalue(),
    "worlds": (state.model.layout.data, state.model.layout.tensor),
    "tables_equal": tables}
res["cli_params"] = state.params()

ck = Checkpointer(data["ckpt"])
fresh = create_train_state(
    loaded(vocab_size=64, **data["tiny"], max_decode_len=data["dec_len"] + 1,
           device="cpu", layout=state.model.layout),
    make_optimizer(run_schedule(1e-3, total_steps=3, warmup_steps=0)))
ck.restore(fresh)
a, b = state.state_dict(), fresh.state_dict()
local = lambda t: t.to_local() if hasattr(t, "to_local") else t
same = all(torch.equal(local(a["opt"][g][k]), local(b["opt"][g][k]))
           for g in ("mu", "nu") for k in a["opt"][g])
same &= all(torch.equal(p, q) for p, q in zip(
    state.model.parameters(), fresh.model.parameters()))
res["restored"] = same and fresh.step == state.step == 3
res["saved_shapes"] = {k: tuple(v[0]) for k, v in
                       ck.saved_metadata(state.step).items()}
ck.close()
try:
    with contextlib.redirect_stdout(io.StringIO()):
        TT.main(["--device", "cpu", *data["cli"], "--tensor", "4"])
    res["resize"] = "resumed"
except ValueError as e:
    res["resize"] = str(e)
dist.destroy_process_group = destroy

gathered = [None] * dist.get_world_size()
dist.all_gather_object(gathered, res)
if ctx.rank == 0:
    merged = {}
    for r in gathered:
        merged.update(r)
    torch.save(merged, out)
dist.barrier()
sys.stdout.flush()
os._exit(0)
"""


def _launch(tmp, payload):
    from torch_ports import free_port

    torch.save(payload, tmp / "in.pt")
    port = free_port()
    procs = []
    for rank in range(4):
        env = {**os.environ, "PYTHONPATH": str(REPO), "MASTER_ADDR":
               "127.0.0.1", "MASTER_PORT": str(port), "RANK": str(rank),
               "WORLD_SIZE": "4", "LOCAL_RANK": str(rank),
               "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, str(tmp / "in.pt"),
             str(tmp / "out.pt")], env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            assert p.returncode == 0, out.decode()[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return torch.load(tmp / "out.pt", weights_only=False)


def _mesh():
    return jax_mesh.create_mesh(jax_mesh.MeshConfig(data=2, tensor=2),
                                devices=jax.devices()[:4])


def _reference(tx, batches, init):
    """The reference's step on the data x tensor mesh from ``init`` (its
    flax tree): the losses and the final parameters as the port's state
    dict."""
    jm, mesh = _jax_model(64), _mesh()
    state = jax_create_train_state(
        jm, 0, (jnp.zeros((1, ENC), jnp.int32), jnp.zeros((1, DEC),
                                                         jnp.int32)),
        tx, mesh)
    state = state.replace(params=jax.device_put(
        init, state_shardings_of(state).params))
    step = jax_make_train_step(jm, tx, mesh, input_key="enc_tokens",
                               label_key="targets",
                               forward_loss=jax_seq2seq_forward(jm),
                               state_sharding=state_shardings_of(state))
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return losses, t5_params_from_flax(_unbox(state.params))


@pytest.fixture(scope="module")
def t5_world(tmp_path_factory):
    from tpudist_torch.models.t5 import span_corrupt_transform

    tmp = tmp_path_factory.mktemp("tp_t5")
    rng = np.random.Generator(np.random.PCG64(9))
    rng.integers(0, CORPUS_V, STEPS * B * 2 * S).astype(np.uint16).tofile(
        tmp / "tokens.bin")
    rng.integers(0, CORPUS_V, 2 * B * S).astype(np.uint16).tofile(
        tmp / "val.bin")
    init_tree = _unbox(_boxed(64))
    sgd_batch = span_corrupt_transform(64, seed=5)(
        {"tokens": rng.integers(0, CORPUS_V, (2 * B, S)).astype(np.int32)},
        0, 0)
    sgd_losses, sgd_final = _reference(optax.sgd(0.1), [sgd_batch],
                                       init_tree)
    demo = span_corrupt_transform(67, seed=6)(
        {"tokens": rng.integers(0, 61, (2, S)).astype(np.int32)}, 0, 0)
    cli = ["--seq_len", str(S), *(f for k, v in TINY.items()
                                  for f in (f"--{k}", str(v))),
           "--no_profiler", "--tensor", "2", "--vocab_size", str(CORPUS_V),
           "--tokens", str(tmp / "tokens.bin"), "--val_tokens",
           str(tmp / "val.bin"), "--batch_size", str(B), "--lr", str(LR),
           "--eval", "--generate", "--checkpoint_dir", str(tmp / "ck"),
           "--log_dir", str(tmp)]
    got = _launch(tmp, {
        "tiny": TINY, "dec_len": DEC, "geoms": {2: SMALL_HEADS, 4: TINY},
        "init64": t5_params_from_flax(init_tree),
        "init67": {2: t5_params_from_flax(_unbox(_boxed(67, SMALL_HEADS))),
                   4: t5_params_from_flax(_unbox(_boxed(67)))},
        "enc": torch.from_numpy(demo["enc_tokens"]).long(),
        "dec": torch.from_numpy(demo["dec_tokens"]).long(),
        "tgt": torch.from_numpy(demo["targets"]).long(),
        "sgd_batch": {k: torch.from_numpy(np.asarray(v))
                      for k, v in sgd_batch.items()},
        "cli": cli, "ckpt": str(tmp / "ck")})
    return init_tree, (sgd_losses, sgd_final), got, tmp


@pytest.mark.parametrize("t", [2, 4], ids=["6-heads-of-85-T2", "tiny-T4"])
def test_sharded_model_is_the_unsharded_function(t5_world, t):
    _, _, got, _ = t5_world
    r = got[("model", t)]
    assert r["logits"] < 1e-5 and r["grads"] < 1e-5
    assert r["rel_bias_grads"] < 1e-6
    assert r["generate"]


def test_sharded_model_is_the_unsharded_function_in_float64(t5_world):
    """At t5-small's 6 heads of 85 in float64 (attention, norms, logits
    and loss in float64), the sharded loss and gathered gradients are the
    unsharded model's to float64's rounding: the witness that the float32
    gaps of an un-scaled attention stack are rounding, not layout."""
    _, _, got, _ = t5_world
    r = got["float64"]
    assert r["dtype"] == "torch.float64"
    assert r["loss"] < 1e-12 and r["grads"] < 1e-10, r


def test_sgd_step_matches_the_references_data_x_tensor_mesh(t5_world):
    _, (want_losses, want), got, _ = t5_world
    np.testing.assert_allclose(got["sgd"]["losses"], want_losses, rtol=1e-5,
                               atol=1e-5)
    assert got["sgd"]["params"].keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got["sgd"]["params"][k].numpy(),
                                   w.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_cli_matches_the_references_step(t5_world):
    init, _, got, _ = t5_world
    replicas = [got[("cli", r)]["batches"][1:1 + STEPS] for r in (0, 2)]
    batches = [{k: np.concatenate([r[i][k].numpy() for r in replicas])
                for k in KEYS} for i in range(STEPS)]
    tx = jax_make_optimizer(jax_run_schedule(LR, total_steps=STEPS,
                                             warmup_steps=0))
    want_losses, want = _reference(tx, batches, init)
    for rank in range(4):
        r = got[("cli", rank)]
        assert r["worlds"] == (2, 2)
        np.testing.assert_allclose(r["losses"], want_losses, rtol=2e-4)
        assert all(r["tables_equal"].values()), rank
    for a, b in zip(got[("cli", 0)]["batches"], got[("cli", 1)]["batches"],
                    strict=True):
        for k in KEYS:
            assert torch.equal(a[k], b[k])
    params = got["cli_params"]
    assert params.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(params[k].numpy(), w.numpy(), rtol=2e-4,
                                   atol=2e-4 * LR * STEPS, err_msg=k)


def test_cli_eval_and_generate_are_the_unsharded_models(t5_world):
    from tpudist_torch.generate import generate_seq2seq
    from tpudist_torch.models.t5 import T5, span_corrupt_transform

    _, _, got, tmp = t5_world
    model = T5(vocab_size=64, **TINY, max_decode_len=DEC + 1, device="cpu")
    model.load_state_dict(got["cli_params"])
    model.eval()
    sums = np.zeros(3)
    with torch.no_grad():
        for r in (0, 2):
            for batch in got[("cli", r)]["batches"][1 + STEPS:]:
                logits = model(batch["enc_tokens"], batch["dec_tokens"])
                t = batch["targets"].long()
                sums += [float(F.cross_entropy(logits.transpose(1, 2), t,
                                               reduction="sum")),
                         float((logits.argmax(-1) == t).sum()),
                         t.numel()]
    out = got[("cli", 0)]["stdout"]
    loss = float(out.split("span_loss: ")[1].split()[0])
    acc = float(out.split("span_accuracy: ")[1].split()[0])
    np.testing.assert_allclose(loss, sums[0] / sums[2], atol=1e-4)
    np.testing.assert_allclose(acc, sums[1] / sums[2], atol=1e-4)
    # --generate: the CLI's window (the val stream's first), its corruption
    window = np.fromfile(tmp / "val.bin", np.uint16)[:S].astype(np.int32)[None]
    demo = span_corrupt_transform(64, seed=20_000)({"tokens": window})
    want = generate_seq2seq(model, demo["enc_tokens"], DEC, temperature=0.0)
    line = out.split("generated span tokens: ")[1].split("\n")[0]
    assert line == str(want[0].tolist())
    # rank 0 alone prints
    assert all("generated span tokens" not in got[("cli", r)]["stdout"]
               for r in (1, 2, 3))


def test_checkpoint_holds_whole_leaves_restores_and_refuses_a_resize(
        t5_world):
    _, _, got, _ = t5_world
    assert got["restored"]
    shapes = got["saved_shapes"]
    assert shapes["params.wte"] == (64, 32)
    assert shapes["params.lm_head.weight"] == (64, 32)
    assert shapes["opt.mu.enc.0.attn.q.weight"] == (32, 32)
    assert shapes["params.dec.1.cross_attn.out.weight"] == (32, 32)
    assert shapes["params.enc.0.mlp.wo.weight"] == (32, 64)
    assert shapes["params.enc_rel_bias"] == (32, 4)
    assert "tensor_world 2 -> 4" in got["resize"]
    assert "only the data axis is elastic" in got["resize"]
