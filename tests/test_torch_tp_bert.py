"""BERT over ``data x tensor`` (``Bert(layout=)``, ``mlm_forward``,
``train_bert --tensor``) against the JAX package's step on a
``MeshConfig(data=2, tensor=2)`` mesh of 4 CPU devices, at a tiny size
(2 layers, hidden 32, 4 heads, S 32).

- ``tensor_spec`` under ``BERT_SPECS`` shards exactly the leaves the
  reference annotates with the ``tensor`` axis; the MLM bias stays
  replicated, as the reference leaves it.
- In one gloo world of 4 ranks:
  - at V 67 (the vocabulary's uneven split; the reference's
    ``NamedSharding`` refuses it over 2) over ``data 2 x tensor 2`` and
    ``tensor 4``: the sharded model's logits and gathered gradients equal
    the unsharded model's from the same JAX init, with the vocabulary-
    parallel CE full and chunked, and the classifier's logits;
  - at V 64, one SGD step through ``make_train_step`` and ``mlm_forward``
    against the reference's step (loss and parameters ``atol=rtol=1e-5``,
    tests/test_tensor_parallel.py);
  - ``train_bert --tensor 2 --chunked_ce 5 --eval`` against the
    reference's step with the CLI's schedule over the global batch the
    ranks corrupted (recorded in the world): losses within ``rtol 2e-4``
    after 3 Adam steps (tests/test_parallel_plan.py), the parameters
    within that bar with the floor of tests/test_torch_tp_train.py; the
    MLM bias bit-identical on both tensor ranks; ``--eval``'s loss and
    top-1 equal the unsharded model's over the same batches;
  - the CLI's DCP checkpoint holds whole leaves and restores bit for bit;
    a resume at ``--tensor 4`` is refused.
- ``--tensor 2 --cp 2`` passes the reference's refusals (it runs in
  tests/test_torch_tp_cp.py); a non-CP attention under ``--cp`` is still
  refused.
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
from tpudist.models import bert as J
from tpudist.optim import make_optimizer as jax_make_optimizer
from tpudist.optim import run_schedule as jax_run_schedule
from tpudist.train import create_train_state as jax_create_train_state
from tpudist.train import make_train_step as jax_make_train_step
from tpudist.train import state_shardings_of
from tpudist_torch.interop import bert_params_from_flax
from tpudist_torch.parallel import tp
from torch_threads import two_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
S, B, STEPS, LR = 32, 4, 3, 1e-3
GEOM = dict(max_seq_len=S, hidden_dim=32, depth=2, num_heads=4)
KEYS = ("tokens", "targets", "mlm_mask")


def _unbox(tree):
    return jax.tree_util.tree_map(np.asarray, meta.unbox(tree))


def _init(vocab, seed=1):
    boxed = J.Bert(vocab_size=vocab, **GEOM).init(
        jax.random.key(seed), jnp.zeros((1, 8), jnp.int32),
        train=False)["params"]
    return boxed


def test_tensor_spec_is_the_references_annotation():
    boxed = _init(64)
    specs = nn.get_partition_spec(boxed)
    marks = bert_params_from_flax(jax.tree_util.tree_map(
        lambda p, s: np.full(p.shape, float(jax_mesh.TENSOR_AXIS in tuple(s)),
                             np.float32),
        _unbox(boxed), specs, is_leaf=lambda x: isinstance(x, np.ndarray)))
    sharded = {k for k, m in marks.items() if float(m.max()) == 1.0}
    assert sharded == {k for k in marks
                       if tp.tensor_spec(k, table=tp.BERT_SPECS) is not None}
    assert "wte" in sharded and "mlm_head.bias" not in sharded


def test_tensor_with_cp_is_refused_first(tmp_path):
    """``--tensor 2 --cp 2`` composes now (tests/test_torch_tp_cp.py runs
    it): the reference's refusals pass it, and what stays refused is
    what the reference refuses, a non-CP attention under --cp."""
    from tpudist_torch.train_bert import check_args, parse_args

    argv = ["--device", "cpu", "--tokens", str(tmp_path / "none.bin"),
            "--tensor", "2", "--cp", "2"]
    assert check_args(parse_args([*argv, "--attn", "ring"])) == (30522,
                                                                 30523)
    with pytest.raises(SystemExit, match="--cp needs a sequence-parallel"):
        check_args(parse_args(argv))


WORKER = r"""
import contextlib, io, os, sys
import torch
import torch.distributed as dist
import torch.nn.functional as F
import tpudist_torch.data.lm as LM
import tpudist_torch.models.bert as MB
import tpudist_torch.train_bert as TB
from tpudist_torch.checkpoint import Checkpointer
from tpudist_torch.distributed import init_from_env
from tpudist_torch.mesh import MeshConfig, create_layout
from tpudist_torch.models.lm_utils import chunked_head_reduce
from tpudist_torch.optim import SGD, make_optimizer, run_schedule
from tpudist_torch.parallel import tp
from tpudist_torch.train import create_train_state, make_train_step

torch.set_num_threads(1)
src, out = sys.argv[1], sys.argv[2]
ctx = init_from_env("cpu")
data = torch.load(src)
geom, Bert = data["geom"], MB.Bert
layouts = {2: create_layout(MeshConfig(data=-1, tensor=2)),
           4: create_layout(MeshConfig(data=-1, tensor=4))}
res = {}


def sharded(cls, sd, lay, **kw):
    model = cls(**kw, device="cpu", layout=lay)
    model.load_state_dict(tp.shard_state_dict(sd, lay,
                                              table=cls.tensor_specs))
    return model


def gathered_grads(model, lay, vocab):
    return tp.gather_state_dict({k: p.grad for k, p in
                                 model.named_parameters()}, lay, vocab,
                                table=model.tensor_specs)


def worst(grads, whole):
    return max(float((grads[k] - p.grad).abs().max()
                     / max(float(p.grad.abs().max()), 1e-30))
               for k, p in whole.named_parameters())


# the sharded model against the unsharded one at the uneven vocabulary
sd, V = data["init67"], 67
tokens, targets = data["tokens"], data["targets"]
mask = data["mask"]
for t, lay in layouts.items():
    whole = Bert(vocab_size=V, **geom, device="cpu")
    whole.load_state_dict(sd)
    model = sharded(Bert, sd, lay, vocab_size=V, **geom)
    want = whole(tokens)
    got = model(tokens)
    ce = F.cross_entropy(want.reshape(-1, V), targets.reshape(-1),
                         reduction="none")
    (ce * mask.reshape(-1)).sum().backward()
    local = model(tokens, vocab_local=True)
    ces = tp.vocab_parallel_cross_entropy(local.reshape(-1, local.shape[-1]),
                                          targets.reshape(-1), lay, V)
    (ces * mask.reshape(-1)).sum().backward()
    r = {"logits": float((got - want).abs().max()),
         "grads": worst(gathered_grads(model, lay, V), whole)}
    whole.zero_grad(); model.zero_grad()
    a = chunked_head_reduce(MB.mlm_head_logits_fn(whole),
                            whole(tokens, return_hidden=True), targets, mask, 5)
    b = chunked_head_reduce(MB.mlm_head_logits_fn(model),
                            model(tokens, return_hidden=True), targets, mask,
                            5, model=model)
    a.backward(); b.backward()
    r["chunked_loss"] = (float(b), float(a))
    r["chunked_grads"] = worst(gathered_grads(model, lay, V), whole)
    # the classifier: the encoder laid out, the pooled head replicated
    cw = MB.BertClassifier(3, vocab_size=V, **geom, device="cpu", seed=2)
    cs = sharded(MB.BertClassifier, cw.state_dict(), lay, num_labels=3,
                 vocab_size=V, **geom)
    r["classifier"] = float((cs(tokens) - cw(tokens)).abs().max())
    res[("model", t)] = r

# one SGD step through make_train_step at V 64, this replica's rows
lay = layouts[2]
model = sharded(Bert, data["init64"], lay, vocab_size=64, **geom)
tx = SGD(0.1, momentum=0.0)
state = create_train_state(model, tx)
step = make_train_step(model, tx, input_key="tokens", label_key="targets",
                       forward_loss=MB.mlm_forward(model))
state, m = step(state, {k: v.chunk(lay.data)[lay.data_idx]
                        for k, v in data["sgd_batch"].items()})
res["sgd"] = {"losses": [float(m["loss"])], "params": state.params()}


# the CLI, its init the reference's and its batches recorded
def loaded(*args, **kw):
    model = Bert(*args, **kw)
    model.load_state_dict(tp.shard_state_dict(data["init64"], kw["layout"],
                                              table=tp.BERT_SPECS))
    return model


MB.Bert = loaded
batches, gather = [], LM.TokenWindowLoader._gather_batch


def recording(self, indices, start):
    batch = gather(self, indices, start)
    batches.append({k: torch.from_numpy(v.copy()) for k, v in batch.items()})
    return batch


LM.TokenWindowLoader._gather_batch = recording
destroy, dist.destroy_process_group = (dist.destroy_process_group,
                                       lambda *a, **k: None)
printed = io.StringIO()
with contextlib.redirect_stdout(printed):
    state, losses = TB.main(["--device", "cpu", *data["cli"]])
bias = state.model.mlm_head.bias.detach()
peers = [torch.empty_like(bias) for _ in range(2)]
dist.all_gather(peers, bias, group=state.model.layout.tensor_group)
res[("cli", ctx.rank)] = {
    "losses": losses, "batches": list(batches), "stdout": printed.getvalue(),
    "worlds": (state.model.layout.data, state.model.layout.tensor),
    "bias_equal": all(torch.equal(p, bias) for p in peers)}
res["cli_params"] = state.params()

# the checkpoint it wrote, restored into a fresh state
ck = Checkpointer(data["ckpt"])
fresh = create_train_state(
    loaded(vocab_size=64, **geom, device="cpu",
           layout=state.model.layout),
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
        TB.main(["--device", "cpu", *data["cli"], "--tensor", "4"])
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


def _sgd_reference(batch):
    jm, mesh = J.Bert(vocab_size=64, **GEOM), _mesh()
    tx = optax.sgd(0.1)
    state = jax_create_train_state(jm, 1, jnp.zeros((1, S), jnp.int32), tx,
                                   mesh)
    step = jax_make_train_step(jm, tx, mesh, input_key="tokens",
                               label_key="targets",
                               forward_loss=J.mlm_forward(jm),
                               state_sharding=state_shardings_of(state))
    init = bert_params_from_flax(_unbox(state.params))
    state, m = step(state, batch)
    return init, [float(m["loss"])], bert_params_from_flax(
        _unbox(state.params))


@pytest.fixture(scope="module")
def bert_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_bert")
    rng = np.random.Generator(np.random.PCG64(7))
    # the CLI's corpus: 64 corpus ids, the [MASK] id 63 inside them, so the
    # model vocabulary is 64 (the reference's tensor axis divides it)
    rng.integers(0, 64, STEPS * B * 2 * S).astype(np.uint16).tofile(
        tmp / "tokens.bin")
    rng.integers(0, 64, 2 * B * S).astype(np.uint16).tofile(tmp / "val.bin")
    sgd_batch = J.mlm_transform(64, 63, seed=3)(
        {"tokens": rng.integers(0, 64, (2 * B, S)).astype(np.int32)})
    init64, sgd_losses, sgd_final = _sgd_reference(sgd_batch)
    tokens = rng.integers(0, 67, (2, 16))
    mask = rng.random((2, 16)) < 0.3
    cli = ["--seq_len", str(S), "--hidden_dim", "32", "--depth", "2",
           "--num_heads", "4", "--no_profiler", "--tensor", "2",
           "--vocab_size", "64", "--mask_id", "63", "--tokens",
           str(tmp / "tokens.bin"), "--val_tokens", str(tmp / "val.bin"),
           "--batch_size", str(B), "--lr", str(LR), "--chunked_ce", "5",
           "--eval", "--checkpoint_dir", str(tmp / "ck"), "--log_dir",
           str(tmp)]
    got = _launch(tmp, {
        "geom": GEOM, "init64": init64,
        "init67": bert_params_from_flax(_unbox(_init(67))),
        "tokens": torch.from_numpy(tokens),
        "targets": torch.from_numpy(rng.integers(0, 67, (2, 16))),
        "mask": torch.from_numpy(mask.astype(np.float32)),
        "sgd_batch": {k: torch.from_numpy(np.asarray(v))
                      for k, v in sgd_batch.items()},
        "cli": cli, "ckpt": str(tmp / "ck")})
    return (init64, sgd_losses, sgd_final), got


@pytest.mark.parametrize("t", [2, 4], ids=["data2-tensor2", "tensor4"])
def test_sharded_model_is_the_unsharded_function(bert_world, t):
    _, got = bert_world
    r = got[("model", t)]
    assert r["logits"] < 1e-5 and r["grads"] < 1e-5
    np.testing.assert_allclose(*r["chunked_loss"], rtol=1e-5)
    assert r["chunked_grads"] < 1e-5
    assert r["classifier"] < 1e-5


def test_sgd_step_matches_the_references_data_x_tensor_mesh(bert_world):
    (init, want_losses, want), got = bert_world
    np.testing.assert_allclose(got["sgd"]["losses"], want_losses, rtol=1e-5,
                               atol=1e-5)
    assert got["sgd"]["params"].keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got["sgd"]["params"][k].numpy(),
                                   w.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def _cli_reference(got):
    """The reference's step with the CLI's schedule on the data x tensor
    mesh over the global batches the port's replicas corrupted (each
    rank's first gather is fit's one-row probe; then 3 steps)."""
    jm, mesh = J.Bert(vocab_size=64, **GEOM), _mesh()
    tx = jax_make_optimizer(jax_run_schedule(LR, total_steps=STEPS,
                                             warmup_steps=0))
    state = jax_create_train_state(jm, 1, jnp.zeros((1, S), jnp.int32), tx,
                                   mesh)
    step = jax_make_train_step(jm, tx, mesh, input_key="tokens",
                               label_key="targets",
                               forward_loss=J.mlm_forward(jm, chunk=5),
                               state_sharding=state_shardings_of(state))
    replicas = [got[("cli", r)]["batches"][1:1 + STEPS] for r in (0, 2)]
    losses = []
    for i in range(STEPS):
        batch = {k: np.concatenate([r[i][k].numpy() for r in replicas])
                 for k in KEYS}
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses, bert_params_from_flax(_unbox(state.params))


def test_cli_matches_the_references_step(bert_world):
    (init, _, _), got = bert_world
    want_losses, want = _cli_reference(got)
    for rank in range(4):
        r = got[("cli", rank)]
        assert r["worlds"] == (2, 2)
        np.testing.assert_allclose(r["losses"], want_losses, rtol=2e-4)
        assert r["bias_equal"], rank
    # the tensor peers corrupt their replica's rows alike
    for a, b in zip(got[("cli", 0)]["batches"], got[("cli", 1)]["batches"],
                    strict=True):
        for k in KEYS:
            assert torch.equal(a[k], b[k])
    params = got["cli_params"]
    assert params.keys() == want.keys()
    for k, w in want.items():
        g, w = params[k].numpy(), w.numpy()
        if k.endswith("qkv.bias"):
            moved = np.abs(g[1] - init[k].numpy()[1])
            assert moved.max() <= 1.5 * STEPS * LR, k
            g, w = g[[0, 2]], w[[0, 2]]
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-4 * LR * STEPS,
                                   err_msg=k)


def test_cli_eval_is_the_unsharded_models(bert_world):
    """``--eval`` (the vocabulary-parallel CE and argmax over the chunked
    head) against the unsharded model on the CLI's final parameters, over
    the eval batches both replicas corrupted."""
    from tpudist_torch.models.bert import Bert

    _, got = bert_world
    model = Bert(vocab_size=64, **GEOM, device="cpu")
    model.load_state_dict(got["cli_params"])
    sums = np.zeros(3)
    with torch.no_grad():
        for r in (0, 2):
            for batch in got[("cli", r)]["batches"][1 + STEPS:]:
                logits = model(batch["tokens"].long())
                t, m = batch["targets"].long(), batch["mlm_mask"]
                ce = F.cross_entropy(logits.transpose(1, 2), t,
                                     reduction="none")
                sums += [float((ce * m).sum()),
                         float(((logits.argmax(-1) == t) & m).sum()),
                         float(m.sum())]
    out = got[("cli", 0)]["stdout"]
    loss = float(out.split("mlm_loss: ")[1].split()[0])
    acc = float(out.split("masked_accuracy: ")[1].split()[0])
    assert sums[2] > 0
    np.testing.assert_allclose(loss, sums[0] / sums[2], atol=1e-4)
    np.testing.assert_allclose(acc, sums[1] / sums[2], atol=1e-4)


def test_checkpoint_holds_whole_leaves_restores_and_refuses_a_resize(
        bert_world):
    _, got = bert_world
    assert got["restored"]
    shapes = got["saved_shapes"]
    assert shapes["params.wte"] == (64, 32)
    assert shapes["opt.mu.wte"] == (64, 32)
    assert shapes["params.h.0.qkv.weight"] == (96, 32)
    assert shapes["params.h.0.qkv.bias"] == (3, 4, 8)
    assert shapes["params.h.0.mlp_proj.weight"] == (32, 128)
    assert shapes["params.mlm_head.bias"] == (64,)
    assert "tensor_world 2 -> 4" in got["resize"]
    assert "only the data axis is elastic" in got["resize"]
