"""ViT over ``data x tensor`` (``ViT(layout=)`` / ``ViT(mesh=)`` through
``make_train_step`` and ``fit``) against the JAX package's step on a
``MeshConfig(data=2, tensor=2)`` mesh of 4 CPU devices, at
tests/test_vit.py's tiny size (patch 8 on 32x32, width 32, depth 2, 4
heads, MLP 64, 10 classes).

- ``tensor_spec`` under ``VIT_SPECS`` shards exactly the leaves the
  reference annotates with the ``tensor`` axis; so do GPT-2's and
  Llama's tables (``GPT2_SPECS``, ``LLAMA_SPECS``, and ``LM_SPECS`` for
  a call that names none).
- In one gloo world of 4 ranks (``data 2 x tensor 2``): one SGD step
  through ``make_train_step`` (the loss within the reference's ViT bar,
  ``rtol 2e-5``, tests/test_tensor_parallel.py; the parameters ``atol=rtol=
  1e-5``) and three fused-AdamW steps through ``fit(fused="all")`` on a
  model built with the reference's keyword ``mesh=`` (``rtol 2e-4``,
  tests/test_parallel_plan.py, with an absolute floor of that bar times
  the steps' scale for elements Adam moves from zero); each rank's
  ``qkv.weight`` is its shard, the replicated head bit-identical on both
  tensor ranks; ``shard_model`` of the whole model computes its function.
- ``main --tensor 2`` without ``--serve`` trains exactly as ``--tensor 1``
  (the reference reads the flag under ``--serve`` only).
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
from flax import linen as nn
from flax.core import meta

from tpudist import mesh as jax_mesh
from tpudist.data.cifar import synthetic_cifar as jax_synthetic_cifar
from tpudist.data.cifar import to_tensor as jax_to_tensor
from tpudist.models import vit_b16 as jax_vit_b16
from tpudist.optim import make_optimizer as jax_make_optimizer
from tpudist.train import create_train_state as jax_create_train_state
from tpudist.train import make_train_step as jax_make_train_step
from tpudist.train import state_shardings_of
from tpudist_torch.interop import vit_params_from_flax
from tpudist_torch.parallel import tp
from torch_threads import two_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
TINY = dict(num_classes=10, patch_size=8, hidden_dim=32, depth=2,
            num_heads=4, mlp_dim=64)
ROWS, STEPS, LR = 8, 3, 1e-3


def _unbox(tree):
    return jax.tree_util.tree_map(np.asarray, meta.unbox(tree))


def test_tensor_spec_is_the_references_annotation():
    boxed = jax_vit_b16(**TINY).init(jax.random.key(0),
                                     jnp.zeros((1, 32, 32, 3)),
                                     train=False)["params"]
    specs = nn.get_partition_spec(boxed)
    params = _unbox(boxed)
    marks = vit_params_from_flax(jax.tree_util.tree_map(
        lambda p, s: np.full(p.shape, float(jax_mesh.TENSOR_AXIS in tuple(s)),
                             np.float32),
        params, specs, is_leaf=lambda x: isinstance(x, np.ndarray)))
    sharded = {k for k, m in marks.items() if float(m.max()) == 1.0}
    assert sharded == {k for k in marks
                       if tp.tensor_spec(k, table=tp.VIT_SPECS) is not None}
    assert sharded  # qkv, out and the MLP of every block


@pytest.mark.parametrize("arch", ["gpt2", "llama"])
def test_lm_placements_are_unchanged(arch):
    """The LMs' own tables place their leaves as the reference annotates
    them (tests/test_torch_tp.py), with or without the table named."""
    from test_torch_tp import GPT2_GEOM, LLAMA_GEOM, _flax
    from tpudist_torch.models.gpt2 import GPT2
    from tpudist_torch.models.llama import Llama

    model = (GPT2(vocab_size=64, **GPT2_GEOM, device="cpu") if arch == "gpt2"
             else Llama(vocab_size=64, **LLAMA_GEOM, device="cpu"))
    assert model.tensor_specs is (tp.GPT2_SPECS if arch == "gpt2"
                                  else tp.LLAMA_SPECS)
    sd, marks = _flax(arch, 64)
    sharded = {k for k, m in marks.items() if float(m.max()) == 1.0}
    for table in (model.tensor_specs, None):
        assert sharded == {k for k in sd if tp.tensor_spec(
            k, table=table) is not None}


def _batches():
    data = jax_to_tensor(jax_synthetic_cifar(STEPS * ROWS, num_classes=10,
                                             seed=3))
    return [{k: v[i * ROWS:(i + 1) * ROWS] for k, v in data.items()}
            for i in range(STEPS)]


def _reference(tx, batches):
    """The reference's step on the data x tensor mesh (the qkv kernel
    tensor-sharded, as its own test asserts): the initial parameters as
    the port's state dict, the losses, the final ones."""
    mesh = jax_mesh.create_mesh(jax_mesh.MeshConfig(data=2, tensor=2),
                                devices=jax.devices()[:4])
    model = jax_vit_b16(**TINY)
    state = jax_create_train_state(model, 0, jnp.zeros((1, 32, 32, 3)), tx,
                                   mesh)
    spec = state.params["block_0"]["qkv"]["kernel"].sharding.spec
    assert jax_mesh.TENSOR_AXIS in spec, spec
    step = jax_make_train_step(model, tx, mesh,
                               state_sharding=state_shardings_of(state))
    init, losses = vit_params_from_flax(_unbox(state.params)), []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return init, losses, vit_params_from_flax(_unbox(state.params))


WORKER = r"""
import os
import sys
import numpy as np
import torch
import torch.distributed as dist
from tpudist_torch.data.cifar import synthetic_cifar, to_tensor
from tpudist_torch.data.loader import DataLoader
from tpudist_torch.data.sampler import DistributedSampler
from tpudist_torch.distributed import init_from_env
from tpudist_torch.mesh import MeshConfig, create_layout
from tpudist_torch.models.vit import ViT
from tpudist_torch.optim import SGD, make_optimizer
from tpudist_torch.parallel import tp
from tpudist_torch.train import create_train_state, fit, make_train_step

torch.set_num_threads(1)
src, out = sys.argv[1], sys.argv[2]
ctx = init_from_env("cpu")
data = torch.load(src)
geom = dict(data["geom"], image_size=32, device="cpu")
lay = create_layout(MeshConfig(data=-1, tensor=2))
res = {"worlds": (lay.data, lay.tensor)}


def load(model, sd):
    model.load_state_dict(tp.shard_state_dict(sd, model.layout,
                                              table=tp.VIT_SPECS))
    return model


def tensor_peers(t):
    parts = [torch.empty_like(t) for _ in range(lay.tensor)]
    dist.all_gather(parts, t.detach().contiguous(), group=lay.tensor_group)
    return parts


# one SGD step through make_train_step, this replica's rows of the batch
model = load(ViT(**geom, layout=lay), data["init"]["sgd"])
tx = SGD(0.1, momentum=0.0)
state = create_train_state(model, tx)
step = make_train_step(model, tx)
losses = []
for b in data["batches"]["sgd"]:
    mine = {k: v.chunk(lay.data)[lay.data_idx] for k, v in b.items()}
    state, m = step(state, mine)
    losses.append(float(m["loss"]))
res["sgd"] = {"losses": losses, "params": state.params(),
              "ddp": type(state.module).__name__}

# three fused-AdamW steps through fit, on the reference's keyword mesh=
model = load(ViT(**geom, mesh=MeshConfig(data=-1, tensor=2)),
             data["init"]["adam"])
res["qkv_shape"] = tuple(model.blocks[0].qkv.weight.shape)
res["qkv_bias_shape"] = tuple(model.blocks[0].qkv.bias.shape)
images = {k: v.numpy() for k, v in data["images"].items()}
loader = DataLoader(images, data["rows"] // 2, transform=to_tensor,
                    native=False, sampler=DistributedSampler(
                        len(images["label"]), num_replicas=2,
                        rank=model.layout.data_idx, shuffle=False))
state, losses = fit(model, make_optimizer(1e-3, fused=True), loader,
                    epochs=1, fused="all", profile=False, log_dir=data["log"])
res["adam"] = {"losses": losses, "params": state.params()}
res["head_equal"] = all(
    all(torch.equal(p, q) for q in tensor_peers(p))
    for p in (model.head.weight, model.head.bias, model.norm.scale,
              model.cls, model.pos_embedding))

# shard_model of the whole model: its function, gradients gathered
whole = ViT(**geom)
whole.load_state_dict(data["init"]["sgd"])
sharded = tp.shard_model(whole, lay)
x = torch.from_numpy(np.asarray(data["batches"]["sgd"][0]["image"]))
want, got = whole(x), sharded(x)
want.square().sum().backward()
got.square().sum().backward()
grads = tp.gather_state_dict({k: p.grad for k, p in sharded.named_parameters()},
                             lay, None, table=tp.VIT_SPECS)
res["shard_model"] = {
    "logits": float((got - want).abs().max()),
    # relative to each leaf's largest gradient
    "grads": max(float((grads[k] - p.grad).abs().max() / p.grad.abs().max())
                 for k, p in whole.named_parameters()),
    "sharded": sorted(tp.sharded_names(sharded))}

if ctx.rank == 0:
    torch.save(res, out)
# every rank here past the last collective: leave without the interpreter's
# teardown of the gloo threads
dist.barrier()
sys.stdout.flush()
os._exit(0)
"""


@pytest.fixture(scope="module")
def vit_world(tmp_path_factory):
    from torch_ports import free_port
    from tpudist_torch.data.cifar import synthetic_cifar

    tmp = tmp_path_factory.mktemp("tp_vit")
    batches = _batches()
    refs = {"sgd": _reference(optax.sgd(0.1), batches[:1]),
            "adam": _reference(jax_make_optimizer(LR), batches)}
    torch.save({
        "geom": TINY, "rows": ROWS, "log": str(tmp),
        "init": {k: v[0] for k, v in refs.items()},
        "batches": {"sgd": [{k: torch.from_numpy(np.asarray(v))
                             for k, v in batches[0].items()}]},
        "images": {k: torch.from_numpy(v) for k, v in synthetic_cifar(
            STEPS * ROWS, num_classes=10, seed=3).items()},
    }, tmp / "in.pt")
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
            out, _ = p.communicate(timeout=240)
            assert p.returncode == 0, out.decode()[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return refs, torch.load(tmp / "out.pt", weights_only=False)


def _close(got, want_losses, want, init, *, sgd):
    if sgd:  # the reference's ViT loss bar, its SGD parameter bar
        np.testing.assert_allclose(got["losses"], want_losses, rtol=2e-5)
    else:
        np.testing.assert_allclose(got["losses"], want_losses, rtol=2e-4)
    assert got["params"].keys() == want.keys()
    for k, w in want.items():
        g, w = got["params"][k].numpy(), np.asarray(w)
        if not sgd and k.endswith("qkv.bias"):
            # the key bias's gradient is zero in exact arithmetic: Adam
            # turns rounding noise into a step of either sign, held to the
            # step bound (tests/test_torch_gpt2_train.py's rule)
            moved = np.abs(g[1] - init[k].numpy()[1])
            assert moved.max() <= 1.5 * STEPS * LR, k
            g, w = g[[0, 2]], w[[0, 2]]
        atol = 1e-5 if sgd else 2e-4 * LR * STEPS
        np.testing.assert_allclose(g, w, rtol=1e-5 if sgd else 2e-4,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_step_matches_the_references_data_x_tensor_mesh(vit_world, opt):
    refs, got = vit_world
    assert got["worlds"] == (2, 2)
    init, want_losses, want = refs[opt]
    _close(got[opt], want_losses, want, init, sgd=opt == "sgd")
    if opt == "sgd":  # DDP over the data group
        assert got["sgd"]["ddp"] == "DistributedDataParallel"


def test_each_rank_holds_its_heads_and_the_replicated_leaves_agree(vit_world):
    _, got = vit_world
    # qkv's out features (3, H, dh): two of the four heads of each of
    # q, k and v; its bias [3, H / T, dh]
    assert got["qkv_shape"] == (48, 32)
    assert got["qkv_bias_shape"] == (3, 2, 8)
    assert got["head_equal"]


def test_shard_model_is_the_unsharded_function(vit_world):
    _, got = vit_world
    r = got["shard_model"]
    assert r["logits"] < 1e-5 and r["grads"] < 1e-5
    assert r["sharded"] == sorted(
        f"blocks.{i}.{leaf}" for i in range(2) for leaf in (
            "qkv.weight", "qkv.bias", "out.weight", "mlp.fc.weight",
            "mlp.fc.bias", "mlp.proj.weight"))


def test_main_tensor_without_serve_trains_as_tensor_1(tmp_path):
    """The reference's ``--tensor`` is "with --serve": without it the
    training job reads nothing of it, so ``--tensor 2`` writes the TSV
    losses of ``--tensor 1`` (it was refused before)."""
    from tpudist_torch.main import main

    def losses(tensor):
        job = f"T{tensor}"
        main(["--device", "cpu", "--model", "resnet18", "--dataset",
              "synthetic", "--batch_size", "2", "--epochs", "1",
              "--synthetic_size", "12", "--no_profiler", "--tensor",
              str(tensor), "--JobID", job, "--log_dir", str(tmp_path)])
        rows = (tmp_path / f"{job}_2_0.log").read_text().splitlines()
        return [r.split("\t")[3] for r in rows[1:-1]]

    want = losses(1)
    assert want and losses(2) == want
