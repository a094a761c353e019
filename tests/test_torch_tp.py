"""The tensor axis and the Megatron layers (``tpudist_torch.mesh``,
``tpudist_torch.parallel.tp``, the models' tensor layout) against the JAX
package.

- ``tensor_spec`` shards exactly the leaves the reference annotates with
  the ``tensor`` axis (GPT-2 and Llama, through ``*_params_from_flax``),
  and the rank coordinates are the reference's device order.
- In one gloo world of 4 ranks (``tensor 4`` and ``data 2 x tensor 2``):
  ``gather_state_dict(shard_state_dict(x)) == x`` bit for bit for the
  grouped ``qkv`` split and the uneven vocabulary (V 67 at T 2 and T 4);
  the sharded models' logits and gathered gradients equal the unsharded
  model's, whose weights are the JAX init's (1e-5); the vocabulary-
  parallel CE, full and chunked, equals the plain loss and its gradient.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax.core import meta

from tpudist import mesh as jax_mesh
from tpudist.models.gpt2 import GPT2 as JGPT2
from tpudist.models.llama import Llama as JLlama
from tpudist_torch import mesh as mesh_lib
from tpudist_torch.interop import gpt2_params_from_flax, llama_params_from_flax
from tpudist_torch.parallel import tp
from torch_threads import two_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
GPT2_GEOM = dict(max_seq_len=32, hidden_dim=32, depth=2, num_heads=4)
LLAMA_GEOM = dict(max_seq_len=32, hidden_dim=32, depth=2, num_heads=4,
                  num_kv_heads=2, ffn_dim=64)


def _flax(arch, vocab, seed=0):
    """The JAX init as the port's state dict, and the flax tree's
    partition specs converted the same way (1 where the reference names
    the tensor axis)."""
    if arch == "gpt2":
        jm, convert = JGPT2(vocab_size=vocab, **GPT2_GEOM), gpt2_params_from_flax
    else:
        jm, convert = JLlama(vocab_size=vocab, **LLAMA_GEOM), llama_params_from_flax
    boxed = jm.init(jax.random.key(seed), np.zeros((1, 8), np.int32),
                    train=False)["params"]
    specs = nn.get_partition_spec(boxed)
    params = jax.tree_util.tree_map(np.asarray, meta.unbox(boxed))
    marks = jax.tree_util.tree_map(
        lambda p, s: np.full(p.shape, float(mesh_lib.TENSOR_AXIS in tuple(s)),
                             np.float32),
        params, specs, is_leaf=lambda x: isinstance(x, np.ndarray))
    return convert(params), convert(marks)


@pytest.mark.parametrize("arch", ["gpt2", "llama"])
def test_tensor_spec_is_the_references_annotation(arch):
    sd, marks = _flax(arch, 64)
    sharded = {k for k, m in marks.items() if float(m.max()) == 1.0}
    assert sharded == {k for k in sd if tp.tensor_spec(k) is not None}
    for k, m in marks.items():
        assert float(m.min()) == float(m.max()), k


def test_rank_coordinates_are_the_references_device_order():
    """``data x tensor`` over 8 ranks: rank r sits where the reference's
    mesh puts device r (tensor innermost)."""
    mesh = jax_mesh.create_mesh(jax_mesh.MeshConfig(data=4, tensor=2),
                                devices=jax.devices()[:8])
    ids = np.vectorize(lambda d: d.id)(np.asarray(mesh.devices))
    grid = ids.reshape(4, 2)
    for rank in range(8):
        lay = mesh_lib.RankLayout(rank, 4, 1, tensor=2)
        assert grid[lay.data_idx, lay.tensor_idx] == rank
        assert lay.replica == lay.data_idx
    assert mesh_lib.MeshConfig(data=-1, tensor=4).axis_sizes(8) == {
        "data": 2, "fsdp": 1, "pipe": 1, "expert": 1, "seq": 1, "tensor": 4}
    # tensor composed with fsdp or seq: the four-axis formulas at 8 ranks
    for other in ("fsdp", "seq"):
        cfg = {"data": 2, other: 2, "tensor": 2}
        mesh = jax_mesh.create_mesh(jax_mesh.MeshConfig(**cfg),
                                    devices=jax.devices()[:8])
        ids = np.vectorize(lambda d: d.id)(np.asarray(mesh.devices))
        grid = ids.reshape(2, 2, 2)
        assert mesh_lib.MeshConfig(data=-1, **{other: 2},
                                   tensor=2).axis_sizes(8) == {
            "data": 2, "fsdp": 1, "pipe": 1, "expert": 1, "seq": 1,
            "tensor": 2, other: 2}
        for rank in range(8):
            lay = mesh_lib.RankLayout(rank, 2, cfg.get("seq", 1), tensor=2,
                                      fsdp=cfg.get("fsdp", 1))
            mid = lay.fsdp_idx if other == "fsdp" else lay.seq_idx
            assert grid[lay.data_idx, mid, lay.tensor_idx] == rank
            # the batch rides data x fsdp: the tensor and seq ranks of a
            # replica share it
            assert lay.replica == (lay.data_idx * 2 + lay.fsdp_idx
                                   if other == "fsdp" else lay.data_idx)
    with pytest.raises(ValueError, match="fsdp does not compose with seq"):
        mesh_lib.MeshConfig(fsdp=2, seq=2, tensor=2)


@pytest.mark.parametrize("vocab,t", [(64, 2), (67, 2), (67, 4), (50257, 4),
                                     (128256, 4)])
def test_vocab_split_is_torch_chunk(vocab, t):
    """``ceil(V/T)`` rows a rank, the last shorter: what ``torch.chunk``
    and a ``DTensor``'s ``Shard(0)`` give."""
    rows = torch.arange(vocab)
    for r, part in enumerate(rows.chunk(t)):
        v0, v1 = tp.vocab_range(vocab, t, r)
        assert (v0, v1) == (int(part[0]), int(part[-1]) + 1)


def test_qkv_shard_is_each_ranks_heads_of_q_k_and_v():
    d, h, t = 32, 4, 2
    w = torch.arange(3 * d * d, dtype=torch.float32).reshape(3 * d, d)
    for r in range(t):
        got = tp.shard_tensor("h.0.qkv.weight", w, t, r)
        want = w.view(3, h, d // h, d)[:, r * 2:(r + 1) * 2].reshape(-1, d)
        assert torch.equal(got, want)


WORKER = r"""
import os
import sys
import torch
import torch.distributed as dist
import torch.nn.functional as F
from tpudist_torch.distributed import init_from_env
from tpudist_torch.mesh import MeshConfig, create_layout
from tpudist_torch.models.gpt2 import GPT2
from tpudist_torch.models.llama import Llama
from tpudist_torch.models.lm_utils import chunked_ce_sum
from tpudist_torch.parallel import tp
from tpudist_torch.train import lm_loss, tp_lm_loss

torch.set_num_threads(1)
src, out = sys.argv[1], sys.argv[2]
ctx = init_from_env("cpu")
data = torch.load(src)
res = {}
layouts = {4: create_layout(MeshConfig(data=-1, tensor=4)),
           2: create_layout(MeshConfig(data=-1, tensor=2))}
for (arch, vocab), sd in data["init"].items():
    for t, lay in layouts.items():
        if arch == "llama" and t == 4:
            continue  # its 2 K/V heads do not divide over 4 ranks
        shards = tp.shard_state_dict(sd, lay)
        back = tp.gather_state_dict(shards, lay, vocab)
        res[("roundtrip", arch, vocab, t)] = all(
            torch.equal(back[k], v) for k, v in sd.items()) and \
            back.keys() == sd.keys()
        cls = GPT2 if arch == "gpt2" else Llama
        geom = data["geom"][arch]
        whole = cls(vocab_size=vocab, **geom, device="cpu")
        whole.load_state_dict(sd)
        model = cls(vocab_size=vocab, **geom, device="cpu", layout=lay)
        # the seeded init drawn whole, then sliced
        fresh = tp.gather_state_dict(model.state_dict(), lay, vocab)
        res[("init", arch, vocab, t)] = all(
            torch.equal(fresh[k], v) for k, v in
            cls(vocab_size=vocab, **geom, device="cpu").state_dict().items())
        model.load_state_dict(shards)
        tokens = data["tokens"] % vocab
        want = whole(tokens)
        lw = lm_loss(want, tokens)
        lw.backward()
        got = model(tokens)
        local = model(tokens, vocab_local=True)
        ls = tp_lm_loss(local, tokens, lay, vocab)
        ls.backward()
        grads = tp.gather_state_dict(
            {k: p.grad for k, p in model.named_parameters()}, lay, vocab)
        res[("model", arch, vocab, t)] = {
            "logits": float((got - want).abs().max()),
            "loss": (float(ls), float(lw)),
            "grads": max(float((grads[k] - p.grad).abs().max())
                         for k, p in whole.named_parameters())}
        # the chunked loss over the same hidden state
        whole.zero_grad(); model.zero_grad()
        hidden = whole(tokens, return_hidden=True)
        mask = torch.ones(tokens.shape[0], tokens.shape[1] - 1)
        a = chunked_ce_sum(whole.wte if arch == "gpt2" else whole.lm_head,
                           hidden[:, :-1], tokens[:, 1:], mask, 5)
        hs = model(tokens, return_hidden=True)
        b = chunked_ce_sum(model.wte if arch == "gpt2" else model.lm_head,
                           hs[:, :-1], tokens[:, 1:], mask, 5, model=model)
        # the mean, as the training loss takes it
        a, b = a / mask.numel(), b / mask.numel()
        a.backward(); b.backward()
        grads = tp.gather_state_dict(
            {k: p.grad for k, p in model.named_parameters()}, lay, vocab)
        res[("chunked", arch, vocab, t)] = {
            "loss": (float(b), float(a)),
            "grads": max(float((grads[k] - p.grad).abs().max())
                         for k, p in whole.named_parameters())}

# the loss alone: uneven shards, ignored rows
for t, lay in layouts.items():
    logits = data["logits"].clone().requires_grad_(True)
    target = data["target"]
    want = F.cross_entropy(logits, target, reduction="none", ignore_index=-100)
    want.sum().backward()
    v0, v1 = tp.vocab_range(67, t, lay.tensor_idx)
    mine = logits.detach()[:, v0:v1].clone().requires_grad_(True)
    got = tp.vocab_parallel_cross_entropy(mine, target, lay, 67)
    got.sum().backward()
    res[("ce", t)] = {"loss": float((got - want).abs().max()),
                      "grad": float((mine.grad - logits.grad[:, v0:v1])
                                    .abs().max())}
if ctx.rank == 0:
    torch.save(res, out)
# every rank here past the last collective: leave without the interpreter's
# teardown of the gloo threads (an abort there under a loaded host would
# fail a world whose results are written)
dist.barrier()
sys.stdout.flush()
os._exit(0)
"""


@pytest.fixture(scope="module")
def tp_world(tmp_path_factory):
    from torch_ports import free_port

    tmp = tmp_path_factory.mktemp("tp")
    init = {}
    for arch in ("gpt2", "llama"):
        for vocab in (64, 67):
            init[(arch, vocab)] = _flax(arch, vocab, seed=1)[0]
    rng = np.random.Generator(np.random.PCG64(4))
    logits = torch.from_numpy(rng.standard_normal((12, 67)).astype(np.float32))
    target = torch.from_numpy(rng.integers(0, 67, 12))
    target[[2, 7]] = -100
    torch.save({"init": init, "geom": {"gpt2": GPT2_GEOM,
                                       "llama": LLAMA_GEOM},
                "tokens": torch.from_numpy(rng.integers(0, 67, (2, 16))),
                "logits": logits, "target": target}, tmp / "in.pt")
    port = free_port()
    procs = []
    for rank in range(4):
        env = {**os.environ, "PYTHONPATH": str(REPO), "MASTER_ADDR":
               "127.0.0.1", "MASTER_PORT": str(port), "RANK": str(rank),
               "WORLD_SIZE": "4", "LOCAL_RANK": str(rank),
               "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, str(tmp / "in.pt"),
             str(tmp / "out.pt")], env=env, cwd=tmp, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out.decode()[-4000:]
    return torch.load(tmp / "out.pt", weights_only=False)


# the tiny Llama's 2 K/V heads split over 2 ranks only
CASES = [(a, v, t) for a in ("gpt2", "llama") for v in (64, 67)
         for t in ((2, 4) if a == "gpt2" else (2,))]
IDS = [f"{a}-V{v}-T{t}" for a, v, t in CASES]


@pytest.mark.parametrize("arch,vocab,t", CASES, ids=IDS)
def test_shard_then_gather_is_bit_identical(tp_world, arch, vocab, t):
    assert tp_world[("roundtrip", arch, vocab, t)]


@pytest.mark.parametrize("arch,vocab,t", CASES, ids=IDS)
def test_sharded_init_is_the_whole_init_sliced(tp_world, arch, vocab, t):
    assert tp_world[("init", arch, vocab, t)]


@pytest.mark.parametrize("arch,vocab,t", CASES, ids=IDS)
def test_sharded_model_is_the_unsharded_function(tp_world, arch, vocab, t):
    got = tp_world[("model", arch, vocab, t)]
    assert got["logits"] < 1e-5
    np.testing.assert_allclose(*got["loss"], rtol=1e-5)
    assert got["grads"] < 1e-5


@pytest.mark.parametrize("arch,vocab,t", CASES, ids=IDS)
def test_chunked_vocab_parallel_loss_is_the_plain_one(tp_world, arch, vocab,
                                                      t):
    got = tp_world[("chunked", arch, vocab, t)]
    np.testing.assert_allclose(*got["loss"], rtol=1e-5)
    assert got["grads"] < 1e-5


@pytest.mark.parametrize("t", [2, 4])
def test_vocab_parallel_cross_entropy_is_the_plain_loss(tp_world, t):
    got = tp_world[("ce", t)]
    assert got["loss"] < 1e-5 and got["grad"] < 1e-6
