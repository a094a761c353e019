"""Shared scaffolding of the composed-axes tests (test_torch_tp_fsdp.py,
test_torch_tp_cp.py, test_torch_tp_zero1.py): the reference's step on a
composed mesh of CPU devices, one gloo world of 4 ranks a file running
the port's step on the same mesh from the same (flax) init, and the bars.

The worker reads a payload:

- ``mesh``: the axis sizes (``data``, ``fsdp``, ``seq``, ``tensor``); an
  fsdp axis builds a ``ParallelPlan``, the others a ``create_layout``;
- ``cases``: ``{name: {arch, opt, attn, zero1, geom, init, batches}}``
  (``opt``: ``sgd``, ``adam`` or ``fused``, the fused AdamW),
  each trained from the whole init (each rank keeping its tensor shards)
  on its replica's rows of every global batch; its losses, its gathered
  parameters, the placement of every leaf (``"fsdp"``: an FSDP DTensor,
  ``"tensor"``: a tensor shard, None) and the bytes of the rank's
  parameters and optimizer-state tensors come back;
- ``ckpt``: ``(case, dir)``, whose final state is saved with DCP and
  restored into a fresh one (every tensor compared bit for bit);
- ``cli``: ``[(tag, module, argv[, init])]``, a CLI run in the world (its
  model loading ``init``, or ``cli_init``), each rank's losses, the
  gathered parameters and (BERT) the batches the rank drew;
- ``overlay``: a case run on its own ``mesh`` (a ``data 2 x fsdp 2``
  plan) in the same world, with the ZeRO-1 state's classification of
  each leaf.
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax.core import meta
from jax.sharding import PartitionSpec as P

from tpudist import mesh as jax_mesh
from tpudist.models.gpt2 import GPT2 as JGPT2
from tpudist.models.llama import Llama as JLlama
from tpudist.optim import shard_state as jax_shard_state
from tpudist.parallel.plan import ParallelPlan as JPlan
from tpudist.train import create_train_state as jax_create_train_state
from tpudist.train import lm_loss as jax_lm_loss
from tpudist.train import make_train_step as jax_make_train_step
from tpudist.train import state_shardings_of
from tpudist_torch.interop import gpt2_params_from_flax, llama_params_from_flax

REPO = Path(__file__).resolve().parent.parent
CP = ("ring", "ulysses", "ulysses_flash")

WORKER = r"""
import contextlib, io, os, sys
import torch
import torch.distributed as dist
from tpudist_torch.checkpoint import Checkpointer
from tpudist_torch.distributed import init_from_env
from tpudist_torch.mesh import MeshConfig, create_layout
from tpudist_torch.models.gpt2 import GPT2
from tpudist_torch.models.llama import Llama
from tpudist_torch.optim import SGD, local, make_optimizer, shard_state
from tpudist_torch.parallel import tp
from tpudist_torch.parallel.plan import ParallelPlan
from tpudist_torch.train import create_train_state, lm_loss, make_train_step

torch.set_num_threads(1)
src, out = sys.argv[1], sys.argv[2]
ctx = init_from_env("cpu")
data = torch.load(src)
res = {}


def laid_out(mesh):
    mesh = dict(mesh)
    min_size = mesh.pop("min_size", 1024)
    if mesh.get("fsdp", 1) > 1:
        plan = ParallelPlan.build(**mesh, fsdp_min_size=min_size)
        return plan, plan.layout
    return None, create_layout(MeshConfig(**mesh))


def build(case, lay):
    cls = GPT2 if case["arch"] == "gpt2" else Llama
    model = cls(vocab_size=data["V"], **case["geom"], device="cpu",
                attn_impl=case["attn"], layout=lay)
    model.load_state_dict(tp.shard_state_dict(case["init"], lay,
                                              table=model.tensor_specs))
    return model


def optimizer(case, plan, lay):
    tx = (SGD(0.1, momentum=0.0) if case["opt"] == "sgd"
          else make_optimizer(1e-3, fused=case["opt"] == "fused"))
    if case["zero1"]:
        tx = plan.wrap_zero1(tx) if plan is not None else shard_state(tx, lay)
    return tx


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = local(v).detach().clone()
    return out


def run(name, case, plan, lay):
    model = build(case, lay)
    tx = optimizer(case, plan, lay)
    state = create_train_state(model, tx, plan)
    step = make_train_step(model, tx, loss_fn=lm_loss, input_key="tokens",
                           label_key="tokens", plan=plan,
                           fused="optimizer" if case["opt"] == "fused"
                           else None)
    losses = []
    for b in case["batches"]:
        rows = b.chunk(lay.data_parallel_size)[lay.replica]
        state, m = step(state, {"tokens": rows})
        losses.append(float(m["loss"]))
    placed = set(tp.sharded_names(model))
    opt = state.opt_state
    moments = {}
    for g in ("mu", "nu"):
        inner = getattr(getattr(opt, "inner", opt), g, None)
        if inner is not None:
            moments[g] = {k: tuple(local(v).shape) for k, v in inner.items()}
    r = {"losses": losses, "params": state.params(),
         "placement": {k: "fsdp" if hasattr(p, "to_local") else
                       "tensor" if k in placed else None
                       for k, p in model.named_parameters()},
         "param_bytes": sum(local(p).numel() * local(p).element_size()
                            for p in model.parameters()),
         "moments": moments,
         "module": type(state.module).__name__}
    return r, state, model, tx


plan, lay = laid_out(data["mesh"])
res["worlds"] = {a: getattr(lay, a) for a in ("data", "fsdp", "seq",
                                                "tensor")}
res["mesh_dims"] = (None if lay.device_mesh is None
                    else lay.device_mesh.mesh_dim_names)
for name, case in data["cases"].items():
    r, state, model, tx = run(name, case, plan, lay)
    res[(name, ctx.rank)] = r
    ck = data.get("ckpt")
    if ck is not None and ck[0] == name:
        saver = Checkpointer(ck[1])
        saver.save(state, wait=True)
        fresh = create_train_state(build(case, lay), optimizer(case, plan,
                                                               lay), plan)
        saver.restore(fresh)
        a, b = flat(state.state_dict()), flat(fresh.state_dict())
        same = a.keys() == b.keys() and all(torch.equal(a[k], b[k])
                                            for k in a)
        same &= all(torch.equal(local(p), local(q)) for p, q in zip(
            state.model.parameters(), fresh.model.parameters()))
        res[("restored", ctx.rank)] = same and fresh.step == state.step
        res["saved_shapes"] = {k: tuple(v[0]) for k, v in
                               saver.saved_metadata(state.step).items()}
        saver.close()

if data.get("overlay") is not None:
    oplan, olay = laid_out(data["overlay"]["mesh"])
    r, state, model, tx = run("overlay", data["overlay"], oplan, olay)
    r["modes"] = {k: m for k, (m, _) in state.opt_state.modes.items()}
    res[("overlay", ctx.rank)] = r

for tag, module, argv, *init in data.get("cli", ()):
    init = init[0] if init else data.get("cli_init")
    mod = __import__(module, fromlist=["main"])
    batches = []
    if module.endswith("train_bert"):
        # the model loads the reference's init; the corrupted batches the
        # replica's ranks drew are recorded for the reference's step
        import tpudist_torch.data.lm as LM
        import tpudist_torch.models.bert as MB

        bert, gather = MB.Bert, LM.TokenWindowLoader._gather_batch

        def loaded(*args, _b=bert, **kw):
            model = _b(*args, **kw)
            model.load_state_dict(tp.shard_state_dict(
                init, kw["layout"], table=tp.BERT_SPECS))
            return model

        def recording(self, indices, start, _g=gather):
            batch = _g(self, indices, start)
            batches.append({k: torch.from_numpy(v.copy())
                            for k, v in batch.items()})
            return batch

        MB.Bert, LM.TokenWindowLoader._gather_batch = loaded, recording
    if hasattr(mod, "build_model"):
        build_model = mod.build_model

        def build_loaded(args, dtype, attn, device, layout, _b=build_model):
            model = _b(args, dtype, attn, device, layout)
            model.load_state_dict(tp.shard_state_dict(
                init, layout, table=model.tensor_specs))
            return model

        mod.build_model = build_loaded
    destroy, dist.destroy_process_group = (dist.destroy_process_group,
                                           lambda *a, **k: None)
    printed = io.StringIO()
    try:
        with contextlib.redirect_stdout(printed):
            state, losses = mod.main(["--device", "cpu", *argv])
        got = {"losses": losses, "params": state.params(),
               "stdout": printed.getvalue(), "batches": batches}
    except (ValueError, SystemExit, NotImplementedError) as e:
        got = {"error": f"{type(e).__name__}: {e}"}
    finally:
        dist.destroy_process_group = destroy
        if hasattr(mod, "build_model"):
            mod.build_model = build_model
        if module.endswith("train_bert"):
            MB.Bert, LM.TokenWindowLoader._gather_batch = bert, gather
    res[(tag, ctx.rank)] = got

gathered = [None] * dist.get_world_size()
dist.all_gather_object(gathered, res)
if ctx.rank == 0:
    merged = {}
    for r in gathered:
        merged.update(r)
    torch.save(merged, out)
# every rank here past the last collective: leave without the interpreter's
# teardown of the gloo threads
dist.barrier()
sys.stdout.flush()
os._exit(0)
"""


def spawn(tmp, payload, world=4):
    """Run :data:`WORKER` in a gloo world of ``world`` ranks on
    ``payload``; return rank 0's merged results."""
    from torch_ports import free_port

    torch.save(payload, tmp / "in.pt")
    port = free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, "PYTHONPATH": str(REPO), "MASTER_ADDR":
               "127.0.0.1", "MASTER_PORT": str(port), "RANK": str(rank),
               "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
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


def jax_model(arch, vocab, geom, attn, mesh):
    cls, convert = ((JGPT2, gpt2_params_from_flax) if arch == "gpt2" else
                    (JLlama, llama_params_from_flax))
    kw = {"mesh": mesh} if attn in CP else {}
    return cls(vocab_size=vocab, **geom, attn_impl=attn, **kw), convert


def reference(arch, tx, batches, *, mesh, vocab, geom, attn="xla",
              zero1=False, chunk=None):
    """The reference's step on ``mesh`` (axis sizes; an fsdp axis builds
    its ``ParallelPlan``, ZeRO-1 through ``plan.wrap_zero1`` or
    ``shard_state``): ``(init, losses, final)``, the parameters as the
    port's state dicts. A seq axis shards the tokens over ``((data,
    fsdp), seq)``, as the CLIs' ``batch_spec`` does."""
    from tpudist.models.lm_utils import chunked_lm_forward

    sizes = {a: mesh.get(a, 1) for a in ("data", "fsdp", "seq", "tensor")}
    devices = jax.devices()[:math.prod(sizes.values())]
    plan = None
    if sizes["fsdp"] > 1:
        plan = JPlan.build(devices=devices, data=sizes["data"],
                           fsdp=sizes["fsdp"], tensor=sizes["tensor"],
                           fsdp_min_size=mesh.get("min_size", 1024))
        jmesh = plan.mesh
        if zero1:
            tx = plan.wrap_zero1(tx)
    else:
        jmesh = jax_mesh.create_mesh(jax_mesh.MeshConfig(**sizes),
                                     devices=devices)
        if zero1:
            tx = jax_shard_state(tx, jmesh)
    model, convert = jax_model(arch, vocab, geom, attn, jmesh)
    rows, s = batches[0].shape
    sample = jnp.zeros((rows, s), jnp.int32)
    state = (jax_create_train_state(model, 0, sample, tx, plan=plan)
             if plan is not None else
             jax_create_train_state(model, 0, sample, tx, jmesh))
    kw = {}
    if sizes["seq"] > 1:
        kw["batch_spec"] = {"tokens": P((jax_mesh.DATA_AXIS,
                                         jax_mesh.FSDP_AXIS),
                                        jax_mesh.SEQUENCE_AXIS)}
    if chunk:
        kw["forward_loss"] = chunked_lm_forward(model, chunk=chunk)
    step = jax_make_train_step(model, tx, jmesh, loss_fn=jax_lm_loss,
                               input_key="tokens", label_key="tokens",
                               state_sharding=state_shardings_of(state),
                               plan=plan, **kw)

    def params(st):
        return convert(jax.tree_util.tree_map(np.asarray,
                                              meta.unbox(st.params)))

    init, losses = params(state), []
    for b in batches:
        state, m = step(state, {"tokens": b})
        losses.append(float(m["loss"]))
    return init, losses, params(state)


def assert_close(got, want_losses, want, *, sgd, steps=3, lr=1e-3):
    """tests/test_torch_tp_train.py's bars: one SGD step ``atol=rtol=
    1e-5``; three Adam steps ``rtol 2e-4`` with the floor of that bar times
    the parameter scale for elements Adam moves from zero, the qkv key
    bias (a zero gradient in exact arithmetic) held to the step bound."""
    rtol = 1e-5 if sgd else 2e-4
    np.testing.assert_allclose(got["losses"], want_losses, rtol=rtol,
                               atol=1e-5 if sgd else 0)
    assert got["params"].keys() == want.keys()
    for k, w in want.items():
        g, w = got["params"][k].numpy(), np.asarray(w)
        if not sgd and k.endswith("qkv.bias"):
            assert np.abs(g[1]).max() <= 1.5 * steps * lr, k
            g, w = g[[0, 2]], w[[0, 2]]
        atol = 1e-5 if sgd else 2e-4 * lr * steps
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=k)


def assert_cli_close(got, want_losses, want, *, steps, lr):
    """tests/test_torch_gpt2_train.py's bars for a CLI run against the
    reference's step with its schedule."""
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-5)
    assert got["params"].keys() == want.keys()
    for k, w in want.items():
        g, w = got["params"][k].numpy(), np.asarray(w)
        if k.endswith("qkv.bias"):
            assert np.abs(g[1]).max() <= 1.5 * steps * lr, k
            g, w = g[[0, 2]], w[[0, 2]]
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=k)


def lm_cli_reference(stream, *, mesh, replicas, vocab, geom, batch, seq,
                     steps, lr, attn="xla"):
    """The reference's AdamW step (the CLI's schedule, decay 0.1, clip
    1.0) on ``mesh`` over the windows the port's loader deals its
    ``replicas``: ``(init, losses, final)``."""
    from tpudist.optim import make_optimizer as jax_make_optimizer
    from tpudist.optim import run_schedule as jax_run_schedule
    from tpudist_torch.data.lm import TokenWindowLoader

    tx = jax_make_optimizer(
        jax_run_schedule(lr, total_steps=steps, warmup_steps=0),
        weight_decay=0.1, clip_norm=1.0)
    loaders = [iter(TokenWindowLoader(stream, batch, seq,
                                      num_replicas=replicas, rank=d))
               for d in range(replicas)]
    batches = [np.concatenate([next(it)["tokens"] for it in loaders])
               for _ in range(steps)]
    return reference("gpt2", tx, batches, mesh=mesh, vocab=vocab, geom=geom,
                     attn=attn)


def lm_geometry_flags(vocab, geom, arch="gpt2"):
    flags = ["--vocab_size", str(vocab), "--seq_len",
             str(geom["max_seq_len"]), "--hidden_dim",
             str(geom["hidden_dim"]), "--depth", str(geom["depth"]),
             "--num_heads", str(geom["num_heads"])]
    if arch == "llama":
        flags += ["--arch", "llama", "--num_kv_heads",
                  str(geom["num_kv_heads"]), "--ffn_dim", str(geom["ffn_dim"])]
    return flags
