"""The port's context parallelism (tpudist_torch.parallel.cp,
tpudist_torch.mesh) against the JAX reference (tpudist.parallel.cp) on
the same inputs, drawn from a seed with numpy, on the CPU.

Ring and Ulysses attention, forward and the q/k/v gradients of a random
cotangent, causal and not, at n = 2 and 4 seq ranks: the port's n ranks
run in this process through the loopback exchange
(``ring_attention_loopback``, ``ulysses_attention_loopback``), the
reference's on ``MeshConfig(data=1, seq=n)`` over ``jax.devices()[:n]``
(conftest.py's 8 fake devices). Then GQA through ``repeat_kv``,
``ulysses_flash``'s kernel attention (the Pallas kernels in interpret
mode on the JAX side), the refusals (heads not divisible by n, decode in
both model families, a CP impl without a layout), the rank layout against
the reference's device order, and one 2-rank gloo world that runs
``batch_isend_irecv`` and ``all_to_all_single`` for real.

Tolerances are the reference's own CP tolerances
(tests/test_context_parallel.py): 1e-5 absolute and relative on the
forward, 1e-4 on the gradients, float32 on both sides.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpudist import mesh as jax_mesh
from tpudist.ops.attention import kernel_attention as jax_kernel_attention
from tpudist.ops.attention import repeat_kv as jax_repeat_kv
from tpudist.parallel.cp import ring_attention, ulysses_attention
from tpudist_torch import mesh as mesh_lib
from tpudist_torch.models.gpt2 import GPT2
from tpudist_torch.models.llama import Llama
from tpudist_torch.ops.attention import kernel_attention, repeat_kv
from tpudist_torch.parallel import cp
from torch_threads import two_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
FWD, GRAD = 1e-5, 1e-4


def _inputs(b=2, s=64, h=4, d=16, h_kv=None, seed=0):
    rng = np.random.Generator(np.random.PCG64(seed))
    h_kv = h_kv or h
    q = rng.standard_normal((b, s, h, d), np.float32)
    k, v = (rng.standard_normal((b, s, h_kv, d), np.float32) for _ in range(2))
    g = rng.standard_normal((b, s, h, d), np.float32)
    return q, k, v, g


def _reference(fn, q, k, v, g, n, *, causal, attn_fn=None, gqa=False):
    mesh = jax_mesh.create_mesh(jax_mesh.MeshConfig(data=1, seq=n),
                                devices=jax.devices()[:n])
    kw = {} if attn_fn is None else {"attn_fn": attn_fn}

    def loss(q, k, v):
        if gqa:
            k, v = jax_repeat_kv(q, k, v)
        out = fn(q, k, v, mesh, causal=causal, **kw)
        return jnp.sum(out * g), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(out), [np.asarray(x) for x in grads]


def _port(fn, q, k, v, g, n, *, causal, gqa=False, **kw):
    q, k, v = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    kk, vv = repeat_kv(q, k, v) if gqa else (k, v)
    out = fn(q, kk, vv, n, causal=causal, **kw)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [x.grad.numpy() for x in (q, k, v)]


def _close(got, want):
    (out, grads), (want_out, want_grads) = got, want
    np.testing.assert_allclose(out, want_out, atol=FWD, rtol=FWD)
    for name, a, b in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(a, b, atol=GRAD, rtol=GRAD,
                                   err_msg=f"d{name}")


SCHEMES = {"ring": (cp.ring_attention_loopback, ring_attention),
           "ulysses": (cp.ulysses_attention_loopback, ulysses_attention)}


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("scheme", ["ring", "ulysses"])
def test_matches_the_reference(scheme, n, causal):
    port_fn, ref_fn = SCHEMES[scheme]
    q, k, v, g = _inputs()
    _close(_port(port_fn, q, k, v, g, n, causal=causal),
           _reference(ref_fn, q, k, v, g, n, causal=causal))


#: the bf16 ring's bar against the reference: every dq, dk, dv element
#: within one bf16 step of the reference's, the step of the tensor's
#: largest element (the unit of ROADMAP's reading before the repair; an
#: element's own step is too fine where two hops' rounded terms cancel,
#: and at an exact 0 the two sides' f32 residues differ), and at most 1%
#: of the elements off it at all. Both were set after the first reading
#: of the repaired backward (the per-element one-step form was tried
#: first and failed on small dq elements). Readings, full / causal, as
#: (largest error in steps of the largest element, share of elements off):
#: repaired dq 0 / (0.0156, 0.83%), dk and dv 0 / 0 (bit-equal); the
#: backward before the repair dq (0.5, 40.5%) / (1.0, 29.5%), dk
#: (1.0, 38.7%) / (0.5, 26.4%), dv (0.25, 38.0%) / (0.5, 16.9%). The step
#: term alone passes the old backward; the share cap is what fails it.
RING_BF16_STEPS, RING_BF16_SHARE = 1.0, 0.01


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_bf16_ring_gradients_round_as_the_reference(causal):
    """bf16 on both sides, n = 2 (the loopback against the reference on 2
    CPU devices), B 1, S 64, H 2, D 16: the backward rounds each hop's
    dq, dk, dv and their running sums to bf16 and takes delta from the
    f32 output, as ``jax.grad`` of the reference's scan does."""
    q, k, v, g = _inputs(b=1, s=64, h=2, d=16, seed=3)
    mesh = jax_mesh.create_mesh(jax_mesh.MeshConfig(data=1, seq=2),
                                devices=jax.devices()[:2])
    bf = lambda x: jnp.asarray(x, jnp.bfloat16)

    def loss(q, k, v):
        out = ring_attention(q, k, v, mesh, causal=causal)
        return jnp.sum(out.astype(jnp.float32) * bf(g).astype(jnp.float32))

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(bf(q), bf(k), bf(v))
    ts = [torch.tensor(x).bfloat16().requires_grad_() for x in (q, k, v)]
    cp.ring_attention_loopback(*ts, 2, causal=causal).backward(
        torch.tensor(g).bfloat16())
    for name, t, w in zip("qkv", ts, want):
        got = t.grad.float().numpy()
        w = np.asarray(w.astype(jnp.float32))
        step = np.spacing(np.abs(w).max()) * 2.0 ** 16
        assert float((np.abs(got - w) / step).max()) <= RING_BF16_STEPS, name
        assert float((got != w).mean()) <= RING_BF16_SHARE, name


@pytest.mark.parametrize("scheme", ["ring", "ulysses"])
def test_grouped_kv_heads_through_repeat_kv(scheme):
    """Llama's GQA: K/V heads repeated before the CP body on both sides;
    the K/V gradients sum over their query groups."""
    port_fn, ref_fn = SCHEMES[scheme]
    q, k, v, g = _inputs(h=4, h_kv=2, seed=1)
    _close(_port(port_fn, q, k, v, g, 2, causal=True, gqa=True),
           _reference(ref_fn, q, k, v, g, 2, causal=True, gqa=True))


def test_ulysses_flash_takes_the_kernel_attention():
    """``ulysses_flash``: each head group through the best kernel for the
    whole sequence (S 128: the vmem kernel's plain version here, the
    Pallas kernel in interpret mode on the reference's side)."""
    q, k, v, g = _inputs(s=128, seed=2)
    _close(_port(cp.ulysses_attention_loopback, q, k, v, g, 2, causal=True,
                 attn_fn=kernel_attention),
           _reference(ulysses_attention, q, k, v, g, 2, causal=True,
                      attn_fn=jax_kernel_attention))


def test_one_rank_takes_no_collective():
    """n = 1 with no group: Ulysses is ``attn_fn`` itself, the ring one
    hop, both the dense attention's function."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(seed=3))
    dense = cp.dot_product_attention(q, k, v, causal=True)
    assert torch.equal(cp.ulysses_attention_local(q, k, v, causal=True), dense)
    ring = cp.ring_attention_local(q, k, v, causal=True)
    np.testing.assert_allclose(ring.numpy(), dense.numpy(), atol=FWD, rtol=FWD)
    loop = cp.ring_attention_loopback(q, k, v, 1, causal=True)
    assert torch.equal(ring, loop)


def test_refusals():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(h=6))
    with pytest.raises(ValueError, match="num_heads 6 not divisible by seq "
                       "axis 4"):
        cp.ulysses_attention_loopback(q, k, v, 4)
    with pytest.raises(ValueError, match="repeat grouped K/V heads"):
        cp.ring_attention_loopback(q, k[:, :, :2], v[:, :, :2], 2)
    with pytest.raises(ValueError, match="not divisible by 5 shards"):
        cp.ring_attention_loopback(q, k, v, 5)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
@pytest.mark.parametrize("impl", cp.CP_IMPLS)
def test_decode_and_a_missing_layout_are_refused(family, impl):
    """The reference's refusals: a CP model has no decode path, and a CP
    impl needs its layout (the reference's mesh)."""
    cls = GPT2 if family == "gpt2" else Llama
    geom = dict(vocab_size=64, max_seq_len=16, hidden_dim=32, depth=1,
                num_heads=4, device="cpu")
    with pytest.raises(ValueError, match="layout"):
        cls(**geom, attn_impl=impl)
    model = cls(**geom, attn_impl=impl, layout=mesh_lib.create_layout())
    cache = model.init_cache(1)
    with pytest.raises(ValueError, match="has no decode path"):
        model(torch.zeros((1, 1), dtype=torch.long), cache=cache)
    logits = model(torch.zeros((2, 16), dtype=torch.long))
    assert logits.shape == (2, 16, 64) and torch.isfinite(logits).all()


def test_layout_is_the_references_device_order():
    """rank = data_idx * seq + seq_idx: the reference's mesh (axis order
    data, fsdp, pipe, expert, seq, tensor) over devices 0..7 in order."""
    cfg = mesh_lib.MeshConfig(data=-1, seq=4)
    assert cfg.axis_sizes(8) == {"data": 2, "fsdp": 1, "pipe": 1,
                                 "expert": 1, "seq": 4, "tensor": 1}
    mesh = jax_mesh.create_mesh(jax_mesh.MeshConfig(data=2, seq=4),
                                devices=jax.devices()[:8])
    ids = np.vectorize(lambda d: d.id)(np.asarray(mesh.devices))
    grid = ids.reshape(2, 4)  # every other axis is 1
    for rank in range(8):
        lay = mesh_lib.RankLayout(rank, 2, 4)
        assert grid[lay.data_idx, lay.seq_idx] == rank
    with pytest.raises(ValueError, match="not divisible"):
        cfg.axis_sizes(6)
    # seq composes with tensor (tests/test_torch_tp_cp.py), not with fsdp
    assert mesh_lib.MeshConfig(tensor=2, seq=2).axis_sizes(8) == {
        "data": 2, "fsdp": 1, "pipe": 1, "expert": 1, "seq": 2, "tensor": 2}
    with pytest.raises(ValueError, match="fsdp does not compose with seq"):
        mesh_lib.MeshConfig(fsdp=2, seq=2)
    one = mesh_lib.create_layout()
    assert (one.data, one.seq, one.seq_group, one.data_group) == (1, 1, None,
                                                                  None)


WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from tpudist_torch.distributed import init_from_env
from tpudist_torch.mesh import MeshConfig, create_layout
from tpudist_torch.parallel import cp

inp, out = sys.argv[1], sys.argv[2]
ctx = init_from_env("cpu")
lay = create_layout(MeshConfig(data=1, seq=ctx.world_size))
arrays = np.load(inp)
w = arrays["q"].shape[1] // lay.seq
part = slice(lay.seq_idx * w, (lay.seq_idx + 1) * w)
res = {}
for name in ("ring", "ulysses"):
    fn = getattr(cp, name + "_attention_local")
    q, k, v = (torch.tensor(arrays[x][:, part], requires_grad=True)
               for x in "qkv")
    o = fn(q, k, v, group=lay.seq_group, causal=True)
    o.backward(torch.from_numpy(arrays["g"][:, part]))
    res[name] = [o.detach().numpy()] + [x.grad.numpy() for x in (q, k, v)]
np.save(out, np.array([res["ring"], res["ulysses"]]))
dist.destroy_process_group()
"""


def _free_port() -> int:
    from torch_ports import free_port

    return free_port()


def test_two_gloo_ranks_match_the_reference(tmp_path):
    """The process-group exchanges (ring P2P both ways, the all-to-all
    and its backward) in a real 2-rank gloo world: each rank's chunk of
    the output and of dq, dk, dv against the reference's."""
    q, k, v, g = _inputs(seed=4)
    np.savez(tmp_path / "in.npz", q=q, k=k, v=v, g=g)
    port, world = _free_port(), 2
    procs = []
    for rank in range(world):
        env = {**os.environ, "PYTHONPATH": str(REPO), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port), "RANK": str(rank),
               "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
               "OMP_NUM_THREADS": "2"}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, str(tmp_path / "in.npz"),
             str(tmp_path / f"r{rank}.npy")], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        # the oracle while the world runs
        want = {name: _reference(SCHEMES[name][1], q, k, v, g, world,
                                 causal=True) for name in SCHEMES}
        for proc in procs:
            log, _ = proc.communicate(timeout=120)
            assert proc.returncode == 0, log
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    chunks = [np.load(tmp_path / f"r{rank}.npy") for rank in range(world)]
    for i, name in enumerate(("ring", "ulysses")):
        out, *grads = (np.concatenate([c[i][j] for c in chunks], axis=1)
                       for j in range(4))
        _close((out, grads), want[name])
