"""The port's gradient buckets, int8 quantizer and int8-wire ring
(``tpudist_torch.allreduce``) against ``tpudist.comm``.

- ``BucketLayout``'s numbers (bucket size, count, padding, wire bytes)
  equal the reference's for the same leaf sizes and world.
- ``quantize_bucket`` without a key and ``dequantize`` are bit-identical
  to the reference's on the same buckets, all-zero, NaN and inf included.
- Stochastic rounding is unbiased: the mean of ``N = 512`` draws lies
  within ``6 scale / sqrt(N)`` of ``x`` (one draw errs by less than one
  scale), the bound stated before the run.
- The ring (loopback n = 2, 4 and a gloo world of 4): every rank's result
  is bit-identical, and it lies within the per-hop quantization bound of
  the exact float32 sum: each of the ``w`` quantizations of a partial sum
  (``w - 1`` hops plus the owner's) errs by at most its scale (stochastic)
  or half of it (nearest), and every partial sum's amax is at most ``A =
  sum_r max |x_r|``, so ``|out - sum| <= w A / 127`` (``w A / 254``
  without a key). The reference's ring over 4 CPU devices lies within the
  same bound on the same buckets.
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
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpudist import comm as jcomm
from tpudist.utils.compat import shard_map
from tpudist_torch import allreduce as comm
from tpudist_torch.rng import fold_in
from torch_threads import two_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("sizes,world,bucket", [
    ((37, 91, 1), 8, 16),
    ((898,), 8, 4 * 1024 * 1024),   # one leaf, smaller than one bucket
    ((5, 1000, 333), 4, 128),
    ((10_000,), 1, 1024),
    ((64, 64, 7), 2, comm.DEFAULT_BUCKET_ELEMS),
])
def test_layout_numbers_equal_the_reference(sizes, world, bucket):
    tree = {f"l{i}": torch.zeros(n) for i, n in enumerate(sizes)}
    jtree = {f"l{i}": jnp.zeros(n) for i, n in enumerate(sizes)}
    ours = comm.BucketLayout(tree, world, bucket)
    ref = jcomm.BucketLayout(jtree, world, bucket)
    for attr in ("total", "bucket_size", "n_buckets", "padded_total",
                 "buckets_per_chunk"):
        assert getattr(ours, attr) == getattr(ref, attr), attr
    for method in ("quantized", "bucketed"):
        for r in (1, 5):
            assert ours.wire_bytes(method, reductions=r) == ref.wire_bytes(
                method, reductions=r)


def test_layout_round_trip_and_padding():
    tree = {"a": torch.arange(37.0), "b": torch.arange(91.0).view(7, 13) * 0.5,
            "c": torch.tensor(3.25), "d": torch.ones(5, 11, dtype=torch.bfloat16)}
    layout = comm.BucketLayout(tree, world=8, bucket_size=16)
    buckets = layout.flatten(tree)
    assert buckets.shape == (layout.n_buckets, layout.bucket_size)
    assert layout.n_buckets % 8 == 0
    assert torch.count_nonzero(buckets.reshape(-1)[layout.total:]) == 0
    out = layout.unflatten(buckets)
    for k, t in tree.items():
        assert out[k].dtype == t.dtype and torch.equal(out[k], t)
    jtree = {k: jnp.asarray(t.float().numpy()) for k, t in tree.items()}
    ref = jcomm.BucketLayout(jtree, world=8, bucket_size=16).flatten(jtree)
    np.testing.assert_array_equal(buckets.numpy(), np.asarray(ref))
    with pytest.raises(ValueError):
        comm.BucketLayout({}, world=2)
    with pytest.raises(ValueError):
        comm.BucketLayout(tree, world=0)
    with pytest.raises(ValueError):
        comm.BucketLayout(tree, world=2, bucket_size=0)
    with pytest.raises(ValueError):
        layout.wire_bytes("nope")


def _buckets():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 257)).astype(np.float32) * np.float32(3.0)
    x[1] = 0.0                       # all-zero bucket: scale 1, exact
    x[2, 5] = np.nan                 # poisoned buckets stay non-finite
    x[3, 0] = np.inf
    x[4, 7] = -np.inf
    x[5, :] = rng.normal(size=257).astype(np.float32) * np.float32(1e-30)
    x[6, ::2] = np.float32(0.5) * np.float32(127.0 / 3.0)  # halves: to even
    return x


def test_keyless_quantize_is_bit_identical_to_the_reference():
    x = _buckets()
    q, s = comm.quantize_bucket(torch.from_numpy(x))
    jq, js = jcomm.quantize_bucket(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    d = comm.dequantize(q, s)
    np.testing.assert_array_equal(
        d.numpy(), np.asarray(jcomm.dequantize(jq, js)))
    assert not torch.isfinite(d[2]).all() and not torch.isfinite(d[3]).all()
    assert torch.equal(d[1], torch.zeros(257)) and float(s[1]) == 1.0


def test_stochastic_quantize_keeps_nonfinite_and_zero():
    x = torch.from_numpy(_buckets())
    q, s = comm.quantize_bucket(x, 11)
    d = comm.dequantize(q, s)
    assert not torch.isfinite(d[2]).all() and not torch.isfinite(d[4]).all()
    assert torch.equal(d[1], torch.zeros(257))
    fin = torch.isfinite(x).all(-1)
    err = (d[fin] - x[fin]).abs()
    assert bool((err <= s[fin]).all())


def test_stochastic_rounding_is_unbiased():
    x = torch.from_numpy(
        np.random.default_rng(1).normal(size=(1, 128)).astype(np.float32))
    n = 512
    acc = torch.zeros(1, 128, dtype=torch.float64)
    for i in range(n):
        q, s = comm.quantize_bucket(x, fold_in(3, i))
        acc += comm.dequantize(q, s).double()
    _, scale = comm.quantize_bucket(x)
    tol = float(scale) * 6 / np.sqrt(n)
    np.testing.assert_allclose((acc / n).numpy(), x.double().numpy(), atol=tol)


def _locals(w, bpc=2, b=32, seed=0):
    return np.random.default_rng(seed).normal(
        size=(w, w, bpc, b)).astype(np.float32)


def _bound(locals_np, keyed):
    w = locals_np.shape[0]
    a = np.abs(locals_np).reshape(w, -1).max(axis=1).sum()
    return w * a / (127 if keyed else 254)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("keyed", [False, True])
def test_loopback_ring_is_identical_across_ranks_and_within_bound(n, keyed):
    x = _locals(n, seed=n)
    keys = [fold_in(7, r) for r in range(n)] if keyed else None
    out = comm.ring_allreduce_quantized(torch.from_numpy(x),
                                        comm.LoopbackRing(n), keys)
    for r in range(1, n):
        assert torch.equal(out[r], out[0])
    err = np.abs(out[0].numpy() - x.sum(0))
    assert err.max() <= _bound(x, keyed), (err.max(), _bound(x, keyed))


def test_reference_ring_on_4_devices_lies_within_the_same_bound():
    w = 4
    x = _locals(w, seed=w)
    mesh = Mesh(np.asarray(jax.devices()[:w]), ("data",))

    def body(xs, key):
        k = jax.random.fold_in(key, jax.lax.axis_index("data"))
        return jcomm.ring_allreduce_quantized(xs[0], "data", k)[None]

    fn = shard_map(body, mesh=mesh, in_specs=(P("data"), P()),
                   out_specs=P("data"), check_vma=False)
    out = np.asarray(jax.jit(fn)(
        jax.device_put(x, NamedSharding(mesh, P("data"))), jax.random.key(7)))
    assert np.abs(out[0] - x.sum(0)).max() <= _bound(x, True)
    ours = comm.ring_allreduce_quantized(
        torch.from_numpy(x), comm.LoopbackRing(w),
        [fold_in(7, r) for r in range(w)])
    # two independent roundings of one sum: each within the bound of it
    assert np.abs(ours[0].numpy() - out[0]).max() <= 2 * _bound(x, True)


def test_reduce_buckets_loopback_means_and_residual():
    w = 4
    layout = comm.BucketLayout({"w": torch.zeros(203)}, world=w, bucket_size=16)
    rng = np.random.default_rng(2)
    shape = (w, layout.n_buckets, layout.bucket_size)
    b = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    res = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * 0.01)
    ring = comm.LoopbackRing(w)
    mean, r = comm.reduce_buckets(b, None, layout, ring, method="bucketed")
    assert r is None
    np.testing.assert_allclose(mean[0].numpy(), b.numpy().mean(0), rtol=1e-6,
                               atol=1e-6)
    keys = [fold_in(5, i) for i in range(w)]
    mean, r = comm.reduce_buckets(b, res, layout, ring, keys,
                                  method="quantized")
    x = b + res
    for i in range(w):
        q, s = comm.quantize_bucket(x[i], fold_in(keys[i], 0))
        assert torch.equal(r[i], x[i] - comm.dequantize(q, s))
        assert torch.equal(mean[i], mean[0])
    true = x.numpy().mean(0)
    a = np.abs(x.numpy()).reshape(w, -1).max(1).sum()
    # the local quantization (A / 127 summed) plus the ring's bound, / w
    assert np.abs(mean[0].numpy() - true).max() <= (a / 127 + w * a / 127) / w


def test_multihost_reads_the_launcher(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert comm.multihost()
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    assert not comm.multihost()
    monkeypatch.delenv("WORLD_SIZE")
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    assert not comm.multihost()


GLOO_RING = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from tpudist_torch import allreduce as comm
from tpudist_torch.rng import fold_in

dist.init_process_group("gloo")
r, w = dist.get_rank(), dist.get_world_size()
x = np.random.default_rng(w).normal(size=(w, w, 2, 32)).astype(np.float32)
for keyed in (False, True):
    out = comm.ring_allreduce_quantized(
        torch.from_numpy(x[r:r + 1]), comm.GroupRing(),
        [fold_in(7, r)] if keyed else None)
    loop = comm.ring_allreduce_quantized(
        torch.from_numpy(x), comm.LoopbackRing(w),
        [fold_in(7, i) for i in range(w)] if keyed else None)
    every = [torch.empty_like(out) for _ in range(w)]
    dist.all_gather(every, out)
    torch.save({"every": every, "loop": loop}, f"{sys.argv[1]}_{int(keyed)}_{r}")
dist.destroy_process_group()
"""


def _free_port() -> int:
    from torch_ports import free_port

    return free_port()


def test_gloo_ring_of_4_equals_the_loopback_bit_for_bit(tmp_path):
    w, port = 4, _free_port()
    script = tmp_path / "ring.py"
    script.write_text(GLOO_RING)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(tmp_path / "out")],
        env={**os.environ, "PYTHONPATH": str(REPO), "MASTER_ADDR": "127.0.0.1",
             "MASTER_PORT": str(port), "RANK": str(r), "WORLD_SIZE": str(w),
             "OMP_NUM_THREADS": "1"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(w)]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out.decode()[-3000:]
    x = _locals(w, seed=w)
    for keyed in (0, 1):
        got = torch.load(tmp_path / f"out_{keyed}_0")
        every = got["every"]
        for r in range(w):
            assert torch.equal(every[r][0], every[0][0])
            assert torch.equal(every[r][0], got["loop"][r])
        err = np.abs(every[0][0].numpy() - x.sum(0))
        assert err.max() <= _bound(x, bool(keyed))
