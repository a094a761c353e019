"""The port's decode attention (tpudist_torch.ops.decode) against the JAX
reference on the same inputs: the plain versions of both kernels against
the Pallas kernels (interpret mode on the CPU, as the JAX package's own
tests run them), the dense oracles, a numerical model of the CUDA
kernels' arithmetic (tests/torch_decode_model.py) against the Pallas
kernels, and cached_kv's writes in its three modes against the JAX cache
contents.

Tolerances follow tests/conftest.py's kernel-parity rule, restated here
(the port's tests do not import the reference's conftest helper): 2e-5
absolute and relative in f32; in bf16, 2% of the reference's max
magnitude — the kernels round unnormalised probabilities to bf16 where
the reference rounds at other points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import meta

from tpudist.generate import zero_cache as jax_zero_cache
from tpudist.models.gpt2 import GPT2 as JGPT2
from tpudist.ops.decode import decode_attention as jax_decode_attention
from tpudist.ops.decode import paged_decode_attention as jax_paged_attention
from tpudist.serve.blocks import paged_cache as jax_paged_cache
from tpudist_torch.generate import zero_cache
from tpudist_torch.interop import gpt2_params_from_flax
from tpudist_torch.models.gpt2 import GPT2
from tpudist_torch.ops import decode as D
from tpudist_torch.ops import lm_kernels_bench as LB
from tpudist_torch.serve.blocks import paged_cache
from torch_decode_model import contiguous_model, paged_model

GEOM = dict(vocab_size=64, max_seq_len=64, hidden_dim=32, depth=2, num_heads=4)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def assert_parity(got, want):
    """tests/conftest.py assert_kernel_parity's rule, copied: ``got`` a
    torch tensor, ``want`` the JAX reference array."""
    g = got.float().numpy()
    w = np.asarray(want.astype(jnp.float32))
    if want.dtype == jnp.bfloat16:
        scale = float(max(np.max(np.abs(w)), 1e-6))
        np.testing.assert_allclose(g, w, rtol=0.0, atol=2e-2 * scale)
    else:
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=2e-5)


def _t(x, tdtype):
    return torch.from_numpy(np.asarray(x, np.float32)).to(tdtype)


def _paged_fixture(seed, b, h, h_kv, dh, bs, n_blocks, mb, max_pos, s_q=1):
    """tests/test_serve_paged.py::_paged_fixture's shapes and draws, with a
    query chunk of ``s_q`` rows."""
    rng = np.random.Generator(np.random.PCG64(seed))
    q = rng.standard_normal((b, s_q, h, dh)).astype(np.float32)
    k_pool = rng.standard_normal((n_blocks, h_kv, bs, dh)).astype(np.float32)
    v_pool = rng.standard_normal((n_blocks, h_kv, bs, dh)).astype(np.float32)
    perm = rng.permutation(n_blocks - 1)[: b * mb] + 1
    tables = perm.reshape(b, mb).astype(np.int32)
    pos = rng.integers(0, max_pos, (b,)).astype(np.int32)
    return q, k_pool, v_pool, tables, pos


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("gqa", [1, 2])
@pytest.mark.parametrize("s_q", [1, 3])
def test_paged_plain_matches_jax_kernel(dtype, gqa, s_q):
    """The paged kernel's plain version against the Pallas paged kernel,
    cursors at block start, block end, mid-block and the table's end (the
    s_q > 1 verify chunk's tail walks past it)."""
    jdt, tdt = DTYPES[dtype]
    h = 4
    q, k, v, bt, pos = _paged_fixture(0, b=5, h=h, h_kv=h // gqa, dh=16,
                                      bs=8, n_blocks=64, mb=4, max_pos=31,
                                      s_q=s_q)
    pos[:4] = [0, 7, 8, 31]
    want = jax_paged_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(bt), jnp.asarray(pos), impl="paged")
    got = D.paged_decode_attention(
        _t(q, tdt), _t(k, tdt), _t(v, tdt), torch.from_numpy(bt),
        torch.from_numpy(pos), impl="paged")
    assert got.dtype == tdt
    assert_parity(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("gqa", [1, 2])
def test_paged_oracle_matches_jax_oracle(dtype, gqa):
    jdt, tdt = DTYPES[dtype]
    q, k, v, bt, pos = _paged_fixture(1, b=6, h=4, h_kv=4 // gqa, dh=16,
                                      bs=8, n_blocks=128, mb=4, max_pos=31)
    want = jax_paged_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(bt), jnp.asarray(pos), impl="xla")
    got = D.paged_decode_attention(
        _t(q, tdt), _t(k, tdt), _t(v, tdt), torch.from_numpy(bt),
        torch.from_numpy(pos), impl="xla")
    assert_parity(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("gqa", [1, 2])
@pytest.mark.parametrize("pos", [0, 7, 31])
def test_contiguous_plain_matches_jax_kernel(dtype, gqa, pos):
    """The contiguous kernel's plain version against the Pallas fused
    decode kernel (``decode_attention(impl="fused")`` with a scalar cursor
    and one query token)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.Generator(np.random.PCG64(pos + 10 * gqa))
    b, h, dh, s = 3, 4, 16, 32
    q = rng.standard_normal((b, 1, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, h // gqa, s, dh)).astype(np.float32)
    v = rng.standard_normal((b, h // gqa, s, dh)).astype(np.float32)
    mask = (np.arange(s) <= pos)[None, None, None, :]
    want = jax_decode_attention(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                jnp.asarray(v, jdt), jnp.asarray(mask),
                                jnp.int32(pos), impl="fused")
    got = D.decode_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt),
                             torch.from_numpy(mask), pos, impl="fused")
    assert_parity(got, want)
    oracle = D.decode_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt),
                                torch.from_numpy(mask), pos, impl="xla")
    assert_parity(oracle, jax_decode_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(mask), jnp.int32(pos), impl="xla"))


def test_wrappers_take_plain_path_on_cpu_without_counting():
    """On CPU tensors the wrappers run the plain versions and leave the
    launch counters alone (they count kernel launches only)."""
    D.reset_launch_counts()
    q, k, v, bt, pos = _paged_fixture(2, b=2, h=4, h_kv=4, dh=8, bs=8,
                                      n_blocks=16, mb=2, max_pos=15)
    out = D.paged_fused_attention(_t(q, torch.float32), _t(k, torch.float32),
                                  _t(v, torch.float32), torch.from_numpy(bt),
                                  torch.from_numpy(pos))
    kc = torch.randn(2, 4, 16, 8)
    out2 = D.fused_decode_attention(_t(q, torch.float32), kc, kc, 5)
    assert out.shape == (2, 1, 4, 8) and out2.shape == (2, 1, 4, 8)
    assert D.launch_counts == {"fused_decode_attention": 0,
                               "paged_decode_attention": 0}
    with pytest.raises(ValueError, match="CUDA"):
        D.paged_fused_attention_cuda(_t(q, torch.float32), _t(k, torch.float32),
                                     _t(v, torch.float32), torch.from_numpy(bt),
                                     torch.from_numpy(pos))


# ---------------------------------------------------------------------------
# the CUDA kernels' arithmetic (tests/torch_decode_model.py) against the
# Pallas kernels: in f32 the parity rule; in bf16 lm_kernels_bench's
# element bar (2 ulps + 2^-14 of the max) and at most 1% of the elements
# differing, since a p rounded against another max than the function's
# moves outputs by about one ulp, which only the share of differing
# elements shows


def _hold_model(got, want):
    w = torch.from_numpy(np.array(want.astype(jnp.float32)))
    if want.dtype == jnp.bfloat16:
        w = w.to(torch.bfloat16)
        err, ok = LB.max_err(got, w, elem=True)
        share = float((got.float() != w.float()).float().mean())
        assert ok and share <= 0.01, (err, share)
    else:
        assert_parity(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("gqa", [1, 2])
@pytest.mark.parametrize("pos", [0, 15, 40, 63])
@pytest.mark.parametrize("parts", [1, 3])
def test_contiguous_model_matches_pallas(dtype, gqa, pos, parts):
    """The contiguous kernel's arithmetic (tiles of 16 slots shared by the
    parts of a cluster, the maxes exchanged before any p, column-owning PV
    partials) against the Pallas fused decode kernel, at cursors inside
    the first tile, on a tile edge and across tiles."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.Generator(np.random.PCG64(100 + pos + 7 * gqa))
    b, h, dh, s = 3, 4, 16, 64
    q = rng.standard_normal((b, 1, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, h // gqa, s, dh)).astype(np.float32)
    v = rng.standard_normal((b, h // gqa, s, dh)).astype(np.float32)
    mask = (np.arange(s) <= pos)[None, None, None, :]
    want = jax_decode_attention(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                jnp.asarray(v, jdt), jnp.asarray(mask),
                                jnp.int32(pos), impl="fused")
    got = contiguous_model(_t(q, tdt), _t(k, tdt), _t(v, tdt), pos,
                           parts=parts, tile=16)
    _hold_model(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("gqa", [1, 2])
@pytest.mark.parametrize("s_q", [1, 3])
@pytest.mark.parametrize("parts", [1, 3])
def test_paged_model_matches_pallas(dtype, gqa, s_q, parts):
    """The paged kernel's arithmetic (tiles of two pool blocks; split
    parts seeded with the max of all earlier pool blocks, each holding the
    scores of its whole walk; the rescales folded into the weights)
    against the Pallas paged kernel, cursors at block start, block end,
    mid-block and the table's end."""
    jdt, tdt = DTYPES[dtype]
    h = 4
    q, k, v, bt, pos = _paged_fixture(3, b=6, h=h, h_kv=h // gqa, dh=16,
                                      bs=8, n_blocks=64, mb=8, max_pos=63,
                                      s_q=s_q)
    pos[:5] = [0, 7, 8, 36, 63 - s_q + 1]
    want = jax_paged_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(bt), jnp.asarray(pos), impl="paged")
    got = paged_model(_t(q, tdt), _t(k, tdt), _t(v, tdt),
                      torch.from_numpy(bt), torch.from_numpy(pos),
                      parts=parts, gb=2)
    _hold_model(got, want)


@pytest.mark.parametrize("dh", [20, 64, 80, 256])
def test_dot_kernel_order_is_the_kernels_sum(dh):
    """The plain versions' bf16 scores on the card (``dot_kernel_order``)
    equal, bit for bit, a scalar float32 walk of the kernels' score loop:
    lane l of 8 sums chunks l, l + 8, ... of 8 columns with an fma each
    (exact in float64, then rounded, as a bf16 product is exact), and the
    lanes meet by xor shuffles 4, 2, 1; and they stay within f32 rounding
    of the einsum's sums."""
    rng = np.random.Generator(np.random.PCG64(dh))
    q = _t(rng.standard_normal((3, dh)), torch.bfloat16)
    k = _t(rng.standard_normal((5, dh)), torch.bfloat16)
    got = D.dot_kernel_order(q, k)
    qn, kn = q.double().numpy(), k.double().numpy()
    nc = (dh + 7) // 8
    for r in range(3):
        for t in range(5):
            lanes = []
            for gl in range(8):
                a = np.float32(0.0)
                for c in range(gl, nc, 8):
                    for d in range(c * 8, min(c * 8 + 8, dh)):
                        a = np.float32(np.float64(a) + qn[r, d] * kn[t, d])
                lanes.append(a)
            for o in (4, 2, 1):
                lanes = [np.float32(lanes[i] + lanes[i ^ o]) for i in range(8)]
            assert float(got[r, t]) == float(lanes[0]), (r, t)
    want = torch.einsum("rd,td->rt", q.float(), k.float())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["contiguous", "paged"])
def test_part_local_max_misses_pallas(kind):
    """A split that rounds p against each part's own max (contiguous) or
    starts each part's running max from NEG_INF (paged) and rescales
    afterwards computes another function: in bf16 at cursor 255 with 4
    parts it differs from the Pallas kernel in about 40% of the output
    elements, each by about one ulp, where the exact split (maxes
    exchanged, or seeded with the earlier pool blocks') differs in none."""
    rng = np.random.Generator(np.random.PCG64(0))
    b, h, dh, cursor = 2, 4, 32, 255
    if kind == "contiguous":
        q = rng.standard_normal((b, 1, h, dh)).astype(np.float32)
        k = rng.standard_normal((b, h, cursor + 1, dh)).astype(np.float32)
        v = rng.standard_normal((b, h, cursor + 1, dh)).astype(np.float32)
        mask = (np.arange(cursor + 1) <= cursor)[None, None, None, :]
        want = jax_decode_attention(
            *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
            jnp.asarray(mask), jnp.int32(cursor), impl="fused")
        args = [_t(x, torch.bfloat16) for x in (q, k, v)] + [cursor]
        model = lambda own: contiguous_model(*args, parts=4, tile=16,
                                             own_max=own)
    else:
        q, k, v, bt, pos = _paged_fixture(0, b=b, h=h, h_kv=h, dh=dh, bs=16,
                                          n_blocks=40, mb=16, max_pos=1)
        pos[:] = cursor
        want = jax_paged_attention(
            *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
            jnp.asarray(bt), jnp.asarray(pos), impl="paged")
        args = [_t(x, torch.bfloat16) for x in (q, k, v)] + [
            torch.from_numpy(bt), torch.from_numpy(pos)]
        model = lambda own: paged_model(*args, parts=4, gb=2, own_max=own)
    w = torch.from_numpy(np.array(want.astype(jnp.float32)))
    share = {own: float((model(own).float() != w).float().mean())
             for own in (False, True)}
    assert share[False] <= 0.005, share
    assert share[True] >= 0.2, share


# ---------------------------------------------------------------------------
# cached_kv writes, against the JAX cache contents


def _models(seed=5):
    jm = JGPT2(**GEOM)
    params = jm.init(jax.random.key(seed), np.zeros((1, 8), np.int32),
                     train=False)["params"]
    params = jax.tree_util.tree_map(np.asarray, meta.unbox(params))
    pm = GPT2(**GEOM, device="cpu")
    pm.load_state_dict(gpt2_params_from_flax(params))
    return jm, params, pm


def _assert_cache_equal(jcache, pcache, atol=2e-5):
    for i, layer in enumerate(pcache["layers"]):
        jl = jcache[f"h_{i}"]
        np.testing.assert_allclose(layer["k"].numpy(),
                                   np.asarray(jl["cached_key"]), atol=atol)
        np.testing.assert_allclose(layer["v"].numpy(),
                                   np.asarray(jl["cached_value"]), atol=atol)


def test_cached_kv_scalar_mode_matches_jax():
    jm, params, pm = _models()
    toks = np.random.Generator(np.random.PCG64(0)).integers(
        0, 64, (2, 9)).astype(np.int32)
    jcache, pcache = jax_zero_cache(jm, 2), zero_cache(pm, 2)
    for chunk in (toks[:, :6], toks[:, 6:7], toks[:, 7:9]):
        _, upd = jm.apply({"params": params, "cache": jcache},
                          jnp.asarray(chunk), train=False, decode=True,
                          mutable=["cache"])
        jcache = upd["cache"]
        pm(torch.from_numpy(chunk).long(), cache=pcache)
    _assert_cache_equal(jcache, pcache)
    assert int(jcache["h_0"]["cache_index"]) == pcache["layers"][0]["index"] == 9


def test_cached_kv_per_row_mode_matches_jax():
    """Per-row writes, including a chunk whose tail runs past max_len on
    one row (those entries write nothing)."""
    jm, params, pm = _models(6)
    jcache, pcache = jax_zero_cache(jm, 3), zero_cache(pm, 3)
    pos = np.array([0, 17, 62], np.int32)
    toks = np.random.Generator(np.random.PCG64(1)).integers(
        0, 64, (3, 2)).astype(np.int32)
    _, upd = jm.apply({"params": params, "cache": jcache}, jnp.asarray(toks),
                      train=False, decode=True, positions=jnp.asarray(pos),
                      mutable=["cache"])
    pm(torch.from_numpy(toks).long(), cache=pcache,
       positions=torch.from_numpy(pos))
    _assert_cache_equal(upd["cache"], pcache)


def test_cached_kv_paged_mode_matches_jax():
    """Paged writes land at (table[p // bs], p % bs); inactive rows (zero
    table, position 0) land in the garbage block 0, and a verify tail past
    the table's extent writes nothing. The reference writes that tail (NaN
    past GPT-2's position table) into block 0 too, where row 0, which maps
    only two blocks, reads it as masked slots: ``0 * NaN`` makes its later
    layers NaN. The port's row 0 is the reference's without row 2."""
    jm, params, pm = _models(7)
    n_blocks, bs = 12, 8
    jpool = jax_paged_cache(jm, n_blocks, bs)
    ppool = paged_cache(pm, n_blocks, bs)
    tables = np.array([[3, 5, 0, 0, 0, 0, 0, 0],
                       [0, 0, 0, 0, 0, 0, 0, 0],
                       [1, 2, 4, 6, 7, 8, 9, 10]], np.int32)
    pos = np.array([7, 0, 61], np.int32)
    toks = np.random.Generator(np.random.PCG64(2)).integers(
        0, 64, (3, 4)).astype(np.int32)
    _, upd = jm.apply({"params": params, "cache": jpool}, jnp.asarray(toks),
                      train=False, decode=True, positions=jnp.asarray(pos),
                      block_tables=jnp.asarray(tables), mutable=["cache"])
    pm(torch.from_numpy(toks).long(), cache=ppool,
       positions=torch.from_numpy(pos), block_tables=torch.from_numpy(tables))
    # the reference on rows 0-1 alone: no tail past the table's extent
    _, alone = jm.apply({"params": params,
                         "cache": jax_paged_cache(jm, n_blocks, bs)},
                        jnp.asarray(toks[:2]), train=False, decode=True,
                        positions=jnp.asarray(pos[:2]),
                        block_tables=jnp.asarray(tables[:2]),
                        mutable=["cache"])
    # block 0 takes several racing garbage writes (order unspecified):
    # compare every other block exactly; past layer 0 the three-row
    # reference's row 0 (blocks 3 and 5) is NaN, so row 0 is held to the
    # reference run on rows 0-1 alone
    row0 = [3, 5]
    for i, layer in enumerate(ppool["layers"]):
        jl = upd["cache"][f"h_{i}"]
        for name, jname in (("k", "cached_key"), ("v", "cached_value")):
            got, want = layer[name].numpy(), np.asarray(jl[jname])
            blocks = list(range(1, n_blocks)) if i == 0 else list(tables[2])
            np.testing.assert_allclose(got[blocks], want[blocks], atol=2e-5)
            if i:
                assert np.isnan(want[row0]).any()
            np.testing.assert_allclose(
                got[row0], np.asarray(alone["cache"][f"h_{i}"][jname])[row0],
                atol=2e-5)
            assert np.isfinite(got[1:]).all()
    # row 0's entries 7..10 straddle blocks 3 and 5
    assert float(ppool["layers"][0]["k"][5, :, :3].abs().sum()) > 0
