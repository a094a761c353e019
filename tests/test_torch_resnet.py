"""The port's ResNet (tpudist_torch.models.resnet) against the flax
reference (tpudist.models.resnet) on the same weights and the same
32x32 inputs: the weight bridge, SAME padding on its own, the
space-to-depth stem, and eval logits, train-mode logits, the updated BN
statistics and the gradients of ResNet-18 and ResNet-50 (num_filters=8,
full depth).

Tolerances, and why:

- **float64** (both frameworks in float64; the head is float32 in both,
  as flax's ``Dense(dtype=float32)`` is): eval and train logits and the
  BN statistics within 2e-5, gradients within 1e-4, each relative to the
  quantity's largest magnitude. This is the check of the FUNCTION (SAME
  padding, biased batch variance, momentum, cross-replica sums): the
  float32 head bounds the agreement at float32 precision.
- **float32**: eval logits within 2e-5 (the repo's kernel-parity bar).
  Train-mode BN in float32 is ill-conditioned in the reference itself:
  flax takes ``var = E[x^2] - E[x]^2`` with XLA's float32 reductions, and
  on ResNet-50 its train-mode logits sit 3.6e-3 and its gradients 39%
  (relative) from the float64 value. So the float32 train-mode check is
  that the port's logits are no farther from the float64 reference than
  the float32 reference's are (ROADMAP Queue 3 records this).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from tpudist.models import resnet as jres
from tpudist_torch.interop import resnet_params_from_flax
from tpudist_torch.models import resnet as tres
from tpudist_torch.train import cross_entropy_loss
from torch_threads import two_torch_threads  # noqa: F401

BATCH = 8


def _inputs(seed=0):
    r = np.random.Generator(np.random.PCG64(seed))
    x = r.random((BATCH, 32, 32, 3), dtype=np.float32)
    y = r.integers(0, 1000, BATCH).astype(np.int32)
    return x, y


def _flax_vars(name, seed=0, **kw):
    model = getattr(jres, name)(num_filters=8, **kw)
    v = jax.jit(lambda key: model.init(key, jnp.zeros((1, 32, 32, 3)),
                                       train=False))(jax.random.key(seed))
    return jax.tree_util.tree_map(np.asarray, v)


def _port(name, v, dtype=torch.float32, **kw):
    model = getattr(tres, name)(num_filters=8, dtype=dtype, device="cpu", **kw)
    model.load_state_dict(resnet_params_from_flax(v["params"], v["batch_stats"]))
    return model.to(dtype)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_params_from_flax_round_trip(name):
    """Every flax leaf lands in the port's state dict under its name and
    reshapes back to itself exactly."""
    v = _flax_vars(name)
    sd = {k: t.numpy() for k, t in _port(name, v).state_dict().items()}
    flat = jax.tree_util.tree_flatten_with_path(
        {"params": v["params"], "batch_stats": v["batch_stats"]})[0]
    assert len(sd) == len(flat)
    for path, leaf in flat:
        keys = [p.key for p in path]
        top, leafname = keys[1], keys[-1]
        if top.startswith(("ResNetBlock_", "BottleneckBlock_")):
            inner = keys[2].replace("Conv_", "conv").replace("BatchNorm_", "bn")
            prefix = f"blocks.{int(top.rsplit('_', 1)[1])}.{inner}"
        else:
            prefix = {"Dense_0": "head"}.get(top, top)
        if leafname == "kernel" and leaf.ndim == 4:
            np.testing.assert_array_equal(
                sd[f"{prefix}.weight"].transpose(2, 3, 1, 0), leaf)
        elif leafname == "kernel":
            np.testing.assert_array_equal(sd[f"{prefix}.weight"].T, leaf)
        else:
            np.testing.assert_array_equal(sd[f"{prefix}.{leafname}"], leaf)


def _jax_train(name, v, x, y, dtype):
    model = getattr(jres, name)(num_filters=8, dtype=dtype)
    cast = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), t)
    params, stats = cast(v["params"]), cast(v["batch_stats"])

    def loss(p):
        logits, upd = model.apply({"params": p, "batch_stats": stats}, x,
                                  train=True, mutable=["batch_stats"])
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
        return ce, (logits, upd["batch_stats"])

    (_, (train_logits, new_stats)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(params)
    eval_logits = model.apply({"params": params, "batch_stats": stats}, x,
                              train=False)
    as64 = lambda t: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), t)
    # the grads mapped through the bridge, stats mapped the same way
    mapped = resnet_params_from_flax(as64(grads), as64(new_stats))
    return np.asarray(eval_logits), np.asarray(train_logits), mapped


def _port_train(model, x, y):
    model.eval()
    eval_logits = model(x).detach().numpy()
    model.train()
    logits = model(x)
    cross_entropy_loss(logits, y).backward()
    grads = {k: p.grad.numpy() for k, p in model.named_parameters()}
    stats = {k: b.numpy() for k, b in model.named_buffers()}
    return eval_logits, logits.detach().numpy(), grads, stats


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_matches_reference_in_float64(name):
    v = _flax_vars(name)
    x, y = _inputs()
    with jax.enable_x64(True):
        j_eval, j_train, j_mapped = _jax_train(name, v, x.astype(np.float64),
                                               y, jnp.float64)
    model = _port(name, v, torch.float64)
    t_eval, t_train, t_grads, t_stats = _port_train(
        model, torch.from_numpy(x.astype(np.float64)), torch.from_numpy(y))
    assert _rel(t_eval, j_eval) < 2e-5
    assert _rel(t_train, j_train) < 2e-5
    assert t_stats.keys() <= j_mapped.keys()
    for k, s in t_stats.items():
        assert _rel(s, j_mapped[k]) < 2e-5, k
    assert len(t_grads) == len(jax.tree_util.tree_leaves(v["params"]))
    for k, g in t_grads.items():
        assert _rel(g, j_mapped[k]) < 1e-4, k


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_float32_against_reference(name, kernel_parity):
    v = _flax_vars(name)
    x, y = _inputs(1)
    jm = getattr(jres, name)(num_filters=8)

    @jax.jit
    def forward(x):
        ev = jm.apply(v, x, train=False)
        tr, _ = jm.apply(v, x, train=True, mutable=["batch_stats"])
        return ev, tr

    j_eval, j_train = (np.asarray(a) for a in forward(x))
    with jax.enable_x64(True):
        j64 = getattr(jres, name)(num_filters=8, dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)
        j_train64 = np.asarray(jax.jit(lambda x: j64.apply(
            v64, x, train=True, mutable=["batch_stats"])[0])(
                x.astype(np.float64)))
    model = _port(name, v)
    model.eval()
    t_eval = model(torch.from_numpy(x)).detach().numpy()
    model.train()
    t_train = model(torch.from_numpy(x)).detach().numpy()
    kernel_parity(t_eval, j_eval)
    # train mode: no farther from the exact function than the reference
    ref_err = np.abs(j_train - j_train64).max()
    assert np.abs(t_train - j_train64).max() <= max(ref_err, 2e-5)


@pytest.mark.parametrize("n", [8, 9])
@pytest.mark.parametrize("k,s", [(3, 2), (7, 2), (3, 1), (1, 2)])
def test_same_padding_conv(n, k, s):
    r = np.random.Generator(np.random.PCG64(n * 10 + k))
    x = r.standard_normal((2, n, n, 4)).astype(np.float32)
    conv = nn.Conv(6, (k, k), (s, s), use_bias=False, padding="SAME")
    v = conv.init(jax.random.key(0), x)
    want = np.asarray(conv.apply(v, x))
    tconv = tres.Conv(4, 6, k, s, dtype=torch.float32,
                      gen=torch.Generator().manual_seed(0))
    with torch.no_grad():
        tconv.weight.copy_(torch.from_numpy(np.ascontiguousarray(
            np.transpose(np.asarray(v["params"]["kernel"]), (3, 2, 0, 1)))))
    got = tconv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("n", [8, 9, 16, 17])
def test_same_padding_max_pool(n):
    x = np.random.Generator(np.random.PCG64(n)).standard_normal(
        (2, n, n, 3)).astype(np.float32)
    want = np.asarray(nn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME"))
    got = tres.max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_same_pads_are_flax_asymmetric():
    assert tres.same_pads(32, 7, 2) == (2, 3)   # the 7x7/s2 stem
    assert tres.same_pads(16, 3, 2) == (0, 1)   # a 3x3/s2 conv, the max-pool
    assert tres.same_pads(15, 3, 2) == (1, 1)
    assert tres.same_pads(16, 3, 1) == (1, 1)


def test_space_to_depth_stem(kernel_parity):
    v = _flax_vars("resnet18", stem="space_to_depth")
    assert "conv_init_s2d" in v["params"]
    x, _ = _inputs(2)
    want = np.asarray(jres.resnet18(num_filters=8, stem="space_to_depth")
                      .apply(v, x, train=False))
    model = _port("resnet18", v, stem="space_to_depth")
    model.eval()
    kernel_parity(model(torch.from_numpy(x)).detach().numpy(), want)
    with pytest.raises(ValueError, match="even H/W"):
        model(torch.zeros(1, 31, 31, 3))
