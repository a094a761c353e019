"""The port's ViT (tpudist_torch.models.vit) and its training path against
the flax reference (tpudist.models.vit) on the same weights and inputs,
at tests/test_vit.py's tiny size (patch 8 on 32x32 images, width 32,
depth 2, 4 heads, MLP 64): logits and every gradient with the fused
LayerNorm off and on and the dense and vmem attention, the bf16 policy,
the patch count, the weight-decay mask leaf for leaf, three Adam steps of
the port's ``fit`` against the reference's ``make_train_step``, and
``grad_accum`` 1 against 2; then ``python -m tpudist_torch.main --model
vit_b16`` at full width on the CPU.

Tolerances. Logits and gradients: the repo's float32 kernel-parity rule
(2e-5 absolute plus relative; measured within 1.5e-6), the Pallas
kernels interpreted on the reference's side. Trainer: losses within 1e-5
relative, parameters within 1e-4 relative plus 1e-4 absolute after
three Adam steps of lr 1e-3 (a tenth of one step; Adam moves a
coordinate whose gradient is within rounding of zero by a fraction of lr
either way), the key slice of the qkv bias held to the step bound
instead (its gradient is zero in exact arithmetic: tests/
test_torch_gpt2_train.py). grad_accum 1 against 2: the losses within
1e-5 relative, as tests/test_vit.py holds the reference."""

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
from flax.core import meta

from tpudist import mesh as mesh_lib
from tpudist.data.cifar import synthetic_cifar as jax_synthetic_cifar
from tpudist.data.cifar import to_tensor as jax_to_tensor
from tpudist.models import vit_b16 as jax_vit_b16
from tpudist.optim import decay_mask as jax_decay_mask
from tpudist.train import create_train_state as jax_create_train_state
from tpudist.train import make_train_step as jax_make_train_step
from tpudist_torch.data.cifar import synthetic_cifar, to_tensor
from tpudist_torch.data.loader import DataLoader
from tpudist_torch.interop import vit_params_from_flax
from tpudist_torch.models.vit import vit_b16
from tpudist_torch.optim import decay_mask, make_optimizer
from tpudist_torch.train import (
    create_train_state, cross_entropy_loss, fit, make_train_step)

REPO = Path(__file__).resolve().parent.parent
TINY = dict(num_classes=10, patch_size=8, hidden_dim=32, depth=2,
            num_heads=4, mlp_dim=64)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    # pytest-xdist runs several workers on one host (tests/test_torch_train.py)
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _tiny_vit(**kw):
    return jax_vit_b16(**TINY, **kw)


def _port(**kw):
    return vit_b16(**TINY, image_size=32, device="cpu", **kw)


def _flax_params(model, seed=0):
    params = model.init(jax.random.key(seed), jnp.zeros((1, 32, 32, 3)),
                        train=False)["params"]
    params = jax.tree_util.tree_map(np.asarray, meta.unbox(params))
    # LayerNorm scales and offsets, cls and biases off their trivial init,
    # so every parameter's gradient path is exercised
    r = np.random.Generator(np.random.PCG64(seed + 1))
    return jax.tree_util.tree_map(
        lambda a: (a + 0.05 * r.standard_normal(a.shape)).astype(np.float32),
        params)


def _inputs(n=4, seed=0):
    r = np.random.Generator(np.random.PCG64(seed))
    return (r.random((n, 32, 32, 3), dtype=np.float32),
            r.integers(0, 10, n).astype(np.int32))


@pytest.mark.parametrize("attn", ["xla", "vmem"])
@pytest.mark.parametrize("fused_ln", [False, True])
def test_logits_and_gradients_match_the_reference(fused_ln, attn,
                                                  kernel_parity):
    x, y = _inputs()
    jm = _tiny_vit(fused_ln=fused_ln, attn_impl=attn)
    params = _flax_params(jm)

    def loss(p):
        logits = jm.apply({"params": p}, x, train=False)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
        return ce, logits

    (_, want_logits), grads = jax.value_and_grad(loss, has_aux=True)(params)
    model = _port(attn_impl=attn)
    model.fused_ln = fused_ln
    model.load_state_dict(vit_params_from_flax(params))
    logits = model(torch.from_numpy(x))
    cross_entropy_loss(logits, torch.from_numpy(y)).backward()
    kernel_parity(logits.detach().numpy(), np.asarray(want_logits))
    want = vit_params_from_flax(jax.tree_util.tree_map(np.asarray, grads))
    got = {k: p.grad for k, p in model.named_parameters()}
    assert got.keys() == want.keys() and len(got) == 4 + 12 * 2 + 4
    for k, w in want.items():
        kernel_parity(got[k].numpy(), w.numpy())


def test_bf16_policy_keeps_f32_params_and_logits():
    model = _port(dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    logits = model(torch.zeros(2, 32, 32, 3))
    assert logits.dtype == torch.float32 and logits.shape == (2, 10)
    assert model.flops_counter is None
    assert vit_b16(device="cpu", depth=1).flops_counter == "vit"


def test_patch_count_and_pos_shape():
    model = _port()
    # 32/8 = 4x4 patches + cls, as the reference's
    assert model.pos_embedding.shape == (1, 17, 32)
    params = _flax_params(_tiny_vit())
    assert params["pos_embedding"].shape == tuple(model.pos_embedding.shape)
    assert model(torch.zeros(3, 32, 32, 3)).shape == (3, 10)
    with pytest.raises(ValueError, match="tokens"):
        model(torch.zeros(1, 40, 40, 3))


def test_main_builds_vit_b16_at_65_tokens():
    model = vit_b16(patch_size=4, image_size=32, device="cpu")
    assert model.pos_embedding.shape == (1, 65, 768)
    assert len(list(model.parameters())) == 152
    assert model.blocks[0].qkv.bias.shape == (3, 12, 64)


def test_unported_knobs_raise():
    # dropout is ported: in train mode it needs the step's key, as the
    # reference needs a 'dropout' rng
    with pytest.raises(ValueError, match="needs a dropout_key"):
        _port(dropout=0.1).train()(torch.zeros(1, 32, 32, 3))
    with pytest.raises(NotImplementedError, match="Queue 1 #7"):
        _port(mesh=object())


def test_decay_mask_matches_the_references_leaf_for_leaf():
    params = _flax_params(_tiny_vit())
    ref = jax.tree_util.tree_map(
        lambda p, m: np.full(np.shape(p), float(m), np.float32), params,
        jax_decay_mask(params))
    want = {k: bool(t.reshape(-1)[0]) for k, t in
            vit_params_from_flax(ref).items()}
    got = decay_mask(dict(_port().named_parameters()))
    assert got == want
    # the qkv bias keeps its [3, H, dh] shape, so it is decayed as the
    # reference's is; the other biases and the LayerNorms are not
    assert got["blocks.0.qkv.bias"] and not got["blocks.0.out.bias"]
    assert got["cls"] and got["pos_embedding"] and got["embedding.weight"]


def _batches(n, rows, seed=3):
    data = jax_to_tensor(jax_synthetic_cifar(n * rows, num_classes=10,
                                             seed=seed))
    return [{k: v[i * rows:(i + 1) * rows] for k, v in data.items()}
            for i in range(n)]


@pytest.mark.parametrize("fused", [None, "ln", "all"])
def test_three_fit_steps_match_the_reference(fused, tmp_path):
    steps, rows = 3, 8
    mesh = mesh_lib.create_mesh(devices=jax.devices()[:1])
    jm = _tiny_vit()
    opt_kw = dict(weight_decay=0.1, fused=fused == "all")
    from tpudist.optim import make_optimizer as jax_make_optimizer

    jtx = jax_make_optimizer(1e-3, **opt_kw)
    jstate = jax_create_train_state(jm, 0, jnp.zeros((1, 32, 32, 3)), jtx,
                                    mesh)
    init = vit_params_from_flax(
        jax.tree_util.tree_map(np.asarray, meta.unbox(jstate.params)))
    jstep = jax_make_train_step(jm, jtx, mesh, fused=fused)
    want_losses = []
    for b in _batches(steps, rows):
        jstate, metrics = jstep(jstate, b)
        want_losses.append(float(metrics["loss"]))

    model = _port()
    model.load_state_dict(init)
    loader = DataLoader(synthetic_cifar(steps * rows, num_classes=10, seed=3),
                        rows, transform=to_tensor)
    state, losses = fit(model, make_optimizer(1e-3, **opt_kw), loader,
                        epochs=1, fused=fused, profile=False,
                        log_dir=str(tmp_path))
    assert state.step == steps
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    want = vit_params_from_flax(
        jax.tree_util.tree_map(np.asarray, meta.unbox(jstate.params)))
    got = state.params()
    assert got.keys() == want.keys()
    for k, w in want.items():
        g, w = got[k].numpy(), w.numpy()
        if k.endswith("qkv.bias"):
            start = init[k].numpy()[1]
            for side in (g[1], w[1]):
                assert np.abs(side - start).max() <= 1.5 * steps * 1e-3, k
            g, w = g[[0, 2]], w[[0, 2]]
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=k)


def test_grad_accum_matches_flat_batch():
    batch = {k: torch.from_numpy(np.array(v))
             for k, v in to_tensor(synthetic_cifar(16, num_classes=10)).items()}
    losses = {}
    for accum in (1, 2):
        model = _port(seed=1)
        tx = make_optimizer(1e-3)
        state = create_train_state(model, tx)
        step = make_train_step(model, tx, grad_accum=accum)
        state, metrics = step(state, batch)
        losses[accum] = float(metrics["loss"])
    np.testing.assert_allclose(losses[1], losses[2], rtol=1e-5)


def test_cli_trains_vit_b16_with_amp_and_grad_accum(tmp_path):
    """The full-width model through the CLI on the CPU, bf16 with the
    guard, the fused kernels' plain versions and two microbatches."""
    proc = subprocess.run(
        [sys.executable, "-m", "tpudist_torch.main", "--device", "cpu",
         "--model", "vit_b16", "--dataset", "synthetic", "--synthetic_size",
         "8", "--batch_size", "4", "--epochs", "1", "--bf16", "--fused",
         "all", "--amp", "--grad_accum", "2", "--no_profiler", "--log_dir",
         str(tmp_path)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "Epoch: 0 step: 0 loss:" in proc.stdout
    assert "amp: skipped" not in proc.stdout
    rows = (tmp_path / "Job0_4_0.log").read_text().splitlines()
    assert rows[0] == "datetime\tg_step\tg_img\tloss_value\texamples_per_sec"
    assert rows[-1].startswith("TrainTime\t") and len(rows) == 2
