"""scikit-learn's digits through the port (``tpudist_torch.data.digits``)
against ``tpudist.data.digits``: the same arrays and split bit for bit,
``main --dataset digits`` for one epoch on the CPU, and the ImportError
that names the package where scikit-learn is missing."""

import builtins
import re

import numpy as np
import pytest

from tpudist.data.digits import load_digits_dataset as jax_load_digits
from tpudist_torch.data.digits import load_digits_dataset
from torch_threads import two_torch_threads  # noqa: F401


@pytest.mark.parametrize("train", [True, False], ids=["train", "val"])
@pytest.mark.parametrize("kw", [{}, {"upscale": 1, "rgb": False}],
                         ids=["32x32-rgb", "8x8-gray"])
def test_arrays_and_split_equal_the_references(train, kw):
    ours, ref = load_digits_dataset(train, **kw), jax_load_digits(train, **kw)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k])


def test_split_is_disjoint_and_whole():
    tr, va = load_digits_dataset(True), load_digits_dataset(False)
    assert len(tr["label"]) + len(va["label"]) == 1797
    assert tr["image"].shape[1:] == (32, 32, 3)


def test_missing_scikit_learn_names_the_package(monkeypatch):
    real = builtins.__import__

    def no_sklearn(name, *args, **kwargs):
        if name.startswith("sklearn"):
            raise ImportError("No module named 'sklearn'")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_sklearn)
    with pytest.raises(ImportError, match="scikit-learn"):
        load_digits_dataset()


def test_main_trains_an_epoch_on_digits(tmp_path, capsys):
    from tpudist_torch.main import main

    state, losses = main(["--device", "cpu", "--model", "resnet18",
                          "--dataset", "digits", "--batch_size", "256",
                          "--epochs", "1", "--no_profiler", "--eval",
                          "--JobID", "D", "--log_dir", str(tmp_path)])
    assert len(losses) == 1437 // 256 and np.isfinite(losses).all()
    assert re.search(r"Accuracy: \d\.\d{4}", capsys.readouterr().out)
    assert (tmp_path / "D_256_0.log").exists()
