"""The port stands alone: no module of tpudist_torch, nor chip_smoke.py
or tools/torch_world_run.py, imports jax, flax or anything of the tpudist
package (checked on the source by an AST walk, and on a fresh interpreter
by importing the whole port and looking at sys.modules). And its entry
points run on the card by default: without CUDA they raise unless the
caller asks for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "tpudist_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "tpudist")


def _sources():
    files = sorted(PORT.rglob("*.py"))
    assert files, "tpudist_torch has no python sources"
    return files + [REPO / "chip_smoke.py",
                    REPO / "tools" / "torch_world_run.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(name: str) -> bool:
    root = name.split(".")[0]
    return root in FORBIDDEN


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_reference_imports_in_source(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_forbidden_rule_tells_packages_apart():
    assert _forbidden("tpudist.ops.decode") and _forbidden("jax.numpy")
    assert not _forbidden("tpudist_torch.ops.decode")


def test_importing_the_port_loads_no_reference_module():
    code = (
        "import importlib, pkgutil, sys, tpudist_torch\n"
        "for m in pkgutil.walk_packages(tpudist_torch.__path__, 'tpudist_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "assert 'tpudist_torch.serve.engine' in sys.modules\n"
        "assert 'tpudist_torch.train' in sys.modules\n"
        "assert 'tpudist_torch.main' in sys.modules\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'tpudist'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(no_cuda):
    from tpudist_torch import resolve_device
    from tpudist_torch.distributed import init_from_env
    from tpudist_torch.main import main as train_main
    from tpudist_torch.models.gpt2 import GPT2
    from tpudist_torch.models.resnet import resnet18, resnet50
    from tpudist_torch.serve.__main__ import main

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPT2(vocab_size=16, max_seq_len=16, hidden_dim=8, depth=1, num_heads=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--requests", "1"])
    for ctor in (resnet18, resnet50):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ctor(num_filters=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_from_env()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main(["--model", "resnet18", "--dataset", "synthetic"])
    assert resolve_device("cpu") == torch.device("cpu")


def test_world_run_tool_refuses_without_cuda(no_cuda):
    """The multi-card timing tool measures the card only: without one it
    exits before it runs a CLI."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_world_run", REPO / "tools" / "torch_world_run.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tool.main(["gpt2", "G4", "--fsdp", "4"])


def test_cpu_entry_points_run_when_asked(no_cuda, tmp_path):
    """``device="cpu"`` runs the whole path on the plain versions."""
    from tpudist_torch.generate import generate
    from tpudist_torch.models.gpt2 import GPT2
    from tpudist_torch.serve import ServeEngine
    from tpudist_torch.serve.__main__ import main

    model = GPT2(vocab_size=16, max_seq_len=16, hidden_dim=8, depth=1,
                 num_heads=2, attn_impl="fused", device="cpu")
    assert generate(model, [[1, 2, 3]], 4, temperature=0.0).shape == (1, 4)
    eng = ServeEngine(model, max_slots=2, paged=True, block_size=4)
    rid = eng.submit([1, 2, 3], 4)
    assert len(eng.run()[rid]) == 4
    snap = main(["--device", "cpu", "--requests", "2", "--max_new", "3",
                 "--seq_len", "128", "--paged", "--block_size", "8",
                 "--log_dir", str(tmp_path)])
    assert snap["completed"] == 2 and snap["tokens"] == 6


def test_cpu_training_runs_when_asked(no_cuda, tmp_path):
    """``--device cpu`` trains through the plain versions of the
    kernels; the fused-AdamW kernel is never launched."""
    from tpudist_torch.main import main
    from tpudist_torch.models.resnet import resnet18
    from tpudist_torch.ops import fused_update

    model = resnet18(num_filters=8, device="cpu")
    assert model(torch.zeros(2, 32, 32, 3)).shape == (2, 1000)
    fused_update.reset_launch_counts()
    _, losses = main(["--device", "cpu", "--model", "resnet18", "--dataset",
                      "synthetic", "--synthetic_size", "8", "--batch_size",
                      "8", "--epochs", "1", "--fused", "optimizer",
                      "--no_profiler", "--log_dir", str(tmp_path)])
    assert len(losses) == 1
    assert fused_update.launch_counts["fused_adamw"] == 0
