"""The serving CLIs of the port on the CPU: ``python -m tpudist_torch.main
--serve`` (the reference's ``main.py --serve`` demo: a byte-vocabulary
GPT-2, 128 wide and 2 deep, alternately greedy and sampled requests) and
``python -m tpudist_torch.serve`` (``examples/serve_gpt2.py``), with and
without ``--spec_draft``: every request served, the ``serve`` rows of
``{log_dir}/{JobID}_serve_0.jsonl`` carrying the speculative fields, the
summary lines printed; ``--init_hf`` serving a saved checkpoint's greedy
streams; and the flags that stay refused, naming their ROADMAP items.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tpudist_torch import interop
from tpudist_torch.generate import generate
from tpudist_torch.main import main
from tpudist_torch.models.gpt2 import GPT2
from tpudist_torch.serve.__main__ import main as serve_main

REPO = Path(__file__).resolve().parent.parent
SPEC_FIELDS = {"spec_drafted", "spec_accepted", "spec_acceptance_rate"}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    yield
    torch.set_num_threads(threads)


def _rows(path):
    return [json.loads(line) for line in open(path)]


@pytest.mark.parametrize("spec", [[], ["--spec_draft", "1"]],
                         ids=["plain", "spec"])
def test_main_serve_demo(spec, tmp_path, capsys):
    snap = main(["--serve", "--device", "cpu", "--log_dir", str(tmp_path),
                 "--JobID", "Demo", *spec])
    out = capsys.readouterr().out
    assert snap["completed"] == 8
    assert out.count("tokens (done)") == 8
    assert "served 8 requests" in out
    assert ("speculative: " in out) == bool(spec)
    rows = _rows(tmp_path / "Demo_serve_0.jsonl")
    serve = [r for r in rows if r["kind"] == "serve"]
    assert serve and all(SPEC_FIELDS <= set(r) for r in serve)
    summary = [r for r in rows if r["kind"] == "serve_summary"][-1]
    assert summary["completed"] == 8
    if spec:
        assert summary["spec_drafted"] >= summary["spec_accepted"]
        assert summary["spec_drafted"] > 0
    else:
        assert summary["spec_drafted"] == 0


def test_main_serve_from_the_command_line(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
    proc = subprocess.run(
        [sys.executable, "-m", "tpudist_torch.main", "--serve", "--device",
         "cpu", "--spec_draft", "1", "--spec_k", "3", "--serve_requests", "3",
         "--log_dir", str(tmp_path)], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "served 3 requests" in proc.stdout
    assert "speculative: " in proc.stdout


def test_serve_cli_with_a_draft(tmp_path, capsys):
    snap = serve_main(["--device", "cpu", "--spec_draft", "1", "--requests",
                       "3", "--max_new", "6", "--paged", "--block_size", "8",
                       "--log_dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert snap["completed"] == 3 and snap["tokens"] == 18
    assert "speculative: " in out and "drafts accepted" in out
    rows = _rows(tmp_path / "Serve_serve_0.jsonl")
    assert all(SPEC_FIELDS <= set(r) for r in rows
               if r["kind"] in ("serve", "serve_summary"))
    assert rows[-1]["kind"] == "serve_summary"
    assert rows[-1]["spec_drafted"] > 0


def test_serve_cli_init_hf_serves_the_checkpoint(tmp_path, capsys):
    model = GPT2(vocab_size=64, max_seq_len=64, hidden_dim=32, depth=2,
                 num_heads=4, device="cpu", seed=3)
    interop.save_hf_checkpoint(model.state_dict(), tmp_path / "hf",
                               arch="gpt2", depth=2)
    prompts = [[5, 9, 2, 7], [1, 2, 3, 4]]
    serve_main(["--device", "cpu", "--init_hf", str(tmp_path / "hf"),
                "--vocab_size", "64", "--seq_len", "64", "--hidden_dim", "32",
                "--depth", "2", "--num_heads", "4", "--max_new", "6",
                "--spec_draft", "1", "--log_dir", str(tmp_path),
                *[a for p in prompts for a in ("--prompt", ",".join(map(str, p)))]])
    out = capsys.readouterr().out
    want = generate(model, np.asarray(prompts, np.int32), 6, temperature=0.0)
    for i, row in enumerate(want):
        assert f"request {i}: 6 tokens -> {list(map(int, row))}" in out


@pytest.mark.parametrize("flag,item", [
    (["--serve_experts", "2"], "Queue 1 #7"),
    (["--tensor", "2"], "Queue 1 #7"),
    (["--serve_moe_dispatch", "index"], "Queue 1 #7"),
    (["--trace"], "Queue 1 #8"),
    (["--metrics_port", "0"], "Queue 1 #8"),
], ids=lambda f: " ".join(f) if isinstance(f, list) else f)
def test_serve_flags_still_refused(flag, item, tmp_path):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        main(["--serve", "--device", "cpu", "--log_dir", str(tmp_path), *flag])


def test_without_a_card_the_demo_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        main(["--serve", "--log_dir", str(tmp_path)])
