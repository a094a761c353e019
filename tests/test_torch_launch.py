"""The port's launcher (``python -m tpudist_torch.launch``), driven with
tiny child scripts so each test costs a few interpreter starts:

- the env/argv contract (``MASTER_ADDR``/``MASTER_PORT``, ``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, the generation, ``--local_rank=i``
  injected, the checkout's root on ``PYTHONPATH``), as the reference's
  launcher exports it for the same flags;
- fail-fast (one dead rank drains the world), ``--max_restarts``
  recovery, a restartable exit (75) relaunched without ``--max_restarts``,
  SIGTERM to the launcher stopping the restart loop, ``crash@k@*``
  exhausting the restart budget, ``--emulate-devices`` refused;
- the two CLIs run as script paths (``tpudist_torch/train_gpt2.py``), and
  no module beside them shadows a standard-library or installed name;
- two gloo ranks training through ``fit``: ``sigterm@3`` on both, both
  stop and save the same step (the vote rides the loss all-reduce), no
  hang, and the relaunched world ends bit-identical to an uninterrupted
  one."""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _launch(tmp_path, launcher_args, body, script_args=(), env=None,
            module="tpudist_torch.launch", timeout=120):
    script = tmp_path / "child.py"
    script.write_text(textwrap.dedent(body))
    return subprocess.run(
        [sys.executable, "-m", module, *launcher_args, str(script),
         *script_args],
        cwd=REPO, capture_output=True, text=True, timeout=timeout,
        env={**os.environ, "OUT_DIR": str(tmp_path), "OMP_NUM_THREADS": "1",
             **(env or {})})


_RECORD = """
    import json, os, sys
    out = {
        "env": {k: os.environ.get(k) for k in
                ["MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                 "LOCAL_RANK", "TPUDIST_RESTART_GENERATION"]},
        "argv": sys.argv[1:],
        "run_id": os.environ.get("TPUDIST_RUN_ID"),
        "path": os.environ.get("PYTHONPATH", "").split(os.pathsep),
    }
    with open(os.path.join(os.environ["OUT_DIR"],
                           f"{sys.argv[-1]}{os.environ['RANK']}.json"), "w") as f:
        json.dump(out, f)
"""


def test_env_and_argv_contract_equal_the_references(tmp_path):
    args = ["--nproc_per_node=2", "--nnode=2", "--node_rank=1",
            "--master_addr=10.0.0.1", "--master_port=29777"]
    for module, tag in (("tpudist_torch.launch", "port"),
                        ("tpudist.launch", "ref")):
        r = _launch(tmp_path, args, _RECORD, ["--batch_size", "16", tag],
                    module=module, env={"PYTHONPATH": "/elsewhere"})
        assert r.returncode == 0, r.stderr
    for rank in (2, 3):
        port = json.loads((tmp_path / f"port{rank}.json").read_text())
        ref = json.loads((tmp_path / f"ref{rank}.json").read_text())
        assert port["env"] == ref["env"] == {
            "MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29777",
            "RANK": str(rank), "WORLD_SIZE": "4", "LOCAL_RANK": str(rank - 2),
            "TPUDIST_RESTART_GENERATION": "0"}
        assert port["argv"][:-1] == ref["argv"][:-1] == [
            f"--local_rank={rank - 2}", "--batch_size", "16"]
        assert port["run_id"] and len(port["run_id"]) == 12
        assert port["path"] == [str(REPO), "/elsewhere"]
    ids = {json.loads((tmp_path / f"port{r}.json").read_text())["run_id"]
           for r in (2, 3)}
    assert len(ids) == 1  # one run id for the whole world


def test_fail_fast_drains_the_world(tmp_path):
    body = """
        import os, sys, time
        if os.environ["RANK"] == "1":
            sys.exit(3)
        time.sleep(60)
    """
    t0 = time.monotonic()
    r = _launch(tmp_path, ["--nproc_per_node=2", "--term_grace=5"], body)
    assert r.returncode == 3
    assert time.monotonic() - t0 < 30


def test_max_restarts_recovers_a_crash(tmp_path):
    body = """
        import os, sys, time
        gen = os.environ["TPUDIST_RESTART_GENERATION"]
        if gen == "0":  # the first world loses rank 1; rank 0 is drained
            if os.environ["RANK"] == "1":
                sys.exit(7)
            time.sleep(20)
        with open(os.path.join(os.environ["OUT_DIR"], "gen" + gen), "w"):
            pass
    """
    r = _launch(tmp_path, ["--nproc_per_node=2", "--max_restarts=2",
                           "--backoff_base=0.01"], body)
    assert r.returncode == 0, r.stderr
    assert "restarting (1/2)" in r.stderr
    assert (tmp_path / "gen1").exists() and not (tmp_path / "gen0").exists()


def test_restartable_exit_relaunches_without_max_restarts(tmp_path):
    body = """
        import os, sys
        gen = os.environ["TPUDIST_RESTART_GENERATION"]
        with open(os.path.join(os.environ["OUT_DIR"], "gen" + gen), "w"):
            pass
        sys.exit(75 if gen == "0" else 0)
    """
    r = _launch(tmp_path, ["--nproc_per_node=1"], body)
    assert r.returncode == 0, r.stderr
    assert "rc=75 (restartable); restarting generation 1" in r.stderr
    assert (tmp_path / "gen0").exists() and (tmp_path / "gen1").exists()


def test_sigterm_to_the_launcher_stops_the_world_without_a_restart(tmp_path):
    script = tmp_path / "child.py"
    script.write_text("import time\ntime.sleep(60)\n")
    p = subprocess.Popen(
        [sys.executable, "-m", "tpudist_torch.launch", "--nproc_per_node=2",
         "--max_restarts=5", "--term_grace=5", str(script)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for _ in range(100):
        ps = subprocess.run(["ps", "--ppid", str(p.pid), "-o", "pid="],
                            capture_output=True, text=True)
        if len(ps.stdout.split()) >= 2:
            break
        time.sleep(0.2)
    p.send_signal(signal.SIGTERM)
    try:
        _, err = p.communicate(timeout=30)
    except subprocess.TimeoutExpired:
        p.kill()
        raise AssertionError("the launcher kept the world after SIGTERM")
    assert "restarting" not in err, err
    assert p.returncode != 0


def test_deterministic_crash_exhausts_the_restart_budget(tmp_path):
    """crash@1@* fires in every generation: the budget (1 restart a
    window) ends it instead of --max_restarts 50."""
    body = """
        from tpudist_torch.resilience import make_injector
        inj = make_injector("crash@1@*")
        inj.maybe_fire(0)
        inj.maybe_fire(1)
    """
    r = _launch(tmp_path, ["--nproc_per_node=1", "--max_restarts=50",
                           "--restart_budget=1", "--backoff_base=0.01"], body)
    assert r.returncode == 1
    assert r.stderr.count("ChaosCrash: chaos: injected crash after step 1") == 2
    assert "restart budget exhausted" in r.stderr


@pytest.mark.parametrize("value", ["4", "8,4"])
def test_emulate_devices_is_refused(value):
    from tpudist_torch import launch

    with pytest.raises(NotImplementedError, match="JAX mechanism"):
        launch.main([f"--emulate-devices={value}", "x.py"])


def test_no_module_of_the_package_shadows_another_name():
    """A CLI run as a script path has ``tpudist_torch/`` as
    ``sys.path[0]``: no module or package there may take the name of a
    standard-library or installed top-level module."""
    port = REPO / "tpudist_torch"
    names = {p.stem for p in port.glob("*.py")} | {
        p.name for p in port.iterdir() if (p / "__init__.py").exists()}
    names.discard("__init__")
    assert "checkpoint" in names and "launch" in names
    # an isolated interpreter (no working directory, no PYTHONPATH on its
    # path) sees the standard library and the installed packages only
    code = ("import importlib.util, json, sys\n"
            f"names = {sorted(names)!r}\n"
            "print(json.dumps([n for n in names if n in sys.stdlib_module_names"
            " or importlib.util.find_spec(n) is not None]))\n")
    r = subprocess.run([sys.executable, "-I", "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout) == []


def test_gpt2_cli_runs_as_a_script_path_under_the_launcher(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "tpudist_torch.launch", "--nproc_per_node=1",
         "tpudist_torch/train_gpt2.py", "--device", "cpu", "--vocab_size",
         "64", "--seq_len", "16", "--hidden_dim", "32", "--depth", "1",
         "--num_heads", "2", "--batch_size", "2", "--synthetic_tokens", "200",
         "--no_profiler", "--log_dir", str(tmp_path), "--checkpoint_dir",
         str(tmp_path / "ck"), "--checkpoint_every", "2", "--chaos",
         "sigterm@3"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1",
             "PYTHONPATH": ""})
    assert r.returncode == 0, r.stdout + r.stderr
    assert "rc=75 (restartable); restarting generation 1" in r.stderr
    assert "steps=3 " in r.stdout  # the second life: steps 4..6
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "3", "4", "6", "tpudist_meta.json"]


_WORLD = """
    import json, os, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    from tpudist_torch.checkpoint import read_step
    from tpudist_torch.data.cifar import synthetic_cifar, to_tensor
    from tpudist_torch.data.loader import DataLoader
    from tpudist_torch.data.sampler import DistributedSampler
    from tpudist_torch.distributed import init_from_env
    from tpudist_torch.models.resnet import resnet18
    from tpudist_torch.optim import make_optimizer
    from tpudist_torch.train import fit

    ctx = init_from_env("cpu")
    out, ckpt, chaos = sys.argv[-3:]
    data = synthetic_cifar(64, num_classes=10, seed=1)
    loader = DataLoader(data, 4, transform=to_tensor,
                        sampler=DistributedSampler(64, num_replicas=2,
                                                   rank=ctx.rank, seed=2))
    model = resnet18(num_filters=8, num_classes=10, small_inputs=True,
                     device="cpu")
    try:
        state, losses = fit(model, make_optimizer(1e-3, fused=True), loader,
                            epochs=1, fused="optimizer", profile=False,
                            log_dir=out, checkpoint_dir=ckpt,
                            checkpoint_every=5,
                            chaos=None if chaos == "none" else chaos)
        code, step = 0, state.step
    except SystemExit as e:
        code, step, losses = e.code, e.step, e.losses
        raise
    finally:
        gen = os.environ["TPUDIST_RESTART_GENERATION"]
        with open(os.path.join(out, f"{os.path.basename(ckpt)}_{gen}_"
                               f"{ctx.rank}.json"), "w") as f:
            json.dump({"code": code, "step": step, "losses": losses}, f)
"""


def test_two_gloo_ranks_stop_together_and_resume_bit_identical(tmp_path):
    from tpudist_torch.checkpoint import latest_step, read_step

    script = tmp_path / "child.py"
    script.write_text(textwrap.dedent(_WORLD))
    worlds = {name: subprocess.Popen(
        [sys.executable, "-m", "tpudist_torch.launch", "--nproc_per_node=2",
         "--master_port", str(_free_port()), str(script), str(tmp_path),
         str(tmp_path / name), chaos],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
        for name, chaos in (("full", "none"), ("cut", "sigterm@3"))}
    # the two worlds run side by side
    outs = {}
    for name, p in worlds.items():
        try:
            outs[name] = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in worlds.values():
                q.kill()
            raise AssertionError(f"world {name} hung")
        assert p.returncode == 0, outs[name][0][-3000:] + outs[name][1][-3000:]
    assert "rc=75 (restartable); restarting generation 1" in outs["cut"][1]

    def rec(name, gen, rank):
        return json.loads((tmp_path / f"{name}_{gen}_{rank}.json").read_text())

    first = [rec("cut", 0, rank) for rank in (0, 1)]
    # both ranks trip at the boundary after step 3, vote with step 4's
    # all-reduce, read the vote with step 4's loss while step 5 runs, and
    # stop together at the boundary after step 5: one emergency save
    assert [f["code"] for f in first] == [75, 75]
    assert [f["step"] for f in first] == [5, 5]
    assert first[0]["losses"] == first[1]["losses"]
    full = rec("full", 0, 0)
    assert first[0]["losses"] == full["losses"][:5]
    resumed = [rec("cut", 1, rank) for rank in (0, 1)]
    assert [x["step"] for x in resumed] == [8, 8]
    assert resumed[0]["losses"] == full["losses"][5:]
    assert latest_step(tmp_path / "cut") == latest_step(tmp_path / "full") == 8
    a, b = read_step(tmp_path / "cut", 8), read_step(tmp_path / "full", 8)
    assert a.keys() == b.keys()
    import torch

    for k, v in a.items():
        assert (torch.equal(v, b[k]) if isinstance(v, torch.Tensor)
                else v == b[k]), k


def _free_port() -> int:
    from torch_ports import free_port

    return free_port()
