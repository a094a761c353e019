"""The tensor-sharded engine (``ServeEngine(mesh=)``, ``main --serve
--tensor``, ``serve --tensor``) against the JAX package's unsharded
engine and the port's one-rank engine (tests/test_serve_multichip.py's
contract: greedy streams identical token for token).

- In one gloo world of 2 ranks (``tensor 2``), on weights from the JAX
  init (``*_params_from_flax``): GPT-2 contiguous and paged, speculative
  decoding on (an early-exit draft, contiguous and paged), and GQA Llama
  (H 4 / H_kv 2) paged; every rank's streams equal the one-rank engine's
  and the reference engine's, and ``tensor_world`` is 2 in the stats.
- ``main --serve --tensor 2`` and ``serve --tensor 2 --paged`` on the same
  world print the one-rank CLI's streams (rank 0 alone prints).
- The refusals, before any weight moves: a tensor world that does not
  divide the query or the K/V heads, of the model or the draft, and the
  clock-driven ``ttft_slo_s`` aging.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax.core import meta

from tpudist.models.gpt2 import GPT2 as JGPT2
from tpudist.models.llama import Llama as JLlama
from tpudist.serve import ServeEngine as JServeEngine
from tpudist.serve import early_exit_draft as jax_early_exit_draft
from tpudist_torch.interop import gpt2_params_from_flax, llama_params_from_flax
from torch_threads import two_torch_threads  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
GEOM = dict(vocab_size=64, max_seq_len=64, hidden_dim=32, depth=2,
            num_heads=4)
LLAMA = dict(GEOM, num_kv_heads=2, ffn_dim=64)
PAGED = dict(paged=True, block_size=8, n_blocks=24)
SPEC = dict(spec_k=3)
#: case -> (arch, engine keywords, early-exit draft depth or 0)
CASES = {
    "gpt2-contiguous": ("gpt2", {}, 0),
    "gpt2-paged": ("gpt2", PAGED, 0),
    "gpt2-spec": ("gpt2", SPEC, 1),
    "gpt2-spec-paged": ("gpt2", {**SPEC, **PAGED}, 1),
    "llama-gqa-paged": ("llama", PAGED, 0),
}


def _prompts(n=4, lo=3, hi=9, seed=5):
    rng = np.random.Generator(np.random.PCG64(seed))
    return [rng.integers(1, 64, rng.integers(lo, hi)).astype(np.int32)
            for _ in range(n)]


def _flax(arch, seed):
    jm = JGPT2(**GEOM) if arch == "gpt2" else JLlama(**LLAMA)
    params = jm.init(jax.random.key(seed), np.zeros((1, 8), np.int32),
                     train=False)["params"]
    return jax.tree_util.tree_map(np.asarray, meta.unbox(params))


def _jax_streams(arch, params, kw, draft_depth):
    """The reference's unsharded engine (its dense decode path)."""
    jm = (JGPT2 if arch == "gpt2" else JLlama)(
        **(GEOM if arch == "gpt2" else LLAMA), attn_impl="xla")
    jp = jax.tree_util.tree_map(jax.numpy.asarray, params)
    extra = {}
    if draft_depth:
        dm, dp = jax_early_exit_draft(jm, jp, draft_depth)
        extra = dict(draft_model=dm, draft_params=dp)
    eng = JServeEngine(jm, jp, max_slots=2, seed=0, **kw, **extra)
    ids = [eng.submit(p, 8) for p in _prompts()]
    out = eng.run()
    return [list(out[i]) for i in ids]


WORKER = r"""
import contextlib
import io
import os
import sys
import torch
import torch.distributed as dist
from tpudist_torch.distributed import init_from_env
from tpudist_torch.mesh import MeshConfig, create_layout
from tpudist_torch.models.gpt2 import GPT2
from tpudist_torch.models.llama import Llama
from tpudist_torch.serve import ServeEngine, early_exit_draft

torch.set_num_threads(1)
src, out = sys.argv[1], sys.argv[2]
ctx = init_from_env("cpu")
data = torch.load(src, weights_only=False)
lay = create_layout(MeshConfig(data=-1, tensor=2))
res = {}


def streams(model, kw, depth, mesh):
    extra = {"draft_model": early_exit_draft(model, depth)} if depth else {}
    eng = ServeEngine(model, max_slots=2, seed=0, mesh=mesh, **kw, **extra)
    ids = [eng.submit(p, 8) for p in data["prompts"]]
    got = eng.run()
    return [got[i] for i in ids], eng.stats.snapshot()["tensor_world"]


for name, (arch, kw, depth) in data["cases"].items():
    cls = GPT2 if arch == "gpt2" else Llama
    model = cls(**data["geom"][arch], attn_impl="fused", device="cpu")
    model.load_state_dict(data["init"][arch])
    one, _ = streams(model, kw, depth, None)
    shard, world = streams(model, kw, depth, lay)
    res[name] = {"one": one, "shard": shard, "tensor_world": world}


def cli(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


from tpudist_torch.main import main as main_cli
from tpudist_torch.serve.__main__ import main as serve_cli

serve = ["--device", "cpu", "--requests", "3", "--max_new", "6", "--paged",
         "--block_size", "8", "--log_dir", data["tmp"]]
res["serve"] = {"one": cli(serve_cli, serve),
                "shard": cli(serve_cli, [*serve, "--tensor", "2"])}
demo = ["--serve", "--device", "cpu", "--serve_requests", "3",
        "--log_dir", data["tmp"]]
res["main"] = {"one": cli(main_cli, demo),
               "shard": cli(main_cli, [*demo, "--tensor", "2"])}
torch.save(res, f"{out}.{ctx.rank}")
# every rank here past the last collective: leave without the interpreter's
# teardown of the gloo threads (an abort there under a loaded host would
# fail a world whose results are written)
dist.barrier()
sys.stdout.flush()
os._exit(0)
"""


@pytest.fixture(scope="module")
def serve_world(tmp_path_factory):
    from torch_ports import free_port

    tmp = tmp_path_factory.mktemp("serve_tp")
    params = {"gpt2": _flax("gpt2", 0), "llama": _flax("llama", 1)}
    init = {"gpt2": gpt2_params_from_flax(params["gpt2"]),
            "llama": llama_params_from_flax(params["llama"])}
    ref = {name: _jax_streams(arch, params[arch], kw, depth)
           for name, (arch, kw, depth) in CASES.items()}
    torch.save({"cases": CASES, "init": init, "prompts": _prompts(),
                "geom": {"gpt2": GEOM, "llama": LLAMA},
                "tmp": str(tmp)}, tmp / "in.pt")
    port = free_port()
    procs = []
    for rank in range(2):
        env = {**os.environ, "PYTHONPATH": str(REPO), "MASTER_ADDR":
               "127.0.0.1", "MASTER_PORT": str(port), "RANK": str(rank),
               "WORLD_SIZE": "2", "LOCAL_RANK": str(rank),
               "OMP_NUM_THREADS": "1"}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER, str(tmp / "in.pt"),
             str(tmp / "out.pt")], env=env, cwd=tmp, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            assert p.returncode == 0, out.decode()[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ranks = [torch.load(f"{tmp / 'out.pt'}.{r}", weights_only=False)
             for r in range(2)]
    return ref, ranks


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_streams_equal_the_unsharded_engines(serve_world, case):
    ref, ranks = serve_world
    for got in ranks:
        r = got[case]
        assert r["shard"] == r["one"], case
        assert r["one"] == ref[case], case
        assert r["tensor_world"] == 2


def test_serve_cli_tensor_prints_the_one_rank_streams(serve_world):
    _, ranks = serve_world
    got = ranks[0]["serve"]
    rows = lambda out: [ln for ln in out.splitlines()
                        if ln.startswith("request ")]
    assert len(rows(got["one"])) == 3
    assert rows(got["shard"]) == rows(got["one"])
    assert "tensor_world 2" in got["shard"]
    assert ranks[1]["serve"]["shard"] == ""  # rank 0 alone prints


def test_main_serve_tensor_serves_every_request(serve_world):
    _, ranks = serve_world
    got = ranks[0]["main"]
    done = lambda out: sorted(ln for ln in out.splitlines()
                              if ln.endswith("tokens (done)"))
    assert len(done(got["one"])) == 3
    assert done(got["shard"]) == done(got["one"])
    assert "tensor_world 2" in got["shard"]
    assert ranks[1]["main"]["shard"] == ""


def test_head_divisibility_and_clock_refusals():
    from tpudist_torch.mesh import RankLayout
    from tpudist_torch.models.gpt2 import GPT2
    from tpudist_torch.models.llama import Llama
    from tpudist_torch.serve import ServeEngine

    gpt2 = GPT2(**GEOM, device="cpu")
    llama = Llama(**LLAMA, device="cpu")
    three = RankLayout(0, 1, 1, tensor=3)
    with pytest.raises(ValueError, match=r"model: num_heads=4 / "
                       r"num_kv_heads=4 not divisible by tensor=3"):
        ServeEngine(gpt2, mesh=three)
    with pytest.raises(ValueError, match=r"num_kv_heads=2 not divisible by "
                       r"tensor=4 .*GQA: the KV heads are the binding"):
        ServeEngine(llama, mesh=RankLayout(0, 1, 1, tensor=4))
    draft = GPT2(**dict(GEOM, num_heads=2), device="cpu")
    with pytest.raises(ValueError, match="draft_model: num_heads=2"):
        ServeEngine(gpt2, mesh=RankLayout(0, 1, 1, tensor=4),
                    draft_model=draft)
    with pytest.raises(ValueError, match="ttft_slo_s"):
        ServeEngine(gpt2, mesh=RankLayout(0, 1, 1, tensor=2),
                    ttft_slo_s=1.0)
    assert ServeEngine(gpt2).tensor_world == 1
