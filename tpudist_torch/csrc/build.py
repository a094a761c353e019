"""Build and load the port's CUDA kernels.

Each ``*.cu`` source here is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, named by a
hash of the source, the shared headers (``*.cuh``) and the flags, under
``tpudist_torch/_build/`` (listed in ``.gitignore``), and loaded with
``ctypes``. Nothing is built when the package is imported: the first
launch builds, later launches and later processes reuse the library
whose hash matches. Nothing includes PyTorch's headers, so a build takes
seconds.

    python -m tpudist_torch.csrc.build     # build every source now, print the log
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent
BUILD_DIR = CSRC.parent / "_build"
SOURCES = ("decode_attention.cu", "flash_attention.cu", "fused_update.cu",
           "layernorm.cu", "vmem_attention.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: per-source build record: seconds spent (0 for a reuse) and the
#: compiler's log (``-Xptxas -v`` register / shared-memory report), kept
#: beside the library as ``<library>.log``
build_info: dict[str, dict] = {}


def nvcc_path() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc",
        shutil.which("nvcc"),
        Path("/usr/local/cuda/bin/nvcc"),
    ):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the CUDA "
        "kernels are built on the machine with the card"
    )


def library_path(source: str) -> Path:
    """``source`` names a file here or is a path (an alternate source of
    the same C interface, for an A/B). The name hashes the headers beside
    the source too, since it may include them."""
    path = CSRC / source
    text = b"".join([path.read_bytes(), *(
        h.read_bytes() for h in sorted(path.parent.glob("*.cuh")))])
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{Path(source).stem}_{digest[:16]}.so"


def build(source: str) -> Path:
    """Compile ``source`` unless a library with its hash exists; returns
    the library path. The output is written to a temporary name and
    renamed, so concurrent builds never load a half-written file."""
    out = library_path(source)
    log = out.with_suffix(".log")
    if out.exists():
        build_info.setdefault(source, {
            "seconds": 0.0, "reused": True,
            "log": log.read_text() if log.exists() else ""})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed on {source} (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    text = (proc.stdout + proc.stderr).strip()
    log.write_text(text)
    os.replace(tmp, out)
    build_info[source] = {
        "seconds": time.perf_counter() - t0, "log": text, "reused": False}
    return out


def build_all() -> dict[str, Path]:
    """Compile every source at once, one ``nvcc`` process each, started
    together."""
    todo = [s for s in SOURCES if not library_path(s).exists()]
    threads = [threading.Thread(target=build, args=(s,)) for s in todo]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return {s: build(s) for s in SOURCES}


def load(source: str = "decode_attention.cu") -> ctypes.CDLL:
    """The loaded library for ``source``, built on first use, with the
    argument types of its C entry points declared."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _declare(lib, source)
            _libs[source] = lib
        return lib


def _declare(lib: ctypes.CDLL, source: str) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tpudist_cuda_error_string.argtypes = [I]
    lib.tpudist_cuda_error_string.restype = ctypes.c_char_p
    if hasattr(lib, "tpudist_fused_adamw_table"):
        lib.tpudist_fused_adamw_max_leaves.argtypes = []
        lib.tpudist_fused_adamw_max_leaves.restype = I
        lib.tpudist_fused_adamw_table.argtypes = [
            I, I, P, I, I, I, F, F, F, F, F, F, F, F, P, P, P, P,
        ]
        lib.tpudist_fused_adamw_table.restype = I
    L = ctypes.c_longlong
    if hasattr(lib, "tpudist_layernorm_fwd"):
        lib.tpudist_layernorm_max_d.argtypes = []
        lib.tpudist_layernorm_max_d.restype = I
        lib.tpudist_layernorm_bwd_parts.argtypes = [L]
        lib.tpudist_layernorm_bwd_parts.restype = I
        lib.tpudist_layernorm_fwd.argtypes = [
            I, I, P, P, P, P, P, P, L, I, F, F, I, P,
        ]
        lib.tpudist_layernorm_fwd.restype = I
        lib.tpudist_layernorm_bwd.argtypes = [
            I, I, P, P, P, P, P, P, P, P, P, L, I, I, F, F, I, P,
        ]
        lib.tpudist_layernorm_bwd.restype = I
    # vmem_attention.cu and flash_attention.cu share one C interface
    for prefix in ("tpudist_vmem", "tpudist_flash"):
        if hasattr(lib, f"{prefix}_fwd"):
            fwd = getattr(lib, f"{prefix}_fwd")
            bwd = getattr(lib, f"{prefix}_bwd")
            fwd.argtypes = [
                I, P, P, P, P, P, I, I, I, I, I, I, *[L] * 9, I, I, F, P,
            ]
            fwd.restype = I
            bwd.argtypes = [
                I, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, *[L] * 15,
                I, I, F, P,
            ]
            bwd.restype = I
    if hasattr(lib, "tpudist_decode_attention"):
        lib.tpudist_decode_attention.argtypes = [
            I, P, P, P, P, I, I, I, I, I, I, F, P,
        ]
        lib.tpudist_decode_attention.restype = I
        lib.tpudist_paged_decode_attention.argtypes = [
            I, P, P, P, P, P, P, I, I, I, I, I, I, I, F, P,
        ]
        lib.tpudist_paged_decode_attention.restype = I


def _kernel_name(mangled: str) -> str:
    """``attn_dq_mma_kernel<64, true>`` from nvcc's name of a kernel in an
    anonymous namespace, ``_ZN<n><namespace><n><name>I<args>E...``;
    other names are returned as they are."""
    m = re.match(r"_ZN(\d+)", mangled)
    rest = mangled[m.end() + int(m.group(1)):] if m else ""
    m = re.match(r"\d+", rest)
    if not m:
        return mangled
    end = m.end() + int(m.group())
    name, tail = rest[m.end():end], rest[end:]
    if not tail.startswith("I") or "Ev" not in tail:
        return name
    args = []
    for m in re.finditer(r"13__nv_bfloat16|6__half|Li(\d+)E|Lb([01])E|"
                         r"NS\d*_\d+(\w+?)E|S\d*_|f(?=[fLENS\d])",
                         tail[1:tail.index("Ev")]):
        tok = m.group(0)
        if m.group(3):  # a type of the kernel's own namespace
            args.append(m.group(3))
        elif tok[0] == "S":  # a type repeated: the argument before it
            args.append(args[-1] if args else "?")
        else:
            args.append({"13__nv_bfloat16": "bf16", "6__half": "half",
                         "f": "float"}.get(tok) or m.group(1) or
                        {"0": "false", "1": "true"}[m.group(2)])
    return f"{name}<{', '.join(args)}>"


def register_report(source: str) -> list[dict]:
    """Per kernel of ``source``'s library: registers, spill stores and
    loads (bytes) and stack frame, from its build's ``-Xptxas -v`` log."""
    out, cur = [], {}
    for line in build_info.get(source, {}).get("log", "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": _kernel_name(m.group(1))}
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            cur["registers"] = int(m.group(1))
            out.append(cur)
            cur = {}
    return out


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = lib.tpudist_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


if __name__ == "__main__":
    for src, path in build_all().items():
        info = build_info.get(src, {})
        print(f"{src} -> {path} ({info.get('seconds', 0.0):.2f} s)")
        if info.get("log"):
            print(info["log"])
