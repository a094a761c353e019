"""The port's kernel build (tpudist_torch.csrc.build) without a compiler:
library names hash the headers beside their source (an A/B builds a
revision's sources against that revision's headers), the ``-Xptxas -v``
log is kept beside the library so a reused build still reports its
registers and spills, and the report names each kernel readably."""

import subprocess
import types
from pathlib import Path

from tpudist_torch.csrc import build

#: a bf16 HD 64 instantiation with no spills and an f32 one with spills,
#: as nvcc 12 names kernels in an anonymous namespace
PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__96ee40d6_17_vmem_attention_cu_8d14b09820attn_dkdv_mma_kernelILi64ELb1EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__96ee40d6_17_vmem_attention_cu_8d14b09820attn_dkdv_mma_kernelILi64ELb1EEEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 166 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__96ee40d6_17_vmem_attention_cu_8d14b09814attn_dq_kernelILi128EEEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__96ee40d6_17_vmem_attention_cu_8d14b09814attn_dq_kernelILi128EEEvNS_6ParamsE
    24 bytes stack frame, 56 bytes spill stores, 44 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__96ee40d6_17_vmem_attention_cu_8d14b09817attn_delta_kernelI13__nv_bfloat16EEvNS_6ParamsE' for 'sm_90a'
ptxas info    : Function properties for _ZN50_GLOBAL__N__96ee40d6_17_vmem_attention_cu_8d14b09817attn_delta_kernelI13__nv_bfloat16EEvNS_6ParamsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 29 registers, used 0 barriers, 400 bytes cmem[0]
"""


def test_register_report_names_each_kernel(monkeypatch):
    monkeypatch.setitem(build.build_info, "x.cu", {"log": PTXAS_LOG})
    assert build.register_report("x.cu") == [
        dict(kernel="attn_dkdv_mma_kernel<64, true>", stack=0,
             spill_stores=0, spill_loads=0, registers=166),
        dict(kernel="attn_dq_kernel<128>", stack=24, spill_stores=56,
             spill_loads=44, registers=255),
        dict(kernel="attn_delta_kernel<bf16>", stack=0, spill_stores=0,
             spill_loads=0, registers=29),
    ]
    assert build._kernel_name("main") == "main"


def test_library_names_hash_the_headers_beside_the_source(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    for d, header in ((a, "// one"), (b, "// two")):
        d.mkdir()
        (d / "k.cu").write_text('#include "t.cuh"\n')
        (d / "t.cuh").write_text(header)
    assert build.library_path(str(a / "k.cu")) != build.library_path(
        str(b / "k.cu"))
    (b / "t.cuh").write_text("// one")
    assert build.library_path(str(a / "k.cu")) == build.library_path(
        str(b / "k.cu"))


def test_a_reused_build_keeps_its_report(tmp_path, monkeypatch):
    """The compiler's log is written beside the library, so a later
    process that reuses the library still has the register report."""
    src = tmp_path / "k.cu"
    src.write_text("// kernel")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")

    def fake_nvcc(cmd, **kw):
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"\x7fELF")
        return types.SimpleNamespace(returncode=0, stdout=PTXAS_LOG,
                                     stderr="")

    monkeypatch.setattr(subprocess, "run", fake_nvcc)
    monkeypatch.setattr(build, "build_info", {})
    out = build.build(str(src))
    assert not build.build_info[str(src)]["reused"]
    monkeypatch.setattr(build, "build_info", {})
    assert build.build(str(src)) == out
    assert build.build_info[str(src)]["reused"]
    assert len(build.register_report(str(src))) == 3


def _entry(name, args, spill, regs):
    """One kernel's lines of a ptxas log, its name mangled as nvcc 12
    mangles a kernel in an anonymous namespace."""
    ns = "_GLOBAL__N__96ee40d6_18_flash_attention_cu_8d14b098"
    mangled = f"_ZN{len(ns)}{ns}{len(name)}{name}I{args}EEvNS_6ParamsE"
    return (f"ptxas info    : Compiling entry function '{mangled}' for "
            f"'sm_90a'\n    0 bytes stack frame, {spill} bytes spill stores, "
            f"{spill} bytes spill loads\nptxas info    : Used {regs} "
            f"registers, used 1 barriers, 400 bytes cmem[0]\n")


def test_attention_build_reports_forwards_and_flags_hd64_spills(monkeypatch):
    """The attention build report (chip_smoke phases 12 and 16) lists the
    forward kernels beside the backward ones, and flags a spill only in a
    bf16 HD 64 tensor-core instantiation, forward or backward."""
    from tpudist_torch.ops import lm_kernels_bench as LB

    log = "".join((
        _entry("flash_fwd_mma_kernel", "Li64E", 8, 255),
        _entry("flash_fwd_mma_kernel", "Li128E", 16, 255),
        _entry("attn_dkdv_mma_kernel", "Li64ELb0E", 0, 168),
        _entry("attn_dq_mma_kernel", "Li64ELb0E", 4, 255),
        _entry("flash_fwd_kernel", "fLi64E", 12, 131),
    ))
    monkeypatch.setitem(build.build_info, "f.cu", {"log": log})
    lines, spilled = LB.attention_build("f.cu")
    assert [ln.split(":")[0] for ln in lines] == [
        "flash_fwd_mma_kernel<64>", "flash_fwd_mma_kernel<128>",
        "attn_dkdv_mma_kernel<64, false>", "attn_dq_mma_kernel<64, false>",
        "flash_fwd_kernel<float, 64>"]
    assert spilled == ["flash_fwd_mma_kernel<64>",
                       "attn_dq_mma_kernel<64, false>"]


def test_ln_build_reports_backward_and_flags_spills_to_d768(monkeypatch):
    """The LayerNorm build report (chip_smoke phase 11) lists the backward
    instantiations ``ln_bwd_kernel<TX, TG, PER, V>`` beside the forward
    ones, and flags a spill in every backward for D up to 768 (PER at most
    24, f32 or bf16, either load width) and in the bf16 forwards at D 768;
    a spill at D 2048 or in an f32 forward is reported, not flagged."""
    from tpudist_torch.ops import lm_kernels_bench as LB

    log = "".join((
        _entry("ln_bwd_kernel", "13__nv_bfloat16S1_Li24ELi8E", 0, 159),
        _entry("ln_bwd_kernel", "ffLi24ELi1E", 16, 255),
        _entry("ln_bwd_kernel", "13__nv_bfloat16S1_Li64ELi8E", 480, 255),
        _entry("ln_bwd_kernel", "f13__nv_bfloat16Li8ELi8E", 4, 80),
        _entry("ln_fwd_kernel", "13__nv_bfloat16S1_Li24E", 8, 255),
        _entry("ln_fwd_kernel", "ffLi24E", 8, 200),
    ))
    monkeypatch.setitem(build.build_info, "layernorm.cu", {"log": log})
    lines, spilled = LB.ln_build()
    assert [ln.split(":")[0] for ln in lines] == [
        "ln_bwd_kernel<bf16, bf16, 24, 8>", "ln_bwd_kernel<float, float, 24, 1>",
        "ln_bwd_kernel<bf16, bf16, 64, 8>", "ln_bwd_kernel<float, bf16, 8, 8>",
        "ln_fwd_kernel<bf16, bf16, 24>", "ln_fwd_kernel<float, float, 24>"]
    assert spilled == ["ln_bwd_kernel<float, float, 24, 1>",
                       "ln_bwd_kernel<float, bf16, 8, 8>",
                       "ln_fwd_kernel<bf16, bf16, 24>"]


def test_kernel_names_of_repeated_and_namespace_types():
    """Template arguments that repeat a type (``S<n>_``), a type of the
    kernel's own namespace (``NS_<len><name>E``) and a float before a
    named type read as they were written: the register report tells the
    LayerNorm forward's bf16 instantiations and fused AdamW's copy modes
    apart."""
    ns = "_ZN12_GLOBAL__N_1"
    cases = {
        f"{ns}13ln_fwd_kernelI13__nv_bfloat16S1_Li24EEEvPKT_S4_PKfS6_":
            "ln_fwd_kernel<bf16, bf16, 24>",
        f"{ns}13ln_fwd_kernelIf13__nv_bfloat16Li24EEEvPKT_":
            "ln_fwd_kernel<float, bf16, 24>",
        f"{ns}13ln_fwd_kernelI13__nv_bfloat16fLi8EEEvPKT_":
            "ln_fwd_kernel<bf16, float, 8>",
        f"{ns}12adamw_kernelI6__halfNS_6NoCopyEEEvNS_5TableE":
            "adamw_kernel<half, NoCopy>",
        f"{ns}12adamw_kernelIffEEvNS_5TableE": "adamw_kernel<float, float>",
        f"{ns}13ln_bwd_reduceEPKdS1_PfS2_ii": "ln_bwd_reduce",
    }
    for mangled, name in cases.items():
        assert build._kernel_name(mangled) == name
