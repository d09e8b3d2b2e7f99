"""How the port's CUDA sources are built, checked on the CPU: the build key
follows the headers a source includes, every variant of the int8 expert
kernels that ``tools/moe_i8_ab.py`` times, and of K2 / K3 that
``tools/moe_grad_ab.py`` times, still applies to the source, and
each library keeps its code in its own anonymous namespace (a second copy
of a library loaded into one process must not share a launcher's
once-only flag with the first)."""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path

import pytest

from repro_torch.kernels import build

ROOT = Path(__file__).resolve().parents[1]
KERNELS = ROOT / "src/repro_torch/kernels"


def test_build_key_follows_included_headers(tmp_path, monkeypatch):
    """An edit of the source or of a header of the kernels' directory it
    includes gives a new key; system headers and names that are not there
    are not read."""
    monkeypatch.setattr(build, "_HERE", tmp_path)
    (tmp_path / "common.cuh").write_text("// v1\n")
    src = ('#include <cuda.h>\n#include "common.cuh"\n'
           '#  include "absent.cuh"\nint x;\n')
    assert build.includes(src) == [tmp_path / "common.cuh"]
    key = build.source_key(src)
    assert build.source_key(src) == key
    assert build.source_key(src + "int y;\n") != key
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert build.source_key(src) != key
    assert build.includes("int x;\n") == []


def test_every_included_header_is_in_the_kernels_directory():
    """The wgmma sources include ``hopper.cuh``, and every ``#include
    "..."`` of a source names a file nvcc finds through ``-I`` that
    directory."""
    for name, rel in build.SOURCES.items():
        text = (KERNELS / rel).read_text()
        named = re.findall(r'^\s*#\s*include\s+"([^"]+)"', text, re.M)
        assert [p.name for p in build.includes(text)] == named, name
    for name in ("moe_gemm", "flash_attention_bwd"):
        text = (KERNELS / build.SOURCES[name]).read_text()
        assert KERNELS / "hopper.cuh" in build.includes(text)


def test_nvcc_is_given_the_kernels_directory(monkeypatch):
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    cmd = build.nvcc_cmd("a.cu", "liba.so")
    assert cmd[0] == "nvcc" and cmd[1:len(build.NVCC_FLAGS) + 1] == \
        build.NVCC_FLAGS
    assert cmd[cmd.index("-I") + 1] == str(KERNELS)
    assert cmd[-3:] == ["-o", "liba.so", "a.cu"]
    assert build.nvcc_cmd("a.cu", "b.so", ["-O0"])[1:2] == ["-O0"]


@pytest.mark.parametrize("rel", sorted(build.SOURCES.values())
                         + ["hopper.cuh", "mma_sync.cuh"])
def test_kernel_code_sits_in_the_anonymous_namespace(rel):
    """Outside the one anonymous namespace (``namespace {`` ... ``}  //
    namespace``) a source holds only its C interface: no template, no
    named namespace, no kernel and no function-local static. (g++ binds a
    static of a template with external linkage STB_GNU_UNIQUE, one object
    across every library of the process.)"""
    lines = [ln for ln in (KERNELS / rel).read_text().splitlines()
             if not ln.lstrip().startswith("//")]
    opens = [i for i, ln in enumerate(lines) if ln == "namespace {"]
    closes = [i for i, ln in enumerate(lines) if ln == "}  // namespace"]
    assert len(opens) == 1 and len(closes) == 1 and opens[0] < closes[0]
    outside = lines[:opens[0]] + lines[closes[0] + 1:]
    bad = [ln for ln in outside
           if re.match(r"\s*template\b|namespace \w|\s+static\s|.*__global__",
                       ln)]
    assert not bad
    if not rel.endswith(".cuh"):
        assert any(ln.startswith('extern "C"') for ln in outside)


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / f"tools/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


AB = _tool("moe_i8_ab")
GRAD_AB = _tool("moe_grad_ab")
SSD_AB = _tool("ssd_bwd_ab")


@pytest.mark.parametrize("name", sorted(AB.EDITS) + sorted(AB.PATCHES))
def test_each_int8_design_choice_still_applies(name):
    """Every edit and patch hunk of the A/B tool matches the int8 kernel's
    source exactly once (``variants`` exits otherwise), and the variant
    differs from the kept source; placement (ii) reads A by descriptor
    from a bf16 tile instead of from registers."""
    out = AB.variants()
    whole, text = out["whole"], out[name]
    assert whole == (KERNELS / build.SOURCES["moe_gemm"]).read_text()
    assert text != whole
    if name in AB.PATCHES:
        assert "wgmma_rs(acc" in whole and "wgmma_rs(acc" not in text
        assert "wgmma_ss(acc" not in whole and "wgmma_ss(acc" in text


@pytest.mark.parametrize("name", sorted(GRAD_AB.EDITS)
                         + sorted(GRAD_AB.DIAGNOSTICS)
                         + sorted(GRAD_AB.PATCHES))
def test_each_grad_design_choice_still_applies(name):
    """Every edit and patch hunk of the K1 / K2 / K3 A/B tool matches the
    source exactly once (``variants`` exits otherwise), and the variant
    differs from the kept source; the st.global patch stores no tile by
    TMA; K1's patches: one pipeline, or the split consumers, launch one
    block a unit; the cluster one multicasts x; the 32-row one loads x in
    the 64-byte swizzle."""
    out = GRAD_AB.variants()
    tree, text = out["tree"], out[name]
    assert tree == (KERNELS / build.SOURCES["moe_gemm"]).read_text()
    assert text != tree
    patch = GRAD_AB.PATCHES.get(name, "")
    if patch == "moe_grad_ab_st_global.diff":
        assert "tma_store_3d(" in tree and "tma_store_3d(" not in text
    elif patch.endswith(("lockstep.diff", "split.diff")):
        assert "pairs < sms" in tree and "pairs < sms" not in text
    elif patch.endswith("cluster.diff"):
        assert "multicast" in text and "multicast" not in tree
    elif patch:
        wgrad = [t[t.index("namespace wgrad {"):] for t in (tree, text)]
        assert "SWIZZLE_64B" not in wgrad[0] and "SWIZZLE_64B" in wgrad[1]


@pytest.mark.parametrize("name", sorted(SSD_AB.EDITS))
def test_each_ssd_bwd_design_choice_still_applies(name):
    """Every edit of the SSD backward's A/B tool matches the source
    exactly once (``variants`` exits otherwise), and the variant differs
    from the kept source: a slice width the shared memory holds, or the
    states' copies waited for at once."""
    out = SSD_AB.variants()
    tree, text = out["tree"], out[name]
    assert tree == (KERNELS / build.SOURCES["ssd_chunk_bwd"]).read_text()
    assert text != tree
    hs = re.search(r"constexpr int kSliceHeads = (\d+);", text).group(1)
    assert 1 <= int(hs) <= int(re.search(r"constexpr int kMaxHs = (\d+);",
                                         text).group(1))
