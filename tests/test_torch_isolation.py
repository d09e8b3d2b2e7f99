"""The port stands alone: nothing under ``src/repro_torch/`` and nothing in
``chip_smoke.py`` imports JAX, ``ml_dtypes`` or the reference package (the
machine with the card has none of them); the control-plane modules are
copies of the reference's with only their imports rewritten; and the entry
points take the CUDA card unless the caller asks for the CPU. The modules
the port writes itself (its kernels and the torch versions of JAX code) are
listed in ``PORTED`` and held to the no-JAX rule by name."""

import ast
import re
from pathlib import Path

import pytest
import torch

from repro_torch.adapters import AdapterRuntime
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.serve import serve
from repro_torch.models.transformer import LM
from repro_torch.serving.engine import InferenceEngine

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")

#: copied from the reference with imports rewritten and nothing else; the
#: other copies differ on purpose (core/sites.py states H100 figures,
#: models/config.py drops the reference's decode-kernel switches)
VERBATIM = sorted(
    [p.relative_to(REF) for d in ("core", "netfault", "splitserve",
                                  "federation", "sim") for p in
     (REF / d).glob("*.py") if p.name != "sites.py"]
    + [Path("api") / f for f in ("__init__.py", "messages.py", "gateway.py",
                                 "client.py")]
    + [Path("serving") / f for f in ("plane.py", "scheduler.py",
                                     "supervisor.py")]
    + [Path("adapters/catalog.py")]
    + [Path("training") / f for f in ("__init__.py", "data.py",
                                      "fault_tolerance.py")]
    + [p.relative_to(REF) for p in (REF / "configs").glob("*.py")
       if p.name != "__init__.py"])


#: ported, not copied: the port's own code for these reference modules (its
#: kernels and the torch versions of JAX code), held to the same rule
PORTED = ("adapters/runtime.py", "models/moe.py", "models/transformer.py",
          "serving/engine.py", "bridge.py", "kernels/moe_gemm/__init__.py",
          "kernels/moe_gemm/moe_gemm.py",
          "kernels/decode_attention/decode_attention.py",
          "models/rglru.py", "models/ssd.py", "models/attention.py",
          "models/kvcache.py", "kernels/rglru_scan/__init__.py",
          "kernels/rglru_scan/rglru_scan.py", "kernels/ssd_chunk/__init__.py",
          "kernels/ssd_chunk/ssd_chunk.py",
          "kernels/flash_attention/__init__.py",
          "kernels/flash_attention/flash_attention.py",
          "models/frontends.py", "models/quant.py",
          "training/optimizer.py", "training/compression.py",
          "training/checkpoint.py", "training/train_step.py",
          "launch/train.py")


def _sources():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "tools").glob("*.py")))


def _imported(tree):
    """Every module name an import statement or a literal import call in
    ``tree`` names."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and node.args and (
                getattr(node.func, "attr", None) == "import_module"
                or getattr(node.func, "id", None) == "__import__"):
            arg = node.args[0]
            if isinstance(arg, ast.JoinedStr) and arg.values:
                arg = arg.values[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                yield arg.value


def test_sources_exist():
    assert len(_sources()) > 40


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [name for name in _imported(tree)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("rel", PORTED)
def test_ported_modules_are_the_ports_own(rel):
    """Each ported module exists, is not a copy of a reference module (so
    the no-JAX rule, not the copy rule, is what holds it), and imports
    nothing of JAX or the reference."""
    path = PORT / rel
    assert path in _sources() and Path(rel) not in VERBATIM
    ref = REF / rel
    if ref.exists():
        assert path.read_text() != re.sub(r"\brepro\.", "repro_torch.",
                                          ref.read_text())
    tree = ast.parse(path.read_text(), filename=str(path))
    assert not [n for n in _imported(tree) if n.split(".")[0] in FORBIDDEN]


@pytest.mark.parametrize("rel", VERBATIM, ids=str)
def test_control_plane_copies_differ_only_in_imports(rel):
    ref = re.sub(r"\brepro\.", "repro_torch.", (REF / rel).read_text())
    assert (PORT / rel).read_text() == ref


def test_entry_points_take_the_card_by_default(monkeypatch):
    """With no CUDA device, device=None raises rather than running on the
    CPU, before any weights are drawn."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("edge-tiny")
    moe = get_smoke_config("qwen3-moe-30b-a3b")
    hybrid = get_smoke_config("recurrentgemma-2b")
    ssm = get_smoke_config("mamba2-1.3b")
    encdec = get_smoke_config("seamless-m4t-medium")
    for call in (lambda: serve("edge-tiny", sessions=1, requests=1,
                               quiet=True),
                 lambda: InferenceEngine(cfg, slots=1, max_len=16),
                 lambda: LM(cfg).init(0),
                 lambda: LM(moe).init(0),
                 lambda: InferenceEngine(moe, slots=1, max_len=16),
                 lambda: AdapterRuntime(cfg.d_model),
                 lambda: LM(hybrid).init(0),
                 lambda: InferenceEngine(hybrid, slots=1, max_len=16),
                 lambda: LM(ssm).init(0),
                 lambda: InferenceEngine(ssm, slots=1, max_len=16),
                 lambda: serve("mamba2-1.3b", sessions=1, requests=1,
                               quiet=True),
                 lambda: LM(encdec).init(0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-1.3b"])
def test_recurrent_families_construct_at_full_size(arch):
    """The LM of both recurrent families takes their catalog configs (no
    weights are drawn here)."""
    assert LM(get_config(arch)).cfg.name == arch
