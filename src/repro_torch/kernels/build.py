"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel library is one ``.cu`` file with a plain C interface, compiled
by ``nvcc`` for ``sm_90a`` into a shared library; a source may include
headers of this directory (``#include "hopper.cuh"``: ``-I`` names it).
The library lands in ``_build/`` beside this module (listed in
``.gitignore``), in a directory named by a hash of the source, the headers
it includes and the flags, so an edited source or header rebuilds and an
unchanged one loads at once. Nothing is fetched or prebuilt: with no
``nvcc``, or a failing compile, loading raises.

``build_all()`` starts one ``nvcc`` per library, all at once, and waits for
them — the way a run that needs every kernel should pay for the builds.
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
from pathlib import Path
from typing import Dict, List

import torch

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE / "_build"

#: library name -> its source, relative to this directory
SOURCES: Dict[str, str] = {
    "decode_attention": "decode_attention/csrc/decode_attention.cu",
    "flash_attention": "flash_attention/csrc/flash_attention.cu",
    "flash_attention_bwd": "flash_attention/csrc/flash_attention_bwd.cu",
    "moe_gemm": "moe_gemm/csrc/moe_gemm.cu",
    "rglru_scan": "rglru_scan/csrc/rglru_scan.cu",
    "ssd_chunk": "ssd_chunk/csrc/ssd_chunk.cu",
    "ssd_chunk_bwd": "ssd_chunk/csrc/ssd_chunk_bwd.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source at first use and need the CUDA toolkit")


_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def includes(text: str) -> List[Path]:
    """The headers of this directory that a source's ``#include "..."``
    lines name, in order."""
    return [_HERE / n for n in _INCLUDE.findall(text) if (_HERE / n).is_file()]


def source_key(text: str) -> str:
    """A hash of a source, the headers of this directory it includes and
    the flags: a build is reused only while all of them are unchanged."""
    h = hashlib.sha256(text.encode())
    for header in includes(text):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def nvcc_cmd(src, out, flags: List[str] = None) -> List[str]:
    """nvcc compiling ``src`` into the shared library ``out``, with this
    directory on the include path."""
    return [nvcc_path(), *(NVCC_FLAGS if flags is None else flags),
            "-I", str(_HERE), "-o", str(out), str(src)]


def _target(name: str) -> Path:
    key = source_key((_HERE / SOURCES[name]).read_text())
    return BUILD_DIR / f"{name}-{key}" / f"lib{name}.so"


def _start(name: str):
    """Start nvcc for ``name`` into a temporary file beside its target."""
    target = _target(name)
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    cmd = nvcc_cmd(_HERE / SOURCES[name], tmp)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, started) -> None:
    proc, tmp, target = started
    log, _ = proc.communicate()
    (target.parent / "build.log").write_text(log)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, target)          # atomic: a reader never sees half a file


def build_all(names: List[str] = None) -> None:
    """Compile every missing library, one nvcc process each, in parallel."""
    names = list(SOURCES) if names is None else names
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return
    nvcc_path()                       # raises before anything starts
    started = {n: _start(n) for n in todo}
    errors = []
    for n, s in started.items():
        try:
            _finish(n, s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def build_log(name: str) -> str:
    """nvcc's output for the current build of ``name`` (ptxas register and
    spill report), or '' if it was not built here."""
    log = _target(name).parent / "build.log"
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, building it first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_target(name)))
            _loaded[name] = lib
        return lib


def call_on_stream(fn, t, *args) -> int:
    """``fn(*args, stream)`` with t's card current, on that card's current
    stream; returns fn's CUDA error code. It reads the raw stream handle
    (as PyTorch's generated kernel launchers do) and enters a device guard
    only when t is not on the current card: a ``torch.cuda.Stream`` and a
    guard cost 6-10 and 4-8 us a call on the H100 machine's host, against
    0.1-0.6 for these (``tools/decode_ab.py``)."""
    idx = t.device.index
    if idx == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(idx):
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))


def refuse_autograd(name: str, *tensors, why: str) -> None:
    """Raise where a kernel that has no backward would be launched while
    autograd records: its output would carry no ``grad_fn``, and the
    parameters upstream would silently get no gradient. ``tensors`` may
    hold int8 ``{q, s}`` weight dicts; ``why`` says what keeps the kernel
    without one (the open ROADMAP.md item, or why none is planned). The
    CPU runs the plain version instead, which autograd differentiates."""
    if not torch.is_grad_enabled():
        return
    flat = [t for x in tensors
            for t in (x.values() if isinstance(x, dict) else (x,))]
    if any(isinstance(t, torch.Tensor) and t.requires_grad for t in flat):
        raise RuntimeError(
            f"{name} has no backward kernel: {why}. On a CUDA tensor it "
            f"cannot be differentiated; run it under torch.no_grad(), or "
            f"train on the CPU")
