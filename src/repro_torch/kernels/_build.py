"""Build and load the port's CUDA kernels (`src/repro_torch/csrc/*.cu`).

Each source is compiled on first use by `nvcc` for Hopper
(`-gencode arch=compute_90a,code=sm_90a`) into a shared library with a plain
C interface under `build/repro_torch_kernels/` at the repository root, and
loaded with `ctypes`.  Sources include no PyTorch header, so a build takes
seconds; every source not yet built is compiled by its own `nvcc`, all
started together.  A library is named by a digest of its source, the
shared headers (`csrc/*.cuh`) and the flags, so an edited source or header
rebuilds and an unchanged one is reused.

Nothing falls back: a missing `nvcc` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

__all__ = ["BUILD_DIR", "CSRC", "build_all", "library"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# nvcc's report (ptxas registers / shared memory / spills) per source built
# by this process; chip_smoke.py prints it.
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin); the port's CUDA"
            " kernels are built from source on the machine with the card"
        )
    return path


def _target(src: Path) -> Path:
    """The library of `src`, named by a digest of the source, the headers
    beside it (which it may include) and the flags."""
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:12]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source that has no current library; {stem: library}."""
    sources = sorted(CSRC.glob("*.cu"))
    todo = [(src, _target(src)) for src in sources if not _target(src).exists()]
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for src, out in todo:
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            procs.append((src, out, tmp, proc))
        failed = []
        for src, out, tmp, proc in procs:
            log, _ = proc.communicate()
            BUILD_LOGS[src.stem] = log
            if proc.returncode != 0:
                failed.append(f"{src.name}: nvcc exited {proc.returncode}\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {src.stem: _target(src) for src in sources}


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<name>.cu` (built on first use)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            paths = build_all()
            if name not in paths:
                raise RuntimeError(f"no kernel source csrc/{name}.cu; have {sorted(paths)}")
            lib = ctypes.CDLL(str(paths[name]))
            _LIBS[name] = lib
        return lib
