"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel package keeps its sources under ``csrc/*.cu`` and the headers
they include under ``csrc/*.cuh``; headers shared by several packages (the
Hopper building blocks, ``hopper.cuh``; the TF32x3 products, ``tf32x3.cuh``)
live in ``kernels/csrc/`` and reach nvcc through ``-I``. ``nvcc`` compiles a package's sources for Hopper
(``sm_90a``) into a shared library with a plain C interface, under
``build/`` at the repository root (listed in ``.gitignore``). The file name
carries a hash of the sources, the package's headers, every shared header
and the flags, so an edited source or header is rebuilt and an unchanged one
is loaded as it is. The
wrapper passes every pointer and the stream as ``ctypes.c_void_p``; each C
entry point returns ``cudaGetLastError()`` after its launch, and the wrapper
raises on nonzero.

Nothing here runs at import time: the build starts on the first launch on a
CUDA tensor, or when :func:`build` is called (``chip_smoke.py`` does so to
time it). Kernels are built only from the sources in this repository.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

KERNELS_DIR = Path(__file__).resolve().parent
REPO_ROOT = KERNELS_DIR.parents[2]
BUILD_DIR = REPO_ROOT / "build"

# Every kernel package of the port that holds csrc/*.cu sources.
KERNELS = ("adamw", "flash_attention", "quant_blockwise", "ssd_scan")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def sources(name: str) -> list[Path]:
    srcs = sorted((KERNELS_DIR / name / "csrc").glob("*.cu"))
    if not srcs:
        raise KernelBuildError(f"no CUDA sources for kernel {name!r}")
    return srcs


def nvcc() -> str:
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")] if "CUDA_HOME" in os.environ else []
    cands += ["/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def shared_include() -> Path:
    """The directory of the headers every kernel package may include."""
    return KERNELS_DIR / "csrc"


def headers(name: str) -> list[Path]:
    """The shared headers, then the kernel's own: hashed into the library's
    name, never compiled on their own."""
    return (sorted(shared_include().glob("*.cuh"))
            + sorted((KERNELS_DIR / name / "csrc").glob("*.cuh")))


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources(name) + headers(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    return BUILD_DIR / f"{name}.log"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every named kernel that is not built yet, one nvcc each, all
    started together. Returns {name: path of the shared library}."""
    out = {name: library_path(name) for name in names}
    todo = [name for name, lib in out.items() if not lib.exists()]
    if not todo:
        return out
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for name in todo:
        lib = out[name]
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-I", str(shared_include()), "-o", str(tmp),
               *map(str, sources(name))]
        log = open(log_path(name), "w")
        running.append((name, lib, tmp, log,
                        subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for name, lib, tmp, log, proc in running:
        try:
            rc = proc.wait(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = -1
        finally:
            log.close()
        if rc == 0:
            os.replace(tmp, lib)
        else:
            failed.append(f"{name} (nvcc exit {rc}):\n{log_path(name).read_text()[-4000:]}")
    if failed:
        raise KernelBuildError("kernel build failed: " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if need be."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _LIBS[name] = lib
        return lib
