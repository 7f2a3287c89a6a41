"""Build the package's CUDA C++ kernels with ``nvcc`` and load them with ctypes.

Each source under ``distkeras_tpu_torch/csrc/`` becomes one shared library
with a plain C interface, compiled for Hopper (``sm_90a``) into
``build/kernels/`` at the root of the checkout on first use. The library's
file name carries a hash of its source, of every header under ``csrc/``
(the sources share ``mma_bf16.cuh``, ``hopper_sm90.cuh`` and
``flash_generic_sm90.cuh``) and of the flags, so an edited source or header
is rebuilt and an unchanged one is loaded as it is. ``build_all`` starts
one ``nvcc`` for each source at once and waits for all of them.
:data:`SOURCE_FLAGS` adds flags for one source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "SOURCE_FLAGS", "build_all", "load_library"]

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# The generic flash sources hold many template instances (K1g 10, K2g and
# K3g 20): nvcc optimizes them on all of the host's threads (on the H100's
# 8-core host one source of 45 such instances built in 14.8 s against
# 25.7 s in one thread), so that their builds end with the others'.
SOURCE_FLAGS = {"flash_attention_generic": ("--split-compile=0",),
                "flash_attention_generic_bwd": ("--split-compile=0",)}

_loaded: dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()  # one build of a library when threads race to it


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _flags(name: str) -> tuple:
    return (*NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()))


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: list[str] | None = None) -> dict[str, str]:
    """Compile every named source (default: all of ``csrc/*.cu``) that has
    no up-to-date library yet, all ``nvcc`` processes in parallel. Returns
    each source's ``ptxas`` report (empty for a library already built).
    Raises ``RuntimeError`` with the compiler's output if any build fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    reports = {name: "" for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``, building it first
    if needed. One handle per process, whichever threads ask."""
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_target(name)))
            _loaded[name] = lib
    return lib
