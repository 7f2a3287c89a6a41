"""ctypes bindings for the native data plane (``native/fastdata.cpp``).

Counterpart of ``distkeras_tpu/data/native.py``: the same C library, bound
with the same argument types, gives the host side of the feed a C hot path
(CSV parsing, permutation gather, batch packing with a fused affine
normalize). ``make -C native`` builds ``native/libfastdata.so`` (git
ignores it); a ``.so`` older than its source is never loaded, and one build
is tried per process. Without a toolchain every function falls back to
numpy, as the reference's do: this is host code, not a device kernel.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

__all__ = [
    "available",
    "parse_csv",
    "gather_rows",
    "pack_batch",
    "permutation",
    "column_minmax",
]

_LIB = None
_LOAD_TRIED = False


def _find_lib():
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return _ensure_built(os.path.join(here, "native"))


def _ensure_built(native_dir: str) -> str | None:
    """Build (or rebuild) libfastdata.so from source when the checkout has
    the sources. The .so is NOT committed (it would be an unauditable binary
    that silently goes stale against fastdata.cpp); a stale .so is never
    loaded — numpy fallback instead."""
    src = os.path.join(native_dir, "fastdata.cpp")
    so = os.path.join(native_dir, "libfastdata.so")
    if not os.path.exists(src):
        return so if os.path.exists(so) else None
    fresh = os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src)
    if fresh:
        return so
    try:
        subprocess.run(
            ["make", "-C", native_dir],
            check=True,
            capture_output=True,
            timeout=120,
        )
    except (OSError, subprocess.SubprocessError):
        return None  # no toolchain / failed build: numpy fallback, not stale .so
    return so if os.path.exists(so) else None


def _load():
    global _LIB, _LOAD_TRIED
    if _LIB is not None or _LOAD_TRIED:
        # One attempt per process: a failed build/load must not re-spawn
        # `make` on every minibatch call (the numpy fallback is the steady
        # state on toolchain-less hosts).
        return _LIB
    _LOAD_TRIED = True
    path = _find_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.fd_parse_csv_f32.restype = ctypes.c_int64
    lib.fd_parse_csv_f32.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, f32p, ctypes.c_int64, ctypes.c_int64,
    ]
    lib.fd_gather_f32.restype = None
    lib.fd_gather_f32.argtypes = [f32p, i64p, f32p, ctypes.c_int64, ctypes.c_int64]
    lib.fd_pack_batch_f32.restype = None
    lib.fd_pack_batch_f32.argtypes = [
        f32p, f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_float, ctypes.c_float,
    ]
    lib.fd_permutation.restype = None
    lib.fd_permutation.argtypes = [i64p, ctypes.c_int64, ctypes.c_uint64]
    lib.fd_minmax_f32.restype = None
    lib.fd_minmax_f32.argtypes = [f32p, ctypes.c_int64, f32p, f32p]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def parse_csv(data: bytes, rows: int, cols: int) -> np.ndarray:
    """Parse a headerless numeric CSV buffer into a [rows, cols] float32."""
    lib = _load()
    if lib is None:
        flat = np.array(
            data.decode().replace("\n", ",").split(",")[: rows * cols],
            dtype=np.float32,
        )
        return flat.reshape(rows, cols)
    out = np.empty((rows, cols), np.float32)
    n = lib.fd_parse_csv_f32(data, len(data), _f32p(out), rows, cols)
    if n < 0:
        raise ValueError("malformed CSV input")
    return out[:n]


def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """out[i] = src[idx[i]] over the leading axis (native memcpy gather)."""
    lib = _load()
    src = np.ascontiguousarray(src, dtype=np.float32)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if lib is None:
        return src[idx]
    # The C path is a raw memcpy: out-of-range indices would read (or fault
    # on) arbitrary memory, where the numpy fallback raises IndexError.
    # Match the fallback's contract before crossing the FFI boundary.
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= src.shape[0]):
        raise IndexError(
            f"gather index out of range [0, {src.shape[0]}): "
            f"min={int(idx.min())} max={int(idx.max())}"
        )
    row_elems = int(np.prod(src.shape[1:], dtype=np.int64)) if src.ndim > 1 else 1
    out = np.empty((idx.shape[0],) + src.shape[1:], np.float32)
    lib.fd_gather_f32(_f32p(src), _i64p(idx), _f32p(out), idx.shape[0], row_elems)
    return out


def pack_batch(
    src: np.ndarray, start: int, batch: int, scale: float = 1.0, shift: float = 0.0
) -> np.ndarray:
    """Contiguous [start:start+batch] slice, optionally fused ``x*scale+shift``."""
    lib = _load()
    src = np.ascontiguousarray(src, dtype=np.float32)
    if start < 0 or batch < 0 or start + batch > src.shape[0]:
        # The C path is a raw memcpy; keep the numpy fallback on the same
        # contract so the two paths never diverge on bad ranges.
        raise IndexError(
            f"pack_batch range [{start}, {start + batch}) outside "
            f"[0, {src.shape[0]})"
        )
    if lib is None:
        chunk = src[start : start + batch]
        return chunk * scale + shift if (scale != 1.0 or shift != 0.0) else chunk.copy()
    row_elems = int(np.prod(src.shape[1:], dtype=np.int64)) if src.ndim > 1 else 1
    out = np.empty((batch,) + src.shape[1:], np.float32)
    lib.fd_pack_batch_f32(_f32p(src), _f32p(out), start, batch, row_elems,
                          float(scale), float(shift))
    return out


def permutation(n: int, seed: int) -> np.ndarray:
    """Deterministic Fisher-Yates permutation (SplitMix64)."""
    lib = _load()
    if lib is None:
        return np.random.default_rng(seed).permutation(n).astype(np.int64)
    out = np.empty(n, np.int64)
    lib.fd_permutation(_i64p(out), n, ctypes.c_uint64(seed))
    return out


def column_minmax(x: np.ndarray) -> tuple[float, float]:
    lib = _load()
    x = np.ascontiguousarray(x, dtype=np.float32)
    if lib is None:
        return float(x.min()), float(x.max())
    lo = np.empty(1, np.float32)
    hi = np.empty(1, np.float32)
    lib.fd_minmax_f32(_f32p(x), x.size, _f32p(lo), _f32p(hi))
    return float(lo[0]), float(hi[0])
