"""ctypes bindings of the native host-side data path
(``native/hostloader.cpp``; counterpart of ``climsim_tpu/data/native.py``).

Fused gather+normalize, in-place normalization, the exponential cloud
transform and NaN scrubbing run multithreaded in C++ (OpenMP), the
host-loop roles the reference fills with numba @njit kernels and
DataLoader worker processes (rnn/utils.py:1798-1865). The library is the
checkout's ``native/libhostloader.so``; where that file is absent it is
compiled from ``native/hostloader.cpp`` into ``build/native/`` (git
ignored) with the flags of ``native/build.sh``, if a compiler is there.
Without the library every function computes the same with numpy
(``available()`` says which). Host code: nothing here touches the card.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_ROOT, "native")
_SO = os.path.join(_NATIVE_DIR, "libhostloader.so")
_BUILT = os.path.join(_ROOT, "build", "native", "libhostloader.so")
_LIB = None


def _build() -> str | None:
    """Compile ``native/hostloader.cpp`` into ``build/native/`` (the flags
    of ``native/build.sh``); the library's path, or None."""
    src = os.path.join(_NATIVE_DIR, "hostloader.cpp")
    if not os.path.exists(src):
        return None
    os.makedirs(os.path.dirname(_BUILT), exist_ok=True)
    try:
        subprocess.run(["g++", "-O3", "-march=native", "-fopenmp", "-shared",
                        "-fPIC", src, "-o", _BUILT], check=True,
                       capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    return _BUILT


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    path = next((p for p in (_SO, _BUILT) if os.path.exists(p)), None) \
        or _build()
    try:
        lib = ctypes.CDLL(path) if path else None
    except OSError:
        lib = None
    if lib is None:
        _LIB = False
        return _LIB
    i64 = ctypes.c_int64
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int64)
    lib.gather_normalize_f32.argtypes = [fp, ip, fp, fp, fp, i64, i64]
    lib.gather_f32.argtypes = [fp, ip, fp, i64, i64]
    lib.normalize_f32.argtypes = [fp, fp, fp, i64, i64]
    lib.cloud_exp_transform_f32.argtypes = [fp, fp, i64, i64, i64, i64]
    lib.scrub_nonfinite_f32.argtypes = [fp, i64]
    lib.omp_thread_count.restype = ctypes.c_int
    _LIB = lib
    return _LIB


def available() -> bool:
    """True when the native library is loaded (found or built)."""
    return bool(_load())


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _row_vec(v, shape) -> np.ndarray:
    """``v`` broadcast to one row of trailing ``shape``, flat float32."""
    return np.ascontiguousarray(np.broadcast_to(v, shape).ravel(),
                                np.float32)


def gather_normalize(src: np.ndarray, idx: np.ndarray, mean: np.ndarray,
                     div: np.ndarray) -> np.ndarray:
    """dst[i] = (src[idx[i]] - mean) / div over flattened trailing dims."""
    src = np.ascontiguousarray(src, np.float32)
    row = int(np.prod(src.shape[1:]))
    idx = np.ascontiguousarray(idx, np.int64)
    mean, div = _row_vec(mean, src.shape[1:]), _row_vec(div, src.shape[1:])
    lib = _load()
    if not lib:
        return ((src[idx].reshape(len(idx), row) - mean) / div).reshape(
            (len(idx),) + src.shape[1:])
    dst = np.empty((len(idx),) + src.shape[1:], np.float32)
    lib.gather_normalize_f32(_fptr(src), _iptr(idx), _fptr(mean),
                             _fptr(div), _fptr(dst), len(idx), row)
    return dst


def gather(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """dst[i] = src[idx[i]]."""
    src = np.ascontiguousarray(src, np.float32)
    idx = np.ascontiguousarray(idx, np.int64)
    lib = _load()
    if not lib:
        return src[idx].copy()
    row = int(np.prod(src.shape[1:]))
    dst = np.empty((len(idx),) + src.shape[1:], np.float32)
    lib.gather_f32(_fptr(src), _iptr(idx), _fptr(dst), len(idx), row)
    return dst


def normalize_inplace(x: np.ndarray, mean: np.ndarray, div: np.ndarray):
    """x = (x - mean) / div in place (C-contiguous float32 ``x``)."""
    assert x.dtype == np.float32 and x.flags["C_CONTIGUOUS"]
    row = int(np.prod(x.shape[1:]))
    mean, div = _row_vec(mean, x.shape[1:]), _row_vec(div, x.shape[1:])
    lib = _load()
    if not lib:
        x.reshape(len(x), row)[:] = (x.reshape(len(x), row) - mean) / div
        return x
    lib.normalize_f32(_fptr(x), _fptr(mean), _fptr(div), len(x), row)
    return x


def cloud_exp_inplace(x: np.ndarray, lbd: np.ndarray, channel: int):
    """x[..., channel] = 1 - exp(-x[..., channel]*lbd) on [n, nlev, nch]."""
    assert x.ndim == 3 and x.dtype == np.float32 and x.flags["C_CONTIGUOUS"]
    lbd = np.ascontiguousarray(lbd, np.float32)
    lib = _load()
    if not lib:
        x[:, :, channel] = 1.0 - np.exp(-x[:, :, channel] * lbd)
        return x
    n, nlev, nch = x.shape
    lib.cloud_exp_transform_f32(_fptr(x), _fptr(lbd), n, nlev, nch, channel)
    return x


def scrub_nonfinite(x: np.ndarray):
    """Non-finite entries of ``x`` set to 0 in place."""
    assert x.dtype == np.float32 and x.flags["C_CONTIGUOUS"]
    lib = _load()
    if not lib:
        x[~np.isfinite(x)] = 0.0
        return x
    lib.scrub_nonfinite_f32(_fptr(x), x.size)
    return x


def thread_count() -> int:
    """The library's OpenMP thread count (1 without the library)."""
    lib = _load()
    return lib.omp_thread_count() if lib else 1
