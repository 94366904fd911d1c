"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface (the device helpers
the sources share live in ``csrc/*.cuh``) and is compiled with ``nvcc``
for ``sm_90a`` into ``<checkout>/build/kernels/`` (listed in
``.gitignore``) the first time it is needed, then loaded with ``ctypes``.
The library's file name carries a hash of its source and the headers, so
an edited source is rebuilt and a stale library is never loaded. Nothing
here runs at import time: importing the package needs neither ``nvcc``
nor a GPU.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from .library import refuse_export

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# sources with a C entry point; one shared library each
SOURCES = ("bigru_heads_init_cm", "bigru_heads_cm_bwd", "fv_tracers_sphere",
           "bigru_lbh", "bigru_lbh_bwd", "adding_sw", "adding_sw_bwd",
           "lw_noscat", "lw_noscat_bwd", "bigru_heads_cm", "fv_tracers_flat",
           "bigru_heads_lbh", "gates16_check")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "with the CUDA toolkit on the GPU machine")
    return found


def _lib_path(name: str) -> Path:
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    tag = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def _start(name: str):
    """Start nvcc for one source; returns (Popen, tmp path, final path),
    or None when the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names=SOURCES) -> float:
    """Compile every missing library, one nvcc process per source, all
    started together. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        started = {n: _start(n) for n in names}
        for n, s in started.items():
            if s is not None:
                _finish(n, s)
    return time.perf_counter() - t0


def check_status(rc: int, name: str) -> None:
    """Raise when a kernel's C entry point returned a CUDA error code
    (``cudaGetLastError`` after its launch)."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def build_log(name: str) -> str:
    """nvcc/ptxas output of the last build of ``name`` (registers,
    shared memory and spills per kernel)."""
    path = _lib_path(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed.
    Raises under ``torch.export``, which cannot trace a ctypes launch."""
    refuse_export(name)
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        started = _start(name)
        if started is not None:
            _finish(name, started)
        lib = ctypes.CDLL(str(_lib_path(name)))
        _libs[name] = lib
        return lib
