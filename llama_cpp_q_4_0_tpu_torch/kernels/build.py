"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build takes
seconds), placed in ``llama_cpp_q_4_0_tpu_torch/build/``.  The build happens at
first use; ``build_all`` starts one ``nvcc`` per source at once.  The wrappers
in ``ops/`` load the libraries with ctypes and launch on PyTorch's current
stream.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = {
    "qmm_q4_0": os.path.join(_PKG, "csrc", "qmm_q4_0.cu"),
    "qmm_int8": os.path.join(_PKG, "csrc", "qmm_int8.cu"),
    "flash_prefill": os.path.join(_PKG, "csrc", "flash_prefill.cu"),
    "qmm_q8x": os.path.join(_PKG, "csrc", "qmm_q8x.cu"),
    "mha_decode": os.path.join(_PKG, "csrc", "mha_decode.cu"),
    "stream": os.path.join(_PKG, "csrc", "stream.cu"),
}
# headers the sources include: a change to one rebuilds every source
HEADERS = [os.path.join(_PKG, "csrc", h) for h in ("qmm_common.cuh", "qmm_tile.cuh")]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}  # nvcc's stderr (ptxas register/smem report)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _so_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    so = _so_path(name)
    return (not os.path.exists(so)
            or os.path.getmtime(so) < max(os.path.getmtime(p)
                                          for p in [SOURCES[name], *HEADERS]))


def build_all(names=None) -> dict[str, float]:
    """Compile the stale sources, one nvcc process each, all started together.
    Returns the seconds each build took; raises with nvcc's output on failure."""
    names = [n for n in (names or SOURCES) if _stale(n)]
    if not names:
        return {}
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n in names:
        tmp = _so_path(n) + f".{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, SOURCES[n]]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE, text=True))
    seconds, errors = {}, []
    for n, (tmp, p) in procs.items():
        out, err = p.communicate()
        seconds[n] = time.perf_counter() - t0
        build_log[n] = out + err
        if p.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[n]}:\n{out}{err}")
            continue
        os.replace(tmp, _so_path(n))
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of one kernel source, built first if needed.
    ``signatures`` maps each C function to ``(argtypes, restype)``; every
    pointer and the stream must be ``c_void_p`` or ctypes cuts them to 32 bits."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                build_all([name])
            lib = ctypes.CDLL(_so_path(name))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return lib
