"""Build and load the port's compiled code: the CUDA kernels and the native
host library.

Each source under ``csrc/`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build takes
seconds); ``native/ggjt_native.cpp``, the host fast paths, compiles with g++
(``GXX_FLAGS``: ``-ffp-contract=off`` keeps its quantizer bit-exact).  The
libraries go into ``llama_cpp_q_4_0_tpu_torch/build/`` (``BUILD_DIR``;
``utils/compile_cache.enable`` names another).  The build happens at first
use, again whenever a source is newer than its library; ``build_all`` starts
one compiler per stale source at once.  Processes that build at once (test
workers) take the build directory's file lock, so one compiles while the
others wait and then find the libraries fresh; each library is written under
a temporary name and renamed into place.  The wrappers in ``ops/`` load the
libraries with ctypes and launch on PyTorch's current stream.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_BUILD_DIR = os.path.join(_PKG, "build")
# where the libraries go: utils/compile_cache.enable names another
BUILD_DIR = DEFAULT_BUILD_DIR
SOURCES = {
    "qmm_q4_0": os.path.join(_PKG, "csrc", "qmm_q4_0.cu"),
    "qmm_int8": os.path.join(_PKG, "csrc", "qmm_int8.cu"),
    "flash_prefill": os.path.join(_PKG, "csrc", "flash_prefill.cu"),
    "qmm_q8x": os.path.join(_PKG, "csrc", "qmm_q8x.cu"),
    "mha_decode": os.path.join(_PKG, "csrc", "mha_decode.cu"),
    "stream": os.path.join(_PKG, "csrc", "stream.cu"),
    "ggjt_native": os.path.join(_PKG, "native", "ggjt_native.cpp"),
}
CUDA_SOURCES = [n for n, p in SOURCES.items() if p.endswith(".cu")]
# headers the CUDA sources include: a change to one rebuilds every one of them
HEADERS = [os.path.join(_PKG, "csrc", h)
           for h in ("hopper.cuh", "qmm_common.cuh", "qmm_tile.cuh")]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
             "-pthread"]
COMPILE_TIMEOUT = 600  # seconds, for one compiler process

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}  # the compiler's output (nvcc: ptxas register/smem report)


def _tool(name: str, fallback: str | None = None) -> str:
    path = shutil.which(name) or fallback
    if path is None or not os.path.exists(path):
        raise RuntimeError(f"{name} not found: the CUDA kernels build only on a machine with "
                           "the CUDA toolkit, the native library only where g++ is installed")
    return path


def _compile_cmd(name: str, out: str) -> list[str]:
    src = SOURCES[name]
    if src.endswith(".cu"):
        return [_tool("nvcc", "/usr/local/cuda/bin/nvcc"), *NVCC_FLAGS, "-o", out, src]
    return [_tool("g++"), *GXX_FLAGS, src, "-o", out]


def _so_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def stale(name: str) -> bool:
    """Whether the library of ``name`` is missing or older than its sources."""
    so = _so_path(name)
    deps = [SOURCES[name], *(HEADERS if SOURCES[name].endswith(".cu") else [])]
    return not os.path.exists(so) or os.path.getmtime(so) < max(map(os.path.getmtime, deps))


@contextlib.contextmanager
def build_lock():
    """The build directory's file lock, held by one process at a time."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".build.lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        yield


def build_all(names=None) -> dict[str, float]:
    """Compile the stale sources of ``names`` (default: all), one compiler
    process each, all started together under the build lock.  Returns the
    seconds each build took; raises with the compiler's output on failure."""
    names = list(names or SOURCES)
    if not any(stale(n) for n in names):
        return {}
    seconds, errors = {}, []
    with build_lock():
        procs = {}
        t0 = time.perf_counter()
        try:
            for n in [n for n in names if stale(n)]:  # another process may have built some
                tmp = _so_path(n) + f".{os.getpid()}.tmp"
                procs[n] = (tmp, subprocess.Popen(_compile_cmd(n, tmp), stdout=subprocess.PIPE,
                                                  stderr=subprocess.PIPE, text=True))
            for n, (tmp, p) in procs.items():
                try:
                    out, err = p.communicate(timeout=COMPILE_TIMEOUT)
                except subprocess.TimeoutExpired:
                    p.kill()
                    out, err = p.communicate()
                    errors.append(f"the build of {SOURCES[n]} took over {COMPILE_TIMEOUT} s")
                    continue
                seconds[n] = time.perf_counter() - t0
                build_log[n] = out + err
                if p.returncode != 0:
                    errors.append(f"the build of {SOURCES[n]} failed:\n{out}{err}")
                    continue
                os.replace(tmp, _so_path(n))
        finally:
            for tmp, p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
                if os.path.exists(tmp):
                    os.remove(tmp)
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed.
    ``signatures`` maps each C function to ``(argtypes, restype)``; every
    pointer and the stream must be ``c_void_p`` or ctypes cuts them to 32 bits."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if stale(name):
                build_all([name])
            lib = ctypes.CDLL(_so_path(name))
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return lib
