"""ctypes bindings and the lazy g++ build of the native host paths.

``ggjt_native.cpp`` holds the three host hot paths, each bit for bit the
numpy or Python version it stands beside:

  - gt_pack_q4_0: multithreaded block_q4_0 -> split-half packed repack, the
    load-time layout change that feeds the CUDA kernels (quant/q4_0.py)
  - gt_quantize_q4_0: the q4_0 quantizer of the quantize and convert tools
    (quant/blockq.py)
  - gt_tokenize: the bigram tokenizer (runtime/tokenizer.py)

The shared library builds on first use with g++ (``kernels/build.py``, the
kernels' builder: its build directory, file lock and rename into place),
again whenever the source is newer.  Every entry point returns None when the
library is missing (no g++, a failed build, or ``LLAMA_TPU_NO_NATIVE`` set);
its callers then take the numpy or Python version, which gives the same
bytes.  ``calls`` counts the calls of each entry point that ran natively.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import sys
import threading

import numpy as np

from ..kernels import build as kernel_build

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
SIGNATURES = {
    "gt_pack_q4_0": ([_P, _I64, _I64, _I64, _P, _P, ctypes.c_int], None),
    "gt_quantize_q4_0": ([_P, _I64, _I64, _P, ctypes.c_int], None),
    "gt_vocab_create": ([_P, _P, _P, _I32], _P),
    "gt_vocab_free": ([_P], None),
    "gt_tokenize": ([_P, _P, _I64, _I32, _P, _I64], _I32),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
calls = {"pack_q4_0": 0, "quantize_q4_0": 0, "tokenize": 0}


def get_lib() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("LLAMA_TPU_NO_NATIVE"):
            return None
        if kernel_build.stale("ggjt_native") and shutil.which("g++") is None:
            return None
        try:
            _lib = kernel_build.load("ggjt_native", SIGNATURES)
        except (RuntimeError, OSError) as e:
            print(f"native build failed:\n{str(e)[:2000]}", file=sys.stderr)
        return _lib


def available() -> bool:
    return get_lib() is not None


def reset():
    """Forget the loaded library, so that the next call looks again (at
    ``LLAMA_TPU_NO_NATIVE`` and the build)."""
    global _lib, _tried
    with _lock:
        _lib, _tried = None, False


def pack_q4_0(blocks_raw: np.ndarray, n: int, k: int,
              n_threads: int = 0) -> tuple[np.ndarray, np.ndarray] | None:
    """block_q4_0 bytes [N*(K/32)*18] -> (packed uint8 [K2P, N], scales f32
    [2, K2P/32, N]) in the QTensor packed layout, as quant/q4_0.py's
    ``pack_q4_0``; None if there is no library."""
    lib = get_lib()
    if lib is None:
        return None
    if k % 64:
        raise ValueError(f"K={k}: each half-panel must hold whole 32-groups")
    blocks_raw = np.ascontiguousarray(blocks_raw).view(np.uint8).reshape(-1)
    if blocks_raw.size != n * (k // 32) * 18:
        raise ValueError(f"{blocks_raw.size} bytes do not hold a q4_0 [{n}, {k}]")
    k2p = -(-(k // 2) // 256) * 256
    packed = np.zeros((k2p, n), np.uint8)
    scales = np.zeros((2, k2p // 32, n), np.float32)
    lib.gt_pack_q4_0(blocks_raw.ctypes.data, n, k, k2p, packed.ctypes.data,
                     scales.ctypes.data, n_threads)
    calls["pack_q4_0"] += 1
    return packed, scales


def quantize_q4_0(x: np.ndarray, n_threads: int = 0) -> np.ndarray | None:
    """f32 [N, K] -> raw block_q4_0 bytes uint8 [N, K/32, 18], bit for bit
    quant/blockq.py's ``quantize_q4_0``; None if there is no library."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    n, k = x.shape
    if k % 32:
        raise ValueError(f"K={k} is not a multiple of 32")
    out = np.empty((n, k // 32, 18), np.uint8)
    lib.gt_quantize_q4_0(x.ctypes.data, n, k, out.ctypes.data, n_threads)
    calls["quantize_q4_0"] += 1
    return out


class NativeVocab:
    """A vocabulary handle for gt_tokenize."""

    def __init__(self, tokens: list[bytes], scores: list[float]):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("the native library is not available")
        self._lib = lib
        blob = b"".join(tokens)
        offsets = np.zeros(len(tokens) + 1, np.int64)
        np.cumsum([len(t) for t in tokens], out=offsets[1:])
        self._blob = (np.frombuffer(blob, np.uint8).copy() if blob
                      else np.zeros(1, np.uint8))
        self._offsets = offsets
        self._scores = np.asarray(scores, np.float32)
        self._handle = lib.gt_vocab_create(self._blob.ctypes.data, offsets.ctypes.data,
                                           self._scores.ctypes.data, len(tokens))

    def tokenize(self, text: bytes, bos: bool) -> list[int]:
        cap = len(text) + 8
        out = np.empty(cap, np.int32)
        n = self._lib.gt_tokenize(self._handle, text, len(text), 1 if bos else 0,
                                  out.ctypes.data, cap)
        if n < 0:
            raise RuntimeError("tokenize output overflow")
        calls["tokenize"] += 1
        return out[:n].tolist()

    def __del__(self):
        try:
            self._lib.gt_vocab_free(self._handle)
        except Exception:
            pass
