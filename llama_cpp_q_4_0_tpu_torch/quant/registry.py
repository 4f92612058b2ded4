"""The quant-fn table of the reference's ``quantize_fns`` (ggml.c:1618-1716):
for each block type its quantizer, dequantizer, activation-side quantizer,
dot product and the activation type of that dot, with the k-quant dot
products (k_quants.h:145-149) as integer math over unpacked levels.
``quantize`` / ``dequantize`` take ``qk_k``, the k-quant super-block build
(256, or 64 for the ``-DGGML_QKK_64`` variant of ``kquants64.py``).

The JAX package's ``quant/registry.py``, numpy only: its q4_0 quantizer's
native fast path is left out, since JAX holds it bit for bit equal to this
numpy path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from . import blockq, kquants, kquants64
from .types import BLOCK_Q4_0, K_QUANTS, GGMLType, type_traits

F32 = np.float32


@dataclass(frozen=True)
class QuantFns:
    """One row of the table (quantize_fns_t, ggml.h:1524-1533)."""

    quantize_row: Callable[[np.ndarray], np.ndarray]
    quantize_row_reference: Callable[[np.ndarray], np.ndarray]
    dequantize_row: Callable[[np.ndarray], np.ndarray]
    quantize_row_dot: Callable[[np.ndarray], np.ndarray]  # activation-side quant
    vec_dot: Callable[[np.ndarray, np.ndarray], float] | None
    vec_dot_type: GGMLType


def _dot_parts(x, y, levels, groups):
    """Each super-block's group dots of the levels with the q8_K values, and
    the weight's d times the activation's."""
    nb = x.shape[0]
    q8 = y["qs"].astype(np.int32).reshape(nb, groups, -1)
    dots = (levels.reshape(nb, groups, -1) * q8).sum(axis=2)
    return dots, blockq.f16_to_f32(x["d"]) * y["d"].astype(F32)


def vec_dot_q2_K_q8_K(xb: np.ndarray, yb: np.ndarray) -> float:
    """sum_g d*sc_g*(q2 . q8)_g - dmin*mn_g*bsum_g (k_quants.c scalar path)."""
    x, y = xb.reshape(-1), yb.reshape(-1)
    sc = (x["scales"] & 0xF).astype(F32)
    mn = (x["scales"] >> 4).astype(F32)
    dots, d = _dot_parts(x, y, kquants._unpack2(x["qs"]), 16)
    dmin = blockq.f16_to_f32(x["dmin"]) * y["d"].astype(F32)
    sumi = (sc * dots.astype(F32)).sum(axis=1)
    summin = (mn * y["bsums"].astype(F32)).sum(axis=1)
    return float((d * sumi - dmin * summin).sum(dtype=F32))


def vec_dot_q3_K_q8_K(xb: np.ndarray, yb: np.ndarray) -> float:
    x, y = xb.reshape(-1), yb.reshape(-1)
    sc = kquants._q3_unpack_scales(x["scales"])
    dots, d = _dot_parts(x, y, kquants._q3_levels(x), 16)
    sumi = (sc.astype(F32) * dots.astype(F32)).sum(axis=1)
    return float((d * sumi).sum(dtype=F32))


def _dot_affine_32(x, y, levels) -> float:
    """q4_K / q5_K: 8 groups of 32 with 6-bit scales and mins."""
    nb = x.shape[0]
    sc, mn = kquants.unpack_scale_min_k4(x["scales"])
    dots, d = _dot_parts(x, y, levels, 8)
    dmin = blockq.f16_to_f32(x["dmin"]) * y["d"].astype(F32)
    bs2 = y["bsums"].astype(np.int32).reshape(nb, 8, 2).sum(axis=2)
    sumi = (sc.astype(F32) * dots.astype(F32)).sum(axis=1)
    summin = (mn.astype(F32) * bs2.astype(F32)).sum(axis=1)
    return float((d * sumi - dmin * summin).sum(dtype=F32))


def vec_dot_q4_K_q8_K(xb: np.ndarray, yb: np.ndarray) -> float:
    x, y = xb.reshape(-1), yb.reshape(-1)
    return _dot_affine_32(x, y, kquants._unpack_nibble_pairs(x["qs"]))


def vec_dot_q5_K_q8_K(xb: np.ndarray, yb: np.ndarray) -> float:
    x, y = xb.reshape(-1), yb.reshape(-1)
    return _dot_affine_32(x, y, kquants._q5_levels(x))


def vec_dot_q6_K_q8_K(xb: np.ndarray, yb: np.ndarray) -> float:
    x, y = xb.reshape(-1), yb.reshape(-1)
    dots, d = _dot_parts(x, y, kquants._q6_levels(x), 16)
    sumi = (x["scales"].astype(F32) * dots.astype(F32)).sum(axis=1)
    return float((d * sumi).sum(dtype=F32))


def _row(q, dq, dot_q, dot, dot_type) -> QuantFns:
    return QuantFns(q, q, dq, dot_q, dot, dot_type)


QUANT_FNS: dict[GGMLType, QuantFns] = {
    GGMLType.Q4_0: _row(blockq.quantize_q4_0, blockq.dequantize_q4_0,
                        blockq.quantize_q8_0, blockq.vec_dot_q4_0_q8_0, GGMLType.Q8_0),
    GGMLType.Q4_1: _row(blockq.quantize_q4_1, blockq.dequantize_q4_1,
                        blockq.quantize_q8_1, blockq.vec_dot_q4_1_q8_1, GGMLType.Q8_1),
    GGMLType.Q5_0: _row(blockq.quantize_q5_0, blockq.dequantize_q5_0,
                        blockq.quantize_q8_0, blockq.vec_dot_q5_0_q8_0, GGMLType.Q8_0),
    GGMLType.Q5_1: _row(blockq.quantize_q5_1, blockq.dequantize_q5_1,
                        blockq.quantize_q8_1, blockq.vec_dot_q5_1_q8_1, GGMLType.Q8_1),
    GGMLType.Q8_0: _row(blockq.quantize_q8_0, blockq.dequantize_q8_0,
                        blockq.quantize_q8_0, blockq.vec_dot_q8_0_q8_0, GGMLType.Q8_0),
    GGMLType.Q8_1: _row(blockq.quantize_q8_1, blockq.dequantize_q8_1,
                        blockq.quantize_q8_1, None, GGMLType.Q8_1),
    GGMLType.Q2_K: _row(kquants.quantize_q2_K, kquants.dequantize_q2_K,
                        kquants.quantize_q8_K, vec_dot_q2_K_q8_K, GGMLType.Q8_K),
    GGMLType.Q3_K: _row(kquants.quantize_q3_K, kquants.dequantize_q3_K,
                        kquants.quantize_q8_K, vec_dot_q3_K_q8_K, GGMLType.Q8_K),
    GGMLType.Q4_K: _row(kquants.quantize_q4_K, kquants.dequantize_q4_K,
                        kquants.quantize_q8_K, vec_dot_q4_K_q8_K, GGMLType.Q8_K),
    GGMLType.Q5_K: _row(kquants.quantize_q5_K, kquants.dequantize_q5_K,
                        kquants.quantize_q8_K, vec_dot_q5_K_q8_K, GGMLType.Q8_K),
    GGMLType.Q6_K: _row(kquants.quantize_q6_K, kquants.dequantize_q6_K,
                        kquants.quantize_q8_K, vec_dot_q6_K_q8_K, GGMLType.Q8_K),
    GGMLType.Q8_K: _row(kquants.quantize_q8_K, kquants.dequantize_q8_K,
                        kquants.quantize_q8_K, None, GGMLType.Q8_K),
}


def _fns(t: GGMLType, qk_k: int):
    """(quantize, dequantize) of t in the QK_K = qk_k build."""
    type_traits(t, qk_k)  # checks qk_k
    if qk_k == 64 and t in K_QUANTS:
        return kquants64.QUANT_FNS_64[t][:2]
    if t not in QUANT_FNS:
        raise NotImplementedError(f"no quantizer for {GGMLType(t).name}")
    return QUANT_FNS[t].quantize_row, QUANT_FNS[t].dequantize_row


def quantize(x: np.ndarray, t: GGMLType, qk_k: int = 256) -> np.ndarray:
    """Quantize float32 rows (..., k) to blocks of type t (..., k / block).
    A 2-D q4_0 input with rows of whole 32-groups takes the C++ quantizer
    (native/) when it is built, bit for bit the numpy one."""
    fn = _fns(t, qk_k)[0]
    if t == GGMLType.Q4_0 and getattr(x, "ndim", 0) == 2 and x.shape[1] % 32 == 0:
        from .. import native

        raw = native.quantize_q4_0(np.asarray(x, np.float32))
        if raw is not None:
            return raw.reshape(x.shape[0], -1).view(BLOCK_Q4_0).reshape(
                x.shape[0], x.shape[1] // 32)
    return fn(x)


def dequantize(blocks: np.ndarray, t: GGMLType, qk_k: int = 256) -> np.ndarray:
    """Blocks of type t (..., n) back to float32 rows (..., n * block)."""
    return _fns(t, qk_k)[1](blocks)


def quantize_bytes(x: np.ndarray, t: GGMLType, qk_k: int = 256) -> bytes:
    """Quantize and serialise in the ggml on-disk byte layout."""
    return quantize(x, t, qk_k).tobytes()


def dequantize_bytes(raw, t: GGMLType, shape, qk_k: int = 256) -> np.ndarray:
    """ggml block bytes (or f32 / f16 values) as float32 of the given
    element shape."""
    if t == GGMLType.F32:
        return np.frombuffer(raw, dtype="<f4").reshape(shape).astype(np.float32)
    if t == GGMLType.F16:
        return np.frombuffer(raw, dtype="<f2").reshape(shape).astype(np.float32)
    tr = type_traits(t, qk_k)
    if tr.block_dtype is None:
        raise NotImplementedError(f"no dequantizer for {GGMLType(t).name}")
    buf = np.frombuffer(raw, dtype=tr.block_dtype)
    if buf.shape[0] * tr.block_size != int(np.prod(shape)):
        raise ValueError(f"{buf.shape[0]} {tr.name} blocks do not hold shape {tuple(shape)}")
    return dequantize(buf, t, qk_k).reshape(shape)
