"""The legacy 32-element block formats (q4_0, q4_1, q5_0, q5_1, q8_0, q8_1):
the fp16 scale widening and q5 high bits the planar repack needs, the
quantizers and the dequantizers.

The quantizers are vectorised numpy that reproduce the reference's scalar
``quantize_row_*_reference`` (ggml.c:918-1316) byte for byte: fp16 scale
rounding, C-cast truncation and ``roundf`` half away from zero.  Each takes
float32 rows (..., k), k a multiple of 32, and returns the structured blocks
(..., k/32) of ``types.py``; each dequantizer is its inverse, in the float32
order of the reference's ``dequantize_row_*``.  The JAX package's
``quant/blockq.py``.
"""

from __future__ import annotations

import numpy as np

from .types import (BLOCK_Q4_0, BLOCK_Q4_1, BLOCK_Q5_0, BLOCK_Q5_1, BLOCK_Q8_0,
                    BLOCK_Q8_1)

F32 = np.float32


def f16(x: np.ndarray) -> np.ndarray:
    """fp32 -> fp16, round to nearest even (GGML_FP32_TO_FP16)."""
    return np.asarray(x, dtype=np.float32).astype(np.float16)


def f16_to_f32(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, dtype=np.float16).astype(np.float32)


def roundf(v: np.ndarray) -> np.ndarray:
    """C roundf: round half away from zero."""
    v = np.asarray(v, dtype=np.float32)
    return np.sign(v) * np.floor(np.abs(v) + F32(0.5))


def _qh_bits(qh_bytes: np.ndarray) -> np.ndarray:
    """(nb, 4) uint8 -> (nb, 32) int32 of individual bits, LSB first."""
    qh = np.ascontiguousarray(qh_bytes).view("<u4").reshape(-1)
    shifts = np.arange(32, dtype=np.uint32)
    return ((qh[:, None] >> shifts) & 1).astype(np.int32)


def _blocks(x: np.ndarray) -> tuple[np.ndarray, tuple[int, ...]]:
    x = np.ascontiguousarray(x, dtype=np.float32)
    if x.shape[-1] % 32:
        raise ValueError(f"row length {x.shape[-1]} is not a multiple of 32")
    return x.reshape(-1, 32), x.shape[:-1]


def _signed_absmax(xb: np.ndarray) -> np.ndarray:
    """Per block, the signed value of largest magnitude; the first wins a tie
    (the strict ``amax < fabsf(v)`` of ggml.c:928-933)."""
    idx = np.argmax(np.abs(xb), axis=-1)
    return xb[np.arange(xb.shape[0]), idx]


def _safe_inv(d: np.ndarray) -> np.ndarray:
    """``id = d ? 1.0f/d : 0.0f`` in float32."""
    with np.errstate(divide="ignore"):
        return np.where(d != 0, F32(1.0) / d.astype(F32), F32(0.0)).astype(F32)


def _qh(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """The fifth bits of the 32 levels as the 4 little-endian qh bytes."""
    shifts = np.arange(16, dtype=np.uint32)
    qh = (((lo >> 4).astype(np.uint32) << shifts).sum(axis=-1, dtype=np.uint32)
          | ((hi >> 4).astype(np.uint32) << (shifts + 16)).sum(axis=-1, dtype=np.uint32))
    return qh.astype("<u4").view(np.uint8).reshape(-1, 4)


def quantize_q4_0(x: np.ndarray) -> np.ndarray:
    """x = d * (q - 8), d = signed_absmax / -8 (ggml.c:918-953)."""
    xb, lead = _blocks(x)
    d = (_signed_absmax(xb) / F32(-8.0)).astype(F32)
    id_ = _safe_inv(d)
    # MIN(15, (int8_t)(x*id + 8.5f)): the argument is >= ~0.5, so the C cast
    # (truncation toward zero) is a floor
    q = np.minimum(15, np.floor(xb * id_[:, None] + F32(8.5)).astype(np.int32))
    q = q.astype(np.uint8)
    out = np.empty(xb.shape[0], dtype=BLOCK_Q4_0)
    out["d"] = f16(d)
    out["qs"] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(*lead, -1)


def quantize_q4_1(x: np.ndarray) -> np.ndarray:
    """x = d * q + m, d = (max - min) / 15 (ggml.c:962-998)."""
    xb, lead = _blocks(x)
    mn = xb.min(axis=-1).astype(F32)
    mx = xb.max(axis=-1).astype(F32)
    d = ((mx - mn) / F32(15.0)).astype(F32)
    id_ = _safe_inv(d)
    q = np.minimum(15, np.floor((xb - mn[:, None]) * id_[:, None]
                                + F32(0.5)).astype(np.int32)).astype(np.uint8)
    out = np.empty(xb.shape[0], dtype=BLOCK_Q4_1)
    out["d"] = f16(d)
    out["m"] = f16(mn)
    out["qs"] = q[:, :16] | (q[:, 16:] << 4)
    return out.reshape(*lead, -1)


def quantize_q5_0(x: np.ndarray) -> np.ndarray:
    """x = d * (q - 16), the fifth bits in qh (ggml.c:1000-1046)."""
    xb, lead = _blocks(x)
    d = (_signed_absmax(xb) / F32(-16.0)).astype(F32)
    id_ = _safe_inv(d)
    q = np.minimum(31, np.floor(xb * id_[:, None] + F32(16.5)).astype(np.int32))
    q = q.astype(np.uint8)
    lo, hi = q[:, :16], q[:, 16:]
    out = np.empty(xb.shape[0], dtype=BLOCK_Q5_0)
    out["d"] = f16(d)
    out["qs"] = (lo & 0x0F) | ((hi & 0x0F) << 4)
    out["qh"] = _qh(lo, hi)
    return out.reshape(*lead, -1)


def quantize_q5_1(x: np.ndarray) -> np.ndarray:
    """x = d * q + m, d = (max - min) / 31 (ggml.c:1048-1095)."""
    xb, lead = _blocks(x)
    mn = xb.min(axis=-1).astype(F32)
    mx = xb.max(axis=-1).astype(F32)
    d = ((mx - mn) / F32(31.0)).astype(F32)
    id_ = _safe_inv(d)
    q = np.floor((xb - mn[:, None]) * id_[:, None] + F32(0.5)).astype(np.int32)
    q = q.astype(np.uint8)
    lo, hi = q[:, :16], q[:, 16:]
    out = np.empty(xb.shape[0], dtype=BLOCK_Q5_1)
    out["d"] = f16(d)
    out["m"] = f16(mn)
    out["qs"] = (lo & 0x0F) | ((hi & 0x0F) << 4)
    out["qh"] = _qh(lo, hi)
    return out.reshape(*lead, -1)


def quantize_q8_0(x: np.ndarray) -> np.ndarray:
    """x = d * q, d = amax / 127 stored fp16, q = roundf(x / d)
    (ggml.c:1097-1126)."""
    xb, lead = _blocks(x)
    d = (np.abs(xb).max(axis=-1).astype(F32) / F32(127.0)).astype(F32)
    q = roundf(xb * _safe_inv(d)[:, None]).astype(np.int8)
    out = np.empty(xb.shape[0], dtype=BLOCK_Q8_0)
    out["d"] = f16(d)
    out["qs"] = q
    return out.reshape(*lead, -1)


def quantize_q8_1(x: np.ndarray) -> np.ndarray:
    """q8_0 with an f32 d and s = d * sum(q) (ggml.c:1282-1316)."""
    xb, lead = _blocks(x)
    d = (np.abs(xb).max(axis=-1).astype(F32) / F32(127.0)).astype(F32)
    q = roundf(xb * _safe_inv(d)[:, None]).astype(np.int8)
    out = np.empty(xb.shape[0], dtype=BLOCK_Q8_1)
    out["d"] = d
    out["qs"] = q
    out["s"] = (q.sum(axis=-1, dtype=np.int32).astype(F32) * d).astype(F32)
    return out.reshape(*lead, -1)


def _unblock(y: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    """Flat (nb, qk) values back to the blocks' leading shape and a row."""
    if blocks.ndim == 1:
        return y.reshape(-1)
    return y.reshape(*blocks.shape[:-1], -1)


def dequantize_q4_0(blocks: np.ndarray) -> np.ndarray:
    b = blocks.reshape(-1)
    d = f16_to_f32(b["d"])[:, None]
    lo = (b["qs"] & 0x0F).astype(np.int32) - 8
    hi = (b["qs"] >> 4).astype(np.int32) - 8
    return _unblock(np.concatenate([lo, hi], axis=-1).astype(F32) * d, blocks)


def dequantize_q4_1(blocks: np.ndarray) -> np.ndarray:
    b = blocks.reshape(-1)
    d = f16_to_f32(b["d"])[:, None]
    m = f16_to_f32(b["m"])[:, None]
    q = np.concatenate([(b["qs"] & 0x0F).astype(F32), (b["qs"] >> 4).astype(F32)], axis=-1)
    return _unblock(q * d + m, blocks)


def _q5_levels(b: np.ndarray) -> np.ndarray:
    bits = _qh_bits(b["qh"])
    lo = (b["qs"] & 0x0F).astype(np.int32) | (bits[:, :16] << 4)
    hi = (b["qs"] >> 4).astype(np.int32) | (bits[:, 16:] << 4)
    return np.concatenate([lo, hi], axis=-1)


def dequantize_q5_0(blocks: np.ndarray) -> np.ndarray:
    b = blocks.reshape(-1)
    d = f16_to_f32(b["d"])[:, None]
    return _unblock((_q5_levels(b) - 16).astype(F32) * d, blocks)


def dequantize_q5_1(blocks: np.ndarray) -> np.ndarray:
    b = blocks.reshape(-1)
    d = f16_to_f32(b["d"])[:, None]
    m = f16_to_f32(b["m"])[:, None]
    return _unblock(_q5_levels(b).astype(F32) * d + m, blocks)


def dequantize_q8_0(blocks: np.ndarray) -> np.ndarray:
    b = blocks.reshape(-1)
    return _unblock(b["qs"].astype(F32) * f16_to_f32(b["d"])[:, None], blocks)


def dequantize_q8_1(blocks: np.ndarray) -> np.ndarray:
    b = blocks.reshape(-1)
    return _unblock(b["qs"].astype(F32) * b["d"].astype(F32)[:, None], blocks)
