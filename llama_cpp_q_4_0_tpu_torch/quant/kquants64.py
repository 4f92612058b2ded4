"""The k-quant super-blocks of the reference's ``-DGGML_QKK_64`` build
(QK_K = 64): quantizers and dequantizers of q2_K..q6_K and q8_K, and the
unpack helpers the planners of ``pack.py`` share.

The build switches every k-quant struct and several algorithms, not only the
packing (k_quants.c ``#if QK_K == 256 / #else``):

- q3_K: 4-bit block scales (iscale -8/max), two a byte (k_quants.c:471-498),
  not 6-bit triples;
- q4_K: two fp16 scales d[0] / d[1] with 4-bit block scale and min codes and
  a final weighted least-squares refinement of d[0] (k_quants.c:690-720);
- q5_K: symmetric, make_qx_quants(16, 16) with int8 block scales and no mins
  (k_quants.c:875-917), where the 256 build is affine.

The same vectorised-across-groups numpy as ``kquants.py``, the JAX package's
``quant/kquants64.py`` step for step: byte for byte its blocks.
"""

from __future__ import annotations

import numpy as np

from .blockq import f16, f16_to_f32
from .kquants import _group, make_q3_quants, make_qkx1_quants, make_qx_quants, nearest_int
from .types import (BLOCK_Q2_K64, BLOCK_Q3_K64, BLOCK_Q4_K64, BLOCK_Q5_K64, BLOCK_Q6_K64,
                    BLOCK_Q8_K64, GGMLType)

F32 = np.float32
QK_K64 = 64


def _pack2_64(L: np.ndarray) -> np.ndarray:
    """(nb, 64) 2-bit levels -> (nb, 16) bytes: qs[l] = L[l] | L[l+16]<<2 |
    L[l+32]<<4 | L[l+48]<<6 (k_quants.c:342-345 QKK_64 branch)."""
    nb = L.shape[0]
    q = np.zeros((nb, 16), dtype=np.uint8)
    Lu = L.astype(np.uint8)
    for sub in range(4):
        q |= Lu[:, 16 * sub : 16 * (sub + 1)] << (2 * sub)
    return q


def _unpack2_64(q: np.ndarray) -> np.ndarray:
    nb = q.shape[0]
    L = np.zeros((nb, 64), dtype=np.int32)
    for sub in range(4):
        L[:, 16 * sub : 16 * (sub + 1)] = (q >> (2 * sub)) & 3
    return L


# ---------------------------------------------------------------------------
# q2_K-64: same affine 16-groups as the 256 variant, 4 groups per block
# ---------------------------------------------------------------------------

def quantize_q2_K64(x: np.ndarray) -> np.ndarray:
    xb = np.ascontiguousarray(x, dtype=F32).reshape(-1, QK_K64)
    nb = xb.shape[0]
    scales, mins, L0 = make_qkx1_quants(_group(xb, 16), 3, ntry=5)
    scales = scales.reshape(nb, 4)
    mins = mins.reshape(nb, 4)
    L = L0.reshape(nb, QK_K64)

    q4scale = F32(15.0)
    max_scale = np.maximum(scales.max(axis=1), F32(0.0))
    max_min = np.maximum(mins.max(axis=1), F32(0.0))

    out = np.zeros(nb, dtype=BLOCK_Q2_K64)
    sc4 = np.zeros((nb, 4), dtype=np.int32)
    mn4 = np.zeros((nb, 4), dtype=np.int32)
    pos_s = max_scale > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        isc = (q4scale / max_scale).astype(F32)
        imn = (q4scale / max_min).astype(F32)
    sc4[pos_s] = nearest_int(isc[pos_s, None] * scales[pos_s])
    d = np.where(pos_s, (max_scale / q4scale).astype(F32), F32(0.0))
    pos_m = max_min > 0
    mn4[pos_m] = nearest_int(imn[pos_m, None] * mins[pos_m])
    dmin = np.where(pos_m, (max_min / q4scale).astype(F32), F32(0.0))
    out["d"] = f16(d)
    out["dmin"] = f16(dmin)
    out["scales"] = sc4.astype(np.uint8) | (mn4.astype(np.uint8) << 4)

    df = f16_to_f32(out["d"])[:, None] * (out["scales"] & 0xF).astype(F32)
    dmf = f16_to_f32(out["dmin"])[:, None] * (out["scales"] >> 4).astype(F32)
    xg = xb.reshape(nb, 4, 16)
    with np.errstate(divide="ignore", invalid="ignore"):
        lq = nearest_int((xg + dmf[:, :, None]) / df[:, :, None])
    lq = np.clip(lq, 0, 3)
    keep = (df != 0)[:, :, None]
    L = np.where(keep, lq, L.reshape(nb, 4, 16)).reshape(nb, QK_K64)
    out["qs"] = _pack2_64(L)
    return out.reshape(*x.shape[:-1], -1) if x.ndim > 1 else out


def dequantize_q2_K64(blocks: np.ndarray) -> np.ndarray:
    b = blocks.reshape(-1)
    nb = b.shape[0]
    d = f16_to_f32(b["d"])[:, None]
    dmin = f16_to_f32(b["dmin"])[:, None]
    sc = (b["scales"] & 0xF).astype(F32)
    mn = (b["scales"] >> 4).astype(F32)
    L = _unpack2_64(b["qs"]).reshape(nb, 4, 16).astype(F32)
    y = (d * sc)[:, :, None] * L - (dmin * mn)[:, :, None]
    y = y.reshape(nb, QK_K64)
    return y.reshape(-1) if blocks.ndim == 1 else y.reshape(*blocks.shape[:-1], -1)


# ---------------------------------------------------------------------------
# q3_K-64: make_q3_quants groups; 4-bit paired scales (k_quants.c:471-498)
# ---------------------------------------------------------------------------

def quantize_q3_K64(x: np.ndarray) -> np.ndarray:
    xb = np.ascontiguousarray(x, dtype=F32).reshape(-1, QK_K64)
    nb = xb.shape[0]
    scales, L0 = make_q3_quants(_group(xb, 16), 4)
    scales = scales.reshape(nb, 4)
    L = L0.reshape(nb, QK_K64)

    idx = np.argmax(np.abs(scales), axis=1)
    max_scale = scales[np.arange(nb), idx]
    nonzero = max_scale != 0

    out = np.zeros(nb, dtype=BLOCK_Q3_K64)
    with np.errstate(divide="ignore", invalid="ignore"):
        iscale = (F32(-8.0) / max_scale).astype(F32)
    l4 = np.zeros((nb, 4), dtype=np.int32)
    l4[nonzero] = 8 + np.clip(
        nearest_int(iscale[nonzero, None] * scales[nonzero]), -8, 7)
    out["scales"] = (l4[:, 0::2] | (l4[:, 1::2] << 4)).astype(np.uint8)
    with np.errstate(divide="ignore", invalid="ignore"):
        dval = np.where(nonzero, (F32(1.0) / iscale).astype(F32), F32(0.0))
    out["d"] = f16(dval)

    # requantize with the decoded 4-bit scales (s - 8)
    df = f16_to_f32(out["d"])[:, None] * _q3_scales_64(out["scales"]).astype(F32)
    xg = xb.reshape(nb, 4, 16)
    with np.errstate(divide="ignore", invalid="ignore"):
        lq = np.clip(nearest_int(xg / df[:, :, None]), -4, 3) + 4
    keep = (df != 0)[:, :, None]
    L = np.where(keep, lq, L.reshape(nb, 4, 16)).reshape(nb, QK_K64)

    # hmask: bit (j//8) of hmask[j%8] set iff L[j] > 3 (generic m/hm loop)
    high = L > 3
    L = np.where(high, L - 4, L)
    hmask = np.zeros((nb, 8), dtype=np.uint8)
    for bit in range(8):
        hmask |= high[:, bit * 8 : (bit + 1) * 8].astype(np.uint8) << bit
    out["hmask"] = hmask
    out["qs"] = _pack2_64(L)
    return out.reshape(*x.shape[:-1], -1) if x.ndim > 1 else out


def _q3_scales_64(scales: np.ndarray) -> np.ndarray:
    """(nb, 2) bytes -> (nb, 4) int32 signed scales: 4-bit codes, two a
    byte (low nibble first), less 8."""
    s_lo = (scales[:, [0, 0, 1, 1]] >> np.array([0, 4, 0, 4])) & 0xF
    return s_lo.astype(np.int32) - 8


def _q3_levels_64(b: np.ndarray) -> np.ndarray:
    """(nb, 64) signed q3_K levels: the 2-bit value less 4 where the
    element's hmask bit (bit j // 8 of byte j % 8) is clear."""
    nb = b.shape[0]
    shifts = np.arange(8, dtype=np.uint8)[None, :, None]
    bits = ((b["hmask"][:, None, :] >> shifts) & 1).reshape(nb, QK_K64)
    return _unpack2_64(b["qs"]) - np.where(bits == 1, 0, 4)


def dequantize_q3_K64(blocks: np.ndarray) -> np.ndarray:
    b = blocks.reshape(-1)
    nb = b.shape[0]
    d_all = f16_to_f32(b["d"])[:, None]
    sc = _q3_scales_64(b["scales"]).astype(F32)
    q = _q3_levels_64(b)
    y = (d_all * sc)[:, :, None] * q.reshape(nb, 4, 16).astype(F32)
    y = y.reshape(nb, QK_K64)
    return y.reshape(-1) if blocks.ndim == 1 else y.reshape(*blocks.shape[:-1], -1)


# ---------------------------------------------------------------------------
# q4_K-64: two fp16 scales + 4-bit codes + d[0] WLS refinement
# (k_quants.c:690-720)
# ---------------------------------------------------------------------------

def quantize_q4_K64(x: np.ndarray) -> np.ndarray:
    xb = np.ascontiguousarray(x, dtype=F32).reshape(-1, QK_K64)
    nb = xb.shape[0]
    scales, mins, L0 = make_qkx1_quants(_group(xb, 32), 15, ntry=5)
    scales = scales.reshape(nb, 2)
    mins = mins.reshape(nb, 2)
    L = L0.reshape(nb, QK_K64)

    s_factor = F32(15.0)
    max_scale = np.maximum(scales.max(axis=1), F32(0.0))
    max_min = np.maximum(mins.max(axis=1), F32(0.0))
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_scale = np.where(max_scale > 0, s_factor / max_scale, F32(0.0)).astype(F32)
        inv_min = np.where(max_min > 0, s_factor / max_min, F32(0.0)).astype(F32)
    dq = nearest_int(inv_scale[:, None] * scales)
    mq = nearest_int(inv_min[:, None] * mins)
    out = np.zeros(nb, dtype=BLOCK_Q4_K64)
    out["scales"] = (dq.astype(np.uint8) | (mq.astype(np.uint8) << 4))
    out["d"][:, 0] = f16((max_scale / s_factor).astype(F32))
    out["d"][:, 1] = f16((max_min / s_factor).astype(F32))

    # requantize + weighted-LS refinement of d[0] over both groups,
    # preserving C accumulation order (float sumlx, int suml2)
    sd = (out["scales"] & 0xF).astype(np.int32)          # (nb, 2)
    sm = (out["scales"] >> 4).astype(np.int32)
    d0 = f16_to_f32(out["d"][:, 0])
    d1 = f16_to_f32(out["d"][:, 1])
    sumlx = np.zeros(nb, dtype=F32)
    suml2 = np.zeros(nb, dtype=np.int64)
    Lg = L.reshape(nb, 2, 32)
    xg = xb.reshape(nb, 2, 32)
    for j in range(2):
        dj = (d0 * sd[:, j].astype(F32)).astype(F32)
        mj = (d1 * sm[:, j].astype(F32)).astype(F32)
        active = dj != 0
        with np.errstate(divide="ignore", invalid="ignore"):
            lq = np.clip(nearest_int((xg[:, j] + mj[:, None]) / dj[:, None]),
                         0, 15)
        Lg[:, j] = np.where(active[:, None], lq, Lg[:, j])
        lf = Lg[:, j].astype(F32)
        sdf = sd[:, j].astype(F32)
        for ii in range(32):
            t = ((xg[:, j, ii] + mj) * lf[:, ii]).astype(F32)
            term = (t * sdf).astype(F32)
            sumlx = np.where(active, (sumlx + term).astype(F32), sumlx)
            suml2 = np.where(
                active,
                suml2 + (Lg[:, j, ii] * Lg[:, j, ii]
                         * sd[:, j] * sd[:, j]).astype(np.int64),
                suml2)
    refit = suml2 != 0
    with np.errstate(divide="ignore", invalid="ignore"):
        newd = (sumlx / suml2.astype(F32)).astype(F32)
    out["d"][:, 0] = np.where(refit, f16(newd), out["d"][:, 0])

    L = Lg.reshape(nb, QK_K64)
    out["qs"] = (L[:, :32] | (L[:, 32:] << 4)).astype(np.uint8)
    return out.reshape(*x.shape[:-1], -1) if x.ndim > 1 else out


def dequantize_q4_K64(blocks: np.ndarray) -> np.ndarray:
    b = blocks.reshape(-1)
    nb = b.shape[0]
    dall = f16_to_f32(b["d"][:, 0])[:, None]
    mall = f16_to_f32(b["d"][:, 1])[:, None]
    sd = (b["scales"] & 0xF).astype(F32)
    sm = (b["scales"] >> 4).astype(F32)
    q = b["qs"]
    y = np.zeros((nb, QK_K64), dtype=F32)
    y[:, :32] = (dall * sd[:, :1]) * (q & 0xF).astype(F32) - mall * sm[:, :1]
    y[:, 32:] = (dall * sd[:, 1:]) * (q >> 4).astype(F32) - mall * sm[:, 1:]
    return y.reshape(-1) if blocks.ndim == 1 else y.reshape(*blocks.shape[:-1], -1)


# ---------------------------------------------------------------------------
# q5_K-64: SYMMETRIC make_qx_quants(16, 16), int8 scales (k_quants.c:875-917)
# ---------------------------------------------------------------------------

def quantize_q5_K64(x: np.ndarray) -> np.ndarray:
    xb = np.ascontiguousarray(x, dtype=F32).reshape(-1, QK_K64)
    nb = xb.shape[0]
    scales, L0 = make_qx_quants(_group(xb, 16), 16, rmse_type=1)
    scales = scales.reshape(nb, 4)
    L = L0.reshape(nb, QK_K64)

    idx = np.argmax(np.abs(scales), axis=1)
    max_scale = scales[np.arange(nb), idx]
    zero = max_scale == 0
    with np.errstate(divide="ignore", invalid="ignore"):
        iscale = (F32(-128.0) / max_scale).astype(F32)
    out = np.zeros(nb, dtype=BLOCK_Q5_K64)
    sc8 = np.zeros((nb, 4), dtype=np.int32)
    sc8[~zero] = np.clip(nearest_int(iscale[~zero, None] * scales[~zero]),
                         -128, 127)
    out["scales"] = sc8.astype(np.int8)
    with np.errstate(divide="ignore", invalid="ignore"):
        out["d"] = f16(np.where(zero, F32(0.0), F32(1.0) / iscale).astype(F32))

    df = f16_to_f32(out["d"])[:, None] * sc8.astype(F32)
    xg = xb.reshape(nb, 4, 16)
    with np.errstate(divide="ignore", invalid="ignore"):
        lq = np.clip(nearest_int(xg / df[:, :, None]), -16, 15) + 16
    keep = (df != 0)[:, :, None]
    L = np.where(keep, lq, L.reshape(nb, 4, 16)).reshape(nb, QK_K64)

    # pack: ql[j] = l1|l2<<4; qh[j%8] bits j//8 (l1) and 4+j//8 (l2)
    qh = np.zeros((nb, 8), dtype=np.uint8)
    l1 = L[:, :32]
    l2 = L[:, 32:]
    hi1 = (l1 > 15).astype(np.uint8)
    hi2 = (l2 > 15).astype(np.uint8)
    for is_ in range(4):
        sl = slice(is_ * 8, (is_ + 1) * 8)
        qh |= hi1[:, sl] << is_
        qh |= hi2[:, sl] << (4 + is_)
    out["qh"] = qh
    out["qs"] = ((l1 - 16 * hi1.astype(np.int32))
                 | ((l2 - 16 * hi2.astype(np.int32)) << 4)).astype(np.uint8)
    return out.reshape(*x.shape[:-1], -1) if x.ndim > 1 else out


def _q5_levels_64(b: np.ndarray) -> np.ndarray:
    """(nb, 64) signed q5_K levels: element 8 * i + j (i < 4, j < 8) is the
    low nibble of qs[8 * i + j] less 16 where bit i of qh[j] is clear,
    element 32 + 8 * i + j its high nibble with bit 4 + i (the +16 offset
    dropped where the bit is set, k_quants.c:1020-1031)."""
    nb = b.shape[0]
    qs = b["qs"].reshape(nb, 4, 8).astype(np.int32)
    qh = b["qh"][:, None, :]
    i = np.arange(4, dtype=np.uint8)[None, :, None]
    lo = (qs & 0xF) - 16 * (1 - ((qh >> i) & 1).astype(np.int32))
    hi = (qs >> 4) - 16 * (1 - ((qh >> (4 + i)) & 1).astype(np.int32))
    return np.concatenate([lo.reshape(nb, 32), hi.reshape(nb, 32)], axis=1)


def dequantize_q5_K64(blocks: np.ndarray) -> np.ndarray:
    b = blocks.reshape(-1)
    d = f16_to_f32(b["d"])[:, None]
    s = b["scales"].astype(F32)  # (nb, 4)
    y = (d * np.repeat(s, 16, axis=1)) * _q5_levels_64(b).astype(F32)
    return y.reshape(-1) if blocks.ndim == 1 else y.reshape(*blocks.shape[:-1], -1)


# ---------------------------------------------------------------------------
# q6_K-64: same algorithm as the 256 variant, 4 groups; different packing
# ---------------------------------------------------------------------------

def quantize_q6_K64(x: np.ndarray) -> np.ndarray:
    xb = np.ascontiguousarray(x, dtype=F32).reshape(-1, QK_K64)
    nb = xb.shape[0]
    scales, L0 = make_qx_quants(_group(xb, 16), 32, rmse_type=1)
    scales = scales.reshape(nb, 4)
    L = L0.reshape(nb, QK_K64)

    idx = np.argmax(np.abs(scales), axis=1)
    max_scale = scales[np.arange(nb), idx]
    zero = max_scale == 0
    with np.errstate(divide="ignore", invalid="ignore"):
        iscale = (F32(-128.0) / max_scale).astype(F32)
    out = np.zeros(nb, dtype=BLOCK_Q6_K64)
    with np.errstate(divide="ignore", invalid="ignore"):
        out["d"] = f16(np.where(zero, F32(0.0), F32(1.0) / iscale).astype(F32))
        sc8 = np.minimum(127, nearest_int(
            np.where(zero, F32(0.0), iscale)[:, None] * scales)).astype(np.int8)
    out["scales"] = sc8

    df = f16_to_f32(out["d"])[:, None] * sc8.astype(F32)
    xg = xb.reshape(nb, 4, 16)
    with np.errstate(divide="ignore", invalid="ignore"):
        lq = np.clip(nearest_int(xg / df[:, :, None]), -32, 31) + 32
    keep = (df != 0)[:, :, None]
    L = np.where(keep, lq, L.reshape(nb, 4, 16)).reshape(nb, QK_K64)

    Lu = L.astype(np.uint8)
    out["ql"] = (Lu[:, :32] & 0xF) | ((Lu[:, 32:] & 0xF) << 4)
    out["qh"] = ((Lu[:, :16] >> 4) | ((Lu[:, 16:32] >> 4) << 2)
                 | ((Lu[:, 32:48] >> 4) << 4) | ((Lu[:, 48:] >> 4) << 6))
    return out.reshape(*x.shape[:-1], -1) if x.ndim > 1 else out


def _q6_levels_64(b):
    """(nb, 64) signed q6_K levels (q - 32)."""
    nb = b.shape[0]
    ql = b["ql"].astype(np.int32)
    qh = b["qh"].astype(np.int32)
    q = np.zeros((nb, QK_K64), dtype=np.int32)
    q[:, :16] = ((ql[:, :16] & 0xF) | (((qh >> 0) & 3) << 4)) - 32
    q[:, 16:32] = ((ql[:, 16:] & 0xF) | (((qh >> 2) & 3) << 4)) - 32
    q[:, 32:48] = ((ql[:, :16] >> 4) | (((qh >> 4) & 3) << 4)) - 32
    q[:, 48:] = ((ql[:, 16:] >> 4) | (((qh >> 6) & 3) << 4)) - 32
    return q


def dequantize_q6_K64(blocks: np.ndarray) -> np.ndarray:
    b = blocks.reshape(-1)
    nb = b.shape[0]
    d = f16_to_f32(b["d"])[:, None]
    sc = b["scales"].astype(F32)
    q = _q6_levels_64(b)
    y = (d * np.repeat(sc, 16, axis=1)) * q.astype(F32)
    return y.reshape(-1) if blocks.ndim == 1 else y.reshape(*blocks.shape[:-1], -1)


# ---------------------------------------------------------------------------
# q8_K-64: activation-side format (same algorithm, 64-elem blocks)
# ---------------------------------------------------------------------------

def quantize_q8_K64(x: np.ndarray) -> np.ndarray:
    xb = np.ascontiguousarray(x, dtype=F32).reshape(-1, QK_K64)
    nb = xb.shape[0]
    idx = np.argmax(np.abs(xb), axis=1)
    mx = xb[np.arange(nb), idx].astype(F32)
    zero = np.abs(mx) == 0
    with np.errstate(divide="ignore", invalid="ignore"):
        iscale = (F32(-128.0) / mx).astype(F32)
    q = np.minimum(127, nearest_int(iscale[:, None] * xb))
    q = np.where(zero[:, None], 0, q).astype(np.int8)
    out = np.zeros(nb, dtype=BLOCK_Q8_K64)
    out["qs"] = q
    out["bsums"] = q.reshape(nb, 4, 16).astype(np.int32).sum(axis=2).astype(np.int16)
    with np.errstate(divide="ignore", invalid="ignore"):
        out["d"] = np.where(zero, F32(0.0), (F32(1.0) / iscale).astype(F32))
    return out.reshape(*x.shape[:-1], -1) if x.ndim > 1 else out


def dequantize_q8_K64(blocks: np.ndarray) -> np.ndarray:
    b = blocks.reshape(-1)
    y = b["qs"].astype(F32) * b["d"].astype(F32)[:, None]
    return y.reshape(-1) if blocks.ndim == 1 else y.reshape(*blocks.shape[:-1], -1)


# ---------------------------------------------------------------------------
# registry for the QKK_64 build variant
# ---------------------------------------------------------------------------

QUANT_FNS_64 = {
    GGMLType.Q2_K: (quantize_q2_K64, dequantize_q2_K64, BLOCK_Q2_K64),
    GGMLType.Q3_K: (quantize_q3_K64, dequantize_q3_K64, BLOCK_Q3_K64),
    GGMLType.Q4_K: (quantize_q4_K64, dequantize_q4_K64, BLOCK_Q4_K64),
    GGMLType.Q5_K: (quantize_q5_K64, dequantize_q5_K64, BLOCK_Q5_K64),
    GGMLType.Q6_K: (quantize_q6_K64, dequantize_q6_K64, BLOCK_Q6_K64),
    GGMLType.Q8_K: (quantize_q8_K64, dequantize_q8_K64, BLOCK_Q8_K64),
}
