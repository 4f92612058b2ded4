"""Planar repack of ggml blocks: every format into one schema.

    levels : int8 [N, K]        signed quant levels
    gscale : f32  [N, K/gsize]  per-group scale (super-block d folded in)
    gbias  : f32  [N, K/gsize]  per-group additive bias (min formats), or None

so that W[n, k] = levels[n, k] * gscale[n, k // gsize] + gbias[n, k // gsize].
Scale products (d * sc, -(dmin * m)) are taken in float32 as the reference
dequantizers take them.  Array for array the same as the JAX package's
``quant/pack.py`` (QK_K = 256 formats), with each planner working on all
blocks at once.  ``quantize_planar`` quantizes a float32 weight first.
``ops/qtensor.py`` turns a PlanarQuant into the device layout.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import blockq, kquants
from .types import QK_K, GGMLType, type_traits

F32 = np.float32


@dataclass
class PlanarQuant:
    """Quantized 2-D weight [N, K] (N = out rows, K = reduce) in planar form."""

    qtype: GGMLType
    shape: tuple[int, int]
    gsize: int
    levels: np.ndarray  # int8 [N, K]
    gscale: np.ndarray  # f32 [N, K // gsize]
    gbias: np.ndarray | None = None  # f32 [N, K // gsize]

    def dequantize(self) -> np.ndarray:
        n, k = self.shape
        w = self.levels.astype(F32).reshape(n, k // self.gsize, self.gsize)
        w = w * self.gscale[:, :, None]
        if self.gbias is not None:
            w = w + self.gbias[:, :, None]
        return w.reshape(n, k)


def _nib_lohi(qs: np.ndarray) -> np.ndarray:
    """ggml 32-block nibble order: byte j holds elements (j, j + 16)."""
    return np.concatenate([qs & 0x0F, qs >> 4], axis=-1).astype(np.int8)


def _f16(b, name):
    return blockq.f16_to_f32(b[name])


def _plan_q4_0(b):
    return _nib_lohi(b["qs"]) - 8, _f16(b, "d"), None, 32


def _plan_q4_1(b):
    return _nib_lohi(b["qs"]), _f16(b, "d"), _f16(b, "m"), 32


def _plan_q5_0(b):
    bits = blockq._qh_bits(b["qh"])
    q = _nib_lohi(b["qs"]) + (bits << 4).astype(np.int8) - 16
    return q, _f16(b, "d"), None, 32


def _plan_q5_1(b):
    bits = blockq._qh_bits(b["qh"])
    q = _nib_lohi(b["qs"]) + (bits << 4).astype(np.int8)
    return q, _f16(b, "d"), _f16(b, "m"), 32


def _plan_q8_0(b):
    return b["qs"].copy(), _f16(b, "d"), None, 32


def _plan_q2_K(b):
    L = kquants._unpack2(b["qs"]).astype(np.int8)
    sc = (b["scales"] & 0xF).astype(F32)
    mn = (b["scales"] >> 4).astype(F32)
    d = _f16(b, "d")[:, None]
    dmin = _f16(b, "dmin")[:, None]
    return L, d * sc, -(dmin * mn), 16


def _plan_q3_K(b):
    nb = b.shape[0]
    L = kquants._unpack2(b["qs"])
    # bit `bit` of hmask byte j is the high bit of element 32 * bit + j
    shifts = np.arange(8, dtype=np.uint8)[None, :, None]
    bits = ((b["hmask"][:, None, :] >> shifts) & 1).reshape(nb, QK_K)
    q = (L - np.where(bits == 1, 0, 4)).astype(np.int8)
    sc = kquants._q3_unpack_scales(b["scales"]).astype(F32)
    return q, _f16(b, "d")[:, None] * sc, None, 16


def _plan_q4_K(b):
    L = kquants._unpack_nibble_pairs(b["qs"]).astype(np.int8)
    sc, mn = kquants.unpack_scale_min_k4(b["scales"])
    d = _f16(b, "d")[:, None]
    dmin = _f16(b, "dmin")[:, None]
    return L, d * sc.astype(F32), -(dmin * mn.astype(F32)), 32


def _plan_q5_K(b):
    nb = b.shape[0]
    byte = b["qs"].reshape(nb, 4, 32)
    qh = b["qh"][:, None, :]
    seg = np.arange(4, dtype=np.uint8)[None, :, None]
    hi1 = (qh >> (2 * seg)) & 1
    hi2 = (qh >> (2 * seg + 1)) & 1
    # element seg*64 + j: low nibble + 16 * bit 2*seg of qh[j]; seg*64 + 32 + j:
    # high nibble + 16 * bit 2*seg + 1
    L = np.stack([(byte & 0xF) + 16 * hi1, (byte >> 4) + 16 * hi2], axis=2)
    sc, mn = kquants.unpack_scale_min_k4(b["scales"])
    d = _f16(b, "d")[:, None]
    dmin = _f16(b, "dmin")[:, None]
    return (L.reshape(nb, QK_K).astype(np.int8), d * sc.astype(F32),
            -(dmin * mn.astype(F32)), 32)


def _plan_q6_K(b):
    nb = b.shape[0]
    ql = b["ql"].reshape(nb, 2, 1, 2, 32)  # [half, -, a, j]: ql[half*64 + a*32 + j]
    qh = b["qh"].reshape(nb, 2, 1, 32)
    # part p = 2 * nibble + a of each 128-element half: element
    # half*128 + p*32 + j, with high bits 2p of qh[half*32 + j]
    low = np.concatenate([ql & 0xF, ql >> 4], axis=2).reshape(nb, 2, 4, 32)
    hb = (qh >> (2 * np.arange(4, dtype=np.uint8))[None, None, :, None]) & 3
    q = ((low | (hb << 4)).astype(np.int16) - 32).astype(np.int8)
    return q.reshape(nb, QK_K), _f16(b, "d")[:, None] * b["scales"].astype(F32), None, 16


_PLANNERS = {
    GGMLType.Q4_0: _plan_q4_0,
    GGMLType.Q4_1: _plan_q4_1,
    GGMLType.Q5_0: _plan_q5_0,
    GGMLType.Q5_1: _plan_q5_1,
    GGMLType.Q8_0: _plan_q8_0,
    GGMLType.Q2_K: _plan_q2_K,
    GGMLType.Q3_K: _plan_q3_K,
    GGMLType.Q4_K: _plan_q4_K,
    GGMLType.Q5_K: _plan_q5_K,
    GGMLType.Q6_K: _plan_q6_K,
}


PLANAR_TYPES = frozenset(_PLANNERS)


def pack_planar(blocks: np.ndarray, qtype: GGMLType,
                shape: tuple[int, int]) -> PlanarQuant:
    """Blocks of a [N, K] row-major weight -> planar layout."""
    if qtype not in PLANAR_TYPES:
        raise NotImplementedError(f"{qtype.name} weights are not ported")
    n, k = shape
    tr = type_traits(qtype)
    flat = blocks.reshape(-1)
    nbr = k // tr.block_size
    if k % tr.block_size or flat.shape[0] != n * nbr:
        raise ValueError(f"{flat.shape[0]} {tr.name} blocks do not hold [{n}, {k}]")
    levels, gscale_b, gbias_b, gsize = _PLANNERS[qtype](flat)
    groups = nbr * (tr.block_size // gsize)
    gscale = np.ascontiguousarray(gscale_b.reshape(n, groups), dtype=F32)
    gbias = None
    if gbias_b is not None:
        gbias = np.ascontiguousarray(gbias_b.reshape(n, groups), dtype=F32)
    return PlanarQuant(qtype, (n, k), gsize,
                       np.ascontiguousarray(levels.reshape(n, k)), gscale, gbias)


def quantize_planar(w: np.ndarray, qtype: GGMLType) -> PlanarQuant:
    """float32 [N, K] weight -> blocks of qtype -> planar layout."""
    from .registry import quantize

    n, k = w.shape
    return pack_planar(quantize(w, qtype), qtype, (n, k))
