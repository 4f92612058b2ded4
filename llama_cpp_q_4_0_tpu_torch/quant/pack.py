"""Planar repack of ggml blocks: every format into one schema.

    levels : int8 [N, K]        signed quant levels
    gscale : f32  [N, K/gsize]  per-group scale (super-block d folded in)
    gbias  : f32  [N, K/gsize]  per-group additive bias (min formats), or None

so that W[n, k] = levels[n, k] * gscale[n, k // gsize] + gbias[n, k // gsize].
Scale products (d * sc, -(dmin * m)) are taken in float32 as the reference
dequantizers take them.  Array for array the same as the JAX package's
``quant/pack.py``, the k-quants in both super-block builds (``qk_k`` 256 or
64), with each planner working on all blocks at once.  ``quantize_planar``
quantizes a float32 weight first.
``ops/qtensor.py`` turns a PlanarQuant into the device layout.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import blockq, kquants, kquants64
from .types import GGMLType, type_traits

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


def _q2_planes(b, L):
    """q2_K's 16-groups: 4-bit scale and min codes times d and dmin."""
    sc = (b["scales"] & 0xF).astype(F32)
    mn = (b["scales"] >> 4).astype(F32)
    d = _f16(b, "d")[:, None]
    dmin = _f16(b, "dmin")[:, None]
    return L.astype(np.int8), d * sc, -(dmin * mn), 16


def _int8_scaled(b, q):
    """Symmetric 16-groups: the levels times d times each group's int8
    scale (q6_K; q5_K at QK_K = 64)."""
    return q.astype(np.int8), _f16(b, "d")[:, None] * b["scales"].astype(F32), None, 16


def _plan_q2_K(b):
    return _q2_planes(b, kquants._unpack2(b["qs"]))


def _plan_q3_K(b):
    sc = kquants._q3_unpack_scales(b["scales"]).astype(F32)
    return kquants._q3_levels(b).astype(np.int8), _f16(b, "d")[:, None] * sc, None, 16


def _affine_32(b, L):
    """q4_K / q5_K's 32-groups: 6-bit scale and min codes times d and dmin."""
    sc, mn = kquants.unpack_scale_min_k4(b["scales"])
    d = _f16(b, "d")[:, None]
    dmin = _f16(b, "dmin")[:, None]
    return L.astype(np.int8), d * sc.astype(F32), -(dmin * mn.astype(F32)), 32


def _plan_q4_K(b):
    return _affine_32(b, kquants._unpack_nibble_pairs(b["qs"]))


def _plan_q5_K(b):
    return _affine_32(b, kquants._q5_levels(b))


def _plan_q6_K(b):
    return _int8_scaled(b, kquants._q6_levels(b))


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


# the QK_K = 64 super-blocks, into the same schema: q2_K and q4_K affine
# (16- and 32-groups), q3_K, q5_K and q6_K symmetric over 16-groups


def _plan_q2_K64(b):
    return _q2_planes(b, kquants64._unpack2_64(b["qs"]))


def _plan_q3_K64(b):
    sc = kquants64._q3_scales_64(b["scales"]).astype(F32)
    return kquants64._q3_levels_64(b).astype(np.int8), _f16(b, "d")[:, None] * sc, None, 16


def _plan_q4_K64(b):
    q = b["qs"]
    L = np.concatenate([q & 0xF, q >> 4], axis=-1).astype(np.int8)
    sd = (b["scales"] & 0xF).astype(F32)
    sm = (b["scales"] >> 4).astype(F32)
    dall = blockq.f16_to_f32(b["d"][:, 0])[:, None]
    mall = blockq.f16_to_f32(b["d"][:, 1])[:, None]
    return L, dall * sd, -(mall * sm), 32


def _plan_q5_K64(b):
    return _int8_scaled(b, kquants64._q5_levels_64(b))


def _plan_q6_K64(b):
    return _int8_scaled(b, kquants64._q6_levels_64(b))


_PLANNERS_64 = {
    GGMLType.Q2_K: _plan_q2_K64,
    GGMLType.Q3_K: _plan_q3_K64,
    GGMLType.Q4_K: _plan_q4_K64,
    GGMLType.Q5_K: _plan_q5_K64,
    GGMLType.Q6_K: _plan_q6_K64,
}

PLANAR_TYPES = frozenset(_PLANNERS)


def pack_planar(blocks: np.ndarray, qtype: GGMLType, shape: tuple[int, int],
                qk_k: int = 256) -> PlanarQuant:
    """Blocks of a [N, K] row-major weight -> planar layout; qk_k is the
    k-quant super-block build that wrote them."""
    if qtype not in PLANAR_TYPES:
        raise NotImplementedError(f"{qtype.name} weights are not ported")
    n, k = shape
    tr = type_traits(qtype, qk_k)
    flat = blocks.reshape(-1)
    nbr = k // tr.block_size
    if k % tr.block_size or flat.shape[0] != n * nbr:
        raise ValueError(f"{flat.shape[0]} {tr.name} blocks do not hold [{n}, {k}]")
    planner = _PLANNERS_64.get(qtype) if qk_k == 64 else None
    levels, gscale_b, gbias_b, gsize = (planner or _PLANNERS[qtype])(flat)
    groups = nbr * (tr.block_size // gsize)
    gscale = np.ascontiguousarray(gscale_b.reshape(n, groups), dtype=F32)
    gbias = None
    if gbias_b is not None:
        gbias = np.ascontiguousarray(gbias_b.reshape(n, groups), dtype=F32)
    return PlanarQuant(qtype, (n, k), gsize,
                       np.ascontiguousarray(levels.reshape(n, k)), gscale, gbias)


def quantize_planar(w: np.ndarray, qtype: GGMLType, qk_k: int = 256) -> PlanarQuant:
    """float32 [N, K] weight -> blocks of qtype -> planar layout."""
    from .registry import quantize

    n, k = w.shape
    return pack_planar(quantize(w, qtype, qk_k), qtype, (n, k), qk_k)
