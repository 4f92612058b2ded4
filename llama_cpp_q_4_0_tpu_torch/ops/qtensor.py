"""QTensor: a quantized 2-D weight on a device, in planar layout.

The logical weight is W [N, K] (ggml row-major: N output rows, K the reduce
dim), stored transposed (K-major) in one of two forms.

Unpacked (``pack_zero`` None; 5-bit and wider levels: q5_0, q5_1, q8_0,
q5_K, q6_K):

  levels_t int8 [K, N];  W[n, k] = levels_t[k, n] * gscale_t[k // g, n]
                                   (+ gbias_t[k // g, n])
  gscale_t, gbias_t [K/g, N].

Packed (levels spanning at most 16 values: q4_0, q4_1, q2_K, q3_K, q4_K),
split-half nibbles:

  levels_t uint8 [K2P, N], K2P = K/2 rounded up to 256 (zero padding rows);
  level(k) = (byte[k, n] & 0xF) - pack_zero          for k <  K/2
           = (byte[k - K/2, n] >> 4) - pack_zero     for k >= K/2
  gscale_t, gbias_t f32 [2, K2P/g, N]: plane 0 holds the low panel's groups,
  plane 1 the high panel's; padding rows are zero.

The planes are float32, float16 or bfloat16, one dtype for all planes of a
tensor (``cast_scales_f16`` and ``cast_scales_bf16`` below make the 2-byte
ones); every host-side reader widens them to f32, exactly.  ``gbias_t`` is
None for the symmetric formats.  Split-half (not adjacent
pairs) so a kernel unpacks with one mask and one shift and each nibble plane
is a contiguous K panel.  The JAX package's ``ops/qtensor.py`` without the
pytree registration.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..quant.pack import PlanarQuant, quantize_planar
from ..quant.types import GGMLType


@dataclass
class QTensor:
    levels_t: torch.Tensor  # int8 [K, N] | uint8 [K2P, N] when packed
    gscale_t: torch.Tensor  # f32/f16/bf16 [K // gsize, N] | [2, K2P // gsize, N] packed
    gsize: int
    qtype: GGMLType
    shape: tuple[int, int]  # (N, K)
    pack_zero: int | None = None  # nibble bias; None = unpacked int8
    gbias_t: torch.Tensor | None = None  # gscale_t's dtype and shape rule

    @property
    def n_out(self) -> int:
        return self.shape[0]

    @property
    def n_in(self) -> int:
        return self.shape[1]

    @property
    def packed(self) -> bool:
        return self.pack_zero is not None

    @property
    def device(self) -> torch.device:
        return self.levels_t.device

    @staticmethod
    def from_planar(p: PlanarQuant, device=None) -> "QTensor":
        """Device layout of a planar weight, byte for byte the JAX package's
        ``QTensor.from_planar``: packed when each half panel holds whole groups
        and the levels span at most 16 values, with pack_zero = -min(level).
        The transposes and the packing run on ``device`` (cuda unless named;
        integer ops, so exact on either)."""
        device = resolve_device(device)

        def put_t(a):  # [N, X] host array -> contiguous [X, N] on the device
            return torch.from_numpy(np.ascontiguousarray(a)).to(device).T.contiguous()

        lv, gs = put_t(p.levels), put_t(p.gscale)  # [K, N] int8, [K/gsize, N] f32
        gb = put_t(p.gbias) if p.gbias is not None else None
        k, n = lv.shape
        pack_zero = None
        if k % 2 == 0 and (k // 2) % p.gsize == 0:
            lo, hi = int(lv.min()), int(lv.max())
            if hi - lo <= 15:
                pack_zero = -lo
                k2 = k // 2
                k2p = -(-k2 // 256) * 256
                packed = torch.zeros((k2p, n), dtype=torch.uint8, device=lv.device)
                packed[:k2] = (((lv[k2:].to(torch.int16) + pack_zero) << 4)
                               | (lv[:k2].to(torch.int16) + pack_zero)).to(torch.uint8)
                g2, g2p = k2 // p.gsize, k2p // p.gsize

                def planes(a):
                    out = torch.zeros((2, g2p, n), dtype=torch.float32, device=a.device)
                    out[0, :g2] = a[:g2]
                    out[1, :g2] = a[g2:]
                    return out

                lv, gs = packed, planes(gs)
                gb = planes(gb) if gb is not None else None
        return QTensor(levels_t=lv, gscale_t=gs, gsize=p.gsize, qtype=p.qtype,
                       shape=tuple(p.shape), pack_zero=pack_zero, gbias_t=gb)

    @staticmethod
    def quantize(w: np.ndarray, qtype: GGMLType, device=None) -> "QTensor":
        """A float32 [N, K] weight quantized to qtype and laid out on
        ``device`` (cuda unless named), as the JAX ``QTensor.quantize``."""
        return QTensor.from_planar(quantize_planar(np.asarray(w, np.float32), qtype),
                                   device=device)

    def to(self, device) -> "QTensor":
        return dataclasses.replace(
            self, levels_t=self.levels_t.to(device),
            gscale_t=self.gscale_t.to(device),
            gbias_t=None if self.gbias_t is None else self.gbias_t.to(device))

    def _panels(self, t: torch.Tensor) -> torch.Tensor:
        """[2, G2P, ...] planes -> the logical [K/gsize, ...] groups."""
        g2 = (self.shape[1] // 2) // self.gsize
        return torch.cat([t[0, :g2], t[1, :g2]], dim=0)

    def _unpack(self, p: torch.Tensor) -> torch.Tensor:
        """Packed rows [K2P, ...] -> int16 levels [K, ...]."""
        k2 = self.shape[1] // 2
        p = p[:k2].to(torch.int16)
        return torch.cat([(p & 0xF) - self.pack_zero,
                          (p >> 4) - self.pack_zero], dim=0)

    def levels_full(self) -> torch.Tensor:
        """Unpacked int8 levels [K, N]."""
        if not self.packed:
            return self.levels_t
        return self._unpack(self.levels_t).to(torch.int8)

    def gscale_full(self) -> torch.Tensor:
        """Group scales in logical [K/gsize, N] order, f32."""
        return (self._panels(self.gscale_t) if self.packed else self.gscale_t).float()

    def gbias_full(self) -> torch.Tensor | None:
        if self.gbias_t is None:
            return None
        return (self._panels(self.gbias_t) if self.packed else self.gbias_t).float()

    def fold_zero(self) -> "QTensor":
        """The JAX ``QTensor.fold_zero``: a packed tensor's symmetric pack zero
        becomes the affine bias plane gbias = d * -zero (computed in f32, stored
        in the planes' dtype; exact, -zero * d is d shifted by a small
        integer multiple), with pack zero 0, so that w = d * nib + gbias.  The
        levels and scale planes are shared, not copied.  A tensor that is
        unpacked, has pack zero 0 or already has a bias is returned as is."""
        if not self.packed or not self.pack_zero or self.gbias_t is not None:
            return self
        gb = (self.gscale_t.float() * float(-self.pack_zero)).to(self.gscale_t.dtype)
        return dataclasses.replace(self, gbias_t=gb, pack_zero=0)

    def scales_f16(self) -> "QTensor":
        """The JAX ``QTensor.scales_f16``: the scale (and bias) planes stored
        as float16, half their bytes.  Exact for the block formats, whose d
        (and m) the file holds as fp16 (``_F16_EXACT_QTYPES``); the levels
        are shared."""
        if self.gscale_t.dtype == torch.float16:
            return self
        return dataclasses.replace(
            self, gscale_t=self.gscale_t.to(torch.float16),
            gbias_t=None if self.gbias_t is None else self.gbias_t.to(torch.float16))

    def dequantize_t(self, dtype=torch.float32) -> torch.Tensor:
        """W^T [K, N] (the matmul-ready orientation)."""
        n, k = self.shape
        g = k // self.gsize
        w = self.levels_full().float().reshape(g, self.gsize, n)
        w = w * self.gscale_full()[:, None, :]
        gb = self.gbias_full()
        if gb is not None:
            w = w + gb[:, None, :]
        return w.reshape(k, n).to(dtype)

    def rows(self, idx: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        """Gather and dequantize logical rows: idx [...] -> [..., K]
        (ggml_get_rows, the embedding lookup)."""
        k = self.shape[1]
        flat = idx.reshape(-1)
        if self.packed:
            lv = self._unpack(self.levels_t[:, flat]).float()  # [K, M]
        else:
            lv = self.levels_t[:, flat].float()
        g = k // self.gsize
        w = lv.reshape(g, self.gsize, -1) * self.gscale_full()[:, flat][:, None, :]
        gb = self.gbias_full()
        if gb is not None:
            w = w + gb[:, flat][:, None, :]
        return w.reshape(k, -1).T.reshape(*idx.shape, k).to(dtype)


# Formats whose group scales are the file's fp16 d (and m), so that f16
# planes hold them exactly (the JAX package's _F16_EXACT_QTYPES).  Not the
# k-quants: their scale is d times a 6-bit sub-scale, a product fp16 may not
# hold.
_F16_EXACT_QTYPES = frozenset((GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0,
                               GGMLType.Q5_1, GGMLType.Q8_0))


def _map_qtensors(params, fn):
    """fn applied to every QTensor of params (a TransformerParams, a Block, a
    QTensor, or a list, tuple or dict of them); every other leaf is kept."""
    if isinstance(params, QTensor):
        return fn(params)
    if dataclasses.is_dataclass(params) and not isinstance(params, type):
        return dataclasses.replace(params, **{
            f.name: _map_qtensors(getattr(params, f.name), fn)
            for f in dataclasses.fields(params)})
    if isinstance(params, (list, tuple)):
        return type(params)(_map_qtensors(v, fn) for v in params)
    if isinstance(params, dict):
        return {k: _map_qtensors(v, fn) for k, v in params.items()}
    return params


def cast_scales_bf16(params):
    """The JAX ``cast_scales_bf16``: every QTensor with f32 planes gets them
    as bfloat16.  Not exact (bf16 keeps 8 significant bits of fp16's 11, a
    scale moves by up to 2^-9 of itself); applied only when asked for."""
    def cast(t: QTensor) -> QTensor:
        if t.gscale_t.dtype != torch.float32:
            return t
        return dataclasses.replace(
            t, gscale_t=t.gscale_t.to(torch.bfloat16),
            gbias_t=None if t.gbias_t is None else t.gbias_t.to(torch.bfloat16))

    return _map_qtensors(params, cast)


def cast_scales_f16(params):
    """The JAX ``cast_scales_f16``: ``QTensor.scales_f16`` for the formats
    where it is exact (``_F16_EXACT_QTYPES``); the others are kept."""
    return _map_qtensors(
        params, lambda t: t.scales_f16() if t.qtype in _F16_EXACT_QTYPES else t)


def maybe_cast_scales_f16(params):
    """``cast_scales_f16`` when the environment sets ``QMM_F16_SCALES=1``."""
    if os.environ.get("QMM_F16_SCALES") != "1":
        return params
    return cast_scales_f16(params)


def fold_zero_points(params):
    """The JAX ``fold_zero_points``: ``QTensor.fold_zero`` over params."""
    return _map_qtensors(params, QTensor.fold_zero)


def maybe_fold_zero_points(params):
    """``fold_zero_points`` when the environment sets ``QMM_ZERO_FOLD=1``."""
    if os.environ.get("QMM_ZERO_FOLD") != "1":
        return params
    return fold_zero_points(params)
