"""QTensor: a quantized 2-D weight on a device, in planar layout.

The logical weight is W [N, K] (ggml row-major: N output rows, K the reduce
dim), stored transposed (K-major) in one of two forms.

Unpacked (``pack_zero`` None; 5-bit and wider levels: q5_0, q5_1, q8_0,
q5_K, q6_K):

  levels_t int8 [K, N];  W[n, k] = levels_t[k, n] * gscale_t[k // g, n]
                                   (+ gbias_t[k // g, n])
  gscale_t, gbias_t f32 [K/g, N].

Packed (levels spanning at most 16 values: q4_0, q4_1, q2_K, q3_K, q4_K),
split-half nibbles:

  levels_t uint8 [K2P, N], K2P = K/2 rounded up to 256 (zero padding rows);
  level(k) = (byte[k, n] & 0xF) - pack_zero          for k <  K/2
           = (byte[k - K/2, n] >> 4) - pack_zero     for k >= K/2
  gscale_t, gbias_t f32 [2, K2P/g, N]: plane 0 holds the low panel's groups,
  plane 1 the high panel's; padding rows are zero.

``gbias_t`` is None for the symmetric formats.  Split-half (not adjacent
pairs) so a kernel unpacks with one mask and one shift and each nibble plane
is a contiguous K panel.  The JAX package's ``ops/qtensor.py`` without the
pytree registration.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..quant.pack import PlanarQuant, quantize_planar
from ..quant.types import GGMLType


@dataclass
class QTensor:
    levels_t: torch.Tensor  # int8 [K, N] | uint8 [K2P, N] when packed
    gscale_t: torch.Tensor  # f32 [K // gsize, N] | [2, K2P // gsize, N] packed
    gsize: int
    qtype: GGMLType
    shape: tuple[int, int]  # (N, K)
    pack_zero: int | None = None  # nibble bias; None = unpacked int8
    gbias_t: torch.Tensor | None = None  # f32, same shape rule as gscale_t

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
        """Group scales in logical [K/gsize, N] order."""
        return self._panels(self.gscale_t) if self.packed else self.gscale_t

    def gbias_full(self) -> torch.Tensor | None:
        if self.gbias_t is None or not self.packed:
            return self.gbias_t
        return self._panels(self.gbias_t)

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
