"""LowRankPatched: a weight with an unmerged LoRA delta.

The reference merges LoRA into the base weights (w += (alpha/r) BA,
llama.cpp:2716-2991) and must requantize quantized targets.  Unmerged, the
quantized base stays bit for bit as it is and the delta is applied at matmul
time:

    y = q_matmul(x, base) + ((x @ A^T) @ B^T) * (alpha/r)

The base goes through the kernel route of its format (``ops/qmatmul.py``);
the two skinny f32 products are ``torch.matmul``, as the JAX package
computes them outside any Pallas kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class LowRankPatched:
    """base: QTensor or dense [N, K]; a: f32 [r, K]; b: f32 [N, r];
    y += (x A^T) B^T * scale."""

    base: object
    a: torch.Tensor
    b: torch.Tensor
    scale: float

    @property
    def shape(self):
        return self.base.shape

    def delta(self) -> torch.Tensor:
        """The materialized [N, K] delta."""
        return (self.b.float() @ self.a.float()) * self.scale


def lowrank_apply(x2: torch.Tensor, w: LowRankPatched) -> torch.Tensor:
    """The low-rank correction of x2 [B, K] -> [B, N] f32."""
    return ((x2.float() @ w.a.float().T) @ w.b.float().T) * w.scale


def patch(base, a: np.ndarray, b: np.ndarray, scale: float) -> LowRankPatched:
    """base with the delta b @ a * scale (a [r, K], b [N, r]) unmerged, the
    factors as contiguous f32 tensors on the base's device."""
    def put(m):
        return torch.from_numpy(np.ascontiguousarray(m, np.float32)).to(base.device)

    return LowRankPatched(base=base, a=put(a), b=put(b), scale=float(scale))
