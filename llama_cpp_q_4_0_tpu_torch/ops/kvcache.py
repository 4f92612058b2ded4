"""Scaled-int8 KV cache (the CLI's ``--cache-type q8``).

Each [D] vector of K or V is stored as int8 levels with one f32 scale
(amax/127).  Attention folds the scales into the small score and probability
tensors instead of dequantizing the cache (ops/layers.py)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .qmm import ieee_div


@dataclass
class QuantKV:
    """int8 KV-cache layer with per-(token, head) scales."""

    data: torch.Tensor  # int8 [B, S, H, D]
    scale: torch.Tensor  # f32 [B, S, H]

    @property
    def shape(self):
        return self.data.shape


def quantize_kv(val: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., D] -> (int8 levels, f32 scale[...]) with scale = amax/127;
    rounding is half to even, as in the JAX package.  The scale is a
    correctly rounded division (``ieee_div``): PyTorch's CUDA division by
    the Python scalar 127 multiplies by its reciprocal, an ulp off for some
    amax."""
    vf = val.float()
    amax = vf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, ieee_div(amax, 127.0), torch.ones_like(amax))
    q = torch.clamp(torch.round(vf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale
