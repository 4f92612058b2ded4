"""Scaled-int8 KV cache (the CLI's ``--cache-type q8``), and the e4m3 cast
of the f8 cache (``--cache-type f8``).

Each [D] vector of K or V is stored as int8 levels with one f32 scale
(amax/127).  Attention folds the scales into the small score and probability
tensors instead of dequantizing the cache (ops/layers.py).

An f8 cache is a plain ``torch.float8_e4m3fn`` tensor.  It is written and
copied through its bytes (``raw``): some kernels PyTorch has for the other
dtypes (``index_copy_`` among them) are not implemented for it."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .qmm import ieee_div


F8 = torch.float8_e4m3fn
# the largest magnitude that rounds to a finite e4m3fn value (448; a tie
# at 464 rounds to it, as the mantissa of 448 is even)
F8_LIMIT = 464.0


def to_f8(val: torch.Tensor) -> torch.Tensor:
    """val as e4m3fn as the JAX package's cast gives it: rounded to nearest
    even, NaN beyond F8_LIMIT (e4m3fn has no infinity).  PyTorch's own cast
    saturates there on the CPU instead."""
    v = val.float()
    return torch.where(v.abs() <= F8_LIMIT, v, torch.full((), float("nan"),
                                                          device=v.device)).to(F8)


def to_cache(val: torch.Tensor, dtype) -> torch.Tensor:
    """val cast to a float cache's dtype."""
    return to_f8(val) if dtype == F8 else val.to(dtype)


def raw(t: torch.Tensor) -> torch.Tensor:
    """The tensor to write an f8 cache through: its bytes (uint8, the same
    storage); any other tensor itself."""
    return t.view(torch.uint8) if t.dtype == F8 else t


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
