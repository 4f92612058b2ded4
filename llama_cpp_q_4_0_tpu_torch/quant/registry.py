"""``quantize(x, t)``: float32 rows to the blocks of format t, the quantizer
column of the reference's ``quantize_fns`` table (ggml.c:1618-1716) as the
JAX package's ``quant/registry.py`` holds it (numpy only, no native fast
path).  QK_K = 64 super-blocks are not written."""

from __future__ import annotations

import numpy as np

from . import blockq, kquants
from .types import GGMLType

QUANTIZERS = {
    GGMLType.Q4_0: blockq.quantize_q4_0,
    GGMLType.Q4_1: blockq.quantize_q4_1,
    GGMLType.Q5_0: blockq.quantize_q5_0,
    GGMLType.Q5_1: blockq.quantize_q5_1,
    GGMLType.Q8_0: blockq.quantize_q8_0,
    GGMLType.Q8_1: blockq.quantize_q8_1,
    GGMLType.Q2_K: kquants.quantize_q2_K,
    GGMLType.Q3_K: kquants.quantize_q3_K,
    GGMLType.Q4_K: kquants.quantize_q4_K,
    GGMLType.Q5_K: kquants.quantize_q5_K,
    GGMLType.Q6_K: kquants.quantize_q6_K,
    GGMLType.Q8_K: kquants.quantize_q8_K,
}


def quantize(x: np.ndarray, t: GGMLType) -> np.ndarray:
    """Quantize float32 rows (..., k) to blocks of type t (..., k / block)."""
    if t not in QUANTIZERS:
        raise NotImplementedError(f"no quantizer for {GGMLType(t).name}")
    return QUANTIZERS[t](x)
