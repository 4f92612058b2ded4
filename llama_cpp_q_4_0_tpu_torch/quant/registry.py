"""``quantize(x, t)`` and ``dequantize(blocks, t)``: the quantizer and
dequantizer columns of the reference's ``quantize_fns`` table
(ggml.c:1618-1716) as the JAX package's ``quant/registry.py`` holds them
(numpy only, no native fast path).  QK_K = 64 super-blocks are neither
written nor read."""

from __future__ import annotations

import numpy as np

from . import blockq, kquants
from .types import GGMLType, type_traits

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

DEQUANTIZERS = {
    GGMLType.Q4_0: blockq.dequantize_q4_0,
    GGMLType.Q4_1: blockq.dequantize_q4_1,
    GGMLType.Q5_0: blockq.dequantize_q5_0,
    GGMLType.Q5_1: blockq.dequantize_q5_1,
    GGMLType.Q8_0: blockq.dequantize_q8_0,
    GGMLType.Q8_1: blockq.dequantize_q8_1,
    GGMLType.Q2_K: kquants.dequantize_q2_K,
    GGMLType.Q3_K: kquants.dequantize_q3_K,
    GGMLType.Q4_K: kquants.dequantize_q4_K,
    GGMLType.Q5_K: kquants.dequantize_q5_K,
    GGMLType.Q6_K: kquants.dequantize_q6_K,
    GGMLType.Q8_K: kquants.dequantize_q8_K,
}


def quantize(x: np.ndarray, t: GGMLType) -> np.ndarray:
    """Quantize float32 rows (..., k) to blocks of type t (..., k / block)."""
    if t not in QUANTIZERS:
        raise NotImplementedError(f"no quantizer for {GGMLType(t).name}")
    return QUANTIZERS[t](x)


def dequantize(blocks: np.ndarray, t: GGMLType) -> np.ndarray:
    """Blocks of type t (..., n) back to float32 rows (..., n * block)."""
    if t not in DEQUANTIZERS:
        raise NotImplementedError(f"no dequantizer for {GGMLType(t).name}")
    return DEQUANTIZERS[t](blocks)


def dequantize_bytes(raw, t: GGMLType, shape) -> np.ndarray:
    """ggml block bytes (or f32 / f16 values) as float32 of the given
    element shape."""
    if t == GGMLType.F32:
        return np.frombuffer(raw, dtype="<f4").reshape(shape).astype(np.float32)
    if t == GGMLType.F16:
        return np.frombuffer(raw, dtype="<f2").reshape(shape).astype(np.float32)
    tr = type_traits(t)
    buf = np.frombuffer(raw, dtype=tr.block_dtype)
    if buf.shape[0] * tr.block_size != int(np.prod(shape)):
        raise ValueError(f"{buf.shape[0]} {tr.name} blocks do not hold shape {tuple(shape)}")
    return dequantize(buf, t).reshape(shape)
