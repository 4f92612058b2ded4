"""Helpers of the legacy 32-element block formats (q4_0, q4_1, q5_0, q5_1,
q8_0) that the planar repack needs: the fp16 scale widening and the q5 high
bits."""

from __future__ import annotations

import numpy as np


def f16_to_f32(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, dtype=np.float16).astype(np.float32)


def _qh_bits(qh_bytes: np.ndarray) -> np.ndarray:
    """(nb, 4) uint8 -> (nb, 32) int32 of individual bits, LSB first."""
    qh = np.ascontiguousarray(qh_bytes).view("<u4").reshape(-1)
    shifts = np.arange(32, dtype=np.uint32)
    return ((qh[:, None] >> shifts) & 1).astype(np.int32)
