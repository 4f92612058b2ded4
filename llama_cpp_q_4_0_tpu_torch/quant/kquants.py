"""Unpack helpers of the k-quant super-blocks (QK_K = 256): the 2-bit and
nibble-pair level layouts and the packed 6-bit scale codes.  Each works on
every block at once; the quantizers are not ported."""

from __future__ import annotations

import numpy as np


def unpack_scale_min_k4(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(nb, 12) bytes -> ((nb, 8) scales, (nb, 8) mins), each 6-bit, int32:
    entries 0-3 are the low 6 bits of bytes 0-3 (scales) and 4-7 (mins);
    entries 4-7 take 4 bits from bytes 8-11 and 2 from the top of 0-7."""
    q = np.asarray(scales, np.uint8)
    a, b, c = q[:, 0:4], q[:, 4:8], q[:, 8:12]
    sc = np.concatenate([a & 63, (c & 0xF) | ((a >> 6) << 4)], axis=1)
    mn = np.concatenate([b & 63, (c >> 4) | ((b >> 6) << 4)], axis=1)
    return sc.astype(np.int32), mn.astype(np.int32)


def _unpack2(q: np.ndarray) -> np.ndarray:
    """(nb, 64) bytes -> (nb, 256) 2-bit values: element half*128 + 32*sub + j
    is bits 2*sub of byte half*32 + j."""
    nb = q.shape[0]
    shifts = (2 * np.arange(4, dtype=np.uint8))[None, None, :, None]
    L = (np.asarray(q, np.uint8).reshape(nb, 2, 1, 32) >> shifts) & 3
    return L.reshape(nb, 256).astype(np.int32)


def _unpack_nibble_pairs(q: np.ndarray) -> np.ndarray:
    """(nb, 128) bytes -> (nb, 256): byte seg*32 + j holds element seg*64 + j
    in its low nibble and seg*64 + 32 + j in its high nibble."""
    nb = q.shape[0]
    b = np.asarray(q, np.uint8).reshape(nb, 4, 1, 32)
    L = np.concatenate([b & 0xF, b >> 4], axis=2)
    return L.reshape(nb, 256).astype(np.int32)


def _q3_unpack_scales(scales: np.ndarray) -> np.ndarray:
    """(nb, 12) bytes -> (nb, 16) int32 signed scales (code - 32): the low 4
    bits of scale j come from byte j % 8 (low nibble for j < 8, high above),
    the top 2 bits from byte 8 + j % 4 at bit 2 * (j // 4)."""
    q = np.asarray(scales, np.uint8)
    nb = q.shape[0]
    low = np.concatenate([q[:, :8] & 0xF, q[:, :8] >> 4], axis=1)
    shifts = (2 * np.arange(4, dtype=np.uint8))[None, :, None]
    hi = ((q[:, None, 8:12] >> shifts) & 3).reshape(nb, 16)
    return (low.astype(np.int32) | (hi.astype(np.int32) << 4)) - 32
