"""The k-quant super-blocks (QK_K = 256): the unpack helpers of the 2-bit and
nibble-pair level layouts and the packed 6-bit scale codes, and the
quantizers and dequantizers of q2_K..q6_K and q8_K.

The quantizers are the JAX package's ``quant/kquants.py``: the reference's
per-group scalar loops (k_quants.c) vectorised across groups with per-group
active masks, inner sums taken element by element in float32 to keep the C
order.  Like it, ``make_qkx1_quants`` starts L at zero where the reference
reads uninitialised stack memory (k_quants.c:243-247), which only moves the
early exit of degenerate groups.  QK_K = 64 super-blocks are not written.
"""

from __future__ import annotations

import numpy as np

from .blockq import f16, f16_to_f32
from .types import BLOCK_Q2_K, BLOCK_Q3_K, BLOCK_Q4_K, BLOCK_Q5_K, BLOCK_Q6_K, BLOCK_Q8_K, QK_K

F32 = np.float32


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


# ------------------------------------------------------------- quantizers

def nearest_int(x: np.ndarray) -> np.ndarray:
    """Round half-to-even (the 12582912.0f magic in k_quants.c:50-55)."""
    return np.rint(np.asarray(x, dtype=np.float32)).astype(np.int32)


def _group(x: np.ndarray, gsize: int) -> np.ndarray:
    """(nb, QK_K) -> (nb * QK_K/gsize, gsize) float32 groups."""
    return x.reshape(-1, gsize)


def make_qkx1_quants(x: np.ndarray, nmax: int, ntry: int = 5):
    """Affine x ~ scale*L + (-the_min), L in [0, nmax] (k_quants.c:222-263).

    x: (G, n) float32.  Returns (scale (G,), the_min (G,), L (G, n) int32).
    """
    G, n = x.shape
    mn = x.min(axis=1).astype(F32)
    mx = x.max(axis=1).astype(F32)
    degenerate = mx == mn
    mn = np.where(mn > 0, F32(0.0), mn).astype(F32)
    with np.errstate(divide="ignore", invalid="ignore"):
        iscale = (F32(nmax) / (mx - mn)).astype(F32)
        scale = (F32(1.0) / iscale).astype(F32)
    L = np.zeros((G, n), dtype=np.int32)
    active = ~degenerate
    for _ in range(ntry):
        if not active.any():
            break
        with np.errstate(invalid="ignore", over="ignore"):
            l_new = nearest_int(iscale[:, None] * (x - mn[:, None]))
        l_new = np.clip(l_new, 0, nmax)
        changed = (l_new != L).any(axis=1)
        L = np.where(active[:, None], l_new, L)
        # sequential f32 accumulation over the n elements (C loop order)
        sumlx = np.zeros(G, dtype=F32)
        suml2 = np.zeros(G, dtype=np.int64)
        Lf = L.astype(F32)
        for i in range(n):
            sumlx = (sumlx + (x[:, i] - mn) * Lf[:, i]).astype(F32)
            suml2 = suml2 + L[:, i].astype(np.int64) ** 2
        with np.errstate(divide="ignore", invalid="ignore"):
            new_scale = (sumlx / suml2.astype(F32)).astype(F32)
        scale = np.where(active, new_scale, scale)
        tot = np.zeros(G, dtype=F32)
        for i in range(n):
            tot = (tot + (x[:, i] - scale * Lf[:, i])).astype(F32)
        mn_new = (tot / F32(n)).astype(F32)
        mn_new = np.where(mn_new > 0, F32(0.0), mn_new)
        mn = np.where(active, mn_new, mn)
        with np.errstate(divide="ignore", invalid="ignore"):
            iscale = np.where(active, (F32(1.0) / scale).astype(F32), iscale)
        active = active & changed
    scale = np.where(degenerate, F32(0.0), scale).astype(F32)
    the_min = np.where(degenerate, F32(0.0), -mn).astype(F32)
    L = np.where(degenerate[:, None], 0, L)
    return scale, the_min, L


def _greedy_refine(x, w, L, sumlx, suml2, nmax, niter=5):
    """The per-element greedy RMSE refinement loop shared by make_qx_quants /
    make_q3_quants (k_quants.c:112-138, 193-215), vectorized across groups.

    L holds *signed* levels in [-nmax, nmax-1].  Mutates and returns
    (L, sumlx, suml2)."""
    G, n = x.shape
    active = np.ones(G, dtype=bool)
    for _ in range(niter):
        if not active.any():
            break
        n_changed = np.zeros(G, dtype=np.int32)
        for i in range(n):
            wi = w[:, i]
            xi = x[:, i]
            l = L[:, i].astype(F32)
            slx = (sumlx - wi * xi * l).astype(F32)
            sl2 = (suml2 - wi * l * l).astype(F32)
            with np.errstate(divide="ignore", invalid="ignore"):
                cand = nearest_int(xi * sl2 / slx)
            new_l = np.clip(cand, -nmax, nmax - 1)
            try_it = active & (slx > 0) & (new_l != L[:, i])
            nl = new_l.astype(F32)
            slx2 = (slx + wi * xi * nl).astype(F32)
            sl22 = (sl2 + wi * nl * nl).astype(F32)
            accept = try_it & (sl22 > 0) & (slx2 * slx2 * suml2 > sumlx * sumlx * sl22)
            L[:, i] = np.where(accept, new_l, L[:, i])
            sumlx = np.where(accept, slx2, sumlx).astype(F32)
            suml2 = np.where(accept, sl22, suml2).astype(F32)
            n_changed += accept.astype(np.int32)
        active = active & (n_changed > 0)
    return L, sumlx, suml2


def make_qx_quants(x: np.ndarray, nmax: int):
    """Symmetric x ~ scale * (L - nmax), L in [0, 2*nmax-1], with the weight
    x^2 (rmse_type 1, the only variant the reference's model quantization
    uses; k_quants.c:57-156).  Returns (scale (G,), L (G, n) int32 with the
    +nmax offset applied).
    """
    G, n = x.shape
    amax_idx = np.argmax(np.abs(x), axis=1)
    mx = x[np.arange(G), amax_idx].astype(F32)
    amax = np.abs(mx)
    zero = amax == 0
    with np.errstate(divide="ignore", invalid="ignore"):
        iscale = (F32(-nmax) / mx).astype(F32)

    def levels(isc):
        with np.errstate(invalid="ignore", over="ignore"):
            return np.clip(nearest_int(isc[:, None] * x), -nmax, nmax - 1)

    L = levels(iscale)
    w = (x * x).astype(F32)
    Lf = L.astype(F32)
    sumlx = np.zeros(G, dtype=F32)
    suml2 = np.zeros(G, dtype=F32)
    for i in range(n):
        sumlx = (sumlx + w[:, i] * x[:, i] * Lf[:, i]).astype(F32)
        suml2 = (suml2 + w[:, i] * Lf[:, i] * Lf[:, i]).astype(F32)
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = (sumlx / suml2).astype(F32)
    best = (scale * sumlx).astype(F32)
    # up to 3 re-scale passes with early exit (k_quants.c:91-111)
    active = ~zero
    for _ in range(3):
        if not active.any():
            break
        with np.errstate(divide="ignore", invalid="ignore"):
            isc = (F32(1.0) / scale).astype(F32)
        l_new = levels(isc)
        changed = (l_new != L).any(axis=1)
        slx = np.zeros(G, dtype=F32)
        sl2 = np.zeros(G, dtype=F32)
        lf = l_new.astype(F32)
        for i in range(n):
            slx = (slx + w[:, i] * x[:, i] * lf[:, i]).astype(F32)
            sl2 = (sl2 + w[:, i] * lf[:, i] * lf[:, i]).astype(F32)
        keep_going = active & changed & (sl2 != 0) & (slx * slx > best * sl2)
        L = np.where(keep_going[:, None], l_new, L)
        sumlx = np.where(keep_going, slx, sumlx).astype(F32)
        suml2 = np.where(keep_going, sl2, suml2).astype(F32)
        with np.errstate(divide="ignore", invalid="ignore"):
            scale = np.where(keep_going, (sumlx / suml2).astype(F32), scale)
        best = np.where(keep_going, (scale * sumlx).astype(F32), best)
        active = keep_going
    L, sumlx, suml2 = _greedy_refine(x, w, L, sumlx, suml2, nmax)
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = (sumlx / suml2).astype(F32)
    scale = np.where(zero, F32(0.0), scale)
    L = np.where(zero[:, None], 0, L + nmax)
    return scale, L


def make_q3_quants(x: np.ndarray, nmax: int):
    """do_rmse=True variant used by q3_K (k_quants.c:159-220).

    Returns (scale (G,), L (G, n) int32 with +nmax offset)."""
    G, n = x.shape
    amax_idx = np.argmax(np.abs(x), axis=1)
    mx = x[np.arange(G), amax_idx].astype(F32)
    zero = np.abs(mx) == 0
    with np.errstate(divide="ignore", invalid="ignore"):
        iscale = (F32(-nmax) / mx).astype(F32)
    with np.errstate(invalid="ignore", over="ignore"):
        L = np.clip(nearest_int(iscale[:, None] * x), -nmax, nmax - 1)
    w = (x * x).astype(F32)
    Lf = L.astype(F32)
    sumlx = np.zeros(G, dtype=F32)
    suml2 = np.zeros(G, dtype=F32)
    for i in range(n):
        sumlx = (sumlx + w[:, i] * x[:, i] * Lf[:, i]).astype(F32)
        suml2 = (suml2 + w[:, i] * Lf[:, i] * Lf[:, i]).astype(F32)
    L, sumlx, suml2 = _greedy_refine(x, w, L, sumlx, suml2, nmax)
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = (sumlx / suml2).astype(F32)
    scale = np.where(zero, F32(0.0), scale)
    L = np.where(zero[:, None], 0, L + nmax)
    return scale, L


def pack_scale_min_k4(ls: np.ndarray, lm: np.ndarray) -> np.ndarray:
    """(nb, 8) 6-bit scales + (nb, 8) 6-bit mins -> (nb, 12) bytes."""
    nb = ls.shape[0]
    out = np.zeros((nb, 12), dtype=np.uint8)
    ls = ls.astype(np.uint8)
    lm = lm.astype(np.uint8)
    for j in range(8):
        if j < 4:
            out[:, j] = ls[:, j]
            out[:, j + 4] = lm[:, j]
        else:
            out[:, j + 4] = (ls[:, j] & 0xF) | ((lm[:, j] & 0xF) << 4)
            out[:, j - 4] |= (ls[:, j] >> 4) << 6
            out[:, j] |= (lm[:, j] >> 4) << 6
    return out


def _pack2(L: np.ndarray) -> np.ndarray:
    """(nb, 256) 2-bit levels -> (nb, 64) bytes (k_quants.c:336-341)."""
    nb = L.shape[0]
    q = np.zeros((nb, 64), dtype=np.uint8)
    Lu = L.astype(np.uint8)
    for half in (0, 128):
        base = half // 4
        for sub in range(4):
            q[:, base : base + 32] |= Lu[:, half + 32 * sub : half + 32 * (sub + 1)] << (2 * sub)
    return q


def quantize_q2_K(x: np.ndarray) -> np.ndarray:
    xb = np.ascontiguousarray(x, dtype=F32).reshape(-1, QK_K)
    nb = xb.shape[0]
    scales, mins, L0 = make_qkx1_quants(_group(xb, 16), 3, ntry=5)
    scales = scales.reshape(nb, 16)
    mins = mins.reshape(nb, 16)
    L = L0.reshape(nb, QK_K)

    q4scale = F32(15.0)
    max_scale = np.maximum(scales.max(axis=1), F32(0.0))
    max_min = np.maximum(mins.max(axis=1), F32(0.0))

    out = np.zeros(nb, dtype=BLOCK_Q2_K)
    sc4 = np.zeros((nb, 16), dtype=np.int32)
    mn4 = np.zeros((nb, 16), dtype=np.int32)
    pos_s = max_scale > 0
    with np.errstate(divide="ignore", invalid="ignore"):
        isc = (q4scale / max_scale).astype(F32)
        imn = (q4scale / max_min).astype(F32)
    sc4[pos_s] = nearest_int(isc[pos_s, None] * scales[pos_s])
    d = np.where(pos_s, (max_scale / q4scale).astype(F32), F32(0.0))
    pos_m = max_min > 0
    mn4[pos_m] = nearest_int(imn[pos_m, None] * mins[pos_m])
    dmin = np.where(pos_m, (max_min / q4scale).astype(F32), F32(0.0))
    out["d"] = f16(d)
    out["dmin"] = f16(dmin)
    # C stores via uint8 assignment + |= (l << 4), truncating mod 256
    out["scales"] = sc4.astype(np.uint8) | (mn4.astype(np.uint8) << 4)

    # requantize with the *decoded* coded scales (k_quants.c:324-333)
    df = f16_to_f32(out["d"])[:, None] * (out["scales"] & 0xF).astype(F32)
    dmf = f16_to_f32(out["dmin"])[:, None] * (out["scales"] >> 4).astype(F32)
    xg = xb.reshape(nb, 16, 16)
    with np.errstate(divide="ignore", invalid="ignore"):
        lq = nearest_int((xg + dmf[:, :, None]) / df[:, :, None])
    lq = np.clip(lq, 0, 3)
    keep = (df != 0)[:, :, None]
    L = np.where(keep, lq, L.reshape(nb, 16, 16)).reshape(nb, QK_K)

    out["qs"] = _pack2(L)
    return out.reshape(*x.shape[:-1], -1) if x.ndim > 1 else out


def _q3_pack_scales(l6: np.ndarray) -> np.ndarray:
    """(nb, 16) 6-bit codes -> (nb, 12) bytes (k_quants.c:441-453)."""
    nb = l6.shape[0]
    out = np.zeros((nb, 12), dtype=np.uint8)
    lu = l6.astype(np.uint8)
    for j in range(16):
        if j < 8:
            out[:, j] |= lu[:, j] & 0xF
        else:
            out[:, j - 8] |= (lu[:, j] & 0xF) << 4
        out[:, 8 + j % 4] |= (lu[:, j] >> 4) << (2 * (j // 4))
    return out


def quantize_q3_K(x: np.ndarray) -> np.ndarray:
    xb = np.ascontiguousarray(x, dtype=F32).reshape(-1, QK_K)
    nb = xb.shape[0]
    scales, L0 = make_q3_quants(_group(xb, 16), 4)
    scales = scales.reshape(nb, 16)
    L = L0.reshape(nb, QK_K)

    # signed value of largest |scale| per super-block (k_quants.c:427-436)
    idx = np.argmax(np.abs(scales), axis=1)
    max_scale = scales[np.arange(nb), idx]
    nonzero = max_scale != 0

    out = np.zeros(nb, dtype=BLOCK_Q3_K)
    with np.errstate(divide="ignore", invalid="ignore"):
        iscale = (F32(-32.0) / max_scale).astype(F32)
    l6 = np.zeros((nb, 16), dtype=np.int32)
    l6[nonzero] = np.clip(nearest_int(iscale[nonzero, None] * scales[nonzero]), -32, 31) + 32
    out["scales"] = _q3_pack_scales(l6)
    with np.errstate(divide="ignore", invalid="ignore"):
        dval = np.where(nonzero, (F32(1.0) / iscale).astype(F32), F32(0.0))
    out["d"] = f16(dval)

    sc = _q3_unpack_scales(out["scales"])
    df = f16_to_f32(out["d"])[:, None] * sc.astype(F32)
    xg = xb.reshape(nb, 16, 16)
    with np.errstate(divide="ignore", invalid="ignore"):
        lq = np.clip(nearest_int(xg / df[:, :, None]), -4, 3) + 4
    keep = (df != 0)[:, :, None]
    L = np.where(keep, lq, L.reshape(nb, 16, 16)).reshape(nb, QK_K)

    # high-bit mask: bit (j//32) of hmask[j%32] set iff L[j] > 3 (k_quants.c:505-517)
    high = L > 3
    L = np.where(high, L - 4, L)
    hmask = np.zeros((nb, 32), dtype=np.uint8)
    for bit in range(8):
        seg = high[:, bit * 32 : (bit + 1) * 32].astype(np.uint8) << bit
        hmask |= seg
    out["hmask"] = hmask
    out["qs"] = _pack2(L)
    return out.reshape(*x.shape[:-1], -1) if x.ndim > 1 else out


def _pack_nibble_pairs(L: np.ndarray) -> np.ndarray:
    """(nb, 256) 4/5-bit low nibbles -> (nb, 128) bytes, 64-elem stride

    (q[l] = L[j+l] | L[j+l+32] << 4 for j in 0,64,128,192; k_quants.c:729-733)."""
    nb = L.shape[0]
    q = np.zeros((nb, 128), dtype=np.uint8)
    Lu = L.astype(np.uint8)
    for seg in range(4):
        lo = Lu[:, seg * 64 : seg * 64 + 32]
        hi = Lu[:, seg * 64 + 32 : seg * 64 + 64]
        q[:, seg * 32 : (seg + 1) * 32] = lo | (hi << 4)
    return q


def _qkx_scales_6bit(scales, mins, nb):
    """Common 63-step scale/min coding for q4_K/q5_K (k_quants.c:674-691)."""
    max_scale = np.maximum(scales.max(axis=1), F32(0.0))
    max_min = np.maximum(mins.max(axis=1), F32(0.0))
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_scale = np.where(max_scale > 0, F32(63.0) / max_scale, F32(0.0)).astype(F32)
        inv_min = np.where(max_min > 0, F32(63.0) / max_min, F32(0.0)).astype(F32)
    # C: uint8_t ls = nearest_int(...); ls = MIN(63, ls) — cast *before* min
    ls = np.minimum(63, nearest_int(inv_scale[:, None] * scales) & 0xFF)
    lm = np.minimum(63, nearest_int(inv_min[:, None] * mins) & 0xFF)
    d = (max_scale / F32(63.0)).astype(F32)
    dmin = (max_min / F32(63.0)).astype(F32)
    return ls, lm, d, dmin


def quantize_q4_K(x: np.ndarray) -> np.ndarray:
    xb = np.ascontiguousarray(x, dtype=F32).reshape(-1, QK_K)
    nb = xb.shape[0]
    scales, mins, L0 = make_qkx1_quants(_group(xb, 32), 15, ntry=5)
    scales = scales.reshape(nb, 8)
    mins = mins.reshape(nb, 8)
    L = L0.reshape(nb, QK_K)

    ls, lm, d, dmin = _qkx_scales_6bit(scales, mins, nb)
    out = np.zeros(nb, dtype=BLOCK_Q4_K)
    out["scales"] = pack_scale_min_k4(ls, lm)
    out["d"] = f16(d)
    out["dmin"] = f16(dmin)

    sc, m = unpack_scale_min_k4(out["scales"])
    df = f16_to_f32(out["d"])[:, None] * sc.astype(F32)
    dmf = f16_to_f32(out["dmin"])[:, None] * m.astype(F32)
    xg = xb.reshape(nb, 8, 32)
    with np.errstate(divide="ignore", invalid="ignore"):
        lq = np.clip(nearest_int((xg + dmf[:, :, None]) / df[:, :, None]), 0, 15)
    keep = (df != 0)[:, :, None]
    L = np.where(keep, lq, L.reshape(nb, 8, 32)).reshape(nb, QK_K)
    out["qs"] = _pack_nibble_pairs(L)
    return out.reshape(*x.shape[:-1], -1) if x.ndim > 1 else out


def quantize_q5_K(x: np.ndarray) -> np.ndarray:
    xb = np.ascontiguousarray(x, dtype=F32).reshape(-1, QK_K)
    nb = xb.shape[0]
    scales, mins, L0 = make_qkx1_quants(_group(xb, 32), 31, ntry=5)
    scales = scales.reshape(nb, 8)
    mins = mins.reshape(nb, 8)
    L = L0.reshape(nb, QK_K)

    ls, lm, d, dmin = _qkx_scales_6bit(scales, mins, nb)
    out = np.zeros(nb, dtype=BLOCK_Q5_K)
    out["scales"] = pack_scale_min_k4(ls, lm)
    out["d"] = f16(d)
    out["dmin"] = f16(dmin)

    sc, m = unpack_scale_min_k4(out["scales"])
    df = f16_to_f32(out["d"])[:, None] * sc.astype(F32)
    dmf = f16_to_f32(out["dmin"])[:, None] * m.astype(F32)
    xg = xb.reshape(nb, 8, 32)
    with np.errstate(divide="ignore", invalid="ignore"):
        lq = np.clip(nearest_int((xg + dmf[:, :, None]) / df[:, :, None]), 0, 31)
    keep = (df != 0)[:, :, None]
    L = np.where(keep, lq, L.reshape(nb, 8, 32)).reshape(nb, QK_K)

    # split into low nibble + high bit; qh bit pairs per 64-elem segment
    # (m1/m2 doubling loop, k_quants.c:941-956)
    qh = np.zeros((nb, 32), dtype=np.uint8)
    ql = np.zeros((nb, 128), dtype=np.uint8)
    for seg in range(4):
        l1 = L[:, seg * 64 : seg * 64 + 32]
        l2 = L[:, seg * 64 + 32 : seg * 64 + 64]
        hi1 = (l1 > 15).astype(np.uint8)
        hi2 = (l2 > 15).astype(np.uint8)
        qh |= hi1 << (2 * seg)
        qh |= hi2 << (2 * seg + 1)
        ql[:, seg * 32 : (seg + 1) * 32] = (
            (l1 - 16 * hi1) | ((l2 - 16 * hi2).astype(np.uint8) << 4)
        ).astype(np.uint8)
    out["qh"] = qh
    out["qs"] = ql
    return out.reshape(*x.shape[:-1], -1) if x.ndim > 1 else out


def quantize_q6_K(x: np.ndarray) -> np.ndarray:
    xb = np.ascontiguousarray(x, dtype=F32).reshape(-1, QK_K)
    nb = xb.shape[0]
    scales, L0 = make_qx_quants(_group(xb, 16), 32)
    scales = scales.reshape(nb, 16)
    L = L0.reshape(nb, QK_K)

    idx = np.argmax(np.abs(scales), axis=1)
    max_scale = scales[np.arange(nb), idx]
    zero = max_scale == 0
    with np.errstate(divide="ignore", invalid="ignore"):
        iscale = (F32(-128.0) / max_scale).astype(F32)

    out = np.zeros(nb, dtype=BLOCK_Q6_K)
    with np.errstate(divide="ignore", invalid="ignore"):
        out["d"] = f16(np.where(zero, F32(0.0), (F32(1.0) / iscale)).astype(F32))
        sc8 = np.minimum(127, nearest_int(np.where(zero, F32(0.0), iscale)[:, None] * scales)).astype(np.int8)
    out["scales"] = sc8

    df = f16_to_f32(out["d"])[:, None] * sc8.astype(F32)
    xg = xb.reshape(nb, 16, 16)
    with np.errstate(divide="ignore", invalid="ignore"):
        lq = np.clip(nearest_int(xg / df[:, :, None]), -32, 31) + 32
    keep = (df != 0)[:, :, None]
    L = np.where(keep, lq, L.reshape(nb, 16, 16)).reshape(nb, QK_K)

    # pack: ql low nibbles / qh top 2 bits in 128-elem halves (k_quants.c:1100-1113)
    ql = np.zeros((nb, 128), dtype=np.uint8)
    qh = np.zeros((nb, 64), dtype=np.uint8)
    Lu = L.astype(np.uint8)
    for half in range(2):
        o = half * 128
        q1 = Lu[:, o : o + 32] & 0xF
        q2 = Lu[:, o + 32 : o + 64] & 0xF
        q3 = Lu[:, o + 64 : o + 96] & 0xF
        q4 = Lu[:, o + 96 : o + 128] & 0xF
        ql[:, half * 64 : half * 64 + 32] = q1 | (q3 << 4)
        ql[:, half * 64 + 32 : half * 64 + 64] = q2 | (q4 << 4)
        qh[:, half * 32 : half * 32 + 32] = (
            (Lu[:, o : o + 32] >> 4)
            | ((Lu[:, o + 32 : o + 64] >> 4) << 2)
            | ((Lu[:, o + 64 : o + 96] >> 4) << 4)
            | ((Lu[:, o + 96 : o + 128] >> 4) << 6)
        )
    out["ql"] = ql
    out["qh"] = qh
    return out.reshape(*x.shape[:-1], -1) if x.ndim > 1 else out


def quantize_q8_K(x: np.ndarray) -> np.ndarray:
    xb = np.ascontiguousarray(x, dtype=F32).reshape(-1, QK_K)
    nb = xb.shape[0]
    idx = np.argmax(np.abs(xb), axis=1)
    mx = xb[np.arange(nb), idx].astype(F32)
    zero = np.abs(mx) == 0
    with np.errstate(divide="ignore", invalid="ignore"):
        iscale = (F32(-128.0) / mx).astype(F32)
    q = np.minimum(127, nearest_int(iscale[:, None] * xb))
    q = np.where(zero[:, None], 0, q).astype(np.int8)
    out = np.zeros(nb, dtype=BLOCK_Q8_K)
    out["qs"] = q
    out["bsums"] = q.reshape(nb, 16, 16).astype(np.int32).sum(axis=2).astype(np.int16)
    with np.errstate(divide="ignore", invalid="ignore"):
        out["d"] = np.where(zero, F32(0.0), (F32(1.0) / iscale).astype(F32))
    return out.reshape(*x.shape[:-1], -1) if x.ndim > 1 else out


def _unblock(y: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    y = y.reshape(-1, QK_K)
    return y.reshape(-1) if blocks.ndim == 1 else y.reshape(*blocks.shape[:-1], -1)


def dequantize_q2_K(blocks: np.ndarray) -> np.ndarray:
    """y = d * sc * q - dmin * m per 16-group (k_quants.c:380)."""
    b = blocks.reshape(-1)
    nb = b.shape[0]
    d = f16_to_f32(b["d"])[:, None]
    dmin = f16_to_f32(b["dmin"])[:, None]
    sc = (b["scales"] & 0xF).astype(F32)
    mn = (b["scales"] >> 4).astype(F32)
    L = _unpack2(b["qs"]).reshape(nb, 16, 16).astype(F32)
    return _unblock((d * sc)[:, :, None] * L - (dmin * mn)[:, :, None], blocks)


def _q3_levels(b: np.ndarray) -> np.ndarray:
    """(nb, 256) signed q3_K levels: the 2-bit value less 4 where the
    element's hmask bit is clear."""
    nb = b.shape[0]
    shifts = np.arange(8, dtype=np.uint8)[None, :, None]
    bits = ((b["hmask"][:, None, :] >> shifts) & 1).reshape(nb, QK_K).astype(np.int32)
    return _unpack2(b["qs"]) - np.where(bits == 1, 0, 4)


def dequantize_q3_K(blocks: np.ndarray) -> np.ndarray:
    """y = d * (scale - 32) * q per 16-group (k_quants.c:536)."""
    b = blocks.reshape(-1)
    nb = b.shape[0]
    d = f16_to_f32(b["d"])[:, None]
    sc = _q3_unpack_scales(b["scales"]).astype(F32)
    q = _q3_levels(b).reshape(nb, 16, 16).astype(F32)
    return _unblock((d * sc)[:, :, None] * q, blocks)


def dequantize_q4_K(blocks: np.ndarray) -> np.ndarray:
    """y = d * sc * q - dmin * m per 32-group (k_quants.c:747)."""
    b = blocks.reshape(-1)
    nb = b.shape[0]
    d = f16_to_f32(b["d"])[:, None]
    dmin = f16_to_f32(b["dmin"])[:, None]
    sc, m = unpack_scale_min_k4(b["scales"])
    L = _unpack_nibble_pairs(b["qs"]).reshape(nb, 8, 32).astype(F32)
    return _unblock((d * sc.astype(F32))[:, :, None] * L
                    - (dmin * m.astype(F32))[:, :, None], blocks)


def dequantize_q5_K(blocks: np.ndarray) -> np.ndarray:
    """q4_K's form with a fifth bit from qh: bit 2 * seg for the low
    nibbles of segment seg, 2 * seg + 1 for its high ones (k_quants.c:982)."""
    b = blocks.reshape(-1)
    nb = b.shape[0]
    d = f16_to_f32(b["d"])[:, None]
    dmin = f16_to_f32(b["dmin"])[:, None]
    sc, m = unpack_scale_min_k4(b["scales"])
    shifts = np.arange(8, dtype=np.uint8)[None, :, None]
    hi = ((b["qh"][:, None, :] >> shifts) & 1).reshape(nb, QK_K).astype(np.int32)
    L = (_unpack_nibble_pairs(b["qs"]) + 16 * hi).reshape(nb, 8, 32).astype(F32)
    return _unblock((d * sc.astype(F32))[:, :, None] * L
                    - (dmin * m.astype(F32))[:, :, None], blocks)


def dequantize_q6_K(blocks: np.ndarray) -> np.ndarray:
    """y = d * scale * (q - 32) per 16-group; the low 4 bits from ql, the
    top 2 from qh (k_quants.c:1130)."""
    b = blocks.reshape(-1)
    nb = b.shape[0]
    d = f16_to_f32(b["d"])[:, None]
    ql = b["ql"].reshape(nb, 2, 1, 2, 32)  # half, nibble, part of ql, j
    qh = b["qh"].reshape(nb, 2, 1, 1, 32)
    low = np.concatenate([ql & 0xF, ql >> 4], axis=2)  # half, nibble, part, j
    shifts = (2 * np.arange(4, dtype=np.uint8)).reshape(1, 1, 2, 2, 1)
    q = (low.astype(np.int32) | (((qh >> shifts) & 3).astype(np.int32) << 4)) - 32
    s = np.repeat(b["scales"].astype(F32), 16, axis=1).reshape(nb, 2, 2, 2, 32)
    return _unblock(d[:, :, None, None, None] * s * q.astype(F32), blocks)


def dequantize_q8_K(blocks: np.ndarray) -> np.ndarray:
    b = blocks.reshape(-1)
    return _unblock(b["qs"].astype(F32) * b["d"].astype(F32)[:, None], blocks)
