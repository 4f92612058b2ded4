"""Quantized matmul kernels (csrc/qmm_q4_0.cu, csrc/qmm_int8.cu,
csrc/qmm_q8x.cu) and their plain versions.

Each computes ``x [B, K] @ dequant(W) -> f32 [B, N]`` from one layout of
``ops/qtensor.py``.  Dequantized weights are rounded to bf16 before the
product and x is cast to bf16; the products accumulate in f32.  An affine
bias enters as the full-K seed ``xg . gbias``, with ``xg`` the f32 sums of
un-rounded x over each group.  The JAX package's ``ops/pallas/qmm.py``
kernels they replace:

  qmm_packed        K1  ``_qmm_packed_kernel``        packed, no bias (q4_0)
  qmm_packed_kfold  K2  ``_qmm_packed_kfold_kernel``  same, zero folded, B <= 32
  qmm_packed_bias   K5  ``_qmm_packed_bias_kernel``   packed affine (q4_K,
                                                       q4_1, q2_K)
  qmm_int8          K6  ``_qmm_kernel``               unpacked int8 levels
                                                       (q5_0, q8_0, q6_K)
  qmm_int8_bias     K6b ``_qmm_bias_kernel``          same with a bias
                                                       (q5_1, q5_K)
  qmm_packed_q8x    K7  ``_qmm_packed_q8x_kernel``    q4_0 with int8
                                                       activations

K7 is the other arithmetic: x is quantized per 32-group as the reference's
q8_0 (``quantize_q8x``) and each group dot is an exact integer product,
scaled into f32 as ``dot * d_x * d_w``.

Packed: ``packed`` uint8 ``[K2P, N]`` (low nibble row r, high nibble row
r + K/2, each level + zero), planes f32 ``[2, K2P/g, N]``.  Unpacked:
``levels`` int8 ``[K, N]``, planes f32 ``[K/g, N]``.

For a CPU tensor each wrapper runs the plain PyTorch version; for a CUDA
tensor it launches the kernel or raises.  ``launches`` counts the kernel
launches of each wrapper.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

launches = {"qmm_q4_0": 0, "qmm_q4_0_kfold": 0, "qmm_packed_bias": 0,
            "qmm_int8": 0, "qmm_int8_bias": 0, "qmm_q8x": 0}


def bf16_f32(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and widen back: products of two such values are exact in
    f32, so an f32 matmul of them equals a bf16 dot with f32 accumulation."""
    return t.to(torch.bfloat16).to(torch.float32)


def _q4_0_only(zero: int, gsize: int):
    """K1 and K2 are built for q4_0's (zero 8, 32-groups) alone."""
    if (zero, gsize) != (8, 32):
        raise NotImplementedError(
            f"the q4_0 kernels take pack zero 8 and 32-groups, not zero {zero} "
            f"and {gsize}-groups (q3_K and other symmetric packings are not "
            "ported)")


def _group_sums(x: torch.Tensor, gsize: int) -> torch.Tensor:
    """f32 sums of x [B, K'] over each gsize-group: [B, K'/gsize]."""
    b, k = x.shape
    return x.reshape(b, k // gsize, gsize).sum(-1)


def _packed_weights(packed: torch.Tensor, scales: torch.Tensor, k: int,
                    gsize: int, sub: int):
    """bf16-rounded low and high panels, w = bf16((nibble - sub) * d)."""
    k2, n = k // 2, packed.shape[1]
    g2 = k2 // gsize
    p = packed[:k2].to(torch.int32)
    out = []
    for plane, nib in enumerate((p & 0xF, p >> 4)):
        w = (nib - sub).float().reshape(g2, gsize, n) * scales[plane, :g2, None, :]
        out.append(bf16_f32(w.reshape(k2, n)))
    return out


def qmm_packed_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                     *, zero: int = 8, gsize: int = 32) -> torch.Tensor:
    """Plain version of K1: w = bf16((nibble - 8) * d)."""
    _q4_0_only(zero, gsize)
    k2 = x.shape[1] // 2
    wlo, whi = _packed_weights(packed, scales, x.shape[1], gsize, zero)
    xb = bf16_f32(x.float())
    return xb[:, :k2] @ wlo + xb[:, k2:] @ whi


def qmm_packed_kfold_plain(x: torch.Tensor, packed: torch.Tensor,
                           scales: torch.Tensor, *, zero: int = 8,
                           gsize: int = 32) -> torch.Tensor:
    """Plain version of K2: w = bf16(nibble * d) with no subtract, plus
    -8 * (xg_lo @ d_lo + xg_hi @ d_hi) where xg holds the f32 sums of x over
    each 32-group."""
    _q4_0_only(zero, gsize)
    k2 = x.shape[1] // 2
    g2 = k2 // gsize
    wlo, whi = _packed_weights(packed, scales, x.shape[1], gsize, 0)
    xf = x.float()
    xb = bf16_f32(xf)
    acc = xb[:, :k2] @ wlo + xb[:, k2:] @ whi
    return acc + float(-zero) * (_group_sums(xf[:, :k2], gsize) @ scales[0, :g2]
                                 + _group_sums(xf[:, k2:], gsize) @ scales[1, :g2])


def qmm_packed_bias_plain(x: torch.Tensor, packed: torch.Tensor,
                          scales: torch.Tensor, gbias: torch.Tensor, *, zero: int,
                          gsize: int) -> torch.Tensor:
    """Plain version of K5: the seed xg_lo @ b_lo + xg_hi @ b_hi, plus the
    bf16 products with w = bf16((nibble - zero) * d)."""
    k2 = x.shape[1] // 2
    g2 = k2 // gsize
    wlo, whi = _packed_weights(packed, scales, x.shape[1], gsize, zero)
    xf = x.float()
    xb = bf16_f32(xf)
    seed = (_group_sums(xf[:, :k2], gsize) @ gbias[0, :g2]
            + _group_sums(xf[:, k2:], gsize) @ gbias[1, :g2])
    return seed + (xb[:, :k2] @ wlo + xb[:, k2:] @ whi)


def _int8_weights(levels: torch.Tensor, scales: torch.Tensor, gsize: int):
    k, n = levels.shape
    w = levels.float().reshape(k // gsize, gsize, n) * scales[:, None, :]
    return bf16_f32(w.reshape(k, n))


def qmm_int8_plain(x: torch.Tensor, levels: torch.Tensor, scales: torch.Tensor,
                   *, gsize: int) -> torch.Tensor:
    """Plain version of K6: bf16(x) @ bf16(level * d)."""
    return bf16_f32(x.float()) @ _int8_weights(levels, scales, gsize)


def qmm_int8_bias_plain(x: torch.Tensor, levels: torch.Tensor,
                        scales: torch.Tensor, gbias: torch.Tensor, *,
                        gsize: int) -> torch.Tensor:
    """Plain version of K6b: the seed xg @ gbias, plus K6's product."""
    xf = x.float()
    seed = _group_sums(xf, gsize) @ gbias
    return seed + bf16_f32(xf) @ _int8_weights(levels, scales, gsize)


def roundf(v: torch.Tensor) -> torch.Tensor:
    """C roundf (ties away from zero) in f32: torch.round rounds ties to even,
    and trunc(v + .5) mis-rounds the float just below a tie, so the ties are
    found exactly and moved away from zero."""
    t = torch.trunc(v)
    return torch.where((v - t).abs() == 0.5, t + torch.sign(v), torch.round(v))


def ieee_div(a, b) -> torch.Tensor:
    """a / b in correctly rounded f32 on every device, for a tensor and a
    Python number on either side: PyTorch's CUDA kernels multiply by the
    reciprocal when one side is a Python scalar, which is off by an ulp for
    some values (the reference divides)."""
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(b, a)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(a, b)
    return a / b


def quantize_q8x_plain(x: torch.Tensor, gsize: int = 32):
    """The JAX ``_quantize_q8x`` (quantize_row_q8_0): per gsize-group of x
    [B, K], d = amax/127, q = roundf(x * (1/d)) in f32, d then rounded
    through fp16.  Returns (xq int8 [B, K], d f32 [B, K/gsize]) in logical
    order (the low panel's groups, then the high panel's)."""
    b, k = x.shape
    xf = x.float().reshape(b, k // gsize, gsize)
    dq = ieee_div(xf.abs().amax(dim=-1), 127.0)
    idq = torch.where(dq > 0, ieee_div(1.0, dq), torch.zeros_like(dq))
    xq = roundf(xf * idq[..., None]).to(torch.int8).reshape(b, k)
    return xq, dq.to(torch.float16).float()


def qmm_packed_q8x_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                         *, zero: int = 8, gsize: int = 32) -> torch.Tensor:
    """Plain version of K7: per group g (the low panel's, then the high
    panel's), acc += (float)(xq_g . level_g) * d_x * d_w, the group dots
    exact in f32 (|xq| <= 127, |level| <= 8, 32 terms)."""
    _q4_0_only(zero, gsize)
    b, k = x.shape
    k2, n = k // 2, packed.shape[1]
    g2 = k2 // gsize
    xq, d = quantize_q8x_plain(x, gsize)
    xq = xq.float().reshape(b, 2, g2, gsize)
    d = d.reshape(b, 2, g2)
    p = packed[:k2].to(torch.int32)
    lv = torch.stack([(p & 0xF) - zero, (p >> 4) - zero]).float().reshape(2, g2, gsize, n)
    acc = torch.zeros((b, n), dtype=torch.float32, device=x.device)
    for g in range(g2):
        for h in range(2):
            dot = xq[:, h, g] @ lv[h, g]
            acc = acc + dot * d[:, h, g, None] * scales[h, g]
    return acc


def _check(x: torch.Tensor, w: torch.Tensor, planes: list, *, packed: bool,
           gsize: int):
    """Shapes, dtypes and devices of one call; on CUDA also what the kernels
    take (contiguous, 16-byte aligned, K % 64 == 0, N % 16 == 0, B > 0)."""
    if gsize not in (16, 32):
        raise NotImplementedError(f"{gsize}-groups: the kernels take 16 and 32")
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"bad ranks: x {tuple(x.shape)}, weight {tuple(w.shape)}")
    b, k = x.shape
    rows, n = w.shape
    if packed:
        if k % (2 * gsize) or k // 2 > rows or rows % gsize:
            raise ValueError(f"K={k} does not fit packed rows {rows}")
        want = (2, rows // gsize, n)
    else:
        if k != rows or k % gsize:
            raise ValueError(f"K={k} does not match levels rows {rows}")
        want = (rows // gsize, n)
    for p in planes:
        if tuple(p.shape) != want:
            raise ValueError(f"plane {tuple(p.shape)} != {want}")
    if x.dtype != torch.float32 or w.dtype != (torch.uint8 if packed else torch.int8) \
            or any(p.dtype != torch.float32 for p in planes):
        raise TypeError(f"dtypes {x.dtype}, {w.dtype}, {[p.dtype for p in planes]}; "
                        f"want float32, {'uint8' if packed else 'int8'}, float32")
    if any(t.device != x.device for t in (w, *planes)):
        raise ValueError("x, the weight and its planes lie on different devices")
    if x.device.type == "cuda":
        if not all(t.is_contiguous() for t in (x, w, *planes)):
            raise ValueError("the CUDA kernels take contiguous tensors")
        if n % 16 or b == 0 or k % 64:
            raise ValueError(f"the CUDA kernels take N % 16 == 0, K % 64 == 0 "
                             f"and B > 0 (N={n}, K={k}, B={b})")
        if any(t.data_ptr() % 16 for t in (x, w, *planes)):
            raise ValueError("the CUDA kernels take 16-byte aligned tensors")
    elif x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "qmm_q4_0": {
        "qmm_q4_0": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P], _I),
        "qmm_q4_0_kfold": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        "qmm_packed_bias": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                             _I, _P], _I),
        "qmm_packed_splits": ([_I], _I),
        "qmm_tile_smem": ([_I], _I),
    },
    "qmm_int8": {
        "qmm_int8": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P], _I),
        "qmm_int8_splits": ([_I], _I),
    },
    "qmm_q8x": {
        "qmm_q8x": ([_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
        "q8x_quantize": ([_P, _P, _P, _I, _I, _P], _I),
        "qmm_q8x_splits": ([_I], _I),
    },
}
GEMV_MAX_ROWS = 32  # rows the kernels take in their decode (split-K) form


def _lib(source: str):
    from ..kernels import build

    return build.load(source, _SIGNATURES[source])


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launched(err: int, name: str):
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launches[name] += 1


def _scratch(lib, splits_fn: str, x: torch.Tensor, n: int) -> torch.Tensor | None:
    """The decode form's f32 partial sums of its K splits, [splits, B, N];
    None above GEMV_MAX_ROWS rows."""
    b, k = x.shape
    if b > GEMV_MAX_ROWS:
        return None
    return torch.empty((getattr(lib, splits_fn)(k), b, n), dtype=torch.float32,
                       device=x.device)


# The prefill tile (csrc/qmm_tile.cuh): TILE_N output columns and one of
# TILE_ROWS rows per unit, TILE_STEP_K logical K rows per pipeline step, and
# for an affine weight one extra step per SEED_GROUPS groups of each plane.
TILE_N = 128
TILE_ROWS = (64, 128, 256)
TILE_STEP_K = 64
SEED_GROUPS = 16


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """One tile call: rows per unit (bm), K splits, pipeline steps per unit
    before the split, and ka, the columns of the bf16 x scratch (K, then
    the seed's hi/lo group sums)."""
    bm: int
    splits: int
    steps: int
    ka: int


# Relative time of one pipeline step at each unit height, and the cost model's
# other constants, fitted to a sweep of every (rows per unit, splits) at the
# 7B shapes and 64, 128 and 512 rows (q4_0 and q6_K, H100 80GB HBM3 at
# 700 W) so that its plans come close to the fastest measured ones.
TILE_STEP_COST = {64: 0.7, 128: 1.0, 256: 1.45}
TILE_FILL_STEPS = 2  # a unit's pipeline fill and epilogue, in steps
TILE_SPLITS = (1, 2, 4)
TILE_REDUCE_COST = 1e-6  # per byte the split-K reduce moves (reads splits, writes 1)


def tile_plan(b: int, k: int, n: int, gsize: int, *, packed: bool, bias: bool,
              sms: int) -> TilePlan:
    """Rows per unit and K splits of a tile call.  The persistent loop gives
    each of the sms blocks ceil(units / sms) units; a block's time is its
    steps times the step cost of its unit height, plus the fill, plus the
    reduce pass's bytes when K is split.  Heights of which half or more would
    be padding are not tried; K splits keep at least 4 steps each."""
    planes = 2 if packed else 1
    groups = k // planes // gsize
    seed = planes * -(-groups // SEED_GROUPS) if bias else 0
    steps = k // TILE_STEP_K + seed
    n_tiles = -(-n // TILE_N)
    best = None
    for bm in TILE_ROWS:
        if bm > 64 and bm // 2 >= b:
            break
        units = -(-b // bm) * n_tiles
        for splits in TILE_SPLITS:
            if splits > 1 and splits * 4 > steps:
                break
            cost = ((-(-units * splits // sms) * steps / splits + TILE_FILL_STEPS)
                    * TILE_STEP_COST[bm])
            if splits > 1:
                cost += TILE_REDUCE_COST * (splits + 1) * b * n * 4
            if best is None or cost < best[0]:
                best = (cost, bm, splits)
    _, bm, splits = best
    return TilePlan(bm, splits, steps, k + TILE_STEP_K * seed)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _tile_scratch(x: torch.Tensor, n: int, gsize: int, *, packed: bool,
                  bias: bool):
    """(plan, xa bf16 [B, ka], partial f32 [splits, B, N] or None)."""
    b, k = x.shape
    plan = tile_plan(b, k, n, gsize, packed=packed, bias=bias,
                     sms=_sm_count(x.device.index or 0))
    xa = torch.empty((b, plan.ka), dtype=torch.bfloat16, device=x.device)
    partial = (torch.empty((plan.splits, b, n), dtype=torch.float32, device=x.device)
               if plan.splits > 1 else None)
    return plan, xa, partial


_NO_TILE = TilePlan(0, 0, 0, 0)  # the decode form takes no plan


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def qmm_packed(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *,
               zero: int = 8, gsize: int = 32) -> torch.Tensor:
    """K1, the prefill form (more than 32 rows): f32 [B, N]."""
    _q4_0_only(zero, gsize)
    _check(x, packed, [scales], packed=True, gsize=gsize)
    if x.device.type == "cpu":
        return qmm_packed_plain(x, packed, scales, zero=zero, gsize=gsize)
    b, k = x.shape
    k2p, n = packed.shape
    plan, xa, partial = _tile_scratch(x, n, gsize, packed=True, bias=False)
    out = torch.empty((b, n), dtype=torch.float32, device=x.device)
    err = _lib("qmm_q4_0").qmm_q4_0(x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                                    xa.data_ptr(), _ptr(partial), out.data_ptr(), b, k, n,
                                    k2p // gsize, plan.bm, plan.splits, plan.ka, _stream(x))
    _launched(err, "qmm_q4_0")
    return out


def qmm_packed_kfold(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *,
                     zero: int = 8, gsize: int = 32) -> torch.Tensor:
    """K2, the decode form (32 rows or fewer), zero point folded: f32 [B, N]."""
    _q4_0_only(zero, gsize)
    _check(x, packed, [scales], packed=True, gsize=gsize)
    if x.device.type == "cpu":
        return qmm_packed_kfold_plain(x, packed, scales, zero=zero, gsize=gsize)
    b, k = x.shape
    k2p, n = packed.shape
    if b > GEMV_MAX_ROWS:
        raise ValueError(f"the kfold kernel takes at most {GEMV_MAX_ROWS} rows, not {b}")
    lib = _lib("qmm_q4_0")
    partial = _scratch(lib, "qmm_packed_splits", x, n)
    out = torch.empty((b, n), dtype=torch.float32, device=x.device)
    err = lib.qmm_q4_0_kfold(x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                             partial.data_ptr(), out.data_ptr(), b, k, n,
                             k2p // gsize, _stream(x))
    _launched(err, "qmm_q4_0_kfold")
    return out


def qmm_packed_bias(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                    gbias: torch.Tensor, *, zero: int, gsize: int) -> torch.Tensor:
    """K5, the packed affine matmul at any row count: f32 [B, N]."""
    _check(x, packed, [scales, gbias], packed=True, gsize=gsize)
    if x.device.type == "cpu":
        return qmm_packed_bias_plain(x, packed, scales, gbias, zero=zero, gsize=gsize)
    b, k = x.shape
    k2p, n = packed.shape
    lib = _lib("qmm_q4_0")
    scratch, xa, plan = _scratch(lib, "qmm_packed_splits", x, n), None, _NO_TILE
    if scratch is None:
        plan, xa, scratch = _tile_scratch(x, n, gsize, packed=True, bias=True)
    out = torch.empty((b, n), dtype=torch.float32, device=x.device)
    err = lib.qmm_packed_bias(x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                              gbias.data_ptr(), _ptr(scratch), _ptr(xa), out.data_ptr(),
                              b, k, n, k2p // gsize, zero, gsize, plan.bm, plan.splits,
                              plan.ka, _stream(x))
    _launched(err, "qmm_packed_bias")
    return out


def _int8(x, levels, scales, gbias, gsize, name):
    b, k = x.shape
    n = levels.shape[1]
    lib = _lib("qmm_int8")
    scratch, xa, plan = _scratch(lib, "qmm_int8_splits", x, n), None, _NO_TILE
    if scratch is None:
        plan, xa, scratch = _tile_scratch(x, n, gsize, packed=False,
                                          bias=gbias is not None)
    out = torch.empty((b, n), dtype=torch.float32, device=x.device)
    err = lib.qmm_int8(x.data_ptr(), levels.data_ptr(), scales.data_ptr(),
                       _ptr(gbias), _ptr(scratch), _ptr(xa), out.data_ptr(), b, k, n,
                       gsize, plan.bm, plan.splits, plan.ka, _stream(x))
    _launched(err, name)
    return out


def qmm_int8(x: torch.Tensor, levels: torch.Tensor, scales: torch.Tensor, *,
             gsize: int) -> torch.Tensor:
    """K6, unpacked int8 levels at any row count: f32 [B, N]."""
    _check(x, levels, [scales], packed=False, gsize=gsize)
    if x.device.type == "cpu":
        return qmm_int8_plain(x, levels, scales, gsize=gsize)
    return _int8(x, levels, scales, None, gsize, "qmm_int8")


def qmm_int8_bias(x: torch.Tensor, levels: torch.Tensor, scales: torch.Tensor,
                  gbias: torch.Tensor, *, gsize: int) -> torch.Tensor:
    """K6b, unpacked int8 levels with the affine bias seed: f32 [B, N]."""
    _check(x, levels, [scales, gbias], packed=False, gsize=gsize)
    if x.device.type == "cpu":
        return qmm_int8_bias_plain(x, levels, scales, gbias, gsize=gsize)
    return _int8(x, levels, scales, gbias, gsize, "qmm_int8_bias")


def quantize_q8x(x: torch.Tensor, gsize: int = 32):
    """K7's activation quantizer alone (its first pass): (xq int8 [B, K],
    d f32 [B, K/32]), bit-identical to ``quantize_q8x_plain``."""
    _q4_0_only(8, gsize)
    if x.dim() != 2 or x.dtype != torch.float32 or x.shape[1] % 64:
        raise ValueError(f"x must be f32 [B, K] with K % 64 == 0, not "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return quantize_q8x_plain(x, gsize)
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("the CUDA kernel takes a contiguous, 16-byte aligned x")
    b, k = x.shape
    xq = torch.empty((b, k), dtype=torch.int8, device=x.device)
    d = torch.empty((b, k // gsize), dtype=torch.float32, device=x.device)
    err = _lib("qmm_q8x").q8x_quantize(x.data_ptr(), xq.data_ptr(), d.data_ptr(),
                                        b, k, _stream(x))
    if err:
        raise RuntimeError(f"q8x_quantize launch failed: CUDA error {err}")
    return xq, d


def qmm_packed_q8x(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor, *,
                   zero: int = 8, gsize: int = 32) -> torch.Tensor:
    """K7 at any row count (a split-K GEMV at 32 rows or fewer, an int8
    tensor-core tile above): f32 [B, N]."""
    _q4_0_only(zero, gsize)
    _check(x, packed, [scales], packed=True, gsize=gsize)
    if x.device.type == "cpu":
        return qmm_packed_q8x_plain(x, packed, scales, zero=zero, gsize=gsize)
    b, k = x.shape
    k2p, n = packed.shape
    lib = _lib("qmm_q8x")
    xq = torch.empty((b, k), dtype=torch.int8, device=x.device)
    d = torch.empty((b, k // gsize), dtype=torch.float32, device=x.device)
    partial = _scratch(lib, "qmm_q8x_splits", x, n)
    out = torch.empty((b, n), dtype=torch.float32, device=x.device)
    err = lib.qmm_q8x(x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
                      xq.data_ptr(), d.data_ptr(), _ptr(partial), out.data_ptr(),
                      b, k, n, k2p // gsize, _stream(x))
    _launched(err, "qmm_q8x")
    return out
