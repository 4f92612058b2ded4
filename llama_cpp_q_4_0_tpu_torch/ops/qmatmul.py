"""Quantized matmul dispatch: ``q_matmul(x, w)`` = x @ W^T for a QTensor or a
dense weight, f32 out.

Routing follows the JAX package's ``ops/qmatmul.py`` on its accelerator,
with its switches read the same way:
  * ``compute_dtype=float32`` (the parity path) takes a true f32 product of
    the f32-dequantized levels and scales, plus ``xg @ gbias`` for an affine
    weight (``xg`` the f32 group sums of x), as ``_xla_qmm`` does; it never
    reaches a kernel.
  * bf16 compute on a weight outside the JAX dispatch's kernel gate (N a
    multiple of 128 and K of 256; a 32001-entry vocabulary or K 8640 fail
    it) takes ``_xla_qmm``'s bf16 product, ``dequant_matmul``, as the JAX
    dispatch does; no kernel runs.
  * bf16 compute on a packed weight without a bias (q4_0, q3_K): with the
    environment variable ``QMM_Q8X`` set (any value; ``bf16`` selects the
    same kernel, whose integer group dots are exact either way), calls of at
    most ``QMM_Q8X_MAX_B`` rows (default 128) go to the int8-activation
    kernel K7, decode included, as the JAX test comes before kfold's.
    Otherwise ``use_kfold`` sends a call to the kfold kernel K2 (by default
    at ``QMM_KFOLD_MAX_B`` = 32 rows or fewer; ``QMM_KFOLD=0`` never,
    ``QMM_KFOLD=1`` at every row count) and the rest to the prefill kernel
    K1.  The row count is the call's B*T: bucket 32 takes kfold, bucket 64
    the prefill kernel, and the output head after ``last_index`` slicing
    (one row) takes kfold.
  * a packed weight with a bias (q4_K, q4_1, q2_K) goes to K5 at every row
    count (kfold refuses a biased tensor);
  * an unpacked weight (q5_0, q8_0, q6_K; q5_1, q5_K with a bias) goes to K6,
    or K6b when it has a bias.
  * a ``LowRankPatched`` weight (an unmerged LoRA adapter, ops/lowrank.py)
    sends its base down the route above and adds the two skinny f32
    products of its delta.

``q_matmul_ref_int8`` is the reference's own arithmetic for every quantized
format (the model's ``compute_dtype="ref_int8"``): activations quantized as
q8_0, q8_1 or q8_K, exact integer group dots, f32 rescale.  It runs plain
torch, on any device.
"""

from __future__ import annotations

import os

import torch

from ..quant.types import K_QUANTS
from .lowrank import LowRankPatched, lowrank_apply
from .qmm import (bf16_f32, qmm_int8, qmm_int8_bias, qmm_packed,
                  qmm_packed_bias, qmm_packed_kfold, qmm_packed_q8x,
                  ieee_div, roundf)
from .qtensor import QTensor

# the most x rows the serving engine flattens into one batched admission
# (its [M_pad, T_pad] prompt matrix), as in the JAX package
MAX_PALLAS_ROWS = 2048


def use_q8x(b: int, w: QTensor) -> bool:
    """The JAX ``QMM_Q8X`` test: a packed weight without a bias, at most
    ``QMM_Q8X_MAX_B`` rows (default 128), with ``QMM_Q8X`` set."""
    return (bool(os.environ.get("QMM_Q8X")) and w.gbias_t is None
            and b <= int(os.environ.get("QMM_Q8X_MAX_B") or 128))


def use_kfold(b: int, w: QTensor) -> bool:
    """The JAX ``use_kfold``: a packed tensor with a nonzero pack zero and no
    bias, and ``QMM_KFOLD`` unset (at most ``QMM_KFOLD_MAX_B`` rows, default
    32), "1" (every row count) or anything but "0" (which turns it off)."""
    env = os.environ.get("QMM_KFOLD", "")
    if env == "0" or w.gbias_t is not None or not w.pack_zero:
        return False
    return env == "1" or b <= int(os.environ.get("QMM_KFOLD_MAX_B", "32"))


def dequant_matmul(x2: torch.Tensor, w: QTensor,
                   compute_dtype=torch.float32) -> torch.Tensor:
    """The JAX ``_xla_qmm`` (its ``use_pallas=False`` path): x2 @ (levels *
    gscale) with both operands rounded to compute_dtype and f32 sums; the
    bias stays out of the dequantized weight and enters as its own f32
    product with the group sums of the un-rounded x."""
    rnd = bf16_f32 if compute_dtype == torch.bfloat16 else (lambda a: a)
    deq = (w.levels_full().float().reshape(-1, w.gsize, w.n_out)
           * w.gscale_full()[:, None, :]).reshape(w.n_in, w.n_out)
    out = rnd(x2.float()) @ rnd(deq)
    gb = w.gbias_full()
    if gb is not None:
        b = x2.shape[0]
        xg = x2.float().reshape(b, -1, w.gsize).sum(-1)
        out = out + xg @ gb
    return out


def q_matmul(x: torch.Tensor, w, *, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x [..., K] @ W[N, K]^T -> [..., N] float32."""
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"compute_dtype {compute_dtype}")
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    if isinstance(w, LowRankPatched):
        # unmerged LoRA: the base on its own route, plus two skinny products
        base = q_matmul(x2, w.base, compute_dtype=compute_dtype)
        return (base + lowrank_apply(x2, w)).reshape(*lead, w.shape[0])
    if not isinstance(w, QTensor):
        # dense (f16/f32 tensors of the model file): a plain product, with
        # bf16-rounded operands in bf16 mode
        if compute_dtype == torch.float32:
            out = x2.float() @ w.float().T
        else:
            out = bf16_f32(x2) @ bf16_f32(w).T
        return out.reshape(*lead, w.shape[0])
    n = w.shape[0]
    if compute_dtype == torch.float32:
        return dequant_matmul(x2, w).reshape(*lead, n)
    if n % 128 or k % 256:  # outside the JAX kernel gate (logical N and K)
        return dequant_matmul(x2, w, torch.bfloat16).reshape(*lead, n)
    x2 = x2.float().contiguous()
    if not w.packed:
        if w.gbias_t is None:
            out = qmm_int8(x2, w.levels_t, w.gscale_t, gsize=w.gsize)
        else:
            out = qmm_int8_bias(x2, w.levels_t, w.gscale_t, w.gbias_t, gsize=w.gsize)
    elif w.gbias_t is not None:
        out = qmm_packed_bias(x2, w.levels_t, w.gscale_t, w.gbias_t,
                              zero=w.pack_zero, gsize=w.gsize)
    elif use_q8x(x2.shape[0], w):
        out = qmm_packed_q8x(x2, w.levels_t, w.gscale_t, zero=w.pack_zero,
                             gsize=w.gsize)
    elif use_kfold(x2.shape[0], w):
        out = qmm_packed_kfold(x2, w.levels_t, w.gscale_t, zero=w.pack_zero,
                               gsize=w.gsize)
    else:
        out = qmm_packed(x2, w.levels_t, w.gscale_t, zero=w.pack_zero, gsize=w.gsize)
    return out.reshape(*lead, n)


def _quantize_row_q8_0(x2: torch.Tensor, gsize: int, f16_d: bool):
    """quantize_row_q8_0 / _q8_1 (ggml.c:1135-1169, 1283-1316): per group
    d = amax/127 (fp16-rounded for q8_0, f32 for q8_1), q = C roundf(x/d).
    Returns (levels f32 [B, G, gsize], d f32 [B, G])."""
    b, k = x2.shape
    xf = x2.float().reshape(b, k // gsize, gsize)
    dq = ieee_div(xf.abs().amax(dim=-1), 127.0)
    idq = torch.where(dq > 0, ieee_div(1.0, dq), torch.zeros_like(dq))
    xq = roundf(xf * idq[..., None])
    if f16_d:
        dq = dq.to(torch.float16).float()
    return xq, dq


def _quantize_row_q8_K(x2: torch.Tensor):
    """quantize_row_q8_K_reference (k_quants.c:1133-1168): per 256-element
    super-block iscale = -128 / (the signed value of largest magnitude),
    q = min(127, round-half-even(iscale * x)), d = 1/iscale.
    Returns (levels f32 [B, G256, 256], d f32 [B, G256])."""
    b, k = x2.shape
    xf = x2.float().reshape(b, k // 256, 256)
    mx = torch.gather(xf, -1, xf.abs().argmax(dim=-1, keepdim=True))[..., 0]
    nonzero = mx != 0
    iscale = torch.where(nonzero, ieee_div(-128.0, mx), torch.zeros_like(mx))
    xq = torch.clamp(torch.round(xf * iscale[..., None]), max=127.0)
    xq = torch.where(nonzero[..., None], xq, torch.zeros_like(xq))
    d = torch.where(nonzero, ieee_div(1.0, torch.where(nonzero, iscale,
                                                       torch.ones_like(iscale))),
                    torch.zeros_like(iscale))
    return xq, d


def q_matmul_ref_int8(x: torch.Tensor, w) -> torch.Tensor:
    """The reference's quantized mul_mat (ggml.c:1618-1747, 11353-11367),
    the JAX package's ``q_matmul_ref_int8``: x quantized as q8_0 for the
    32-group symmetric formats, q8_1 for the affine ones and q8_K for the
    k-quants, then per group ``gscale * d_x * intdot + gbias * d_x * qsum``
    in f32.  The integer dots (|q8| <= 128, |level| <= 63, 256 terms at most)
    are exact in f32.  Dense weights take the f32 product."""
    if not isinstance(w, QTensor):
        return q_matmul(x, w, compute_dtype=torch.float32)
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    b, n, g = x2.shape[0], w.n_out, k // w.gsize
    lv = w.levels_full().float().reshape(g, w.gsize, n)
    sc, gb = w.gscale_full(), w.gbias_full()
    if w.qtype in K_QUANTS:
        xq, d = _quantize_row_q8_K(x2)
        d = d.repeat_interleave(256 // w.gsize, dim=1)
    else:
        xq, d = _quantize_row_q8_0(x2, w.gsize, f16_d=gb is None)
    xq = xq.reshape(b, g, w.gsize)
    dot = torch.einsum("bgk,gkn->bgn", xq, lv)
    out = torch.einsum("bgn,bg,gn->bn", dot, d, sc)
    if gb is not None:
        out = out + torch.einsum("bg,bg,gn->bn", xq.sum(-1), d, gb)
    return out.reshape(*lead, n)
