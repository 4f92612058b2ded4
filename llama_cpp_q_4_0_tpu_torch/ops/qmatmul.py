"""Quantized matmul dispatch: ``q_matmul(x, w)`` = x @ W^T for a QTensor or a
dense weight, f32 out.

Routing follows the default path of the JAX package's ``ops/qmatmul.py``:
  * ``compute_dtype=float32`` (the parity path) takes a true f32 product of
    the f32-dequantized levels and scales, plus ``xg @ gbias`` for an affine
    weight (``xg`` the f32 group sums of x), as ``_xla_qmm`` does; it never
    reaches a kernel.
  * bf16 compute on a packed weight without a bias (q4_0) goes to the kfold
    decode kernel K2 for calls of ``KFOLD_MAX_ROWS`` rows or fewer and to the
    prefill kernel K1 above.  The row count is the call's B*T: bucket 32
    takes kfold, bucket 64 the prefill kernel, and the output head after
    ``last_index`` slicing (one row) takes kfold.
  * a packed weight with a bias (q4_K, q4_1, q2_K) goes to K5 at every row
    count (kfold refuses a biased tensor);
  * an unpacked weight (q5_0, q8_0, q6_K; q5_1, q5_K with a bias) goes to K6,
    or K6b when it has a bias.
"""

from __future__ import annotations

import torch

from .qmm import (bf16_f32, qmm_int8, qmm_int8_bias, qmm_packed,
                  qmm_packed_bias, qmm_packed_kfold)
from .qtensor import QTensor

KFOLD_MAX_ROWS = 32


def use_kfold(b: int, w: QTensor) -> bool:
    """kfold needs a packed tensor with a nonzero pack zero and no bias (q4_0
    always has zero 8)."""
    return (w.gbias_t is None and bool(w.pack_zero)
            and b <= KFOLD_MAX_ROWS)


def _f32_qmm(x2: torch.Tensor, w: QTensor) -> torch.Tensor:
    """The JAX ``_xla_qmm`` in f32: the bias stays out of the dequantized
    weight and enters as its own product with the group sums of x."""
    out = x2.float() @ (w.levels_full().float().reshape(-1, w.gsize, w.n_out)
                        * w.gscale_full()[:, None, :]).reshape(w.n_in, w.n_out)
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
        return _f32_qmm(x2, w).reshape(*lead, n)
    x2 = x2.float().contiguous()
    if not w.packed:
        if w.gbias_t is None:
            out = qmm_int8(x2, w.levels_t, w.gscale_t, gsize=w.gsize)
        else:
            out = qmm_int8_bias(x2, w.levels_t, w.gscale_t, w.gbias_t, gsize=w.gsize)
    elif w.gbias_t is not None:
        out = qmm_packed_bias(x2, w.levels_t, w.gscale_t, w.gbias_t,
                              zero=w.pack_zero, gsize=w.gsize)
    elif use_kfold(x2.shape[0], w):
        out = qmm_packed_kfold(x2, w.levels_t, w.gscale_t, zero=w.pack_zero,
                               gsize=w.gsize)
    else:
        out = qmm_packed(x2, w.levels_t, w.gscale_t, zero=w.pack_zero, gsize=w.gsize)
    return out.reshape(*lead, n)
