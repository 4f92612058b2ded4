"""Load-time projection fusion: QKV and gate/up as single matmuls.

wq/wk/wv share their input and reduce dim, and so do SwiGLU's gate and up:
one matmul each saves kernel launches per layer, which is what a decode step
pays for.  Quantized weights of one format fuse by concatenating along the
output (N) columns of the K-major arrays (levels, scale and bias planes); the
forward slices the fused output, at ``kv_heads`` width for K and V (one
head each in the MQA families).  Their biases fuse with them, all or none.
Weights of mixed formats (a k-quant mix that gives wv more bits than wq and
wk) stay separate.  ``defuse_projections`` undoes it."""

from __future__ import annotations

import dataclasses

import torch

from ..ops.qtensor import QTensor
from .config import ModelConfig
from .transformer import TransformerParams


def _concat_n(ws: list):
    """Concatenate weights along the output dim; None if they do not match
    (a LowRankPatched weight, an unmerged adapter, never does: its group
    stays unfused, the numbers the JAX package gives unfused)."""
    if any(w is None for w in ws):
        return None
    if all(isinstance(w, QTensor) for w in ws):
        w0 = ws[0]
        if not all(w.qtype == w0.qtype and w.gsize == w0.gsize
                   and w.pack_zero == w0.pack_zero and w.shape[1] == w0.shape[1]
                   and w.levels_t.shape[0] == w0.levels_t.shape[0] for w in ws):
            return None
        axis_s = 2 if w0.packed else 1
        return QTensor(
            levels_t=torch.cat([w.levels_t for w in ws], dim=1),
            gscale_t=torch.cat([w.gscale_t for w in ws], dim=axis_s),
            gbias_t=None if w0.gbias_t is None else torch.cat(
                [w.gbias_t for w in ws], dim=axis_s),
            gsize=w0.gsize, qtype=w0.qtype,
            shape=(sum(w.shape[0] for w in ws), w0.shape[1]),
            pack_zero=w0.pack_zero,
        )
    if all(isinstance(w, torch.Tensor) for w in ws):
        if len({w.shape[1] for w in ws}) != 1 or len({w.dtype for w in ws}) != 1:
            return None
        return torch.cat(list(ws), dim=0)
    return None


def _concat_bias(bs: list):
    """(the concatenated biases, True), (None, True) when none has one, and
    (None, False) when only some do: then the weights stay separate."""
    if all(b is None for b in bs):
        return None, True
    if any(b is None for b in bs):
        return None, False
    return torch.cat(list(bs), dim=0), True


def _slice_n(w, lo: int, hi: int):
    """Output rows lo..hi of a weight (the inverse of _concat_n), as
    contiguous tensors of their own, which the kernels take."""
    if isinstance(w, QTensor):
        def cols(a):
            if a is None:
                return None
            return (a[:, :, lo:hi] if w.packed else a[:, lo:hi]).contiguous()

        return QTensor(levels_t=w.levels_t[:, lo:hi].contiguous(), gscale_t=cols(w.gscale_t),
                       gbias_t=cols(w.gbias_t), gsize=w.gsize, qtype=w.qtype,
                       shape=(hi - lo, w.shape[1]), pack_zero=w.pack_zero)
    return w[lo:hi].contiguous()


def defuse_projections(cfg: ModelConfig, params: TransformerParams) -> TransformerParams:
    """The inverse of fuse_projections: wq/wk/wv (and their biases) and
    w_gate/w_up sliced back out of the fused tensors."""
    e = cfg.n_embd
    kvd = cfg.kv_heads * cfg.head_dim
    blocks = []
    for blk in params.blocks:
        kw = {}
        if blk.wqkv is not None:
            kw.update(wq=_slice_n(blk.wqkv, 0, e), wk=_slice_n(blk.wqkv, e, e + kvd),
                      wv=_slice_n(blk.wqkv, e + kvd, e + 2 * kvd), wqkv=None)
            if blk.b_qkv is not None:
                kw.update(bq=_slice_n(blk.b_qkv, 0, e), bk=_slice_n(blk.b_qkv, e, e + kvd),
                          bv=_slice_n(blk.b_qkv, e + kvd, e + 2 * kvd), b_qkv=None)
        if blk.w_gateup is not None:
            f = blk.w_gateup.shape[0] // 2
            kw.update(w_gate=_slice_n(blk.w_gateup, 0, f),
                      w_up=_slice_n(blk.w_gateup, f, 2 * f), w_gateup=None)
        blocks.append(dataclasses.replace(blk, **kw) if kw else blk)
    return dataclasses.replace(params, blocks=tuple(blocks))


def fuse_projections(cfg: ModelConfig, params: TransformerParams) -> TransformerParams:
    """params with per-block fused QKV (with its biases) and, in the gated
    MLP, gate/up where formats allow (no numeric change)."""
    blocks = []
    for blk in params.blocks:
        kw = {}
        qkv = _concat_n([blk.wq, blk.wk, blk.wv])
        if qkv is not None:
            b_qkv, ok = _concat_bias([blk.bq, blk.bk, blk.bv])
            if ok:
                kw.update(wqkv=qkv, b_qkv=b_qkv, wq=None, wk=None, wv=None,
                          bq=None, bk=None, bv=None)
        if cfg.ffn_gated:
            gu = _concat_n([blk.w_gate, blk.w_up])
            if gu is not None:
                kw.update(w_gateup=gu, w_gate=None, w_up=None)
        blocks.append(dataclasses.replace(blk, **kw) if kw else blk)
    return dataclasses.replace(params, blocks=tuple(blocks))
