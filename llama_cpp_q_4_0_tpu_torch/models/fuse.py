"""Load-time projection fusion: QKV and gate/up as single matmuls.

wq/wk/wv share their input and reduce dim, and so do SwiGLU's gate and up:
one matmul each saves kernel launches per layer, which is what a decode step
pays for.  Quantized weights of one format fuse by concatenating along the
output (N) columns of the K-major arrays (levels, scale and bias planes); the
forward slices the fused output.  Weights of mixed formats (a k-quant mix
that gives wv more bits than wq and wk) stay separate."""

from __future__ import annotations

import dataclasses

import torch

from ..ops.qtensor import QTensor
from .config import ModelConfig
from .transformer import TransformerParams


def _concat_n(ws: list):
    """Concatenate weights along the output dim; None if they do not match."""
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
    if not any(isinstance(w, QTensor) for w in ws):
        if len({w.shape[1] for w in ws}) != 1 or len({w.dtype for w in ws}) != 1:
            return None
        return torch.cat(list(ws), dim=0)
    return None


def fuse_projections(cfg: ModelConfig, params: TransformerParams) -> TransformerParams:
    """params with per-block fused QKV and gate/up where formats allow (no
    numeric change)."""
    blocks = []
    for blk in params.blocks:
        kw = {}
        qkv = _concat_n([blk.wq, blk.wk, blk.wv])
        if qkv is not None:
            kw.update(wqkv=qkv, wq=None, wk=None, wv=None)
        gu = _concat_n([blk.w_gate, blk.w_up])
        if gu is not None:
            kw.update(w_gateup=gu, w_gate=None, w_up=None)
        blocks.append(dataclasses.replace(blk, **kw) if kw else blk)
    return dataclasses.replace(params, blocks=tuple(blocks))
