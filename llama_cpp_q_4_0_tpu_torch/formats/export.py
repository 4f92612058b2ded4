"""Export in-memory params to a ggjt model file.

Inverse of models/loading.py, for the trainer's --model-out
(save_as_llama_model, train-text-from-scratch.cpp).  Only the llama layout
is written; 2-D tensors go out as f32 or f16, or block-quantized on the host
by the registry's quantizers (the JAX package's bytes)."""

from __future__ import annotations

import numpy as np
import torch

from ..models.config import ModelConfig, llama_n_ff
from ..models.transformer import TransformerParams
from ..ops.qtensor import QTensor
from ..quant.registry import quantize_bytes
from ..quant.types import GGMLType, LlamaFType
from .ggjt import GGJTWriter

_FTYPES = {GGMLType.F32: LlamaFType.ALL_F32, GGMLType.F16: LlamaFType.MOSTLY_F16,
           GGMLType.Q4_0: LlamaFType.MOSTLY_Q4_0, GGMLType.Q4_1: LlamaFType.MOSTLY_Q4_1,
           GGMLType.Q5_0: LlamaFType.MOSTLY_Q5_0, GGMLType.Q5_1: LlamaFType.MOSTLY_Q5_1,
           GGMLType.Q8_0: LlamaFType.MOSTLY_Q8_0}


def _to_f32(w) -> np.ndarray:
    if isinstance(w, QTensor):
        w = w.dequantize_t().T
    return w.detach().to(device="cpu", dtype=torch.float32).contiguous().numpy()


def _find_n_mult(n_embd: int, n_ff: int) -> int:
    for n_mult in range(1, 32769):
        if llama_n_ff(n_embd, n_mult) == n_ff:
            return n_mult
    raise ValueError(f"no n_mult reproduces n_ff={n_ff} at n_embd={n_embd}")


def save_llama_ggjt(path: str, cfg: ModelConfig, params: TransformerParams,
                    vocab: list[tuple[bytes, float]], qtype: GGMLType = GGMLType.F32) -> None:
    """Unfused llama params (init_transformer's or a loader's with
    fuse=False) -> a ggjt v3 file of ftype qtype."""
    assert cfg.arch == "llama", cfg.arch
    ftype = _FTYPES[qtype]
    hparams = {"n_vocab": cfg.n_vocab, "n_embd": cfg.n_embd,
               "n_mult": _find_n_mult(cfg.n_embd, cfg.n_ff), "n_head": cfg.n_head,
               "n_layer": cfg.n_layer, "n_rot": cfg.n_rot}

    def emit(w: GGJTWriter, name: str, t):
        arr = _to_f32(t)
        ne = tuple(reversed(arr.shape))
        if arr.ndim == 2 and qtype == GGMLType.F16:
            w.write_tensor(name, GGMLType.F16, ne, arr.astype(np.float16).tobytes())
        elif arr.ndim == 2 and qtype != GGMLType.F32:
            w.write_tensor(name, qtype, ne, quantize_bytes(arr, qtype))
        else:
            w.write_tensor(name, GGMLType.F32, ne, arr.tobytes())

    with GGJTWriter(path, "llama", hparams, int(ftype), vocab) as w:
        emit(w, "tok_embeddings.weight", params.tok_embeddings)
        emit(w, "norm.weight", params.out_norm_w)
        emit(w, "output.weight", params.output)
        for i, blk in enumerate(params.blocks):
            p = f"layers.{i}."
            emit(w, p + "attention_norm.weight", blk.attn_norm_w)
            emit(w, p + "attention.wq.weight", blk.wq)
            emit(w, p + "attention.wk.weight", blk.wk)
            emit(w, p + "attention.wv.weight", blk.wv)
            emit(w, p + "attention.wo.weight", blk.wo)
            emit(w, p + "ffn_norm.weight", blk.ffn_norm_w)
            emit(w, p + "feed_forward.w1.weight", blk.w_gate)
            emit(w, p + "feed_forward.w2.weight", blk.w_down)
            emit(w, p + "feed_forward.w3.weight", blk.w_up)
