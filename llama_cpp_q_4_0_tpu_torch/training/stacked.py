"""Stacked-layer training forward and rematerialization.

The per-layer loop of models/transformer.py is right for inference (each
layer owns differently quantized weights); the JAX package's trainer can
also stack every layer's parameters along a leading [L] axis and scan one
layer body over them, with ``jax.checkpoint`` on the body trading FLOPs for
activation memory.  Here the stacked params keep that layout (the
checkpoint's keys and shapes are the JAX package's), the layers run in a
loop over views of the stacked leaves, and remat is
``torch.utils.checkpoint`` around each layer: its activations are freed
after the forward and recomputed in the backward."""

from __future__ import annotations

import math
from functools import partial
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..models.config import ModelConfig
from ..models.transformer import Block, TransformerParams, _embed, _ffn, _mm, _norm, _qkv
from ..ops.layers import attention, rope
from .train import Transform, cross_entropy_loss, make_train_step
from .tree import leaves, tree_map


def stack_params(params: TransformerParams) -> TransformerParams:
    """blocks (L x Block) -> one Block of [L, ...] leaves."""
    first = params.blocks[0]
    stacked = Block(**{f: (None if getattr(first, f) is None else
                           torch.stack([getattr(b, f) for b in params.blocks]))
                       for f in first.__dataclass_fields__})
    return TransformerParams(tok_embeddings=params.tok_embeddings, blocks=(stacked,),
                             out_norm_w=params.out_norm_w, out_norm_b=params.out_norm_b,
                             output=params.output)


def unstack_params(params: TransformerParams, n_layer: int) -> TransformerParams:
    """Inverse of stack_params (to hand a trained model to Context)."""
    (stacked,) = params.blocks
    blocks = tuple(tree_map(lambda x: x[i], stacked) for i in range(n_layer))
    return TransformerParams(tok_embeddings=params.tok_embeddings, blocks=blocks,
                             out_norm_w=params.out_norm_w, out_norm_b=params.out_norm_b,
                             output=params.output)


def layer_apply(cfg: ModelConfig, blk: Block, x: torch.Tensor) -> torch.Tensor:
    """One transformer layer on a whole causal sequence [B, T, E] (the
    training form: no KV cache, attention over this call's own K/V)."""
    b, t = x.shape[:2]
    pos = torch.arange(t, device=x.device)[None, :].expand(b, t)
    kv_mask = torch.ones((b, t), dtype=torch.bool, device=x.device)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    h = _norm(cfg, x, blk.attn_norm_w, blk.attn_norm_b)
    q, k, v = _qkv(cfg, blk, h, b, t)
    if cfg.n_rot > 0:
        q = rope(q, pos, cfg.n_rot, neox=cfg.rope_neox, base=cfg.rope_base)
        k = rope(k, pos, cfg.n_rot, neox=cfg.rope_neox, base=cfg.rope_base)
    a = attention(q, k, v, pos, kv_mask, scale)
    attn_out = _mm(a.reshape(b, t, cfg.n_head * cfg.head_dim), blk.wo, cfg, blk.bo)
    if cfg.parallel_residual:
        ff_in = h if cfg.ffn_norm_shared else _norm(cfg, x, blk.ffn_norm_w, blk.ffn_norm_b)
        return x + attn_out + _ffn(cfg, blk, ff_in)
    x = x + attn_out
    return x + _ffn(cfg, blk, _norm(cfg, x, blk.ffn_norm_w, blk.ffn_norm_b))


def stacked_forward(cfg: ModelConfig, params: TransformerParams, tokens: torch.Tensor, *,
                    remat: bool = False) -> torch.Tensor:
    """Full-sequence causal logits [B, T, V]; params from stack_params."""
    (stacked,) = params.blocks
    x = _embed(params, tokens)
    for i in range(leaves(stacked)[0].shape[0]):
        blk = tree_map(lambda w: w[i], stacked)
        if remat:
            x = checkpoint(layer_apply, cfg, blk, x, use_reentrant=False)
        else:
            x = layer_apply(cfg, blk, x)
    x = _norm(cfg, x, params.out_norm_w, params.out_norm_b)
    return _mm(x, params.output, cfg)


def stacked_lm_loss(cfg: ModelConfig, params, tokens, targets, *,
                    remat: bool = False, mesh=None) -> torch.Tensor:
    """mesh: params are this rank's slices of the stacked params
    (shard_transformer keeps their [L, N, K] blocks whole, as JAX's) and
    tokens/targets its block (parallel/mesh_train.py)."""
    if mesh is not None:
        from ..parallel.mesh_train import mesh_lm_loss

        return mesh_lm_loss(cfg, params, tokens, targets, mesh, stacked=True, remat=remat)
    return cross_entropy_loss(stacked_forward(cfg, params, tokens, remat=remat), targets)


def make_stacked_train_step(cfg: ModelConfig, tx: Transform, *,
                            remat: bool = True, mesh=None) -> Callable:
    """The stacked train step: make_train_step over stacked_lm_loss, with
    remat-bounded activation memory; mesh as make_train_step's."""
    return make_train_step(cfg, tx, partial(stacked_lm_loss, cfg, remat=remat, mesh=mesh),
                           mesh=mesh)
