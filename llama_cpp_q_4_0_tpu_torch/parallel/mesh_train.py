"""The training forward and loss over a (dp, sp, tp) mesh.

The JAX package trains sharded params with one ``jax.jit``: GSPMD
partitions ``lm_loss`` (or ``stacked_lm_loss``) over whatever mesh the
params and tokens sit on and inserts the collectives.  Here each rank runs
the cacheless forward of ``training/stacked.py::layer_apply`` on its own
slices, with the collectives written out in their autograd forms
(parallel/mesh.py), so that one ``torch.autograd.grad`` on every rank gives
the rank its slice of JAX's gradient:

  tp — the vocabulary-split embedding (masked rows, ``reduce_from``);
       Megatron's "f" at every column-parallel product, the head's included
       (its input's cotangent summed over tp), and ``reduce_from`` after
       ``wo`` and ``w_down``; the head's logits all-gathered along the
       vocabulary (``gather_from``, same=True), so every tp rank computes
       the same loss.  A bf16 column product sums the ranks' f32 partial
       input cotangents and rounds the sum to bf16 once (``_ColProduct``),
       as XLA partitions the transpose of a bf16 dot (an f32 all-reduce of
       the partial dot, then the convert); "f" before a ``Bf16Product``
       would round each rank's part first.  A weight that
       shard_transformer keeps whole (a stacked [L, N, K] block: JAX's
       ``put_weight`` replicates every 3-D leaf) runs whole on every rank;
       a stacked 2-D leaf that the same rule splits (a column bias [L, N]
       over its L, ``b_down`` [L, E] over its E) is gathered whole first.
  sp — this rank's T/sp tokens at their global positions; K and V
       all-gathered over sp inside attention (``gather_from``, same=False),
       as GSPMD gathers them (JAX ``parallel/shard.py::shard_tokens``).
  dp — this rank's rows.

The loss is the local NLL sum, summed over dp and sp, over the global B*T:
JAX's mean over the whole batch, the same on every rank.  The gradients of
the leaves, every one replicated over dp and sp, are then summed over those
axes by the step (training/train.py ``value_and_grad``); a tp-replicated leaf
already holds its whole gradient on every tp rank, through "f".
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..models.config import ModelConfig
from ..models.transformer import Block, TransformerParams, _act, _mm, _norm
from ..ops.layers import attention, rope
from ..training.tree import leaves, map_with_path, tree_map
from .mesh import Mesh, all_reduce, axis_index, copy_to, gather_from, reduce_from
from .shard import leaf_spec


class _ColProduct(torch.autograd.Function):
    """ops/qmatmul.py's Bf16Product of a tp-replicated x and this rank's
    column (N) slice of a dense w, with XLA's partitioned transpose: the
    input's cotangent is the f32 sum over tp of every rank's partial
    product, rounded to bf16 once."""

    @staticmethod
    def forward(ctx, x2, w, mesh):
        xb, wb = x2.to(torch.bfloat16), w.to(torch.bfloat16)
        ctx.save_for_backward(xb, wb)
        ctx.mesh, ctx.dtypes = mesh, (x2.dtype, w.dtype)
        return xb.float() @ wb.float().T

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = all_reduce(g @ wb.float(), ctx.mesh, "tp")
            dx = dx.to(torch.bfloat16).to(ctx.dtypes[0])
        if ctx.needs_input_grad[1]:
            dw = (g.T @ xb.float()).to(torch.bfloat16).to(ctx.dtypes[1])
        return dx, dw, None


def _col(cfg: ModelConfig, x, w, b, mesh: Mesh, split: bool):
    """x @ w.T (+ b) for a column-parallel weight: Megatron's "f" where w is
    this rank's slice."""
    if not split:
        return _mm(x, w, cfg, b)
    if cfg.compute_dtype != "bfloat16" or not isinstance(w, torch.Tensor):
        return _mm(copy_to(x, mesh, "tp"), w, cfg, b)
    out = _ColProduct.apply(x.reshape(-1, x.shape[-1]), w, mesh).reshape(*x.shape[:-1], -1)
    return out if b is None else out + b.float()


def _row(cfg: ModelConfig, x, w, b, mesh: Mesh, split: bool):
    """x @ w.T (+ b) for a row-parallel weight: the local partial sums,
    summed over tp where w is this rank's slice of K, then the bias."""
    out = _mm(x, w, cfg)
    if split:
        out = reduce_from(out, mesh, "tp")
    return out if b is None else out + b.float()


def layer_apply(cfg: ModelConfig, blk: Block, x: torch.Tensor, mesh: Mesh,
                pos: torch.Tensor) -> torch.Tensor:
    """training/stacked.py's layer_apply on this rank's slices: x [B/dp,
    T/sp, E] whole over tp, pos [B/dp, T/sp] the tokens' global positions.
    The block is tp-split (Megatron) or whole, as its wq shows."""
    if blk.wqkv is not None or blk.w_gateup is not None:
        raise ValueError("the sharded training forward takes unfused projections "
                         "(init_transformer's)")
    b, t = x.shape[:2]
    hd = cfg.head_dim
    split = mesh.shape["tp"] > 1 and blk.wq.shape[-2] != cfg.n_head * hd
    n = mesh.shape["tp"] if split else 1
    if cfg.n_head % n or cfg.kv_heads % n:
        raise ValueError(f"{cfg.n_head} heads over {cfg.kv_heads} do not split over tp={n}")
    h = _norm(cfg, x, blk.attn_norm_w, blk.attn_norm_b)
    q = _col(cfg, h, blk.wq, blk.bq, mesh, split).reshape(b, t, cfg.n_head // n, hd)
    k = _col(cfg, h, blk.wk, blk.bk, mesh, split).reshape(b, t, cfg.kv_heads // n, hd)
    v = _col(cfg, h, blk.wv, blk.bv, mesh, split).reshape(b, t, cfg.kv_heads // n, hd)
    if cfg.n_rot > 0:
        q = rope(q, pos, cfg.n_rot, neox=cfg.rope_neox, base=cfg.rope_base)
        k = rope(k, pos, cfg.n_rot, neox=cfg.rope_neox, base=cfg.rope_base)
    k = gather_from(k, mesh, "sp", 1, same=False)
    v = gather_from(v, mesh, "sp", 1, same=False)
    kv_mask = torch.ones((b, k.shape[1]), dtype=torch.bool, device=x.device)
    a = attention(q, k, v, pos, kv_mask, 1.0 / math.sqrt(hd))
    attn_out = _row(cfg, a.reshape(b, t, -1), blk.wo, blk.bo, mesh, split)

    def ffn(h_in):
        if cfg.ffn_gated:
            inner = (_act(cfg, _col(cfg, h_in, blk.w_gate, None, mesh, split))
                     * _col(cfg, h_in, blk.w_up, None, mesh, split))
        else:
            inner = _act(cfg, _col(cfg, h_in, blk.w_up, blk.b_up, mesh, split))
        return _row(cfg, inner, blk.w_down, blk.b_down, mesh, split)

    if cfg.parallel_residual:
        ff_in = h if cfg.ffn_norm_shared else _norm(cfg, x, blk.ffn_norm_w, blk.ffn_norm_b)
        return x + attn_out + ffn(ff_in)
    x = x + attn_out
    return x + ffn(_norm(cfg, x, blk.ffn_norm_w, blk.ffn_norm_b))


def embed(cfg: ModelConfig, params: TransformerParams, tokens: torch.Tensor,
          mesh: Mesh) -> torch.Tensor:
    """[B, T] tokens -> [B, T, E] f32, whole on every tp rank: a
    vocabulary-split table gives the rows it holds, summed over tp."""
    emb = params.tok_embeddings
    if mesh.shape["tp"] == 1 or emb.shape[0] == cfg.n_vocab:
        return emb[tokens].float()
    v_l = emb.shape[0]
    local = tokens - axis_index(mesh, "tp") * v_l
    inr = (local >= 0) & (local < v_l)
    got = emb[torch.where(inr, local, torch.zeros_like(local))].float()
    return reduce_from(torch.where(inr[..., None], got, torch.zeros((), device=got.device)),
                       mesh, "tp")


def logits(cfg: ModelConfig, params: TransformerParams, x: torch.Tensor,
           mesh: Mesh) -> torch.Tensor:
    """The output norm and head: [B, T, E] -> [B, T, V], whole on every tp
    rank (a vocabulary-split head's slices gathered)."""
    x = _norm(cfg, x, params.out_norm_w, params.out_norm_b)
    split = mesh.shape["tp"] > 1 and params.output.shape[0] != cfg.n_vocab
    out = _col(cfg, x, params.output, None, mesh, split)
    return gather_from(out, mesh, "tp", -1, same=True) if split else out


def _whole(w: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """A stacked block leaf whole on every rank (every rank uses it whole,
    so its cotangent is this rank's slice)."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            w = gather_from(w, mesh, axis, dim, same=True)
    return w


def mesh_lm_loss(cfg: ModelConfig, params: TransformerParams, tokens: torch.Tensor,
                 targets: torch.Tensor, mesh: Mesh, *, stacked: bool = False,
                 remat: bool = False) -> torch.Tensor:
    """The mean token NLL of the whole batch, the same on every rank.
    params: this rank's slices (shard_transformer, of stacked_params where
    stacked); tokens, targets: this rank's [B/dp, T/sp] block
    (``shard_tokens(..., sequence_parallel=True)``).  remat: each layer under
    torch.utils.checkpoint (its collectives run again in the backward)."""
    dev = mesh.device
    tokens, targets = tokens.to(dev), targets.to(dev)
    b, t = tokens.shape
    t0 = axis_index(mesh, "sp") * t
    pos = (t0 + torch.arange(t, device=dev))[None, :].expand(b, t)
    x = embed(cfg, params, tokens, mesh)
    if stacked:
        (stack,) = params.blocks
        stack = map_with_path(lambda path, w: _whole(w, leaf_spec(".blocks[0]" + path, w), mesh),
                              stack)
        blocks = [tree_map(lambda w, i=i: w[i], stack)
                  for i in range(leaves(stack)[0].shape[0])]
    else:
        blocks = params.blocks
    for blk in blocks:
        if remat:
            x = checkpoint(layer_apply, cfg, blk, x, mesh, pos, use_reentrant=False)
        else:
            x = layer_apply(cfg, blk, x, mesh, pos)
    logp = torch.log_softmax(logits(cfg, params, x, mesh).float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None].long()).sum()
    total = reduce_from(reduce_from(nll, mesh, "dp"), mesh, "sp")
    return total / (tokens.numel() * mesh.shape["dp"] * mesh.shape["sp"])
