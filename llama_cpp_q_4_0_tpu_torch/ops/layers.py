"""Model-graph ops: RMSNorm, SiLU, RoPE and attention over the KV cache.

RoPE modes follow ggml_rope: ``neox=False`` rotates adjacent pairs (x[2i],
x[2i+1]) — LLaMA's ggml layout — and ``neox=True`` rotates half-split pairs
(x[i], x[i + n_rot/2]).
"""

from __future__ import annotations

import os

import torch

from .kvcache import QuantKV
from .mha_decode import mha_decode
from .qmm import bf16_f32


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    """ggml_rms_norm followed by the weight multiply."""
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(dt)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def rope(x: torch.Tensor, positions: torch.Tensor, n_rot: int, *, neox: bool,
         base: float = 10000.0) -> torch.Tensor:
    """Rotary embedding over the first n_rot dims of each head.
    x: [..., T, n_head, head_dim]; positions: [..., T] integer."""
    head_dim = x.shape[-1]
    dt = x.dtype
    xf = x.float()
    half = n_rot // 2
    exps = -torch.arange(half, dtype=torch.float32, device=x.device) * 2.0 / n_rot
    # the base filled in on the device: torch.tensor(base, device=...) is a
    # host copy, which synchronises and cannot be captured in a CUDA graph
    freqs = torch.pow(torch.full((), base, dtype=torch.float32, device=x.device), exps)
    theta = positions.float()[..., None, None] * freqs
    cos, sin = torch.cos(theta), torch.sin(theta)
    if neox:
        x0, x1 = xf[..., :half], xf[..., half:n_rot]
        rotated = torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    else:
        xr = xf[..., :n_rot].reshape(*xf.shape[:-1], half, 2)
        x0, x1 = xr[..., 0], xr[..., 1]
        rotated = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos],
                              dim=-1).reshape(*xf.shape[:-1], n_rot)
    if n_rot < head_dim:
        rotated = torch.cat([rotated, xf[..., n_rot:]], dim=-1)
    return rotated.to(dt)


def use_flash_prefill(t: int, hd: int, device: torch.device) -> bool:
    """Whole-prompt prefill eligibility for the flash kernel: the JAX rule
    (``FLASH_PREFILL=0`` opts out; prompt buckets of at least 128 that are
    multiples of 128, head widths that are multiples of 128), on the card.
    The kernel's wrapper raises for a head width it is not compiled for."""
    if os.environ.get("FLASH_PREFILL", "1") == "0":
        return False
    return (device.type == "cuda" and t >= 128 and t % 128 == 0
            and hd % 128 == 0)


def use_fused_decode(rep: int, t: int, s: int, hd: int, device: torch.device) -> bool:
    """The JAX package's ``_use_fused_decode`` rule for the decode attention
    kernel: ``FUSED_ATTN`` set, on the card, at most ``FUSED_MAX_T`` (default
    8) query tokens, head widths that are multiples of 64 and windows of at
    least 128 slots that are multiples of 256 (or of themselves below 256).
    The kernel's wrapper raises for a head width it is not compiled for and
    above 16 query tokens.  ``rep`` does not enter, as in the JAX rule."""
    if not os.environ.get("FUSED_ATTN"):
        return False
    max_t = int(os.environ.get("FUSED_MAX_T", "8"))
    return (device.type == "cuda" and t <= max_t and hd % 64 == 0
            and s % min(256, s) == 0 and s >= 128)


def attention(q: torch.Tensor, k_cache, v_cache, q_positions: torch.Tensor,
              kv_mask: torch.Tensor, scale: float) -> torch.Tensor:
    """Causal attention over a preallocated KV buffer.

    q [B, T, n_head, hd]; k_cache/v_cache [B, S, n_kv_head, hd] float tensors
    or QuantKV; q_positions [B, T] absolute positions; kv_mask [B, S] bool,
    True where a slot holds a valid token.  Returns f32 [B, T, n_head, hd].

    As in the JAX package, a bf16 or int8 cache feeds bf16-rounded operands
    (q, the stored K/V and the probabilities) to f32-accumulated products,
    unless ``ATTN_MXU=0``; an f32 cache, or any cache with ``ATTN_MXU=0``,
    keeps the exact f32 chain.  QuantKV scales multiply the
    scores (K) and the probabilities (V); query heads are grouped onto their
    KV head (GQA/MQA) without repeating the cache.  Where ``use_fused_decode``
    holds, the decode attention kernel (ops/mha_decode.py) computes the f32
    chain on the stored values instead."""

    def split(c):
        if isinstance(c, QuantKV):
            return c.data, c.scale
        return c, None

    kd, ks = split(k_cache)
    vd, vs = split(v_cache)
    b, t, n_head, hd = q.shape
    s, n_kv = kd.shape[1], kd.shape[2]
    if n_head % n_kv:
        raise ValueError(f"{n_head} query heads over {n_kv} kv heads")
    rep = n_head // n_kv
    if use_fused_decode(rep, t, s, hd, q.device):
        return mha_decode(q.float().contiguous(), kd, ks, vd, vs, q_positions,
                          kv_mask, scale)
    # the storage-dtype (bf16 operand) path
    low = kd.dtype != torch.float32 and os.environ.get("ATTN_MXU", "1") != "0"
    rnd = bf16_f32 if low else (lambda a: a)
    qg = rnd(q.float()).reshape(b, t, n_kv, rep, hd)
    scores = torch.einsum("btgrd,bsgd->bgrts", qg, rnd(kd.float())) * scale
    if ks is not None:
        scores = scores * ks.permute(0, 2, 1)[:, :, None, None, :]
    kv_pos = torch.arange(s, device=q.device)[None, None, None, None, :]
    causal = kv_pos <= q_positions[:, None, None, :, None]
    valid = kv_mask[:, None, None, None, :] & causal
    scores = scores.masked_fill(~valid, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(valid, probs, torch.zeros((), device=q.device))
    if vs is not None:
        probs = probs * vs.permute(0, 2, 1)[:, :, None, None, :]
    out = torch.einsum("bgrts,bsgd->btgrd", rnd(probs), rnd(vd.float()))
    return out.reshape(b, t, n_head, hd)
