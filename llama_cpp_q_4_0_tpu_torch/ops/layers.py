"""Model-graph ops: norms, activations, RoPE and attention over the KV cache.

RoPE modes follow ggml_rope: ``neox=False`` rotates adjacent pairs (x[2i],
x[2i+1]) — LLaMA's ggml layout — and ``neox=True`` rotates half-split pairs
(x[i], x[i + n_rot/2]), the GPT-NeoX family's.

The parity modes (``ModelConfig.act_f16_table``) reproduce ggml's own
arithmetic: ``rms_norm_ref`` (the square sum accumulated as a double),
``act_f16_table`` (the fp16 activation tables) and ``attention``'s
``ref_f16_softmax`` (the fp16 exp table).
"""

from __future__ import annotations

import math
import os

import torch

from .kvcache import QuantKV
from .mha_decode import mha_decode
from .qmm import bf16_f32, ieee_div


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    """ggml_rms_norm followed by the weight multiply."""
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(dt)


def rms_norm_ref(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6):
    """ggml_rms_norm bit for bit as the JAX ``rms_norm_ref`` computes it: the
    f32 squares summed in order by a Kahan-compensated sum (the reference
    sums them in double), the mean divided in f32, scale = 1 / sqrt(mean +
    eps).  Returns f32.  A sequential loop over the row: parity gates only."""
    xf = x.float()
    xx = (xf * xf).movedim(-1, 0)
    s = torch.zeros_like(xx[0])
    c = torch.zeros_like(xx[0])
    for v in xx:
        y = v - c
        t = s + y
        c = (t - s) - y
        s = t
    mean = ieee_div(s[..., None], float(x.shape[-1]))
    scale = ieee_div(1.0, torch.sqrt(mean + eps))
    return (xf * scale) * weight.float()


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5):
    """ggml_norm and the weight multiply and bias add (GPT-NeoX, Falcon)."""
    dt = x.dtype
    xf = x.float()
    xc = xf - xf.mean(dim=-1, keepdim=True)
    var = (xc * xc).mean(dim=-1, keepdim=True)
    out = xc * torch.rsqrt(var + eps) * weight.float()
    return (out + bias.float()).to(dt)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh form of GELU (the JAX ``jax.nn.gelu(approximate=True)``, the
    formula ggml's table holds)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def act_f16_table(fn, x: torch.Tensor) -> torch.Tensor:
    """ggml's fp16 lookup-table activation: y = f16(fn(f16(x))) read back as
    f32 (the reference builds with GGML_GELU_FP16 / GGML_SILU_FP16)."""
    xh = x.to(torch.float16).float()
    return fn(xh).to(torch.float16).float()


def alibi_bias(n_head: int, kv_len: int, n_head_log2_bias: float = 8.0,
               device=None) -> torch.Tensor:
    """ggml_alibi's slopes times the slot positions: f32 [n_head, kv_len]
    (used by some NeoX-family models; no ported family calls it)."""
    n2 = 2 ** math.floor(math.log2(n_head))
    m0 = 2.0 ** (-8.0 / n2)
    m1 = 2.0 ** (-4.0 / n2)
    slopes = [m0 ** (h + 1) if h < n2 else m1 ** (2 * (h - n2) + 1)
              for h in range(n_head)]
    slopes = torch.tensor(slopes, dtype=torch.float32, device=device)
    pos = torch.arange(kv_len, dtype=torch.float32, device=device)
    return slopes[:, None] * pos[None, :]


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


def _softmax_ref_f16(scores: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """ggml's table softmax: e = f16(exp(f16(s - max))) over the valid slots,
    then divided by its sum."""
    m = scores.masked_fill(~valid, float("-inf")).amax(dim=-1, keepdim=True)
    sh = (scores - m).to(torch.float16).float()
    e = torch.exp(sh).to(torch.float16).float()
    e = torch.where(valid, e, torch.zeros((), device=e.device))
    return e / e.sum(dim=-1, keepdim=True)


def attention(q: torch.Tensor, k_cache, v_cache, q_positions: torch.Tensor,
              kv_mask: torch.Tensor, scale: float, *,
              ref_f16_softmax: bool = False) -> torch.Tensor:
    """Causal attention over a preallocated KV buffer.

    q [B, T, n_head, hd]; k_cache/v_cache [B, S, n_kv_head, hd] float tensors
    or QuantKV; q_positions [B, T] absolute positions; kv_mask [B, S] bool,
    True where a slot holds a valid token.  Returns f32 [B, T, n_head, hd].

    As in the JAX package, a cache of any dtype but f32 (bf16, f16, int8,
    e4m3) feeds bf16-rounded operands (q, the stored K/V, exact in bf16 for
    e4m3, and the probabilities) to f32-accumulated products, unless
    ``ATTN_MXU=0``; an f32 cache, or any cache with ``ATTN_MXU=0``, keeps the
    exact f32 chain.  QuantKV scales multiply the scores (K) and the
    probabilities (V); query heads are grouped onto their
    KV head (GQA/MQA) without repeating the cache.  Where ``use_fused_decode``
    holds, the decode attention kernel (ops/mha_decode.py) computes the f32
    chain on the stored values instead.  ``ref_f16_softmax`` (the parity
    mode) takes ggml's table softmax on the f32 chain: neither the kernel
    nor the bf16 operands."""

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
    if not ref_f16_softmax and use_fused_decode(rep, t, s, hd, q.device):
        return mha_decode(q.float().contiguous(), kd, ks, vd, vs, q_positions,
                          kv_mask, scale)
    # the storage-dtype (bf16 operand) path
    low = (not ref_f16_softmax and kd.dtype != torch.float32
           and os.environ.get("ATTN_MXU", "1") != "0")
    rnd = bf16_f32 if low else (lambda a: a)
    qg = rnd(q.float()).reshape(b, t, n_kv, rep, hd)
    scores = torch.einsum("btgrd,bsgd->bgrts", qg, rnd(kd.float())) * scale
    if ks is not None:
        scores = scores * ks.permute(0, 2, 1)[:, :, None, None, :]
    kv_pos = torch.arange(s, device=q.device)[None, None, None, None, :]
    causal = kv_pos <= q_positions[:, None, None, :, None]
    valid = kv_mask[:, None, None, None, :] & causal
    scores = scores.masked_fill(~valid, float("-inf"))
    if ref_f16_softmax:
        probs = _softmax_ref_f16(scores, valid)
    else:
        probs = torch.softmax(scores, dim=-1)
        probs = torch.where(valid, probs, torch.zeros((), device=q.device))
    if vs is not None:
        probs = probs * vs.permute(0, 2, 1)[:, :, None, None, :]
    out = torch.einsum("bgrts,bsgd->btgrd", rnd(probs), rnd(vd.float()))
    return out.reshape(b, t, n_head, hd)
