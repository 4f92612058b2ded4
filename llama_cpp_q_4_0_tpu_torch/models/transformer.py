"""Decoder-only transformer forward: one function for four families,
switched by ModelConfig.

  llama   — RMSNorm, separate wq/wk/wv, adjacent-pair RoPE, SwiGLU, serial
  gptneox — LayerNorm and biases, fused QKV, partial NeoX RoPE, GELU MLP,
            parallel or serial residual with its own post-attention norm
  falcon  — LayerNorm, fused MQA QKV (one KV head), NeoX RoPE, GELU MLP,
            parallel residual sharing the input norm
  bonsai  — RMSNorm with a bias and a min shift, fused MQA QKV, NeoX RoPE,
            the hybrid relu/gelu MLP, parallel residual sharing the input norm

The KV cache is a preallocated [B, S, H_kv, D] buffer per layer.  K is roped
at insert time with its absolute position (cache slot == position), and
attention masks the slots beyond the valid prefix instead of growing views.
Unlike the JAX package, which is functional and donates its buffers, the
forward writes each layer's K/V into the cache tensors IN PLACE.  ``n_past``
and ``last_index`` may be 0-d int64 tensors on the device, as the JAX forward
takes them traced: nothing in the forward then reads a value on the host, so
``runtime/context.py`` captures it in a CUDA graph and replays it for any
``n_past``.  ``n_past`` may also be a [B] int64 tensor, each row of the batch
at its own position (continuous batching, the JAX forward's per-row form).
The NeoX family's "rope the whole cache from position 0" is the same as
roping K at insert, since a cache slot is its position.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from .. import resolve_device
from ..ops.kvcache import F8, QuantKV, quantize_kv, raw, to_cache
from ..ops.layers import (act_f16_table, attention, gelu, layer_norm, rms_norm,
                          rms_norm_ref, rope, silu)
from ..ops.qmatmul import q_matmul, q_matmul_ref_int8
from ..ops.qtensor import QTensor
from .config import ModelConfig

Param = Any  # QTensor | torch.Tensor | None


@dataclass
class Block:
    attn_norm_w: Param = None
    attn_norm_b: Param = None
    wq: Param = None
    wk: Param = None
    wv: Param = None
    bq: Param = None
    bk: Param = None
    bv: Param = None
    wo: Param = None
    bo: Param = None
    ffn_norm_w: Param = None
    ffn_norm_b: Param = None
    w_gate: Param = None  # llama w1
    w_up: Param = None  # llama w3 / the MLP's fc
    w_down: Param = None  # llama w2 / the MLP's proj
    b_up: Param = None
    b_down: Param = None
    # load-time fused projections (models/fuse.py), set instead of
    # wq/wk/wv (and their biases) and w_gate/w_up
    wqkv: Param = None
    b_qkv: Param = None
    w_gateup: Param = None


@dataclass
class TransformerParams:
    tok_embeddings: Param
    blocks: tuple
    out_norm_w: Param
    out_norm_b: Param
    output: Param


def _compute_dtype(cfg: ModelConfig):
    return torch.float32 if cfg.compute_dtype == "float32" else torch.bfloat16


def bonsai_rms_norm(x, weight, bias, eps: float = 1e-5):
    """BonsaiRMSNorm: the T5 layer norm shifted positive, with a bias.  The
    family's ``_norm`` calls it with this default eps, not cfg.norm_eps, as
    the JAX package does."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    cur = xf * torch.rsqrt(var + eps)
    cur = cur - cur.amin(dim=-1, keepdim=True) + eps
    return cur * weight.float() + bias.float()


def grelu(x):
    """Bonsai's hybrid activation: relu above zero, x (tanh(x sqrt(2/pi)) +
    1) below."""
    x1 = torch.clamp(x, max=0.0)
    return torch.clamp(x, min=0.0) + x1 * (torch.tanh(x1 * math.sqrt(2.0 / math.pi)) + 1.0)


def _norm(cfg: ModelConfig, x, w, b):
    if cfg.act_f16_table and cfg.norm == "rmsnorm":
        return rms_norm_ref(x, w, cfg.norm_eps)
    if cfg.norm == "rmsnorm":
        return rms_norm(x, w, cfg.norm_eps)
    if cfg.norm == "layernorm":
        return layer_norm(x, w, b, cfg.norm_eps)
    if cfg.norm == "rmsnorm_bias":
        return bonsai_rms_norm(x, w, b)
    raise ValueError(cfg.norm)


_ACTS = {"silu": silu, "gelu": gelu, "bonsai_hybrid": grelu}


def _act(cfg: ModelConfig, x):
    try:
        fn = _ACTS[cfg.act]
    except KeyError:
        raise ValueError(cfg.act) from None
    if cfg.act_f16_table:
        return act_f16_table(fn, x)
    return fn(x)


def _mm(x, w, cfg: ModelConfig, b=None):
    if cfg.compute_dtype == "ref_int8":
        out = q_matmul_ref_int8(x, w)
    else:
        out = q_matmul(x, w, compute_dtype=_compute_dtype(cfg))
    if b is not None:
        out = out + b.float()
    return out


def _embed(params: TransformerParams, tokens: torch.Tensor) -> torch.Tensor:
    emb = params.tok_embeddings
    if isinstance(emb, QTensor):
        return emb.rows(tokens)
    return emb[tokens].float()


def _qkv(cfg: ModelConfig, blk: Block, h, b: int, t: int):
    hq, hkv, hd = cfg.n_head, cfg.kv_heads, cfg.head_dim
    if blk.wqkv is not None:
        qkv = _mm(h, blk.wqkv, cfg, blk.b_qkv)
        e, kvd = hq * hd, hkv * hd
        q, k, v = qkv[..., :e], qkv[..., e:e + kvd], qkv[..., e + kvd:]
    else:
        q, k, v = (_mm(h, blk.wq, cfg, blk.bq), _mm(h, blk.wk, cfg, blk.bk),
                   _mm(h, blk.wv, cfg, blk.bv))
    return (q.reshape(b, t, hq, hd), k.reshape(b, t, hkv, hd),
            v.reshape(b, t, hkv, hd))


def _ffn(cfg: ModelConfig, blk: Block, h):
    if not cfg.ffn_gated:
        up = _act(cfg, _mm(h, blk.w_up, cfg, blk.b_up))
        return _mm(up, blk.w_down, cfg, blk.b_down)
    if blk.w_gateup is not None:
        gu = _mm(h, blk.w_gateup, cfg)
        f = gu.shape[-1] // 2
        inner = _act(cfg, gu[..., :f]) * gu[..., f:]
    else:
        inner = _act(cfg, _mm(h, blk.w_gate, cfg)) * _mm(h, blk.w_up, cfg)
    return _mm(inner, blk.w_down, cfg)


def _kv_view(cache, w: int):
    if isinstance(cache, QuantKV):
        return QuantKV(cache.data[:, :w], cache.scale[:, :w])
    return cache[:, :w]


def _insert_slots(n_past: torch.Tensor, s: int, t: int) -> torch.Tensor:
    """The T cache slots a call writes, on the device: from n_past (a 0-d
    device tensor) clamped to [0, S - T], exactly as the JAX package's
    dynamic_update_slice clamps its start, so a bucket-padded block near the
    end of the cache lands earlier than n_past (a quirk of the reference,
    kept for parity)."""
    start = n_past.clamp(max=s - t).clamp(min=0)
    return start + torch.arange(t, device=n_past.device)


def _cache_insert(cache, val: torch.Tensor, slots: torch.Tensor):
    """Write val [B, T, H, D] into the cache slots ``_insert_slots`` gives,
    in place (an f8 cache through its bytes)."""
    if isinstance(cache, QuantKV):
        q, sc = quantize_kv(val)
        cache.data.index_copy_(1, slots, q)
        cache.scale.index_copy_(1, slots, sc)
    else:
        raw(cache).index_copy_(1, slots, raw(to_cache(val, cache.dtype)))


def _row_slots(n_past: torch.Tensor, s: int, t: int):
    """The per-row insert of a [B] n_past: the flat index (row * S + slot)
    of each of the B*T writes, and the index j into val of the write each one
    carries.  Row r writes its T tokens at slots n_past[r] + j.  JAX scatters
    them with ``mode="promise_in_bounds"``; here a write at a slot >= S (a
    frozen speculative row runs past the cache) is dropped: it is sent to
    slot S - 1 carrying the same bytes as the row's own write there, or, when
    the row writes nothing below S, the bytes slot S - 1 already holds
    (``_row_values``), so that duplicate writes of one slot never disagree."""
    b = n_past.shape[0]
    dev = n_past.device
    pos = n_past[:, None] + torch.arange(t, device=dev)  # [B, T]
    inb = pos < s
    # the write of slot S - 1 in the row, where the row makes one
    last = (s - 1 - n_past).clamp(0, t - 1)[:, None].expand(b, t)
    j = torch.where(inb, torch.arange(t, device=dev)[None, :], last)
    keep_old = (n_past >= s)[:, None] & ~inb  # no write of the row is in range
    rows = torch.arange(b, device=dev)[:, None]
    flat = (rows * s + pos.clamp(max=s - 1)).reshape(-1)
    return flat, j, keep_old


def _row_values(buf: torch.Tensor, vals: torch.Tensor, j, keep_old, s: int):
    """The B*T values the per-row insert writes into buf [B, S, ...]: vals
    [B, T, ...] taken at j, and buf's slot S - 1 where keep_old."""
    b, t = j.shape
    src = vals.gather(1, j.reshape(b, t, *([1] * (vals.dim() - 2))).expand(vals.shape))
    old = buf[:, s - 1:s].expand(src.shape)
    mask = keep_old.reshape(b, t, *([1] * (vals.dim() - 2)))
    return torch.where(mask, old, src).reshape(b * t, *vals.shape[2:])


def _cache_insert_rows(cache, val: torch.Tensor, slots):
    """Write val [B, T, H, D] at each row's own slots, ``_row_slots``, in
    place; a QuantKV writes its levels and its scales alike."""
    flat, j, keep_old = slots
    s = cache.shape[1]
    if isinstance(cache, QuantKV):
        pairs = zip((cache.data, cache.scale), quantize_kv(val))
    else:
        pairs = ((raw(cache), raw(to_cache(val, cache.dtype))),)
    for buf, v in pairs:
        b = buf.shape[0]
        buf.view(b * s, *buf.shape[2:]).index_copy_(
            0, flat, _row_values(buf, v, j, keep_old, s))


def _device_int(v, device) -> torch.Tensor:
    """A 0-d int64 tensor on device: v itself, or a Python int filled in on
    the device (no host copy, which would synchronise)."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.full((), v, dtype=torch.int64, device=device)


def _roundtrip(cache, val: torch.Tensor) -> torch.Tensor:
    """What the cache gives back for val: the K/V an attention_fn sees."""
    if isinstance(cache, QuantKV):
        q, sc = quantize_kv(val)
        return (q.float() * sc[..., None]).contiguous()
    return to_cache(val, cache.dtype).float().contiguous()


@torch.no_grad()
def forward(cfg: ModelConfig, params: TransformerParams, tokens: torch.Tensor,
            n_past, cache_k: list, cache_v: list, *,
            last_only: bool = False, with_embedding: bool = False,
            kv_window: int | None = None, last_index=None, attention_fn=None):
    """tokens [B, T] int (or raw input embeddings [B, T, E] float, the JAX
    forward's llama_eval_embd entry) -> logits [B, T | 1, n_vocab] f32;
    updates the caches.  With with_embedding, (logits, x) where x is the
    hidden state after the output norm (llama_get_embeddings).

    n_past and last_index: Python ints or 0-d int64 tensors on the device;
    n_past may also be a [B] int64 tensor, a position per row (the JAX
    forward's scatter insert, whose writes at slots >= S are dropped here).
    kv_window restricts attention to the first kv_window cache slots (the
    caller guarantees n_past + T <= kv_window).  last_index keeps one row (the
    real last token of a bucket-padded prompt) before the output norm and
    head; a [B] int64 tensor keeps each row's own (the serving engine's
    batched admissions).  attention_fn(q, k, v, scale) replaces the cache-window attention
    over this call's fresh, cache-round-tripped K/V; valid only when
    n_past == 0 and the call covers the whole sequence."""
    b, t = tokens.shape[:2]
    dev = tokens.device
    s = cache_k[0].shape[1]
    w = s if kv_window is None else min(kv_window, s)
    n_past = _device_int(n_past, dev)
    per_row = n_past.dim() == 1
    # [B, 1] or [1, 1]: each row's start
    start = n_past[:, None] if per_row else n_past.reshape(1, 1)
    pos = (start + torch.arange(t, device=dev, dtype=torch.int64)[None, :]).expand(b, t)
    kv_mask = (torch.arange(w, device=dev)[None, :] < start + t).expand(b, w)
    if per_row:
        slots = _row_slots(n_past, s, t)
        insert = _cache_insert_rows
    else:
        slots = _insert_slots(n_past, s, t)
        insert = _cache_insert
    scale = 1.0 / math.sqrt(cfg.head_dim)

    if tokens.dim() == 3:  # raw input embeddings (JAX forward, llama_eval_embd)
        x = tokens.float()
    else:
        x = _embed(params, tokens)  # [B, T, E] f32
    for layer, blk in enumerate(params.blocks):
        h = _norm(cfg, x, blk.attn_norm_w, blk.attn_norm_b)
        q, k, v = _qkv(cfg, blk, h, b, t)
        if cfg.n_rot > 0:
            q = rope(q, pos, cfg.n_rot, neox=cfg.rope_neox, base=cfg.rope_base)
            k = rope(k, pos, cfg.n_rot, neox=cfg.rope_neox, base=cfg.rope_base)
        insert(cache_k[layer], k, slots)
        insert(cache_v[layer], v, slots)
        if attention_fn is not None:
            a = attention_fn(q.contiguous(), _roundtrip(cache_k[layer], k),
                             _roundtrip(cache_v[layer], v), scale)
        else:
            a = attention(q, _kv_view(cache_k[layer], w),
                          _kv_view(cache_v[layer], w), pos, kv_mask, scale,
                          ref_f16_softmax=cfg.act_f16_table)
        attn_out = _mm(a.reshape(b, t, cfg.n_embd), blk.wo, cfg, blk.bo)
        if cfg.parallel_residual:
            ff_in = h if cfg.ffn_norm_shared else _norm(
                cfg, x, blk.ffn_norm_w, blk.ffn_norm_b)
            x = x + attn_out + _ffn(cfg, blk, ff_in)
        else:
            x = x + attn_out
            x = x + _ffn(cfg, blk, _norm(cfg, x, blk.ffn_norm_w, blk.ffn_norm_b))

    if last_index is not None:
        li = _device_int(last_index, dev)
        if li.dim():
            x = x.gather(1, li.reshape(b, 1, 1).expand(b, 1, x.shape[2]))
        else:
            x = x.index_select(1, li.reshape(1))
    elif last_only:
        x = x[:, -1:]
    x = _norm(cfg, x, params.out_norm_w, params.out_norm_b)
    logits = _mm(x, params.output, cfg)
    if with_embedding:
        return logits, x
    return logits


def init_cache(cfg: ModelConfig, batch: int, n_ctx: int | None = None,
               dtype=torch.bfloat16, device=None):
    """Preallocated per-layer KV buffers on ``device`` (default cuda; raises
    without CUDA unless device="cpu"); dtype torch.int8 selects the
    scaled-int8 QuantKV layout, any float dtype (torch.float8_e4m3fn
    included) a plain cast cache."""
    device = resolve_device(device)
    s = n_ctx or cfg.n_ctx
    shape = (batch, s, cfg.kv_heads, cfg.head_dim)

    def mk():
        if dtype == torch.int8:
            return QuantKV(torch.zeros(shape, dtype=torch.int8, device=device),
                           torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device))
        return torch.zeros(shape, dtype=torch.uint8 if dtype == F8 else dtype,
                           device=device).view(dtype)

    return ([mk() for _ in range(cfg.n_layer)],
            [mk() for _ in range(cfg.n_layer)])
