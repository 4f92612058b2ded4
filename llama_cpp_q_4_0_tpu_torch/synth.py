"""Synthetic weights built on the device from a torch.Generator: LLaMA
(``build_llama``) and the GPT-NeoX, Falcon and Bonsai families
(``build_gptneox``, ``build_falcon``, ``build_bonsai``).

Random levels and group scales (and, for the affine k-quants, group biases)
in the loader's layouts: padding rows and planes zero, projections fused
where the formats allow.  Decode reads every weight byte once per token
whatever its value, so the timing matches a real checkpoint of the same
shapes and formats.

``ftype`` picks the file type's mix of formats, as the JAX package's
``formats/quantize.py`` assigns them:

  q4_0    every 2-D weight q4_0 (the weights bench.py builds); q4_1, q5_0,
          q5_1 and q8_0 the same in those formats;
  q3_K_M  q3_K for wq, wk, w1, w3 and the token embeddings, q4_K for wv, wo
          and w2, q6_K for the output head;
  q4_K_M  q4_K everywhere, q6_K for the output head and for wv and w2 in
          the layers ``use_more_bits`` picks (half of them);
  q5_K_M  the same with q5_K in place of q4_K.

The families take one block format for every 2-D weight (q4_0 by default),
norm weights of one, and small random f32 biases where the family has them
(norms; GPT-NeoX's projections).

q3_K weights are packed symmetric nibbles (levels -4..3 stored as 0..7, pack
zero 4) over 16-groups with no bias, the layout the loader gives them.  The
block formats' scales and biases are fp16 values, as a file stores them, so
that ``cast_scales_f16`` holds them exactly.
"""

from __future__ import annotations

import dataclasses

import torch

from . import resolve_device
from .models.config import ModelConfig
from .models.fuse import fuse_projections
from .models.transformer import Block, TransformerParams
from .ops.qtensor import _F16_EXACT_QTYPES, QTensor
from .quant.q4_0 import PACK_ZERO, k2_padded
from .quant.types import GGMLType

FTYPES = {"q4_0": GGMLType.Q4_0, "q4_1": GGMLType.Q4_1, "q5_0": GGMLType.Q5_0,
          "q5_1": GGMLType.Q5_1, "q8_0": GGMLType.Q8_0, "q3_K_M": GGMLType.Q3_K,
          "q4_K_M": GGMLType.Q4_K, "q5_K_M": GGMLType.Q5_K}


def use_more_bits(i_layer: int, num_layers: int) -> bool:
    """The layers whose wv and w2 a _M k-quant mix stores in q6_K."""
    return (i_layer < num_layers // 8 or i_layer >= 7 * num_layers // 8
            or (i_layer - num_layers // 8) % 3 == 2)


def _uniform(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)


def _plane_values(p: torch.Tensor, qtype: GGMLType) -> torch.Tensor:
    """A block format's planes rounded to the fp16 values its file holds."""
    return p.half().float() if qtype in _F16_EXACT_QTYPES else p


def _packed(gen, n, k, qtype, zero, gsize, bias, device, mask=0xFF) -> QTensor:
    k2, k2p = k // 2, k2_padded(k)
    packed = torch.zeros((k2p, n), dtype=torch.uint8, device=device)
    packed[:k2] = torch.randint(0, 256, (k2, n), generator=gen, device=device,
                                dtype=torch.uint8) & mask
    g2 = k2 // gsize

    def plane(lo, hi):
        p = torch.zeros((2, k2p // gsize, n), dtype=torch.float32, device=device)
        p[:, :g2] = _uniform(gen, (2, g2, n), lo, hi, device)
        return _plane_values(p, qtype)

    return QTensor(levels_t=packed, gscale_t=plane(0.005, 0.015), gsize=gsize,
                   qtype=qtype, shape=(n, k), pack_zero=zero,
                   gbias_t=plane(-0.08, 0.0) if bias else None)


def _unpacked(gen, n, k, qtype, lo, hi, gsize, scale, bias, device) -> QTensor:
    levels = torch.randint(lo, hi + 1, (k, n), generator=gen, device=device,
                           dtype=torch.int8)
    g = k // gsize

    def plane(lo, hi):
        return _plane_values(_uniform(gen, (g, n), lo, hi, device), qtype)

    return QTensor(levels_t=levels, gscale_t=plane(*scale), gsize=gsize, qtype=qtype,
                   shape=(n, k), gbias_t=plane(-0.08, 0.0) if bias else None)


def synth_qtensor(gen: torch.Generator, n: int, k: int, device,
                  qtype: GGMLType = GGMLType.Q4_0) -> QTensor:
    """One random [N, K] weight in the device layout of ``qtype``."""
    if qtype == GGMLType.Q4_0:
        return _packed(gen, n, k, qtype, PACK_ZERO, 32, False, device)
    if qtype == GGMLType.Q4_1:
        return _packed(gen, n, k, qtype, 0, 32, True, device)
    if qtype == GGMLType.Q3_K:
        return _packed(gen, n, k, qtype, 4, 16, False, device, mask=0x77)
    if qtype == GGMLType.Q4_K:
        return _packed(gen, n, k, qtype, 0, 32, True, device)
    if qtype == GGMLType.Q2_K:
        return _packed(gen, n, k, qtype, 0, 16, True, device)
    if qtype == GGMLType.Q8_0:
        return _unpacked(gen, n, k, qtype, -127, 127, 32, (0.0005, 0.0015), False, device)
    if qtype == GGMLType.Q5_0:
        return _unpacked(gen, n, k, qtype, -16, 15, 32, (0.0025, 0.0075), False, device)
    if qtype == GGMLType.Q5_1:
        return _unpacked(gen, n, k, qtype, 0, 31, 32, (0.0025, 0.0075), True, device)
    if qtype == GGMLType.Q5_K:
        return _unpacked(gen, n, k, qtype, 0, 31, 32, (0.0025, 0.0075), True, device)
    if qtype == GGMLType.Q6_K:
        return _unpacked(gen, n, k, qtype, -32, 31, 16, (0.0005, 0.0015), False, device)
    raise NotImplementedError(f"no synthetic {qtype.name} weights")


def build_llama(n_layer: int = 32, n_embd: int = 4096, n_head: int = 32,
                n_ff: int = 11008, n_vocab: int = 32000, n_ctx: int = 2048,
                *, device=None, seed: int = 0, ftype: str = "q4_0"):
    """(cfg, params) of a LLaMA at the given widths (default 7B) in the file
    type ``ftype`` (see the module docstring)."""
    if ftype not in FTYPES:
        raise NotImplementedError(f"no synthetic {ftype} mix")
    base = FTYPES[ftype]
    more = GGMLType.Q6_K if ftype.endswith("_K_M") else base
    dev = resolve_device(device)
    cfg = ModelConfig.llama(n_vocab=n_vocab, n_embd=n_embd, n_mult=256,
                            n_head=n_head, n_layer=n_layer,
                            n_rot=n_embd // n_head, n_ctx=n_ctx)
    cfg = dataclasses.replace(cfg, n_ff=n_ff)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    e = n_embd

    def q(n, k, qtype=base):
        return synth_qtensor(gen, n, k, dev, qtype)

    def ones():
        return torch.ones((e,), dtype=torch.float32, device=dev)

    def block(i):
        wide, wo = (more if use_more_bits(i, n_layer) else base), base
        if ftype == "q3_K_M":  # wv, wo and w2 in q4_K in every layer
            wide = wo = GGMLType.Q4_K
        return Block(attn_norm_w=ones(), wq=q(e, e), wk=q(e, e), wv=q(e, e, wide),
                     wo=q(e, e, wo), ffn_norm_w=ones(), w_gate=q(n_ff, e),
                     w_up=q(n_ff, e), w_down=q(e, n_ff, wide))

    blocks = tuple(block(i) for i in range(n_layer))
    params = TransformerParams(tok_embeddings=q(n_vocab, e), blocks=blocks,
                               out_norm_w=ones(), out_norm_b=None,
                               output=q(n_vocab, e, more))
    return cfg, fuse_projections(cfg, params)


def _family(cfg: ModelConfig, ftype: str, dev, seed: int):
    """(cfg, params) of a gptneox, falcon or bonsai cfg: each 2-D weight in
    ftype's block format, Q, K and V (and their biases) fused at kv_heads
    width."""
    if ftype not in FTYPES or ftype.endswith("_K_M"):
        raise NotImplementedError(f"no synthetic {ftype} {cfg.arch}")
    base = FTYPES[ftype]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    e, kvd, f = cfg.n_embd, cfg.kv_heads * cfg.head_dim, cfg.n_ff

    def q(n, k):
        return synth_qtensor(gen, n, k, dev, base)

    def ones():
        return torch.ones((e,), dtype=torch.float32, device=dev)

    def bias(n):
        return 0.01 * torch.randn((n,), generator=gen, device=dev)

    def opt_bias(n):
        return bias(n) if cfg.qkv_bias else None

    def block():
        blk = Block(attn_norm_w=ones(), attn_norm_b=bias(e),
                    wq=q(e, e), wk=q(kvd, e), wv=q(kvd, e),
                    bq=opt_bias(e), bk=opt_bias(kvd), bv=opt_bias(kvd),
                    wo=q(e, e), bo=opt_bias(e), w_up=q(f, e), b_up=opt_bias(f),
                    w_down=q(e, f), b_down=opt_bias(e))
        if not cfg.ffn_norm_shared:  # gptneox's post-attention norm
            blk.ffn_norm_w, blk.ffn_norm_b = ones(), bias(e)
        return blk

    blocks = tuple(block() for _ in range(cfg.n_layer))
    params = TransformerParams(tok_embeddings=q(cfg.n_vocab, e), blocks=blocks,
                               out_norm_w=ones(), out_norm_b=bias(e),
                               output=q(cfg.n_vocab, e))
    return cfg, fuse_projections(cfg, params)


def build_gptneox(n_layer: int = 16, n_embd: int = 6144, n_head: int = 48,
                  n_vocab: int = 50688, n_ctx: int = 2048, rotary_pct: float = 0.25,
                  *, device=None, seed: int = 0, ftype: str = "q4_0"):
    """(cfg, params) of a GPT-NeoX with the parallel residual (default:
    StableLM-Base-Alpha-7B's widths, n_rot = rotary_pct * head_dim = 32, at
    16 layers)."""
    dev = resolve_device(device)
    cfg = ModelConfig.gptneox(n_vocab, n_embd, n_head, n_layer,
                              int(rotary_pct * (n_embd // n_head)), n_ctx=n_ctx)
    return _family(cfg, ftype, dev, seed)


def build_falcon(n_layer: int = 32, n_embd: int = 4544, n_head: int = 71,
                 n_vocab: int = 65024, n_ctx: int = 2048, *, device=None, seed: int = 0,
                 ftype: str = "q4_0"):
    """(cfg, params) of a Falcon with parallel attention (default: Falcon-7B's
    widths, one KV head of 64)."""
    dev = resolve_device(device)
    cfg = ModelConfig.falcon(n_vocab, n_embd, n_head, n_layer, n_ctx=n_ctx)
    return _family(cfg, ftype, dev, seed)


def build_bonsai(n_layer: int = 2, n_embd: int = 2048, n_head: int = 16,
                 n_vocab: int = 32000, n_ctx: int = 2048, *, device=None, seed: int = 0,
                 ftype: str = "q4_0"):
    """(cfg, params) of a Bonsai with parallel attention (default widths
    chosen inside the kernels' gate: head_dim 128, one KV head)."""
    dev = resolve_device(device)
    cfg = ModelConfig.bonsai(n_vocab, n_embd, n_head, n_layer, n_ctx=n_ctx)
    return _family(cfg, ftype, dev, seed)
