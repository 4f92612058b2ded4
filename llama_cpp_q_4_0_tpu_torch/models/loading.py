"""GGJT file -> device parameters for llama, gptneox, falcon and bonsai.

q4_0 weights whose K is a multiple of 64 take the direct repack of
``quant/q4_0.py`` (the JAX ``_q4_0_native``); other q4_0 shapes and every
other quantized type (q4_1, q5_0, q5_1, q8_0, q2_K..q6_K) goes through the planar
repack and ``QTensor.from_planar``, as in the JAX package's loader.  llama's
wq/wk stay in their on-disk permuted layout because rope(neox=False)
implements the matching adjacent-pair rotation.

The other families store Q, K and V as one tensor, which the loader splits
into row groups (quant blocks are per row, so the split is exact), each
through the planar repack as the JAX ``_load_rows`` does (a q4_0 group then
takes the pack zero of its own levels):

  gptneox       per-head interleave [q_h | k_h | v_h] x n_head
  falcon/bonsai [Q rows 0..E | K rows E..E+D | V rows E+D..E+2D] (one KV head)

and ``fuse_projections`` joins them again at ``kv_heads`` width.  RWKV is not
ported."""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..formats.ggjt import GGJTFile
from ..ops.qtensor import QTensor
from ..quant.pack import PLANAR_TYPES, pack_planar
from ..quant.q4_0 import PACK_ZERO, pack_q4_0
from ..quant.types import GGMLType, type_traits
from .config import ModelConfig
from .transformer import Block, TransformerParams


def load_tensor(gf: GGJTFile, name: str, device: torch.device,
                dense_dtype=torch.bfloat16):
    """2-D quantized -> QTensor; 2-D float -> dense tensor; 1-D -> f32 tensor."""
    t = gf.tensors[name]
    if t.qtype in (GGMLType.F32, GGMLType.F16):
        arr = torch.from_numpy(gf.tensor_f32(name))
        dt = torch.float32 if len(t.shape) == 1 else dense_dtype
        return arr.to(device=device, dtype=dt)
    if t.qtype == GGMLType.Q4_0 and len(t.shape) == 2 and t.shape[1] % 64 == 0:
        n, k = t.shape
        packed, scales = pack_q4_0(gf.tensor_bytes(name), n, k)
        return QTensor(levels_t=torch.from_numpy(packed).to(device),
                       gscale_t=torch.from_numpy(scales).to(device),
                       gsize=32, qtype=GGMLType.Q4_0, shape=(n, k),
                       pack_zero=PACK_ZERO)
    if len(t.shape) != 2 or t.qtype not in PLANAR_TYPES:
        raise NotImplementedError(f"{name}: {len(t.shape)}-D {t.qtype.name} "
                                  "tensors are not ported")
    return QTensor.from_planar(pack_planar(gf.tensor_blocks(name), t.qtype, t.shape),
                               device)


def _load_rows(gf: GGJTFile, name: str, row_groups: list, device: torch.device,
               dense_dtype=torch.bfloat16) -> list:
    """A [N, K] tensor split into the rows of each group (the fused QKV)."""
    t = gf.tensors[name]
    n, k = t.shape
    if t.qtype in (GGMLType.F32, GGMLType.F16):
        arr = torch.from_numpy(gf.tensor_f32(name))
        return [arr[torch.from_numpy(g)].to(device=device, dtype=dense_dtype)
                for g in row_groups]
    if len(t.shape) != 2 or t.qtype not in PLANAR_TYPES:
        raise NotImplementedError(f"{name}: {len(t.shape)}-D {t.qtype.name} "
                                  "tensors are not ported")
    blocks = gf.tensor_blocks(name).reshape(n, k // type_traits(t.qtype).block_size)
    return [QTensor.from_planar(pack_planar(blocks[g], t.qtype, (len(g), k)), device)
            for g in row_groups]


def _split_1d(gf: GGJTFile, name: str, row_groups: list, device: torch.device) -> list:
    arr = torch.from_numpy(gf.tensor_f32(name))
    return [arr[torch.from_numpy(g)].to(device=device, dtype=torch.float32)
            for g in row_groups]


def _qkv_groups(cfg: ModelConfig) -> list:
    """The rows of Q, K and V in the fused tensor."""
    e, d, h = cfg.n_embd, cfg.head_dim, cfg.n_head
    if cfg.arch == "gptneox":
        base = np.arange(d)
        return [np.concatenate([hh * 3 * d + j * d + base for hh in range(h)])
                for j in range(3)]
    # falcon / bonsai MQA: contiguous [Q | K (one head) | V (one head)]
    return [np.arange(e), np.arange(e, e + d), np.arange(e + d, e + 2 * d)]


def config_from_ggjt(gf: GGJTFile, n_ctx: int = 2048, **kw) -> ModelConfig:
    """The ModelConfig of a file's header (``gf.arch``, as it was read)."""
    hp = gf.hparams
    if gf.arch == "llama":
        return ModelConfig.llama(
            n_vocab=hp["n_vocab"], n_embd=hp["n_embd"], n_mult=hp["n_mult"],
            n_head=hp["n_head"], n_layer=hp["n_layer"], n_rot=hp["n_rot"],
            n_ctx=n_ctx, **kw)
    if gf.arch == "gptneox":
        return ModelConfig.gptneox(
            hp["n_vocab"], hp["n_embd"], hp["n_head"], hp["n_layer"], hp["n_rot"],
            hp.get("use_parallel_residual", 1), n_ctx=n_ctx, **kw)
    if gf.arch in ("falcon", "bonsai"):
        make = ModelConfig.falcon if gf.arch == "falcon" else ModelConfig.bonsai
        return make(hp["n_vocab"], hp["n_embd"], hp["n_head"], hp["n_layer"],
                    hp.get("parallel_attn", 1), n_ctx=n_ctx, **kw)
    raise NotImplementedError(f"{gf.arch} models are not ported yet")


def load_transformer(gf: GGJTFile, cfg: ModelConfig, *, device=None,
                     fuse: bool = True) -> TransformerParams:
    """Load a llama, gptneox, falcon or bonsai GGJT file onto ``device``
    (default cuda; raises without CUDA unless device="cpu")."""
    if cfg.arch not in ("llama", "gptneox", "falcon", "bonsai"):
        raise NotImplementedError(f"{cfg.arch} models are not ported yet")
    dev = resolve_device(device)
    dense = torch.float32 if cfg.compute_dtype == "float32" else torch.bfloat16

    def lt(name):
        return load_tensor(gf, name, dev, dense)

    if cfg.arch == "llama":
        params = _load_llama(cfg, lt)
    else:
        params = _load_family(gf, cfg, lt, dev, dense)
    if fuse:
        from .fuse import fuse_projections

        params = fuse_projections(cfg, params)
    return params


def _load_llama(cfg: ModelConfig, lt) -> TransformerParams:
    blocks = []
    for i in range(cfg.n_layer):
        p = f"layers.{i}."
        blocks.append(Block(
            attn_norm_w=lt(p + "attention_norm.weight"),
            wq=lt(p + "attention.wq.weight"),
            wk=lt(p + "attention.wk.weight"),
            wv=lt(p + "attention.wv.weight"),
            wo=lt(p + "attention.wo.weight"),
            ffn_norm_w=lt(p + "ffn_norm.weight"),
            w_gate=lt(p + "feed_forward.w1.weight"),
            w_down=lt(p + "feed_forward.w2.weight"),
            w_up=lt(p + "feed_forward.w3.weight"),
        ))
    return TransformerParams(
        tok_embeddings=lt("tok_embeddings.weight"), blocks=tuple(blocks),
        out_norm_w=lt("norm.weight"), out_norm_b=None,
        output=lt("output.weight"))


def _load_family(gf: GGJTFile, cfg: ModelConfig, lt, dev, dense) -> TransformerParams:
    """gptneox (its own tensor names) and falcon / bonsai (HF-falcon names)."""
    groups = _qkv_groups(cfg)
    if cfg.arch == "gptneox":
        pre, qkv, attn_out = ("gpt_neox.layers.", ".attention.query_key_value",
                              ".attention.dense")
        emb, fnorm, out = ("gpt_neox.embed_in.weight", "gpt_neox.final_layer_norm",
                           "embed_out.weight")
    else:
        pre, qkv, attn_out = ("transformer.h.", ".self_attention.query_key_value",
                              ".self_attention.dense")
        emb, fnorm, out = ("transformer.word_embeddings.weight", "transformer.ln_f",
                           "lm_head.weight")
    bias = cfg.qkv_bias  # gptneox: every projection has one

    def opt(name):
        return lt(name) if bias else None

    blocks = []
    for i in range(cfg.n_layer):
        p = f"{pre}{i}"
        wq, wk, wv = _load_rows(gf, p + qkv + ".weight", groups, dev, dense)
        bq = bk = bv = None
        if bias:
            bq, bk, bv = _split_1d(gf, p + qkv + ".bias", groups, dev)
        blk = Block(
            attn_norm_w=lt(p + ".input_layernorm.weight"),
            attn_norm_b=lt(p + ".input_layernorm.bias"),
            wq=wq, wk=wk, wv=wv, bq=bq, bk=bk, bv=bv,
            wo=lt(p + attn_out + ".weight"), bo=opt(p + attn_out + ".bias"),
            w_up=lt(p + ".mlp.dense_h_to_4h.weight"),
            b_up=opt(p + ".mlp.dense_h_to_4h.bias"),
            w_down=lt(p + ".mlp.dense_4h_to_h.weight"),
            b_down=opt(p + ".mlp.dense_4h_to_h.bias"))
        if not cfg.ffn_norm_shared:
            blk.ffn_norm_w = lt(p + ".post_attention_layernorm.weight")
            blk.ffn_norm_b = lt(p + ".post_attention_layernorm.bias")
        elif not cfg.parallel_residual and p + ".post_attn_layernorm.weight" in gf.tensors:
            # falcon / bonsai in serial mode: an optional post-attention norm
            blk.ffn_norm_w = lt(p + ".post_attn_layernorm.weight")
            blk.ffn_norm_b = lt(p + ".post_attn_layernorm.bias")
        blocks.append(blk)
    return TransformerParams(
        tok_embeddings=lt(emb), blocks=tuple(blocks),
        out_norm_w=lt(fnorm + ".weight"), out_norm_b=lt(fnorm + ".bias"),
        output=lt(out))
