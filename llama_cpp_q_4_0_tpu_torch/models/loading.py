"""GGJT file -> device parameters for LLaMA models.

q4_0 weights take the direct repack of ``quant/q4_0.py``; every other
quantized type (q4_1, q5_0, q5_1, q8_0, q2_K..q6_K) goes through the planar
repack and ``QTensor.from_planar``, as in the JAX package's loader.  llama's
wq/wk stay in their on-disk permuted layout because rope(neox=False)
implements the matching adjacent-pair rotation."""

from __future__ import annotations

import torch

from .. import resolve_device
from ..formats.ggjt import GGJTFile
from ..ops.qtensor import QTensor
from ..quant.pack import PLANAR_TYPES, pack_planar
from ..quant.q4_0 import PACK_ZERO, pack_q4_0
from ..quant.types import GGMLType
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
    if t.qtype == GGMLType.Q4_0 and len(t.shape) == 2:
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


def config_from_ggjt(gf: GGJTFile, n_ctx: int = 2048, **kw) -> ModelConfig:
    if gf.arch != "llama":
        raise NotImplementedError(f"{gf.arch} models are not ported yet")
    hp = gf.hparams
    return ModelConfig.llama(
        n_vocab=hp["n_vocab"], n_embd=hp["n_embd"], n_mult=hp["n_mult"],
        n_head=hp["n_head"], n_layer=hp["n_layer"], n_rot=hp["n_rot"],
        n_ctx=n_ctx, **kw)


def load_transformer(gf: GGJTFile, cfg: ModelConfig, *, device=None,
                     fuse: bool = True) -> TransformerParams:
    """Load a llama GGJT file onto ``device`` (default cuda; raises without
    CUDA unless device="cpu")."""
    if cfg.arch != "llama":
        raise NotImplementedError(f"{cfg.arch} models are not ported yet")
    dev = resolve_device(device)
    dense = torch.float32 if cfg.compute_dtype == "float32" else torch.bfloat16

    def lt(name):
        return load_tensor(gf, name, dev, dense)

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
    params = TransformerParams(
        tok_embeddings=lt("tok_embeddings.weight"), blocks=tuple(blocks),
        out_norm_w=lt("norm.weight"), out_norm_b=None,
        output=lt("output.weight"))
    if fuse:
        from .fuse import fuse_projections

        params = fuse_projections(cfg, params)
    return params
