"""Shared CLI plumbing: model flags and model bring-up (llama_init_from_gpt_params)."""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass

import torch

from ..formats.ggjt import detect_arch, read_ggjt
from ..models.config import ModelConfig
from ..models.loading import config_from_ggjt, load_transformer
from ..quant.types import LlamaFType
from ..runtime.context import Context
from ..runtime.tokenizer import Tokenizer, Vocab

CACHE_TYPES = {"bf16": torch.bfloat16, "f32": torch.float32,
               "f16": torch.float16, "q8": torch.int8}


def ftype_name(ftype: int) -> str:
    """llama_ftype as its enum name (MOSTLY_Q4_K_M), or the bare number."""
    try:
        return LlamaFType(ftype).name
    except ValueError:
        return str(ftype)


def add_model_args(p: argparse.ArgumentParser):
    p.add_argument("-m", "--model", required=True, help="model path (ggjt v3)")
    p.add_argument("-c", "--ctx-size", "--n-ctx", type=int, default=512,
                   dest="n_ctx")
    p.add_argument("--cache-type", default="bf16", choices=tuple(CACHE_TYPES),
                   help="KV cache dtype; q8 is scaled int8 (amax/127 per "
                        "token-head vector)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no silent CPU fallback")


@dataclass
class LoadedModel:
    cfg: ModelConfig
    ctx: Context
    tokenizer: Tokenizer
    t_load_ms: float


def load_model(args) -> LoadedModel:
    """File -> params -> context on the requested device (llama only)."""
    t0 = time.perf_counter()
    arch = detect_arch(args.model)
    if arch != "llama":
        raise NotImplementedError(f"{arch} models are not ported yet")
    gf = read_ggjt(args.model, arch)
    cfg = config_from_ggjt(gf, n_ctx=args.n_ctx)
    tokenizer = Tokenizer(Vocab.from_ggjt(gf))
    params = load_transformer(gf, cfg, device=args.device)
    ctx = Context(cfg, params, n_ctx=args.n_ctx,
                  cache_dtype=CACHE_TYPES[args.cache_type], device=args.device)
    t_load = (time.perf_counter() - t0) * 1e3
    ctx.timings.t_load_ms = t_load
    print(f"{arch}: loaded {args.model} | ftype={ftype_name(gf.ftype)} "
          f"n_vocab={cfg.n_vocab} "
          f"n_embd={cfg.n_embd} n_layer={cfg.n_layer} n_ctx={args.n_ctx} "
          f"device={ctx.device}", file=sys.stderr)
    return LoadedModel(cfg, ctx, tokenizer, t_load)
