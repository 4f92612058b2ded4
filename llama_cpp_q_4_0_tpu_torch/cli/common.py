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
from ..runtime.sampling import SamplingParams
from ..runtime.tokenizer import Tokenizer, Vocab

CACHE_TYPES = {"bf16": torch.bfloat16, "f32": torch.float32,
               "f16": torch.float16, "f8": torch.float8_e4m3fn, "q8": torch.int8}


def ftype_name(ftype: int) -> str:
    """llama_ftype as its enum name (MOSTLY_Q4_K_M), or the bare number."""
    try:
        return LlamaFType(ftype).name
    except ValueError:
        return str(ftype)


def add_model_args(p: argparse.ArgumentParser):
    p.add_argument("-m", "--model", required=True, help="model path (ggjt v3)")
    p.add_argument("--arch", default=None,
                   help="llama|gptneox|falcon|bonsai (default: detect; a bonsai file "
                        "reads as falcon unless named; rwkv is not ported)")
    p.add_argument("-c", "--ctx-size", "--n-ctx", type=int, default=512,
                   dest="n_ctx")
    p.add_argument("-b", "--batch-size", type=int, default=512, dest="n_batch")
    p.add_argument("--memory-f32", action="store_true",
                   help="f32 KV cache (default bf16; reference default f16)")
    p.add_argument("--cache-type", default=None, choices=tuple(CACHE_TYPES),
                   help="KV cache dtype (default bf16, f32 under --memory-f32); "
                        "f8 (e4m3) halves KV memory, q8 (scaled int8, amax/127 "
                        "per token-head vector) quarters it")
    p.add_argument("-t", "--threads", type=int, default=0,
                   help="accepted for reference-CLI compatibility (the device "
                        "manages its own parallelism)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no silent CPU fallback")


def add_sampling_args(p: argparse.ArgumentParser):
    p.add_argument("-n", "--n-predict", type=int, default=128)
    p.add_argument("-s", "--seed", type=int, default=-1)
    p.add_argument("--top-k", type=int, default=40)
    p.add_argument("--top-p", type=float, default=0.95)
    p.add_argument("--temp", type=float, default=0.8)
    p.add_argument("--repeat-penalty", type=float, default=1.1)
    p.add_argument("--repeat-last-n", type=int, default=64)
    p.add_argument("--frequency-penalty", type=float, default=0.0)
    p.add_argument("--presence-penalty", type=float, default=0.0)
    p.add_argument("--tfs", type=float, default=1.0)
    p.add_argument("--typical", type=float, default=1.0)
    p.add_argument("--mirostat", type=int, default=0, choices=(0, 1, 2))
    p.add_argument("--mirostat-lr", type=float, default=0.1)
    p.add_argument("--mirostat-ent", type=float, default=5.0)
    p.add_argument("-l", "--logit-bias", action="append", default=[],
                   metavar="TOKEN_ID(+/-)BIAS",
                   help="e.g. 2-inf to ban EOS (main --logit-bias)")
    p.add_argument("--ignore-eos", action="store_true")


def sampling_from_args(args) -> SamplingParams:
    """The sampling flags as SamplingParams, parsed as the JAX package
    parses them (``-l 2-inf`` bans token 2; ``--ignore-eos`` bans EOS)."""
    logit_bias = {}
    for item in args.logit_bias:
        sep = "+" if "+" in item[1:] else "-"
        idx = item.rfind(sep)
        tok, val = int(item[:idx]), item[idx:]
        logit_bias[tok] = float("-inf") if val in ("-inf", "-Infinity") else float(val)
    if args.ignore_eos:
        logit_bias[2] = float("-inf")  # llama EOS (common.cpp --ignore-eos)
    return SamplingParams(
        top_k=args.top_k, top_p=args.top_p, temp=args.temp,
        repeat_penalty=args.repeat_penalty, repeat_last_n=args.repeat_last_n,
        frequency_penalty=args.frequency_penalty,
        presence_penalty=args.presence_penalty,
        tfs_z=args.tfs, typical_p=args.typical,
        mirostat=args.mirostat, mirostat_eta=args.mirostat_lr,
        mirostat_tau=args.mirostat_ent, logit_bias=logit_bias,
    )


@dataclass
class LoadedModel:
    cfg: ModelConfig
    ctx: Context
    tokenizer: Tokenizer
    arch: str
    t_load_ms: float
    # the model file's header (GGSN sessions need the raw llama_hparams
    # fields and the ftype, formats/ggsn.py)
    hparams: dict | None = None
    ftype: int = 0


def cache_dtype(args):
    """The KV cache dtype the flags ask for: --cache-type, else f32 under
    --memory-f32, else bf16."""
    if getattr(args, "cache_type", None):
        return CACHE_TYPES[args.cache_type]
    return torch.float32 if getattr(args, "memory_f32", False) else torch.bfloat16


def load_model(args, *, logits_all: bool = False) -> LoadedModel:
    """File -> params -> context on the requested device: llama, gptneox,
    falcon or bonsai (RWKV is not ported).  logits_all is accepted as the
    JAX ``load_model`` accepts it: a Context returns every row on request."""
    t0 = time.perf_counter()
    arch = args.arch or detect_arch(args.model)
    if arch == "rwkv":
        raise NotImplementedError(f"{arch} models are not ported yet")
    gf = read_ggjt(args.model, arch)
    cfg = config_from_ggjt(gf, n_ctx=args.n_ctx)
    tokenizer = Tokenizer(Vocab.from_ggjt(gf))
    params = load_transformer(gf, cfg, device=args.device)
    ctx = Context(cfg, params, n_ctx=args.n_ctx, cache_dtype=cache_dtype(args),
                  device=args.device)
    t_load = (time.perf_counter() - t0) * 1e3
    ctx.timings.t_load_ms = t_load
    print(f"{arch}: loaded {args.model} | ftype={ftype_name(gf.ftype)} "
          f"n_vocab={cfg.n_vocab} "
          f"n_embd={cfg.n_embd} n_layer={cfg.n_layer} n_ctx={args.n_ctx} "
          f"device={ctx.device}", file=sys.stderr)
    return LoadedModel(cfg, ctx, tokenizer, arch, t_load, hparams=dict(gf.hparams),
                       ftype=gf.ftype)
