"""wikitext-2 perplexity: the quality gate (examples/perplexity).

The JAX package's ``runtime/perplexity.py``: tokenize the whole text (BOS
swapped into the first slot of each chunk), evaluate n_ctx-token chunks in
n_batch pieces with logits_all, and accumulate the NLL over the second half
of each window (from lo = min(512, n_ctx // 2)); ppl = exp(sum nll / count).

``perplexity`` is the host loop: a ``Context.eval`` a piece, the logsumexp in
f64 on the host.  ``perplexity_ondevice`` is the port of the jitted
``_chunk_nll``: the forward over the chunk, the f32 logsumexp and the target
gather run on the device, as one CUDA graph per (n_ctx, lo, cache dtype,
routing switches) captured into the Context's graph pool, and one scalar
crosses to the host a chunk."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models import transformer
from ..ops.kvcache import QuantKV
from .context import LAUNCH_COUNTERS, Context, _Graph, add_launches, step_key
from .tokenizer import TOKEN_BOS, Tokenizer


@dataclass
class PerplexityResult:
    ppl: float
    nll: float
    count: int
    chunk_ppls: list


def perplexity(
    ctx: Context,
    tokens: list[int] | np.ndarray,
    *,
    n_ctx: int = 512,
    n_batch: int = 512,
    progress=None,
) -> PerplexityResult:
    tokens = np.asarray(tokens, dtype=np.int32)
    n_chunk = len(tokens) // n_ctx
    nll = 0.0
    count = 0
    chunk_ppls = []
    for i in range(n_chunk):
        start = i * n_ctx
        chunk = tokens[start : start + n_ctx].copy()
        chunk[0] = TOKEN_BOS  # BOS for the first batch of each chunk
        ctx.reset()
        logits = []
        for j in range(0, n_ctx, n_batch):
            piece = chunk[j : j + n_batch]
            logits.append(
                ctx.eval(piece[None, :], logits_all=True)[0].astype(np.float64)
            )
        logits = np.concatenate(logits, axis=0)  # [n_ctx, V]
        lo = min(512, n_ctx // 2)
        sel = logits[lo : n_ctx - 1]
        m = sel.max(axis=-1, keepdims=True)
        lse = m[:, 0] + np.log(np.exp(sel - m).sum(axis=-1))
        targets = tokens[start + lo + 1 : start + n_ctx]
        tok_logit = sel[np.arange(sel.shape[0]), targets]
        nll += float((lse - tok_logit).sum())
        count += sel.shape[0]
        chunk_ppls.append(float(np.exp(nll / count)))
        if progress:
            progress(f"[{i + 1}]{chunk_ppls[-1]:.4f},")
    return PerplexityResult(float(np.exp(nll / max(1, count))), nll, count, chunk_ppls)


def chunk_nll(cfg, params, chunk: torch.Tensor, cache_k, cache_v, lo: int,
              n_ctx: int) -> torch.Tensor:
    """The JAX ``_chunk_nll``: the forward of chunk [1, n_ctx] at n_past 0
    over a window of n_ctx, every row's logits, and the sum over rows lo ..
    n_ctx - 2 of logsumexp(logits) - logits[target] in f32 (0-d)."""
    logits = transformer.forward(cfg, params, chunk, 0, cache_k, cache_v,
                                 last_only=False, kv_window=n_ctx)
    sel = logits[0, lo : n_ctx - 1].float()
    tgt = chunk[0, lo + 1 : n_ctx]
    lse = torch.logsumexp(sel, dim=-1)
    tok_logit = sel.gather(1, tgt[:, None])[:, 0]
    return (lse - tok_logit).sum()


class _NllStep(_Graph):
    """One key of the on-device loop: the static chunk, the loop's own
    caches (captured by address) and on the card the graph."""

    def __init__(self, cfg, n_ctx: int, cache_dtype, device: torch.device):
        super().__init__()
        self.chunk = torch.zeros((1, n_ctx), dtype=torch.int64, device=device)
        self.staging = (torch.empty((1, n_ctx), dtype=torch.int64, pin_memory=True)
                        if device.type == "cuda" else None)
        self.cache_k, self.cache_v = transformer.init_cache(cfg, 1, n_ctx, cache_dtype,
                                                            device)

    def load(self, chunk: np.ndarray):
        host = torch.from_numpy(chunk.astype(np.int64))[None]
        if self.staging is None:
            self.chunk.copy_(host)
        else:
            self.staging.copy_(host)
            self.chunk.copy_(self.staging, non_blocking=True)


def _chunk_sum(ctx: Context, chunk: np.ndarray, lo: int, n_ctx: int) -> float:
    """chunk_nll of one chunk on ctx.params (the view JAX's loop takes):
    eager on the CPU; on the card the key's graph, captured on its first
    call."""
    cdt = (torch.int8 if isinstance(ctx.cache_k[0], QuantKV)
           else ctx.cache_k[0].dtype)
    key = step_key("nll", n_ctx, n_ctx, False, False, None, "decode") + (lo, str(cdt))
    st = ctx._steps.get(key)
    if st is None:
        st = ctx._steps[key] = _NllStep(ctx.cfg, n_ctx, cdt, ctx.device)
    st.load(chunk)

    def step():
        return chunk_nll(ctx.cfg, ctx.params, st.chunk, st.cache_k, st.cache_v,
                         lo, n_ctx)

    if ctx.device.type != "cuda":  # the caller asked for the CPU
        return float(step())
    if st.graph is None:
        out = step()  # eager: the warm-up, and this chunk's sum
        ctx._capture(st, step)
        return float(out)
    st.graph.replay()
    st.replays += 1
    add_launches(LAUNCH_COUNTERS, st.launches)
    return float(st.out)


def perplexity_ondevice(
    ctx: Context,
    tokens: list[int] | np.ndarray,
    *,
    n_ctx: int = 512,
    n_batch: int = 512,
    progress=None,
) -> PerplexityResult:
    """Same windowing as perplexity(), but the NLL reduces on the device:
    per chunk one scalar crosses to the host instead of [n_ctx, V] logits
    (65 MB a chunk at 7B).  An f32 logsumexp instead of the host loop's f64;
    the JAX package puts the difference at ~1e-5 in ppl.  The loop runs on
    caches of its own, of the Context's cache dtype (q8 and f8 included), so
    that the quality of each cache type is measurable; n_batch is ignored,
    as in JAX (the whole chunk is one forward)."""
    tokens = np.asarray(tokens, dtype=np.int32)
    n_chunk = len(tokens) // n_ctx
    lo = min(512, n_ctx // 2)
    nll, count, chunk_ppls = 0.0, 0, []
    for i in range(n_chunk):
        chunk = tokens[i * n_ctx : (i + 1) * n_ctx].copy()
        chunk[0] = TOKEN_BOS
        nll += _chunk_sum(ctx, chunk, lo, n_ctx)
        count += n_ctx - 1 - lo
        chunk_ppls.append(float(np.exp(nll / count)))
        if progress:
            progress(f"[{i + 1}]{chunk_ppls[-1]:.4f},")
    return PerplexityResult(float(np.exp(nll / max(1, count))), nll, count,
                            chunk_ppls)


def perplexity_file(ctx: Context, tokenizer: Tokenizer, path: str,
                    on_device: bool = False, **kw):
    with open(path, "rb") as f:
        text = f.read()
    toks = tokenizer.tokenize(text, bos=True)
    if on_device:
        return perplexity_ondevice(ctx, toks, **kw)
    return perplexity(ctx, toks, **kw)
