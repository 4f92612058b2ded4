"""Inference context: params + KV cache + eval (the llama_context).

Holds the model params, preallocated KV buffers and n_past.  Prompt lengths
are padded up to the next bucket of ``PREFILL_BUCKETS``, and attention reads
only the first ``kv_window`` cache slots, with ``kv_window`` the bucket of
``n_past + t`` — the same shapes the JAX package compiles for.

As the JAX ``Context`` (without a mesh), it keeps two views of the params
that share their levels and scale planes: ``QMM_F16_SCALES=1`` first stores
the planes of the exact formats as float16 (``maybe_cast_scales_f16``), which
both views take; ``QMM_ZERO_FOLD=1`` then folds each symmetric pack zero into
a bias plane (``maybe_fold_zero_points``) in ``params``, the view of calls of
at most 32 tokens (decode-shaped), while ``_params_prefill`` keeps the
unfolded tensors for larger buckets.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..models import transformer
from ..models.config import ModelConfig
from ..models.transformer import TransformerParams, init_cache
from ..ops.flash_prefill import flash_prefill
from ..ops.layers import use_flash_prefill
from ..ops.qtensor import maybe_cast_scales_f16, maybe_fold_zero_points

PREFILL_BUCKETS = (1, 8, 32, 64, 128, 256, 512, 1024, 2048)


def _bucket(n: int) -> int:
    for b in PREFILL_BUCKETS:
        if n <= b:
            return b
    return ((n + 2047) // 2048) * 2048


@dataclass
class Timings:
    """llama_print_timings counters."""

    t_load_ms: float = 0.0
    t_sample_ms: float = 0.0
    n_sample: int = 0
    t_prompt_ms: float = 0.0
    n_prompt: int = 0
    t_eval_ms: float = 0.0
    n_eval: int = 0

    def report(self) -> str:
        lines = [f"load time = {self.t_load_ms:10.2f} ms"]
        if self.n_sample:
            lines.append(
                f"sample time = {self.t_sample_ms:10.2f} ms / {self.n_sample} runs "
                f"({self.t_sample_ms / max(1, self.n_sample):8.2f} ms per token)")
        if self.n_prompt:
            lines.append(
                f"prompt eval time = {self.t_prompt_ms:10.2f} ms / {self.n_prompt} "
                f"tokens ({self.t_prompt_ms / max(1, self.n_prompt):8.2f} ms per token)")
        if self.n_eval:
            lines.append(
                f"eval time = {self.t_eval_ms:10.2f} ms / {self.n_eval} runs "
                f"({self.t_eval_ms / max(1, self.n_eval):8.2f} ms per token)")
        return "\n".join(lines)


class Context:
    """One generation run over a loaded model: KV cache, n_past, timings."""

    def __init__(self, cfg: ModelConfig, params: TransformerParams, *,
                 batch: int = 1, n_ctx: int | None = None,
                 cache_dtype=torch.bfloat16, device=None):
        """device defaults to cuda and raises without CUDA unless "cpu" is
        asked for; params must already lie on it (models.loading)."""
        self.device = resolve_device(device)
        self.cfg = cfg
        # cast before the fold, so that both views share the cast planes and
        # the folded bias takes their dtype (JAX context.py)
        params = maybe_cast_scales_f16(params)
        self._params_prefill = params
        self.params = maybe_fold_zero_points(params)
        self.n_ctx = n_ctx or cfg.n_ctx
        self.batch = batch
        self.cache_k, self.cache_v = init_cache(cfg, batch, self.n_ctx,
                                                cache_dtype, self.device)
        self.n_past = 0
        self.timings = Timings()
        self._logits = None

    def reset(self):
        for c in (*self.cache_k, *self.cache_v):
            if isinstance(c, torch.Tensor):
                c.zero_()
            else:
                c.data.zero_()
                c.scale.zero_()
        self.n_past = 0

    def eval(self, tokens, *, logits_all: bool = False) -> np.ndarray:
        """Evaluate tokens (list or [B, T] array) after the current n_past.
        Returns host f32 logits: [B, T, V] if logits_all else [B, 1, V]."""
        tokens = np.atleast_2d(np.asarray(tokens, dtype=np.int64))
        b, t = tokens.shape
        if b != self.batch:
            raise ValueError(f"batch {b} != context batch {self.batch}")
        if self.n_past + t > self.n_ctx:
            raise ValueError("context overflow")
        bt = _bucket(t)
        padded = np.zeros((b, bt), dtype=np.int64)
        padded[:, :t] = tokens
        t0 = time.perf_counter()
        attn_fn = None
        if (self.n_past == 0 and t > 1
                and use_flash_prefill(bt, self.cfg.head_dim, self.device)):
            attn_fn = flash_prefill
        slice_last = not logits_all and bt != t
        # decode-shaped calls take the folded view, larger buckets the raw one
        params = self.params if bt <= 32 else self._params_prefill
        logits = transformer.forward(
            self.cfg, params,
            torch.from_numpy(padded).to(self.device), self.n_past,
            self.cache_k, self.cache_v,
            last_only=not (logits_all or bt != t),
            kv_window=min(_bucket(self.n_past + t), self.n_ctx),
            last_index=t - 1 if slice_last else None,
            attention_fn=attn_fn)
        if logits.shape[1] > 1:
            logits = logits[:, :t]
        logits = logits.float().cpu().numpy()
        dt = (time.perf_counter() - t0) * 1e3
        if t > 1:
            self.timings.t_prompt_ms += dt
            self.timings.n_prompt += t
        else:
            self.timings.t_eval_ms += dt
            self.timings.n_eval += 1
        self.n_past += t
        self._logits = logits
        return logits

    @property
    def logits(self) -> np.ndarray:
        return self._logits
