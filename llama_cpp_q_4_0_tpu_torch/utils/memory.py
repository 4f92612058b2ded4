"""Memory requirement estimates: the MEM_REQ_* tables, computed.

The reference hard-codes per-model-size scratch, KV and eval budgets
(llama.cpp:81-130 MEM_REQ_SCRATCH0/1, MEM_REQ_KV_SELF, MEM_REQ_EVAL); here
the same numbers derive from the config, as in the JAX package, whose
figures (and so the ``mem estimate:`` line ``main`` prints at load) these
are.  They estimate the JAX package's device layout (levels packed when 4
bits or fewer, f32 group scales), not the port's planes on the card."""

from __future__ import annotations

from dataclasses import dataclass

from ..models.config import ModelConfig
from ..quant.types import TYPE_TRAITS, GGMLType, row_size_bytes


@dataclass
class MemEstimate:
    weights_bytes: int
    kv_bytes: int
    activation_bytes: int  # peak decode activations (approx)
    logits_bytes: int

    @property
    def total_bytes(self) -> int:
        return self.weights_bytes + self.kv_bytes + self.activation_bytes + self.logits_bytes

    def report(self) -> str:
        g = 1 << 30
        return (f"weights {self.weights_bytes / g:.2f} GiB | "
                f"kv {self.kv_bytes / g:.2f} GiB | "
                f"act {self.activation_bytes / g:.2f} GiB | "
                f"total {self.total_bytes / g:.2f} GiB")


def _param_counts(cfg: ModelConfig) -> tuple[int, int]:
    """(2-D weight elements, 1-D elements) of the transformer families."""
    e, f, v = cfg.n_embd, cfg.n_ff, cfg.n_vocab
    kv_dim = cfg.kv_heads * cfg.head_dim
    per_layer = e * e * 2 + e * kv_dim * 2  # wq wo + wk wv
    per_layer += e * f * (3 if cfg.ffn_gated else 2)
    w2d = cfg.n_layer * per_layer + 2 * v * e  # + embedding, lm head
    w1d = cfg.n_layer * 4 * e + 2 * e
    return w2d, w1d


def estimate(cfg: ModelConfig, qtype: GGMLType = GGMLType.Q4_0, *, n_ctx: int | None = None,
             batch: int = 1, cache_bytes_per_el: int = 2) -> MemEstimate:
    """Device-memory estimate for inference: sub-5-bit formats pack two
    levels a byte, scales are f32 per group."""
    n_ctx = n_ctx or cfg.n_ctx
    w2d, w1d = _param_counts(cfg)
    tr = TYPE_TRAITS[qtype]
    if qtype in (GGMLType.F32, GGMLType.F16):
        wbytes = w2d * (4 if qtype == GGMLType.F32 else 2)
    else:
        # levels (packed when 4 bits or fewer, read off the file row size)
        # plus f32 group scales
        file_bpe = row_size_bytes(qtype, tr.block_size) / tr.block_size
        packed = file_bpe < 0.75  # 4-bit-class formats
        gsize = 32 if tr.block_size == 32 else 16
        wbytes = int(w2d * ((0.5 if packed else 1.0) + 4.0 / gsize))
    wbytes += w1d * 4
    kv = 2 * cfg.n_layer * batch * n_ctx * cfg.kv_heads * cfg.head_dim * cache_bytes_per_el
    # decode activations: a handful of [B, T, max(E, F)] f32 buffers
    act = 8 * batch * max(cfg.n_embd, cfg.n_ff) * 4
    logits = batch * cfg.n_vocab * 4
    return MemEstimate(wbytes, kv, act, logits)
