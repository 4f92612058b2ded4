"""Model configuration (the reference's llama hparams, llama.cpp)."""

from __future__ import annotations

from dataclasses import dataclass


def llama_n_ff(n_embd: int, n_mult: int) -> int:
    """FFN width rule of llama.cpp (n_ff derived from n_mult)."""
    return ((2 * (4 * n_embd) // 3 + n_mult - 1) // n_mult) * n_mult


@dataclass(frozen=True)
class ModelConfig:
    arch: str  # llama (the only family the port runs so far)
    n_vocab: int
    n_embd: int
    n_layer: int
    n_head: int = 1
    n_kv_head: int | None = None
    n_rot: int = 0
    n_ff: int = 0
    n_ctx: int = 2048
    rope_neox: bool = False  # half-split pairs (mode 2) vs adjacent pairs
    rope_base: float = 10000.0
    norm_eps: float = 1e-6
    # matmul arithmetic: bfloat16 | float32 | ref_int8 (the reference's
    # q8-activation integer dots, ops/qmatmul.py q_matmul_ref_int8)
    compute_dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def kv_heads(self) -> int:
        return self.n_kv_head if self.n_kv_head is not None else self.n_head

    @staticmethod
    def llama(n_vocab=32000, n_embd=4096, n_mult=256, n_head=32, n_layer=32,
              n_rot=128, n_ctx=2048, **kw) -> "ModelConfig":
        return ModelConfig(
            arch="llama", n_vocab=n_vocab, n_embd=n_embd, n_layer=n_layer,
            n_head=n_head, n_rot=n_rot, n_ff=llama_n_ff(n_embd, n_mult),
            n_ctx=n_ctx, rope_neox=False, norm_eps=1e-6, **kw,
        )
