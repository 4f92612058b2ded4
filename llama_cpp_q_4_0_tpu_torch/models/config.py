"""Model configuration of the decoder-only families: the hparams of the
reference's llama, gptneox, falcon and bonsai (RWKV is not ported)."""

from __future__ import annotations

from dataclasses import dataclass


def llama_n_ff(n_embd: int, n_mult: int) -> int:
    """FFN width rule of llama.cpp (n_ff derived from n_mult)."""
    return ((2 * (4 * n_embd) // 3 + n_mult - 1) // n_mult) * n_mult


@dataclass(frozen=True)
class ModelConfig:
    arch: str  # llama | gptneox | falcon | bonsai
    n_vocab: int
    n_embd: int
    n_layer: int
    n_head: int = 1
    n_kv_head: int | None = None  # falcon and bonsai MQA: 1
    n_rot: int = 0  # rotary dims per head (gptneox: rotary_pct * head_dim)
    n_ff: int = 0
    n_ctx: int = 2048
    rope_neox: bool = False  # half-split pairs (mode 2) vs adjacent pairs
    rope_base: float = 10000.0
    parallel_residual: bool = True  # gptneox/falcon/bonsai
    ffn_norm_shared: bool = False  # falcon/bonsai: the MLP reuses the input norm
    norm: str = "rmsnorm"  # rmsnorm | layernorm | rmsnorm_bias
    norm_eps: float = 1e-6
    act: str = "silu"  # silu | gelu | bonsai_hybrid
    ffn_gated: bool = True  # llama SwiGLU (w1/w2/w3) vs a plain 2-matmul MLP
    qkv_fused: bool = False  # gptneox/falcon/bonsai store one c_attn tensor
    qkv_bias: bool = False  # gptneox: biases everywhere
    rope_full_cache: bool = False  # neox family: the reference ropes the whole cache
    # matmul arithmetic: bfloat16 | float32 | ref_int8 (the reference's
    # q8-activation integer dots, ops/qmatmul.py q_matmul_ref_int8)
    compute_dtype: str = "bfloat16"
    # ggml's fp16 lookup tables byte for byte: the activations
    # (GGML_GELU_FP16 / GGML_SILU_FP16), the softmax's exp table and the
    # double-accumulated rms_norm.  Parity gates only.
    act_f16_table: bool = False

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
            n_ctx=n_ctx, rope_neox=False, parallel_residual=False,
            norm="rmsnorm", norm_eps=1e-6, act="silu", ffn_gated=True, **kw,
        )

    @staticmethod
    def gptneox(n_vocab, n_embd, n_head, n_layer, n_rot, use_parallel_residual=1,
                n_ctx=2048, **kw) -> "ModelConfig":
        return ModelConfig(
            arch="gptneox", n_vocab=n_vocab, n_embd=n_embd, n_layer=n_layer,
            n_head=n_head, n_rot=n_rot, n_ff=4 * n_embd, n_ctx=n_ctx,
            rope_neox=True, parallel_residual=bool(use_parallel_residual),
            norm="layernorm", norm_eps=1e-5, act="gelu", ffn_gated=False,
            qkv_fused=True, qkv_bias=True, rope_full_cache=True, **kw,
        )

    @staticmethod
    def falcon(n_vocab, n_embd, n_head, n_layer, parallel_attn=1, n_ctx=2048,
               **kw) -> "ModelConfig":
        return ModelConfig(
            arch="falcon", n_vocab=n_vocab, n_embd=n_embd, n_layer=n_layer,
            n_head=n_head, n_kv_head=1, n_rot=n_embd // n_head, n_ff=4 * n_embd,
            n_ctx=n_ctx, rope_neox=True, parallel_residual=bool(parallel_attn),
            norm="layernorm", norm_eps=1e-5, act="gelu", ffn_gated=False,
            qkv_fused=True, qkv_bias=False, rope_full_cache=True,
            ffn_norm_shared=True, **kw,
        )

    @staticmethod
    def bonsai(n_vocab, n_embd, n_head, n_layer, parallel_attn=1, n_ctx=2048,
               **kw) -> "ModelConfig":
        return ModelConfig(
            arch="bonsai", n_vocab=n_vocab, n_embd=n_embd, n_layer=n_layer,
            n_head=n_head, n_kv_head=1, n_rot=n_embd // n_head, n_ff=4 * n_embd,
            n_ctx=n_ctx, rope_neox=True, parallel_residual=bool(parallel_attn),
            norm="rmsnorm_bias", norm_eps=1e-6, act="bonsai_hybrid",
            ffn_gated=False, qkv_fused=True, qkv_bias=False,
            rope_full_cache=True, ffn_norm_shared=True, **kw,
        )
