"""Random model init for training from scratch.

Mirrors init_model / randomize_model of the reference trainer
(train-text-from-scratch.cpp:246-393) and emits the same dense
TransformerParams the inference runtime takes, so a trained model generates
text through the standard Context with no glue.  The draws come from a
``torch.Generator`` on the device the params are made on: the JAX package's
``jax.random`` stream is not reproduced (as for sampling), the fields set
and left None are its init's."""

from __future__ import annotations

import torch

from ..models.config import ModelConfig
from ..models.transformer import Block, TransformerParams


def init_transformer(cfg: ModelConfig, generator: torch.Generator, *, scale: float = 0.02,
                     dtype=torch.float32) -> TransformerParams:
    """Gaussian init (randomize_model, train-text-from-scratch.cpp:329-393)
    on the generator's device: weights N(0, scale) drawn in f32 and cast to
    dtype, norms of one, zero biases where the family has them."""
    dev = generator.device
    e, v, f = cfg.n_embd, cfg.n_vocab, cfg.n_ff
    kv_dim = cfg.kv_heads * cfg.head_dim

    def nrm(*shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=dev)
        return (w * scale).to(dtype)

    def ones(n):
        return torch.ones(n, dtype=torch.float32, device=dev)

    def zeros(n, on=True):
        return torch.zeros(n, dtype=torch.float32, device=dev) if on else None

    has_ln_bias = cfg.norm in ("layernorm", "rmsnorm_bias")
    bias = cfg.qkv_bias
    blocks = []
    for _ in range(cfg.n_layer):
        blk = Block(
            attn_norm_w=ones(e), attn_norm_b=zeros(e, has_ln_bias),
            wq=nrm(e, e), wk=nrm(kv_dim, e), wv=nrm(kv_dim, e), wo=nrm(e, e),
            bq=zeros(e, bias), bk=zeros(kv_dim, bias), bv=zeros(kv_dim, bias),
            bo=zeros(e, bias), w_up=nrm(f, e), w_down=nrm(e, f),
            b_up=zeros(f, bias), b_down=zeros(e, bias))
        if cfg.ffn_gated:
            blk.w_gate = nrm(f, e)
        if not cfg.ffn_norm_shared:
            blk.ffn_norm_w = ones(e)
            blk.ffn_norm_b = zeros(e, has_ln_bias)
        blocks.append(blk)
    return TransformerParams(tok_embeddings=nrm(v, e), blocks=tuple(blocks), out_norm_w=ones(e),
                             out_norm_b=zeros(e, has_ln_bias), output=nrm(v, e))
