"""Small random-weight GGJT model files for tests and smoke runs.

Structurally valid files of the llama, gptneox, falcon and bonsai families,
written with this package's ``GGJTWriter`` and quantizers
(``quant/registry.quantize``): for the same arguments and seed, byte for byte
the files of the JAX package's ``formats/fixtures.py``.  Every 2-D weight is
quantized to ``qtype`` (or written as f16 / f32), every 1-D tensor as f32.
"""

from __future__ import annotations

import numpy as np

from ..models.config import ModelConfig
from ..quant.registry import quantize
from ..quant.types import GGMLType, LlamaFType
from .ggjt import GGJTWriter


def _fake_vocab(n_vocab: int) -> list[tuple[bytes, float]]:
    vocab = [(b"<unk>", 0.0), (b"<s>", 0.0), (b"</s>", 0.0)]
    for i in range(3, 259):
        vocab.append((bytes([i - 3]) if 32 <= i - 3 < 127 else f"<0x{i-3:02X}>".encode(), 0.0))
    while len(vocab) < n_vocab:
        vocab.append((f" tok{len(vocab)}".encode(), -float(len(vocab))))
    return vocab[:n_vocab]


def _emit(w: GGJTWriter, name: str, arr: np.ndarray, qtype: GGMLType):
    """Write a float32 tensor, 2-D weights in qtype."""
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    ne = tuple(reversed(arr.shape))  # ggml order: ne[0] is the fastest dim
    if arr.ndim == 2 and qtype == GGMLType.F16:
        w.write_tensor(name, GGMLType.F16, ne, arr.astype(np.float16))
    elif arr.ndim == 2 and qtype != GGMLType.F32:
        w.write_tensor(name, qtype, ne, quantize(arr, qtype))
    else:
        w.write_tensor(name, GGMLType.F32, ne, arr)


def _normal(rng):
    def r(*shape, scale=0.05):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return r


def make_llama_ggjt(path: str, *, n_vocab: int = 512, n_embd: int = 64,
                    n_mult: int = 32, n_head: int = 4, n_layer: int = 2,
                    qtype: GGMLType = GGMLType.Q4_0, ftype: int | None = None,
                    seed: int = 0, vocab: list | None = None) -> ModelConfig:
    if ftype is None:
        ftype = {GGMLType.F32: 0, GGMLType.F16: 1}.get(qtype, int(LlamaFType.MOSTLY_Q4_0))
    r = _normal(np.random.default_rng(seed))
    cfg = ModelConfig.llama(n_vocab=n_vocab, n_embd=n_embd, n_mult=n_mult,
                            n_head=n_head, n_layer=n_layer, n_rot=n_embd // n_head)
    hp = {"n_vocab": n_vocab, "n_embd": n_embd, "n_mult": n_mult,
          "n_head": n_head, "n_layer": n_layer, "n_rot": n_embd // n_head}
    with GGJTWriter(path, "llama", hp, ftype, vocab or _fake_vocab(n_vocab)) as w:
        _emit(w, "tok_embeddings.weight", r(n_vocab, n_embd, scale=0.1), qtype)
        _emit(w, "norm.weight", np.ones(n_embd), qtype)
        _emit(w, "output.weight", r(n_vocab, n_embd, scale=0.1), qtype)
        for i in range(n_layer):
            p = f"layers.{i}."
            _emit(w, p + "attention_norm.weight", np.ones(n_embd), qtype)
            for nm in ("wq", "wk", "wv", "wo"):
                _emit(w, p + f"attention.{nm}.weight", r(n_embd, n_embd), qtype)
            _emit(w, p + "ffn_norm.weight", np.ones(n_embd), qtype)
            _emit(w, p + "feed_forward.w1.weight", r(cfg.n_ff, n_embd), qtype)
            _emit(w, p + "feed_forward.w2.weight", r(n_embd, cfg.n_ff), qtype)
            _emit(w, p + "feed_forward.w3.weight", r(cfg.n_ff, n_embd), qtype)
    return cfg


def make_gptneox_ggjt(path: str, *, n_vocab: int = 512, n_embd: int = 64,
                      n_head: int = 4, n_layer: int = 2, n_rot: int | None = None,
                      use_parallel_residual: int = 1, qtype: GGMLType = GGMLType.Q4_0,
                      ftype: int = 2, seed: int = 0) -> ModelConfig:
    r = _normal(np.random.default_rng(seed))
    n_rot = n_rot if n_rot is not None else n_embd // n_head
    hp = {"n_vocab": n_vocab, "n_ctx": 2048, "n_embd": n_embd, "n_head": n_head,
          "n_layer": n_layer, "n_rot": n_rot,
          "use_parallel_residual": use_parallel_residual}
    cfg = ModelConfig.gptneox(n_vocab, n_embd, n_head, n_layer, n_rot,
                              use_parallel_residual)
    with GGJTWriter(path, "gptneox", hp, ftype, _fake_vocab(n_vocab)) as w:
        _emit(w, "gpt_neox.embed_in.weight", r(n_vocab, n_embd, scale=0.1), qtype)
        _emit(w, "gpt_neox.final_layer_norm.weight", np.ones(n_embd), qtype)
        _emit(w, "gpt_neox.final_layer_norm.bias", r(n_embd, scale=0.01), qtype)
        _emit(w, "embed_out.weight", r(n_vocab, n_embd, scale=0.1), qtype)
        for i in range(n_layer):
            p = f"gpt_neox.layers.{i}"
            _emit(w, p + ".input_layernorm.weight", np.ones(n_embd), qtype)
            _emit(w, p + ".input_layernorm.bias", r(n_embd, scale=0.01), qtype)
            _emit(w, p + ".attention.query_key_value.weight", r(3 * n_embd, n_embd), qtype)
            _emit(w, p + ".attention.query_key_value.bias", r(3 * n_embd, scale=0.01), qtype)
            _emit(w, p + ".attention.dense.weight", r(n_embd, n_embd), qtype)
            _emit(w, p + ".attention.dense.bias", r(n_embd, scale=0.01), qtype)
            _emit(w, p + ".post_attention_layernorm.weight", np.ones(n_embd), qtype)
            _emit(w, p + ".post_attention_layernorm.bias", r(n_embd, scale=0.01), qtype)
            _emit(w, p + ".mlp.dense_h_to_4h.weight", r(4 * n_embd, n_embd), qtype)
            _emit(w, p + ".mlp.dense_h_to_4h.bias", r(4 * n_embd, scale=0.01), qtype)
            _emit(w, p + ".mlp.dense_4h_to_h.weight", r(n_embd, 4 * n_embd), qtype)
            _emit(w, p + ".mlp.dense_4h_to_h.bias", r(n_embd, scale=0.01), qtype)
    return cfg


def make_falcon_like_ggjt(path: str, arch: str = "falcon", *, n_vocab: int = 512,
                          n_embd: int = 64, n_head: int = 4, n_layer: int = 2,
                          parallel_attn: int = 1, qtype: GGMLType = GGMLType.Q4_0,
                          ftype: int = 2, seed: int = 0,
                          post_attn_norm: bool = False) -> ModelConfig:
    """falcon or bonsai (the same tensor names; the header's arch picks the
    norm and activation).  post_attn_norm also writes the optional
    ``post_attn_layernorm`` of each layer, which a serial-residual file
    (parallel_attn 0) needs; the JAX package's generator has no such option,
    so only a file without it matches its bytes."""
    r = _normal(np.random.default_rng(seed))
    head_dim = n_embd // n_head
    hp = {"n_vocab": n_vocab, "n_embd": n_embd, "n_head": n_head,
          "n_layer": n_layer, "parallel_attn": parallel_attn}
    make = ModelConfig.falcon if arch == "falcon" else ModelConfig.bonsai
    cfg = make(n_vocab, n_embd, n_head, n_layer, parallel_attn)
    with GGJTWriter(path, arch, hp, ftype, _fake_vocab(n_vocab)) as w:
        _emit(w, "transformer.word_embeddings.weight", r(n_vocab, n_embd, scale=0.1), qtype)
        _emit(w, "transformer.ln_f.weight", np.ones(n_embd), qtype)
        _emit(w, "transformer.ln_f.bias", r(n_embd, scale=0.01), qtype)
        _emit(w, "lm_head.weight", r(n_vocab, n_embd, scale=0.1), qtype)
        for i in range(n_layer):
            p = f"transformer.h.{i}"
            _emit(w, p + ".input_layernorm.weight", np.ones(n_embd), qtype)
            _emit(w, p + ".input_layernorm.bias", r(n_embd, scale=0.01), qtype)
            _emit(w, p + ".self_attention.query_key_value.weight",
                  r(n_embd + 2 * head_dim, n_embd), qtype)
            _emit(w, p + ".self_attention.dense.weight", r(n_embd, n_embd), qtype)
            if post_attn_norm:
                _emit(w, p + ".post_attn_layernorm.weight", np.ones(n_embd), qtype)
                _emit(w, p + ".post_attn_layernorm.bias", r(n_embd, scale=0.01), qtype)
            _emit(w, p + ".mlp.dense_h_to_4h.weight", r(4 * n_embd, n_embd), qtype)
            _emit(w, p + ".mlp.dense_4h_to_h.weight", r(n_embd, 4 * n_embd), qtype)
    return cfg
