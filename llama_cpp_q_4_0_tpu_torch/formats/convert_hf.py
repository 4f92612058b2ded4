"""HuggingFace checkpoint -> ggjt converters for all five families.

Re-implements the reference's convert tooling against local checkpoint dirs
(nothing is downloaded), byte for byte the JAX package's
``formats/convert_hf.py``:

  llama    — convert.py: torch-pickle/safetensors lazy load, shard merge
             (convert.py:583-610), wq/wk head permute for the adjacent-pair
             RoPE layout (convert.py:271-275), SentencePiece vocab + scores
  gptneox  — scripts/gptneox/convert-gptneox-to-ggml.py: names passthrough,
             drop attention.masked_bias/rotary_emb/attention.bias buffers
  falcon   — scripts/falcon/convert-falcon-to-ggml.py
  bonsai   — scripts/bonsai/convert-bonsai-to-ggml.py
  rwkv     — scripts/rwkv/convert-rwkv-to-ggml.py: squeeze time_* tensors,
             time_decay -> -exp(time_decay), rescale att.output / ffn.value
             by 2^(block//rescale_every)

All outputs are written as ggjt (v3 for llama, v1 for the arch forks) so one
reader serves every file this package produces.  safetensors shards are read
through torch (``safe_open(framework="pt")``) and floats widened with
``.float()``: numpy has no bfloat16 of its own, so a bf16 checkpoint read
as numpy would need ``ml_dtypes``, which this package does not use.  The
vocabulary readers need ``sentencepiece`` or ``transformers``; without them,
pass ``vocab=`` explicitly.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from ..quant.types import GGMLType, LlamaFType
from .ggjt import GGJTWriter


# --------------------------------------------------------------- state dicts

def _numpy(t) -> np.ndarray:
    """A checkpoint tensor as numpy: floats (bf16 and f16 included) widened
    to f32 by torch, integers as they are."""
    return t.float().numpy() if t.is_floating_point() else t.numpy()


class LazyStateDict:
    """Per-tensor lazy weight access — the reference convert.py's LazyModel
    analogue (convert.py:420-610).  Peak memory stays at one tensor instead
    of the whole checkpoint (a 7B f16 model no longer needs 26 GB of RAM to
    convert):

      - safetensors shards: `safe_open(framework="pt")` handles, each
        tensor read from disk only when a converter asks for it
      - torch zipfile checkpoints: `torch.load(mmap=True)` keeps shard data
        page-mapped; legacy files fall back to resident shards (old
        behavior, still shard-merged)

    GPTQ tensor groups ({base}.qweight/qzeros/scales[/g_idx/zeros/bias])
    are hidden and surfaced as a synthesized {base}.weight, dequantized on
    access (same semantics as resolve_gptq/gptq_dense).  Float tensors come
    out float32, integers unchanged — identical to the old eager loader.
    """

    def __init__(self, model_dir: str):
        d = Path(model_dir)
        self._get: dict[str, object] = {}  # name -> zero-arg loader
        st_files = sorted(d.glob("*.safetensors"))
        pt_files = sorted(d.glob("pytorch_model*.bin")) + sorted(d.glob("*.pt"))
        if st_files:
            from safetensors import safe_open

            for f in st_files:
                h = safe_open(str(f), framework="pt")
                for k in h.keys():
                    self._get[k] = (lambda h=h, k=k: _numpy(h.get_tensor(k)))
        elif pt_files:
            import torch

            for f in pt_files:
                try:
                    shard = torch.load(str(f), map_location="cpu",
                                       weights_only=True, mmap=True)
                except (TypeError, RuntimeError, ValueError):
                    # legacy (non-zipfile) serialization: resident shard
                    shard = torch.load(str(f), map_location="cpu",
                                       weights_only=True)
                for k, v in shard.items():
                    self._get[k] = (lambda v=v: _numpy(v))
        else:
            raise FileNotFoundError(f"no weights found in {model_dir}")

        # GPTQ groups -> synthesized {base}.weight (resolve_gptq semantics)
        hidden: set[str] = set()
        synth: dict[str, object] = {}
        for k in [k for k in self._get if k.endswith(".qweight")]:
            b = k[: -len(".qweight")]
            parts = {s: self._get.get(b + "." + s) for s in
                     ("qweight", "scales", "qzeros", "zeros", "g_idx", "bias")}
            hidden.update(b + "." + s for s, g in parts.items() if g is not None)

            def dense(parts=parts, b=b):
                bias = parts["bias"] and parts["bias"]()
                if bias is not None:
                    assert not np.any(bias), f"{b}: ggml formats carry no bias"
                return gptq_dense(
                    np.asarray(parts["qweight"]()),
                    np.asarray(parts["scales"]()),
                    qzeros=(np.asarray(parts["qzeros"]())
                            if parts["qzeros"] else None),
                    zeros=(np.asarray(parts["zeros"]())
                           if parts["zeros"] else None),
                    g_idx=(np.asarray(parts["g_idx"]())
                           if parts["g_idx"] else None),
                )

            synth[b + ".weight"] = dense
        for k in hidden:
            del self._get[k]
        self._get.update(synth)

    def __getitem__(self, name: str) -> np.ndarray:
        a = np.asarray(self._get[name]())
        if a.dtype.kind == "f" and a.dtype != np.float32:
            a = a.astype(np.float32)
        return a

    def __contains__(self, name) -> bool:
        return name in self._get

    def __iter__(self):
        return iter(self._get)

    def __len__(self) -> int:
        return len(self._get)

    def keys(self):
        return self._get.keys()

    def items(self):  # lazily — one materialized tensor at a time
        for k in self._get:
            yield k, self[k]


def load_state_dict(model_dir: str) -> LazyStateDict:
    """Open every weight shard in the dir (torch pickle or safetensors) as
    one lazily-merged state dict."""
    return LazyStateDict(model_dir)


# ------------------------------------------------------------------- GPTQ

def _gptq_nibbles(packed: np.ndarray) -> np.ndarray:
    """int32 [R, C] -> uint8 [R, C*8]; packed value j sits at bits 4j."""
    u8 = np.ascontiguousarray(packed).view(np.uint8)  # little-endian bytes
    out = np.empty((u8.shape[0], u8.shape[1] * 2), np.uint8)
    out[:, 0::2] = u8 & 0xF
    out[:, 1::2] = u8 >> 4
    return out


def gptq_dense(qweight: np.ndarray, scales: np.ndarray,
               qzeros: np.ndarray | None = None,
               zeros: np.ndarray | None = None,
               g_idx: np.ndarray | None = None) -> np.ndarray:
    """GPTQ-for-LLaMa tensors -> dense f32 [out, in]
    (GPTQForLLaMaQuantizedTensor semantics, convert.py:277-508):

      qweight int32 [in/8, out] packed along the input dim
      scales  f32 [groups, out] (new style) or [out, 1] (old style)
      qzeros  int32 [groups, out/8] — zero points stored MINUS ONE, so
              zero = (nibble + 1) * scale; or `zeros` already-float
      g_idx   optional int32 [in]: per-input-column group index

      weight[o, i] = nib(qweight)[o, i] * scale[o, g(i)] - zero[o, g(i)]
    """
    qv = _gptq_nibbles(qweight.T).astype(np.float32)  # [out, in]
    scales = np.asarray(scales, np.float32)
    if zeros is None:
        assert qzeros is not None
        zn = _gptq_nibbles(qzeros).astype(np.float32)  # [groups, out]
        zeros = (zn + 1.0) * scales  # the GPTQ minus-one storage quirk
    else:
        zeros = np.asarray(zeros, np.float32)
    if scales.shape[1] != 1:  # new style: transpose to [out, groups]
        scales = scales.T
        zeros = zeros.T
    out_dim, in_dim = qv.shape
    if g_idx is not None:
        s = scales[:, g_idx]  # [out, in]
        z = zeros[:, g_idx]
    else:
        groups = scales.shape[1]
        rep = in_dim // groups
        s = np.repeat(scales, rep, axis=1)
        z = np.repeat(zeros, rep, axis=1)
    return qv * s - z


def resolve_gptq(sd: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Replace GPTQ-quantized tensor groups ({base}.qweight/qzeros/scales
    [/g_idx/zeros/bias]) with dense {base}.weight so the per-arch
    converters see an ordinary state dict (the lazy-repack path of the
    reference is replaced by dequantize-then-requantize — the quantize
    tool re-packs to any ggml ftype afterwards)."""
    bases = [k[: -len(".qweight")] for k in list(sd) if k.endswith(".qweight")]
    for b in bases:
        qweight = sd.pop(b + ".qweight")
        scales = sd.pop(b + ".scales")
        qzeros = sd.pop(b + ".qzeros", None)
        zeros = sd.pop(b + ".zeros", None)
        g_idx = sd.pop(b + ".g_idx", None)
        bias = sd.pop(b + ".bias", None)
        if bias is not None:
            assert not np.any(bias), f"{b}: ggml formats carry no bias"
        sd[b + ".weight"] = gptq_dense(qweight, scales, qzeros=qzeros,
                                       zeros=zeros, g_idx=g_idx)
    return sd


def load_config(model_dir: str) -> dict:
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)


# -------------------------------------------------------------------- vocabs

def sp_vocab(model_dir: str, n_vocab: int) -> list[tuple[bytes, float]]:
    """SentencePiece vocab + scores (convert.py SentencePieceVocab), plus
    added_tokens.json entries (convert.py:204-268)."""
    import sentencepiece

    sp = sentencepiece.SentencePieceProcessor()
    sp.Load(os.path.join(model_dir, "tokenizer.model"))
    vocab = []
    for i in range(sp.vocab_size()):
        piece = sp.IdToPiece(i)
        if sp.IsByte(i):  # "<0xAB>"
            text = bytes([int(piece[3:5], 16)])
        else:
            text = piece.replace("▁", " ").encode("utf-8")
        vocab.append((text, float(sp.GetScore(i))))
    added = os.path.join(model_dir, "added_tokens.json")
    if os.path.exists(added):
        with open(added) as f:
            for text, idx in sorted(json.load(f).items(), key=lambda kv: kv[1]):
                assert idx == len(vocab)
                vocab.append((text.encode("utf-8"), -1000.0))
    assert len(vocab) <= n_vocab, (len(vocab), n_vocab)
    while len(vocab) < n_vocab:
        vocab.append((f"<pad{len(vocab)}>".encode(), -1000.0))
    return vocab


def hf_tokenizer_vocab(model_dir: str, n_vocab: int) -> list[tuple[bytes, float]]:
    """Fallback: decode each id with the HF tokenizer (what the per-arch
    converters do, convert-gptneox-to-ggml.py:72-77)."""
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(model_dir, local_files_only=True)
    return [(tok.decode([i]).encode("utf-8"), 0.0) for i in range(n_vocab)]


def auto_vocab(model_dir: str, n_vocab: int) -> list[tuple[bytes, float]]:
    if os.path.exists(os.path.join(model_dir, "tokenizer.model")):
        try:
            return sp_vocab(model_dir, n_vocab)
        except ImportError:
            pass
    return hf_tokenizer_vocab(model_dir, n_vocab)


# ------------------------------------------------------------------- helpers

def permute_rope(w: np.ndarray, n_head: int) -> np.ndarray:
    """HF interleaved rope layout -> ggml adjacent-pair layout
    (convert.py:271-275)."""
    r, k = w.shape
    return (w.reshape(n_head, 2, r // n_head // 2, k)
             .swapaxes(1, 2).reshape(r, k))


def _emit(w: GGJTWriter, name: str, arr: np.ndarray, f16: bool,
          qtype: GGMLType | None = None):
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    ne = tuple(reversed(arr.shape))
    if qtype is not None and arr.ndim > 1:
        # --outtype q4_0/q4_1: quantize 2-D weights at conversion time
        # (convert.py GGMLFileType.MostlyQ4_0/Q4_1; 1-D stays f32)
        from ..quant.registry import quantize_bytes

        w.write_tensor(name, qtype, ne, quantize_bytes(arr, qtype))
    elif f16 and arr.ndim > 1:
        w.write_tensor(name, GGMLType.F16, ne, arr.astype(np.float16).tobytes())
    else:
        w.write_tensor(name, GGMLType.F32, ne, arr.tobytes())


def write_vocab_only(out_path: str, vocab: list) -> None:
    """--vocab-only: a ggjt v1 file carrying just the vocab (the reference's
    OutputFile.write_vocab_only, convert.py:997-1004) — usable for
    tokenizer work without weights (e.g. models/ggml-vocab.bin)."""
    hp = {"n_vocab": len(vocab), "n_embd": 0, "n_mult": 0, "n_head": 1,
          "n_layer": 0, "n_rot": 0}
    with GGJTWriter(out_path, "llama", hp, 0, vocab, version=1):
        pass


# ------------------------------------------------------------------ per arch

def convert_llama(model_dir: str, out_path: str, *, f16: bool = True,
                  vocab: list | None = None,
                  outtype: str | None = None) -> None:
    qt = {"q4_0": GGMLType.Q4_0, "q4_1": GGMLType.Q4_1}.get(outtype or "")
    if outtype in ("f16", "f32"):
        f16 = outtype == "f16"
    cfg = load_config(model_dir)
    sd = load_state_dict(model_dir)
    n_embd = cfg["hidden_size"]
    n_head = cfg["num_attention_heads"]
    n_layer = cfg["num_hidden_layers"]
    n_vocab = cfg["vocab_size"]
    n_ff = cfg["intermediate_size"]
    # n_mult so that llama_n_ff reproduces intermediate_size (convert.py:143
    # find_n_mult — raises just like the reference when no multiple works)
    n_mult = next((m for m in range(1, 32769)
                   if ((2 * (4 * n_embd) // 3 + m - 1) // m) * m == n_ff), None)
    if n_mult is None:
        raise ValueError(f"failed to find n_mult for n_ff={n_ff}, n_embd={n_embd}")
    hparams = {"n_vocab": n_vocab, "n_embd": n_embd, "n_mult": n_mult,
               "n_head": n_head, "n_layer": n_layer, "n_rot": n_embd // n_head}
    vocab = vocab or auto_vocab(model_dir, n_vocab)
    ftype = (LlamaFType.MOSTLY_Q4_0 if qt == GGMLType.Q4_0
             else LlamaFType.MOSTLY_Q4_1 if qt == GGMLType.Q4_1
             else LlamaFType.MOSTLY_F16 if f16 else LlamaFType.ALL_F32)
    name_map = [
        ("model.embed_tokens.weight", "tok_embeddings.weight"),
        ("model.norm.weight", "norm.weight"),
        ("lm_head.weight", "output.weight"),
    ]
    with GGJTWriter(out_path, "llama", hparams, int(ftype), vocab) as w:
        for src, dst in name_map:
            _emit(w, dst, sd[src], f16, qt)
        for i in range(n_layer):
            p, q = f"model.layers.{i}.", f"layers.{i}."
            _emit(w, q + "attention_norm.weight", sd[p + "input_layernorm.weight"], f16)
            _emit(w, q + "attention.wq.weight",
                  permute_rope(sd[p + "self_attn.q_proj.weight"], n_head), f16, qt)
            _emit(w, q + "attention.wk.weight",
                  permute_rope(sd[p + "self_attn.k_proj.weight"], n_head), f16, qt)
            _emit(w, q + "attention.wv.weight", sd[p + "self_attn.v_proj.weight"], f16, qt)
            _emit(w, q + "attention.wo.weight", sd[p + "self_attn.o_proj.weight"], f16, qt)
            _emit(w, q + "ffn_norm.weight", sd[p + "post_attention_layernorm.weight"], f16)
            _emit(w, q + "feed_forward.w1.weight", sd[p + "mlp.gate_proj.weight"], f16, qt)
            _emit(w, q + "feed_forward.w2.weight", sd[p + "mlp.down_proj.weight"], f16, qt)
            _emit(w, q + "feed_forward.w3.weight", sd[p + "mlp.up_proj.weight"], f16, qt)


_GPTNEOX_SKIP = ("attention.masked_bias", "attention.rotary_emb.inv_freq",
                 "attention.bias")


def convert_gptneox(model_dir: str, out_path: str, *, f16: bool = True,
                    vocab: list | None = None) -> None:
    cfg = load_config(model_dir)
    sd = load_state_dict(model_dir)
    n_embd = cfg["hidden_size"]
    n_head = cfg["num_attention_heads"]
    hparams = {
        "n_vocab": cfg["vocab_size"], "n_ctx": cfg["max_position_embeddings"],
        "n_embd": n_embd, "n_head": n_head,
        "n_layer": cfg["num_hidden_layers"],
        "n_rot": int(cfg.get("rotary_pct", 1.0) * (n_embd // n_head)),
        "use_parallel_residual": int(cfg.get("use_parallel_residual", True)),
    }
    vocab = vocab or auto_vocab(model_dir, hparams["n_vocab"])
    with GGJTWriter(out_path, "gptneox", hparams, 1 if f16 else 0, vocab) as w:
        for name, arr in sd.items():
            if any(s in name for s in _GPTNEOX_SKIP):
                continue
            _emit(w, name, np.squeeze(arr), f16)


def convert_falcon(model_dir: str, out_path: str, *, f16: bool = True,
                   vocab: list | None = None, arch: str = "falcon") -> None:
    cfg = load_config(model_dir)
    sd = load_state_dict(model_dir)
    hparams = {
        "n_vocab": cfg["vocab_size"], "n_embd": cfg["hidden_size"],
        "n_head": cfg.get("n_head") or cfg["num_attention_heads"],
        "n_layer": cfg.get("n_layer") or cfg["num_hidden_layers"],
        "parallel_attn": int(cfg.get("parallel_attn", True)),
    }
    vocab = vocab or auto_vocab(model_dir, hparams["n_vocab"])
    with GGJTWriter(out_path, arch, hparams, 1 if f16 else 0, vocab) as w:
        for name, arr in sd.items():
            _emit(w, name, arr, f16)


def convert_bonsai(model_dir: str, out_path: str, **kw) -> None:
    convert_falcon(model_dir, out_path, arch="bonsai", **kw)


def convert_rwkv(model_dir: str, out_path: str, *, f16: bool = True,
                 vocab: list | None = None) -> None:
    cfg = load_config(model_dir)
    sd = load_state_dict(model_dir)
    rescale_every = int(cfg.get("rescale_every", 6))
    hparams = {
        "n_vocab": cfg["vocab_size"], "n_ctx": cfg["context_length"],
        "n_embd": cfg["hidden_size"], "n_layer": cfg["num_hidden_layers"],
        "rescale_every": rescale_every,
    }
    vocab = vocab or auto_vocab(model_dir, hparams["n_vocab"])
    with GGJTWriter(out_path, "rwkv", hparams, 1 if f16 else 0, vocab) as w:
        for name, arr in sd.items():
            arr = np.asarray(arr, np.float32)
            if ".time_" in name:
                arr = np.squeeze(arr)
            if ".time_decay" in name:
                arr = -np.exp(arr)
            if rescale_every > 0 and (".attention.output.weight" in name
                                      or ".feed_forward.value.weight" in name):
                block_id = int(name.split(".")[2])
                arr = arr / (2.0 ** (block_id // rescale_every))
            _emit(w, name, arr, f16)


CONVERTERS = {
    "llama": convert_llama,
    "gptneox": convert_gptneox,
    "falcon": convert_falcon,
    "bonsai": convert_bonsai,
    "rwkv": convert_rwkv,
}


def detect_hf_arch(model_dir: str) -> str:
    mt = load_config(model_dir).get("model_type", "").lower()
    for key, arch in (("llama", "llama"), ("gpt_neox", "gptneox"),
                      ("falcon", "falcon"), ("refinedweb", "falcon"),
                      ("rwkv", "rwkv"), ("bonsai", "bonsai")):
        if key in mt:
            return arch
    raise ValueError(f"cannot map model_type '{mt}' to an architecture")
