"""GGSN v1 session files: byte-level interop with the reference.

The reference persists a generation session as magic 'ggsn' + version +
raw `llama_hparams` + prompt tokens + an opaque state blob
(llama_save_session_file / llama_load_session_file); the blob layout is
fixed by llama_copy_state_data / llama_set_state_data:

    size_t rng_size; char rng[65536]      # std::mt19937 <<-serialization
    size_t logits_cap; size_t logits_size; float[logits_cap]
    size_t emb_size; float[emb_size]
    size_t kv_bytes; int32 kv_ntok
    k: [n_layer, kv_ntok, n_embd]  (f16 by default)
    v: [n_layer, n_embd, kv_ntok]  (the reference's transposed V cache)

This module reads and writes that exact layout, as the JAX package's
``formats/ggsn.py`` does, byte for byte.  The zip format of
``runtime/session.py`` stays the richer default (it also carries the
sampler's state); GGSN is the compatibility surface, LLaMA only.

Loading writes into the Context's cache tensors in place: the CUDA graphs of
a Context hold them by address (runtime/context.py).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..ops.kvcache import QuantKV, quantize_kv, raw, to_cache

MAGIC = 0x6767736E  # 'ggsn'
VERSION = 1
MAX_RNG_STATE = 64 * 1024
_MB = 1024 * 1024  # ggml buffer slack in the reference's kv_self.buf

HPARAM_FIELDS = ("n_vocab", "n_ctx", "n_embd", "n_mult", "n_head",
                 "n_layer", "n_rot", "ftype")


def mt19937_stream(seed: int = 5489) -> str:
    """std::mt19937 state in libstdc++ operator<< form ("x0 .. x623 p"):
    the reference parses the rng blob with `rng_ss >> ctx->rng` and asserts
    success, so the writer must emit a stream that round-trips."""
    s = np.empty(624, np.uint64)
    s[0] = seed & 0xFFFFFFFF
    for i in range(1, 624):
        s[i] = (1812433253 * (s[i - 1] ^ (s[i - 1] >> 30)) + i) & 0xFFFFFFFF
    return " ".join(str(int(x)) for x in s) + " 624"


def pack_hparams(hp: dict, n_ctx: int, ftype: int) -> bytes:
    """Raw `llama_hparams` (8 consecutive u32s).  The reference
    memcmp-compares this on load, so n_ctx must be the context size the
    loading process will use."""
    vals = dict(hp)
    vals["n_ctx"] = n_ctx
    vals["ftype"] = ftype
    return struct.pack("<8I", *(vals[f] for f in HPARAM_FIELDS))


def _cache_rows(cache, n: int) -> np.ndarray:
    """First n slots of one layer's [1, S, H, D] cache row as [n, E] f32."""
    if isinstance(cache, QuantKV):
        vals = (cache.data[0, :n].float().cpu().numpy()
                * cache.scale[0, :n].float().cpu().numpy()[..., None])
    else:
        vals = cache[0, :n].float().cpu().numpy()
    return vals.reshape(n, -1)


def save_session_ggsn(path: str, ctx, tokens: list[int], hparams: dict,
                      ftype: int, *, rng_seed: int = 5489,
                      kv_dtype=np.float16) -> None:
    """Write ctx (a batch-1 Context) as a reference-loadable GGSN v1 file.

    hparams: the model file's header dict (GGJTFile.hparams, LLaMA); the
    session's n_ctx field is ctx.n_ctx, so load the file into a context made
    with the same -c.  Over a mesh every rank calls it (each layer is
    gathered whole) and the primary rank writes the file."""
    from ..runtime.session import _writes_files, whole_layer

    assert ctx.batch == 1, "GGSN sessions are single-stream"
    cfg = ctx.cfg
    missing = [f for f in HPARAM_FIELDS
               if f not in hparams and f not in ("n_ctx", "ftype")]
    if missing:
        raise ValueError(
            f"GGSN sessions are llama-architecture only (the raw "
            f"llama_hparams block needs {missing}; {cfg.arch} model "
            f"headers do not carry them) — use the native zip format")
    ntok = ctx.n_past
    e, L, s = cfg.n_embd, cfg.n_layer, ctx.n_ctx
    elt = np.dtype(kv_dtype).itemsize

    rng = mt19937_stream(rng_seed).encode()
    assert len(rng) < MAX_RNG_STATE
    logits = (np.zeros((cfg.n_vocab,), np.float32)
              if ctx.logits is None
              else np.asarray(ctx.logits)[0, -1].astype(np.float32))

    k = v = None
    if ntok:
        k = np.stack([_cache_rows(whole_layer(ctx, ctx.cache_k[l]), ntok)
                      for l in range(L)])  # [L, ntok, E]
        v = np.stack([_cache_rows(whole_layer(ctx, ctx.cache_v[l]), ntok).T
                      for l in range(L)])  # [L, E, ntok]
    if not _writes_files(ctx):
        return
    with open(path, "wb") as f:
        f.write(struct.pack("<II", MAGIC, VERSION))
        f.write(pack_hparams(hparams, s, ftype))
        f.write(struct.pack("<I", len(tokens)))
        f.write(np.asarray(tokens, np.int32).tobytes())
        # --- state blob (llama_copy_state_data layout) ---
        f.write(struct.pack("<Q", len(rng)))
        f.write(rng.ljust(MAX_RNG_STATE, b"\0"))
        f.write(struct.pack("<QQ", cfg.n_vocab, cfg.n_vocab))
        f.write(logits.tobytes())
        f.write(struct.pack("<Q", 0))  # embedding_size (not requested)
        kv_bytes = 2 * L * s * e * elt + 2 * _MB
        f.write(struct.pack("<Qi", kv_bytes, ntok))
        if ntok:
            f.write(k.astype(kv_dtype).tobytes())
            f.write(v.astype(kv_dtype).tobytes())


def _put(cache, rows: np.ndarray, kv_heads: int, head_dim: int) -> None:
    """rows [n, E] f32 into the first n slots of batch row 0, in place."""
    n = rows.shape[0]
    dev = (cache.data if isinstance(cache, QuantKV) else cache).device
    val = torch.from_numpy(np.ascontiguousarray(rows)).to(dev).reshape(
        1, n, kv_heads, head_dim)
    if isinstance(cache, QuantKV):
        q, sc = quantize_kv(val)
        cache.data[:1, :n].copy_(q)
        cache.scale[:1, :n].copy_(sc)
    else:
        raw(cache)[:1, :n].copy_(raw(to_cache(val, cache.dtype)))


def load_session_ggsn(path: str, ctx) -> list[int]:
    """Load a GGSN v1 file (reference- or self-written) into ctx: restores
    the KV cache (in place), n_past and the last logits; returns the token
    history.  The KV element size (f16 by default, f32 under the
    reference's --memory-f32) is inferred from the recorded kv_self buffer
    size.  Raises ValueError on a magic, version or hparams mismatch."""
    cfg = ctx.cfg
    with open(path, "rb") as f:
        magic, version = struct.unpack("<II", f.read(8))
        if magic != MAGIC or version != VERSION:
            raise ValueError(f"not a GGSN v1 session: {magic:08x} v{version}")
        hp = dict(zip(HPARAM_FIELDS, struct.unpack("<8I", f.read(32))))
        if (hp["n_vocab"], hp["n_embd"], hp["n_layer"]) != (
                cfg.n_vocab, cfg.n_embd, cfg.n_layer):
            raise ValueError(f"session hparams mismatch: {hp}")
        if hp["n_ctx"] != ctx.n_ctx:
            raise ValueError(
                f"session n_ctx {hp['n_ctx']} != context {ctx.n_ctx}")
        (n_tok,) = struct.unpack("<I", f.read(4))
        tokens = np.frombuffer(f.read(4 * n_tok), np.int32).tolist()
        # --- state blob ---
        struct.unpack("<Q", f.read(8))  # rng_size
        f.read(MAX_RNG_STATE)  # mt19937 text; the sampler's rng is numpy's
        logits_cap, logits_size = struct.unpack("<QQ", f.read(16))
        logits = np.frombuffer(f.read(4 * logits_size), np.float32)
        f.read(4 * (logits_cap - logits_size))
        (emb_size,) = struct.unpack("<Q", f.read(8))
        f.read(4 * emb_size)
        kv_bytes, ntok = struct.unpack("<Qi", f.read(12))
        e, L, s = cfg.n_embd, cfg.n_layer, ctx.n_ctx
        if ntok:
            # kv_bytes records kv_self.buf.size = 2*L*s*e*elt + 2 MB:
            # recover the element size instead of assuming f16 (the
            # reference's --memory-f32 writes f32)
            elt = (kv_bytes - 2 * _MB) // (2 * L * s * e)
            if elt not in (2, 4):
                raise ValueError(f"unrecognized KV element size {elt} "
                                 f"(kv_bytes={kv_bytes})")
            kv_dtype = np.float16 if elt == 2 else np.float32
            k = np.frombuffer(f.read(L * ntok * e * elt), kv_dtype)
            v = np.frombuffer(f.read(L * ntok * e * elt), kv_dtype)
            k = k.astype(np.float32).reshape(L, ntok, e)
            v = v.astype(np.float32).reshape(L, e, ntok)

    if ntok and getattr(ctx, "mesh", None) is not None:
        # a mesh Context's ranks each write their slice of the whole layers
        # (the slots past ntok zeroed: no step reads them before writing)
        from ..runtime.session import set_state

        whole = np.zeros((L, s, e), np.float32)
        state = {"n_past": int(ntok)}
        for name, rows in (("k", k), ("v", v.transpose(0, 2, 1))):
            whole[:, :ntok] = rows
            for l in range(L):
                state[f"{name}{l}"] = whole[l].reshape(1, s, cfg.kv_heads,
                                                       cfg.head_dim).copy()
        set_state(ctx, state)
    elif ntok:
        for l in range(L):
            _put(ctx.cache_k[l], k[l], cfg.kv_heads, cfg.head_dim)
            _put(ctx.cache_v[l], v[l].T, cfg.kv_heads, cfg.head_dim)
    ctx.n_past = int(ntok)
    if logits_size:
        ctx._logits = logits.reshape(1, 1, -1).copy()
    return tokens


def is_ggsn(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return struct.unpack("<I", f.read(4))[0] == MAGIC
    except (OSError, struct.error):
        return False
