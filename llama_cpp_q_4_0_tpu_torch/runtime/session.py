"""Context state snapshot, session files and the KV-cache shift.

The reference's three checkpoint mechanisms, as the JAX package's
``runtime/session.py`` has them:

  - raw state blob: llama_get_state_size / llama_copy_state_data /
    llama_set_state_data -> get_state / set_state dicts + state_to_bytes /
    state_from_bytes (an npz: the same bytes either package reads)
  - session files: the token list + state blob (llama_{load,save}_session_file)
    -> save_session / load_session (a zip of meta.json + state.npz, no
    pickle), or the reference's binary GGSN v1 for a ``.ggsn`` path
    (formats/ggsn.py)
  - the O(1) KV shift (llama_shift_kv_cache), with the moved K re-rotated by
    -n_discard positions, which makes the shift exact for every family.

A Context's CUDA graphs hold its cache tensors by address
(runtime/context.py), so every restore and the shift write into the existing
tensors (the QuantKV levels and scales included) and never rebind them.  An
RwkvContext's state blob holds its five recurrent tensors (the ``s_`` keys)
in place of the caches, restored into the state tensors in place; the KV
shift and GGSN files are a transformer Context's only.

A Context over a mesh keeps a slice of each cache on every rank
(``parallel.shard.cache_spec``: rows over dp, context slots over sp, heads
over tp).  Its blob is the layout-free one: ``get_state`` gathers the slices
into the whole [B, S, H_kv, D] arrays on every rank (a collective: every
rank of the mesh calls it), so a mesh Context's blob loads into a
single-device Context and the reverse; ``set_state`` writes each rank's
slice of a blob into its caches in place.  Only the primary rank writes a
session file, and the mesh's ranks meet at a barrier before any of them
reads one.  The shift gathers each layer over sp, shifts the whole context
and keeps this rank's block, so slots move across the ranks' blocks.
"""

from __future__ import annotations

import io
import json
import zipfile

import numpy as np
import torch

from ..ops.kvcache import QuantKV, quantize_kv, raw, to_cache
from ..ops.layers import rope

SESSION_MAGIC = "ggsn"
SESSION_VERSION = 1


def _rng_state_to_json(state) -> str:
    """numpy bit-generator state -> JSON (plain dict of ints/str/arrays).
    No pickle anywhere: session files may come from untrusted sources."""
    def enc(o):
        if isinstance(o, np.ndarray):
            return {"__ndarray__": o.tolist(), "dtype": str(o.dtype)}
        if isinstance(o, np.integer):
            return int(o)
        raise TypeError(f"unserializable rng state field {type(o)}")

    return json.dumps(state, default=enc)


def _rng_state_from_json(s: str):
    def hook(d):
        if "__ndarray__" in d:
            return np.asarray(d["__ndarray__"], dtype=d["dtype"])
        return d

    return json.loads(s, object_hook=hook)


def _caches(ctx):
    if not hasattr(ctx, "cache_k"):
        raise TypeError("a recurrent (RWKV) context has no KV cache")
    return ctx.cache_k, ctx.cache_v


def _mesh(ctx):
    return getattr(ctx, "mesh", None)


def _gather(x: torch.Tensor, ctx, axes=("dp", "sp", "tp")) -> torch.Tensor:
    """A cache tensor of a mesh Context ([B, S, H_kv, D] levels or values,
    [B, S, H_kv] scales) gathered from every rank's slice along the named
    axes of ``cache_spec``, in each axis's rank order."""
    from ..parallel.mesh import all_gather
    from ..parallel.shard import cache_spec

    for dim, axis in enumerate(cache_spec(ctx.cfg, ctx.mesh)[:x.dim()]):
        if axis in axes:
            x = all_gather(x, ctx.mesh, axis, dim=dim)
    return x


def whole_layer(ctx, c, axes=("dp", "sp", "tp")):
    """One cache layer whole, as the Context stores it (a QuantKV's levels
    and scales, else the values in the cache's dtype): the layer itself
    without a mesh; over a mesh every rank's slice gathered along axes (a
    collective)."""
    if _mesh(ctx) is None:
        return c
    if isinstance(c, QuantKV):
        return QuantKV(_gather(c.data, ctx, axes), _gather(c.scale, ctx, axes))
    return _gather(raw(c), ctx, axes).view(c.dtype)


def _local(ctx, x: torch.Tensor) -> torch.Tensor:
    """This rank's slice of a whole cache tensor (levels or values [B, S,
    H_kv, D], scales [B, S, H_kv]): the tensor itself without a mesh."""
    mesh = _mesh(ctx)
    if mesh is None:
        return x
    from ..parallel.shard import cache_spec, local_slice

    return local_slice(x, mesh, cache_spec(ctx.cfg, mesh)[:x.dim()])


def _barrier(ctx) -> None:
    """A mesh Context's ranks meet (a file one wrote is there for all)."""
    if _mesh(ctx) is not None:
        from ..parallel.distributed import sync_hosts

        sync_hosts("session", mesh=ctx.mesh)


def _writes_files(ctx) -> bool:
    """Whether this process writes ctx's session files: every process for
    a single-device Context, the primary rank for a mesh's."""
    from ..parallel.distributed import is_primary

    return _mesh(ctx) is None or is_primary()


# ---------------------------------------------------------------- state blob

def get_state(ctx) -> dict:
    """Everything needed to resume decoding (the llama_copy_state_data
    payload: the K/V caches, n_past and the last logits; the sampler's RNG
    is passed separately).  A float cache is stored as f32 (npz has neither
    bf16 nor e4m3; the upcast is exact), a QuantKV cache as its levels and
    scales verbatim; an RWKV context's state as its ``s_`` arrays.  A mesh
    Context's caches are gathered whole (``whole_layer``), the same blob
    on every rank."""
    state = {"n_past": ctx.n_past}
    if hasattr(ctx, "cache_k"):
        for i, (k, v) in enumerate(zip(*_caches(ctx))):
            for name, c in ((f"k{i}", k), (f"v{i}", v)):
                c = whole_layer(ctx, c)
                if isinstance(c, QuantKV):
                    state[name] = c.data.cpu().numpy()
                    state[name + "_s"] = c.scale.cpu().numpy()
                else:
                    state[name] = c.float().cpu().numpy()
    else:  # recurrent (rwkv)
        for name, arr in ctx.get_state().items():
            state["s_" + name] = arr
    if ctx.logits is not None:
        state["logits"] = np.asarray(ctx.logits)
    return state


def _copy_in(dst: torch.Tensor, src: torch.Tensor, name: str) -> None:
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"state {name} has shape {tuple(src.shape)}, the "
                         f"context's cache {tuple(dst.shape)}")
    raw(dst).copy_(raw(src.to(dst.device)))


def _restore(ctx, state: dict, name: str, cur) -> None:
    """One cache layer from the state, written into cur in place: levels and
    scales as saved, an f32 array quantized into a QuantKV, a q8 one
    dequantized into a float cache, as the JAX ``set_state`` converts.  A
    mesh Context's rank takes its slice of the whole arrays first (each
    conversion acts on one slot and head at a time)."""
    arr = torch.from_numpy(np.array(state[name]))
    scale = state.get(name + "_s")
    scale = None if scale is None else torch.from_numpy(np.asarray(scale, np.float32))
    if _mesh(ctx) is not None:
        whole = (ctx.batch, ctx.n_ctx, ctx.cfg.kv_heads, ctx.cfg.head_dim)
        if tuple(arr.shape) != whole:
            raise ValueError(f"state {name} has shape {tuple(arr.shape)}, the "
                             f"context's whole cache {whole}")
        arr = _local(ctx, arr)
        scale = None if scale is None else _local(ctx, scale)
    if isinstance(cur, QuantKV):
        if scale is not None:
            q, sc = arr.to(torch.int8), scale
        else:
            q, sc = quantize_kv(arr.float().to(cur.data.device))
        _copy_in(cur.data, q, name)
        _copy_in(cur.scale, sc, name + "_s")
        return
    val = arr.float()
    if scale is not None:  # a q8 blob into a float cache: dequantize
        val = val * scale[..., None]
    _copy_in(cur, to_cache(val, cur.dtype), name)


def set_state(ctx, state: dict) -> None:
    """Restore a get_state dict into ctx, writing into its caches (or its
    recurrent state) in place; a mesh Context's rank writes its slice."""
    if hasattr(ctx, "cache_k"):
        cache_k, cache_v = _caches(ctx)
        for i in range(len(cache_k)):
            _restore(ctx, state, f"k{i}", cache_k[i])
            _restore(ctx, state, f"v{i}", cache_v[i])
    else:
        ctx.set_state({k[2:]: v for k, v in state.items() if k.startswith("s_")})
    ctx.n_past = int(state["n_past"])
    if "logits" in state:
        ctx._logits = state["logits"]


def state_to_bytes(state: dict) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in state.items()})
    return buf.getvalue()


def state_from_bytes(data: bytes) -> dict:
    arrs = dict(np.load(io.BytesIO(data)))
    return {k: (int(v) if v.ndim == 0 else v) for k, v in arrs.items()}


def get_state_size(ctx) -> int:
    """llama_get_state_size analogue (the blob's size)."""
    return len(state_to_bytes(get_state(ctx)))


# ------------------------------------------------------------- session files

def save_session(path: str, ctx, tokens: list[int], *, rng=None,
                 hparams: dict | None = None, ftype: int = 0) -> None:
    """Token list + full state (main --prompt-cache).

    A path ending in .ggsn writes the reference's binary GGSN v1 format
    instead (formats/ggsn.py; needs the model file's hparams dict), which
    the reference binary loads.  Over a mesh every rank calls it (the
    state's gather is a collective), the primary rank writes the file, and
    the ranks return together once it is written."""
    if path.endswith(".ggsn"):
        from ..formats.ggsn import save_session_ggsn

        if hparams is None:
            raise ValueError("GGSN save needs the model hparams "
                             "(GGJTFile.hparams)")
        save_session_ggsn(path, ctx, tokens, hparams, ftype)
        _barrier(ctx)
        return
    meta = {
        "magic": SESSION_MAGIC,
        "version": SESSION_VERSION,
        "tokens": [int(t) for t in tokens],
        "has_rng": rng is not None,
    }
    blob = state_to_bytes(get_state(ctx))
    if _writes_files(ctx):
        with zipfile.ZipFile(path, "w") as z:
            z.writestr("meta.json", json.dumps(meta))
            z.writestr("state.npz", blob)
            if rng is not None:
                z.writestr("rng.json", _rng_state_to_json(rng.bit_generator.state))
    _barrier(ctx)


def load_session(path: str, ctx, *, rng=None) -> list[int]:
    """Restores ctx state in place and returns the session's token list.
    GGSN v1 files (the reference's, or a .ggsn save) are detected by magic.
    Over a mesh every rank reads the file, after the ranks meet."""
    from ..formats.ggsn import is_ggsn, load_session_ggsn

    _barrier(ctx)
    if is_ggsn(path):
        return load_session_ggsn(path, ctx)
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        if meta.get("magic") != SESSION_MAGIC:
            raise ValueError(f"bad session magic in {path}")
        if meta.get("version") != SESSION_VERSION:
            raise ValueError(f"unsupported session version {meta.get('version')}")
        set_state(ctx, state_from_bytes(z.read("state.npz")))
        if rng is not None and meta.get("has_rng"):
            rng.bit_generator.state = _rng_state_from_json(
                z.read("rng.json").decode())
    return list(meta["tokens"])


def session_prefix_match(session_tokens: list[int], prompt: list[int]) -> int:
    """Longest reusable prefix (main's session prefix logic)."""
    n = 0
    for a, b in zip(session_tokens, prompt):
        if a != b:
            break
        n += 1
    return n


# ----------------------------------------------------------------- KV shift

def _take(t: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """t gathered at slots src along dim 1 (an f8 tensor through its bytes)."""
    return raw(t).index_select(1, src).view(t.dtype)


def shift_layer(cfg, k, v, n_keep: int, n_discard: int):
    """The JAX ``_shift_kv`` for one layer: the new (K, V), computed into
    tensors of their own (the slots read and written overlap).  Slot i takes
    slot min(i + n_discard, S - 1) from n_keep on; the moved K is re-rotated
    by -n_discard positions (rope(p) then rope(-n) is rope(p - n)), in f32
    and rounded back to the cache's dtype.  A QuantKV K is dequantized,
    rotated and requantized (every slot, as in JAX), its V's levels and
    scales gathered."""
    is_q = isinstance(k, QuantKV)
    dev = (k.data if is_q else k).device
    b, s = k.shape[0], k.shape[1]
    idx = torch.arange(s, device=dev)
    src = torch.where(idx >= n_keep, idx + n_discard, idx).clamp(max=s - 1)
    if is_q:
        kf = _take(k.data, src).float() * _take(k.scale, src)[..., None]
    else:
        kf = _take(k, src).float()
    if cfg.n_rot > 0:
        delta = torch.full((b, s), -n_discard, dtype=torch.int64, device=dev)
        moved = rope(kf, delta, cfg.n_rot, neox=cfg.rope_neox, base=cfg.rope_base)
        kf = torch.where((idx < n_keep)[None, :, None, None], kf, moved)
    if is_q:
        return (QuantKV(*quantize_kv(kf)),
                QuantKV(_take(v.data, src), _take(v.scale, src)))
    return to_cache(kf, k.dtype), _take(v, src)


def _own_block(ctx, c):
    """This sp rank's block of context slots of a layer gathered over sp."""
    if isinstance(c, QuantKV):
        return QuantKV(_own_block(ctx, c.data), _own_block(ctx, c.scale))
    s_l = c.shape[1] // ctx.mesh.shape["sp"]
    return c.narrow(1, ctx.mesh.coords["sp"] * s_l, s_l)


def shift_kv_cache(ctx, n_keep: int, n_discard: int) -> None:
    """Drop tokens [n_keep, n_keep + n_discard) from the cache; the positions
    of the surviving tokens are rewritten exactly.  Each layer is computed
    into a temporary and copied back into the cache tensors in place.  Over
    a mesh whose sp splits the context, each layer is gathered over sp (a
    collective), shifted whole and this rank's block kept."""
    assert n_keep + n_discard <= ctx.n_past
    cache_k, cache_v = _caches(ctx)
    split = _mesh(ctx) is not None and ctx.mesh.shape["sp"] > 1
    for k, v in zip(cache_k, cache_v):
        if split:
            nk, nv = shift_layer(ctx.cfg, whole_layer(ctx, k, ("sp",)),
                                 whole_layer(ctx, v, ("sp",)), n_keep, n_discard)
            nk, nv = _own_block(ctx, nk), _own_block(ctx, nv)
        else:
            nk, nv = shift_layer(ctx.cfg, k, v, n_keep, n_discard)
        for dst, new in ((k, nk), (v, nv)):
            if isinstance(dst, QuantKV):
                dst.data.copy_(new.data)
                dst.scale.copy_(new.scale)
            else:
                raw(dst).copy_(raw(new))
    ctx.n_past -= n_discard
