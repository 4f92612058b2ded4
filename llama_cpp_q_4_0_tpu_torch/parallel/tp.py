"""The sharded forward: tensor parallel (Megatron), and the batch rows over
dp and the cache's context over sp, with every collective written out.

The JAX package's ``parallel/tp.py`` writes the tensor-parallel forward
under ``shard_map`` so that each chip runs the quantized matmul kernel on its
own weight shard; here each rank is a process and runs the same body on its
slices.  The only communication of the tp split is two psums a layer (after
``wo`` and after ``w_down``), one for the vocabulary-sharded embedding and
one all-gather of the logits along the vocabulary.  Every local matmul goes
through ``ops/qmatmul.py::q_matmul`` on the local shape, so a shard takes
the kernel (K1, K2, K7) or the off-gate product that the JAX dispatch gives
that shape.

Sharding contract (parallel/shard.py):
  wq wk wv w_gate w_up (and biases) : column-parallel, output dim over tp
  wo w_down                         : row-parallel, reduce dim over tp -> psum
  embedding, output head            : over the vocabulary -> all-gather
  KV cache                          : heads over tp (MQA: replicated KV and
                                      projections, local query heads)

``mesh_forward`` also carries what GSPMD does for the JAX ``Context(mesh)``
and ``BatchEngine(mesh=...)``: with ``dp_rows`` the caches hold this dp
rank's rows of the batch and the logits are gathered over dp; with
``sp_cache`` they hold its sp rank's block of context slots: the K/V insert
writes only the slots this rank owns, and the attention of each rank over
its own slots in the window merges across sp as ``ring_attention._merge``
does (the f16-table softmax of ``cfg.act_f16_table`` instead all-reduces
each row's max over sp before its exps, ``_sp_table_attention``).  A ring
attention_fn (``ring_prefill_fn``) splits a whole-prompt prefill's tokens
over sp; its K/V blocks travel only on the ring, and each rank writes the
slots it owns of every block as the block passes (under the f16 table the
prompt stays whole and takes the two-pass form over the split cache).
``tp_forward`` is the JAX function: tp alone, the caches whole over dp and
sp.  The sharded step runs eagerly: gloo's
collectives are host calls, which a CUDA graph cannot hold.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os

import torch
import torch.distributed as dist

from ..models.config import ModelConfig
from ..models.fuse import defuse_projections
from ..models.transformer import (Block, TransformerParams, _act, _cache_insert,
                                  _cache_insert_rows, _device_int, _embed, _insert_slots,
                                  _kv_view, _mm, _norm, _qkv, _roundtrip, _row_slots)
from ..ops.kvcache import QuantKV, quantize_kv, raw, to_cache
from ..ops.layers import attention, rope
from ..ops.qmm import bf16_f32
from ..ops.qtensor import QTensor
from .mesh import Mesh, all_gather, all_reduce, axis_index, psum
from .ring_attention import RingPrefill, _finish, _merge, _partial, ring_self_attention
from .shard import _put, block_dim, kv_sharded, put_weight, weight_specs

_KV_FIELDS = ("wk", "wv", "bk", "bv")
_SHARD_MAJOR = ("tp", None, None)  # the planes of a repack_row_shards weight


def _wspec(w, dim: str):
    """JAX's spec tree of one weight: ``shard.weight_specs``, except that a
    row weight packed per shard (``repack_row_shards``) splits its planes'
    leading axis and a replicated dense weight is JAX's ``P()``."""
    if w is None:
        return None
    if isinstance(w, QTensor):
        spec, sspec = weight_specs(w, dim)
        if dim == "row" and w.packed:
            sspec = _SHARD_MAJOR
        return dataclasses.replace(w, levels_t=spec, gscale_t=sspec,
                                   gbias_t=sspec if w.gbias_t is not None else None)
    spec = weight_specs(w, dim)
    return () if all(ax is None for ax in spec) else spec


def _dim(field: str, kv_split: bool) -> str:
    return "rep" if field in _KV_FIELDS and not kv_split else block_dim(field)


def param_specs(cfg: ModelConfig, params: TransformerParams,
                kv_split: bool) -> TransformerParams:
    """The spec tree matching params (the KV projections replicated for MQA)."""
    def block_specs(blk: Block) -> Block:
        return Block(**{f.name: _wspec(getattr(blk, f.name), _dim(f.name, kv_split))
                        for f in dataclasses.fields(Block)})

    return TransformerParams(
        tok_embeddings=_wspec(params.tok_embeddings, "col"),
        blocks=tuple(block_specs(b) for b in params.blocks),
        out_norm_w=_wspec(params.out_norm_w, "rep"),
        out_norm_b=_wspec(params.out_norm_b, "rep"),
        output=_wspec(params.output, "col"))


def _split_groups(w: QTensor, g: int, cfg: ModelConfig) -> QTensor:
    """An unpacked QTensor with groups of g rows (g divides its gsize): each
    scale (and bias) row repeated gsize/g times, the levels as they are."""
    if cfg.compute_dtype == "ref_int8":
        raise ValueError(f"a {w.gsize}-group weight of K {w.shape[1]} does not split into "
                         "whole groups over tp, which ref_int8's q8 activations need")
    f = w.gsize // g
    return dataclasses.replace(
        w, gsize=g, gscale_t=w.gscale_t.repeat_interleave(f, 0),
        gbias_t=None if w.gbias_t is None else w.gbias_t.repeat_interleave(f, 0))


def prepare_tp_params(params: TransformerParams, mesh: Mesh,
                      cfg: ModelConfig) -> TransformerParams:
    """This rank's params for the tp forward.  Fused projections are split
    back first (a column shard of a fused QKV would straddle q, k and v).
    Column weights keep their packing; a row weight is repacked per shard
    where K % tp == 0 and (K/tp/2) % gsize == 0 (each rank streams 4-bit
    levels of its own contiguous K range), and unpacked otherwise; MQA's KV
    projections are replicated.  An unpacked row shard of less than whole
    groups (K/tp % gsize != 0, a narrow model over a wide tp, which JAX's
    GSPMD splits anyway) takes groups of gcd(gsize, K/tp), each group's
    scale repeated for its parts: the same dequantized values, so the same
    products in bf16 or f32 compute (ref_int8's q8 activation groups would
    change, and it refuses)."""
    tp = mesh.shape["tp"]
    kv_split = kv_sharded(cfg, tp)
    params = defuse_projections(cfg, params)

    def place(field: str, w):
        dim = _dim(field, kv_split)
        if dim == "row" and isinstance(w, QTensor):
            kl = w.shape[1] // tp
            if w.shape[1] % tp == 0 and kl % 2 == 0 and (kl // 2) % w.gsize == 0:
                rs = w.repack_row_shards(tp)
                return dataclasses.replace(
                    rs, levels_t=_put(rs.levels_t, mesh, ("tp", None)),
                    gscale_t=_put(rs.gscale_t, mesh, _SHARD_MAJOR),
                    gbias_t=_put(rs.gbias_t, mesh, _SHARD_MAJOR))
            w = w.unpack()
            if w.shape[1] % tp == 0 and kl % w.gsize:
                w = _split_groups(w, math.gcd(w.gsize, kl), cfg)
        return put_weight(w, mesh, dim)

    return TransformerParams(
        tok_embeddings=put_weight(params.tok_embeddings, mesh, "col"),
        blocks=tuple(Block(**{f.name: place(f.name, getattr(b, f.name))
                              for f in dataclasses.fields(Block)}) for b in params.blocks),
        out_norm_w=put_weight(params.out_norm_w, mesh, "rep"),
        out_norm_b=put_weight(params.out_norm_b, mesh, "rep"),
        output=put_weight(params.output, mesh, "col"))


def _localize(w):
    """A QTensor's shape made the local shard's (JAX fixes it inside
    shard_map the same way)."""
    if not isinstance(w, QTensor):
        return w
    if w.packed:  # column shards; row shards come local from repack_row_shards
        return dataclasses.replace(w, shape=(w.levels_t.shape[1], w.shape[1]))
    k_l, n_l = w.levels_t.shape
    return dataclasses.replace(w, shape=(n_l, k_l))


def _local_params(params: TransformerParams) -> TransformerParams:
    def blk(b: Block) -> Block:
        return Block(**{f.name: _localize(getattr(b, f.name)) for f in dataclasses.fields(Block)})

    return TransformerParams(tok_embeddings=_localize(params.tok_embeddings),
                             blocks=tuple(blk(b) for b in params.blocks),
                             out_norm_w=params.out_norm_w, out_norm_b=params.out_norm_b,
                             output=_localize(params.output))


@functools.lru_cache(maxsize=8)
def spec_forward(mesh: Mesh):
    """A forward_fn with transformer.forward's arguments whose forwards run
    through tp_forward over mesh (the speculative verify, the serving
    engine's ticks and admissions).  Scalar or per-row n_past and
    kv_window, as tp_forward; one object a mesh."""

    def fwd(cfg, params, toks, n_past, ck, cv, *, last_only=False, kv_window=None):
        return tp_forward(cfg, params, toks, n_past, ck, cv, mesh, last_only=last_only,
                          kv_window=kv_window)

    return fwd


def tp_forward(cfg: ModelConfig, params: TransformerParams, tokens: torch.Tensor, n_past,
               cache_k: list, cache_v: list, mesh: Mesh, *, last_only: bool = True,
               kv_window: int | None = None, attention_fn=None) -> torch.Tensor:
    """The JAX ``tp_forward``: logits [B, T | 1, V] (the whole vocabulary,
    on every rank) of tokens [B, T] (the same on every rank) after n_past (a
    scalar or [B]); params from ``prepare_tp_params``; this rank's caches
    (heads over tp, ``shard_cache``) written in place.  attention_fn: as
    transformer.forward's (the flash prefill on the local heads)."""
    return mesh_forward(cfg, params, tokens, n_past, cache_k, cache_v, mesh,
                        last_only=last_only, kv_window=kv_window, attention_fn=attention_fn)


def _owned_writes(n_past: torch.Tensor, b: int, s: int, t: int, s_l: int, r: int):
    """The writes of a T-token insert that land in sp rank r's block of
    context slots [r*S_l, (r+1)*S_l): (rows, token index j, local slot).  A
    scalar n_past clamps its start to [0, S - T] as ``_insert_slots`` does;
    a per-row one drops slots >= S, as ``_row_slots`` does."""
    ar = torch.arange(t, device=n_past.device)
    if n_past.dim() == 0:
        pos = (n_past.clamp(max=s - t).clamp(min=0) + ar)[None, :].expand(b, t)
    else:
        pos = n_past[:, None] + ar
    local = pos - r * s_l
    keep = (local >= 0) & (local < s_l) & (pos < s)
    rows, j = keep.nonzero(as_tuple=True)
    return rows, j, local[rows, j]


def _insert_owned(cache, val: torch.Tensor, writes) -> None:
    rows, j, slot = writes
    if rows.numel() == 0:
        return
    if isinstance(cache, QuantKV):
        pairs = zip((cache.data, cache.scale), quantize_kv(val))
    else:
        pairs = ((raw(cache), raw(to_cache(val, cache.dtype))),)
    for buf, v in pairs:
        s_l = buf.shape[1]
        buf.view(-1, *buf.shape[2:]).index_copy_(0, rows * s_l + slot, v[rows, j])


def _parts(c):
    """(values, scales) of a cache block: a QuantKV's int8 data and scales,
    else the values and None."""
    return (c.data, c.scale) if isinstance(c, QuantKV) else (c, None)


def _sp_table_attention(q, k, v, valid, scale: float, mesh: Mesh, scales=(None, None)):
    """ggml's table softmax (ops/layers.py ``_softmax_ref_f16``) over a
    context split across sp, on the exact f32 chain as the single-device
    parity mode.  The table rounds s - max to f16 before its exp, so each
    row needs its global max first, which a merge of streaming partials
    cannot give: the max of each rank's slots is all-reduced (MAX) over sp,
    each rank takes the table exps of its own slots, their sum is
    all-reduced, and each rank's probabilities times its V are summed over
    sp.  q [B, Tq, H, D]; k, v this rank's [B, Tk, H_kv, D] slots; valid
    [B, Tq, Tk]; scales a QuantKV block's (k, v) scales [B, Tk, H_kv]."""
    b, tq, h, d = q.shape
    g = k.shape[2]
    qg = q.float().reshape(b, tq, g, h // g, d)
    s = torch.einsum("btgrd,bsgd->bgrts", qg, k.float()) * scale
    ks, vs = scales
    if ks is not None:
        s = s * ks.permute(0, 2, 1)[:, :, None, None, :]
    valid = valid[:, None, None]
    s = s.masked_fill(~valid, float("-inf"))
    m = (s.amax(dim=-1, keepdim=True) if s.shape[-1]
         else torch.full((*s.shape[:-1], 1), float("-inf"), device=s.device))
    m = all_reduce(m, mesh, "sp", dist.ReduceOp.MAX)
    e = torch.exp((s - m).to(torch.float16).float()).to(torch.float16).float()
    e = torch.where(valid, e, torch.zeros((), device=e.device))
    probs = e / psum(e.sum(dim=-1, keepdim=True), mesh, "sp")
    if vs is not None:
        probs = probs * vs.permute(0, 2, 1)[:, :, None, None, :]
    o = torch.einsum("bgrts,bsgd->btgrd", probs, v.float()).reshape(b, tq, h, d)
    return psum(o, mesh, "sp")


def _sp_attention(q, k_cache, v_cache, pos, start, t_all: int, w: int, mesh: Mesh,
                  scale: float, low: bool, f16_table: bool = False):
    """Attention over a context split across sp: each rank over its own
    slots inside the window, the partials gathered and merged in rank
    order (the f16-table softmax: ``_sp_table_attention``)."""
    s_l = k_cache.shape[1]
    lo = axis_index(mesh, "sp") * s_l
    wl = max(0, min(w - lo, s_l))
    kv_pos = lo + torch.arange(wl, device=q.device)
    # the slots written so far, up to each query's position
    valid = ((kv_pos[None, None, :] < start[:, :, None] + t_all)
             & (kv_pos[None, None, :] <= pos[:, :, None]))
    (kd, ks), (vd, vs) = (_parts(_kv_view(c, wl)) for c in (k_cache, v_cache))
    if f16_table:
        return _sp_table_attention(q, kd, vd, valid, scale, mesh, scales=(ks, vs))
    part = _partial(q, kd, vd, valid, scale, scales=(ks, vs), rnd=bf16_f32 if low else None)
    m_all, l_all, o_all = (all_gather(x, mesh, "sp", tiled=False) for x in part)
    m, l, o = m_all[0], l_all[0], o_all[0]
    for i in range(1, m_all.shape[0]):
        m, l, o = _merge(m, l, o, m_all[i], l_all[i], o_all[i])
    return _finish(l, o)


def mesh_forward(cfg: ModelConfig, params: TransformerParams, tokens: torch.Tensor, n_past,
                 cache_k: list, cache_v: list, mesh: Mesh, *, last_only: bool = False,
                 with_embedding: bool = False, kv_window: int | None = None,
                 last_index=None, attention_fn=None, dp_rows: bool = False,
                 sp_cache: bool = False):
    """transformer.forward over a mesh: tokens [B, T] (or embeddings [B, T,
    E]), n_past and last_index as there, whole on every rank; params as
    ``prepare_tp_params`` leaves them; this rank's caches, written in place.
    dp_rows: the caches hold this dp rank's B/dp rows (else every row).
    sp_cache: they hold its sp rank's S/sp context slots (else every slot).
    Returns what transformer.forward returns, whole, on every rank."""
    tp, dp, sp = mesh.shape["tp"], mesh.shape["dp"], mesh.shape["sp"]
    if cfg.n_head % tp:
        raise ValueError(f"{cfg.n_head} heads do not split over tp={tp}")
    kv_split = kv_sharded(cfg, tp)
    h_q = cfg.n_head // tp
    h_kv = cfg.kv_heads // tp if kv_split else cfg.kv_heads
    hd = cfg.head_dim  # the global head width: n_embd over every head
    params = _local_params(params)
    dev = mesh.device
    tokens = tokens.to(dev)
    n_past = _device_int(n_past, dev).to(dev)
    per_row = n_past.dim() == 1
    if dp_rows and dp > 1:
        b_l = tokens.shape[0] // dp
        rows = slice(axis_index(mesh, "dp") * b_l, (axis_index(mesh, "dp") + 1) * b_l)
        tokens = tokens[rows]
        if per_row:
            n_past = n_past[rows]
        if last_index is not None:
            last_index = _device_int(last_index, dev)
            if last_index.dim():
                last_index = last_index.to(dev)[rows]
    b, t_all = tokens.shape[:2]
    ring = isinstance(attention_fn, RingPrefill) and mesh.shape[attention_fn.ring_axis] > 1
    if ring and cfg.act_f16_table:
        # the table softmax needs each row's global max before its exps,
        # which the ring's streaming merge cannot give: the prompt stays
        # whole on every rank and attends over the split cache in the
        # two-pass form (_sp_table_attention)
        ring, attention_fn = False, None
    if ring and not sp_cache:
        raise ValueError("a ring prefill needs a cache split over sp")
    t0, t = 0, t_all
    if ring:
        if t_all % sp:
            raise ValueError(f"{t_all} tokens do not split over sp={sp}")
        t = t_all // sp
        t0 = axis_index(mesh, "sp") * t
        tokens = tokens[:, t0:t0 + t]
    s = cache_k[0].shape[1] * (sp if sp_cache else 1)
    w = s if kv_window is None else min(kv_window, s)
    start = n_past[:, None] if per_row else n_past.reshape(1, 1)
    pos = (start + t0 + torch.arange(t, device=dev)[None, :]).expand(b, t)
    kv_mask = (torch.arange(w, device=dev)[None, :] < start + t_all).expand(b, w)
    if sp_cache:
        writes = _owned_writes(n_past, b, s, t_all, cache_k[0].shape[1], axis_index(mesh, "sp"))
        insert = _insert_owned
    elif per_row:
        writes, insert = _row_slots(n_past, s, t_all), _cache_insert_rows
    else:
        writes, insert = _insert_slots(n_past, s, t_all), _cache_insert
    scale = 1.0 / math.sqrt(hd)
    c0 = cache_k[0]
    low = ((c0.data if isinstance(c0, QuantKV) else c0).dtype != torch.float32
           and os.environ.get("ATTN_MXU", "1") != "0")

    if tokens.dim() == 3:  # raw input embeddings
        x = tokens.float()
    elif tp == 1:
        x = _embed(params, tokens)
    else:
        # the vocabulary-sharded embedding: this rank's rows, masked, summed
        emb = params.tok_embeddings
        v_l = emb.shape[0]
        local = tokens - axis_index(mesh, "tp") * v_l
        inr = (local >= 0) & (local < v_l)
        got = _embed(params, torch.where(inr, local, torch.zeros_like(local)))
        x = psum(torch.where(inr[..., None], got, torch.zeros((), device=dev)), mesh, "tp")

    for layer, blk in enumerate(params.blocks):
        h = _norm(cfg, x, blk.attn_norm_w, blk.attn_norm_b)
        if blk.wqkv is not None:  # a replicated (tp 1) fused QKV, as the loader fuses it
            q, k, v = _qkv(cfg, blk, h, b, t)
        else:
            q = _mm(h, blk.wq, cfg, blk.bq).reshape(b, t, h_q, hd)
            k = _mm(h, blk.wk, cfg, blk.bk).reshape(b, t, h_kv, hd)
            v = _mm(h, blk.wv, cfg, blk.bv).reshape(b, t, h_kv, hd)
        if cfg.n_rot > 0:
            q = rope(q, pos, cfg.n_rot, neox=cfg.rope_neox, base=cfg.rope_base)
            k = rope(k, pos, cfg.n_rot, neox=cfg.rope_neox, base=cfg.rope_base)
        if ring:
            # each block of the prompt's K/V passes every rank once, on the
            # ring: the rank writes the slots it owns of the blocks it holds
            def held(src, kb, vb, ck=cache_k[layer], cv=cache_v[layer]):
                rows, j, slot = writes
                sel = (j >= src * t) & (j < (src + 1) * t)
                got = (rows[sel], j[sel] - src * t, slot[sel])
                insert(ck, kb, got)
                insert(cv, vb, got)
                return _roundtrip(ck, kb), _roundtrip(cv, vb)

            a = ring_self_attention(q.contiguous(), k, v, mesh, scale=scale,
                                    axis=attention_fn.ring_axis, held=held)
        else:
            insert(cache_k[layer], k, writes)
            insert(cache_v[layer], v, writes)
            if attention_fn is not None:
                a = attention_fn(q.contiguous(), _roundtrip(cache_k[layer], k),
                                 _roundtrip(cache_v[layer], v), scale)
            elif sp_cache:
                a = _sp_attention(q, cache_k[layer], cache_v[layer], pos, start, t_all, w,
                                  mesh, scale, low, cfg.act_f16_table)
            else:
                a = attention(q, _kv_view(cache_k[layer], w), _kv_view(cache_v[layer], w),
                              pos, kv_mask, scale, ref_f16_softmax=cfg.act_f16_table)
        # row-parallel wo: the local heads' partial sum
        attn_out = psum(_mm(a.reshape(b, t, h_q * hd), blk.wo, cfg), mesh, "tp")
        if blk.bo is not None:
            attn_out = attn_out + blk.bo.float()

        def ffn(h_in):
            if cfg.ffn_gated and blk.w_gateup is not None:  # fused, tp 1
                gu = _mm(h_in, blk.w_gateup, cfg)
                f = gu.shape[-1] // 2
                inner = _act(cfg, gu[..., :f]) * gu[..., f:]
            elif cfg.ffn_gated:
                inner = _act(cfg, _mm(h_in, blk.w_gate, cfg)) * _mm(h_in, blk.w_up, cfg)
            else:
                inner = _act(cfg, _mm(h_in, blk.w_up, cfg, blk.b_up))
            out = psum(_mm(inner, blk.w_down, cfg), mesh, "tp")
            return out if blk.b_down is None else out + blk.b_down.float()

        if cfg.parallel_residual:
            ff_in = h if cfg.ffn_norm_shared else _norm(cfg, x, blk.ffn_norm_w, blk.ffn_norm_b)
            x = x + attn_out + ffn(ff_in)
        else:
            x = x + attn_out
            x = x + ffn(_norm(cfg, x, blk.ffn_norm_w, blk.ffn_norm_b))

    if ring:
        x = all_gather(x, mesh, "sp", dim=1)
    if last_index is not None:
        li = _device_int(last_index, dev)
        if li.dim():
            x = x.gather(1, li.reshape(b, 1, 1).expand(b, 1, x.shape[2]))
        else:
            x = x.index_select(1, li.reshape(1))
    elif last_only:
        x = x[:, -1:]
    x = _norm(cfg, x, params.out_norm_w, params.out_norm_b)
    logits = all_gather(_mm(x, params.output, cfg), mesh, "tp", dim=-1)
    if dp_rows:
        logits = all_gather(logits, mesh, "dp", dim=0)
        if with_embedding:
            x = all_gather(x, mesh, "dp", dim=0)
    if with_embedding:
        return logits, x
    return logits
