"""Ring attention over the sequence-parallel mesh axis.

The reference caps the context at one device's n_ctx.  Sharding the token
axis over the ``sp`` ranks keeps each rank's K/V block local and passes the
blocks round the ring while each rank accumulates its queries' attention in
the streaming-softmax (flash) form, so the context a prefill can hold grows
with the ranks.  The JAX package's ``parallel/ring_attention.py`` (an einsum
under shard_map, not a Pallas kernel); here plain torch, one rank a process.

Each rank passes its own blocks: q, k, v [B, T/sp, H(, H_kv), D], the
tokens [r*T/sp, (r+1)*T/sp) of the whole sequence on sp rank r, and gets its
block of the output.  sp - 1 ``ppermute`` hops of one packed K/V block each:
a hop is issued before the scores of the block held, so that the transfer
runs beside them (the JAX scan issues one more, whose block it drops).
"""

from __future__ import annotations

import functools
import math

import torch

from .mesh import Mesh, axis_index, ppermute

NEG_INF = -1e30


def _partial(q, k, v, valid, scale, *, scales=(None, None), rnd=None):
    """The streaming-softmax partial of q [B, Tq, H, D] over one block of
    keys k, v [B, Tk, H_kv, D] where valid ([B | 1, Tq, Tk]) holds: grouped
    query heads contracted against their KV head without repeating the
    cache, masked scores at NEG_INF and their probabilities at 0 (so a fully
    masked row adds nothing).  scales: a QuantKV block's (k, v) scales [B,
    Tk, H_kv], on the scores and on the probabilities; rnd rounds the
    product operands (the bf16 MXU path of a low-precision cache).  Returns
    (m [B, H, Tq] the block max, l the exp-sums, o [B, Tq, H, D] the
    weighted V sum)."""
    b, tq, h, d = q.shape
    g = k.shape[2]
    rep = h // g
    if k.shape[1] == 0:
        return (torch.full((b, h, tq), NEG_INF, device=q.device),
                torch.zeros((b, h, tq), device=q.device),
                torch.zeros((b, tq, h, d), device=q.device))
    rnd = rnd or (lambda a: a)
    ks, vs = scales
    qg = rnd(q.float()).reshape(b, tq, g, rep, d)
    s = torch.einsum("btgrd,bsgd->bgrts", qg, rnd(k.float())) * scale
    if ks is not None:
        s = s * ks.permute(0, 2, 1)[:, :, None, None, :]
    valid = valid[:, None, None]
    s = torch.where(valid, s, torch.full((), NEG_INF, device=s.device))
    m = s.amax(dim=-1)
    p = torch.where(valid, torch.exp(s - m[..., None]), torch.zeros((), device=s.device))
    l = p.sum(dim=-1)
    if vs is not None:
        p = p * vs.permute(0, 2, 1)[:, :, None, None, :]
    o = torch.einsum("bgrts,bsgd->btgrd", rnd(p), rnd(v.float())).reshape(b, tq, h, d)
    return m.reshape(b, h, tq), l.reshape(b, h, tq), o


def _block_attend(q, k, v, q_pos, k_pos, scale):
    """One K/V block's causal streaming-softmax partial; positions are
    global token indices (q_pos [Tq], k_pos [Tk])."""
    return _partial(q, k, v, (q_pos[:, None] >= k_pos[None, :])[None], scale)


def _merge(m1, l1, o1, m2, l2, o2):
    """Two streaming-softmax partials as one (the flash-attention merge)."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    l = l1 * a1 + l2 * a2
    o = o1 * a1.transpose(1, 2)[..., None] + o2 * a2.transpose(1, 2)[..., None]
    return m, l, o


def _finish(l, o):
    """The output of merged partials: o / l, with l >= 1e-30 so that a fully
    masked row stays finite."""
    return o / l.clamp(min=1e-30).transpose(1, 2)[..., None]


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh, *,
                        scale: float | None = None, axis: str = "sp",
                        held=None) -> torch.Tensor:
    """Causal self-attention of this rank's block of the sequence over the
    whole sequence, the K/V blocks passed round the ring of ``axis``.
    Numerically the attention of the gathered sequence (ops/layers.py
    attention), f32 [B, T/sp, H, D].  held(src, k, v) -> (k, v), when given,
    sees every block this rank holds (its own first; src the sp rank it came
    from) before the block's scores and returns the operands to score: the
    sharded prefill writes the cache slots it owns there and scores the
    block as its cache rounds it, so the ring is the only transport of the
    prompt's K/V."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    sp = mesh.shape[axis]
    idx = axis_index(mesh, axis)
    b, tl, h, d = q.shape
    dev = q.device
    ar = torch.arange(tl, device=dev)
    q_pos = idx * tl + ar
    m = torch.full((b, h, tl), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, tl), dtype=torch.float32, device=dev)
    o = torch.zeros((b, tl, h, d), dtype=torch.float32, device=dev)
    kv = torch.stack([k.float(), v.float()])
    perm = [(s, (s + 1) % sp) for s in range(sp)]
    for i in range(sp):
        # the block held at step i came from rank (idx - i) mod sp
        src = (idx - i) % sp
        hop = ppermute(kv, mesh, axis, perm, async_op=True) if i < sp - 1 else None
        kb, vb = held(src, kv[0], kv[1]) if held is not None else (kv[0], kv[1])
        mb, lb, ob = _block_attend(q, kb, vb, q_pos, src * tl + ar, scale)
        m, l, o = _merge(m, l, o, mb, lb, ob)
        if hop is not None:
            kv = hop.wait()
    return _finish(l, o)


class RingPrefill:
    """``models.transformer.forward``'s attention_fn for a whole-prompt
    prefill (n_past == 0) over the sp ring: ``parallel/tp.py`` splits the
    prompt's tokens over ``axis`` when it is handed one."""

    __name__ = "ring_prefill"

    def __init__(self, mesh: Mesh, axis: str):
        self.mesh, self.ring_axis = mesh, axis

    def __call__(self, q, k, v, scale):
        return ring_self_attention(q, k, v, self.mesh, scale=scale, axis=self.ring_axis)


@functools.lru_cache(maxsize=8)
def ring_prefill_fn(mesh: Mesh, axis: str = "sp") -> RingPrefill:
    """The attention_fn of an sp-ring prefill, one object a mesh (the JAX
    one is cached for the same reason: a stable static argument)."""
    return RingPrefill(mesh, axis)
