"""RWKV v4: the recurrent runtime, no attention and no KV cache.

The JAX package's ``models/rwkv.py``.  A layer step is a function of (state,
token embedding); the prompt runs either token by token (``_token_step`` in
a loop, the JAX ``lax.scan``) or all at once (``_layer_parallel``: the seven
matmuls of a layer over every position, and the stable-WKV recurrence as two
associative scans).  Nothing in the forward reads a value on the host, so
``runtime/context.py`` captures it in a CUDA graph and replays it.

Per-layer recurrent state, 5 x [L, B, E] f32 (rwkv.cpp's state layout):
  ff_prev   channel mix x_{t-1} (ln2 of the previous token)
  attn_prev time mix x_{t-1} (ln1 of the previous token)
  num, den  the WKV numerator and denominator
  maxv      the running max of the stable WKV (starts at -1e30)

time_decay in the file is already -exp(decay).  x is halved after every
``rescale_every`` layers (the converter divides the FFN output weights to
match).

Every matmul takes ``q_matmul``'s default bf16 arithmetic whatever
``cfg.compute_dtype`` says, as the JAX forward calls it; the compute dtype
only picks the dtype a dense 2-D weight loads in (models/loading.py).
``associative_scan`` is JAX's own recursion (``jax.lax.associative_scan``:
pairs reduced, the half scanned, the evens filled in, interleaved), so each
position is bracketed as XLA brackets it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from .. import resolve_device
from ..ops.layers import layer_norm
from ..ops.qmatmul import q_matmul
from ..ops.qtensor import QTensor
from .config import ModelConfig

Param = Any  # QTensor | torch.Tensor | None
STATE_KEYS = ("ff_prev", "attn_prev", "num", "den", "maxv")


@dataclass
class RwkvLayer:
    ln1_g: Param = None
    ln1_b: Param = None
    ln2_g: Param = None
    ln2_b: Param = None
    att_time_mix_k: Param = None
    att_time_mix_v: Param = None
    att_time_mix_r: Param = None
    att_time_first: Param = None
    att_time_decay: Param = None
    att_key: Param = None
    att_value: Param = None
    att_receptance: Param = None
    att_output: Param = None
    ff_time_mix_k: Param = None
    ff_time_mix_r: Param = None
    ff_key: Param = None
    ff_receptance: Param = None
    ff_value: Param = None


@dataclass
class RwkvParams:
    wte: Param
    ln_pre_g: Param
    ln_pre_b: Param
    layers: tuple
    ln_out_g: Param
    ln_out_b: Param
    head: Param


def init_state(cfg: ModelConfig, batch: int = 1, device=None) -> dict:
    """5 x [L, B, E] f32, maxv at -1e30; device defaults to cuda."""
    dev = resolve_device(device)
    shape = (cfg.n_layer, batch, cfg.n_embd)
    state = {k: torch.zeros(shape, dtype=torch.float32, device=dev) for k in STATE_KEYS}
    state["maxv"].fill_(-1e30)
    return state


def _mm(x, w):
    return q_matmul(x, w)


def _mix(cur, prev, mix):
    return cur * mix + prev * (1.0 - mix)


def _channel_mix(lay: RwkvLayer, cur, prev):
    r = torch.sigmoid(_mm(_mix(cur, prev, lay.ff_time_mix_r), lay.ff_receptance))
    kk = torch.square(torch.relu(_mm(_mix(cur, prev, lay.ff_time_mix_k), lay.ff_key)))
    return r * _mm(kk, lay.ff_value)


def wkv_step(lay: RwkvLayer, k, v, st: dict):
    """The stable WKV of one token: its output from the state before it
    (time_first added to k), and the state after it (num, den, maxv)."""
    num, den, maxv = st["num"], st["den"], st["maxv"]
    ktf = lay.att_time_first + k
    p = torch.maximum(maxv, ktf)
    e1 = torch.exp(maxv - p)
    e2 = torch.exp(ktf - p)
    wkv = (e1 * num + e2 * v) / (e1 * den + e2)

    msd = maxv + lay.att_time_decay
    new_p = torch.maximum(msd, k)
    e1 = torch.exp(msd - new_p)
    e2 = torch.exp(k - new_p)
    return wkv, {"num": e1 * num + e2 * v, "den": e1 * den + e2, "maxv": new_p}


def _layer_step(cfg: ModelConfig, lay: RwkvLayer, st: dict, x):
    """One layer, one token.  x: [B, E]; st: dict of [B, E].  Returns (x, st)."""
    cur = layer_norm(x, lay.ln1_g, lay.ln1_b, cfg.norm_eps)
    xp = st["attn_prev"]
    r = torch.sigmoid(_mm(_mix(cur, xp, lay.att_time_mix_r), lay.att_receptance))
    k = _mm(_mix(cur, xp, lay.att_time_mix_k), lay.att_key)
    v = _mm(_mix(cur, xp, lay.att_time_mix_v), lay.att_value)

    wkv, wst = wkv_step(lay, k, v, st)
    x = x + _mm(r * wkv, lay.att_output)

    ln2 = layer_norm(x, lay.ln2_g, lay.ln2_b, cfg.norm_eps)
    x = x + _channel_mix(lay, ln2, st["ff_prev"])
    return x, {"ff_prev": ln2, "attn_prev": cur, **wst}


def _shift1(seq, init):
    """[B, T, E] -> the previous step's values: [init, seq[0], ..., seq[T-2]]."""
    return torch.cat([init[:, None], seq[:, :-1]], dim=1)


def _interleave(a, b):
    """a[0], b[0], a[1], b[1], ... along dim 1 (a one longer than b or as long)."""
    nb = b.shape[1]
    out = torch.stack([a[:, :nb], b], dim=2).reshape(a.shape[0], 2 * nb, *a.shape[2:])
    if a.shape[1] > nb:
        out = torch.cat([out, a[:, nb:]], dim=1)
    return out


def associative_scan(fn, elems: list) -> list:
    """The inclusive scan of fn over dim 1 of each tensor of elems, by
    ``jax.lax.associative_scan``'s recursion: log2(T) levels, each a few
    ops over whole tensors."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = fn([e[:, 0:n - 1:2] for e in elems], [e[:, 1::2] for e in elems])
    odd = associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn([e[:, :-1] for e in odd], [e[:, 2::2] for e in elems])
    else:
        even = fn(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(a, b) for a, b in zip(even, odd)]


def _max_combine(l, r):
    """f(m) = max(m + a, b) composed: (a1, b1) then (a2, b2)."""
    (a1, b1), (a2, b2) = l, r
    return [a1 + a2, torch.maximum(b1 + a2, b2)]


def _lin_combine(l, r):
    """y = a y' + b composed: (a1, b1) then (a2, b2)."""
    (a1, b1), (a2, b2) = l, r
    return [a1 * a2, a2 * b1 + b2]


def _linrec_scan(alpha, beta):
    """The composed prefix maps (A_t, B_t) of y_t = alpha_t y_{t-1} + beta_t
    over dim 1: y_t = A_t y_0 + B_t."""
    return associative_scan(_lin_combine, [alpha, beta])


def wkv_scan(lay: RwkvLayer, k, v, st: dict, valid=None):
    """The stable WKV of every position at once, k, v: [B, T, E]: each
    position's output from the state before it, the running max after each
    position (m_full, [B, T, E]) and num | den after each (y_full, [B, T,
    2E]).  The running max m_t = max(m_{t-1} + w, k_t) is a (max, +) scan;
    num and den are linear recurrences in the max-shifted frame.  A padded
    step (valid False) is the identity of each scan, (0, -inf) and (1, 0),
    so the state after it is the one before."""
    b, t, e = k.shape
    w = lay.att_time_decay
    pad = None if valid is None else ~valid[:, :, None]
    a_el = w.expand(b, t, e)
    b_el = k
    if pad is not None:
        a_el = torch.where(pad, 0.0, a_el)
        b_el = torch.where(pad, float("-inf"), b_el)
    am, bm = associative_scan(_max_combine, [a_el, b_el])
    m0 = st["maxv"]
    m_full = torch.maximum(m0[:, None] + am, bm)
    m_prev = _shift1(m_full, m0)

    alpha = torch.exp(m_prev + w - m_full)
    beta_s = torch.exp(k - m_full)
    if pad is not None:
        alpha = torch.where(pad, 1.0, alpha)
        beta_s = torch.where(pad, 0.0, beta_s)
    aa, bb = _linrec_scan(torch.cat([alpha, alpha], dim=-1),
                          torch.cat([beta_s * v, beta_s], dim=-1))
    y0 = torch.cat([st["num"], st["den"]], dim=-1)
    y_full = aa * y0[:, None] + bb
    y_prev = _shift1(y_full, y0)
    n_prev, d_prev = y_prev[..., :e], y_prev[..., e:]

    ktf = lay.att_time_first + k
    p = torch.maximum(m_prev, ktf)
    e1 = torch.exp(m_prev - p)
    e2 = torch.exp(ktf - p)
    return (e1 * n_prev + e2 * v) / (e1 * d_prev + e2), m_full, y_full


def _layer_parallel(cfg: ModelConfig, lay: RwkvLayer, st: dict, x, valid,
                    all_states: bool = False):
    """One layer over every position.  x: [B, T, E]; st: dict of [B, E];
    valid: [B, T] bool, a trailing-padding prefix mask, or None.  The seven
    matmuls take every position at once, the WKV runs as ``wkv_scan``; the
    carried num, den and max are the last valid position's, and ln1 / ln2
    are gathered there.  all_states: the state after every position, [B, T,
    E] each.  Returns (x [B, T, E], state)."""
    b, t, e = x.shape
    cur = layer_norm(x, lay.ln1_g, lay.ln1_b, cfg.norm_eps)
    xp = _shift1(cur, st["attn_prev"])
    r = torch.sigmoid(_mm(_mix(cur, xp, lay.att_time_mix_r), lay.att_receptance))
    k = _mm(_mix(cur, xp, lay.att_time_mix_k), lay.att_key)
    v = _mm(_mix(cur, xp, lay.att_time_mix_v), lay.att_value)

    wkv, m_full, y_full = wkv_scan(lay, k, v, st, valid)
    x = x + _mm(r * wkv, lay.att_output)

    ln2 = layer_norm(x, lay.ln2_g, lay.ln2_b, cfg.norm_eps)
    x = x + _channel_mix(lay, ln2, _shift1(ln2, st["ff_prev"]))

    if all_states:
        return x, {"ff_prev": ln2, "attn_prev": cur, "num": y_full[..., :e],
                   "den": y_full[..., e:], "maxv": m_full}
    if valid is None:
        last = torch.full((b,), t - 1, dtype=torch.int64, device=x.device)
        any_valid = torch.ones((b, 1), dtype=torch.bool, device=x.device)
    else:
        last = (valid.sum(dim=1) - 1).clamp(min=0)
        any_valid = valid.any(dim=1)[:, None]
    gi = last[:, None, None].expand(b, 1, e)

    def at_last(seq, init):
        return torch.where(any_valid, seq.gather(1, gi)[:, 0], init)

    return x, {"ff_prev": at_last(ln2, st["ff_prev"]), "attn_prev": at_last(cur, st["attn_prev"]),
               "num": y_full[:, -1, :e], "den": y_full[:, -1, e:], "maxv": m_full[:, -1]}


def _token_step(cfg: ModelConfig, params: RwkvParams, state: dict, emb):
    """Every layer for one token.  emb: [B, E], embedded and pre-normed."""
    x = emb
    new = {k: [] for k in STATE_KEYS}
    for i, lay in enumerate(params.layers):
        x, st = _layer_step(cfg, lay, {k: state[k][i] for k in STATE_KEYS}, x)
        for k in STATE_KEYS:
            new[k].append(st[k])
        if cfg.rescale_every > 0 and (i + 1) % cfg.rescale_every == 0:
            x = x * 0.5
    return x, {k: torch.stack(v) for k, v in new.items()}


def forward(cfg: ModelConfig, params: RwkvParams, tokens, state: dict, *,
            last_only: bool = False, valid=None, parallel: bool | None = None,
            all_states: bool = False):
    """The prompt through the recurrence.  tokens [B, T] int64 on the
    device; state: 5 x [L, B, E], not written (the new state is returned).

    valid [B, T] bool: padded steps carry the state through untouched, so a
    bucket-padded prompt leaves the state of its real tokens (the parallel
    path needs a trailing-padding mask).  parallel: the associative-scan
    prefill, one weight pass a layer for every position; default for
    T >= 8.  all_states (parallel, no valid): the state after every position,
    5 x [L, B, T, E], from which speculative decoding gathers the accepted
    prefix's.  Returns (logits [B, T|1, V] f32, new state)."""
    b, t = tokens.shape
    if all_states:
        if valid is not None or t < 2:
            raise ValueError("all_states takes T >= 2 tokens and no valid mask")
        parallel = True
    if parallel is None:
        parallel = t >= 8
    if isinstance(params.wte, QTensor):
        emb = params.wte.rows(tokens)
    else:
        emb = params.wte[tokens].float()
    emb = layer_norm(emb, params.ln_pre_g, params.ln_pre_b, cfg.norm_eps)

    if parallel and t > 1:
        x = emb
        new = {k: [] for k in STATE_KEYS}
        for i, lay in enumerate(params.layers):
            x, st = _layer_parallel(cfg, lay, {k: state[k][i] for k in STATE_KEYS}, x,
                                    valid, all_states)
            for k in STATE_KEYS:
                new[k].append(st[k])
            if cfg.rescale_every > 0 and (i + 1) % cfg.rescale_every == 0:
                x = x * 0.5
        state = {k: torch.stack(v) for k, v in new.items()}
        if last_only:
            if valid is None:
                x = x[:, -1:]
            else:  # each row's last valid position (padded outputs are garbage)
                last = (valid.sum(dim=1) - 1).clamp(min=0)
                x = x.gather(1, last[:, None, None].expand(b, 1, x.shape[-1]))
        x = layer_norm(x, params.ln_out_g, params.ln_out_b, cfg.norm_eps)
        return q_matmul(x, params.head), state

    xs = []
    for i in range(t):
        x, new = _token_step(cfg, params, state, emb[:, i])
        if valid is not None:
            keep = valid[:, i][None, :, None]
            new = {k: torch.where(keep, new[k], state[k]) for k in STATE_KEYS}
        state = new
        xs.append(x)
    xs = torch.stack(xs, dim=1)
    if last_only:
        xs = xs[:, -1:]
    xs = layer_norm(xs, params.ln_out_g, params.ln_out_b, cfg.norm_eps)
    return q_matmul(xs, params.head), state
