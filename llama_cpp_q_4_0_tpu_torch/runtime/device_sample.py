"""On-device multi-token decode: sampling on the device, k tokens a host
round trip.

The reference samples on the host every token (main.cpp:440-560): the
logits go to the host, the host picks a token, the token comes back.  Here
the whole decode-sample-feedback loop stays on the device and only the
sampled ids are copied to the host, once every ``chunk`` tokens.  On the
card ``Context.decode_chunk`` captures one decode step, with its sampling and
its carry update, as one CUDA graph and replays it ``n_steps`` times back to
back (the JAX package's ``lax.scan`` under ``jit``); ``decode_chunk`` here is
the same loop run eagerly, on the CPU and as the graph's reference.

It supports the full distribution-affecting chain: temperature / top-k /
top-p / tail-free / typical / greedy, repetition-frequency-presence
penalties (over a carried recent-token window), mirostat v1/v2 (carried
mu) and a static logit bias, with llama.cpp:1804-2090 semantics, and a
per-row form of the chain (``SamplingVec``) where each row of a batch keeps
its own settings.

Randomness: the JAX package's PRNG streams cannot be reproduced in torch.
Every draw here comes from explicit state, never from a global generator: a
key (a 0-d int64 tensor holding a 32-bit value) is carried as the JAX key
is and split one step at a time, and each candidate's uniform is an integer
hash of (stream, candidate index), turned into a Gumbel-max pick
(``_categorical``).  The integers are the same on every device, and the
draw is captured in a graph like any other op.  A ``SamplingVec`` row with
``seed >= 0`` draws from a stream that depends only on (seed, absolute
position).

Where the JAX package divides by a Python constant, XLA multiplies by the
constant's f32 reciprocal; the port does the same (``_recip``), so the two
agree bit for bit there.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from .. import resolve_device
from ..models import transformer
from ..models.config import ModelConfig

NEG_INF = float("-inf")


@dataclass(frozen=True)
class DeviceSampling:
    temp: float = 0.8
    top_k: int = 40  # 0 = off; temp <= 0 = greedy
    top_p: float = 1.0  # nucleus over the top-k candidates (1.0 = off)
    tfs_z: float = 1.0  # tail-free sampling (1.0 = off)
    typical_p: float = 1.0  # locally-typical sampling (1.0 = off)
    # repetition penalties over the last repeat_last_n tokens, identical
    # semantics to the host chain (llama.cpp:1804-1860)
    repeat_penalty: float = 1.0
    repeat_last_n: int = 64
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    # mirostat (llama.cpp:2009-2090) with carried mu state
    mirostat: int = 0  # 0 = off, 1 = mirostat v1, 2 = mirostat v2
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    # static ((token_id, bias), ...) applied before penalties (host order,
    # main.cpp:440s); bias=-inf bans a token — how --ignore-eos works
    logit_bias: tuple = ()

    @property
    def penalized(self) -> bool:
        return (self.repeat_penalty != 1.0 or self.frequency_penalty != 0.0
                or self.presence_penalty != 0.0)


def _recip(c: float) -> float:
    """The f32 reciprocal of a Python constant: x * _recip(c) is what XLA
    computes for the JAX package's x / c."""
    return float(np.float32(1.0) / np.float32(c))


_INV_LN2 = _recip(float(np.log(np.float32(2.0))))  # -logp / jnp.log(2.0)


# ------------------------------------------------------------ randomness

_M32 = 0xFFFFFFFF
_MUL = 0x45D9F3B  # below 2^27: a product with a 32-bit value stays below 2^59
_SEEDED = 0x2545F491  # the root of the (seed, position) streams


def _h32(x):
    """A 32-bit integer hash (two xor-shift-multiply rounds) of int64
    tensors or ints holding values in [0, 2^32); no product wraps, so every
    device computes the same integers."""
    x = (((x >> 16) ^ x) * _MUL) & _M32
    x = (((x >> 16) ^ x) * _MUL) & _M32
    return (x >> 16) ^ x


def _mix(stream, counter):
    """The stream of (stream, counter), both tensors or ints in [0, 2^32)."""
    return _h32(stream ^ _h32((counter + 0x9E3779B9) & _M32))


def prng_key(seed: int, device=None) -> torch.Tensor:
    """The key of ``seed`` (jax.random.key): a 0-d int64 tensor on the
    device."""
    return torch.full((), _h32(seed & _M32), dtype=torch.int64,
                      device=resolve_device(device))


def split_key(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(the carried key, a key for this step's draws), as jax.random.split."""
    return _mix(key, 0), _mix(key, 1)


def _gumbel_argmax(streams: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """argmax(vals + Gumbel noise) per row: streams [R], vals [R, K]; the
    uniform of candidate j of row r is the top 24 bits of
    _mix(streams[r], j), plus half an ulp."""
    k = vals.shape[-1]
    h = _mix(streams[:, None], torch.arange(k, device=vals.device)[None, :])
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return torch.argmax(vals - torch.log(-torch.log(u)), dim=-1)


def _categorical(key: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """jax.random.categorical(key, vals, axis=-1) with the port's draws:
    row r of vals [..., K] draws from stream _mix(key, r)."""
    rows = vals.reshape(-1, vals.shape[-1])
    streams = _mix(key, torch.arange(rows.shape[0], device=vals.device))
    return _gumbel_argmax(streams, rows).reshape(vals.shape[:-1])


# --------------------------------------------------- the scalar chain

def _apply_logit_bias(logits: torch.Tensor, ds: DeviceSampling) -> torch.Tensor:
    """logits [..., V] + static sparse bias (llama_sample_logit_bias)."""
    if not ds.logit_bias:
        return logits
    out = logits.clone()
    for tid, bias in ds.logit_bias:
        out[..., tid] += bias
    return out


def _counts(recent: torch.Tensor, v: int) -> torch.Tensor:
    """[B, V] f32 occurrences of each id in recent [B, N]; ids >= V (the
    window's pad, V) are dropped, as JAX's scatter with mode="drop": they
    are counted in an extra column that is sliced off."""
    b = recent.shape[0]
    idx = recent.clamp(max=v)
    buf = torch.zeros((b, v + 1), dtype=torch.float32, device=recent.device)
    buf.scatter_add_(1, idx, torch.ones(idx.shape, dtype=torch.float32, device=idx.device))
    return buf[:, :v]


def _apply_penalties(logits: torch.Tensor, recent: torch.Tensor,
                     ds: DeviceSampling) -> torch.Tensor:
    """logits [B, V], recent [B, N] token ids (pad slots hold V, dropped).

    llama_sample_repetition_penalty (divide positive / multiply negative
    logits of seen tokens) + frequency/presence penalties
    (llama.cpp:1804-1860)."""
    counts = _counts(recent, logits.shape[-1])
    present = counts > 0
    if ds.repeat_penalty != 1.0:
        scaled = torch.where(logits > 0, logits * _recip(ds.repeat_penalty),
                             logits * ds.repeat_penalty)
        logits = torch.where(present, scaled, logits)
    return (logits - counts * ds.frequency_penalty
            - present * ds.presence_penalty)


def _recent_push(recent: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """Shift the [B, N] recent-token window left and append tok [B]."""
    return torch.cat([recent[:, 1:], tok[:, None].to(recent.dtype)], dim=1)


def make_recent(last_tokens_rows, n: int, n_vocab: int, device=None) -> torch.Tensor:
    """Host-side: build the [B, N] recent window (pad = n_vocab), int64 on
    the device."""
    b = len(last_tokens_rows)
    out = np.full((b, n), n_vocab, np.int64)
    for i, lt in enumerate(last_tokens_rows):
        tail = lt[-n:]
        if tail:
            out[i, -len(tail):] = tail
    return torch.from_numpy(out).to(resolve_device(device))


def first_sample(logits_row, history, ds: DeviceSampling, key: torch.Tensor,
                 n_vocab: int) -> int:
    """Sample the first post-prefill token with the same penalty window
    the device loop will use (host loops penalize every sample)."""
    row = torch.as_tensor(np.asarray(logits_row, np.float32)).to(key.device)
    l = _apply_logit_bias(row[None, :], ds)
    if ds.penalized:
        rec = make_recent([history], ds.repeat_last_n, n_vocab, device=key.device)
        l = _apply_penalties(l, rec, ds)
    return int(_sample_logits(l[0], key, ds))


# ------------------------------------------------------ the per-row chain

@dataclass
class SamplingVec:
    """PER-ROW sampling parameters for batched device ticks: each row keeps
    its own request's temp/top-k/top-p/tfs/typical/penalties/mirostat/
    logit-bias.  All fields [B] tensors on the device; neutral values
    (temp<=0 greedy, top_k 0, p/z 1.0, penalties 1.0/0.0, mirostat 0)
    switch a knob off per row.  The optional fields stay None (absent, no
    work) unless some row uses them: mirostat* [B] with carried per-row mu,
    and bias_ids/bias_vals [B, NB] dense-padded per-row logit bias (pad id
    = _BIAS_PAD drops)."""

    temp: torch.Tensor
    top_k: torch.Tensor
    top_p: torch.Tensor
    tfs_z: torch.Tensor
    typical_p: torch.Tensor
    repeat_penalty: torch.Tensor
    repeat_last_n: torch.Tensor
    frequency_penalty: torch.Tensor
    presence_penalty: torch.Tensor
    seed: torch.Tensor  # [B] int64; >=0 makes the row's stream REPRODUCIBLE
    mirostat: torch.Tensor | None = None  # [B] int64 (0 off / 1 v1 / 2 v2)
    mirostat_tau: torch.Tensor | None = None  # [B] f32
    mirostat_eta: torch.Tensor | None = None  # [B] f32
    bias_ids: torch.Tensor | None = None  # [B, NB] int64 (pad = _BIAS_PAD)
    bias_vals: torch.Tensor | None = None  # [B, NB] f32

    def present(self) -> dict:
        """The fields that are set, by name."""
        return {f.name: getattr(self, f.name) for f in fields(self)
                if getattr(self, f.name) is not None}


_BIAS_PAD = 1 << 30  # out-of-vocab id: dropped by the bias scatter


def make_sampling_vec(rows, seeds=None, device=None) -> SamplingVec:
    """Host: build a SamplingVec from per-row SamplingParams (None rows
    get neutral greedy settings).  seeds[i] >= 0 gives row i a sampling
    stream that depends only on (seed, absolute position) — reproducible
    regardless of which other requests share its ticks.  Rows with
    mirostat or logit_bias populate the optional per-row fields (the bias
    width buckets to powers of two, as the JAX package's does to bound its
    recompiles; here each width is a graph key)."""
    device = resolve_device(device)

    def col(get, default, dtype=torch.float32):
        return torch.tensor([get(r) if r is not None else default for r in rows],
                            dtype=dtype).to(device)

    if seeds is None:
        seeds = [-1] * len(rows)
    mirostat = mirostat_tau = mirostat_eta = None
    if any(r is not None and r.mirostat for r in rows):
        mirostat = col(lambda r: r.mirostat, 0, torch.int64)
        mirostat_tau = col(lambda r: r.mirostat_tau, 5.0)
        mirostat_eta = col(lambda r: r.mirostat_eta, 0.1)
    bias_ids = bias_vals = None
    widest = max((len(r.logit_bias) for r in rows
                  if r is not None and r.logit_bias), default=0)
    if widest:
        nb = 1 << (widest - 1).bit_length()  # bucket to power of two
        ids = np.full((len(rows), nb), _BIAS_PAD, np.int64)
        vals = np.zeros((len(rows), nb), np.float32)
        for i, r in enumerate(rows):
            if r is not None and r.logit_bias:
                for j, (tid, bv) in enumerate(sorted(r.logit_bias.items())):
                    ids[i, j] = tid
                    vals[i, j] = bv
        bias_ids = torch.from_numpy(ids).to(device)
        bias_vals = torch.from_numpy(vals).to(device)
    return SamplingVec(
        seed=torch.tensor([s if s is not None else -1 for s in seeds],
                          dtype=torch.int64).to(device),
        temp=col(lambda r: r.temp, -1.0),
        top_k=col(lambda r: r.top_k, 0, torch.int64),
        top_p=col(lambda r: r.top_p, 1.0),
        tfs_z=col(lambda r: r.tfs_z, 1.0),
        typical_p=col(lambda r: r.typical_p, 1.0),
        repeat_penalty=col(lambda r: r.repeat_penalty, 1.0),
        repeat_last_n=col(lambda r: r.repeat_last_n, 0, torch.int64),
        frequency_penalty=col(lambda r: r.frequency_penalty, 0.0),
        presence_penalty=col(lambda r: r.presence_penalty, 0.0),
        mirostat=mirostat, mirostat_tau=mirostat_tau,
        mirostat_eta=mirostat_eta,
        bias_ids=bias_ids, bias_vals=bias_vals,
    )


_VEC_SUPPORT = 256  # top-k support for the per-row path (top_k clamped)
VEC_WINDOW = 128  # recent-token buffer length for per-row penalties


def _apply_penalties_vec(logits: torch.Tensor, recent: torch.Tensor,
                         sv: SamplingVec) -> torch.Tensor:
    """Per-row penalty application; each row's window is the newest
    repeat_last_n[row] entries of `recent` (pad index V drops)."""
    v = logits.shape[-1]
    n = recent.shape[1]
    valid = (torch.arange(n, device=recent.device)[None, :]
             >= (n - sv.repeat_last_n[:, None]))
    counts = _counts(recent.masked_fill(~valid, v), v)
    present = counts > 0
    rp = sv.repeat_penalty[:, None]
    scaled = torch.where(logits > 0, logits / rp, logits * rp)
    logits = torch.where(present, scaled, logits)
    return (logits - counts * sv.frequency_penalty[:, None]
            - present * sv.presence_penalty[:, None])


def _apply_bias_vec(logits: torch.Tensor, sv: SamplingVec) -> torch.Tensor:
    """Per-row logit bias: ids >= V (the pad) are dropped, as JAX's scatter
    with mode="drop": they land in an extra column that is sliced off."""
    b, v = logits.shape
    buf = torch.cat([logits, torch.zeros((b, 1), dtype=logits.dtype,
                                         device=logits.device)], dim=1)
    buf.scatter_add_(1, sv.bias_ids.clamp(max=v), sv.bias_vals)
    return buf[:, :v]


def _row_streams(key: torch.Tensor, sv: SamplingVec, position, b: int):
    """Each row's stream: (seed, absolute position) for rows with seed >=
    0 and a position given, else the step key's row r."""
    shared = _mix(key, torch.arange(b, device=key.device))
    if position is None:
        return shared
    position = torch.as_tensor(position, device=key.device).expand(b)
    seeded = _mix(_mix(_SEEDED, sv.seed.clamp(min=0) & _M32), position & _M32)
    return torch.where(sv.seed >= 0, seeded, shared)


def sample_logits_vec(logits: torch.Tensor, key: torch.Tensor, sv: SamplingVec,
                      recent: torch.Tensor, position=None, mu=None):
    """Per-row sampling chain over a 256-candidate support, exact host
    semantics per knob (bias -> penalties -> top_k -> tfs -> typical ->
    top_p -> temp; greedy rows take the penalized argmax; mirostat rows
    replace the truncation filters with the adaptive-surprise cut, exactly
    like the host chain's separate mirostat branch, llama.cpp:2009-2090).
    logits [B, V] -> [B] int64, or (tok, mu') when `mu` [B] is passed
    (required when sv.mirostat is set; carried across ticks per row).

    position [B] (with sv.seed >= 0): rows draw from a stream of (seed,
    absolute position) instead of the shared one — each request's sampled
    text is reproducible no matter which other requests shared its ticks."""
    if sv.bias_ids is not None:
        logits = _apply_bias_vec(logits, sv)
    logits = _apply_penalties_vec(logits, recent, sv)
    b, v = logits.shape
    k = min(v, _VEC_SUPPORT)
    vals0, idx = torch.topk(logits, k, dim=-1)  # sorted desc, pre-filter
    ar = torch.arange(k, device=logits.device)[None, :]
    tk = torch.where((sv.top_k <= 0) | (sv.top_k > k), k, sv.top_k)
    vals = vals0.masked_fill(ar >= tk[:, None], NEG_INF)
    vals = _tfs_mask(vals, sv.tfs_z[:, None], n_valid=tk)
    vals = _typical_mask(vals, sv.typical_p[:, None])
    vals = _top_p_mask(vals, sv.top_p[:, None])
    denom = torch.where(sv.temp > 0, sv.temp, 1.0)[:, None]
    final = vals / denom
    if sv.mirostat is not None:
        if mu is None:
            raise ValueError("mirostat rows need the carried mu state")
        scaled = vals0 / denom  # mirostat skips the truncation filters
        m2 = _mirostat2_mask_vec(scaled, mu)
        m1 = _mirostat1_mask_vec(scaled, mu, v)
        final = torch.where((sv.mirostat == 2)[:, None], m2,
                            torch.where((sv.mirostat == 1)[:, None], m1, final))
    choice = _gumbel_argmax(_row_streams(key, sv, position, b), final)
    sampled = idx.gather(1, choice[:, None])[:, 0]
    greedy = torch.argmax(logits, dim=-1)
    tok = torch.where(sv.temp > 0, sampled, greedy)
    if mu is None:
        return tok
    if sv.mirostat is not None:
        logp2 = torch.log_softmax(final, dim=-1)
        observed = -logp2.gather(1, choice[:, None])[:, 0] * _INV_LN2
        mu2 = mu - sv.mirostat_eta * (observed - sv.mirostat_tau)
        mu = torch.where((sv.mirostat > 0) & (sv.temp > 0), mu2, mu)
    return tok, mu


def _mirostat2_mask_vec(scaled: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Per-row mirostat-v2 truncation over temp-scaled sorted logits
    [B, K]: drop candidates with surprise > mu[row], always keep the top
    one (llama_sample_token_mirostat_v2, llama.cpp:2065-2090)."""
    surprise = -torch.log_softmax(scaled, dim=-1) * _INV_LN2
    keep = ((surprise <= mu[:, None])
            | (torch.arange(scaled.shape[-1], device=scaled.device) == 0))
    return scaled.masked_fill(~keep, NEG_INF)


def _zipf_k(p: torch.Tensor, mu: torch.Tensor, n_vocab: int, floor: float | None):
    """Mirostat v1's truncation k [B] from sorted probabilities p [B, K]:
    the Zipf exponent s_hat of the top m=100 (llama.cpp:2009-2063); floor
    bounds the ratio's divisor below (the per-row form's guard)."""
    k_sup = p.shape[-1]
    n = min(100 - 1, k_sup - 1)
    i = torch.arange(n, dtype=torch.float32, device=p.device)
    t_i = torch.log((i + 2.0) / (i + 1.0))
    div = p[:, 1:n + 1] if floor is None else p[:, 1:n + 1].clamp(min=floor)
    b_i = torch.log(p[:, :n] / div)
    s_hat = (t_i * b_i).sum(dim=-1) / (t_i * t_i).sum()
    eps_hat = s_hat - 1.0
    nv = torch.full_like(eps_hat, float(n_vocab))
    kk = ((eps_hat * torch.exp2(mu)) / (1.0 - nv ** (-eps_hat))) ** (1.0 / s_hat)
    kk = torch.nan_to_num(kk, nan=1.0, posinf=float(k_sup))
    return kk.clamp(1, k_sup).to(torch.int64)


def _mirostat1_mask_vec(scaled: torch.Tensor, mu: torch.Tensor,
                        n_vocab: int) -> torch.Tensor:
    """Per-row mirostat-v1 truncation (llama_sample_token_mirostat,
    llama.cpp:2009-2063): Zipf exponent s_hat from the top m=100
    probabilities, k from the surprise target, keep the first k."""
    kk = _zipf_k(torch.softmax(scaled, dim=-1), mu, n_vocab, 1e-38)
    ar = torch.arange(scaled.shape[-1], device=scaled.device)[None, :]
    return scaled.masked_fill(ar >= kk[:, None], NEG_INF)


def _first_true(hits: torch.Tensor) -> torch.Tensor:
    """jnp.argmax of a bool tensor along its last axis: the first True."""
    return torch.argmax(hits.to(torch.int32), dim=-1)


def _tfs_mask(vals: torch.Tensor, z, n_valid=None) -> torch.Tensor:
    """Tail-free filter over DESCENDING-sorted logits [..., K]: normalized
    |second derivative| of the sorted probability curve, cumsum'd; drop
    the tail where it exceeds z (llama_sample_tail_free,
    llama.cpp:1907-1959; min_keep=1).

    n_valid [B] (per-row path): the candidate list is only the first
    n_valid entries (rest -inf from a prior top-k cut); derivative entries
    at the truncation boundary are excluded, matching the host computing
    over the REDUCED list."""
    kk = vals.shape[-1]
    if kk <= 2:
        return vals
    dev = vals.device
    probs = torch.softmax(vals, dim=-1)
    first = probs[..., :-1] - probs[..., 1:]
    second = torch.abs(first[..., :-1] - first[..., 1:])  # [..., K-2]
    if n_valid is not None:
        second = second.masked_fill(
            torch.arange(kk - 2, device=dev)[None, :] >= (n_valid - 2)[:, None], 0.0)
    second = second / second.sum(dim=-1, keepdim=True).clamp(min=1e-20)
    cum = torch.cumsum(second, dim=-1)
    hits = (cum > z) & (torch.arange(kk - 2, device=dev) >= 1)
    last = torch.where(hits.any(dim=-1), _first_true(hits), kk)  # keep i < last
    keep = torch.arange(kk, device=dev) < last[..., None]
    return vals.masked_fill(~keep, NEG_INF)


def _typical_mask(vals: torch.Tensor, p) -> torch.Tensor:
    """Locally-typical filter [..., K]: keep the lowest-|surprise - H|
    candidates until their mass exceeds p (llama_sample_typical,
    llama.cpp:1961-2007; min_keep=1).  -inf entries (filtered upstream)
    carry infinite shift and are never re-admitted."""
    kk = vals.shape[-1]
    probs = torch.softmax(vals, dim=-1)
    pos = probs > 0
    logp = torch.log(probs.clamp(min=1e-38)).masked_fill(~pos, NEG_INF)
    ent = -torch.where(pos, probs * logp, 0.0).sum(dim=-1, keepdim=True)
    shifted = torch.abs(-logp - ent).masked_fill(~pos, float("inf"))
    order = torch.argsort(shifted, dim=-1, stable=True)
    cum = torch.cumsum(probs.gather(-1, order), dim=-1)
    hits = cum > p
    last = torch.where(hits.any(dim=-1), _first_true(hits) + 1, kk)
    inv = torch.argsort(order, dim=-1)  # rank of each candidate
    return vals.masked_fill(inv >= last[..., None], NEG_INF)


def _top_p_mask(vals: torch.Tensor, top_p) -> torch.Tensor:
    """Nucleus filter over DESCENDING-sorted logits [..., K]: keep the
    smallest prefix whose probability mass reaches top_p (always >= 1
    token) — llama_sample_top_p semantics (llama.cpp:1875-1905)."""
    probs = torch.softmax(vals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # token i stays if the mass BEFORE it is < top_p
    return vals.masked_fill(~((cum - probs) < top_p), NEG_INF)


# ------------------------------------------------ the scalar samplers

def _mirostat_pick(vals_m, idx, key, ds: DeviceSampling, mu):
    """Sample from the truncated candidates vals_m [B, K], then mu -= eta *
    (observed_surprise - tau).  Returns (tok [B], mu' [B])."""
    choice = _categorical(key, vals_m)
    tok = idx.gather(-1, choice[:, None])[:, 0]
    logp2 = torch.log_softmax(vals_m, dim=-1)
    observed = -logp2.gather(-1, choice[:, None])[:, 0] * _INV_LN2
    return tok, mu - ds.mirostat_eta * (observed - ds.mirostat_tau)


def _mirostat2_sample(logits, key, ds: DeviceSampling, mu):
    """One mirostat-v2 step over a 256-candidate support: truncate
    candidates with surprise > mu (always keeping the top one), sample,
    then mu -= eta * (observed_surprise - tau).  logits [B, V], mu [B];
    returns (tok [B], mu' [B]).  Temperature is applied first, matching
    the host chain order."""
    k = min(logits.shape[-1], 256)
    vals, idx = torch.topk(logits * _recip(max(ds.temp, 1e-6)), k, dim=-1)
    return _mirostat_pick(_mirostat2_mask_vec(vals, mu), idx, key, ds, mu)


def _mirostat1_sample(logits, key, ds: DeviceSampling, mu):
    """Mirostat v1 (llama_sample_token_mirostat, llama.cpp:2009-2063):
    estimate the Zipf exponent s_hat from the top m=100 probabilities,
    derive the truncation k from the surprise target, sample, update mu.
    logits [B, V], mu [B] -> (tok [B], mu' [B])."""
    v = logits.shape[-1]
    k_sup = min(v, 256)
    vals, idx = torch.topk(logits * _recip(max(ds.temp, 1e-6)), k_sup, dim=-1)
    kk = _zipf_k(torch.softmax(vals, dim=-1), mu, v, None)
    ar = torch.arange(k_sup, device=vals.device)[None, :]
    return _mirostat_pick(vals.masked_fill(ar >= kk[:, None], NEG_INF), idx, key, ds, mu)


def _sample_logits(logits, key, ds: DeviceSampling):
    """The scalar chain over logits [..., V] -> [...] int64."""
    if ds.temp <= 0:
        return torch.argmax(logits, dim=-1)
    filtered = ds.top_p < 1.0 or ds.tfs_z < 1.0 or ds.typical_p < 1.0
    if ds.top_k <= 0 and not filtered:
        return _categorical(key, logits * _recip(ds.temp))
    # filters without top-k use a 256-candidate support (the tail beyond
    # is negligible mass for any realistic p/z)
    k = ds.top_k if ds.top_k > 0 else min(logits.shape[-1], 256)
    vals, idx = torch.topk(logits, k, dim=-1)  # sorted descending
    # host chain order: top_k -> tfs -> typical -> top_p -> temp
    if ds.tfs_z < 1.0:
        vals = _tfs_mask(vals, ds.tfs_z)
    if ds.typical_p < 1.0:
        vals = _typical_mask(vals, ds.typical_p)
    if ds.top_p < 1.0:
        vals = _top_p_mask(vals, ds.top_p)
    choice = _categorical(key, vals * _recip(ds.temp))
    return idx.gather(-1, choice[..., None])[..., 0]


# --------------------------------------------------------- the chunk

def decode_step(cfg: ModelConfig, params, tok, n_past, cache_k, cache_v, key,
                recent, mu, *, ds: DeviceSampling, kv_window: int | None = None,
                sv: SamplingVec | None = None, forward_fn=None):
    """One step of the chunk (the JAX ``lax.scan`` body): forward tok [B]
    at n_past (0-d or [B] int64 tensor), writing the caches in place, then
    sample.  Returns the next carry (tok, n_past + 1, key, recent, mu).
    ``Context.decode_chunk`` captures exactly this in its graph."""
    fwd = forward_fn or transformer.forward
    logits = fwd(cfg, params, tok[:, None], n_past, cache_k, cache_v,
                 last_only=True, kv_window=kv_window)
    row = _apply_logit_bias(logits[:, -1], ds)
    key, sub = split_key(key)
    if sv is not None:
        # per-row sampling chain (bias/penalties/mirostat handled inside);
        # seeded rows draw from (seed, abs position)
        if sv.mirostat is not None:
            nxt, mu = sample_logits_vec(row, sub, sv, recent, position=n_past + 1, mu=mu)
        else:
            nxt = sample_logits_vec(row, sub, sv, recent, position=n_past + 1)
        recent = _recent_push(recent, nxt)
    else:
        if ds.penalized:
            row = _apply_penalties(row, recent, ds)
        if ds.mirostat == 2 and ds.temp > 0:
            nxt, mu = _mirostat2_sample(row, sub, ds, mu)
        elif ds.mirostat == 1 and ds.temp > 0:
            nxt, mu = _mirostat1_sample(row, sub, ds, mu)
        else:
            nxt = _sample_logits(row, sub, ds)
        if ds.penalized:
            recent = _recent_push(recent, nxt)
    return nxt, n_past + 1, key, recent, mu


def chunk_carry(tok, n_past, key, recent, mu, ds: DeviceSampling, sv=None):
    """decode_chunk's inputs as the carry's tensors on tok's device: n_past
    an int64 tensor (0-d or [B]), the unused recent window [B, 1] and mu
    2 * tau where none is given.  Raises when penalties need a window."""
    if (ds.penalized or sv is not None) and recent is None:
        raise ValueError("ds has penalties: pass `recent` (make_recent)")
    dev, b = tok.device, tok.shape[0]
    n_past = torch.as_tensor(n_past, dtype=torch.int64).to(dev)
    if recent is None:
        recent = torch.zeros((b, 1), dtype=torch.int64, device=dev)  # unused
    if mu is None:
        mu = torch.full((b,), 2.0 * ds.mirostat_tau, dtype=torch.float32, device=dev)
    return tok.to(torch.int64), n_past, key, recent.to(torch.int64), mu


@torch.no_grad()
def decode_chunk(cfg: ModelConfig, params, tok, n_past, cache_k, cache_v,
                 key, *, n_steps: int, ds: DeviceSampling,
                 kv_window: int | None = None, recent=None, mu=None,
                 sv: SamplingVec | None = None, forward_fn=None):
    """From last token [B] and caches, generate n_steps tokens on the
    device, eagerly: the loop ``Context.decode_chunk`` replays as a graph on
    the card, and that graph's reference.  The caches are written in place
    (and returned, as the JAX function returns its donated ones).

    n_past: an int, a 0-d or a [B] int64 tensor (each row at its own
    position).  recent [B, N] (required when ds.penalized or sv is given):
    sliding window of the last tokens INCLUDING tok, carried so penalties
    see within-chunk samples exactly like the host loop.  mu [B]
    (mirostat): carried adaptive state (init 2*tau).  forward_fn:
    alternative forward with transformer.forward's contract.

    Returns (tokens [B, n_steps], cache_k, cache_v, key, recent, mu)."""
    tok, n_past, key, recent, mu = chunk_carry(tok, n_past, key, recent, mu, ds, sv)
    toks = []
    for _ in range(n_steps):
        tok, n_past, key, recent, mu = decode_step(
            cfg, params, tok, n_past, cache_k, cache_v, key, recent, mu, ds=ds,
            kv_window=kv_window, sv=sv, forward_fn=forward_fn)
        toks.append(tok)
    return torch.stack(toks, dim=1), cache_k, cache_v, key, recent, mu


def generate_ondevice(ctx, prompt_tokens: list[int], n_predict: int, *,
                      sampling: DeviceSampling | None = None, seed: int = 0,
                      chunk: int = 16, eos_token: int = 2) -> list[int]:
    """Prefill on the Context, then decode in device-resident chunks
    (``Context.decode_chunk``).

    EOS is detected between chunks (up to chunk-1 wasted steps — the price
    of amortizing the host round-trip)."""
    from .context import _bucket  # context imports this module

    ds = sampling or DeviceSampling()
    dev = ctx.device
    logits = ctx.eval(np.asarray([prompt_tokens], np.int64))
    key = prng_key(seed, dev)
    key, sub = split_key(key)
    first = first_sample(logits[0, -1], list(prompt_tokens), ds, sub,
                         ctx.cfg.n_vocab)
    out = [first]
    if first == eos_token:
        return []
    tok = torch.full((1,), first, dtype=torch.int64, device=dev)
    recent = (make_recent([list(prompt_tokens) + [first]], ds.repeat_last_n,
                          ctx.cfg.n_vocab, device=dev)
              if ds.penalized else torch.zeros((1, 1), dtype=torch.int64, device=dev))
    mu = torch.full((1,), 2.0 * ds.mirostat_tau, dtype=torch.float32, device=dev)
    while len(out) < n_predict and ctx.n_past + chunk < ctx.n_ctx:
        # always run a FULL chunk (truncate at the end): a partial n_steps
        # is another graph
        n = chunk
        window = min(_bucket(ctx.n_past + n + 1), ctx.n_ctx)
        toks, key, recent, mu = ctx.decode_chunk(
            tok, ctx.n_past, key, n_steps=n, ds=ds, kv_window=window,
            recent=recent, mu=mu)
        ctx.n_past += n
        ids = toks[0].tolist()
        for j, t in enumerate(ids):
            if t == eos_token:
                # rewind past the post-EOS garbage the full chunk wrote, so
                # callers continuing from ctx decode against clean history
                # ending at the last emitted token's cache slot
                ctx.n_past -= n - j - 1
                return out
            out.append(t)
        tok = torch.full((1,), ids[-1], dtype=torch.int64, device=dev)
    return out[:n_predict]

