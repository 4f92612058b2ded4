"""Speculative decoding with the whole loop on the device: draft, verify,
accept.

runtime/speculative.py runs the draft-and-verify loop from the host, one
round trip a verify.  Here a round is device work only: the token history
lives in a device buffer, prompt-lookup drafting is a vectorized n-gram
match over it (``_lookup_drafts``), the verify samples every position of one
T = k+1 forward, and acceptance and rollback are masked arithmetic.  The
host sees the sampled ids once every ``n_steps`` rounds.

``spec_round`` and ``draft_round`` are the bodies of the JAX package's
``lax.scan``s (``device_spec.spec_chunk`` and ``draft_spec_chunk``).
``spec_chunk`` and ``draft_spec_chunk`` here run them eagerly, on the CPU and
as the reference of the graphs: on the card ``Context.spec_chunk`` and
``Context.draft_spec_chunk`` capture one round as one CUDA graph and replay
it ``n_steps`` times, the caches written in place (never rebound), the carry
in static tensors.  A Context over a mesh runs the eager loops, with its
``mesh_forward`` as the forward (``forward_fn``, ``draft_forward_fn``).

The history buffer of a chunk is [B, H + k + 1], H the caller's width: a
frozen row's round writes its emitted tokens at columns H..H+k, which no
lookup reads, where the JAX function writes out of range with
``mode="drop"``.

Exactness: drafts are point masses, so "sample every position, accept the
matching prefix, the first mismatch is the residual sample" is the exact
leapfrog rule (runtime/speculative.py); greedy output is token for token the
plain decode loop's.

RWKV's recurrent form (``rwkv_spec_round`` / ``rwkv_spec_chunk``, the JAX
``rwkv_spec_chunk``) verifies with one T = k+1 parallel forward that keeps
the state after every position, and rolls back by gathering the state at the
last emitted position; ``RwkvContext.spec_chunk`` replays its round as a
graph, the state written in place.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import rwkv, transformer
from .context import Context, RwkvContext, _bucket
from .device_sample import (VEC_WINDOW, DeviceSampling, _recent_push, _sample_logits,
                            first_sample, make_recent, prng_key, split_key)
from .speculative import SpecParams, SpecStats, _verify_sample
from .tokenizer import TOKEN_EOS


def _lookup_drafts(buf, m, *, k: int, max_ngram: int, min_ngram: int):
    """Vectorized prompt lookup over the rows of buf [B, H] (int64 token
    histories, valid prefix lengths m [B]): [B, k] drafts, the continuation
    of the most recent earlier occurrence of the longest suffix n-gram,
    extrapolated periodically when the match runs into the tail (the
    semantics of speculative.PromptLookupDrafter); zeros where nothing
    matches.  The JAX function's clamps are kept: the suffix's start is
    clamped to [0, H - n] (``dynamic_slice``) and the match windows and the
    drafts read at most column H - 1."""
    b, h = buf.shape
    dev = buf.device
    pos = torch.arange(h, device=dev)
    m = m[:, None]
    best_j = torch.full((b, 1), -1, dtype=torch.int64, device=dev)
    best_n = torch.ones((b, 1), dtype=torch.int64, device=dev)
    # ascending n: a longer suffix's match overrides a shorter one's
    for n in range(min_ngram, max_ngram + 1):
        start = (m - n).clamp(0, h - n)
        suffix = buf.gather(1, start + torch.arange(n, device=dev))  # [B, n]
        match = (pos <= m - n - 1) & (m > n)  # a continuation and a suffix exist
        for i in range(n):
            match &= buf.index_select(1, (pos + i).clamp(max=h - 1)) == suffix[:, i:i + 1]
        j = torch.where(match, pos, -1).amax(dim=1, keepdim=True)
        best_j = torch.where(j >= 0, j, best_j)
        best_n = torch.where(j >= 0, n, best_n)
    base = best_j + best_n
    p_len = (m - base).clamp(min=1)
    src = base + torch.arange(k, device=dev) % p_len  # the periodic tail
    drafts = buf.gather(1, src.clamp(0, h - 1))
    return torch.where(best_j >= 0, drafts, 0)


def _accept(ids, drafts, done, *, k: int, eos: int, ignore_eos: bool):
    """A verify's acceptance: a [B] accepted drafts (0..k), the bonus
    token, emit [B, k+1] (the accepted drafts, the bonus, zeros after) and
    emit_n [B] (0 for rows frozen before the round; cut before an EOS), and
    the EOS hits [B] (all False under ignore_eos)."""
    b = ids.shape[0]
    tpos = torch.arange(k + 1, device=ids.device)[None, :]
    a = torch.cumprod((ids[:, :k] == drafts).to(torch.int64), dim=1).sum(dim=1)
    bonus = ids.gather(1, a[:, None])[:, 0]
    drafts_ext = torch.cat([drafts, torch.zeros((b, 1), dtype=drafts.dtype,
                                                device=drafts.device)], dim=1)
    emit = torch.where(tpos < a[:, None], drafts_ext,
                       torch.where(tpos == a[:, None], bonus[:, None], 0))
    if ignore_eos:
        emit_n = a + 1
        hit = torch.zeros_like(done)
    else:
        hits = (emit == eos) & (tpos <= a[:, None])
        hit = hits.any(dim=1)
        emit_n = torch.where(hit, torch.argmax(hits.to(torch.int32), dim=1), a + 1)
    return a, bonus, emit, torch.where(done, 0, emit_n), hit


def pad_hist(hist, k: int):
    """hist [B, H] as a chunk's buffer [B, H + k + 1], zeros past H."""
    b, h = hist.shape
    out = torch.zeros((b, h + k + 1), dtype=torch.int64, device=hist.device)
    out[:, :h] = hist
    return out


def _verify_tokens(buf, m, *, k: int, max_ngram: int, min_ngram: int):
    """(the verify's input [B, k+1]: each row's last token and its k
    drafts, the drafts [B, k])."""
    last = buf.gather(1, (m - 1)[:, None])[:, 0]
    drafts = _lookup_drafts(buf, m, k=k, max_ngram=max_ngram, min_ngram=min_ngram)
    return torch.cat([last[:, None], drafts], dim=1), drafts


def _recent(cfg, buf, m, ds: DeviceSampling, sv):
    """The verify's recent window: the newest tokens of the history, the
    last one included (n_vocab pads); None without penalties or sv."""
    if not (ds.penalized or sv is not None):
        return None
    h = buf.shape[1]
    win = VEC_WINDOW if sv is not None else ds.repeat_last_n
    idx = m[:, None] + torch.arange(-win, 0, device=buf.device)
    return torch.where(idx >= 0, buf.gather(1, idx.clamp(0, h - 1)), cfg.n_vocab)


def _advance(hist, m, key, done, eosed, emit, emit_n, hit, *, h: int, k: int):
    """A round's carry after its acceptance: the emitted tokens written at
    the history's frontier (a frozen row writes at H.., past every column a
    lookup reads), the lengths moved on, the EOS and full rows frozen."""
    rows = torch.arange(hist.shape[0], device=hist.device)
    eosed = eosed | (hit & ~done)
    col = torch.where(done, h, m)[:, None] + torch.arange(k + 1, device=hist.device)
    hist = hist.index_put((rows[:, None], col), emit)
    m = m + emit_n
    done = done | hit | (m + k + 1 > h)  # no room for another verify
    return (hist, m, key, done, eosed), (emit, emit_n)


def _default_forward(cfg, params, toks, n_past, ck, cv, *, last_only, kv_window):
    return transformer.forward(cfg, params, toks, n_past, ck, cv, last_only=last_only,
                               kv_window=kv_window)


def spec_round(cfg, params, state, cache_k, cache_v, sv=None, *, h: int, k: int,
               ds: DeviceSampling, kv_window: int, max_ngram: int, min_ngram: int,
               eos: int, ignore_eos: bool, forward_fn=None):
    """One draft-verify round (the JAX ``spec_chunk``'s scan body).  state:
    (hist [B, H + k + 1] (pad_hist), m [B] valid lengths, key, done [B],
    eosed [B]); the caches are written in place.  forward_fn: the verify's
    forward, with transformer.forward's arguments (cfg, params, tokens,
    n_past, cache_k, cache_v, last_only=, kv_window=), as the JAX one's; e.g.
    parallel.tp.spec_forward(mesh).  Returns the next state and (emit [B,
    k+1], emit_n [B])."""
    hist, m, key, done, eosed = state
    buf = hist[:, :h]
    toks, drafts = _verify_tokens(buf, m, k=k, max_ngram=max_ngram, min_ngram=min_ngram)
    logits = (forward_fn or _default_forward)(cfg, params, toks, m - 1, cache_k, cache_v,
                                              last_only=False, kv_window=kv_window)
    key, sub = split_key(key)
    ids = _verify_sample(logits, toks, sub, ds, _recent(cfg, buf, m, ds, sv), sv,
                         base_pos=m - 1)
    _, _, emit, emit_n, hit = _accept(ids, drafts, done, k=k, eos=eos,
                                      ignore_eos=ignore_eos)
    return _advance(hist, m, key, done, eosed, emit, emit_n, hit, h=h, k=k)


@torch.no_grad()
def spec_chunk(cfg, params, hist, n_hist, cache_k, cache_v, key, done, sv=None, *, k: int,
               n_steps: int, ds: DeviceSampling, kv_window: int, max_ngram: int,
               min_ngram: int, eos: int, ignore_eos: bool, forward_fn=None):
    """n_steps draft-verify rounds, eagerly (the JAX ``spec_chunk``; on the
    card ``Context.spec_chunk`` replays the round as a graph).  hist [B, H]
    token histories (prompt and output; the last token is not yet in the KV
    cache), n_hist [B] their lengths, done [B] frozen rows.  forward_fn: the
    verify's forward (spec_round's; default transformer.forward).  Returns (hist,
    n_hist, cache_k, cache_v, key, done, eosed, emit_toks [n_steps, B, k+1],
    emit_ns [n_steps, B]); eosed tells an EOS freeze from a context-capacity
    one (after which the host may swap the context and go on)."""
    h = hist.shape[1]
    state = (pad_hist(hist, k), n_hist.to(torch.int64), key, done,
             torch.zeros_like(done))
    emits, ns = [], []
    for _ in range(n_steps):
        state, (emit, emit_n) = spec_round(
            cfg, params, state, cache_k, cache_v, sv, h=h, k=k, ds=ds, kv_window=kv_window,
            max_ngram=max_ngram, min_ngram=min_ngram, eos=eos, ignore_eos=ignore_eos,
            forward_fn=forward_fn)
        emits.append(emit)
        ns.append(emit_n)
    hist_p, m, key, done, eosed = state
    return (hist_p[:, :h], m, cache_k, cache_v, key, done, eosed, torch.stack(emits),
            torch.stack(ns))


def rwkv_spec_round(cfg, params, carry, rstate: dict, sv=None, *, h: int, k: int,
                    ds: DeviceSampling, max_ngram: int, min_ngram: int, eos: int,
                    ignore_eos: bool):
    """One round of the JAX ``rwkv_spec_chunk``'s scan: carry (hist [B, H +
    k + 1] (pad_hist), m [B], key, done [B], eosed [B]) as spec_round's;
    rstate: the RWKV state, 5 x [L, B, E], written in place.  The verify is
    the T = k+1 parallel forward with the state after every position; the
    next round's state is the one after the last emitted token (index
    emit_n - 1, so an EOS cut leaves no draft in it), and a row that emits
    nothing (frozen, or EOS first) keeps its own.  Returns the next carry
    and (emit [B, k+1], emit_n [B])."""
    hist, m, key, done, eosed = carry
    buf = hist[:, :h]
    toks, drafts = _verify_tokens(buf, m, k=k, max_ngram=max_ngram, min_ngram=min_ngram)
    logits, st_all = rwkv.forward(cfg, params, toks, rstate, all_states=True)
    key, sub = split_key(key)
    ids = _verify_sample(logits, toks, sub, ds, _recent(cfg, buf, m, ds, sv), sv,
                         base_pos=m - 1)
    _, _, emit, emit_n, hit = _accept(ids, drafts, done, k=k, eos=eos, ignore_eos=ignore_eos)
    adv = ((~done) & (emit_n > 0))[None, :, None]
    n_layer, b, _, e = st_all["num"].shape
    at = (emit_n - 1).clamp(min=0)[None, :, None, None].expand(n_layer, b, 1, e)
    for name, t in rstate.items():
        t.copy_(torch.where(adv, st_all[name].gather(2, at)[:, :, 0], t))
    return _advance(hist, m, key, done, eosed, emit, emit_n, hit, h=h, k=k)


@torch.no_grad()
def rwkv_spec_chunk(cfg, params, hist, n_hist, state: dict, key, done, sv=None, *, k: int,
                    n_steps: int, ds: DeviceSampling, max_ngram: int, min_ngram: int, eos: int,
                    ignore_eos: bool):
    """n_steps RWKV draft-verify rounds, eagerly (the JAX
    ``rwkv_spec_chunk``; on the card ``RwkvContext.spec_chunk`` replays the
    round as a graph).  state: 5 x [L, B, E], written in place; the other
    operands as spec_chunk's.  Returns (hist, n_hist, state, key, done,
    eosed, emit_toks [n_steps, B, k+1], emit_ns [n_steps, B])."""
    h = hist.shape[1]
    carry = (pad_hist(hist, k), n_hist.to(torch.int64), key, done, torch.zeros_like(done))
    emits, ns = [], []
    for _ in range(n_steps):
        carry, (emit, emit_n) = rwkv_spec_round(
            cfg, params, carry, state, sv, h=h, k=k, ds=ds, max_ngram=max_ngram,
            min_ngram=min_ngram, eos=eos, ignore_eos=ignore_eos)
        emits.append(emit)
        ns.append(emit_n)
    hist_p, m, key, done, eosed = carry
    return (hist_p[:, :h], m, state, key, done, eosed, torch.stack(emits),
            torch.stack(ns))


def generate_ondevice_spec_rwkv(ctx: RwkvContext, prompt_tokens: list[int], n_predict: int,
                                *, sampling: DeviceSampling | None = None,
                                spec: SpecParams | None = None, n_steps: int = 8,
                                seed: int = 0, eos_token: int = TOKEN_EOS,
                                ignore_eos: bool = False,
                                stats: SpecStats | None = None) -> list[int]:
    """generate_ondevice_spec for an RwkvContext: the parallel prefill, then
    chunks of n_steps draft-verify rounds over the recurrent state on the
    device, one host copy a chunk.  A recurrence has no context limit: the
    history is sized to fit the run."""
    ds = sampling or DeviceSampling(temp=-1.0)
    sp = spec or SpecParams()
    k = sp.n_draft
    stats = stats if stats is not None else SpecStats()
    dev = ctx.device

    logits = ctx.eval(np.asarray([prompt_tokens], np.int64))
    key = prng_key(seed, dev)
    key, sub = split_key(key)
    first = first_sample(logits[0, -1], list(prompt_tokens), ds, sub, ctx.cfg.n_vocab)
    if first == eos_token and not ignore_eos:
        return []
    out = [first]
    stats.n_tokens += 1

    n0 = len(prompt_tokens) + 1
    h = _bucket(min(n0 + n_predict + n_steps * (k + 1) + 2, ctx.n_ctx))
    buf = np.zeros((1, h), np.int64)
    buf[0, :n0] = list(prompt_tokens) + [first]
    hist = torch.from_numpy(buf).to(dev)
    n_hist = torch.full((1,), n0, dtype=torch.int64, device=dev)
    done = torch.zeros((1,), dtype=torch.bool, device=dev)
    start = n0
    while len(out) < n_predict and start + k + 1 <= h:
        hist, n_hist, key, done, eosed, emit_toks, emit_ns = ctx.spec_chunk(
            hist, n_hist, key, done, k=k, n_steps=n_steps, ds=ds, max_ngram=sp.max_ngram,
            min_ngram=sp.min_ngram, eos=eos_token, ignore_eos=ignore_eos)
        toks_h, ns_h, n_row, done_row, eosed_row = _host(emit_toks, emit_ns, n_hist, done,
                                                         eosed)
        start = int(n_row[0])
        ctx.n_past = start - 1
        _tally(stats, out, k, toks_h, ns_h)
        if eosed_row[0] or done_row[0]:
            break
    return out[:n_predict]


def draft_round(cfg_t, params_t, cfg_d, params_d, state, ck_t, cv_t, ck_d, cv_d, *,
                k: int, ds: DeviceSampling, kv_window: int, eos: int, ignore_eos: bool,
                cap: int | None = None, forward_fn=None, draft_forward_fn=None):
    """One draft-model round (the JAX ``draft_spec_chunk``'s scan body): k+1
    greedy T=1 steps of the draft model, then one T=k+1 verify of the
    target.  Both models insert at one shared frontier n_past.  state:
    (tok [B], n_past [B], key, done [B], recent [B, N]); every cache is
    written in place.  cap: the slots both caches hold (default their
    smaller dim 1; a cache split over sp holds a block of them).
    forward_fn, draft_forward_fn: the target's and the draft's forwards,
    with transformer.forward's arguments (default transformer.forward).
    Returns the next state and (emit, emit_n)."""
    tok, n_p, key, done, rec = state
    greedy = DeviceSampling(temp=-1.0)
    if cap is None:
        cap = min(ck_t[0].shape[1], ck_d[0].shape[1])
    fwd_t = forward_fn or transformer.forward
    fwd_d = draft_forward_fn or transformer.forward
    dtok, np_, drafts = tok, n_p, []
    for _ in range(k + 1):
        logits = fwd_d(cfg_d, params_d, dtok[:, None], np_, ck_d, cv_d,
                       last_only=True, kv_window=kv_window)
        dtok = _sample_logits(logits[:, -1], key, greedy)
        np_ = np_ + 1
        drafts.append(dtok)
    drafts = torch.stack(drafts[:k], dim=1)  # [B, k]
    toks = torch.cat([tok[:, None], drafts], dim=1)
    logits = fwd_t(cfg_t, params_t, toks, n_p, ck_t, cv_t, last_only=False,
                   kv_window=kv_window)
    key, sub = split_key(key)
    ids = _verify_sample(logits, toks, sub, ds, rec)
    a, bonus, emit, emit_n, hit = _accept(ids, drafts, done, k=k, eos=eos,
                                          ignore_eos=ignore_eos)
    if ds.penalized:
        # the round's accepted tokens join the penalty window
        for j in range(k + 1):
            rec = torch.where((j < emit_n)[:, None], _recent_push(rec, emit[:, j]), rec)
    # the next input (the bonus) goes to slot n_past + a + 1 in both models
    n_p = n_p + torch.where(done, 0, a + 1)
    tok = torch.where(done, tok, bonus)
    done = done | hit | (n_p + k + 2 > cap)  # out of cache
    return (tok, n_p, key, done, rec), (emit, emit_n)


@torch.no_grad()
def draft_spec_chunk(cfg_t, params_t, cfg_d, params_d, tok, n_past, ck_t, cv_t, ck_d, cv_d,
                     key, done, recent, *, k: int, n_steps: int, ds: DeviceSampling,
                     kv_window: int, eos: int, ignore_eos: bool, cap: int | None = None,
                     forward_fn=None, draft_forward_fn=None):
    """n_steps draft-model rounds, eagerly (the JAX ``draft_spec_chunk``;
    on the card ``Context.draft_spec_chunk`` replays the round as a graph
    over both Contexts' caches).  tok, n_past, done: [B]; recent: [B, N]
    penalty window including tok (any [B, 1] when ds has no penalties).
    The k+1st draft step makes every proposed draft resident in the draft
    cache on full acceptance (speculative.DraftModelDrafter).  cap,
    forward_fn, draft_forward_fn: draft_round's.  Returns (tok, n_past,
    ck_t, cv_t, ck_d, cv_d, key, done, recent, emit_toks [n_steps, B, k+1],
    emit_ns [n_steps, B])."""
    state = (tok, n_past.to(torch.int64), key, done, recent)
    emits, ns = [], []
    for _ in range(n_steps):
        state, (emit, emit_n) = draft_round(
            cfg_t, params_t, cfg_d, params_d, state, ck_t, cv_t, ck_d, cv_d, k=k, ds=ds,
            kv_window=kv_window, eos=eos, ignore_eos=ignore_eos, cap=cap,
            forward_fn=forward_fn, draft_forward_fn=draft_forward_fn)
        emits.append(emit)
        ns.append(emit_n)
    tok, n_past, key, done, recent = state
    return (tok, n_past, ck_t, cv_t, ck_d, cv_d, key, done, recent, torch.stack(emits),
            torch.stack(ns))


def _host(*tensors):
    """The chunk's results on the host in one copy: each [n] or [n, ...]
    int tensor as a numpy array of its own shape."""
    flat = torch.cat([t.reshape(-1).to(torch.int64) for t in tensors]).cpu().numpy()
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].reshape(t.shape))
        i += t.numel()
    return out


def _tally(stats: SpecStats, out: list, k: int, toks_h, ns_h) -> None:
    """Fold a chunk's rounds into stats and out (row 0)."""
    for s in range(len(ns_h)):
        n = int(ns_h[s, 0])
        stats.n_verify += 1
        stats.n_drafted += k
        stats.n_accepted += max(0, n - 1)
        stats.n_tokens += n
        out.extend(toks_h[s, 0, :n].tolist())


def generate_ondevice_spec_draft(ctx: Context, draft_ctx: Context, prompt_tokens: list[int],
                                 n_predict: int, *, sampling: DeviceSampling | None = None,
                                 n_draft: int = 7, n_steps: int = 8, seed: int = 0,
                                 eos_token: int = TOKEN_EOS, ignore_eos: bool = False,
                                 stats: SpecStats | None = None) -> list[int]:
    """Draft-model speculation with the whole loop on the device: prefill
    both models, then chunks of n_steps rounds (k+1 greedy draft steps, one
    target verify), one host copy a chunk.  The models share a vocabulary;
    greedy output is exact, sampling unbiased."""
    ds = sampling or DeviceSampling(temp=-1.0)
    k = n_draft
    stats = stats if stats is not None else SpecStats()
    dev = ctx.device

    logits = ctx.eval(np.asarray([prompt_tokens], np.int64))
    draft_ctx.eval(np.asarray([prompt_tokens], np.int64))
    if ctx.n_past != draft_ctx.n_past:
        raise ValueError("the target and draft contexts must start at one n_past")
    key = prng_key(seed, dev)
    key, sub = split_key(key)
    first = first_sample(logits[0, -1], list(prompt_tokens), ds, sub, ctx.cfg.n_vocab)
    if first == eos_token and not ignore_eos:
        return []
    out = [first]
    stats.n_tokens += 1

    cap = min(ctx.n_ctx, draft_ctx.n_ctx)
    tok = torch.full((1,), first, dtype=torch.int64, device=dev)
    n_past = torch.full((1,), ctx.n_past, dtype=torch.int64, device=dev)
    done = torch.zeros((1,), dtype=torch.bool, device=dev)
    recent = (make_recent([list(prompt_tokens) + [first]], ds.repeat_last_n,
                          ctx.cfg.n_vocab, device=dev)
              if ds.penalized else torch.zeros((1, 1), dtype=torch.int64, device=dev))
    n_past_h, done_h = ctx.n_past, False
    while len(out) < n_predict and not done_h:
        start = n_past_h + 1
        if start + k + 1 > cap:
            break
        window = min(_bucket(start - 1 + n_steps * (k + 1) + 1), cap)
        tok, n_past, key, done, recent, emit_toks, emit_ns = ctx.draft_spec_chunk(
            draft_ctx, tok, n_past, key, done, recent, k=k, n_steps=n_steps, ds=ds,
            kv_window=window, eos=eos_token, ignore_eos=ignore_eos)
        toks_h, ns_h, n_past_row, done_row = _host(emit_toks, emit_ns, n_past, done)
        n_past_h, done_h = int(n_past_row[0]), bool(done_row[0])
        ctx.n_past = draft_ctx.n_past = n_past_h
        _tally(stats, out, k, toks_h, ns_h)
    return out[:n_predict]


def generate_ondevice_spec(ctx: Context, prompt_tokens: list[int], n_predict: int, *,
                           sampling: DeviceSampling | None = None,
                           spec: SpecParams | None = None, n_steps: int = 8, seed: int = 0,
                           eos_token: int = TOKEN_EOS, ignore_eos: bool = False,
                           stats: SpecStats | None = None,
                           n_keep: int | None = None) -> list[int]:
    """Prefill on the Context, then decode in chunks of n_steps
    prompt-lookup draft-verify rounds on the device, one host copy a chunk.

    n_keep (not None) turns on the infinite-text context swap at the
    context's end (keep n_keep prompt tokens, feed the newest half of the
    rest again; main.cpp:366-389); None stops at the context's end."""
    ds = sampling or DeviceSampling(temp=-1.0)
    sp = spec or SpecParams()
    k = sp.n_draft
    stats = stats if stats is not None else SpecStats()
    dev = ctx.device

    logits = ctx.eval(np.asarray([prompt_tokens], np.int64))
    key = prng_key(seed, dev)
    key, sub = split_key(key)
    first = first_sample(logits[0, -1], list(prompt_tokens), ds, sub, ctx.cfg.n_vocab)
    if first == eos_token and not ignore_eos:
        return []
    out = [first]
    stats.n_tokens += 1

    h = ctx.n_ctx

    def history(tokens):
        buf = np.zeros((1, h), np.int64)
        buf[0, :len(tokens)] = tokens
        return (torch.from_numpy(buf).to(dev),
                torch.full((1,), len(tokens), dtype=torch.int64, device=dev),
                torch.zeros((1,), dtype=torch.bool, device=dev))

    hist, n_hist, done = history(list(prompt_tokens) + [first])
    start = len(prompt_tokens) + 1
    while len(out) < n_predict:
        if start + k + 1 > h:
            if n_keep is None:
                break
            # the context swap: keep n_keep prompt tokens, feed the newest
            # half of everything after them again
            keep = len(prompt_tokens) if n_keep < 0 else n_keep
            all_toks = list(prompt_tokens) + out
            refeed = list(prompt_tokens[:keep]) + all_toks[-((start - keep) // 2):]
            ctx.reset()
            ctx.eval(np.asarray([refeed[:-1]], np.int64))
            hist, n_hist, done = history(refeed)
            start = len(refeed)
        window = min(_bucket(start - 1 + n_steps * (k + 1) + 1), h)
        hist, n_hist, key, done, eosed, emit_toks, emit_ns = ctx.spec_chunk(
            hist, n_hist, key, done, k=k, n_steps=n_steps, ds=ds, kv_window=window,
            max_ngram=sp.max_ngram, min_ngram=sp.min_ngram, eos=eos_token,
            ignore_eos=ignore_eos)
        toks_h, ns_h, n_row, done_row, eosed_row = _host(emit_toks, emit_ns, n_hist, done,
                                                         eosed)
        start = int(n_row[0])
        ctx.n_past = start - 1
        _tally(stats, out, k, toks_h, ns_h)
        if eosed_row[0]:
            break
        if done_row[0] and n_keep is None:
            break  # the context's end, no swap
    return out[:n_predict]
