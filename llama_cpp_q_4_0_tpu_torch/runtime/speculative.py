"""Speculative decoding: draft k tokens cheaply, verify them in one forward.

The reference decodes one token per eval (main.cpp:414-431).  A verify
forward of T = k+1 rows streams the same 4-bit weights as a decode step, so
every accepted draft is a token that did not pay its own weight pass; on the
card each matmul of the verify runs K2 at b = k+1 (K7 in the int8
configuration) and, under ``FUSED_ATTN=1``, attention runs K4 at T = k+1.

Two draft sources, as the JAX package's ``runtime/speculative.py``:

- ``PromptLookupDrafter``: the continuation of the most recent earlier
  occurrence of the history's suffix n-gram (prompt-lookup decoding); free,
  on the host, no extra model.
- ``DraftModelDrafter``: a small model of the same vocabulary drafts greedily
  through one on-device chunk (``Context.decode_chunk``), kept in step with
  the target by moving its n_past back.

Acceptance is exact.  Drafts are point masses, so "sample every position,
accept the prefix where the samples equal the drafts, and the sample at the
first mismatch is the residual sample" is the leapfrog rule: greedy output
is token for token the plain decode loop's, and sampling is unbiased.
Rollback costs nothing: cache slot i is visible only when i < n_past + t
(the forward's kv mask), so slots of rejected drafts are written again by
the next verify.

The verify is a ``Context`` step (``Context.verify``): on the card one CUDA
graph per key (T, kv_window, the sampling), replayed with the tokens, n_past,
key and recent window as static inputs, the caches written in place; the
[B, T] ids are its only copy to the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models import transformer
from .context import Context, _bucket
from .device_sample import (DeviceSampling, _apply_logit_bias, _apply_penalties, _mix,
                            _recent_push, _sample_logits, first_sample, make_recent,
                            prng_key, sample_logits_vec, split_key)
from .tokenizer import TOKEN_EOS


@dataclass(frozen=True)
class SpecParams:
    n_draft: int = 7  # drafts per verify (verify width = n_draft + 1)
    max_ngram: int = 3  # prompt lookup: the longest suffix n-gram to match
    min_ngram: int = 1


# --------------------------------------------------------------- drafters

class PromptLookupDrafter:
    """Draft the continuation of the most recent earlier occurrence of the
    current suffix n-gram (prompt-lookup decoding; no draft model)."""

    def __init__(self, spec: SpecParams | None = None):
        self.spec = spec or SpecParams()

    def prefill(self, tokens: list[int]) -> None:
        pass

    def draft(self, history: list[int], k: int) -> list[int]:
        h = history
        n_h = len(h)
        for n in range(min(self.spec.max_ngram, n_h - 1), self.spec.min_ngram - 1, -1):
            suffix = h[-n:]
            # the most recent earlier occurrence wins
            for j in range(n_h - n - 1, -1, -1):
                if h[j:j + n] == suffix:
                    cont = h[j + n:j + n + k]
                    if cont and len(cont) < k:
                        # the match ran into the history's tail: the text
                        # loops with period len(cont), so the cycle is
                        # extrapolated (a wrong guess costs nothing, the
                        # verify forward is paid for already)
                        cont = (cont * (k // len(cont) + 1))[:k]
                    if cont:
                        return cont
                    break
        return []

    def commit(self, n_accepted: int, bonus: int) -> None:
        pass


class DraftModelDrafter:
    """A small model of the same vocabulary drafts greedily; its KV cache
    follows the target's accepted history by moving n_past back."""

    def __init__(self, ctx: Context):
        self.ctx = ctx
        # tokens past the draft cache's frontier; the last is the next input
        self._pending: list[int] = []
        self._did_draft = False
        self._draft_base = 0

    def prefill(self, tokens: list[int]) -> None:
        self.ctx.reset()
        if len(tokens) > 1:
            self.ctx.eval(np.asarray([tokens[:-1]], np.int64))
        self._pending = [tokens[-1]]
        self._did_draft = False

    def draft(self, history: list[int], k: int) -> list[int]:
        ctx = self.ctx
        self._did_draft = False
        if ctx.n_past + len(self._pending) + k + 2 >= ctx.n_ctx:
            return []
        if len(self._pending) > 1:
            # catch up the tokens of rounds that drafted nothing
            ctx.eval(np.asarray([self._pending[:-1]], np.int64))
            self._pending = self._pending[-1:]
        # k+1 steps feed [last, d_1..d_k] into slots n_past..n_past+k, so
        # that every proposed draft is in the draft cache on full acceptance;
        # d_{k+1} is dropped
        window = min(_bucket(ctx.n_past + k + 2), ctx.n_ctx)
        last = torch.full((1,), self._pending[-1], dtype=torch.int64, device=ctx.device)
        toks, _, _, _ = ctx.decode_chunk(last, ctx.n_past, prng_key(0, ctx.device),
                                         n_steps=k + 1, ds=DeviceSampling(temp=-1.0),
                                         kv_window=window)
        self._draft_base = ctx.n_past  # the position of `last`
        self._did_draft = True
        ctx.n_past += k + 1
        return toks[0, :k].tolist()

    def commit(self, n_accepted: int, bonus: int) -> None:
        if not self._did_draft:
            # the frontier did not move; the round's bonus token joins the
            # catch-up queue as the next input
            self._pending.append(bonus)
            return
        # the accepted prefix sits at slots base..base+n_accepted; the bonus
        # token is the next input, at slot base+n_accepted+1
        self.ctx.n_past = self._draft_base + n_accepted + 1
        self._pending = [bonus]
        self._did_draft = False


# ----------------------------------------------------------- verify step

def _verify_sample(logits, toks, sub, ds: DeviceSampling, rec, sv=None, base_pos=None):
    """Sample every verify position of logits [B, T, V] (toks [B, T] the
    verified input) -> [B, T] int64.  With penalties (or a per-row
    SamplingVec sv), position j's recent window is rec pushed with the
    drafts before it: the plain loop's sequential window on the accepted
    prefix (samples at rejected positions do not matter).  Position j draws
    from _mix(sub, j), as the JAX function splits its key T ways."""
    logits = _apply_logit_bias(logits, ds)
    if sv is None and not ds.penalized:
        return _sample_logits(logits, sub, ds)
    t = logits.shape[1]
    ids = []
    for j in range(t):
        if sv is not None:
            pos = None if base_pos is None else base_pos + 1 + j
            ids.append(sample_logits_vec(logits[:, j], _mix(sub, j), sv, rec, position=pos))
        else:
            ids.append(_sample_logits(_apply_penalties(logits[:, j], rec, ds), _mix(sub, j), ds))
        if j < t - 1:
            rec = _recent_push(rec, toks[:, j + 1])
    return torch.stack(ids, dim=1)


def verify_step(cfg, params, tokens, n_past, cache_k, cache_v, key, recent, *,
                ds: DeviceSampling, kv_window: int, forward_fn=None):
    """The JAX ``_verify``: forward tokens [B, T] = [last, d_1..d_{T-1}] at
    n_past (writing the caches in place), sample every position on the
    device.  Returns (ids [B, T], the carried key).  ``Context.verify``
    captures exactly this in its graph.  forward_fn: the forward, with
    transformer.forward's arguments (default transformer.forward; a mesh
    Context's ``mesh_forward``)."""
    fwd = forward_fn or transformer.forward
    logits = fwd(cfg, params, tokens, n_past, cache_k, cache_v, last_only=False,
                 kv_window=kv_window)
    key, sub = split_key(key)
    return _verify_sample(logits, tokens, sub, ds, recent), key


# ------------------------------------------------------------ host loop

@dataclass
class SpecStats:
    n_verify: int = 0  # verify forwards run
    n_drafted: int = 0  # draft tokens proposed
    n_accepted: int = 0  # draft tokens accepted
    n_tokens: int = 0  # tokens emitted (accepted + bonus samples)

    @property
    def acceptance(self) -> float:
        return self.n_accepted / max(1, self.n_drafted)

    @property
    def tokens_per_step(self) -> float:
        return self.n_tokens / max(1, self.n_verify)

    def report(self) -> str:
        """The stats line main prints on stderr."""
        return (f"speculative: {self.tokens_per_step:.2f} tokens/step, "
                f"{100 * self.acceptance:.0f}% drafts accepted "
                f"({self.n_accepted}/{self.n_drafted})")


def generate_speculative(ctx: Context, prompt_tokens: list[int], n_predict: int, *,
                         sampling: DeviceSampling | None = None,
                         spec: SpecParams | None = None, drafter=None, seed: int = 0,
                         eos_token: int = TOKEN_EOS, ignore_eos: bool = False,
                         stats: SpecStats | None = None) -> list[int]:
    """Prefill, then decode with draft-and-verify steps (the host loop).
    Greedy (sampling.temp <= 0) output is token for token
    runtime/generate.py's; temperature sampling is unbiased."""
    ds = sampling or DeviceSampling(temp=-1.0)
    sp = spec or SpecParams()
    drafter = drafter or PromptLookupDrafter(sp)
    stats = stats if stats is not None else SpecStats()

    logits = ctx.eval(np.asarray([prompt_tokens], np.int64))
    key = prng_key(seed, ctx.device)
    key, sub = split_key(key)
    last = first_sample(logits[0, -1], list(prompt_tokens), ds, sub, ctx.cfg.n_vocab)
    out: list[int] = []
    if last == eos_token and not ignore_eos:
        return out
    out.append(last)
    stats.n_tokens += 1
    history = list(prompt_tokens) + [last]
    drafter.prefill(history)

    while len(out) < n_predict:
        room = ctx.n_ctx - ctx.n_past - 2
        if room <= 0:
            break
        k = min(sp.n_draft, room, n_predict - len(out))
        drafts = drafter.draft(history, k) if k > 0 else []
        bt = min(_bucket(1 + len(drafts)), ctx.n_ctx - ctx.n_past)
        drafts = drafts[: bt - 1]
        toks = np.zeros((1, bt), np.int64)
        toks[0, 0] = last
        toks[0, 1:1 + len(drafts)] = drafts
        p = ctx.n_past
        recent = (make_recent([history], ds.repeat_last_n, ctx.cfg.n_vocab, device=ctx.device)
                  if ds.penalized else None)
        row, key = ctx.verify(toks, p, key, recent, ds=ds,
                              kv_window=min(_bucket(p + bt), ctx.n_ctx))
        row = row[0]
        a = 0
        while a < len(drafts) and int(row[a]) == drafts[a]:
            a += 1
        bonus = int(row[a])
        stats.n_verify += 1
        stats.n_drafted += len(drafts)
        stats.n_accepted += a
        drafter.commit(a, bonus)
        ctx.n_past = p + a + 1

        done = False
        for tok in drafts[:a] + [bonus]:
            if tok == eos_token and not ignore_eos:
                done = True
                break
            out.append(tok)
            history.append(tok)
            stats.n_tokens += 1
            if len(out) >= n_predict:
                done = True
                break
        if done:
            break
        last = out[-1]
    return out[:n_predict]
