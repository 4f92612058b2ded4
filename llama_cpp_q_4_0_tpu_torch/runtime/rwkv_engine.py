"""Continuous batching for the RWKV recurrence: multi-request serving.

The JAX package's ``runtime/rwkv_engine.py``.  The transformer engine's
slots are rows of the KV cache; here a slot is one row of the recurrent
state (5 x [L, B, E]) and one row of the token history.  Every tick is a
chunk of speculative draft-verify rounds (``RwkvContext.spec_chunk``): the
parallel verify is the one multi-token step the recurrence has, and with
prompt-lookup hits it emits several tokens a weight pass; on novel text it
is a batched decode of one token a round.

The engine owns an ``RwkvContext(batch=n_slots)`` and serves from its
state: on the card a tick is that context's round graph replayed ``chunk``
times.  Admissions batch every free slot into one ragged parallel prefill
(trailing-padding valid masks), run eagerly, and their rows are written
into the engine's state, history, lengths and frozen-row tensors with
``index_copy_``: the graphs hold them by address, so nothing is rebound.
Ticks run two in flight: a tick's tokens go to pinned host memory behind an
event, so the copy of tick t overlaps tick t+1.

The public surface is BatchEngine's (submit / start / stop / stats and
``Request``), so ``cli/server.py --parallel`` serves RWKV models the same
way.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from ..models import rwkv
from ..models.config import ModelConfig
from ..ops.qtensor import maybe_cast_scales_f16, maybe_fold_zero_points
from .batch_engine import Request, _bucket, _Slot, dataclasses_replace_rln
from .context import RwkvContext
from .device_sample import DeviceSampling, prng_key
from .sampling import Sampler
from .speculative import SpecParams
from .tokenizer import TOKEN_EOS


class RwkvBatchEngine:
    """Multi-request RWKV serving over speculative device ticks."""

    def __init__(self, cfg: ModelConfig, params, *, n_slots: int = 8, n_ctx: int = 2048,
                 chunk: int = 8, spec_draft: int = 5, spec: SpecParams | None = None,
                 device_sampling: DeviceSampling | None = None,
                 per_request_sampling: bool = True, seed: int = 0, pipeline_depth: int = 2,
                 device=None):
        """n_ctx: the history buffer's width (the lookup window); chunk:
        verify rounds a tick.  device defaults to cuda and raises without
        CUDA unless "cpu" is asked for."""
        self.cfg = cfg
        # the folded view for the ticks, the raw one for the batched prefill
        params = maybe_cast_scales_f16(params)
        self.ctx = RwkvContext(cfg, None, batch=n_slots, device=device,
                               views=(maybe_fold_zero_points(params), params))
        self.device = self.ctx.device
        self.params, self.params_prefill = self.ctx.params, self.ctx._params_prefill
        self.n_slots = n_slots
        self.n_ctx = n_ctx
        self.chunk = chunk
        self.spec = spec or SpecParams(n_draft=spec_draft)
        self.device_sampling = device_sampling or DeviceSampling(temp=-1.0)
        self.per_request_sampling = per_request_sampling
        self.pipeline_depth = pipeline_depth
        self.slots = [_Slot(i) for i in range(n_slots)]
        self._state = self.ctx.state  # the rows of every slot, in place
        self._hist = torch.zeros((n_slots, n_ctx), dtype=torch.int64, device=self.device)
        # an idle row holds one token: its frozen verify then reads column 0
        self._n_hist = torch.ones((n_slots,), dtype=torch.int64, device=self.device)
        self._done = torch.ones((n_slots,), dtype=torch.bool, device=self.device)
        self._key = prng_key(seed, self.device)
        self._inbox: queue.Queue[Request | None] = queue.Queue()
        self._pending: list[Request] = []
        self._inflight: list[dict] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None  # why the engine thread died
        self._req_ids = iter(range(1, 1 << 62))
        self.n_ticks = 0
        self.n_tokens_out = 0
        self.n_requests_done = 0
        self.n_spec_rounds = 0
        self.n_spec_drafted = 0
        self.n_spec_accepted = 0

    # ------------------------------------------------------ the public surface

    def submit(self, req: Request) -> Request:
        if self._error is not None:
            raise RuntimeError("engine thread died; restart the engine") from self._error
        if self.per_request_sampling and req.sampling is not None and req.sampling.mirostat:
            # a verify's acceptance has no defined mirostat mu stream, and the
            # recurrence has no chunked tick to fall back to
            raise ValueError("mirostat sampling is not supported by the speculative RWKV "
                             "engine; use a single-stream context instead")
        req.id = next(self._req_ids)
        self._inbox.put(req)
        if (self._error is not None and self._thread is not None
                and not self._thread.is_alive()):
            req.out.put(None)  # raced a dying thread past its inbox drain
        return req

    def start(self):
        self._error = None
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._inbox.put(None)
        if self._thread:
            self._thread.join()
            self._thread = None

    def stats(self) -> dict:
        acc = self.n_spec_accepted / self.n_spec_drafted if self.n_spec_drafted else 0.0
        return {"arch": "rwkv", "n_slots": self.n_slots, "active": self.n_active,
                "queued": len(self._pending), "n_ticks": self.n_ticks,
                "n_tokens_out": self.n_tokens_out, "n_requests_done": self.n_requests_done,
                "spec_rounds": self.n_spec_rounds, "spec_acceptance": acc}

    @property
    def n_active(self) -> int:
        return sum(1 for s in self.slots if s.active)

    # ---------------------------------------------------------------- engine

    def _drain_inbox(self, block: bool):
        try:
            while True:
                r = self._inbox.get(timeout=0.05) if block else self._inbox.get_nowait()
                block = False
                if r is None:
                    return
                self._pending.append(r)
        except queue.Empty:
            pass

    def _admit(self):
        """Every (free slot, pending request) pair in one ragged parallel
        prefill from a fresh state, its rows then written into the engine's
        tensors."""
        batch = []
        for s in self.slots:
            if not self._pending:
                break
            if s.free:
                batch.append((s, self._pending.pop(0)))
        if not batch:
            return
        # bound before the prefill, so that the engine thread's exit closes
        # them if the forward fails
        for slot, req in batch:
            slot.req = req
        prompts = [r.prompt_tokens for _, r in batch]
        t_pad = _bucket(max(len(p) for p in prompts))
        toks = np.zeros((len(batch), t_pad), np.int64)
        valid = np.zeros((len(batch), t_pad), bool)
        for i, p in enumerate(prompts):
            toks[i, :len(p)] = p
            valid[i, :len(p)] = True
        logits, st = rwkv.forward(
            self.cfg, self.params_prefill, torch.from_numpy(toks).to(self.device),
            rwkv.init_state(self.cfg, len(batch), self.device),
            valid=torch.from_numpy(valid).to(self.device), last_only=True)
        logits = logits.float().cpu().numpy()  # [n, 1, V] at each last valid position

        rows, idxs, hist_rows, ns = [], [], [], []
        for i, (slot, req) in enumerate(batch):
            if req.cancelled:
                req.out.put(None)
                slot.req = None
                continue
            slot.sampler = Sampler(req.sampling, self.cfg.n_vocab, req.seed)
            slot.last_tokens = list(prompts[i])
            slot.produced = 0
            slot.n_past = len(prompts[i])
            self._emit_one(slot, logits[i, -1])
            if slot.req is None:
                continue  # finished on its first token
            row = np.zeros((self.n_ctx,), np.int64)
            row[:len(slot.last_tokens)] = slot.last_tokens
            rows.append(i)
            idxs.append(slot.idx)
            hist_rows.append(row)
            ns.append(len(slot.last_tokens))
        if not idxs:
            return
        idx = torch.tensor(idxs, dtype=torch.int64, device=self.device)
        sel = torch.tensor(rows, dtype=torch.int64, device=self.device)
        for k, t in self._state.items():
            t.index_copy_(1, idx, st[k].index_select(1, sel))
        self._hist.index_copy_(0, idx, torch.from_numpy(np.stack(hist_rows)).to(self.device))
        self._n_hist.index_copy_(0, idx, torch.tensor(ns, dtype=torch.int64,
                                                      device=self.device))
        self._done.index_fill_(0, idx, False)

    def _emit_one(self, slot: _Slot, row_logits: np.ndarray):
        """Host-sample an admission's first token and apply the finish
        conditions (BatchEngine._emit's)."""
        req = slot.req
        tok = slot.sampler.sample(row_logits, slot.last_tokens)
        done = False
        if tok == TOKEN_EOS:
            done = True
        else:
            slot.last_tokens.append(tok)
            slot.produced += 1
            self.n_tokens_out += 1
            req.out.put(tok)
            if req.stop_sequences and any(tuple(slot.last_tokens[-len(ss):]) == ss
                                          for ss in req.stop_sequences if ss):
                done = True
        if slot.produced >= req.n_predict:
            done = True
        if done:
            req.out.put(None)
            self.n_requests_done += 1
            slot.req = None
            slot.sampler = None

    def _make_sv(self):
        from .device_sample import VEC_WINDOW, make_sampling_vec

        sv = make_sampling_vec([s.req.sampling if s.active else None for s in self.slots],
                               seeds=[s.req.seed if s.active else -1 for s in self.slots],
                               device=self.device)
        return dataclasses_replace_rln(sv, VEC_WINDOW)

    def _issue(self):
        """One tick without waiting for it: `chunk` rounds of the context's
        replayed graph over the engine's state; the history, lengths and
        frozen rows copied back into the engine's tensors on the device, the
        tokens to pinned host memory behind an event."""
        sv = self._make_sv() if self.per_request_sampling else None
        hist, n_hist, self._key, done, _eosed, emit_toks, emit_ns = self.ctx.spec_chunk(
            self._hist, self._n_hist, self._key, self._done, sv, k=self.spec.n_draft,
            n_steps=self.chunk, ds=self.device_sampling, max_ngram=self.spec.max_ngram,
            min_ngram=self.spec.min_ngram, eos=TOKEN_EOS, ignore_eos=False)
        for dst, src in ((self._hist, hist), (self._n_hist, n_hist), (self._done, done)):
            dst.copy_(src)
        self.n_ticks += 1
        t = {"snap": [(s.idx, s.req) for s in self.slots if s.active]}
        for name, src in (("emit_toks", emit_toks), ("emit_ns", emit_ns),
                          ("n_hist", n_hist), ("done", done)):
            if self.device.type == "cuda":
                t[name] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
                t[name].copy_(src, non_blocking=True)
            else:
                t[name] = src
        if self.device.type == "cuda":
            t["event"] = torch.cuda.Event()
            t["event"].record()
        self._inflight.append(t)

    def _harvest_one(self):
        t = self._inflight.pop(0)
        if "event" in t:
            t["event"].synchronize()
        toks_h = t["emit_toks"].numpy()  # [n_steps, B, k+1]
        ns_h = t["emit_ns"].numpy()  # [n_steps, B]
        n_hist_h = t["n_hist"].numpy()
        done_h = t["done"].numpy()
        snap = dict(t["snap"])
        freeze = []
        for s in self.slots:
            req = snap.get(s.idx)
            if req is None or s.req is not req:
                continue  # freed at an earlier harvest (a stale tick)
            finished = False
            emit = []  # one queue put a (request, tick)
            for step in range(ns_h.shape[0]):
                n = int(ns_h[step, s.idx])
                self.n_spec_rounds += 1
                self.n_spec_drafted += self.spec.n_draft
                self.n_spec_accepted += max(0, n - 1)
                for tok in toks_h[step, s.idx, :n].tolist():
                    s.last_tokens.append(tok)
                    s.produced += 1
                    self.n_tokens_out += 1
                    emit.append(tok)
                    if req.stop_sequences and any(tuple(s.last_tokens[-len(ss):]) == ss
                                                  for ss in req.stop_sequences if ss):
                        finished = True
                        break
                    if s.produced >= req.n_predict:
                        finished = True
                        break
                if finished:
                    break
            if emit:
                req.out.put(emit)
            s.n_past = int(n_hist_h[s.idx]) - 1
            if not finished and done_h[s.idx]:
                finished = True  # the device froze the row (EOS or the history's end)
            if finished:
                req.out.put(None)
                self.n_requests_done += 1
                s.req = None
                s.sampler = None
                freeze.append(s.idx)
        self._freeze(freeze)

    def _freeze(self, idxs: list[int]) -> None:
        if idxs:
            self._done.index_fill_(0, torch.tensor(idxs, dtype=torch.int64,
                                                   device=self.device), True)

    def _flush_inflight(self):
        while self._inflight:
            self._harvest_one()

    def _reap_cancelled(self):
        freeze = []
        for s in self.slots:
            if s.req is not None and s.req.cancelled:
                s.req.out.put(None)
                s.req = None
                s.sampler = None
                freeze.append(s.idx)
        self._freeze(freeze)

    def _run(self):
        try:
            with torch.no_grad():
                if self.device.type == "cuda":
                    with torch.cuda.device(self.device):
                        self._run_loop()
                else:
                    self._run_loop()
        except BaseException as e:
            self._error = e
            raise
        finally:
            # close the slots, the pending requests and the inbox not yet
            # drained: no client blocks on a dead engine thread
            self._inflight.clear()
            for s in self.slots:
                if s.req is not None:
                    s.req.out.put(None)
                    s.req = None
            for r in self._pending:
                r.out.put(None)
            self._pending.clear()
            try:
                while True:
                    r = self._inbox.get_nowait()
                    if r is not None:
                        r.out.put(None)
            except queue.Empty:
                pass

    def _run_loop(self):
        while not self._stop.is_set():
            self._drain_inbox(block=(self.n_active == 0 and not self._pending
                                     and not self._inflight))
            if self._stop.is_set():
                break
            if self._pending and any(s.free for s in self.slots):
                # an admission writes rows: retire the ticks in flight first, so
                # that a freed row is not admitted under one of them
                self._flush_inflight()
                self._admit()
            self._reap_cancelled()
            if any(s.active for s in self.slots):
                self._issue()
                if len(self._inflight) >= self.pipeline_depth:
                    self._harvest_one()
            elif self._inflight:
                self._flush_inflight()
        self._flush_inflight()
