"""Continuous-batching inference engine: multi-request serving.

The reference's server is single-session (llama_server_context,
server.cpp:40-200): one request at a time.  This engine serves N slots with
one batched decode step a tick (an [N, 1] forward with a position per row),
admits new requests into free slots mid-flight (a prefill that writes only
their rows of the cache) and frees finished slots at once.  Decode streams
the weights once a tick whatever the occupancy, so throughput grows with it.
The JAX package's ``runtime/batch_engine.py``.

On the card every tick is a replayed CUDA graph of the engine's
``Context(batch=n_slots)``, whose caches the engine serves from:

- a host tick is one ``"tick"`` step of the Context, keyed by its kv_window
  and the routing switches;
- a chunked tick is ``Context.decode_chunk`` with a [N] n_past and the
  chunk's tokens left on the device;
- a speculative tick is ``Context.spec_chunk``.

Admissions (a slot's prefill, a batched burst, the chunked-prefill lane and
the prefix cache) run eagerly: their shapes vary with the prompt, and a
graph keyed by slot, bucket and batch would multiply captures.  The caches
are never rebound: the graphs hold them by address.  A slot's prefill runs on
the slot's row views; a batched admission gathers its slots' rows into a
staging cache and writes the real rows back (``index_copy_``); the lane and
the prefix cache keep row caches of their own and are copied into the slots'
rows.  ``ENGINE_TRACE=1`` prints each tick's issue and harvest times.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import queue
import sys
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from ..models import transformer
from ..models.config import ModelConfig
from ..models.transformer import TransformerParams, init_cache
from ..ops.flash_prefill import flash_prefill
from ..ops.kvcache import QuantKV, raw
from ..ops.layers import use_flash_prefill
from ..ops.qtensor import maybe_cast_scales_f16, maybe_fold_zero_points
from .context import Context, StepCall, _bucket
from .sampling import Sampler, SamplingParams
from .tokenizer import TOKEN_EOS


@dataclass
class Request:
    prompt_tokens: list[int]
    n_predict: int = 128
    sampling: SamplingParams = field(default_factory=SamplingParams)
    seed: int = -1
    stop_sequences: tuple[tuple[int, ...], ...] = ()
    # filled by the engine:
    id: int = -1
    out: "queue.Queue[int | list[int] | None]" = field(default_factory=queue.Queue)
    cancelled: bool = False

    def cancel(self) -> None:
        """Ask the engine to stop this request (a client went away); the
        slot frees at the next tick."""
        self.cancelled = True

    def tokens(self, timeout: float | None = None):
        """The generated ids until the request completes (blocking).  The
        engine puts a list of ids a tick, and None at the end; call this
        once a request.  With a timeout, a wait longer than it raises
        ``queue.Empty``."""
        while True:
            t = self.out.get(timeout=timeout)
            if t is None:
                return
            if isinstance(t, list):
                yield from t
            else:
                yield t


class _Slot:
    def __init__(self, idx: int):
        self.idx = idx
        self.req: Request | None = None
        self.sampler: Sampler | None = None
        self.last_tokens: list[int] = []
        self.produced = 0
        self.n_past = 0
        self.ready = True  # False while a chunked prefill is in flight
        self.mu_fresh = False  # reset the device mirostat mu at the next window

    @property
    def free(self) -> bool:
        return self.req is None

    @property
    def active(self) -> bool:
        return self.req is not None and self.ready


def dataclasses_replace_rln(sv, window: int):
    """Clamp the per-row repeat_last_n to the recent window's length."""
    return dataclasses.replace(sv, repeat_last_n=sv.repeat_last_n.clamp(max=window))


def _tensors(obj):
    """Every tensor of a params tree (dataclasses, lists and tuples)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _tensors(x)


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def estimate_engine_hbm(params, cfg, n_slots: int, n_ctx: int,
                        cache_dtype) -> tuple[int, int]:
    """(weight_bytes, kv_bytes) of a single-device engine.  The KV term is
    init_cache's layout (kv_cache_init's sizing, llama.cpp:733-776): 2 x
    [slots, ctx, kv_heads, head_dim] a layer, and the [slots, ctx, kv_heads]
    f32 scale planes of an int8 cache.  The weights are every tensor of the
    params, as they lie in device memory (the layouts are the JAX package's
    byte for byte)."""
    weights = sum(t.numel() * t.element_size() for t in _tensors(params))
    per = n_slots * n_ctx * cfg.kv_heads * cfg.n_layer
    itemsize = _itemsize(cache_dtype)
    kv = 2 * per * cfg.head_dim * itemsize
    if itemsize == 1:
        # QuantKV's per-(token, head) f32 scales; counted for an f8 cache
        # too, which has none, as the JAX estimate counts them
        kv += 2 * per * 4
    return weights, kv


_TRACE = os.environ.get("ENGINE_TRACE") == "1"

# the share of device memory the engine may plan for (the rest covers
# activations, the admissions' staging caches and the graphs' pool); a plan
# beyond it fails here rather than running out of memory mid-serving
_HBM_PLAN_FRACTION = 0.85


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _rows(caches, sl: slice) -> list:
    """Views of rows sl of each layer's cache (written through in place)."""
    return [QuantKV(c.data[sl], c.scale[sl]) if isinstance(c, QuantKV) else c[sl]
            for c in caches]


def _parts(c) -> tuple:
    """The tensors of one layer's cache to copy: an f8 cache through its
    bytes, a QuantKV its levels and scales."""
    return (c.data, c.scale) if isinstance(c, QuantKV) else (raw(c),)


def _cache_dtype(caches):
    return torch.int8 if isinstance(caches[0], QuantKV) else caches[0].dtype


class BatchEngine:
    """One engine thread owns the device state; callers submit() Requests
    and read their token queues."""

    def __init__(self, cfg: ModelConfig, params: TransformerParams, *,
                 n_slots: int = 4, n_ctx: int | None = None,
                 cache_dtype="auto", chunk: int = 1,
                 device_sampling=None, pipeline_depth: int = 2,
                 spec_draft: int = 0, spec_max_active: int | None = None,
                 per_request_sampling: bool = False,
                 forward_fn=None, tp_mesh=None, mesh=None,
                 hbm_limit_bytes: int | None = None, device=None):
        """chunk > 1: `chunk` tokens a tick are decoded and sampled on the
        device (runtime/device_sample.py) with one copy to the host a chunk;
        the engine-wide device_sampling (DeviceSampling) replaces each
        request's sampler after its first token, unless
        per_request_sampling keeps each row's own settings on the device.

        spec_draft > 0: speculative ticks.  Each tick runs `chunk` prompt-
        lookup draft-verify rounds for every slot at once
        (runtime/device_spec.py), 1..spec_draft+1 tokens a slot a round;
        exact for greedy.  Above spec_max_active active slots (default:
        n_slots when n_ctx >= 1024, else 8) and while any slot samples with
        mirostat, the ticks fall back to plain chunked ones.

        forward_fn: a forward with transformer.forward's contract, run
        eagerly for every forward of the engine.  mesh and tp_mesh (the
        sharded engines) are not ported.  hbm_limit_bytes: the device memory
        the plan is held to (default: the card's total).  device defaults
        to cuda and raises without CUDA unless "cpu" is asked for."""
        if mesh is not None or tp_mesh is not None:
            raise NotImplementedError("sharded engines (mesh, tp_mesh) are not ported")
        if forward_fn is not None and spec_draft > 0:
            raise NotImplementedError("speculative ticks take the default forward")
        self.device = resolve_device(device)
        self.forward_fn = forward_fn
        self._fwd = forward_fn or transformer.forward
        self.cfg = cfg
        params_prefill = maybe_cast_scales_f16(params)  # the admissions' raw view
        params = maybe_fold_zero_points(params_prefill)  # the ticks' view
        self.n_slots = n_slots
        self.n_ctx = n_ctx or cfg.n_ctx
        self.chunk = chunk
        self.spec_draft = spec_draft
        if spec_max_active is None:
            spec_max_active = n_slots if self.n_ctx >= 1024 else 8
        self.spec_max_active = spec_max_active
        self.per_request_sampling = per_request_sampling
        self._mode = None  # "spec" | "chunked" | None (the adaptive switch)
        if chunk > 1 or spec_draft > 0:
            from .device_sample import DeviceSampling, prng_key

            self.device_sampling = device_sampling or DeviceSampling()
            self._key = prng_key(0, self.device)
        if spec_draft > 0:
            from .speculative import SpecParams

            self.spec = SpecParams(n_draft=spec_draft)
            self._hist = torch.zeros((n_slots, self.n_ctx), dtype=torch.int64,
                                     device=self.device)
            self._n_hist = torch.ones((n_slots,), dtype=torch.int64, device=self.device)
            self._done = torch.ones((n_slots,), dtype=torch.bool, device=self.device)
        limit = hbm_limit_bytes
        if limit is None and self.device.type == "cuda":
            limit = torch.cuda.mem_get_info(self.device)[1]
        if cache_dtype == "auto":
            # bf16 when it fits the plan, the scaled-int8 cache when only that
            # does; an explicit dtype gets the refusal below instead
            cache_dtype = torch.bfloat16
            if limit:
                weights, kv = estimate_engine_hbm(params, cfg, n_slots, self.n_ctx,
                                                  torch.bfloat16)
                if weights + kv > int(limit * _HBM_PLAN_FRACTION):
                    cache_dtype = torch.int8
                    print(f"engine: bf16 KV ({kv / 2**30:.2f} GiB for {n_slots} slots x "
                          f"{self.n_ctx} ctx) exceeds the memory plan budget; "
                          f"auto-selecting the scaled-int8 cache (pass cache_dtype= or "
                          f"--cache-type to override)", file=sys.stderr)
        if limit:
            weights, kv = estimate_engine_hbm(params, cfg, n_slots, self.n_ctx, cache_dtype)
            budget = int(limit * _HBM_PLAN_FRACTION)
            if weights + kv > int(limit * 0.80) and params is not params_prefill:
                # a tight fit: serve the ticks from the raw view too, which
                # drops the folded view's bias planes
                params = params_prefill
                weights, kv = estimate_engine_hbm(params, cfg, n_slots, self.n_ctx,
                                                  cache_dtype)
                print(f"engine: plan within 20% of device memory; serving ticks from "
                      f"the raw (unfolded) weight view ({(weights + kv) / 2**30:.2f} GiB "
                      f"planned)", file=sys.stderr)
            if weights + kv > budget:
                raise ValueError(
                    f"engine config does not fit HBM: weights {weights / 2**30:.2f} GiB "
                    f"+ KV cache {kv / 2**30:.2f} GiB ({n_slots} slots x {self.n_ctx} ctx, "
                    f"{_dtype_name(cache_dtype)}) > {budget / 2**30:.2f} GiB plan budget "
                    f"({_HBM_PLAN_FRACTION:.0%} of {limit / 2**30:.2f} GiB). Use "
                    f"cache_dtype=torch.int8 (--cache-type q8), fewer slots, or a "
                    f"smaller n_ctx.")
        self.cache_dtype = cache_dtype
        # the ticks' graphs live in this Context; its caches are the engine's
        self.ctx = Context(cfg, None, batch=n_slots, n_ctx=self.n_ctx,
                           cache_dtype=cache_dtype, device=self.device,
                           views=(params, params_prefill))
        self.params, self.params_prefill = params, params_prefill
        self.cache_k, self.cache_v = self.ctx.cache_k, self.ctx.cache_v
        self.slots = [_Slot(i) for i in range(n_slots)]
        # the chunked pipeline: ticks issued ahead of their harvest, the
        # sample-to-input feedback kept on the device
        self.pipeline_depth = max(1, pipeline_depth)
        self._recent = None  # the device penalty window, carried across ticks
        self._sv = None  # the per-request SamplingVec (per_request_sampling)
        self._mu = None  # the device mirostat state, carried across ticks
        self._prefix = None  # (tokens, row_k, row_v) from register_prefix
        self.prefill_chunk = 512  # the chunked prefill's piece (tokens)
        # the lane's cohort: up to this many long prompts of one chunk count
        # advance together in one [K, prefill_chunk] forward.  Each lane row
        # costs one slot's KV on top of the weights and the cache: wide
        # (2-byte and up) caches keep width 1 on the card, int8 cohorts are
        # clamped to the free memory; the CPU keeps cohorts.  LANE_WIDTH
        # overrides either way.
        self.lane_width = 1 if forward_fn else int(os.environ.get("LANE_WIDTH", "4"))
        if self.lane_width > 1 and not os.environ.get("LANE_WIDTH"):
            if _itemsize(cache_dtype) > 1:
                if self.device.type == "cuda":
                    self.lane_width = 1
            elif limit:
                w_b, kv_b = estimate_engine_hbm(params, cfg, n_slots, self.n_ctx, cache_dtype)
                row_b = max(1, kv_b // n_slots)
                free = limit - w_b - kv_b - (512 << 20)
                self.lane_width = max(1, min(self.lane_width, int(free // row_b)))
        self._prefill_state: dict | None = None
        self._inflight: list[dict] = []
        self._sched_n_past = [0] * n_slots
        self._ids = itertools.count()
        # the counters of stats() and the server's /stats
        self.n_ticks = 0
        self.n_tokens_out = 0
        self.n_requests_done = 0
        self.n_spec_rounds = 0
        self.n_spec_accepted = 0
        self.n_spec_drafted = 0
        self._inbox: queue.Queue[Request | None] = queue.Queue()
        self._pending: list[Request] = []
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._error: BaseException | None = None  # why the engine thread died

    # ------------------------------------------------------------- forwards

    def _host_ints(self, a) -> torch.Tensor:
        """Host ints as an int64 tensor on the device, copied without
        waiting for the work queued before it (pinned memory)."""
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _attn_fn(self, pad: int):
        """attention_fn of an n_past == 0 admission: the flash prefill
        kernel where it is eligible (custom forwards own their attention)."""
        if self.forward_fn is None and use_flash_prefill(pad, self.cfg.head_dim, self.device):
            return flash_prefill
        return None

    def _forward(self, params, toks: np.ndarray, n_past, ck, cv, *, kv_window, last,
                 attention_fn=None) -> torch.Tensor:
        """An eager admission forward over caches ck, cv (views or row
        caches, written in place): the logits of each row's token last[i]
        (its last real one), [B, V] on the device."""
        kw = dict(kv_window=kv_window)
        if attention_fn is not None:
            kw["attention_fn"] = attention_fn
        logits = self._fwd(self.cfg, params, self._host_ints(toks), n_past, ck, cv,
                           last_index=self._host_ints(last), **kw)
        return logits[:, 0]

    def _slot_prefill(self, slot: int, toks: np.ndarray, n_real: int, *, kv_window: int,
                      n_past: int = 0, attention_fn=None) -> np.ndarray:
        """A [1, T_pad] prefill of one slot, on its row views of the caches;
        the logits of its last real token [V]."""
        sl = slice(slot, slot + 1)
        logits = self._forward(self.params_prefill, toks, n_past, _rows(self.cache_k, sl),
                               _rows(self.cache_v, sl), kv_window=kv_window,
                               last=[n_real - 1], attention_fn=attention_fn)
        return logits[0].float().cpu().numpy()

    def _gather_rows(self, slots: list[int], m: int, w: int):
        """A staging [m, w] cache holding the first w positions of the given
        slots' rows (and zeros below them)."""
        rk, rv = init_cache(self.cfg, m, w, _cache_dtype(self.cache_k), self.device)
        idx = self._host_ints(slots)
        for big, rows in zip((*self.cache_k, *self.cache_v), (*rk, *rv)):
            for src, dst in zip(_parts(big), _parts(rows)):
                dst[: len(slots)].copy_(src.narrow(1, 0, w).index_select(0, idx))
        return rk, rv

    def _put_rows(self, rk, rv, slots: list[int]):
        """Write the first len(slots) rows of row caches rk, rv into those
        slots of the caches, in place, over their first w positions."""
        idx = self._host_ints(slots)
        for big, rows in zip((*self.cache_k, *self.cache_v), (*rk, *rv)):
            for dst, src in zip(_parts(big), _parts(rows)):
                w = src.shape[1]
                dst.narrow(1, 0, w).index_copy_(0, idx, src[: len(slots)])

    # --------------------------------------------------------------- public

    def register_prefix(self, tokens: list[int]) -> None:
        """Prefill a shared prompt prefix once (a system prompt); later
        requests that start with it copy its cached KV rows instead of
        running its prefill again (the serving analogue of main's
        --prompt-cache, main.cpp:157-230).  Costs one [1, S] row cache."""
        tokens = list(tokens)
        assert 0 < len(tokens) < self.n_ctx - 2
        row_k, row_v = init_cache(self.cfg, 1, self.n_ctx, _cache_dtype(self.cache_k),
                                  self.device)
        pad = min(_bucket(len(tokens)), self.n_ctx)
        toks = np.zeros((1, pad), np.int64)
        toks[0, : len(tokens)] = tokens
        with torch.no_grad():
            self._forward(self.params_prefill, toks, 0, row_k, row_v, kv_window=pad,
                          last=[len(tokens) - 1], attention_fn=self._attn_fn(pad))
        self._prefix = (tokens, row_k, row_v)

    def submit(self, req: Request) -> Request:
        if self._error is not None:
            raise RuntimeError("engine thread died; restart the engine") from self._error
        req.id = next(self._ids)
        self._inbox.put(req)
        if (self._error is not None and self._thread is not None
                and not self._thread.is_alive()):
            # raced a dying thread past its inbox drain: close it here
            req.out.put(None)
        return req

    def start(self):
        assert self._thread is None
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
        """Serving counters: tokens out, ticks, speculative acceptance,
        occupancy."""
        return {
            "n_active": self.n_active,
            "n_pending": len(self._pending),
            "cache_dtype": _dtype_name(self.cache_dtype),
            "n_ticks": self.n_ticks,
            "n_tokens_out": self.n_tokens_out,
            "n_requests_done": self.n_requests_done,
            "mode": self._mode or ("chunked" if self.chunk > 1 else "host"),
            "spec_rounds": self.n_spec_rounds,
            "spec_drafted": self.n_spec_drafted,
            "spec_accepted": self.n_spec_accepted,
            "spec_acceptance": self.n_spec_accepted / max(1, self.n_spec_drafted),
        }

    @property
    def n_active(self) -> int:
        return sum(not s.free for s in self.slots)

    # --------------------------------------------------------------- engine

    def _drain_inbox(self, block: bool):
        try:
            while True:
                r = self._inbox.get(timeout=0.2) if block else self._inbox.get_nowait()
                if r is None:
                    return
                self._pending.append(r)
                block = False
        except queue.Empty:
            pass

    def _long(self, req: Request) -> bool:
        return len(req.prompt_tokens[: self.n_ctx - 1] or [1]) > self.prefill_chunk

    def _admit(self):
        free = [s for s in self.slots if s.free]
        batch = []
        while self._pending and len(batch) < len(free):
            # while the lane is busy a long prompt can only wait: it stays in
            # _pending, and so does everything behind it (FIFO)
            if (self._prefill_state is not None and self._prefix is None
                    and self._long(self._pending[0])):
                break
            batch.append((free[len(batch)], self._pending.pop(0)))
        if not batch:
            return
        # bind each request to its slot before any admission forward: a
        # failure there unwinds past this frame, and _run's finally closes
        # only the requests it can see
        for slot, req in batch:
            slot.req = req
        if self._prefix is not None:
            plen = len(self._prefix[0])
            rest = []
            for slot, req in batch:
                p = req.prompt_tokens
                if len(p) > plen and p[:plen] == self._prefix[0]:
                    self._admit_one(slot, req)  # the cached prefix
                else:
                    rest.append((slot, req))
            batch = rest
        if not batch:
            return
        # The routing: long prompts (> prefill_chunk, no prefix cache) always
        # take the per-slot path, the chunked lane when it is free, else they
        # wait.  Short prompts batch into one [M_pad, T_pad] forward while the
        # flattened rows fit MAX_PALLAS_ROWS; above that they admit per slot.
        from ..ops.qmatmul import MAX_PALLAS_ROWS

        short = [(s, r) for s, r in batch if not self._long(r) or self._prefix is not None]
        rest = batch
        if len(short) > 1:
            pad = min(max(_bucket(len(r.prompt_tokens[: self.n_ctx - 1]) or 1)
                          for _, r in short), self.n_ctx)
            mp = 1
            while mp < len(short):
                mp *= 2
            if mp * pad <= MAX_PALLAS_ROWS:
                self._admit_batched(short)
                short_ids = {id(r) for _, r in short}
                rest = [(s, r) for s, r in batch if id(r) not in short_ids]
        deferred = []
        lane: list = []  # the lane's cohort (one chunk count, FIFO)
        lane_chunks = 0
        for slot, req in rest:
            prompt = req.prompt_tokens[: self.n_ctx - 1] or [1]
            if len(prompt) > self.prefill_chunk and self._prefix is None:
                n_chunks = -(-len(prompt) // self.prefill_chunk)
                if self._prefill_state is None and (
                        not lane or (n_chunks == lane_chunks and len(lane) < self.lane_width)):
                    lane.append((slot, req, prompt))
                    lane_chunks = n_chunks
                    continue
                slot.req = None  # the lane is busy or the cohort differs: wait
                deferred.append(req)
                continue
            if not self._admit_one(slot, req):
                deferred.append(req)
        if lane:
            self._start_prefill(lane)
        self._pending[0:0] = deferred  # FIFO order kept

    def _start_prefill(self, entries):
        """Begin a chunked-prefill cohort (1..lane_width long prompts of one
        chunk count) into a detached [K, S] row cache, so that ticks for
        the other slots go on; the rows go into their slots when it
        completes.  entries: [(slot, req, prompt), ...]."""
        row_k, row_v = init_cache(self.cfg, len(entries), self.n_ctx,
                                  _cache_dtype(self.cache_k), self.device)
        for slot, req, _ in entries:
            slot.req = req
            slot.ready = False
        self._prefill_state = {"entries": list(entries), "pos": 0,
                               "row_k": row_k, "row_v": row_v}

    def _continue_prefill(self):
        """Advance the lane's cohort by one lockstep [K, pad] chunk (one
        n_past for all: the cohort shares a chunk count, so only the last
        pieces' lengths differ, and each row's causal mask keeps its padding
        out of its own attention)."""
        st = self._prefill_state
        entries = st["entries"]
        if all(req.cancelled for _, req, _ in entries):
            for slot, req, _ in entries:
                req.out.put(None)
                slot.req = None
                slot.ready = True
            self._prefill_state = None
            return
        pos = st["pos"]
        k = len(entries)
        pieces = [p[pos: pos + self.prefill_chunk] for _, _, p in entries]
        pad = min(_bucket(max(len(pc) for pc in pieces)), self.n_ctx - pos)
        toks = np.zeros((k, pad), np.int64)
        for i, pc in enumerate(pieces):
            toks[i, : len(pc)] = pc
        n_reals = [max(len(pc), 1) for pc in pieces]
        logits = self._forward(
            self.params_prefill, toks, pos, st["row_k"], st["row_v"],
            kv_window=min(_bucket(pos + pad), self.n_ctx), last=[n - 1 for n in n_reals],
            attention_fn=self._attn_fn(pad) if pos == 0 else None)
        st["pos"] = pos + self.prefill_chunk
        if st["pos"] >= max(len(p) for _, _, p in entries):
            logits = logits.float().cpu().numpy()  # [K, V]
            self._flush_inflight()  # the write and the activations change tick state
            self._put_rows(st["row_k"], st["row_v"], [s.idx for s, _, _ in entries])
            self._prefill_state = None
            for i, (slot, req, prompt) in enumerate(entries):
                slot.req = None  # _activate sets it again
                slot.ready = True
                if req.cancelled:
                    req.out.put(None)
                    continue
                self._activate(slot, req, prompt, logits[i])
                self._sched_n_past[slot.idx] = slot.n_past

    def _admit_one(self, slot, req) -> bool:
        """Admit one request; False if it must wait because the lane is
        busy (the caller queues it again, in order)."""
        prompt = req.prompt_tokens[: self.n_ctx - 1] or [1]
        if len(prompt) > self.prefill_chunk and self._prefix is None:
            if self._prefill_state is None:
                self._start_prefill([(slot, req, prompt)])
                return True
            slot.req = None
            return False
        pre = self._prefix
        if pre is not None and len(prompt) > len(pre[0]) and prompt[: len(pre[0])] == pre[0]:
            # copy the cached prefix rows, then prefill only the rest
            ptoks, row_k, row_v = pre
            sl = slice(slot.idx, slot.idx + 1)
            for dst, src in zip((*_rows(self.cache_k, sl), *_rows(self.cache_v, sl)),
                                (*row_k, *row_v)):
                for d, s in zip(_parts(dst), _parts(src)):
                    d.copy_(s)
            rem = prompt[len(ptoks):]
            pad = min(_bucket(len(rem)), self.n_ctx - len(ptoks))
            toks = np.zeros((1, pad), np.int64)
            toks[0, : len(rem)] = rem
            logits = self._slot_prefill(slot.idx, toks, len(rem),
                                        kv_window=min(_bucket(len(ptoks) + pad), self.n_ctx),
                                        n_past=len(ptoks))
        else:
            pad = min(_bucket(len(prompt)), self.n_ctx)
            toks = np.zeros((1, pad), np.int64)
            toks[0, : len(prompt)] = prompt
            logits = self._slot_prefill(slot.idx, toks, len(prompt), kv_window=pad,
                                        attention_fn=self._attn_fn(pad))
        self._activate(slot, req, prompt, logits)
        return True

    def _admit_batched(self, batch):
        """Every waiting short request prefills in one [M_pad, T_pad]
        forward over a staging cache of their rows; M pads to a power of
        two with dummy rows, which are not written back."""
        prompts = [req.prompt_tokens[: self.n_ctx - 1] or [1] for _, req in batch]
        pad = min(max(_bucket(len(p)) for p in prompts), self.n_ctx)
        m = len(batch)
        mp = 1
        while mp < m:
            mp *= 2
        toks = np.zeros((mp, pad), np.int64)
        n_reals = np.ones((mp,), np.int64)
        for i, p in enumerate(prompts):
            toks[i, : len(p)] = p
            n_reals[i] = len(p)
        slots = [slot.idx for slot, _ in batch]
        rk, rv = self._gather_rows(slots, mp, pad)
        logits = self._forward(self.params_prefill, toks, 0, rk, rv, kv_window=pad,
                               last=n_reals - 1, attention_fn=self._attn_fn(pad))
        self._put_rows(rk, rv, slots)
        logits = logits.float().cpu().numpy()
        for i, ((slot, req), p) in enumerate(zip(batch, prompts)):
            self._activate(slot, req, p, logits[i])

    def _activate(self, slot, req, prompt, row_logits):
        slot.req = req
        slot.sampler = Sampler(req.sampling, self.cfg.n_vocab, req.seed)
        slot.last_tokens = list(prompt)
        slot.produced = 0
        slot.n_past = len(prompt)
        slot.mu_fresh = True  # a request's mirostat starts at mu = 2 * tau
        self._emit(slot, row_logits)
        if self.spec_draft > 0 and slot.req is not None:
            # the slot's history row, for the draft lookups
            row = np.zeros((self.n_ctx,), np.int64)
            row[: len(slot.last_tokens)] = slot.last_tokens
            self._hist[slot.idx] = self._host_ints(row)
            self._n_hist[slot.idx] = len(slot.last_tokens)
            self._done[slot.idx] = False

    def _reap_cancelled(self) -> None:
        for s in self.slots:
            if s.req is not None and s.req.cancelled:
                s.req.out.put(None)
                s.req = None
                s.sampler = None
                if self.spec_draft > 0:
                    self._done[s.idx] = True

    def _emit(self, slot: _Slot, row_logits: np.ndarray):
        """Sample one token for the slot on the host; finish it where due."""
        req = slot.req
        if req.cancelled:
            req.out.put(None)
            slot.req = None
            slot.sampler = None
            return
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
        if slot.produced >= req.n_predict or slot.n_past + 1 >= self.n_ctx:
            done = True
        if done:
            req.out.put(None)
            self.n_requests_done += 1
            slot.req = None
            slot.sampler = None

    def _to_host(self, **tensors) -> dict:
        """Start copies of device tensors into pinned host tensors of their
        own, with an event marking their end: the harvest waits on that
        event alone."""
        out = {}
        for name, t in tensors.items():
            if self.device.type == "cuda":
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                out[name] = h
            else:
                out[name] = t.clone()
        if self.device.type == "cuda":
            out["event"] = torch.cuda.Event()
            out["event"].record()
        return out

    @staticmethod
    def _wait(t: dict) -> None:
        if "event" in t:
            t["event"].synchronize()

    def _issue_chunked(self):
        """Issue one chunked decode tick without waiting for its tokens.
        The first tick of a window feeds the slots' last tokens from the
        host; each later one feeds the previous tick's last column, on the
        device, so that the copy of tick t to the host overlaps tick t+1."""
        from .device_sample import VEC_WINDOW, make_recent

        if self._inflight:
            tok_dev = self._inflight[-1]["out_dev"][:, -1]
        else:
            toks = np.zeros((self.n_slots,), np.int64)
            for s in self.slots:
                if s.active:
                    toks[s.idx] = s.last_tokens[-1]
            tok_dev = self._host_ints(toks)
            # the host state holds at the start of a window: rebuild the
            # penalty window (carried on the device between ticks otherwise)
            if self.per_request_sampling:
                self._sv = self._make_sv()
                self._recent = make_recent([s.last_tokens if s.active else []
                                            for s in self.slots], VEC_WINDOW,
                                           self.cfg.n_vocab, device=self.device)
                if self._sv.mirostat is not None:
                    # each row's mu carries over windows; a slot admitted
                    # since the last window continues its host chain's mu
                    mu_h = (self._mu.cpu().numpy().copy() if self._mu is not None
                            else np.full((self.n_slots,), 10.0, np.float32))
                    for s in self.slots:
                        if s.mu_fresh:
                            mu_h[s.idx] = (s.sampler.mirostat_mu
                                           if s.sampler is not None else 10.0)
                            s.mu_fresh = False
                    self._mu = torch.from_numpy(mu_h.astype(np.float32)).to(self.device)
            else:
                self._recent = (
                    make_recent([s.last_tokens if s.active else [] for s in self.slots],
                                self.device_sampling.repeat_last_n, self.cfg.n_vocab,
                                device=self.device)
                    if self.device_sampling.penalized
                    else torch.zeros((self.n_slots, 1), dtype=torch.int64, device=self.device))
            if self._mu is None:
                self._mu = torch.full((self.n_slots,), 2.0 * self.device_sampling.mirostat_tau,
                                      dtype=torch.float32, device=self.device)
        n_past = np.array(self._sched_n_past, np.int64)
        window = min(_bucket(int(n_past.max()) + self.chunk + 1), self.n_ctx)
        sv = self._sv if self.per_request_sampling else None
        if self.forward_fn is not None:
            from .device_sample import decode_chunk

            out, _, _, self._key, self._recent, self._mu = decode_chunk(
                self.cfg, self.params, tok_dev, self._host_ints(n_past), self.cache_k,
                self.cache_v, self._key, n_steps=self.chunk, ds=self.device_sampling,
                kv_window=window, recent=self._recent, mu=self._mu, sv=sv,
                forward_fn=self.forward_fn)
        else:
            out, self._key, self._recent, self._mu = self.ctx.decode_chunk(
                tok_dev, self._host_ints(n_past), self._key, n_steps=self.chunk,
                ds=self.device_sampling, kv_window=window, recent=self._recent, mu=self._mu,
                sv=sv, to_host=False)
        snap = [(s.idx, s.req) for s in self.slots if s.active]
        self.n_ticks += 1
        self._inflight.append({"out_dev": out, **self._to_host(out=out), "snap": snap})
        for i, _ in snap:
            self._sched_n_past[i] += self.chunk
        if _TRACE:
            print(f"ENGINE_TRACE issue tick={self.n_ticks} window={window} "
                  f"active={len(snap)} t={time.perf_counter():.3f}", flush=True)

    def _harvest_one(self):
        """Wait for the oldest in-flight tick and emit its tokens.  Slots
        that finished at an earlier harvest are skipped (their later ticks
        decoded throwaway tokens: the price of the pipeline)."""
        t = self._inflight.pop(0)
        if t.get("kind") == "spec":
            self._harvest_spec(t)
            return
        h0 = time.perf_counter()
        self._wait(t)
        out = t["out"].numpy()  # [N, chunk]
        if _TRACE:
            print(f"ENGINE_TRACE harvest sync={time.perf_counter() - h0:.3f}s "
                  f"t={time.perf_counter():.3f}", flush=True)
        for idx, req in t["snap"]:
            s = self.slots[idx]
            if s.req is not req or req is None:
                continue
            done = False
            emit = []  # one queue put a (request, tick)
            for j in range(self.chunk):
                tok = int(out[idx, j])
                s.n_past += 1
                if tok == TOKEN_EOS:
                    done = True
                    break
                s.last_tokens.append(tok)
                s.produced += 1
                self.n_tokens_out += 1
                emit.append(tok)
                if req.stop_sequences and any(tuple(s.last_tokens[-len(ss):]) == ss
                                              for ss in req.stop_sequences if ss):
                    done = True
                    break
                if s.produced >= req.n_predict or s.n_past + self.chunk + 1 >= self.n_ctx:
                    done = True
                    break
            if emit:
                req.out.put(emit)
            if done:
                req.out.put(None)
                self.n_requests_done += 1
                s.req = None
                s.sampler = None

    def _flush_inflight(self):
        while self._inflight:
            self._harvest_one()
        for s in self.slots:
            self._sched_n_past[s.idx] = s.n_past

    def _resync_spec_state(self):
        """Rebuild the device histories from the slots after a stretch of
        plain chunked ticks (which do not keep them)."""
        hist = np.zeros((self.n_slots, self.n_ctx), np.int64)
        # an idle row holds one token: its frozen verify then writes at slot
        # 0 of its own cache row (JAX hands its scatter position -1 there,
        # which the per-row insert here would send to the row before)
        n_hist = np.ones((self.n_slots,), np.int64)
        done = np.ones((self.n_slots,), bool)
        for s in self.slots:
            if not s.active:
                continue
            lt = s.last_tokens
            assert len(lt) == s.n_past + 1 <= self.n_ctx, (len(lt), s.n_past)
            hist[s.idx, : len(lt)] = lt
            n_hist[s.idx] = len(lt)
            done[s.idx] = False
        self._hist = self._host_ints(hist)
        self._n_hist = self._host_ints(n_hist)
        self._done = torch.from_numpy(done).to(self.device)

    def _make_sv(self):
        from .device_sample import VEC_WINDOW, make_sampling_vec

        sv = make_sampling_vec([s.req.sampling if s.active else None for s in self.slots],
                               seeds=[s.req.seed if s.active else -1 for s in self.slots],
                               device=self.device)
        return dataclasses_replace_rln(sv, VEC_WINDOW)

    def _mirostat_active(self) -> bool:
        """Any active slot sampling with mirostat (per-request mode)."""
        return self.per_request_sampling and any(
            s.active and s.req.sampling is not None and s.req.sampling.mirostat
            for s in self.slots)

    def _issue_spec(self):
        """Issue one speculative tick without waiting: the histories, the
        caches and the frozen rows stay on the device, so ticks chain with
        no host work and the copy of tick t to the host overlaps tick t+1.
        The host's finish conditions lag a tick (their slots' extra tokens
        are dropped at the harvest)."""
        k = self.spec_draft
        start = max(len(s.last_tokens) for s in self.slots if s.active)
        # each tick in flight may have moved the frontier by chunk * (k + 1)
        start += len(self._inflight) * self.chunk * (k + 1)
        window = min(_bucket(start - 1 + self.chunk * (k + 1) + 1), self.n_ctx)
        sv = self._make_sv() if self.per_request_sampling else None
        (self._hist, self._n_hist, self._key, self._done, _eosed, emit_toks,
         emit_ns) = self.ctx.spec_chunk(
            self._hist, self._n_hist, self._key, self._done, sv, k=k, n_steps=self.chunk,
            ds=self.device_sampling, kv_window=window, max_ngram=self.spec.max_ngram,
            min_ngram=self.spec.min_ngram, eos=TOKEN_EOS, ignore_eos=False)
        self.n_ticks += 1
        self._inflight.append({
            "kind": "spec",
            **self._to_host(emit_toks=emit_toks, emit_ns=emit_ns, n_hist=self._n_hist,
                            done=self._done),
            "snap": [(s.idx, s.req) for s in self.slots if s.active],
        })

    def _harvest_spec(self, t):
        self._wait(t)
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
                self.n_spec_rounds += 1
                self.n_spec_drafted += self.spec_draft
                self.n_spec_accepted += max(0, int(ns_h[step, s.idx]) - 1)
                for tok in toks_h[step, s.idx, : int(ns_h[step, s.idx])].tolist():
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
                finished = True  # the device froze the row (EOS or the context's end)
            if finished:
                req.out.put(None)
                self.n_requests_done += 1
                s.req = None
                s.sampler = None
                freeze.append(s.idx)
        if freeze:
            self._done[self._host_ints(freeze)] = True

    def _tick(self):
        """One batched decode step over all active slots, sampled on the
        host: on the card a replay of the Context's tick graph."""
        self.n_ticks += 1
        toks = np.zeros((self.n_slots, 1), np.int64)
        n_past = np.zeros(self.n_slots, np.int64)
        for s in self.slots:
            if s.active:
                toks[s.idx, 0] = s.last_tokens[-1]
                n_past[s.idx] = s.n_past
        window = min(_bucket(int(n_past.max()) + 1), self.n_ctx)
        if self.forward_fn is not None:
            logits = self._fwd(self.cfg, self.params, self._host_ints(toks),
                               self._host_ints(n_past), self.cache_k, self.cache_v,
                               last_only=True, kv_window=window)
        else:
            logits = self.ctx._run(StepCall("tick", toks, n_past, None, self.params, "decode",
                                            last_only=True, kv_window=window))
        logits = logits.float().cpu().numpy()
        for s in self.slots:
            if not s.active:
                continue
            s.n_past += 1
            self._emit(s, logits[s.idx, -1])

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
            # never leave a client blocked on its queue: close every open
            # request, even when the thread dies on an exception (slots,
            # pending, and the inbox not yet drained)
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
                # an admission writes the caches: drain the pipeline first
                self._flush_inflight()
                self._admit()
                self._flush_inflight()  # resync _sched_n_past after it
            self._reap_cancelled()
            if self._prefill_state is not None:
                # one chunk a loop; ticks go on in between (the chunk writes a
                # detached row cache: no flush until the rows are written)
                self._continue_prefill()
            if any(s.active for s in self.slots):
                # mirostat is stateful a token: a verify's acceptance has no
                # defined mu stream, so mirostat batches take chunked ticks
                use_spec = (self.spec_draft > 0 and self.n_active <= self.spec_max_active
                            and not self._mirostat_active())
                if use_spec:
                    if self._mode != "spec":
                        self._flush_inflight()
                        self._resync_spec_state()
                        self._mode = "spec"
                    self._issue_spec()
                    if len(self._inflight) >= self.pipeline_depth:
                        self._harvest_one()
                elif self.chunk > 1 or self.spec_draft > 0:
                    if self._mode != "chunked":
                        for s in self.slots:
                            self._sched_n_past[s.idx] = s.n_past
                        self._mode = "chunked"
                    # two in flight: issue ahead, harvest one tick behind
                    self._issue_chunked()
                    if len(self._inflight) >= self.pipeline_depth:
                        self._harvest_one()
                else:
                    self._tick()
            elif self._inflight:
                self._flush_inflight()
        self._flush_inflight()
        for s in self.slots:  # close the open requests on shutdown
            if s.req is not None:
                s.req.out.put(None)
                s.req = None
        for r in self._pending:
            r.out.put(None)
        self._pending.clear()
