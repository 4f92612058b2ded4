"""Inference context: params + KV cache + the compiled step (the llama_context).

Holds the model params, preallocated KV buffers and n_past.  Prompt lengths
are padded up to the next bucket of ``PREFILL_BUCKETS``, and attention reads
only the first ``kv_window`` cache slots, with ``kv_window`` the bucket of
``n_past + t`` — the same shapes the JAX package compiles for.

As the JAX ``Context`` (without a mesh), it keeps two views of the params
that share their levels and scale planes: ``QMM_F16_SCALES=1`` first stores
the planes of the exact formats as float16 (``maybe_cast_scales_f16``), which
both views take; ``QMM_ZERO_FOLD=1`` then folds each symmetric pack zero into
a bias plane (``maybe_fold_zero_points``) in ``params``, the view of calls of
at most 32 tokens (decode-shaped), while ``_params_prefill`` keeps the
unfolded tensors for larger buckets.

The step is compiled as the JAX package compiles it.  JAX jits
``_eval_step`` and ``_embed_step`` once per static key, with ``n_past`` and
``last_index`` traced and the caches donated.  Here each key (``step_key``:
the step kind, the padded T, kv_window, last_only, slice_last, the attention
path, the params view and the routing switches of ``SWITCHES``) gets one
``torch.cuda.CUDAGraph`` on the card.  Its inputs are static tensors written
before each call (the tokens or embeddings, ``n_past`` and ``last_index``);
the caches are captured by address and written in place.  The first call of
a key runs the step eagerly, which also warms it up (kernels built, plans and
occupancy queries cached, cuBLAS handles made), then captures it; every later
call replays the graph.  A failed capture or replay raises.  On the CPU,
which the caller must ask for, the same step runs eagerly, uncaptured.

``decode_chunk`` is the JAX ``device_sample.decode_chunk`` jit: one decode
step with its sampling and its carry update (``device_sample.decode_step``)
is one graph, keyed by ``chunk_key``, whose carry (token, n_past, key,
recent window, mu, the step index and the [B, n_steps] tokens) lives in
static tensors; a chunk is n_steps replays back to back and one copy of the
tokens to the host.

The speculative steps are built the same way: ``verify`` (the JAX
``speculative._verify``: a T = k+1 forward sampling every position) is one
graph per key, and ``spec_chunk`` / ``draft_spec_chunk`` (the JAX
``device_spec`` scans) capture one draft-verify round and replay it n_steps
times, the draft model's forwards and caches inside the target's graph.

A Context over a mesh (``mesh=``) runs every one of these eagerly, each
forward through ``parallel/tp.py::mesh_forward`` on this rank's shards:
gloo's collectives are host calls, which a CUDA graph cannot hold.
"""

from __future__ import annotations

import functools
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from ..models import rwkv, transformer
from ..models.config import ModelConfig
from ..models.transformer import TransformerParams, init_cache
from ..ops.flash_prefill import flash_prefill
from ..ops.flash_prefill import launches as _flash_launches
from ..ops.kvcache import raw
from ..ops.layers import use_flash_prefill
from ..ops.mha_decode import launches as _mha_launches
from ..ops.qmm import launches as _qmm_launches
from ..ops.qtensor import maybe_cast_scales_f16, maybe_fold_zero_points
from . import device_sample

PREFILL_BUCKETS = (1, 8, 32, 64, 128, 256, 512, 1024, 2048)


def _bucket(n: int) -> int:
    for b in PREFILL_BUCKETS:
        if n <= b:
            return b
    return ((n + 2047) // 2048) * 2048


@dataclass
class Timings:
    """llama_print_timings counters."""

    t_load_ms: float = 0.0
    t_sample_ms: float = 0.0
    n_sample: int = 0
    t_prompt_ms: float = 0.0
    n_prompt: int = 0
    t_eval_ms: float = 0.0
    n_eval: int = 0

    def report(self) -> str:
        lines = [f"load time = {self.t_load_ms:10.2f} ms"]
        if self.n_sample:
            lines.append(
                f"sample time = {self.t_sample_ms:10.2f} ms / {self.n_sample} runs "
                f"({self.t_sample_ms / max(1, self.n_sample):8.2f} ms per token)")
        if self.n_prompt:
            lines.append(
                f"prompt eval time = {self.t_prompt_ms:10.2f} ms / {self.n_prompt} "
                f"tokens ({self.t_prompt_ms / max(1, self.n_prompt):8.2f} ms per token)")
        if self.n_eval:
            lines.append(
                f"eval time = {self.t_eval_ms:10.2f} ms / {self.n_eval} runs "
                f"({self.t_eval_ms / max(1, self.n_eval):8.2f} ms per token)")
        return "\n".join(lines)


# The environment switches the routing reads at call time (ops/qmatmul.py
# use_q8x and use_kfold; ops/layers.py use_fused_decode, use_flash_prefill and
# attention).  A graph replays the route of its capture, so their values
# enter its key.
SWITCHES = ("QMM_Q8X", "QMM_Q8X_MAX_B", "QMM_KFOLD", "QMM_KFOLD_MAX_B",
            "FUSED_ATTN", "FUSED_MAX_T", "FLASH_PREFILL", "ATTN_MXU")
# the kernel wrappers' launch counts: a replay runs no Python, so it adds
# what its capture would have added
LAUNCH_COUNTERS = (_qmm_launches, _flash_launches, _mha_launches)


def _eval_step(cfg, params, tokens, n_past, cache_k, cache_v, last_only,
               kv_window=None, last_index=None, slice_last=False,
               attention_fn=None):
    """The JAX ``_eval_step``: one forward; tokens may be raw embeddings."""
    return transformer.forward(
        cfg, params, tokens, n_past, cache_k, cache_v, last_only=last_only,
        kv_window=kv_window, last_index=last_index if slice_last else None,
        attention_fn=attention_fn)


def _embed_step(cfg, params, tokens, n_past, cache_k, cache_v):
    """The JAX ``_embed_step``: (logits, post-norm hidden state) over the
    whole cache."""
    return transformer.forward(cfg, params, tokens, n_past, cache_k, cache_v,
                               with_embedding=True)


def step_key(kind: str, t: int, kv_window, last_only: bool, slice_last: bool,
             attention_fn, view: str) -> tuple:
    """The graph key of a step: what its jit is keyed on in the JAX package
    (kind, padded T, kv_window, last_only, slice_last, the attention path,
    the params view), and the routing switches as the environment holds them
    now.  n_past and last_index are inputs, not keys."""
    return (kind, t, kv_window, last_only, slice_last,
            None if attention_fn is None else attention_fn.__name__, view,
            tuple(os.environ.get(name) for name in SWITCHES))


def chunk_key(n_steps: int, kv_window, ds, sv, recent_width: int, per_row: bool) -> tuple:
    """The graph key of a decode chunk: a one-token decode step's key, and
    what the JAX ``decode_chunk`` jit is keyed on besides (n_steps, the
    DeviceSampling value), the shapes of the SamplingVec's present fields,
    the recent window's width and whether n_past is 0-d or [B]."""
    return step_key("chunk", 1, kv_window, True, False, None, "decode") + (
        n_steps, ds, _sv_shapes(sv), recent_width, per_row)


def record_launches(counters, fn):
    """Run fn (a capture, which launches nothing) and return its result and
    what it added to each launch counter, with the counters put back as they
    were: a capture counts as no launch."""
    before = [dict(c) for c in counters]
    try:
        out = fn()
        delta = [{k: c[k] - b[k] for k in c} for c, b in zip(counters, before)]
    finally:
        for c, b in zip(counters, before):
            c.update(b)
    return out, delta


def add_launches(counters, delta, times: int = 1):
    """What `times` replays launch, added to the counters."""
    for c, d in zip(counters, delta):
        for k, v in d.items():
            c[k] += v * times


@dataclass
class StepCall:
    """One step as the Context runs it: the host input (padded tokens
    [B, T] int64, or embeddings [B, T, E] f32), n_past, the kept row of a
    bucket-padded prompt (None unless slice_last), the params view and the
    step's static arguments.  ``transformer.forward`` of these, eagerly, is
    the step's reference.  A "tick" (the serving engine's batched decode
    step) takes n_past as a [B] int64 array, a position per row."""
    kind: str  # "eval", "eval_embd", "embed" or "tick"
    x: np.ndarray
    n_past: int | np.ndarray
    last_index: int | None
    params: TransformerParams
    view: str  # "decode" (Context.params) or "prefill" (_params_prefill)
    last_only: bool = False
    kv_window: int | None = None
    attention_fn: object = None
    key: tuple = field(init=False)  # taken when the call is made

    def __post_init__(self):
        self.key = step_key(self.kind, self.x.shape[1], self.kv_window, self.last_only,
                            self.last_index is not None, self.attention_fn, self.view)


class _Graph:
    """A key's graph on the card, what its capture recorded and its replays."""

    def __init__(self):
        self.graph = self.out = self.launches = None
        self.capture_ms = 0.0
        self.pool_bytes = 0
        self.replays = 0


class _Step(_Graph):
    """The static inputs of one key, and on the card its graph.  The input,
    n_past and last_index live at fixed addresses and are written before
    each call: the input (and a per-row n_past) through pinned staging
    tensors (asynchronous copies), the scalars by fills on the device."""

    def __init__(self, call: StepCall, device: torch.device):
        super().__init__()
        x = call.x
        dtype = torch.from_numpy(x).dtype
        self.x = torch.zeros(x.shape, dtype=dtype, device=device)
        self.n_past = torch.zeros(np.shape(call.n_past), dtype=torch.int64, device=device)
        self.last_index = torch.zeros((), dtype=torch.int64, device=device)
        pinned = device.type == "cuda"
        self.staging = torch.empty(x.shape, dtype=dtype, pin_memory=pinned)
        self.staging_n_past = torch.empty(self.n_past.shape, dtype=torch.int64,
                                          pin_memory=pinned)
        # the last copy out of the staging tensors, which must be done before
        # they are written again
        self.copied = torch.cuda.Event() if pinned else None

    def load(self, call: StepCall):
        if self.copied is not None:
            self.copied.synchronize()
        self.staging.copy_(torch.from_numpy(call.x))
        self.x.copy_(self.staging, non_blocking=True)
        if self.n_past.dim():
            self.staging_n_past.copy_(torch.from_numpy(np.asarray(call.n_past, np.int64)))
            self.n_past.copy_(self.staging_n_past, non_blocking=True)
        else:
            self.n_past.fill_(call.n_past)
        if self.copied is not None:
            self.copied.record()
        self.last_index.fill_(call.last_index or 0)


class _Carry(_Graph):
    """The static tensors of a chunk's or a verify's key, by name (inputs,
    the carry each call writes back, outputs) and a SamplingVec's present
    fields: fixed addresses the graph reads and writes, loaded by copies on
    the device before a call."""

    def __init__(self, sv=None, **tensors):
        super().__init__()
        for name, t in tensors.items():
            setattr(self, name, t.clone())
        self.sv = None if sv is None else device_sample.SamplingVec(
            **{k: t.clone() for k, t in sv.present().items()})

    def load(self, sv=None, **tensors):
        for name, t in tensors.items():
            getattr(self, name).copy_(t)
        if sv is not None:
            for k, t in sv.present().items():
                getattr(self.sv, k).copy_(t)


def _sv_shapes(sv):
    return None if sv is None else tuple((name, tuple(t.shape))
                                         for name, t in sv.present().items())


class _Captures:
    """The graphs of a context on the card: each key's step captured once
    into one shared memory pool (``_pool``) and replayed (``_steps``)."""

    def _capture(self, st: _Graph, fn):
        """Capture fn (a step) on a side stream into the shared pool.
        Capture runs no kernel, so the caches keep what the eager call
        wrote."""
        with torch.cuda.device(self.device):
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_stats()["reserved_bytes.all.current"]
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()

            def capture():
                with torch.cuda.graph(graph, pool=self._pool):
                    return fn()

            st.out, st.launches = record_launches(LAUNCH_COUNTERS, capture)
            st.capture_ms = (time.perf_counter() - t0) * 1e3
            st.pool_bytes = (torch.cuda.memory_stats()["reserved_bytes.all.current"]
                             - reserved)
            st.graph = graph

    def graphs(self) -> list[dict]:
        """Each captured step: its key, capture ms, the bytes its capture
        added to the card's reserved memory (the shared pool's growth) and
        its replays so far."""
        return [{"key": key, "capture_ms": st.capture_ms,
                 "pool_bytes": st.pool_bytes, "replays": st.replays}
                for key, st in self._steps.items() if st.graph is not None]

    def _rounds(self, st: _Graph, fn, n: int):
        """n calls of fn (a step that writes its results into st's static
        tensors) on the card: the first call of a key runs eagerly (the
        warm-up) and is captured; every other call is a replay."""
        left = n
        if st.graph is None:
            fn()
            self._capture(st, fn)
            left -= 1
        for _ in range(left):
            st.graph.replay()
        st.replays += left
        add_launches(LAUNCH_COUNTERS, st.launches, left)

    def _spec_rounds(self, gkey, hist, n_hist, key, done, sv, *, k: int, n_steps: int,
                     round_fn):
        """n_steps speculative rounds on the card: one round captured under
        gkey and replayed.  round_fn(carry, sv, h) is the round
        (``device_spec.spec_round`` or ``rwkv_spec_round`` on the context's
        caches or state): carry is (hist [B, H + k + 1], n_hist, key, done,
        eosed), read from and written back to the key's static tensors.
        Returns device tensors (hist, n_hist, key, done, eosed, emit_toks
        [n_steps, B, k+1], emit_ns [n_steps, B])."""
        from . import device_spec

        b, h = hist.shape
        carry = dict(hist=device_spec.pad_hist(hist, k), m=n_hist.to(torch.int64), key=key,
                     done=done, eosed=torch.zeros_like(done))
        st = self._steps.get(gkey)
        if st is None:
            st = self._steps[gkey] = _Carry(
                sv, **carry, step=torch.zeros((), dtype=torch.int64, device=self.device),
                toks=torch.zeros((n_steps, b, k + 1), dtype=torch.int64, device=self.device),
                ns=torch.zeros((n_steps, b), dtype=torch.int64, device=self.device))
        else:
            st.load(sv, **carry)
            st.step.zero_()
        names = tuple(carry)

        def step():
            new, (emit, emit_n) = round_fn(tuple(getattr(st, n) for n in names), st.sv, h)
            for n, src in zip(names, new):
                getattr(st, n).copy_(src)
            st.toks.index_copy_(0, st.step.reshape(1), emit[None])
            st.ns.index_copy_(0, st.step.reshape(1), emit_n[None])
            st.step.add_(1)

        self.last_chunk = st
        self._rounds(st, step, n_steps)
        return (st.hist[:, :h].clone(), st.m.clone(), st.key.clone(), st.done.clone(),
                st.eosed.clone(), st.toks.clone(), st.ns.clone())


class Context(_Captures):
    """One generation run over a loaded model: KV cache, n_past, timings."""

    def __init__(self, cfg: ModelConfig, params: TransformerParams, *,
                 batch: int = 1, n_ctx: int | None = None,
                 cache_dtype=torch.bfloat16, device=None, views=None, mesh=None):
        """device defaults to cuda and raises without CUDA unless "cpu" is
        asked for; params must already lie on it (models.loading).  views:
        the (decode, prefill) params views when the caller has made them
        already (the serving engine); params is then not read.

        mesh (parallel.make_mesh, over a torch.distributed world): a session
        across ranks, each rank a process that makes this Context with the
        same arguments and makes the same calls.  The params shard over tp
        (parallel/tp.py ``prepare_tp_params``) when tp > 1 and are
        replicated otherwise, in one raw view (no f16 cast, no zero fold);
        each rank's device is the mesh's.  The KV cache shards per
        ``parallel.shard.cache_spec``: the batch over dp, the context over
        sp (the context then grows with the ranks), the heads over tp.  A
        whole-prompt prefill on an sp mesh rides ring attention, each sp
        rank running its T/sp tokens through the layers; a decode step
        attends on each rank to the slots it holds and merges the partials
        (parallel/tp.py ``mesh_forward``).  A mesh step runs eagerly, not as
        a captured graph: gloo's collectives are host calls.  Every method
        runs over a mesh: eval, eval_embd and embed, and decode_chunk,
        verify, spec_chunk and draft_spec_chunk as their eager loops with
        ``mesh_forward`` as the forward (``_forward_fn``); the session
        functions and perplexity_ondevice of runtime/ take a mesh Context
        too.

        Sampling over a mesh: every rank draws from the same key, and every
        rank's logits are the same bits (the tp and dp all-gathers hand each
        rank the same bytes, and the sp partials merge in rank order on
        each), so every rank draws the same tokens, the same penalty window
        and the same mirostat mu, at any temperature; nothing is
        broadcast."""
        self.mesh = mesh
        self.cfg = cfg
        if mesh is not None:
            from ..parallel.shard import replicate
            from ..parallel.tp import prepare_tp_params

            self.device = mesh.device
            params = (prepare_tp_params(params, mesh, cfg) if mesh.shape["tp"] > 1
                      else replicate(params, mesh))
            views = (params, params)
        else:
            self.device = resolve_device(device)
        if views is None:
            # cast before the fold, so that both views share the cast planes
            # and the folded bias takes their dtype (JAX context.py)
            params = maybe_cast_scales_f16(params)
            views = (maybe_fold_zero_points(params), params)
        self.params, self._params_prefill = views
        self.n_ctx = n_ctx or cfg.n_ctx
        self.batch = batch
        # captured by address in every graph: written in place, never
        # reassigned
        if mesh is not None:
            from ..parallel.shard import local_cache

            self.cache_k, self.cache_v = local_cache(cfg, batch, self.n_ctx, cache_dtype, mesh)
        else:
            self.cache_k, self.cache_v = init_cache(cfg, batch, self.n_ctx,
                                                    cache_dtype, self.device)
        self.n_past = 0
        self.timings = Timings()
        self._logits = None
        self._steps: dict[tuple, _Step] = {}
        self._pool = None
        self.last_call: StepCall | None = None
        self.last_chunk: _Carry | None = None  # the carry of the last chunk on the card

    def reset(self):
        for c in (*self.cache_k, *self.cache_v):
            if isinstance(c, torch.Tensor):
                raw(c).zero_()
            else:
                c.data.zero_()
                c.scale.zero_()
        self.n_past = 0

    def _view(self, t: int):
        """Decode-shaped calls take the folded view, larger ones the raw one."""
        return (self.params, "decode") if t <= 32 else (self._params_prefill, "prefill")

    def _check(self, b: int, t: int):
        if b != self.batch:
            raise ValueError(f"batch {b} != context batch {self.batch}")
        if self.n_past + t > self.n_ctx:
            raise ValueError("context overflow")

    def _padded(self, tokens) -> tuple[np.ndarray, int]:
        tokens = np.atleast_2d(np.asarray(tokens, dtype=np.int64))
        b, t = tokens.shape
        self._check(b, t)
        padded = np.zeros((b, _bucket(t)), dtype=np.int64)
        padded[:, :t] = tokens
        return padded, t

    def _run(self, call: StepCall):
        """The step's outputs on the device.  On the card they are the
        graph's static outputs, valid until the next call of this Context:
        every graph shares one memory pool, so callers copy them to the host
        before the next replay (each public method does)."""
        self.last_call = call
        if self.mesh is not None:
            return self._mesh_step(call)
        st = self._steps.get(call.key)
        if st is None:
            st = self._steps[call.key] = _Step(call, self.device)
        st.load(call)
        if self.device.type != "cuda":  # the caller asked for the CPU
            return self._step(call, st)
        if st.graph is None:
            out = self._step(call, st)  # eager: the warm-up, and this call's result
            self._capture(st, lambda: self._step(call, st))
            return out
        st.graph.replay()
        st.replays += 1
        add_launches(LAUNCH_COUNTERS, st.launches)
        return st.out

    def _step(self, call: StepCall, st: _Step):
        if call.kind == "embed":
            return _embed_step(self.cfg, call.params, st.x, st.n_past,
                               self.cache_k, self.cache_v)
        return _eval_step(self.cfg, call.params, st.x, st.n_past, self.cache_k,
                          self.cache_v, call.last_only, kv_window=call.kv_window,
                          last_index=st.last_index,
                          slice_last=call.last_index is not None,
                          attention_fn=call.attention_fn)

    @torch.no_grad()
    def _mesh_step(self, call: StepCall):
        """A step over the mesh, eagerly (parallel/tp.py mesh_forward)."""
        from ..parallel.tp import mesh_forward

        x = torch.from_numpy(np.ascontiguousarray(call.x)).to(self.device)
        n_past = (call.n_past if np.ndim(call.n_past) == 0
                  else torch.from_numpy(np.asarray(call.n_past, np.int64)).to(self.device))
        kw = dict(dp_rows=True, sp_cache=self.mesh.shape["sp"] > 1)
        if call.kind == "embed":
            return mesh_forward(self.cfg, call.params, x, n_past, self.cache_k, self.cache_v,
                                self.mesh, with_embedding=True, **kw)
        return mesh_forward(self.cfg, call.params, x, n_past, self.cache_k, self.cache_v,
                            self.mesh, last_only=call.last_only, kv_window=call.kv_window,
                            last_index=call.last_index, attention_fn=call.attention_fn, **kw)

    @property
    def _eager(self) -> bool:
        """Whether the loops run eagerly: on the CPU (which the caller asked
        for) and over a mesh (gloo's collectives are host calls)."""
        return self.device.type != "cuda" or self.mesh is not None

    def _forward_fn(self):
        """The forward of this Context's eager loops: ``mesh_forward`` on
        this rank's params and caches over a mesh (the caches hold its dp
        rows and its sp block of slots), None (transformer.forward)
        without one."""
        if self.mesh is None:
            return None
        from ..parallel.tp import mesh_forward

        return functools.partial(mesh_forward, mesh=self.mesh, dp_rows=True,
                                 sp_cache=self.mesh.shape["sp"] > 1)

    def _draft_forward_fn(self, draft: "Context"):
        """The draft's forward in draft_spec_chunk.  Over a mesh the draft
        is a Context on the same mesh (its own sharded forward) or a
        single-device Context on the mesh's device, which every rank runs
        whole; any other placement is refused."""
        if draft.mesh is None:
            if self.mesh is not None and draft.device != self.device:
                raise ValueError(f"the draft Context is on {draft.device}; a draft of a mesh "
                                 f"Context runs on the mesh's device {self.device} or on the "
                                 "mesh itself")
            return None
        if draft.mesh is not self.mesh:
            raise ValueError(f"the draft Context is on the mesh {draft.mesh.shape}; the "
                             f"target is on {None if self.mesh is None else self.mesh.shape}: "
                             "a sharded draft must share the target's mesh")
        return draft._forward_fn()

    @torch.no_grad()
    def decode_chunk(self, tok, n_past, key, *, n_steps: int,
                     ds: "device_sample.DeviceSampling", kv_window: int | None = None,
                     recent=None, mu=None, sv=None, to_host: bool = True):
        """``device_sample.decode_chunk`` on this Context's params (the
        decode view) and caches: n_steps tokens from tok [B] (a device
        tensor) at n_past (an int, or a [B] int64 tensor, a position per
        row), sampled on the device.  ctx.n_past is left to the caller, as
        the JAX ``generate_ondevice`` advances it.  Returns (tokens [B,
        n_steps] as a host array, key, recent, mu); the last three are
        device tensors of their own.  With to_host=False the tokens stay on
        the device too, in a tensor of their own: nothing waits for the
        chunk (the serving engine's pipelined ticks).

        On the card the chunk is n_steps replays of one captured step (the
        first call of a key runs its first step eagerly, then captures), and
        the tokens are copied to the host once.  On the CPU and over a mesh
        it is the eager loop."""
        carry = device_sample.chunk_carry(tok, n_past, key, recent, mu, ds, sv)
        if carry[1].dim() == 0 and int(n_past) + n_steps > self.n_ctx:
            raise ValueError("context overflow")
        t0 = time.perf_counter()
        if self._eager:
            tok, n_past, key, recent, mu = carry
            toks, _, _, key, recent, mu = device_sample.decode_chunk(
                self.cfg, self.params, tok, n_past, self.cache_k, self.cache_v, key,
                n_steps=n_steps, ds=ds, kv_window=kv_window, recent=recent, mu=mu, sv=sv,
                forward_fn=self._forward_fn())
            out = (toks.cpu().numpy() if to_host else toks, key, recent, mu)
        else:
            out = self._chunk(carry, sv, n_steps, ds, kv_window, to_host)
        self.timings.t_eval_ms += (time.perf_counter() - t0) * 1e3
        self.timings.n_eval += n_steps
        return out

    def _chunk(self, carry, sv, n_steps, ds, kv_window, to_host=True):
        """A chunk on the card: the key's graph replayed n_steps times."""
        key = chunk_key(n_steps, kv_window, ds, sv, carry[3].shape[1], carry[1].dim() == 1)
        state = dict(zip(("tok", "n_past", "key", "recent", "mu"), carry))
        ch = self._steps.get(key)
        if ch is None:
            dev = carry[0].device
            ch = self._steps[key] = _Carry(
                sv, **state, step=torch.zeros((), dtype=torch.int64, device=dev),
                toks=torch.zeros((carry[0].shape[0], n_steps), dtype=torch.int64, device=dev))
        else:
            ch.load(sv, **state)
            ch.step.zero_()

        def step():
            nxt, n_past, k, recent, mu = device_sample.decode_step(
                self.cfg, self.params, ch.tok, ch.n_past, self.cache_k, self.cache_v,
                ch.key, ch.recent, ch.mu, ds=ds, kv_window=kv_window, sv=ch.sv)
            ch.toks.index_copy_(1, ch.step.reshape(1), nxt[:, None])
            for dst, src in ((ch.tok, nxt), (ch.n_past, n_past), (ch.key, k),
                             (ch.recent, recent), (ch.mu, mu)):
                dst.copy_(src)
            ch.step.add_(1)

        self.last_chunk = ch
        self._rounds(ch, step, n_steps)
        toks = ch.toks.cpu().numpy() if to_host else ch.toks.clone()
        return (toks, ch.key.clone(), ch.recent.clone(), ch.mu.clone())

    @torch.no_grad()
    def verify(self, tokens, n_past: int, key, recent=None, *,
               ds: "device_sample.DeviceSampling", kv_window: int):
        """The speculative verify (``speculative.verify_step``, the JAX
        ``_verify``) on this Context's params (the decode view) and caches:
        forward tokens [B, T] (host ints) at n_past and sample every
        position.  recent [B, N] is the penalty window (make_recent), needed
        when ds has penalties.  ctx.n_past is left to the caller.  Returns
        (ids [B, T] as a host array, the carried key on the device).

        On the card one graph per key (T, kv_window, ds, the window's
        width), replayed with the tokens, n_past, key and window as static
        inputs; the ids are the call's one copy to the host.  On the CPU
        and over a mesh it runs eagerly."""
        from .speculative import verify_step

        x = torch.from_numpy(np.atleast_2d(np.asarray(tokens, dtype=np.int64))).to(self.device)
        b, t = x.shape
        if b != self.batch or n_past + t > self.n_ctx:
            raise ValueError(f"a [{b}, {t}] verify at n_past {n_past} does not fit the context")
        if ds.penalized and recent is None:
            raise ValueError("ds has penalties: pass `recent` (make_recent)")
        t0 = time.perf_counter()
        if self._eager:
            ids, key = verify_step(self.cfg, self.params, x, n_past, self.cache_k, self.cache_v,
                                   key, recent, ds=ds, kv_window=kv_window,
                                   forward_fn=self._forward_fn())
        else:
            if recent is None:
                recent = torch.zeros((b, 1), dtype=torch.int64, device=self.device)  # unused
            gkey = step_key("verify", t, kv_window, False, False, None, "decode") + (
                ds, recent.shape[1])
            state = dict(x=x, n_past=torch.full((), n_past, dtype=torch.int64,
                                                device=self.device),
                         key=key, recent=recent)
            st = self._steps.get(gkey)
            if st is None:
                st = self._steps[gkey] = _Carry(**state, ids=x, key_out=key)
            else:
                st.load(**state)

            def step():
                ids, k = verify_step(self.cfg, self.params, st.x, st.n_past, self.cache_k,
                                     self.cache_v, st.key, st.recent if ds.penalized else None,
                                     ds=ds, kv_window=kv_window)
                st.ids.copy_(ids)
                st.key_out.copy_(k)

            self._rounds(st, step, 1)
            ids, key = st.ids, st.key_out.clone()
        ids = ids.cpu().numpy()
        self.timings.t_eval_ms += (time.perf_counter() - t0) * 1e3
        self.timings.n_eval += 1
        return ids, key

    @torch.no_grad()
    def spec_chunk(self, hist, n_hist, key, done, sv=None, *, k: int, n_steps: int,
                   ds: "device_sample.DeviceSampling", kv_window: int, max_ngram: int,
                   min_ngram: int, eos: int, ignore_eos: bool):
        """``device_spec.spec_chunk`` on this Context's params (the decode
        view) and caches: n_steps prompt-lookup draft-verify rounds from the
        device histories hist [B, H] with lengths n_hist [B] and frozen rows
        done [B].  Returns device tensors (hist, n_hist, key, done, eosed,
        emit_toks [n_steps, B, k+1], emit_ns [n_steps, B]); ctx.n_past is
        left to the caller.

        On the card a round is one graph (``device_spec.spec_round``), keyed
        by the verify's T and kv_window, n_steps, the sampling and the
        lookup's settings, replayed n_steps times over static carry tensors;
        the caches are written in place.  On the CPU and over a mesh it is
        the eager loop."""
        from . import device_spec

        static = dict(k=k, ds=ds, kv_window=kv_window, max_ngram=max_ngram,
                      min_ngram=min_ngram, eos=eos, ignore_eos=ignore_eos)
        t0 = time.perf_counter()
        if self._eager:
            hist, n_hist, _, _, key, done, eosed, toks, ns = device_spec.spec_chunk(
                self.cfg, self.params, hist, n_hist, self.cache_k, self.cache_v, key, done,
                sv, n_steps=n_steps, forward_fn=self._forward_fn(), **static)
            out = (hist, n_hist, key, done, eosed, toks, ns)
        else:
            gkey = step_key("spec", k + 1, kv_window, False, False, None, "decode") + (
                n_steps, ds, _sv_shapes(sv), hist.shape[1], k, max_ngram, min_ngram, eos,
                ignore_eos)
            out = self._spec_rounds(
                gkey, hist, n_hist, key, done, sv, k=k, n_steps=n_steps,
                round_fn=lambda carry, sv_, h: device_spec.spec_round(
                    self.cfg, self.params, carry, self.cache_k, self.cache_v, sv_, h=h,
                    **static))
        self.timings.t_eval_ms += (time.perf_counter() - t0) * 1e3
        self.timings.n_eval += n_steps
        return out

    @torch.no_grad()
    def draft_spec_chunk(self, draft: "Context", tok, n_past, key, done, recent, *, k: int,
                         n_steps: int, ds: "device_sample.DeviceSampling", kv_window: int,
                         eos: int, ignore_eos: bool):
        """``device_spec.draft_spec_chunk`` with this Context as the target
        and ``draft`` as the draft model (the decode views; both caches
        written in place): n_steps rounds of k+1 greedy draft steps and one
        verify from tok, n_past, done [B] and the penalty window recent [B,
        N].  Returns device tensors (tok, n_past, key, done, recent,
        emit_toks [n_steps, B, k+1], emit_ns [n_steps, B]); both Contexts'
        n_past are left to the caller.

        On the card a round (``device_spec.draft_round``: k+1 draft forwards
        and the target's verify) is one graph in this Context's pool over
        both Contexts' caches, keyed as spec_chunk's and by the draft
        Context, replayed n_steps times.  On the CPU and over a mesh it is
        the eager loop; a mesh Context's draft is a Context on the same
        mesh or a single-device Context on the mesh's device, which every
        rank runs whole (``_draft_forward_fn``)."""
        from . import device_spec

        draft_fn = self._draft_forward_fn(draft)
        static = dict(k=k, ds=ds, kv_window=kv_window, eos=eos, ignore_eos=ignore_eos,
                      cap=min(self.n_ctx, draft.n_ctx))
        t0 = time.perf_counter()
        if self._eager:
            tok, n_past, _, _, _, _, key, done, recent, toks, ns = device_spec.draft_spec_chunk(
                self.cfg, self.params, draft.cfg, draft.params, tok, n_past, self.cache_k,
                self.cache_v, draft.cache_k, draft.cache_v, key, done, recent,
                n_steps=n_steps, forward_fn=self._forward_fn(), draft_forward_fn=draft_fn,
                **static)
            out = (tok, n_past, key, done, recent, toks, ns)
        else:
            b = tok.shape[0]
            gkey = step_key("draft_spec", k + 1, kv_window, False, False, None, "decode") + (
                n_steps, ds, recent.shape[1], k, eos, ignore_eos, id(draft))
            state = dict(tok=tok, n_past=n_past.to(torch.int64), key=key, done=done,
                         recent=recent)
            st = self._steps.get(gkey)
            if st is None:
                st = self._steps[gkey] = _Carry(
                    **state, step=torch.zeros((), dtype=torch.int64, device=self.device),
                    toks=torch.zeros((n_steps, b, k + 1), dtype=torch.int64, device=self.device),
                    ns=torch.zeros((n_steps, b), dtype=torch.int64, device=self.device))
                st.draft = draft  # the graph holds its caches: keep it (and its id) alive
            else:
                st.load(**state)
                st.step.zero_()
            names = ("tok", "n_past", "key", "done", "recent")

            def step():
                new, (emit, emit_n) = device_spec.draft_round(
                    self.cfg, self.params, draft.cfg, draft.params,
                    tuple(getattr(st, n) for n in names), self.cache_k, self.cache_v,
                    draft.cache_k, draft.cache_v, **static)
                for n, src in zip(names, new):
                    getattr(st, n).copy_(src)
                st.toks.index_copy_(0, st.step.reshape(1), emit[None])
                st.ns.index_copy_(0, st.step.reshape(1), emit_n[None])
                st.step.add_(1)

            self.last_chunk = st
            self._rounds(st, step, n_steps)
            out = tuple(getattr(st, n).clone() for n in names + ("toks", "ns"))
        self.timings.t_eval_ms += (time.perf_counter() - t0) * 1e3
        self.timings.n_eval += n_steps
        return out

    def eval(self, tokens, *, logits_all: bool = False) -> np.ndarray:
        """Evaluate tokens (list or [B, T] array) after the current n_past.
        Returns host f32 logits: [B, T, V] if logits_all else [B, 1, V]."""
        padded, t = self._padded(tokens)
        bt = padded.shape[1]
        t0 = time.perf_counter()
        attn_fn = None
        sp = self.mesh.shape["sp"] if self.mesh is not None else 1
        if sp > 1 and self.n_past == 0 and t > 1 and bt % sp == 0:
            from ..parallel.ring_attention import ring_prefill_fn

            attn_fn = ring_prefill_fn(self.mesh)
        elif (self.n_past == 0 and t > 1
                and use_flash_prefill(bt, self.cfg.head_dim, self.device)):
            attn_fn = flash_prefill
        slice_last = not logits_all and bt != t
        # an empty call (main's bare Enter) keeps row 0, the padding token's:
        # JAX's dynamic_slice clamps its index -1 to 0
        logits = self._run(StepCall(
            "eval", padded, self.n_past, max(t - 1, 0) if slice_last else None,
            *self._view(bt), last_only=not (logits_all or bt != t),
            kv_window=min(_bucket(self.n_past + t), self.n_ctx),
            attention_fn=attn_fn))
        if logits.shape[1] > 1:
            logits = logits[:, :t]
        logits = logits.float().cpu().numpy()
        dt = (time.perf_counter() - t0) * 1e3
        if t > 1:
            self.timings.t_prompt_ms += dt
            self.timings.n_prompt += t
        else:
            self.timings.t_eval_ms += dt
            self.timings.n_eval += 1
        self.n_past += t
        self._logits = logits
        return logits

    @property
    def logits(self) -> np.ndarray:
        return self._logits

    def eval_embd(self, embeddings, *, logits_all: bool = False) -> np.ndarray:
        """Evaluate raw input embeddings [B, T, n_embd] (llama_eval_embd, the
        embd-input entry point).  No bucket padding: callers control T
        exactly, and T keys the graph.  Returns host f32 logits of the last
        token [B, 1, V], or of every token with logits_all."""
        emb = np.array(embeddings, dtype=np.float32, order="C")  # a copy of its own
        if emb.ndim != 3 or emb.shape[2] != self.cfg.n_embd:
            raise ValueError(f"embeddings {emb.shape} are not [B, T, {self.cfg.n_embd}]")
        b, t, _ = emb.shape
        self._check(b, t)
        logits = self._run(StepCall(
            "eval_embd", emb, self.n_past, None, *self._view(t),
            last_only=not logits_all,
            kv_window=min(_bucket(self.n_past + t), self.n_ctx)))
        self.n_past += t
        self._logits = logits.float().cpu().numpy()
        return self._logits

    def embed(self, tokens) -> np.ndarray:
        """Evaluate tokens and return the final-norm hidden state of the last
        token [B, n_embd] (llama_get_embeddings).  The step attends over the
        whole cache and keeps every row, as the JAX ``_embed_step``; the
        logits of the real tokens stay in ``logits``."""
        padded, t = self._padded(tokens)
        logits, emb = self._run(StepCall("embed", padded, self.n_past, None,
                                         *self._view(padded.shape[1])))
        self.n_past += t
        self._logits = logits[:, :t].float().cpu().numpy()
        return emb[:, t - 1].float().cpu().numpy()


# the routing switches an RWKV step reads (ops/qmatmul.py use_q8x and
# use_kfold): it has no attention
RWKV_SWITCHES = SWITCHES[:4]


def rwkv_step_key(t: int, last_only: bool, view: str) -> tuple:
    """The graph key of an RWKV step: the padded T, last_only, the params
    view and the routing switches as the environment holds them now, in
    step_key's places (a recurrence has no kv_window).  The tokens and the
    valid mask are inputs, not keys."""
    return ("rwkv", t, None, last_only, view,
            tuple(os.environ.get(n) for n in RWKV_SWITCHES))


@dataclass
class RwkvCall:
    """One RWKV step as RwkvContext runs it: the padded tokens [B, T] int64,
    the valid mask [B, T], the params view and last_only.
    ``rwkv.forward`` of these, eagerly, on the state before the step is the
    step's reference."""
    x: np.ndarray
    valid: np.ndarray
    params: object
    view: str  # "decode" (RwkvContext.params) or "prefill" (_params_prefill)
    last_only: bool
    key: tuple = field(init=False)  # taken when the call is made

    def __post_init__(self):
        self.key = rwkv_step_key(self.x.shape[1], self.last_only, self.view)


class _RwkvStep(_Graph):
    """The static tokens and valid mask of one RWKV key (written through
    pinned staging tensors before each call), and on the card its graph."""

    def __init__(self, call: RwkvCall, device: torch.device):
        super().__init__()
        pinned = device.type == "cuda"
        self.x = torch.zeros(call.x.shape, dtype=torch.int64, device=device)
        self.valid = torch.zeros(call.valid.shape, dtype=torch.bool, device=device)
        self.staging = torch.empty(call.x.shape, dtype=torch.int64, pin_memory=pinned)
        self.staging_valid = torch.empty(call.valid.shape, dtype=torch.bool, pin_memory=pinned)
        self.copied = torch.cuda.Event() if pinned else None

    def load(self, call: RwkvCall):
        if self.copied is not None:
            self.copied.synchronize()
        self.staging.copy_(torch.from_numpy(call.x))
        self.staging_valid.copy_(torch.from_numpy(call.valid))
        self.x.copy_(self.staging, non_blocking=True)
        self.valid.copy_(self.staging_valid, non_blocking=True)
        if self.copied is not None:
            self.copied.record()


class RwkvContext(_Captures):
    """The recurrent counterpart of Context (the reference's rwkv_context):
    the RWKV state takes the KV cache's place.  A recurrence has no context
    limit, so n_ctx and n_past are kept only for Context's interface.

    As the JAX ``RwkvContext``: prompts are padded to the bucket of their
    length with a valid mask (a padded step carries the state through), and
    calls of at most 32 padded tokens take the folded params view, larger
    ones the raw prefill view.  On the card every ``eval`` is one CUDA graph
    per key (``rwkv_step_key``), captured on its first call after an eager
    run, with the tokens and the mask as static inputs; the five state
    tensors are held by address, so each step writes its new state into them
    with ``copy_`` and ``reset`` / ``set_state`` write into them too.  On the
    CPU, which the caller must ask for, the same step runs eagerly."""

    def __init__(self, cfg: ModelConfig, params, *, batch: int = 1, n_ctx: int | None = None,
                 device=None, views=None):
        """device defaults to cuda and raises without CUDA unless "cpu" is
        asked for; params must already lie on it (models.loading.load_rwkv).
        views: the (decode, prefill) params views when the caller has made
        them already (the serving engine); params is then not read."""
        self.device = resolve_device(device)
        self.cfg = cfg
        if views is None:
            params = maybe_cast_scales_f16(params)
            views = (maybe_fold_zero_points(params), params)
        self.params, self._params_prefill = views
        self.batch = batch
        self.n_ctx = n_ctx or 1 << 30
        # captured by address in every graph: written in place, never rebound
        self.state = rwkv.init_state(cfg, batch, self.device)
        self.n_past = 0
        self.timings = Timings()
        self._logits = None
        self._steps: dict[tuple, _Graph] = {}
        self._pool = None
        self.last_call: RwkvCall | None = None
        self.last_chunk: _Carry | None = None

    def reset(self):
        for k, t in self.state.items():
            t.fill_(-1e30 if k == "maxv" else 0.0)
        self.n_past = 0

    def _run(self, call: RwkvCall):
        """The step's logits on the device (on the card the graph's static
        output, valid until the next call)."""
        self.last_call = call
        st = self._steps.get(call.key)
        if st is None:
            st = self._steps[call.key] = _RwkvStep(call, self.device)
        st.load(call)
        if self.device.type != "cuda":  # the caller asked for the CPU
            return self._step(call, st)
        if st.graph is None:
            out = self._step(call, st)  # eager: the warm-up, and this call's result
            self._capture(st, lambda: self._step(call, st))
            return out
        st.graph.replay()
        st.replays += 1
        add_launches(LAUNCH_COUNTERS, st.launches)
        return st.out

    def _step(self, call: RwkvCall, st: _RwkvStep):
        logits, new = rwkv.forward(self.cfg, call.params, st.x, self.state, valid=st.valid,
                                   last_only=call.last_only)
        for k, t in self.state.items():
            t.copy_(new[k])
        return logits

    @torch.no_grad()
    def eval(self, tokens, *, logits_all: bool = False) -> np.ndarray:
        """Evaluate tokens (list or [B, T] array) after the current state.
        Returns host f32 logits: [B, T, V] if logits_all else [B, 1, V]."""
        tokens = np.atleast_2d(np.asarray(tokens, dtype=np.int64))
        b, t = tokens.shape
        if b != self.batch:
            raise ValueError(f"batch {b} != context batch {self.batch}")
        t0 = time.perf_counter()
        bt = _bucket(t)
        padded = np.zeros((b, bt), dtype=np.int64)
        padded[:, :t] = tokens
        valid = np.zeros((b, bt), dtype=bool)
        valid[:, :t] = True
        params, view = ((self.params, "decode") if bt <= 32
                        else (self._params_prefill, "prefill"))
        logits = self._run(RwkvCall(padded, valid, params, view,
                                    last_only=not (logits_all or bt != t)))
        logits = logits.float().cpu().numpy()
        if logits.shape[1] > 1:
            logits = logits[:, :t] if logits_all else logits[:, t - 1:t]
        dt = (time.perf_counter() - t0) * 1e3
        if t > 1:
            self.timings.t_prompt_ms += dt
            self.timings.n_prompt += t
        else:
            self.timings.t_eval_ms += dt
            self.timings.n_eval += 1
        self.n_past += t
        self._logits = logits
        return logits

    @property
    def logits(self) -> np.ndarray:
        return self._logits

    def get_state(self) -> dict:
        """The five state tensors as host arrays (rwkv.h's state accessor,
        for sessions)."""
        return {k: t.cpu().numpy() for k, t in self.state.items()}

    def set_state(self, st: dict) -> None:
        """Write a get_state dict into the state tensors in place."""
        for k, t in self.state.items():
            src = torch.from_numpy(np.asarray(st[k], dtype=np.float32))
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"state {k} has shape {tuple(src.shape)}, the "
                                 f"context's {tuple(t.shape)}")
            t.copy_(src)

    @torch.no_grad()
    def spec_chunk(self, hist, n_hist, key, done, sv=None, *, k: int, n_steps: int,
                   ds: "device_sample.DeviceSampling", max_ngram: int, min_ngram: int,
                   eos: int, ignore_eos: bool):
        """``device_spec.rwkv_spec_chunk`` on this context's params (the
        decode view) and state (written in place): n_steps prompt-lookup
        draft-verify rounds from the device histories hist [B, H] with
        lengths n_hist [B] and frozen rows done [B].  Returns device tensors
        (hist, n_hist, key, done, eosed, emit_toks [n_steps, B, k+1], emit_ns
        [n_steps, B]); ctx.n_past is left to the caller.

        On the card one round (``device_spec.rwkv_spec_round``: the T = k+1
        verify with every position's state, the accepted prefix's state
        gathered) is one graph, keyed by k, n_steps, the sampling, the
        history width and the lookup's settings, replayed n_steps times over
        static carry tensors.  On the CPU it is the eager loop."""
        from . import device_spec

        static = dict(k=k, ds=ds, max_ngram=max_ngram, min_ngram=min_ngram, eos=eos,
                      ignore_eos=ignore_eos)
        t0 = time.perf_counter()
        if self.device.type != "cuda":  # the caller asked for the CPU
            hist, n_hist, _, key, done, eosed, toks, ns = device_spec.rwkv_spec_chunk(
                self.cfg, self.params, hist, n_hist, self.state, key, done, sv,
                n_steps=n_steps, **static)
            out = (hist, n_hist, key, done, eosed, toks, ns)
        else:
            gkey = rwkv_step_key(k + 1, False, "decode") + (
                "spec", n_steps, ds, _sv_shapes(sv), hist.shape[1], k, max_ngram, min_ngram,
                eos, ignore_eos)
            out = self._spec_rounds(
                gkey, hist, n_hist, key, done, sv, k=k, n_steps=n_steps,
                round_fn=lambda carry, sv_, h: device_spec.rwkv_spec_round(
                    self.cfg, self.params, carry, self.state, sv_, h=h, **static))
        self.timings.t_eval_ms += (time.perf_counter() - t0) * 1e3
        self.timings.n_eval += n_steps
        return out
