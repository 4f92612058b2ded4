"""The port's serving engine (runtime/batch_engine.py) against the JAX
package's on the CPU, on the fixture of tests/test_batch_engine.py (n_vocab
256, n_embd 64, 4 heads, 2 layers, n_ctx 64).  Both packages run f32 compute
over f32 caches, where their greedy tokens agree, unless a test names
another cache.

Each scenario runs on both engines: per-request tokens and the stats()
counters must be equal, for host ticks, chunked ticks (staggered admission
included), speculative ticks with the adaptive fallback, the prefix cache
(bf16, and q8 with speculation), the chunked prefill of a long prompt, the
lane's cohorts and the batched short burst (their routing pinned as JAX's
tests pin it), cancellation and per-request sampling.  Seeded stochastic
rows are held on their support (JAX's PRNG streams are not reproduced on
the device) and exactly where the host samples them.  Also: the memory
estimate and guard, the lane's width, an admission failure, and the caches
never rebound.  Every queue read has a timeout and every engine is stopped
in `finally`, so that a hang fails one test."""

import dataclasses
import queue

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_q_4_0_tpu.formats.fixtures import make_llama_ggjt
from llama_cpp_q_4_0_tpu.formats.ggjt import read_ggjt as jax_read_ggjt
from llama_cpp_q_4_0_tpu.models.loading import (
    config_from_ggjt as jax_config, load_transformer as jax_load)
from llama_cpp_q_4_0_tpu.runtime import batch_engine as jbe
from llama_cpp_q_4_0_tpu.runtime import device_sample as jds
from llama_cpp_q_4_0_tpu.runtime import sampling as jsampling
from llama_cpp_q_4_0_tpu_torch.formats.ggjt import read_ggjt
from llama_cpp_q_4_0_tpu_torch.models.loading import config_from_ggjt, load_transformer
from llama_cpp_q_4_0_tpu_torch.ops import qmatmul as tqm
from llama_cpp_q_4_0_tpu_torch.runtime import batch_engine as tbe
from llama_cpp_q_4_0_tpu_torch.runtime import device_sample as tds
from llama_cpp_q_4_0_tpu_torch.runtime import sampling as tsampling
from llama_cpp_q_4_0_tpu_torch.runtime.context import Context

torch.set_num_threads(1)

TIMEOUT = 60  # seconds a token queue may stay silent
CACHES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "q8": (jnp.int8, torch.int8)}
GREEDY = dict(temp=-1.0, top_k=0, repeat_penalty=1.0, repeat_last_n=0)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("engine") / "m.bin")
    make_llama_ggjt(path, n_vocab=256, n_embd=64, n_head=4, n_layer=2)
    jgf, gf = jax_read_ggjt(path, "llama"), read_ggjt(path)
    jcfg = dataclasses.replace(jax_config(jgf, n_ctx=64), compute_dtype="float32")
    tcfg = dataclasses.replace(config_from_ggjt(gf, n_ctx=64), compute_dtype="float32")
    return (jcfg, jax_load(jgf, jcfg)), (tcfg, load_transformer(gf, tcfg, device="cpu"))


@dataclasses.dataclass
class Side:
    """One package's engine classes, so that a scenario runs on either."""
    be: object
    sampling: object
    ds: object
    jax: bool

    def sp(self, **kw):
        return self.sampling.SamplingParams(**kw)

    def req(self, prompt, n, sp=None, **kw):
        return self.be.Request(list(prompt), n_predict=n, sampling=sp or self.sp(**GREEDY),
                               **kw)


JAX = Side(jbe, jsampling, jds, True)
PORT = Side(tbe, tsampling, tds, False)


def drain(req) -> list[int]:
    out = []
    while True:
        try:
            t = req.out.get(timeout=TIMEOUT)
        except queue.Empty:
            raise AssertionError(f"request {req.id} starved") from None
        if t is None:
            return out
        out.extend(t if isinstance(t, list) else [t])


def engine(side: Side, model, *, cache="f32", ds=None, setup=None, **kw):
    (jcfg, jp), (tcfg, tp) = model
    dt = CACHES[cache][0 if side.jax else 1]
    if ds is not None:
        kw["device_sampling"] = side.ds.DeviceSampling(**ds)
    if side.jax:
        eng = side.be.BatchEngine(jcfg, jp, n_ctx=64, cache_dtype=dt, **kw)
    else:
        eng = side.be.BatchEngine(tcfg, tp, n_ctx=64, cache_dtype=dt, device="cpu", **kw)
    if setup:
        setup(eng)
    return eng


def run(side: Side, model, scenario, *, before_start=None, **kw):
    """scenario(side, eng) on a started engine; returns (its result,
    stats())."""
    eng = engine(side, model, **kw)
    if before_start:
        before_start(side, eng)
    eng.start()
    try:
        out = scenario(side, eng)
    finally:
        eng.stop()
    assert eng.n_active == 0
    return out, eng.stats(), eng


def both(model, scenario, **kw):
    """The scenario on JAX's engine and the port's: tokens and counters
    equal.  Returns the port's result and its engine."""
    want, jstats, _ = run(JAX, model, scenario, **kw)
    got, tstats, eng = run(PORT, model, scenario, **kw)
    assert got == want, (got, want)
    assert tstats == jstats, (tstats, jstats)
    return got, eng


def _ptrs(eng):
    return [t.data_ptr() for c in (*eng.cache_k, *eng.cache_v)
            for t in ((c.data, c.scale) if hasattr(c, "scale") else (c,))]


def submit_all(prompts, n):
    def scenario(side, eng):
        reqs = [eng.submit(side.req(p, n)) for p in prompts]
        return [drain(r) for r in reqs]
    return scenario


MODES = {"host": dict(),
         "chunked": dict(chunk=4, ds=dict(temp=-1.0)),
         "spec": dict(spec_draft=3, chunk=2, ds=dict(temp=-1.0))}


@pytest.mark.parametrize("mode", list(MODES))
def test_modes_match_jax_engine(model, mode):
    """Three requests through two slots (the third waits for a free slot):
    host, chunked and speculative ticks; the caches stay where they were
    allocated, and are the engine Context's."""
    prompts = [[3, 5, 7, 3, 5], [11, 13, 11, 13], [9, 4]]
    got, eng = both(model, submit_all(prompts, 10), n_slots=2, **MODES[mode])
    assert all(len(o) > 0 for o in got)
    assert eng.cache_k is eng.ctx.cache_k and eng.cache_v is eng.ctx.cache_v


def test_caches_are_never_rebound(model):
    """Across host, chunked and speculative ticks and every admission route,
    the cache tensors keep their addresses."""
    for kw in MODES.values():
        eng = engine(PORT, model, n_slots=2, **kw)
        eng.prefill_chunk = 8
        eng.register_prefix([7, 11, 13])
        ptrs = _ptrs(eng)
        eng.start()
        try:
            rs = [eng.submit(PORT.req(p, 5)) for p in
                  ([3, 5], list(range(20, 45)), [7, 11, 13, 4], [9, 9])]
            for r in rs:
                drain(r)
        finally:
            eng.stop()
        assert _ptrs(eng) == ptrs


def test_chunked_staggered_admission(model):
    """A request submitted while ticks are in flight forces a flush and an
    admission; both requests still match JAX's engine."""
    def scenario(side, eng):
        r1 = eng.submit(side.req([3, 5, 7], 8))
        first = r1.out.get(timeout=TIMEOUT)
        r2 = eng.submit(side.req([11, 13], 8))
        first = first if isinstance(first, list) else [first]
        return [first + drain(r1), drain(r2)]

    both(model, scenario, n_slots=2, chunk=2, ds=dict(temp=-1.0))


def test_adaptive_spec_fallback(model):
    """spec_max_active=1: chunked ticks at high occupancy, speculative ones
    (after a history resync) as slots free up."""
    prompts = [[3, 5, 7, 3, 5], [11, 13, 11], [9, 4, 9, 4]]

    def scenario(side, eng):
        reqs = [eng.submit(side.req(p, n)) for p, n in zip(prompts, (4, 8, 14))]
        return [drain(r) for r in reqs]

    both(model, scenario, n_slots=3, spec_draft=3, chunk=2, spec_max_active=1,
         ds=dict(temp=-1.0))


@pytest.mark.parametrize("cache,kw", [("bf16", dict()),
                                      ("q8", dict(spec_draft=3, chunk=2,
                                                  ds=dict(temp=-1.0)))],
                         ids=["bf16", "q8_spec"])
def test_prefix_cache(model, cache, kw):
    """register_prefix: matching prompts copy the cached rows and prefill
    the rest; the third prompt does not match."""
    pre = [7, 11, 13, 17, 19]
    prompts = [pre + [23, 29], pre + [31], [3, 5, 9]]
    both(model, submit_all(prompts, 6), n_slots=2, cache=cache,
         setup=lambda e: e.register_prefix(pre), **kw)


def _long_short(side, eng):
    rng = np.random.default_rng(51)
    r1 = eng.submit(side.req(rng.integers(3, 250, 40).tolist(), 6))
    r2 = eng.submit(side.req([5, 9], 6))
    return [drain(r2), drain(r1)]


def test_chunked_prefill_long_prompt(model):
    """A prompt longer than prefill_chunk admits through the lane, chunk by
    chunk, while a short request admitted beside it completes."""
    both(model, _long_short, n_slots=2, setup=lambda e: setattr(e, "prefill_chunk", 8))


def _spied(side, monkeypatch):
    """Record the lane's cohorts and the batched admissions' prompt
    lengths of one package's engine."""
    calls = {"lane": [], "batched": []}
    orig_start, orig_batched = side.be.BatchEngine._start_prefill, \
        side.be.BatchEngine._admit_batched

    def spy_start(self, entries):
        calls["lane"].append([len(p) for _, _, p in entries])
        return orig_start(self, entries)

    def spy_batched(self, batch):
        calls["batched"].append([len(r.prompt_tokens) for _, r in batch])
        return orig_batched(self, batch)

    monkeypatch.setattr(side.be.BatchEngine, "_start_prefill", spy_start)
    monkeypatch.setattr(side.be.BatchEngine, "_admit_batched", spy_batched)
    return calls


@pytest.mark.parametrize("lens,n_slots,cohorts,batched", [
    ((25, 28, 31), 3, [[25, 28, 31]], []),
    ((30, 34, 38), 3, None, []),
    ((4, 5, 25, 33), 4, [[25], [33]], [[4, 5]]),
], ids=["one_cohort", "serialized", "short_burst"])
def test_admission_routing_matches_jax(model, monkeypatch, lens, n_slots, cohorts, batched):
    """One burst before start: equal-chunk-count long prompts ride one lane
    cohort; others wait for the lane in FIFO order; short prompts batch into
    one forward while long ones take the lane.  The routes are JAX's (and
    where JAX's tests pin them, those), the tokens too."""
    rng = np.random.default_rng(sum(lens))
    prompts = [rng.integers(3, 250, n).tolist() for n in lens]
    routes, outs, reqs = {}, {}, {}

    def before(side, eng):  # one burst, queued before the engine starts
        reqs[side.jax] = [eng.submit(side.req(p, 5)) for p in prompts]

    for side in (JAX, PORT):
        routes[side.jax] = _spied(side, monkeypatch)
        outs[side.jax], _, _ = run(side, model, lambda s, e: [drain(r) for r in reqs[s.jax]],
                                   n_slots=n_slots, before_start=before,
                                   setup=lambda e: setattr(e, "prefill_chunk", 8))
    assert outs[False] == outs[True]
    assert routes[False] == routes[True]
    if cohorts is not None:
        assert routes[False]["lane"] == cohorts
    else:
        assert sorted(x for c in routes[False]["lane"] for x in c) == sorted(lens)
        assert len(routes[False]["lane"]) == 2
    assert routes[False]["batched"] == batched


def test_long_burst_over_the_row_cap_admits_per_slot(model, monkeypatch):
    """A burst whose [M_pad, T_pad] matrix passes MAX_PALLAS_ROWS admits
    slot by slot, with the tokens of the batched admission."""
    prompts = [[5, 9, 23, 7], [3, 11, 2, 8], [6, 4], [9, 9, 1]]
    reqs = {}

    def before(side, eng):
        reqs[side.jax] = [eng.submit(side.req(p, 6)) for p in prompts]

    def burst(side, eng):
        return [drain(r) for r in reqs[side.jax]]

    outs = {}
    for cap in (2048, 4):
        monkeypatch.setattr(tqm, "MAX_PALLAS_ROWS", cap)
        calls = _spied(PORT, monkeypatch)
        outs[cap], _, _ = run(PORT, model, burst, n_slots=4, before_start=before)
        assert (len(calls["batched"]) > 0) == (cap == 2048)
    assert outs[4] == outs[2048]
    want, _, _ = run(JAX, model, burst, n_slots=4, before_start=before)
    assert outs[2048] == want


def test_cancellation(model):
    """cancel() frees the slot at the next tick and closes the queue; the
    slot then serves the next request."""
    for kw in MODES.values():
        eng = engine(PORT, model, n_slots=1, **kw)
        eng.start()
        try:
            r1 = eng.submit(PORT.req([5, 9], 1 << 20))
            r1.out.get(timeout=TIMEOUT)
            r1.cancel()
            assert len(drain(r1)) < 64
            r2 = eng.submit(PORT.req([7, 3], 4))
            assert 0 < len(drain(r2)) <= 4
        finally:
            eng.stop()
        assert eng.n_active == 0


def test_randomized_differential(model):
    """tests/test_batch_engine.py's fuzz: 10 requests with random prompts,
    lengths and greedy sampler knobs (penalties, windows) in two waves onto
    three slots, one cancelled before it starts, per-request sampling on
    the device: each request's tokens and the counters equal JAX's, in
    host, chunked and speculative modes."""
    rng = np.random.default_rng(77)
    cases = []
    for _ in range(10):
        prompt = rng.integers(3, 250, int(rng.integers(1, 12))).tolist()
        knobs = dict(temp=-1.0, top_k=0, repeat_penalty=float(rng.choice([1.0, 1.1, 1.4])),
                     repeat_last_n=int(rng.choice([0, 4, 16])),
                     frequency_penalty=float(rng.choice([0.0, 0.2])),
                     presence_penalty=float(rng.choice([0.0, 0.3])))
        cases.append((prompt, knobs, int(rng.integers(1, 8))))

    def scenario(side, eng):
        wave1 = [eng.submit(side.req(p, n, side.sp(**k))) for p, k, n in cases[:6]]
        wave1[2].cancel()
        drain(wave1[2])
        wave2 = [eng.submit(side.req(p, n, side.sp(**k))) for p, k, n in cases[6:]]
        return [[] if i == 2 else drain(r) for i, r in enumerate(wave1 + wave2)]

    for kw in (dict(), dict(chunk=3), dict(spec_draft=3, chunk=2)):
        if kw:
            kw.update(per_request_sampling=True, ds=dict(temp=-1.0))
        both(model, scenario, n_slots=3, **kw)


def test_stats_counters(model):
    got, eng = both(model, submit_all([[5, 9, 23]], 5), n_slots=2)
    st = eng.stats()
    assert st["n_tokens_out"] == len(got[0]) and st["n_requests_done"] == 1
    assert st["n_active"] == 0 and st["mode"] == "host"


@pytest.mark.parametrize("cache", ["f32", "bf16", "q8"])
def test_estimate_engine_hbm_equals_jax(model, cache):
    """The weight bytes (every array of the params: levels, scale planes,
    dense tensors) and the KV bytes are JAX's."""
    (jcfg, jp), (tcfg, tp) = model
    want = jbe.estimate_engine_hbm(jp, jcfg, 16, 2048, CACHES[cache][0])
    assert tbe.estimate_engine_hbm(tp, tcfg, 16, 2048, CACHES[cache][1]) == want


def test_capacity_guard_matches_jax(model):
    """At the same hbm_limit_bytes both engines refuse an explicit bf16
    plan, take the q8 one, pick int8 or bf16 under "auto" alike, and refuse
    a plan that does not fit even as q8."""
    (jcfg, jp), (tcfg, tp) = model
    weights, kv_bf16 = tbe.estimate_engine_hbm(tp, tcfg, 16, 2048, torch.bfloat16)
    _, kv_q8 = tbe.estimate_engine_hbm(tp, tcfg, 16, 2048, torch.int8)
    assert kv_q8 < 0.65 * kv_bf16
    limit = int((weights + (kv_q8 + kv_bf16) / 2) / 0.85)
    roomy = int((weights + 2 * kv_bf16) / 0.85)

    def make(side, cache, lim):
        cfg, p = model[0] if side.jax else model[1]
        kw = {} if side.jax else {"device": "cpu"}
        dt = cache if cache == "auto" else CACHES[cache][0 if side.jax else 1]
        return side.be.BatchEngine(cfg, p, n_slots=16, n_ctx=2048, chunk=2, cache_dtype=dt,
                                   hbm_limit_bytes=lim, **kw)

    for side in (JAX, PORT):
        with pytest.raises(ValueError, match="does not fit HBM"):
            make(side, "bf16", limit)
        assert make(side, "q8", limit).n_ctx == 2048
        assert make(side, "auto", limit).stats()["cache_dtype"] == "int8"
        assert make(side, "auto", roomy).stats()["cache_dtype"] == "bfloat16"
        with pytest.raises(ValueError, match="does not fit HBM"):
            make(side, "auto", int(weights * 0.9))
    eng = make(PORT, "auto", limit)
    assert eng.cache_k[0].data.dtype == torch.int8  # the QuantKV layout


def test_lane_width_clamps_to_free_memory(model):
    (_, _), (tcfg, tp) = model
    w_b, kv_b = tbe.estimate_engine_hbm(tp, tcfg, 8, 64, torch.int8)
    row = kv_b // 8
    lim = w_b + kv_b + (512 << 20) + 2 * row + row // 2
    eng = tbe.BatchEngine(tcfg, tp, n_slots=8, n_ctx=64, cache_dtype=torch.int8,
                          hbm_limit_bytes=lim, device="cpu")
    assert eng.lane_width == 2
    # wide caches keep the cohorts on the CPU, as in JAX
    assert tbe.BatchEngine(tcfg, tp, n_slots=2, n_ctx=64, cache_dtype=torch.bfloat16,
                           device="cpu").lane_width == 4


def test_admission_failure_closes_requests(model):
    """An admission forward that dies closes every client's stream, those
    already taken from the queue included, and submit() then raises."""
    (_, _), (tcfg, tp) = model
    eng = tbe.BatchEngine(tcfg, tp, n_slots=2, n_ctx=64, device="cpu")

    def boom(*a, **k):
        raise RuntimeError("injected failure")

    eng._admit_batched = boom
    eng._slot_prefill = boom
    rs = [eng.submit(PORT.req([5, 9, 23], 4)) for _ in range(2)]
    eng.start()
    try:
        for r in rs:
            assert drain(r) == []
        eng._thread.join(timeout=TIMEOUT)
        with pytest.raises(RuntimeError):
            eng.submit(PORT.req([5], 1))
    finally:
        eng.stop()


def test_device_is_required_unless_cpu(model):
    (_, _), (tcfg, tp) = model
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tbe.BatchEngine(tcfg, tp, n_slots=2, n_ctx=64)
    with pytest.raises(NotImplementedError):
        tbe.BatchEngine(tcfg, tp, n_slots=2, n_ctx=64, device="cpu", mesh=object())


# ---------------------------------------------------------- per-request sampling

def _top_k_support(model, prompt, out, k):
    """Each token of out lies among the k most likely of the single
    session's logits at its position (f32, f32 cache)."""
    _, (tcfg, tp) = model
    ctx = Context(tcfg, tp, n_ctx=64, cache_dtype=torch.float32, device="cpu")
    logits = ctx.eval(np.asarray([prompt]))
    for t in out:
        top = np.argsort(-logits[0, -1])[:k]
        assert t in top, (t, top)
        logits = ctx.eval(np.asarray([[t]]))


def test_host_ticks_sample_as_jax(model):
    """Seeded stochastic requests on host ticks: the host sampler is JAX's
    (numpy streams), so the tokens are JAX's exactly."""
    def scenario(side, eng):
        reqs = [eng.submit(side.req(p, 8, side.sp(temp=0.9, top_k=20, top_p=0.95),
                                    seed=s)) for p, s in (([3, 5, 7], 11), ([9, 4], 12))]
        return [drain(r) for r in reqs]

    got, _ = both(model, scenario, n_slots=2)
    assert all(got)


@pytest.mark.parametrize("kw", [dict(chunk=3), dict(spec_draft=3, chunk=2)],
                         ids=["chunked", "spec"])
def test_device_ticks_per_request_sampling(model, kw):
    """A seeded top-k request beside a greedy one in per-request device
    ticks: the greedy row is JAX's exactly, the first token (sampled on the
    host at admission) is JAX's, and every later token lies in the row's
    top-k support; the seeded row's tokens do not depend on its neighbour."""
    p1, p2 = [3, 5, 7, 11], [13, 17, 19]

    def scenario(side, eng, extra=True):
        r1 = eng.submit(side.req(p1, 10, side.sp(temp=0.9, top_k=5), seed=1234))
        r2 = eng.submit(side.req(p2, 8)) if extra else None
        return [drain(r1), drain(r2) if r2 else []]

    kw = dict(kw, per_request_sampling=True, ds=dict(temp=0.9))
    want, _, _ = run(JAX, model, scenario, n_slots=2, **kw)
    got, _, _ = run(PORT, model, scenario, n_slots=2, **kw)
    alone, _, _ = run(PORT, model, lambda s, e: scenario(s, e, extra=False), n_slots=2, **kw)
    assert got[1] == want[1]
    assert got[0][:1] == want[0][:1] and len(got[0]) == 10
    assert alone[0] == got[0]
    _top_k_support(model, p1, got[0], 5)


def test_mirostat_request_rides_chunked_ticks(model):
    """A mirostat request in a speculative engine takes chunked ticks; a
    greedy neighbour still gives JAX's tokens."""
    def scenario(side, eng):
        r1 = eng.submit(side.req([3, 5, 7, 11], 8, side.sp(temp=0.9, mirostat=2,
                                                           mirostat_tau=4.0,
                                                           mirostat_eta=0.2)))
        r2 = eng.submit(side.req([13, 17, 19], 8))
        out = [drain(r1), drain(r2)]
        assert eng.stats()["mode"] == "chunked"
        return out

    kw = dict(n_slots=2, chunk=3, spec_draft=3, per_request_sampling=True, ds=dict(temp=-1.0))
    want, _, _ = run(JAX, model, scenario, **kw)
    got, _, _ = run(PORT, model, scenario, **kw)
    assert got[1] == want[1]
    assert len(got[0]) > 0 and all(0 <= t < 256 for t in got[0])


@pytest.mark.gpu
def test_replayed_tick_equals_its_eager_twin(model):
    """On the card a host tick is a replayed graph: its logits equal the
    eager forward of the same call bit for bit, and the caches keep their
    addresses."""
    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    from llama_cpp_q_4_0_tpu_torch.models import transformer

    _, (tcfg, tp) = model
    params = _to(tp, torch.device("cuda"))
    eng = tbe.BatchEngine(tcfg, params, n_slots=2, n_ctx=64, cache_dtype=torch.float32)
    ptrs = _ptrs(eng)
    eng.start()
    try:
        for r in [eng.submit(PORT.req(p, 8)) for p in ([3, 5, 7], [9, 4])]:
            drain(r)
    finally:
        eng.stop()
    call = eng.ctx.last_call
    assert call.kind == "tick"
    st = eng.ctx._steps[call.key]
    assert st.graph is not None and st.replays > 0
    got = st.out.clone()
    ck = [c.clone() for c in eng.cache_k]
    cv = [c.clone() for c in eng.cache_v]
    want = transformer.forward(tcfg, call.params, st.x, st.n_past, ck, cv,
                               last_only=True, kv_window=call.kv_window)
    assert torch.equal(got, want)
    assert _ptrs(eng) == ptrs


def _to(params, device):
    def move(v):
        if isinstance(v, torch.Tensor):
            return v.to(device)
        if dataclasses.is_dataclass(v):
            return dataclasses.replace(v, **{f.name: move(getattr(v, f.name))
                                             for f in dataclasses.fields(v)})
        if isinstance(v, (list, tuple)):
            return type(v)(move(x) for x in v)
        return v
    return move(params)
