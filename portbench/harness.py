"""One run of one cell: the program built from the seed's weights, its
shapes warmed, the traffic driven for the window, the per-layer readings
taken, and what the window served held against the plain reference.

``run_cell`` is the whole run below the look for a chip; ``run.py`` looks
for one and prints the result.  Everything a cell is made of is found by
name: its configuration file, its family module (``families/``), its
reference (``reference/``), its traffic mix (``traffic/``), its limits
(``limits/``) and each per-layer metric's reader (``metrics/``).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import queue
import random
import sys
import threading
import time
from dataclasses import dataclass
from unittest import mock

import numpy as np
import torch

from . import families, reference, roofline, traffic

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PROGRAM = "llama_cpp_q_4_0_tpu_torch"
# modules that may not be loaded when the window closes (top-level names)
FORBIDDEN = ("jax", "jaxlib", "flax", "llama_cpp_q_4_0_tpu")
FIRST_TOKEN_WAIT_S = 60.0  # past the window's close, for the first tokens it owes
CHECK_TOKENS = 384  # served greedy tokens the check reads at the least, when there are
CHECK_MAX_REQUESTS = 16
MIN_CHECK_TOKENS = 32  # fewer served greedy tokens than this: nothing was shown
SAMPLE_PERIOD_S = 0.001  # the traced run's host stack sampler
OP_NAME_CHARS = 120  # a device operation's name in the breakdown, cut to this


@dataclass
class Readings:
    """What the per-layer readers read (``metrics/<name>.py``'s ``read``)."""
    shapes: object
    window_s: float
    counters: dict | None  # the engine's stats() counters over the window
    decode_steps: int  # decode steps the program ran in the window (ticks x rounds)
    decode_rows: int  # tokens the decode steps produced in the window
    kv_positions: int  # the positions the decode rows attended to, summed
    prefill_lengths: list  # prompt lengths of the requests first served in the window
    spans: list  # (name, start_s, end_s, tokens) of the benchmark's own spans
    device: object = None  # the device's activities in the window (roofline.DeviceTrace)
    trace_lo: int = 0  # the traced window in the device's clock, ns
    trace_hi: int = 0


# ------------------------------------------------------------------ loading

def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_parts(bench: dict, name: str, root: str = ROOT):
    """(cell, configuration, mix, limits) of the cell name in BENCHMARK.json."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    conf = load_json(root, entry["file"])
    mix = traffic.load(cell["traffic"], os.path.join(root, "portbench"))
    limits = load_json(root, "portbench", "limits", f"{name}.json")
    return cell, conf, mix, limits


def metric_reader(name: str, root: str = ROOT):
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(sys.modules)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- the clients

class _Deliver(queue.Queue):
    """A request's token queue: each put is stamped and handed to the one
    queue the driver reads."""

    def __init__(self, sink: queue.Queue, index: int):
        super().__init__()
        self.sink, self.index = sink, index

    def put(self, item, block=True, timeout=None):
        self.sink.put((self.index, time.perf_counter(), item))


class EngineServer:
    """``server --parallel``: the family's engine, and its clients: a closed
    loop of the mix's clients, each sending its next request when the last
    one completes, or an open loop at the mix's arrival times."""

    def __init__(self, fam, conf, cfg, params, mix, device):
        self.engine = fam.engine(conf, cfg, params, mix, device)
        self.mix = mix

    @property
    def thread_id(self):
        return self.engine._thread.ident

    def counters(self) -> dict:
        s = self.engine.stats()
        return {"n_ticks": s["n_ticks"], "n_tokens_out": s["n_tokens_out"]}

    def steps_per_tick(self) -> int:
        return max(1, getattr(self.engine, "chunk", 1))

    def _submit(self, r, sink):
        r.sent = time.perf_counter()
        return self.engine.submit(families.common.request(
            r.prompt, r.n_predict, r.sampling, r.seed, _Deliver(sink, r.index)))

    def warm(self, reqs, prefix=()) -> None:
        """Register the mix's shared prefix, start the engine, and serve reqs
        one at a time, each to its end."""
        if prefix:
            self.engine.register_prefix(list(prefix))
        self.engine.start()
        for r in reqs:
            sink = queue.Queue()
            self._submit(r, sink)
            while sink.get(timeout=600)[2] is not None:
                pass
        if self.engine._error is not None:
            raise RuntimeError("the engine died in the warm-up") from self.engine._error

    def window(self, pool, seconds, on_open=None, on_close=None):
        """The measured window: the clients send until the close; then the
        first tokens the window owes are waited for (a minute at most), and
        what is still running is cancelled.  Returns (requests sent,
        counters at the open, counters at the close, host clock of the open
        and close, the indexes cancelled)."""
        sink = queue.Queue()
        handles, sent, it = {}, [], iter(pool)
        by_index = {}
        arrivals = traffic.arrival_times(self.mix, len(pool))

        def send(client):
            try:
                r = next(it)
            except StopIteration:
                raise RuntimeError("the traffic pool ran out inside the window") from None
            r.client = client
            by_index[r.index] = r
            sent.append(r)
            handles[r.index] = self._submit(r, sink)

        if on_open:
            on_open()
        c0 = self.counters()
        t_open = time.perf_counter()
        t_close = t_open + seconds
        if arrivals is None:
            for c in range(self.mix["clients"]):
                send(c)
        c1 = None
        deadline = t_close + FIRST_TOKEN_WAIT_S
        while True:
            now = time.perf_counter()
            wait = 0.01
            if arrivals is not None:
                while len(sent) < len(arrivals) and t_open + arrivals[len(sent)] <= min(
                        now, t_close):
                    send(len(sent))
                if len(sent) < len(arrivals):
                    wait = min(wait, max(0.0, t_open + arrivals[len(sent)] - now))
            if c1 is None and now >= t_close:
                c1 = self.counters()
                if on_close:
                    on_close()
            if now >= t_close:
                owed = [r for r in sent if r.sent < t_close and not r.times and r.done < 0]
                if not owed or now >= deadline:
                    break
            try:
                i, t, item = sink.get(timeout=wait)
            except queue.Empty:
                continue
            r = by_index[i]
            if item is None:
                r.done = t
                if t < t_close and arrivals is None:
                    send(r.client)
            else:
                items = item if isinstance(item, list) else [item]
                r.tokens.extend(items)
                r.times.extend([t] * len(items))
        if arrivals is not None and len(sent) == len(arrivals) and t_open + arrivals[-1] < t_close:
            raise RuntimeError("the traffic pool ran out inside the window")
        cancelled = set()
        for r in sent:
            if r.done < 0:
                handles[r.index].cancel()
                cancelled.add(r.index)
        self.engine.stop()
        while True:
            try:
                i, t, item = sink.get_nowait()
            except queue.Empty:
                break
            if item is None and by_index[i].done < 0:
                by_index[i].done = t
        return sent, c0, c1, t_open, t_close, cancelled

    def close(self):
        if self.engine._thread is not None:
            self.engine.stop()
        self.engine = None


class GenerateServer:
    """``main``: one client generating on one Context, request after
    request; the prompt's ``Context.eval`` is the benchmark's own span
    (prefill), which ends in the copy of its logits to the host."""

    def __init__(self, fam, conf, cfg, params, mix, device):
        self.ctx = fam.context(conf, cfg, params, mix["n_ctx"], device)
        self.mix = mix
        self.spans = []
        self._record = False
        orig = self.ctx.eval

        def timed(tokens, **kw):
            t0 = time.perf_counter()
            out = orig(tokens, **kw)
            n = np.asarray(tokens).shape[-1]
            if self._record and n > 1:
                self.spans.append(("prefill", t0, time.perf_counter(), n))
            return out

        self.ctx.eval = timed

    thread_id = property(lambda self: threading.main_thread().ident)

    def counters(self):
        return None

    def steps_per_tick(self) -> int:
        return 1

    def _one(self, r):
        r.sent = time.perf_counter()
        for tok in families.common.generate(self.ctx, r.prompt, r.n_predict, r.sampling,
                                            r.seed):
            r.times.append(time.perf_counter())
            r.tokens.append(tok)
        r.done = time.perf_counter()

    def warm(self, reqs, prefix=()):
        for r in reqs:
            self._one(r)

    def window(self, pool, seconds, on_open=None, on_close=None):
        if self.mix.get("arrivals"):
            raise ValueError("main's path is one client in a closed loop: no arrivals")
        sent = []
        if on_open:
            on_open()
        self._record = True
        t_open = time.perf_counter()
        t_close = t_open + seconds
        closed = False
        for r in pool:
            if time.perf_counter() >= t_close:
                break
            r.client = 0
            sent.append(r)
            self._one(r)
            if not closed and time.perf_counter() >= t_close and on_close:
                closed = True
                on_close()
        else:
            raise RuntimeError("the traffic pool ran out inside the window")
        if not closed and on_close:
            on_close()
        self._record = False
        return sent, None, None, t_open, t_close, set()

    def close(self):
        self.ctx = None


# a mix's client loop by its ``entry``, unless a .py mix brings its own Server
SERVERS = {"engine": EngineServer, "generate": GenerateServer}


def warm_requests(mix, seed, n_vocab):
    """The warm-up's requests: for each prefill bucket the mix can reach, one
    prompt that fills it and one a token short of it, each with a few tokens
    out, one at a time: every step shape the window can meet, the prompt's
    and the decode windows up to the longest context.  A shared prefix
    starts each prompt, as it starts the window's."""
    from llama_cpp_q_4_0_tpu_torch.runtime.context import PREFILL_BUCKETS

    prefix = traffic.shared_prefix(mix, seed, n_vocab)
    lo, hi = len(prefix) + mix["prompt"]["min"], traffic.bounds(mix)[1]
    n_ctx = mix["n_ctx"]
    rng = random.Random(f"{seed}/warm")
    greedy = dict(mix["sampling"], **traffic.GREEDY)
    out = []
    for b in PREFILL_BUCKETS:
        if b < lo // 2 or b // 2 > hi:
            continue
        for length in (b - 1, b):
            length = max(len(prefix) + 1, min(length, n_ctx - 4))
            prompt = prefix + [rng.randrange(n_vocab) for _ in range(length - len(prefix))]
            out.append(traffic.Req(-1 - len(out), prompt, 3, greedy, rng.randrange(1 << 31),
                                   True))
    return out


# ------------------------------------------------------------------ tracing

class StackSampler(threading.Thread):
    """Samples a thread's innermost frame in the program, every period: what
    the host was doing, to name the device's idle gaps by."""

    def __init__(self, tid: int, period: float = SAMPLE_PERIOD_S):
        super().__init__(daemon=True)
        self.tid, self.period = tid, period
        self.samples = []
        self._halt = threading.Event()

    def run(self):
        while not self._halt.wait(self.period):
            f = sys._current_frames().get(self.tid)
            self.samples.append((time.perf_counter_ns(), _label(f)))

    def halt(self):
        self._halt.set()
        self.join()


def _label(f) -> str:
    while f is not None:
        fn = f.f_code.co_filename
        at = fn.find(os.sep + PROGRAM + os.sep)
        if at >= 0:
            return f"{fn[at + len(PROGRAM) + 2:]}:{f.f_code.co_name}"
        f = f.f_back
    return "outside the program"


class Tracer:
    """torch.profiler over the window (the device's activity alone), a
    marker kernel to put the host's clock on the device's, and the stack
    sampler."""

    def __init__(self, tid):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.sampler = StackSampler(tid)

    def start(self):
        self.prof.start()
        torch.cuda.synchronize()
        self.marker_host = time.perf_counter_ns()
        torch.ones((1,), device="cuda")  # the first device activity of the trace
        torch.cuda.synchronize()
        self.sampler.start()

    def stop(self):
        torch.cuda.synchronize()
        self.sampler.halt()
        t0 = time.perf_counter()
        self.prof.stop()
        self.stop_s = time.perf_counter() - t0

    def device_trace(self):
        """(the device's activities, the device clock less the host's, ns)."""
        trace = roofline.device_trace(self.prof.profiler.kineto_results)
        if not len(trace):
            return trace, 0
        return trace, int(trace.start[0]) - self.marker_host


def breakdown(trace, samples, offset, lo, hi):
    """The device operations that took most time (by name, cut to
    OP_NAME_CHARS), and the idle gaps of [lo, hi] by what the host was doing
    (the stack sampler's most frequent label in each gap), seconds each, at
    most 10 of each; and the seconds the device was busy.  trace is cut to
    [lo, hi] already."""
    by_name = {}
    for name, ns in trace.ns_by_name().items():
        key = name.removeprefix("void ")[:OP_NAME_CHARS]
        by_name[key] = by_name.get(key, 0) + ns
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gs, ge = trace.gaps(lo, hi)
    times = np.array([t + offset for t, _ in samples], dtype=np.int64)
    names = {}
    labels = np.array([names.setdefault(lab, len(names)) for _, lab in samples], dtype=np.int64)
    names = list(names)
    by_label = {}
    if len(gs) and len(times):
        # each sample's gap, where it falls in one; then each gap's most
        # frequent label
        gi = np.searchsorted(gs, times, side="right") - 1
        inside = gi >= 0
        inside[inside] = times[inside] < ge[gi[inside]]
        key = gi[inside] * len(names) + labels[inside]
        uk, count = np.unique(key, return_counts=True)
        order = np.lexsort((-count, uk // len(names)))
        uk = uk[order]
        first = np.ones(len(uk), dtype=bool)
        first[1:] = uk[1:] // len(names) != uk[:-1] // len(names)
        for k in uk[first]:
            g, lab = divmod(int(k), len(names))
            by_label[names[lab]] = by_label.get(names[lab], 0) + int(ge[g] - gs[g])
    unlabelled = int((ge - gs).sum()) - sum(by_label.values())
    if unlabelled > 0:
        by_label["between host samples (< 1 ms)"] = unlabelled
    idle = sorted(by_label.items(), key=lambda kv: -kv[1])[:10]
    bs, be = trace.busy()
    busy_ns = int((be - bs).sum())
    return ([[n, v / 1e9] for n, v in ops], [[n, v / 1e9] for n, v in idle], busy_ns / 1e9)


# --------------------------------------------------------------- the check

def check_sample(sent, seed):
    """The greedy requests the check reads, each with the tokens it was
    served: those that finished and those that the close cut (a request of
    a busy engine can outlive the window), the one with the most served
    tokens, then others drawn by the seed, until CHECK_TOKENS."""
    done = [r for r in sent if r.greedy and r.tokens]
    if not done:
        return []
    done.sort(key=lambda r: (-len(r.tokens), r.index))
    pick, rest = [done[0]], done[1:]
    random.Random(f"{seed}/check").shuffle(rest)
    n = len(done[0].tokens)
    for r in rest:
        if n >= CHECK_TOKENS or len(pick) >= CHECK_MAX_REQUESTS:
            break
        pick.append(r)
        n += len(r.tokens)
    return pick


def reference_gaps(conf, raw, pick, device, lowp=None):
    """For each served greedy token of pick, the gap by which its logit lies
    below the reference's best at its position: a flat f64 array.  With
    lowp (the control): at the same positions of the same prompts and served
    tokens, the gap of the token that the reference in lowp's precision puts
    first, so that both widest gaps are taken over as many positions."""
    ref = reference.module(families.module(conf["family"]).REFERENCE)
    seqs = [r.prompt + r.tokens[:-1] for r in pick]
    wanted = [list(range(len(r.prompt) - 1, len(s))) for r, s in zip(pick, seqs)]
    logits = ref.logits_at(conf, raw, seqs, wanted, device)
    low = ref.logits_at(conf, raw, seqs, wanted, device, lowp=lowp) if lowp else None
    gaps = []
    for i, (r, lg) in enumerate(zip(pick, logits)):
        lg = lg.double()
        chosen = (torch.as_tensor(r.tokens, device=lg.device) if low is None
                  else low[i].argmax(dim=-1))
        gaps.append((lg.max(dim=-1).values - lg.gather(1, chosen[:, None])[:, 0]).cpu())
    return torch.cat(gaps).numpy()


# ---------------------------------------------------------------- the run

def percentile(values, q):
    """The q-th percentile (0-100), linear between the order statistics
    (numpy's default rule), or None of no values."""
    if not values:
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def run_cell(conf, mix, limits, **kw):
    """One run; the result's dict (without the chip look, which is run.py's).
    The configuration's ``env`` (the program's switches, such as ``QMM_Q8X``)
    holds in the environment for the run.  control: None, or the rounding of
    the control (``reference.fp8_rows``), whose reference then decides
    ``correct`` in the program's place."""
    with mock.patch.dict(os.environ, conf.get("env", {})):
        return _run(conf, mix, limits, **kw)


def _run(conf, mix, limits, *, seed, seconds, trace, device, t_process, control=None,
         per_layer=(), end_to_end=(), log=print):
    fam = families.module(conf["family"])
    shapes = fam.shapes(conf)
    n_vocab = shapes.head_matrices[0][0]
    t = time.perf_counter()

    def phase(name):
        nonlocal t
        now = time.perf_counter()
        log(f"setup: {name} {now - t:.2f} s", file=sys.stderr)
        t = now

    raw = fam.raw_weights(conf, seed, device)
    phase("raw weights made")
    cfg, params = fam.port_model(conf, raw, mix["n_ctx"], device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    phase("program's loader")
    pool = traffic.requests(mix, seed, n_vocab, mix["pool"])
    warm = warm_requests(mix, seed, n_vocab)
    phase("traffic drawn")
    server = (traffic.own(mix, "Server") or SERVERS[mix["entry"]])(
        fam, conf, cfg, params, mix, device)
    phase("server built")
    server.warm(warm, traffic.shared_prefix(mix, seed, n_vocab))
    phase(f"warm-up ({len(warm)} requests)")
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    tracer = None
    if trace:
        tracer = Tracer(server.thread_id)
    t_ready = time.time()
    sent, c0, c1, t_open, t_close, cancelled = server.window(
        pool, seconds, on_open=tracer.start if tracer else None,
        on_close=tracer.stop if tracer else None)
    setup_s = t_ready - t_process
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    steps_per_tick = server.steps_per_tick()
    spans = list(getattr(server, "spans", []))
    server.close()
    del server, params
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))

    # the end-to-end numbers, from the clients' clocks
    in_win = [r for r in sent if t_open <= r.sent < t_close]
    ttft, itl, n_out = [], [], 0
    failed = 0
    for r in in_win:
        if r.times:
            ttft.append((r.times[0] - r.sent) * 1e3)
        elif r.done >= 0 and r.index not in cancelled:
            ttft.append((r.done - r.sent) * 1e3)  # closed with no token (EOS first)
        else:
            failed += 1
    decode_rows = kv_positions = 0
    prefill_lengths = []
    for r in sent:
        for j, t in enumerate(r.times):
            if not t_open <= t < t_close:
                continue
            n_out += 1
            if j:
                itl.append((t - r.times[j - 1]) * 1e3)
                decode_rows += 1
                kv_positions += len(r.prompt) + j
            else:
                prefill_lengths.append(len(r.prompt))
    window_s = t_close - t_open
    e2e = {"output_tok_s": n_out / window_s, "ttft_p95_ms": percentile(ttft, 95),
           "itl_p95_ms": percentile(itl, 95), "setup_s": setup_s}
    if c0 is not None:
        counters = {k: c1[k] - c0[k] for k in c0}
        decode_steps = counters["n_ticks"] * steps_per_tick
    else:
        counters = None
        decode_steps = decode_rows
    readings = Readings(shapes=shapes, window_s=window_s, counters=counters,
                        decode_steps=decode_steps, decode_rows=decode_rows,
                        kv_positions=kv_positions, prefill_lengths=prefill_lengths,
                        spans=spans)
    result = {"attempted": len(in_win), "failed": failed}
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    if tracer is not None:
        t0 = time.perf_counter()
        dev_trace, offset = tracer.device_trace()
        # the window on the device's clock: the host's, moved by the marker
        lo = int(round(t_open * 1e9)) + offset
        hi = int(round(t_close * 1e9)) + offset
        dev_trace = dev_trace.clip(lo, hi)
        readings.device, readings.trace_lo, readings.trace_hi = dev_trace, lo, hi
        ops, idle, busy_s = breakdown(dev_trace, tracer.sampler.samples, offset, lo, hi)
        device_info.update(busy_s=busy_s, window_s=(hi - lo) / 1e9)
        result["breakdown"] = {"device_ops": ops, "idle_gaps": idle}
        log(f"trace: profiler stopped in {tracer.stop_s:.1f} s, {len(dev_trace)} device "
            f"activities read in {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    metrics = {}
    if trace:
        for m in per_layer:
            v = metric_reader(m["name"]).read(readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in end_to_end:
            v = e2e.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the check: the served greedy tokens against the reference; with a
    # control (a rounding, reference.fp8_rows), the reference in that
    # precision put in the program's place, judged by the same rule at the
    # same positions
    pick = check_sample(sent, seed)
    n_tok = sum(len(r.tokens) for r in pick)
    t0 = time.perf_counter()
    gap = float(reference_gaps(conf, raw, pick, device).max()) if pick else float("inf")
    log(f"reference: {len(pick)} requests, {n_tok} served greedy tokens, "
        f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
    if control is not None and pick:
        result["control"] = {"program_logit_gap": gap}
        gap = float(reference_gaps(conf, raw, pick, device, lowp=control).max())
    checks = {"logit_gap": {"value": gap, "limit": limits["logit_gap"]["limit"]},
              "tokens_checked": {"value": n_tok, "limit": MIN_CHECK_TOKENS}}
    correct = (gap <= limits["logit_gap"]["limit"] and n_tok >= MIN_CHECK_TOKENS
               and failed == 0 and not loaded)
    result.update(correct=correct, metrics=metrics, device=device_info, checks=checks,
                  forbidden_loaded=loaded)
    return result
