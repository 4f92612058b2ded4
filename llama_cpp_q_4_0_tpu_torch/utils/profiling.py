"""Tracing and profiling: the GGML_PERF and graph-dump story, on torch.

The reference accumulates per-node perf counters in the executor
(ggml_graph_compute_perf_stats_node, ggml.c:17066) and prints them with
ggml_graph_print (ggml.c:18120) / renders graphviz (ggml_graph_dump_dot,
ggml.c:18212).  The names are the JAX package's, with torch underneath:

  - op_histogram: the op counts of one decode step's graph, the graph
    ``runtime/export.py`` exports (``torch.export`` of the Context's decode
    step), so each kernel appears as its custom op (``llama_cpp_q4::...``)
  - dump_graph: that histogram as text, with the step's input, output and
    cache bytes
  - dump_hlo: the exported program's code
  - trace: a ``torch.profiler`` device trace written under a directory
  - time_jit: milliseconds a call with a hard device sync
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import Counter

import torch
import torch.utils._pytree as pytree


def _decode_program(ctx, n_tokens: int = 1):
    """The ExportedProgram of ctx's decode step on its params (the decode
    view) and its caches (traced, not written)."""
    from ..runtime.export import trace_step

    ep, _ = trace_step(ctx.cfg, ctx.params, batch=ctx.batch, n_tokens=n_tokens,
                       n_ctx=ctx.n_ctx, device=ctx.device,
                       caches=(ctx.cache_k, ctx.cache_v))
    return ep


def _op_name(target) -> str:
    return target.name() if hasattr(target, "name") else getattr(target, "__name__", str(target))


def op_histogram_from_program(ep) -> Counter:
    return Counter(_op_name(n.target) for n in ep.graph.nodes if n.op == "call_function")


def op_histogram(ctx, n_tokens: int = 1) -> Counter:
    """Counts of each op (``aten::mm``, ``llama_cpp_q4::qmm_packed_kfold``, ...)
    in one decode step's exported graph."""
    return op_histogram_from_program(_decode_program(ctx, n_tokens))


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in pytree.tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def dump_graph(ctx, n_tokens: int = 1, *, compiled_stats: bool = True) -> str:
    """Text dump of the decode step (the ggml_graph_print analogue): the op
    histogram, and with compiled_stats the bytes of the step's arguments
    (weights, caches, tokens), of its output and of the caches it writes in
    place."""
    ep = _decode_program(ctx, n_tokens)
    hist = op_histogram_from_program(ep)
    lines = [f"=== decode step graph (n_tokens={n_tokens}) ===",
             f"{sum(hist.values())} nodes, {len(hist)} distinct ops:"]
    for op, cnt in hist.most_common():
        lines.append(f"  {op:40s} x {cnt}")
    if compiled_stats:
        caches = _nbytes((ctx.cache_k, ctx.cache_v))
        out = [n for n in ep.graph.nodes if n.op == "output"][0].args[0]
        out_bytes = sum(_nbytes(a.meta.get("val")) for a in pytree.tree_leaves(out)
                        if hasattr(a, "meta"))
        kernels = sum(v for k, v in hist.items() if k.startswith("llama_cpp_q4::"))
        args = _nbytes(ctx.params) + caches + 8 * (ctx.batch * n_tokens + 1)  # + tokens, n_past
        lines += ["graph stats:",
                  f"  argument_size_in_bytes: {args}",
                  f"  output_size_in_bytes: {out_bytes}",
                  f"  mutated_input_bytes: {caches}",
                  f"  kernel ops: {kernels}"]
    return "\n".join(lines)


def dump_hlo(ctx, n_tokens: int = 1, optimized: bool = False) -> str:
    """The exported decode step's code (the ggml_graph_dump_dot analogue; feed
    it to external tools).  torch has no HLO: the nearest IR is the
    ExportedProgram's graph, printed here as its Python code; optimized gives
    it after ``run_decompositions()`` (the core ATen op set), where each
    kernel op stays one node."""
    ep = _decode_program(ctx, n_tokens)
    if optimized:
        ep = ep.run_decompositions()
    return ep.graph_module.code


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` trace (CPU, and the card's kernels when CUDA is
    present) of the block, written as a Chrome trace JSON file under log_dir
    (the GGML_PERF per-node timeline; open it in Perfetto or
    chrome://tracing).  Yields the profiler, for ``key_averages()``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def time_jit(fn, args, *, iters: int = 20, warmup: int = 1) -> float:
    """Wall-clock ms per call with a hard device sync (the JAX function's
    ``block_until_ready``): ``torch.cuda.synchronize()`` when an output
    tensor lies on the card.  fn is called repeatedly with the same
    arguments."""

    def sync(out):
        if any(isinstance(t, torch.Tensor) and t.is_cuda for t in pytree.tree_leaves(out)):
            torch.cuda.synchronize()

    for _ in range(warmup):
        sync(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args)
    sync(out)
    return (time.perf_counter() - t0) / iters * 1e3
