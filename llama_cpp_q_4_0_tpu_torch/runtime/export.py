"""Ahead-of-time graph export and import: one decode step and its weights
in one file.

The reference's ``ggml_graph_export``/``import`` (ggml.c:17621-18348) and
``llama_eval_export`` (llama.cpp:3413) dump the compute graph with its data,
so that a stripped runner (examples/metal/metal.cpp) replays it without model
code.  Here ``torch.export`` traces the step a ``Context`` captures for its
decode key (``context._eval_step``: tokens, a 0-d ``n_past`` tensor and the
caches in, logits out, the caches written in place) into an
``ExportedProgram``: the cache writes stay in the graph as in-place ops on
its inputs, and every kernel on the route is one node, its custom op of
``ops/library.py`` (K1, K2, K5, K6, K6b, K7, K3, K4 by name).  The file is a
zip as in the JAX package: ``meta.json`` (``EXPORT_MAGIC``, the config, the
shapes, the device, the cache dtype and the routing switches at export),
``step.pt2`` (``torch.export.save``) and ``params.pkl``, the weights as
host tensors.  ``load_exported`` replays the step with no model code.  Load
exported files from trusted sources only: the weights are pickled.

The graph runs on the device it was exported on (its constants are
placed there); the routes of the ``QMM_*`` and ``FUSED_ATTN`` switches are
those of the export, whatever the environment holds when it replays.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import pickle
import zipfile

import numpy as np
import torch
import torch.utils._pytree as pytree

from .. import resolve_device
from ..models.config import ModelConfig
from ..models.transformer import Block, TransformerParams, init_cache
from ..ops.kvcache import QuantKV
from ..ops.qtensor import QTensor
from ..quant.types import GGMLType

EXPORT_MAGIC = "ggtx"  # the ggml graph-export analogue
CACHE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                "float32": torch.float32, "int8": torch.int8,
                "float8_e4m3fn": torch.float8_e4m3fn}


def _register_pytrees():
    """torch.export flattens its inputs as pytrees: QTensor, Block,
    TransformerParams and the q8 cache's QuantKV, each with its fields that
    hold a tensor (or a QTensor, a tuple of blocks) as children and the
    names of those fields as context; a QTensor's gsize, qtype, shape and
    pack_zero join its context.  Absent fields (None) are left out, so that
    a fused block's ``wqkv`` never sits beside a ``wq`` key.  Contexts
    serialize as JSON."""
    meta = {QTensor: ("gsize", "qtype", "shape", "pack_zero")}

    def flatten(obj):
        skip = meta.get(type(obj), ())
        names = tuple(f.name for f in dataclasses.fields(obj)
                      if f.name not in skip and getattr(obj, f.name) is not None)
        extra = tuple(int(getattr(obj, n)) if n == "qtype" else getattr(obj, n) for n in skip)
        return [getattr(obj, n) for n in names], (names, extra)

    def unflatten_fn(cls):
        def unflatten(children, ctx):
            names, extra = ctx
            kw = {f.name: None for f in dataclasses.fields(cls)}
            kw.update(zip(names, children))
            for n, v in zip(meta.get(cls, ()), extra):
                kw[n] = GGMLType(v) if n == "qtype" else tuple(v) if n == "shape" else v
            return cls(**kw)
        return unflatten

    def with_keys(obj):
        children, ctx = flatten(obj)
        return [(pytree.GetAttrKey(n), c) for n, c in zip(ctx[0], children)], ctx

    def from_json(s):
        names, extra = json.loads(s)
        return tuple(names), tuple(tuple(v) if isinstance(v, list) else v for v in extra)

    for cls in (QTensor, Block, TransformerParams, QuantKV):
        if cls not in pytree.SUPPORTED_NODES:
            pytree.register_pytree_node(
                cls, flatten, unflatten_fn(cls),
                serialized_type_name=f"llama_cpp_q_4_0_tpu_torch.{cls.__name__}",
                flatten_with_keys_fn=with_keys,
                to_dumpable_context=lambda ctx: json.dumps([list(ctx[0]), list(ctx[1])]),
                from_dumpable_context=from_json)


_register_pytrees()


class _Step(torch.nn.Module):
    """The Context's decode step as a module: ``context._eval_step`` with the
    last row's logits, over the whole cache."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg

    def forward(self, params, tokens, n_past, cache_k, cache_v):
        from .context import _eval_step

        return _eval_step(self.cfg, params, tokens, n_past, cache_k, cache_v, True)


def to_device(tree, device):
    """Every tensor of a params or cache tree moved to device."""
    return pytree.tree_map(lambda t: t.to(device) if isinstance(t, torch.Tensor) else t, tree)


def _switches() -> dict:
    from .context import SWITCHES

    return {k: os.environ[k] for k in SWITCHES if k in os.environ}


@torch.no_grad()
def trace_step(cfg: ModelConfig, params: TransformerParams, *, batch: int = 1,
               n_tokens: int = 1, n_ctx: int | None = None, device=None,
               cache_dtype=torch.bfloat16, caches=None):
    """(ExportedProgram, example caches) of one decode step: ``n_tokens``
    tokens of ``batch`` rows at a traced ``n_past`` over an ``n_ctx``-slot
    cache of ``cache_dtype`` (or the given (cache_k, cache_v)), on device
    (cuda unless the caller names the CPU; params are moved there)."""
    dev = resolve_device(device)
    n_ctx = n_ctx or cfg.n_ctx
    params = to_device(params, dev)
    if caches is None:
        caches = init_cache(cfg, batch, n_ctx, cache_dtype, dev)
    tokens = torch.zeros((batch, n_tokens), dtype=torch.int64, device=dev)
    n_past = torch.zeros((), dtype=torch.int64, device=dev)
    ep = torch.export.export(_Step(cfg), (params, tokens, n_past, *caches), strict=False)
    return ep, caches


def export_decode(cfg: ModelConfig, params: TransformerParams, path: str, *,
                  batch: int = 1, n_tokens: int = 1, n_ctx: int | None = None,
                  device=None, cache_dtype=torch.bfloat16) -> None:
    """Write one decode step (tokens -> last-row logits, the caches written
    in place) and the weights to path.  The step replays on ``device`` (cuda
    unless the caller passes "cpu"), the device it is traced on."""
    dev = resolve_device(device)
    n_ctx = n_ctx or cfg.n_ctx
    ep, _ = trace_step(cfg, params, batch=batch, n_tokens=n_tokens, n_ctx=n_ctx, device=dev,
                       cache_dtype=cache_dtype)
    ep.example_inputs = None  # the weights travel once, in params.pkl
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    meta = {"magic": EXPORT_MAGIC, "config": dataclasses.asdict(cfg), "batch": batch,
            "n_tokens": n_tokens, "n_ctx": n_ctx, "device": dev.type,
            "cache_dtype": str(cache_dtype).removeprefix("torch."), "switches": _switches()}
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("meta.json", json.dumps(meta))
        z.writestr("step.pt2", buf.getvalue())
        z.writestr("params.pkl", pickle.dumps(to_device(params, "cpu"), protocol=4))


class ExportedModel:
    """The standalone replayer (the examples/metal/metal.cpp analogue): the
    loaded step, the weights and its own caches; no model code runs."""

    def __init__(self, meta: dict, exported, params):
        self.meta = meta
        self.cfg = ModelConfig(**meta["config"])
        self.device = resolve_device(meta["device"])
        self.n_ctx = meta["n_ctx"]
        self.batch = meta["batch"]
        self.n_tokens = meta["n_tokens"]
        self._exported = exported
        self._step = exported.module()
        self._params = to_device(params, self.device)
        self.cache_k, self.cache_v = init_cache(self.cfg, self.batch, self.n_ctx,
                                                CACHE_DTYPES[meta["cache_dtype"]], self.device)
        self.n_past = 0

    @torch.no_grad()
    def step_tensor(self, tokens) -> torch.Tensor:
        """One step on the device: logits [batch, 1, n_vocab] f32, the caches
        written and n_past advanced by n_tokens."""
        tokens = torch.as_tensor(np.atleast_2d(np.asarray(tokens, np.int64)))
        if tuple(tokens.shape) != (self.batch, self.n_tokens):
            raise ValueError(f"exported for shape {(self.batch, self.n_tokens)}, got "
                             f"{tuple(tokens.shape)}")
        if self.n_past + self.n_tokens > self.n_ctx:
            raise ValueError("context overflow")
        n_past = torch.full((), self.n_past, dtype=torch.int64, device=self.device)
        logits = self._step(self._params, tokens.to(self.device), n_past, self.cache_k,
                            self.cache_v)
        self.n_past += self.n_tokens
        return logits

    def step(self, tokens) -> np.ndarray:
        """One step from host tokens [batch, n_tokens]: the logits as a host array."""
        return self.step_tensor(tokens).cpu().numpy()


def load_exported(path: str) -> ExportedModel:
    from ..ops import library  # noqa: F401  the kernels' ops, which the graph names

    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        if meta.get("magic") != EXPORT_MAGIC:
            raise ValueError(f"{path}: not an exported graph")
        exported = torch.export.load(io.BytesIO(z.read("step.pt2")))
        params = pickle.loads(z.read("params.pkl"))
    return ExportedModel(meta, exported, params)
