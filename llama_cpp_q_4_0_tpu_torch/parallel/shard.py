"""Sharding rules: which slice of each param and KV cache a rank keeps.

The JAX package places global arrays with NamedShardings and lets XLA
partition them.  Here there is no global array: each rank keeps its local
slice, the one a spec names.  A spec is a tuple naming the mesh axis that
splits each tensor dimension (None: not split), JAX's PartitionSpec as a
tuple.  Megatron's split, as the JAX ``parallel/shard.py``:

  column-parallel (the output dim N over tp): wq wk wv w_gate w_up, their
      biases, the embedding and the output head (both over the vocabulary);
  row-parallel (the reduce dim K over tp): wo w_down, whose partial sums
      parallel/tp.py adds with one psum each;
  everything else replicated.

A QTensor's levels [K, N] (packed [K2P, N]) and its scale planes [K/g, N]
(packed [2, G, N], split on the axis after the leading one) take the same
split, so every rank holds whole quant groups; its ``shape`` stays global,
as the JAX one's, and ``parallel/tp.py::_localize`` makes it local.

The way back is ``gather_params``: the whole tensors, in JAX's layout, of
dense params or of an optimizer state of them, on every rank (tests,
checkpoints and the card's comparisons).  A leaf's spec follows from its
JAX path (``leaf_spec``), so a state's moments and L-BFGS memories take
their params' split.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

import torch

from ..models.config import ModelConfig
from ..models.transformer import Block, TransformerParams
from ..ops.kvcache import F8, QuantKV
from ..ops.qtensor import QTensor
from ..training.tree import map_with_path
from .mesh import Mesh, all_gather


def local_slice(x: torch.Tensor, mesh: Mesh, spec: tuple) -> torch.Tensor:
    """This rank's block of x under spec: each dimension named by a mesh
    axis is cut into that axis's size and the block at this rank's
    coordinate kept; the result is contiguous and on the mesh's device."""
    for dim, axis in enumerate(spec):
        if axis is None or mesh.shape[axis] == 1:
            continue
        n = mesh.shape[axis]
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {axis}={n}")
        step = x.shape[dim] // n
        x = x.narrow(dim, mesh.coords[axis] * step, step)
    return x.to(mesh.device).contiguous()


def _put(x, mesh: Mesh, spec: tuple):
    if x is None:
        return None
    return local_slice(x, mesh, spec)


def weight_specs(w: Any, dim: str, axis: str = "tp"):
    """(levels spec, planes spec) of a QTensor, or the spec of a dense
    weight ([N, K] or [N]), for dim "col", "row" or "rep" (the JAX
    ``put_weight``'s rule)."""
    if isinstance(w, QTensor):
        spec = {"col": (None, axis), "row": (axis, None), "rep": (None, None)}[dim]
        return spec, ((None, *spec) if w.packed else spec)
    if w.dim() == 2:
        return {"col": (axis, None), "row": (None, axis), "rep": (None, None)}[dim]
    if w.dim() == 1:
        return (axis,) if dim == "col" else (None,)
    return (None,) * w.dim()


def put_weight(w: Any, mesh: Mesh, dim: str, axis: str = "tp"):
    """This rank's slice of a weight (QTensor [N, K] or dense [N, K] / [N]):
    dim='col' splits the output dim N, 'row' the reduce dim K, 'rep' keeps
    it whole.  A packed QTensor splits its packed rows for 'row', as the JAX
    one: such a slice is not a contiguous K range (``prepare_tp_params``
    repacks row weights per shard instead)."""
    if w is None:
        return None
    if isinstance(w, QTensor):
        spec, sspec = weight_specs(w, dim, axis)
        return dataclasses.replace(w, levels_t=_put(w.levels_t, mesh, spec),
                                   gscale_t=_put(w.gscale_t, mesh, sspec),
                                   gbias_t=_put(w.gbias_t, mesh, sspec))
    return _put(w, mesh, weight_specs(w, dim, axis))


# Which Block fields are column- vs row-parallel (everything else replicated).
BLOCK_COL = ("wq", "wk", "wv", "bq", "bk", "bv", "w_gate", "w_up", "b_up",
             "wqkv", "b_qkv", "w_gateup")
BLOCK_ROW = ("wo", "w_down")


def block_dim(field: str) -> str:
    return "col" if field in BLOCK_COL else "row" if field in BLOCK_ROW else "rep"


def shard_block(blk: Block, mesh: Mesh) -> Block:
    return Block(**{f.name: put_weight(getattr(blk, f.name), mesh, block_dim(f.name))
                    for f in dataclasses.fields(Block)})


def shard_transformer(params: TransformerParams, mesh: Mesh) -> TransformerParams:
    return TransformerParams(
        tok_embeddings=put_weight(params.tok_embeddings, mesh, "col"),
        blocks=tuple(shard_block(b, mesh) for b in params.blocks),
        out_norm_w=put_weight(params.out_norm_w, mesh, "rep"),
        out_norm_b=put_weight(params.out_norm_b, mesh, "rep"),
        output=put_weight(params.output, mesh, "col"))


def kv_sharded(cfg: ModelConfig, tp: int) -> bool:
    """KV heads split over tp when they divide (MQA's one head, or fewer
    heads than ranks, is replicated: each rank keeps it whole)."""
    return cfg.kv_heads % tp == 0 and tp <= cfg.kv_heads


def cache_spec(cfg: ModelConfig, mesh: Mesh) -> tuple:
    """KV cache [B, S, H_kv, D]: the batch over dp; the context slots over
    sp when the mesh has a sequence axis (the context scales with the ranks,
    not one device's memory); the heads over tp when they divide."""
    heads = "tp" if kv_sharded(cfg, mesh.shape["tp"]) else None
    seq = "sp" if mesh.shape["sp"] > 1 else None
    return ("dp", seq, heads, None)


def shard_cache(cache_k, cache_v, cfg: ModelConfig, mesh: Mesh, spec: tuple | None = None):
    """This rank's slices of whole caches (spec defaults to cache_spec); a
    QuantKV's scale [B, S, H] takes the spec without its D axis."""
    spec = spec or cache_spec(cfg, mesh)

    def put(c):
        if isinstance(c, QuantKV):
            return QuantKV(_put(c.data, mesh, spec), _put(c.scale, mesh, spec[:3]))
        return _put(c, mesh, spec)

    return [put(c) for c in cache_k], [put(c) for c in cache_v]


def local_cache(cfg: ModelConfig, batch: int, n_ctx: int, dtype, mesh: Mesh,
                spec: tuple | None = None):
    """Zeroed per-layer caches of this rank's slice under spec (default
    cache_spec) of the [batch, n_ctx, H_kv, D] caches ``init_cache`` makes,
    on the mesh's device: what ``shard_cache(init_cache(...))`` keeps,
    without the whole caches."""
    spec = spec or cache_spec(cfg, mesh)
    shape = [batch, n_ctx, cfg.kv_heads, cfg.head_dim]
    for dim, axis in enumerate(spec):
        if axis is not None:
            if shape[dim] % mesh.shape[axis]:
                raise ValueError(f"cache dim {dim} of {shape} does not split over "
                                 f"{axis}={mesh.shape[axis]}")
            shape[dim] //= mesh.shape[axis]
    dev = mesh.device

    def mk():
        if dtype == torch.int8:
            return QuantKV(torch.zeros(shape, dtype=torch.int8, device=dev),
                           torch.zeros(shape[:3], dtype=torch.float32, device=dev))
        return torch.zeros(shape, dtype=torch.uint8 if dtype == F8 else dtype,
                           device=dev).view(dtype)

    return [mk() for _ in range(cfg.n_layer)], [mk() for _ in range(cfg.n_layer)]


def shard_tokens(tokens: torch.Tensor, mesh: Mesh, sequence_parallel: bool = False):
    """This rank's block of [B, T] tokens: the batch over dp, and the tokens
    over sp for a sequence-parallel prefill."""
    return _put(tokens, mesh, ("dp", "sp" if sequence_parallel else None))


def replicate(x, mesh: Mesh):
    """Every tensor of x (params, QTensors, lists) whole on the mesh's
    device."""
    if isinstance(x, torch.Tensor):
        return x.to(mesh.device)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: replicate(getattr(x, f.name), mesh)
                                         for f in dataclasses.fields(x)})
    if isinstance(x, (list, tuple)):
        return type(x)(replicate(v, mesh) for v in x)
    return x


# L-BFGS's memories hold m parameter-shaped differences on a leading axis
_MEMORY = ("diff_params_memory", "diff_updates_memory")


def leaf_spec(path: str, leaf: torch.Tensor) -> tuple:
    """The spec of a dense leaf as shard_transformer places it, from its
    JAX path (``.blocks[0].wq``, ``[0].mu.output``,
    ``[0].diff_params_memory.blocks[1].w_down``): the rule of the path's
    last field (weight_specs: the embedding and head "col", BLOCK_COL and
    BLOCK_ROW, the rest replicated), after a None for the memory axis of an
    L-BFGS memory.  Any other leaf (counts, step sizes, the memory's
    weights) is replicated."""
    names = re.findall(r"\.(\w+)", path)
    lead = int(any(n in _MEMORY for n in names))
    field = names[-1] if names else ""
    dim = "col" if field in ("tok_embeddings", "output") else block_dim(field)
    nd = leaf.dim() - lead
    if nd == 2:
        spec = {"col": ("tp", None), "row": (None, "tp"), "rep": (None, None)}[dim]
    elif nd == 1:
        spec = ("tp",) if dim == "col" else (None,)
    else:
        spec = (None,) * nd
    return (None,) * lead + spec


def gather_leaf(x: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """The whole tensor of this rank's block x under spec: every split
    dimension all-gathered over its axis (a collective: every rank of the
    axis calls it)."""
    with torch.no_grad():
        for dim, axis in enumerate(spec):
            if axis is not None and mesh.shape[axis] > 1:
                x = all_gather(x, mesh, axis, dim=dim)
    return x


def gather_params(tree, mesh: Mesh):
    """The inverse of shard_transformer for dense params, stacked or not, and
    of shard_tree for an optimizer state of them: every leaf whole, in JAX's
    layout, on every rank of the mesh (all of which must call it)."""
    return map_with_path(lambda path, x: gather_leaf(x, leaf_spec(path, x), mesh), tree)


def shard_tree(tree, mesh: Mesh):
    """This rank's slices of whole dense params or an optimizer state of
    them, by leaf_spec: what shard_transformer keeps of params, and tx.init
    of those local params of a state (a checkpoint loaded whole goes back
    onto a mesh through it).  Host scalars (counts, step sizes) stay as they
    are."""
    def put(path, x):
        spec = leaf_spec(path, x)
        return local_slice(x, mesh, spec) if x.dim() else x
    return map_with_path(put, tree)
