"""Multi-rank serving and training over torch.distributed: the mesh, its
collectives and their autograd forms, the sharding rules, the sharded
training forward and the GPipe pipeline (the JAX package's ``parallel/``)."""

from . import pipeline
from .mesh import MESH_AXES, auto_mesh, make_mesh, make_pp_mesh, named
from .shard import (
    cache_spec,
    gather_params,
    replicate,
    shard_block,
    shard_cache,
    shard_tokens,
    shard_transformer,
    shard_tree,
    put_weight,
)

__all__ = [
    "MESH_AXES",
    "auto_mesh",
    "make_mesh",
    "make_pp_mesh",
    "named",
    "pipeline",
    "cache_spec",
    "gather_params",
    "replicate",
    "shard_block",
    "shard_cache",
    "shard_tokens",
    "shard_transformer",
    "shard_tree",
    "put_weight",
]
