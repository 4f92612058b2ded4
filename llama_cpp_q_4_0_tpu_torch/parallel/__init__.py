"""Multi-rank serving over torch.distributed: the mesh, its collectives and
the sharding rules (the JAX package's ``parallel/``)."""

from .mesh import MESH_AXES, auto_mesh, make_mesh, named
from .shard import (
    cache_spec,
    replicate,
    shard_block,
    shard_cache,
    shard_tokens,
    shard_transformer,
    put_weight,
)

__all__ = [
    "MESH_AXES",
    "auto_mesh",
    "make_mesh",
    "named",
    "cache_spec",
    "replicate",
    "shard_block",
    "shard_cache",
    "shard_tokens",
    "shard_transformer",
    "put_weight",
]
