"""A (dp, sp, tp) mesh over the ranks of a ``torch.distributed`` world, and
the collectives the rest of ``parallel/`` calls.

The JAX package builds a ``jax.sharding.Mesh`` over its chips and lets XLA
insert the collectives.  Here each rank is one process with one device, the
mesh lays the world's ranks out as JAX lays its devices out
(``ranks[:n].reshape(dp, sp, tp)``), and every collective is written out:

  dp — data parallel (batch rows, the serving engine's slots)
  sp — sequence parallel (the cache's context slots; whole-prompt prefills
       split their tokens and ride the ring, parallel/ring_attention.py)
  tp — tensor parallel (weights split Megatron-style, parallel/tp.py)

``psum`` is an ``all_reduce``, ``all_gather`` gathers along one tensor
dimension (JAX's ``tiled=True``), ``ppermute`` is ``batch_isend_irecv``.
Under gloo (one card shared by several processes: NCCL refuses two ranks on
one device) a CUDA tensor goes to gloo as it is for the operations gloo
implements on CUDA tensors and through a host copy for the rest, by the
fixed table ``GLOO_CUDA_ROUTES``; the route each operation took is printed
once a process on the card.  Host tensors go to gloo as they are; under
NCCL every tensor goes as a device tensor.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device

MESH_AXES = ("dp", "sp", "tp")

# how a CUDA tensor reaches a gloo collective: "device" hands gloo the
# tensor (gloo stages it through pinned memory itself), "host" copies it to
# the host first.  gloo's send/recv take host memory only.
GLOO_CUDA_ROUTES = {"all_reduce": "device", "all_gather": "device",
                    "broadcast": "device", "ppermute": "host"}

routes_taken: dict[str, str] = {}  # collective -> route, as this process took them


class Mesh:
    """This rank's view of a (dp, sp, tp) mesh: ``shape`` (a dict in
    ``MESH_AXES`` order), ``devices`` (the ranks as a [dp, sp, tp] array, the
    JAX mesh's device grid), this rank's ``coords`` (None for a rank beyond
    the mesh), one process group per axis, and ``device``, where this rank
    computes.  Every rank of the world builds it, with the same sizes, in
    the same order (``dist.new_group`` is collective)."""

    def __init__(self, dp: int = 1, sp: int = 1, tp: int = 1, *, device=None):
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized: call "
                               "parallel.distributed.initialize first")
        world, rank = dist.get_world_size(), dist.get_rank()
        n = dp * sp * tp
        if n > world:
            raise ValueError(f"a {dp}x{sp}x{tp} mesh needs {n} ranks; the world has {world}")
        self.shape = {"dp": dp, "sp": sp, "tp": tp}
        self.axis_names = MESH_AXES
        self.devices = np.arange(n).reshape(dp, sp, tp)
        self.rank = rank
        self.coords = None
        if rank < n:
            self.coords = dict(zip(MESH_AXES, (int(c) for c in
                                               np.argwhere(self.devices == rank)[0])))
        self.groups: dict = {}
        self.ranks: dict = {}
        for i, ax in enumerate(MESH_AXES):
            lines = np.moveaxis(self.devices, i, -1).reshape(-1, self.devices.shape[i])
            for line in lines.tolist():
                g = dist.new_group(line)
                if rank in line:
                    self.groups[ax], self.ranks[ax] = g, line
        self.groups[None] = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
        self.ranks[None] = list(range(n))
        if device is None:
            resolve_device("cuda")  # raises without CUDA
            device = f"cuda:{rank % torch.cuda.device_count()}"
        self.device = resolve_device(device)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords}, device={self.device})"


def make_mesh(dp: int = 1, sp: int = 1, tp: int = 1, *, device=None) -> Mesh:
    """The JAX ``make_mesh``: the first dp*sp*tp ranks of the world laid out
    [dp, sp, tp].  device: this rank's device (default ``cuda:(rank %
    device_count)``; "cpu" runs the rank on the host)."""
    return Mesh(dp, sp, tp, device=device)


def auto_mesh(n_devices: int | None = None, *, device=None) -> Mesh:
    """Split the ranks over (dp, sp, tp) as the JAX ``auto_mesh`` splits
    devices: tp = gcd(n, 4) for even n (else 1), then dp = 2 where the rest
    is even, and sp the rest."""
    n = n_devices or dist.get_world_size()
    tp = math.gcd(n, 4) if n % 2 == 0 else 1
    rest = n // tp
    dp = 2 if rest % 2 == 0 else 1
    return make_mesh(dp=dp, sp=rest // dp, tp=tp, device=device)


def named(mesh: Mesh, *spec) -> tuple:
    """The JAX ``named`` builds an XLA NamedSharding, which has no meaning
    here: this counterpart returns the spec itself (a tuple naming the mesh
    axis of each tensor dimension), the form ``parallel/shard.py`` takes."""
    return tuple(spec)


def axis_size(mesh: Mesh, axis) -> int:
    return mesh.size if axis is None else mesh.shape[axis]


def axis_index(mesh: Mesh, axis: str) -> int:
    return mesh.coords[axis]


def _route(op: str, t: torch.Tensor, group) -> str:
    backend = dist.get_backend(group)
    if backend == "nccl":
        route = "device"
    elif t.device.type == "cuda":
        route = GLOO_CUDA_ROUTES[op]
    else:
        return "host"
    if op not in routes_taken:
        routes_taken[op] = route
        if t.device.type == "cuda":
            print(f"mesh: {op} of CUDA tensors under {backend}: {route}", file=sys.stderr,
                  flush=True)
    return route


def _send_form(op: str, t: torch.Tensor, mesh: Mesh, group) -> torch.Tensor:
    """t as the collective takes it: a contiguous tensor of its own (the
    in-place collectives must not write into t) on the host or on the
    device, per ``_route``."""
    route = _route(op, t, group)
    if route == "host":
        y = t.detach().cpu()
    elif dist.get_backend(group) == "nccl" and t.device.type != "cuda":
        y = t.to(mesh.device)
    else:
        y = t
    y = y.contiguous()
    return y.clone() if y.data_ptr() == t.data_ptr() else y


def psum(x: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """The sum of x over the ranks of ``axis`` (None: the whole mesh), on
    every one of them (``jax.lax.psum``)."""
    return all_reduce(x, mesh, axis)


def all_reduce(x: torch.Tensor, mesh: Mesh, axis=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """x reduced by op over the ranks of ``axis`` (None: the whole mesh)."""
    if axis_size(mesh, axis) == 1:
        return x
    g = mesh.groups[axis]
    y = _send_form("all_reduce", x, mesh, g)
    dist.all_reduce(y, op=op, group=g)
    return y.to(x.device)


def all_gather(x: torch.Tensor, mesh: Mesh, axis, dim: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """The blocks of every rank of ``axis``, in its order, concatenated
    along dim (tiled, ``jax.lax.all_gather(..., tiled=True)``) or stacked
    on a new leading dim."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x if tiled else x[None]
    g = mesh.groups[axis]
    y = _send_form("all_gather", x, mesh, g)
    parts = [torch.empty_like(y) for _ in range(n)]
    dist.all_gather(parts, y, group=g)
    parts = [p.to(x.device) for p in parts]
    return torch.cat(parts, dim=dim) if tiled else torch.stack(parts)


def broadcast(x: torch.Tensor, mesh: Mesh, axis=None, src: int = 0) -> torch.Tensor:
    """x of the rank at index src along ``axis`` (None: the whole mesh), on
    every rank."""
    if axis_size(mesh, axis) == 1:
        return x
    g = mesh.groups[axis]
    y = _send_form("broadcast", x, mesh, g)
    dist.broadcast(y, src=mesh.ranks[axis][src], group=g)
    return y.to(x.device)


class _Hop:
    """A ppermute in flight: ``wait()`` returns what this rank received
    (zeros where no rank sends to it, as ``jax.lax.ppermute``)."""

    def __init__(self, works, out, device):
        self.works, self.out, self.device = works, out, device

    def wait(self) -> torch.Tensor:
        for w in self.works:
            w.wait()
        return self.out.to(self.device)


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str, perm, *, async_op: bool = False):
    """``jax.lax.ppermute``: perm is a list of (source, destination) indices
    along ``axis``; each rank sends x to its destination and returns the
    block its source sent (zeros if none).  With async_op the sends and the
    receive are issued and a handle is returned, whose ``wait()`` gives the
    block: the ring issues a hop before it computes on the block it holds."""
    me = mesh.coords[axis]
    g = mesh.groups[axis]
    ranks = mesh.ranks[axis]
    y = _send_form("ppermute", x, mesh, g)
    out = torch.zeros_like(y)
    ops = []
    for s, d in perm:
        if s == me and d == me:
            out.copy_(y)
        elif s == me:
            ops.append(dist.P2POp(dist.isend, y, ranks[d], g))
        elif d == me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[s], g))
    works = dist.batch_isend_irecv(ops) if ops else []
    hop = _Hop(works, out, x.device)
    return hop if async_op else hop.wait()

