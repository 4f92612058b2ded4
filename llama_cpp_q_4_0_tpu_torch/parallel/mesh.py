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
The serving path calls them under ``no_grad``.  Training differentiates
through their autograd forms, each with its JAX transpose as its backward:
``reduce_from`` (psum; the cotangent as it is), ``copy_to`` (the identity;
psum of the cotangent: Megatron's "f" before a column-parallel product),
``gather_from`` (all_gather; this rank's slice of the cotangent, psum'd
first where the ranks' results differ) and ``ppermute_ad`` (the cotangent
sent back along the inverse permutation).  A mesh may also name its own
axes: ``make_pp_mesh`` builds JAX's 1-axis ``("pp",)`` mesh of
parallel/pipeline.py.
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
    computes.  axes: {name: size} in place of (dp, sp, tp), for a mesh of
    other named axes (``make_pp_mesh``).  Every rank of the world builds it,
    with the same sizes, in the same order (``dist.new_group`` is
    collective)."""

    def __init__(self, dp: int = 1, sp: int = 1, tp: int = 1, *, device=None,
                 axes: dict | None = None):
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized: call "
                               "parallel.distributed.initialize first")
        world, rank = dist.get_world_size(), dist.get_rank()
        sizes = {"dp": dp, "sp": sp, "tp": tp} if axes is None else dict(axes)
        n = math.prod(sizes.values())
        if n > world:
            raise ValueError(f"a {'x'.join(map(str, sizes.values()))} mesh needs {n} ranks; "
                             f"the world has {world}")
        self.shape = sizes
        self.axis_names = tuple(sizes)
        self.devices = np.arange(n).reshape(tuple(sizes.values()))
        self.rank = rank
        self.coords = None
        if rank < n:
            self.coords = dict(zip(self.axis_names, (int(c) for c in
                                                     np.argwhere(self.devices == rank)[0])))
        self.groups: dict = {}
        self.ranks: dict = {}
        for i, ax in enumerate(self.axis_names):
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


def make_pp_mesh(pp: int, *, device=None) -> Mesh:
    """The JAX pipeline's ``Mesh(devices[:pp], ("pp",))``: the first pp ranks
    of the world on one axis, "pp", stage s on rank s."""
    return Mesh(axes={"pp": pp}, device=device)


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


# -- the autograd forms -------------------------------------------------------

BUCKET = 1 << 26  # elements a host call of psum_flat sums at most (256 MiB of f32)


def psum_flat(ts: list, mesh: Mesh, axes) -> list:
    """Every tensor of ts summed over the ranks of each axis of axes (one
    name or a tuple, in order), few tensors to a call: they are flattened
    into buffers of one dtype and at most BUCKET elements (a larger tensor
    alone), each summed with one all_reduce an axis.  Returns new tensors
    of ts's shapes, in ts's order."""
    axes = tuple(a for a in ((axes,) if isinstance(axes, str) else axes)
                 if axis_size(mesh, a) > 1)
    out = list(ts)
    if not axes:
        return out
    buckets: list = []
    for i, t in enumerate(ts):
        last = buckets[-1] if buckets else None
        if (last is None or ts[last[0]].dtype != t.dtype or ts[last[0]].device != t.device
                or sum(ts[j].numel() for j in last) + t.numel() > BUCKET):
            buckets.append([i])
        else:
            last.append(i)
    for idx in buckets:
        flat = torch.cat([ts[j].reshape(-1) for j in idx])
        for ax in axes:
            flat = all_reduce(flat, mesh, ax)
        for j, part in zip(idx, flat.split([ts[j].numel() for j in idx])):
            out[j] = part.view(ts[j].shape)
    return out


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, *xs):
        ctx.mesh, ctx.axis = mesh, axis
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, *psum_flat(list(gs), ctx.mesh, ctx.axis))


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, same):
        ctx.mesh, ctx.axis, ctx.dim, ctx.same = mesh, axis, dim, same
        ctx.n = x.shape[dim]
        return all_gather(x, mesh, axis, dim=dim)

    @staticmethod
    def backward(ctx, g):
        if not ctx.same:
            g = all_reduce(g, ctx.mesh, ctx.axis)
        g = g.narrow(ctx.dim, axis_index(ctx.mesh, ctx.axis) * ctx.n, ctx.n)
        return g.contiguous(), None, None, None, None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, perm):
        ctx.mesh, ctx.axis, ctx.perm = mesh, axis, perm
        return ppermute(x, mesh, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return ppermute(g, ctx.mesh, ctx.axis, inverse), None, None, None


def reduce_from(x: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """psum over axis whose cotangent passes as it is: the output of a
    row-parallel product, or a loss summed over ranks (every rank goes on
    with the same sum, so each holds the whole cotangent)."""
    if axis_size(mesh, axis) == 1:
        return x
    return _ReduceFrom.apply(x, mesh, axis)


def copy_to(x: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """The identity, whose cotangent is psum'd over axis: a replicated value
    that each rank of axis uses for a part of its own (Megatron's "f"
    before a column-parallel product)."""
    if axis_size(mesh, axis) == 1:
        return x
    return _CopyTo.apply(mesh, axis, x)[0]


def copy_to_many(xs: list, mesh: Mesh, axis) -> list:
    """copy_to of several tensors as one node: their cotangents are psum'd
    together (psum_flat), once every one of them is complete."""
    if axis_size(mesh, axis) == 1:
        return list(xs)
    return list(_CopyTo.apply(mesh, axis, *xs))


def gather_from(x: torch.Tensor, mesh: Mesh, axis, dim: int, *, same: bool) -> torch.Tensor:
    """all_gather along dim.  same: every rank of axis goes on to compute the
    same value from the result (the tp head's logits), so its cotangent is
    already whole and this rank takes its slice; otherwise (sp's K/V in
    attention, each rank's queries its own) the cotangents are psum'd over
    axis before the slice."""
    if axis_size(mesh, axis) == 1:
        return x
    return _GatherFrom.apply(x, mesh, axis, dim, same)


def ppermute_ad(x: torch.Tensor, mesh: Mesh, axis: str, perm) -> torch.Tensor:
    """ppermute whose backward sends the cotangent back along the inverse
    permutation (a rank that sent nothing gets zeros).  Every rank of axis
    must run the backward of every hop, in the same order: keep what each
    hop delivers in the loss's graph on every rank."""
    return _Permute.apply(x, mesh, axis, perm)
