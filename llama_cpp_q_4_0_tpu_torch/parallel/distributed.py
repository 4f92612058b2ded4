"""Process groups: ``torch.distributed`` bring-up and the mesh over a whole job.

The JAX package's ``parallel/distributed.py`` wraps ``jax.distributed`` and
lays tp inside a host's chips and dp across hosts.  Here every rank is one
process with one device; ``initialize`` wraps ``dist.init_process_group``
with the backend named by the caller (NCCL for one card a rank, gloo where
ranks share a card or run on the host: the choice is the caller's and is
never changed on a failure), and ``pod_mesh`` lays the world's ranks out as
the JAX one lays its devices out.  Failure semantics follow the reference:
any error aborts the job; restart and reload is the recovery path.
"""

from __future__ import annotations

import os

import torch.distributed as dist

from .mesh import Mesh


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, backend: str = "nccl") -> None:
    """``dist.init_process_group`` for this process; a no-op when the
    default group exists already.  coordinator_address: "host:port" (a TCP
    store), a URL (``tcp://...``, ``file://...``) as it is, or None for the
    ``env://`` variables torchrun sets (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK).  backend: "nccl" or "gloo", used as given."""
    if dist.is_initialized():
        return
    if coordinator_address is None:
        init = "env://"
    elif "://" in coordinator_address:
        init = coordinator_address
    else:
        init = f"tcp://{coordinator_address}"
    kw = {}
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    dist.init_process_group(backend=backend, init_method=init, **kw)


def pod_mesh(tp: int | None = None, sp: int = 1, *, device=None) -> Mesh:
    """A mesh over every rank of the job: tp packed within each host's ranks,
    dp spanning hosts.  tp defaults to the ranks of one host
    (``LOCAL_WORLD_SIZE``, which torchrun sets; else the whole world, one
    host).  Ranks are numbered host by host, so the reshape keeps each
    host's ranks contiguous on the tp axis."""
    n = dist.get_world_size()
    tp = tp or int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if n % (tp * sp):
        raise ValueError(f"{n} ranks do not split into tp {tp} x sp {sp}")
    return Mesh(n // (tp * sp), sp, tp, device=device)


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def sync_hosts(name: str = "barrier", mesh: Mesh | None = None) -> None:
    """A barrier over every rank (checkpoint writes wait on it), or over the
    ranks of mesh (a session file its primary rank wrote).  name labels the
    call, as the JAX one's; a single process returns at once."""
    del name
    if mesh is not None:
        if mesh.size > 1:
            dist.barrier(group=mesh.groups[None])
    elif dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
