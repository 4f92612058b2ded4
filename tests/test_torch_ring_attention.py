"""The port's ring attention (parallel/ring_attention.py) in a 4-process
gloo world on the CPU against the JAX ``ring_self_attention`` on the
virtual 8-device mesh, at tests/test_ring_attention.py's 1e-5: sp 2 and 4,
query heads over as many KV heads, over one (MQA) and over two (GQA).  Each
rank holds its T/sp block of q, k and v and gets its block of the output.
sp 2 runs on a dp 2 x sp 2 mesh: two rings side by side.  Rows whose only
key is themselves (the first token) stay finite."""

import os

import numpy as np
import pytest

from torch_worlds import load, run_jax, run_world, save

HERE = os.path.abspath(__file__)
CASES = [(4, 4, 4), (2, 4, 1), (4, 8, 2), (2, 4, 2)]  # (sp, heads, kv heads)


def _inputs(heads, kv_heads):
    rng = np.random.default_rng(0)
    b, t, d = 2, 32, 16
    return tuple(rng.standard_normal((b, t, h, d)).astype(np.float32)
                 for h in (heads, kv_heads, kv_heads))


def _first_inputs():
    return np.random.default_rng(1).standard_normal((1, 16, 2, 8)).astype(np.float32)


def jax_refs(out: str) -> None:
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from llama_cpp_q_4_0_tpu.parallel import make_mesh
    from llama_cpp_q_4_0_tpu.parallel.ring_attention import ring_self_attention
    from llama_cpp_q_4_0_tpu.parallel.shard import _put

    refs = {}
    spec = P(None, "sp", None, None)
    for sp, heads, kv in CASES:
        mesh = make_mesh(dp=1, sp=sp, tp=1)
        q, k, v = (_put(jnp.asarray(a), mesh, spec) for a in _inputs(heads, kv))
        refs[(sp, heads, kv)] = np.asarray(ring_self_attention(q, k, v, mesh, scale=0.25))
    mesh = make_mesh(dp=1, sp=4, tp=1)
    x = _put(jnp.asarray(_first_inputs()), mesh, spec)
    refs["first"] = np.asarray(ring_self_attention(x, x, x, mesh))
    save(out, "refs", refs)


def port_world(rank: int, out: str) -> None:
    import torch

    from llama_cpp_q_4_0_tpu_torch.parallel import make_mesh
    from llama_cpp_q_4_0_tpu_torch.parallel.ring_attention import ring_self_attention
    from llama_cpp_q_4_0_tpu_torch.parallel.shard import local_slice

    meshes = {4: make_mesh(sp=4, device="cpu"), 2: make_mesh(dp=2, sp=2, device="cpu")}
    spec = (None, "sp", None, None)
    got = {}
    for sp, heads, kv in CASES:
        mesh = meshes[sp]
        q, k, v = (local_slice(torch.from_numpy(a), mesh, spec) for a in _inputs(heads, kv))
        got[(sp, heads, kv)] = ring_self_attention(q, k, v, mesh, scale=0.25).numpy()
    x = local_slice(torch.from_numpy(_first_inputs()), meshes[4], spec)
    got["first"] = ring_self_attention(x, x, x, meshes[4]).numpy()
    save(out, f"got_{rank}", got)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ring"))
    run_jax(HERE, "jax_refs", out)
    run_world(4, HERE, "port_world", out)
    return load(out, "refs"), [load(out, f"got_{r}") for r in range(4)]


def _block(a, sp, rank):
    """Rank's block of the whole output: its sp coordinate's T/sp tokens
    (the ranks of a dp 2 x sp 2 mesh are [[0, 1], [2, 3]])."""
    i = rank % sp
    tl = a.shape[1] // sp
    return a[:, i * tl:(i + 1) * tl]


@pytest.mark.parametrize("sp,heads,kv_heads", CASES)
def test_ring_matches_jax(world, sp, heads, kv_heads):
    refs, got = world
    want = refs[(sp, heads, kv_heads)]
    for rank, g in enumerate(got):
        np.testing.assert_allclose(g[(sp, heads, kv_heads)], _block(want, sp, rank),
                                   rtol=1e-5, atol=1e-5)


def test_ring_first_token_rows_finite(world):
    refs, got = world
    for rank, g in enumerate(got):
        assert np.isfinite(g["first"]).all()
        np.testing.assert_allclose(g["first"], _block(refs["first"], 4, rank),
                                   rtol=1e-5, atol=1e-5)
