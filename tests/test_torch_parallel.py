"""The port's mesh, collectives and sharding rules (parallel/mesh.py,
parallel/shard.py) and the row-parallel layouts of ops/qtensor.py, against
the JAX package:

- ``QTensor.repack_row_shards`` and ``QTensor.unpack``: JAX's bytes, level
  for level and plane for plane (the 256-row padding of each shard and the
  local shape included), at tp 2 and 4, for q4_0 and the biased q4_1;
- in a 4-process gloo world on the CPU: the mesh's layout (JAX's
  ``devices.reshape(dp, sp, tp)``, ``auto_mesh``'s split), the collectives
  (psum, the tiled all-gather, the ppermute ring, broadcast), and each
  rank's slice from ``shard_transformer`` and ``shard_cache`` equal to the
  shard of JAX's NamedSharding at the same place of the mesh."""

import os

import numpy as np
import pytest
import torch

from torch_worlds import load, np_tree, port_model, run_jax, run_world, save

HERE = os.path.abspath(__file__)
MESH = dict(dp=2, sp=1, tp=2)


def _weight(n=64, k=512, seed=5):
    return (np.random.default_rng(seed).standard_normal((n, k)) * 0.2).astype(np.float32)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("qtype", ["Q4_0", "Q4_1"])
def test_row_layouts_are_jax_bytes(tp, qtype):
    from llama_cpp_q_4_0_tpu.ops.qtensor import QTensor as JQ
    from llama_cpp_q_4_0_tpu.quant.types import GGMLType as JT
    from llama_cpp_q_4_0_tpu_torch.ops.qtensor import QTensor
    from llama_cpp_q_4_0_tpu_torch.quant.types import GGMLType

    w = _weight()
    jq = JQ.quantize(w, JT[qtype])
    tq = QTensor.quantize(w, GGMLType[qtype], device="cpu")
    for want, got in ((jq.repack_row_shards(tp), tq.repack_row_shards(tp)),
                      (jq.unpack(), tq.unpack())):
        assert got.shape == tuple(want.shape) and got.pack_zero == want.pack_zero
        np.testing.assert_array_equal(got.levels_t.numpy(), np.asarray(want.levels_t))
        np.testing.assert_array_equal(got.gscale_t.numpy(), np.asarray(want.gscale_t))
        assert (got.gbias_t is None) == (want.gbias_t is None)
        if want.gbias_t is not None:
            np.testing.assert_array_equal(got.gbias_t.numpy(), np.asarray(want.gbias_t))
    rs = tq.repack_row_shards(tp)
    assert rs.shape == (64, 512 // tp)
    assert rs.levels_t.shape[0] == tp * 256  # each shard's 128 packed rows padded to 256


@pytest.mark.parametrize("kv_split", [True, False])
def test_param_specs_are_jax_specs(kv_split):
    """parallel/tp.py param_specs: JAX's PartitionSpecs, as tuples, leaf for
    leaf (the fused model's too; MQA's KV projections replicated)."""
    import dataclasses

    from llama_cpp_q_4_0_tpu.models.fuse import fuse_projections
    from llama_cpp_q_4_0_tpu.ops.qtensor import QTensor as JQ
    from llama_cpp_q_4_0_tpu.parallel.tp import param_specs as jax_specs
    from llama_cpp_q_4_0_tpu_torch.convert import params_from_numpy
    from llama_cpp_q_4_0_tpu_torch.models.config import ModelConfig
    from llama_cpp_q_4_0_tpu_torch.ops.qtensor import QTensor
    from llama_cpp_q_4_0_tpu_torch.parallel.tp import param_specs
    from test_parallel import tiny_q_model

    cfg, params = tiny_q_model(n_layer=1)
    for jp in (params, fuse_projections(cfg, params)):
        want = jax_specs(cfg, jp, kv_split)
        got = param_specs(ModelConfig(**dataclasses.asdict(cfg)),
                          params_from_numpy(np_tree(jp), device="cpu"), kv_split)
        pairs = [(want.tok_embeddings, got.tok_embeddings), (want.output, got.output),
                 (want.out_norm_w, got.out_norm_w)]
        pairs += [(getattr(want.blocks[0], f.name), getattr(got.blocks[0], f.name))
                  for f in dataclasses.fields(got.blocks[0])]
        for w, g in pairs:
            if isinstance(w, JQ):
                assert isinstance(g, QTensor)
                for name in ("levels_t", "gscale_t", "gbias_t"):
                    a, b = getattr(w, name), getattr(g, name)
                    assert (a is None and b is None) or tuple(a) == b, (name, a, b)
            else:
                assert (w is None and g is None) or tuple(w) == g, (w, g)


# ------------------------------------------------------------------ a world

def jax_refs(out: str) -> None:
    """JAX's shards of the tiny model and of a cache on a dp 2 x tp 2 mesh,
    by the position of their device in the mesh (rank order)."""
    import jax.numpy as jnp

    from llama_cpp_q_4_0_tpu.models import transformer
    from llama_cpp_q_4_0_tpu.parallel import make_mesh, shard_cache, shard_transformer
    from test_parallel import tiny_q_model
    from torch_worlds import jax_cfg_dict

    cfg, params = tiny_q_model(n_layer=1)
    save(out, "model", (jax_cfg_dict(cfg), np_tree(params)))
    mesh = make_mesh(**MESH)
    order = [d.id for d in mesh.devices.flat]

    def shards(a):
        by = {s.device.id: np.asarray(s.data) for s in a.addressable_shards}
        return [by[d] for d in order]

    sp = shard_transformer(params, mesh)
    blk = sp.blocks[0]
    refs = {"emb_levels": shards(sp.tok_embeddings.levels_t),
            "wq_levels": shards(blk.wq.levels_t), "wq_scales": shards(blk.wq.gscale_t),
            "wo_levels": shards(blk.wo.levels_t), "wo_scales": shards(blk.wo.gscale_t),
            "norm": shards(blk.attn_norm_w)}
    from llama_cpp_q_4_0_tpu.parallel import shard_tokens

    refs["tokens"] = shards(shard_tokens(jnp.arange(16, dtype=jnp.int32).reshape(2, 8), mesh))
    ck, _ = transformer.init_cache(cfg, 2, 64, dtype=jnp.float32)
    ck = [c + jnp.arange(c.size, dtype=jnp.float32).reshape(c.shape) for c in ck]
    refs["cache_in"] = np.asarray(ck[0])
    refs["cache"] = shards(shard_cache(ck, ck, cfg, mesh)[0][0])
    save(out, "refs", refs)


def port_world(rank: int, out: str) -> None:
    from llama_cpp_q_4_0_tpu_torch.parallel import (auto_mesh, make_mesh, named,
                                                     shard_cache, shard_tokens,
                                                     shard_transformer)
    from llama_cpp_q_4_0_tpu_torch.parallel.mesh import (all_gather, broadcast, ppermute,
                                                         psum)

    cfg, params = port_model(out, "model")
    refs = load(out, "refs")
    mesh = make_mesh(**MESH, device="cpu")
    got = {"devices": mesh.devices.tolist(), "coords": mesh.coords,
           "auto": auto_mesh(device="cpu").shape, "named": named(mesh, "dp", None)}
    x = torch.full((3,), float(rank + 1))
    got["psum_tp"] = psum(x, mesh, "tp").tolist()
    got["psum_all"] = psum(x, mesh, None).tolist()
    got["gather_tp"] = all_gather(x[:1], mesh, "tp", dim=0).tolist()
    got["stack_dp"] = all_gather(x[:1], mesh, "dp", tiled=False).tolist()
    ring = make_mesh(sp=4, device="cpu")
    got["ring"] = ppermute(torch.tensor([float(rank)]), ring, "sp",
                           [(s, (s + 1) % 4) for s in range(4)]).tolist()
    got["shift"] = ppermute(torch.tensor([float(rank + 10)]), ring, "sp", [(0, 1)]).tolist()
    got["bcast"] = broadcast(torch.tensor([rank + 7]), mesh).tolist()
    sp = shard_transformer(params, mesh)
    blk = sp.blocks[0]
    got["shards"] = {"emb_levels": sp.tok_embeddings.levels_t, "wq_levels": blk.wq.levels_t,
                     "wq_scales": blk.wq.gscale_t, "wo_levels": blk.wo.levels_t,
                     "wo_scales": blk.wo.gscale_t, "norm": blk.attn_norm_w}
    got["shards"] = {k: v.numpy() for k, v in got["shards"].items()}
    got["shards"]["tokens"] = shard_tokens(torch.arange(16).reshape(2, 8), mesh).numpy()
    c = torch.from_numpy(refs["cache_in"])
    got["shards"]["cache"] = shard_cache([c], [c], cfg, mesh)[0][0].numpy()
    save(out, f"got_{rank}", got)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("parallel"))
    run_jax(HERE, "jax_refs", out)
    run_world(4, HERE, "port_world", out)
    return load(out, "refs"), [load(out, f"got_{r}") for r in range(4)]


def test_mesh_layout(world):
    _, got = world
    for rank, g in enumerate(got):
        assert g["devices"] == [[[0, 1]], [[2, 3]]]
        assert g["coords"] == {"dp": rank // 2, "sp": 0, "tp": rank % 2}
        assert g["auto"] == {"dp": 1, "sp": 1, "tp": 4}  # gcd(4, 4) = 4, as JAX's
        assert g["named"] == ("dp", None)


def test_collectives(world):
    _, got = world
    for rank, g in enumerate(got):
        pair = [2 * (rank // 2) + 1, 2 * (rank // 2) + 2]
        assert g["psum_tp"] == [float(sum(pair))] * 3
        assert g["psum_all"] == [10.0] * 3
        assert g["gather_tp"] == [float(p) for p in pair]
        assert g["stack_dp"] == [[float(rank % 2 + 1)], [float(rank % 2 + 3)]]
        assert g["ring"] == [float((rank - 1) % 4)]
        assert g["shift"] == [10.0 if rank == 1 else 0.0]  # zeros where nothing arrives
        assert g["bcast"] == [7]


@pytest.mark.parametrize("name", ["emb_levels", "wq_levels", "wq_scales", "wo_levels",
                                  "wo_scales", "norm", "cache", "tokens"])
def test_local_slices_are_jax_shards(world, name):
    refs, got = world
    for rank, g in enumerate(got):
        np.testing.assert_array_equal(g["shards"][name], refs[name][rank])
