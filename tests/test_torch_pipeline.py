"""The port's GPipe pipeline (``parallel/pipeline.py``) in one 4-process gloo
world on the CPU, against the JAX package's ``pp_loss`` on the virtual
8-device mesh and its ``stacked_lm_loss`` on one device: tests/test_pipeline.py's
cases, in bf16 and f32 compute.

The setup is tests/test_pipeline.py's: vocab 64, n_embd 32, 2 heads, 4
layers, n_ctx 16, JAX's init (carried across as numpy, stacked on each
side), tokens [M = 4, mb = 2, T = 16] from a seed.  The loss at pp 2 and 4
is held to JAX's ``pp_loss`` and to ``stacked_lm_loss`` within 2e-5 (1e-5
at f32 compute); the gradients at pp 2 and 4, gathered over the stages,
within test_pipeline.py's rtol 1e-2 / atol 3e-4 (rtol 1e-5 / atol 1e-5 at
f32).  The replicated leaves' gradients (embedding, output norm, head) are
held on every stage, not only on the stage that reaches them: a missing pp
psum shows there.  The same world checks the backward rule of each autograd
collective of parallel/mesh.py against its JAX transpose, exactly."""

import os

import numpy as np
import pytest

from torch_worlds import load, np_tree, run_jax_parallel, run_world, save

HERE = os.path.abspath(__file__)
N_RANKS = 4
WIDTHS = dict(n_vocab=64, n_embd=32, n_mult=16, n_head=2, n_layer=4, n_rot=16, n_ctx=16)
MODES = ("bfloat16", "float32")
PPS = (2, 4)
REPLICATED = ("tok_embeddings", "out_norm_w", "output")


def _batch():
    toks = np.random.default_rng(0).integers(0, 64, (4, 2, 16)).astype(np.int32)  # [M, mb, T]
    return toks, np.roll(toks, -1, axis=2)


def _gates(mode):
    """(loss relative gate, gradient rtol, gradient atol)."""
    return (2e-5, 1e-2, 3e-4) if mode == "bfloat16" else (1e-5, 1e-5, 1e-5)


# ----------------------------------------------------------------- JAX side

def jax_refs(out: str, mode: str) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from llama_cpp_q_4_0_tpu.models.config import ModelConfig
    from llama_cpp_q_4_0_tpu.parallel.pipeline import pp_loss, stage_specs
    from llama_cpp_q_4_0_tpu.training import init_transformer
    from llama_cpp_q_4_0_tpu.training.stacked import stack_params, stacked_lm_loss

    cfg = ModelConfig.llama(**WIDTHS, compute_dtype=mode)
    init = init_transformer(cfg, jax.random.key(0))
    params = stack_params(init)
    toks, tgts = (jnp.asarray(a) for a in _batch())
    flat = (toks.reshape(-1, 16), tgts.reshape(-1, 16))
    refs = {"stacked": float(stacked_lm_loss(cfg, params, *flat)),
            "stacked_grads": [np.asarray(g) for g in jax.tree.leaves(jax.grad(
                lambda p: stacked_lm_loss(cfg, p, *flat))(params))]}
    for pp in PPS:
        mesh = Mesh(np.asarray(jax.devices()[:pp]), ("pp",))
        refs["pp", pp] = float(jax.jit(lambda p, a, b: pp_loss(cfg, p, a, b, mesh))(
            params, toks, tgts))
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("pp",))
    g = jax.jit(jax.grad(lambda p: pp_loss(cfg, p, toks, tgts, mesh)))(params)
    refs["pp_grads"] = [np.asarray(x) for x in jax.tree.leaves(g)]
    refs["names"] = [jax.tree_util.keystr(k) for k, _ in
                     jax.tree_util.tree_flatten_with_path(params)[0]]
    specs = stage_specs(params)
    refs["specs"] = {"blocks": {k: tuple(v) for k, v in vars(specs.blocks[0]).items()
                                if v is not None},
                     **{k: tuple(getattr(specs, k)) for k in ("tok_embeddings", "out_norm_w",
                                                               "output")}}
    if mode == MODES[0]:
        save(out, "model", np_tree(init))
    save(out, f"refs_{mode}", refs)


# ---------------------------------------------------------------- port side

def _collectives(rank: int) -> dict:
    """Each autograd collective on a 4-rank tp axis, fed x_r = (r + 1) *
    [1, 2, 3] and differentiated through sum(y * w_r) with w_r = (r + 1) *
    [1, 2, 4, ...] of y's size: the gradients of x on this rank."""
    import torch

    from llama_cpp_q_4_0_tpu_torch.parallel.mesh import (copy_to, gather_from, make_mesh,
                                                         ppermute_ad, reduce_from)

    mesh = make_mesh(tp=4, device="cpu")
    out = {}
    forms = {"reduce_from": lambda x: reduce_from(x, mesh, "tp"),
             "copy_to": lambda x: copy_to(x, mesh, "tp"),
             "gather_same": lambda x: gather_from(x, mesh, "tp", 0, same=True),
             "gather_varying": lambda x: gather_from(x, mesh, "tp", 0, same=False),
             "ppermute": lambda x: ppermute_ad(x, mesh, "tp", [(s, (s + 1) % 4) for s in
                                                                 range(4)])}
    with torch.enable_grad():
        for name, fn in forms.items():
            x = ((rank + 1) * torch.tensor([1.0, 2.0, 3.0])).requires_grad_(True)
            y = fn(x)
            w = (rank + 1) * 2.0 ** torch.arange(y.numel(), dtype=torch.float32)
            if name == "gather_same":  # every rank computes the same value
                w = 2.0 ** torch.arange(y.numel(), dtype=torch.float32)
            (g,) = torch.autograd.grad((y * w).sum(), x)
            out[name] = (y.detach().numpy(), g.numpy())
    return out


def port_world(rank: int, out: str) -> None:
    import dataclasses

    import torch

    from llama_cpp_q_4_0_tpu_torch.convert import params_from_numpy
    from llama_cpp_q_4_0_tpu_torch.models.config import ModelConfig
    from llama_cpp_q_4_0_tpu_torch.parallel import make_pp_mesh
    from llama_cpp_q_4_0_tpu_torch.parallel import pipeline as P
    from llama_cpp_q_4_0_tpu_torch.training import train as T
    from llama_cpp_q_4_0_tpu_torch.training.stacked import stack_params
    from llama_cpp_q_4_0_tpu_torch.training.tree import flatten_with_path, leaves

    whole = stack_params(params_from_numpy(load(out, "model"), device="cpu"))
    toks, tgts = (torch.from_numpy(a).long() for a in _batch())
    got = {"collectives": _collectives(rank)}
    specs = P.stage_specs(whole)
    got["specs"] = {"blocks": {k: v for k, v in vars(specs.blocks[0]).items() if v is not None},
                    **{k: getattr(specs, k) for k in REPLICATED}}
    for mode in MODES:
        cfg = ModelConfig.llama(**WIDTHS, compute_dtype=mode)
        for pp in PPS:
            mesh = make_pp_mesh(pp, device="cpu")
            if mesh.coords is None:
                continue
            local = P.shard_stages(whole, mesh)
            loss = P.pp_loss(cfg, local, toks, tgts, mesh)
            vg_loss, g = T.value_and_grad(lambda p: P.pp_loss(cfg, p, toks, tgts, mesh), local)
            rec = {"loss": float(loss), "vg_loss": float(vg_loss),
                   "replicated": {k: getattr(g, k).numpy() for k in REPLICATED}}
            gathered = P.gather_stages(g, mesh)
            if rank == 0:
                rec["grads"] = [x.numpy() for x in leaves(gathered)]
                rec["names"] = [k for k, _ in flatten_with_path(gathered)]
            rec["round_trip"] = all(
                torch.equal(a, b) for a, b in zip(leaves(P.gather_stages(local, mesh)),
                                                  leaves(whole)))
            if mode == MODES[0]:
                try:
                    P.pp_loss(cfg, dataclasses.replace(local, blocks=whole.blocks), toks,
                              tgts, mesh)
                except ValueError as e:
                    rec["refused"] = str(e)
            got[mode, pp] = rec
    save(out, f"got_{rank}", got)


# -------------------------------------------------------------------- tests

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("pipeline"))
    run_jax_parallel(HERE, "jax_refs", out, [(m,) for m in MODES], timeout=300)
    run_world(N_RANKS, HERE, "port_world", out, timeout=180)
    return {m: load(out, f"refs_{m}") for m in MODES}, [load(out, f"got_{r}")
                                                         for r in range(N_RANKS)]


def _stages(got, key):
    return [g[key] for g in got if key in g]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("pp", PPS)
def test_pp_loss_matches_jax(world, pp, mode):
    """pp_loss at pp 2 and 4 against JAX's pp_loss and stacked_lm_loss:
    2e-5 relative at bf16 compute, 1e-5 at f32; value_and_grad's loss is
    the same bits."""
    refs, got = world
    tol = _gates(mode)[0]
    for r in _stages(got, (mode, pp)):
        for want in (refs[mode]["pp", pp], refs[mode]["stacked"]):
            assert abs(r["loss"] - want) <= tol * abs(want), (r["loss"], want)
        assert r["vg_loss"] == r["loss"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("pp", PPS)
def test_pp_grads_match_jax(world, pp, mode):
    """The gradients of pp_loss, the stages' layers gathered, against
    jax.grad of JAX's pp_loss at pp 2 and of stacked_lm_loss: rtol 1e-2 /
    atol 3e-4 at bf16 compute (test_pipeline.py's), rtol 1e-5 / atol 1e-5
    at f32."""
    refs, got = world
    _, rtol, atol = _gates(mode)
    r = got[0][mode, pp]
    assert r["names"] == refs[mode]["names"]
    for want in (refs[mode]["pp_grads"], refs[mode]["stacked_grads"]):
        for name, a, b in zip(r["names"], r["grads"], want):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("pp", PPS)
def test_replicated_grads_whole_on_every_stage(world, pp, mode):
    """The embedding's, the output norm's and the head's gradients on every
    stage, each against JAX's (gates as above): only stage 0 reaches the
    embedding and only the last stage the head, so each stage holds the
    whole gradient only through the sum over pp."""
    refs, got = world
    _, rtol, atol = _gates(mode)
    names = refs[mode]["names"]
    want = {k: refs[mode]["pp_grads"][names.index("." + k)] for k in REPLICATED}
    stages = _stages(got, (mode, pp))
    assert len(stages) == pp
    for r in stages:
        for k in REPLICATED:
            assert np.abs(want[k]).max() > 0
            np.testing.assert_allclose(r["replicated"][k], want[k], rtol=rtol, atol=atol,
                                       err_msg=k)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("pp", PPS)
def test_stages_agree_bit_for_bit(world, pp, mode):
    """Every stage's loss and replicated gradients are the same bits."""
    _, got = world
    stages = _stages(got, (mode, pp))
    for r in stages[1:]:
        assert r["loss"] == stages[0]["loss"]
        for k in REPLICATED:
            np.testing.assert_array_equal(r["replicated"][k], stages[0]["replicated"][k])


def test_stage_specs_match_jax(world):
    """stage_specs: every block leaf's [L] axis over pp, the embedding, the
    norm and the head replicated, as JAX's PartitionSpecs."""
    refs, got = world
    for r in got:
        assert r["specs"] == refs[MODES[0]]["specs"]


@pytest.mark.parametrize("pp", PPS)
def test_shard_stages_round_trip_and_refusal(world, pp):
    """gather_stages(shard_stages(p)) is p bit for bit on every stage, and
    pp_loss refuses a stage holding every layer (it takes its L/pp)."""
    _, got = world
    for r in _stages(got, (MODES[0], pp)):
        assert r["round_trip"]
        assert "L/pp" in r["refused"]


def _expect(name: str, rank: int):
    """(y, dx) of _collectives by JAX's transposes."""
    x = lambda r: (r + 1) * np.array([1.0, 2.0, 3.0])  # noqa: E731
    w = lambda r, n: (r + 1) * 2.0 ** np.arange(n)  # noqa: E731
    if name == "reduce_from":  # psum; cotangent as it is
        return sum(x(r) for r in range(4)), w(rank, 3)
    if name == "copy_to":  # identity; cotangents summed
        return x(rank), sum(w(r, 3) for r in range(4))
    y = np.concatenate([x(r) for r in range(4)])
    if name == "gather_same":  # this rank's slice of the one cotangent
        return y, (2.0 ** np.arange(12))[3 * rank:3 * rank + 3]
    if name == "gather_varying":  # every rank's cotangents summed, then the slice
        return y, sum(w(r, 12) for r in range(4))[3 * rank:3 * rank + 3]
    # ppermute r -> r + 1: x_r's cotangent is rank r + 1's
    return x((rank - 1) % 4), w((rank + 1) % 4, 3)


@pytest.mark.parametrize("name", ["reduce_from", "copy_to", "gather_same", "gather_varying",
                                  "ppermute"])
def test_collective_backward_is_jax_transpose(world, name):
    """Each autograd collective's forward and backward on every rank of a
    4-rank axis, exactly (small integers in f32)."""
    _, got = world
    for rank, r in enumerate(got):
        y, dx = r["collectives"][name]
        want_y, want_dx = _expect(name, rank)
        np.testing.assert_array_equal(y, want_y.astype(np.float32))
        np.testing.assert_array_equal(dx, want_dx.astype(np.float32))
