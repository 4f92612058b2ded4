"""Serving over a mesh in the port: ``Context(mesh=...)`` and
``BatchEngine(mesh=...)`` in an 8-process gloo world on the CPU, against the
JAX ``Context(mesh)`` and engine on the virtual 8-device mesh
(tests/test_sp_serving.py's cases, with ``ATTN_MXU=0`` pinned as there):

- Context at sp 4 (a ring prefill, then decode over a context split in
  four) and at tp 2, in f32 products: the logits of every step at 2e-4 and the greedy tokens
  equal; the scaled-int8 cache at sp 4 at 2e-3; each rank's cache holds
  S/sp slots;
- BatchEngine(mesh) at sp 4 and at dp 2 x sp 2 x tp 2 (all eight
  processes): the greedy tokens equal, on every rank;
- every Context method (and session and on-device perplexity function) that
  JAX runs over a mesh, called on each mesh Context: none refuses
  (tests/test_torch_mesh_serving.py holds their results to JAX's).

A mesh of fewer ranks than the world leaves the others idle: they build it
(new_group is collective) and skip its work."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from torch_worlds import jax_cfg_dict, load, np_tree, port_model, run_jax, run_world, save

HERE = os.path.abspath(__file__)
N_RANKS = 8
PROMPTS = [[3, 5, 7], [11, 13], [100, 90, 80, 70]]
CONTEXTS = {"sp4": dict(sp=4), "tp2": dict(tp=2), "q8_sp4": dict(sp=4)}


def _prompt(case):
    return np.random.default_rng(1 if case == "q8_sp4" else 0).integers(
        0, 255, 10 if case == "q8_sp4" else 12).tolist()


# ----------------------------------------------------------------- JAX side

def _jax_drive(ctx, prompt, steps):
    """test_sp_serving._drive: the prefill's and each greedy step's logits,
    and the tokens."""
    outs = [np.asarray(ctx.eval(np.asarray([prompt], np.int32)))]
    toks = []
    for _ in range(steps):
        toks.append(int(np.argmax(outs[-1][0, -1])))
        outs.append(np.asarray(ctx.eval(np.asarray([[toks[-1]]], np.int32))))
    return {"logits": outs, "tokens": toks}


def jax_refs(out: str) -> None:
    import jax.numpy as jnp

    from llama_cpp_q_4_0_tpu.parallel import make_mesh
    from llama_cpp_q_4_0_tpu.runtime.context import Context
    from test_parallel import tiny_q_model
    from test_tp import _run_engine

    os.environ["ATTN_MXU"] = "0"
    refs = {}
    for case, axes in CONTEXTS.items():
        cfg, params = tiny_q_model(n_layer=1 if case == "q8_sp4" else 2)
        # f32 products: the port's CPU takes a kernel's plain version where
        # the weight is on the kernel gate (w_down here), JAX's CPU the XLA
        # product, which part by ~1e-3 of the logits in bf16
        cfg = dataclasses.replace(cfg, compute_dtype="float32")
        save(out, "model_" + case, (jax_cfg_dict(cfg), np_tree(params)))
        dt = jnp.int8 if case == "q8_sp4" else jnp.bfloat16
        mesh = make_mesh(**{"dp": 1, "sp": 1, "tp": 1, **axes})
        refs[case] = _jax_drive(Context(cfg, params, n_ctx=64, cache_dtype=dt, mesh=mesh),
                                _prompt(case), 4)
    cfg, params = tiny_q_model(n_layer=1)
    save(out, "model_engine", (jax_cfg_dict(cfg), np_tree(params)))
    refs["engine_sp4"] = _run_engine(cfg, params, PROMPTS, mesh=make_mesh(dp=1, sp=4, tp=1))
    refs["engine_dp2_sp2_tp2"] = _run_engine(cfg, params, PROMPTS,
                                             mesh=make_mesh(dp=2, sp=2, tp=2))
    save(out, "refs", refs)


# ---------------------------------------------------------------- port side

def _port_drive(ctx, prompt, steps):
    outs = [ctx.eval(np.asarray([prompt]))]
    toks = []
    for _ in range(steps):
        toks.append(int(np.argmax(outs[-1][0, -1])))
        outs.append(ctx.eval(np.asarray([[toks[-1]]])))
    return {"logits": outs, "tokens": toks}


def _refused(ctx, draft) -> list[str]:
    """The Context methods (and session and on-device perplexity functions)
    that JAX runs over a mesh, each called on this mesh Context (draft: a
    second one on its mesh): the names of those that raise
    NotImplementedError, which none does since the port carries them all."""
    from llama_cpp_q_4_0_tpu_torch.runtime.device_sample import DeviceSampling, prng_key
    from llama_cpp_q_4_0_tpu_torch.runtime.perplexity import perplexity_ondevice
    from llama_cpp_q_4_0_tpu_torch.runtime.session import get_state, set_state

    ds, key, n = DeviceSampling(temp=-1.0), prng_key(0, "cpu"), ctx.n_past
    tok, no = torch.tensor([1]), torch.zeros(1, dtype=torch.bool)
    hist = torch.ones((1, 64), dtype=torch.int64)
    calls = {"decode_chunk": lambda: ctx.decode_chunk(tok, n, key, n_steps=1, ds=ds),
             "verify": lambda: ctx.verify([[1, 2]], n, key, ds=ds, kv_window=64),
             "spec_chunk": lambda: ctx.spec_chunk(hist, torch.tensor([n + 1]), key, no, k=1,
                                                  n_steps=1, ds=ds, kv_window=64, max_ngram=1,
                                                  min_ngram=1, eos=2, ignore_eos=False),
             "draft_spec_chunk": lambda: ctx.draft_spec_chunk(
                 draft, tok, torch.tensor([n]), key, no, torch.zeros((1, 1), dtype=torch.int64),
                 k=1, n_steps=1, ds=ds, kv_window=64, eos=2, ignore_eos=False),
             "get_state": lambda: get_state(ctx),
             "set_state": lambda: set_state(ctx, get_state(ctx)),
             "perplexity_ondevice": lambda: perplexity_ondevice(ctx, [1] * 16, n_ctx=8)}
    out = []
    for name, fn in calls.items():
        try:
            fn()
        except NotImplementedError:
            out.append(name)
    return out


def port_world(rank: int, out: str) -> None:
    from llama_cpp_q_4_0_tpu_torch.parallel import make_mesh
    from llama_cpp_q_4_0_tpu_torch.runtime.context import Context
    from test_torch_tp import port_engine

    os.environ["ATTN_MXU"] = "0"
    got = {}
    for case, axes in CONTEXTS.items():
        mesh = make_mesh(**axes, device="cpu")
        if mesh.coords is None:
            continue
        cfg, params = port_model(out, "model_" + case)
        dt = torch.int8 if case == "q8_sp4" else torch.bfloat16
        ctx = Context(cfg, params, n_ctx=64, cache_dtype=dt, mesh=mesh)
        got[case] = _port_drive(ctx, _prompt(case), 4)
        c = ctx.cache_k[0]
        got[case]["cache_shape"] = tuple((c.data if dt == torch.int8 else c).shape)
        got[case]["refused"] = _refused(ctx, Context(cfg, params, n_ctx=64, cache_dtype=dt,
                                                     mesh=mesh))
    cfg, params = port_model(out, "model_engine")
    mesh = make_mesh(sp=4, device="cpu")
    if mesh.coords is not None:
        got["engine_sp4"] = port_engine(cfg, params, PROMPTS, mesh=mesh)
    got["engine_dp2_sp2_tp2"] = port_engine(cfg, params, PROMPTS,
                                            mesh=make_mesh(dp=2, sp=2, tp=2, device="cpu"))
    save(out, f"got_{rank}", got)


# -------------------------------------------------------------------- tests

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sp_serving"))
    run_jax(HERE, "jax_refs", out)
    run_world(N_RANKS, HERE, "port_world", out)
    return load(out, "refs"), [load(out, f"got_{r}") for r in range(N_RANKS)]


@pytest.mark.parametrize("case", sorted(CONTEXTS))
def test_context_mesh_matches_jax(world, case):
    """Every step's logits (2e-4; 2e-3 for the q8 cache) and the greedy
    tokens, on every rank of the mesh."""
    refs, got = world
    want = refs[case]
    tol = 2e-3 if case == "q8_sp4" else 2e-4
    ranks = [g[case] for g in got if case in g]
    assert len(ranks) == (2 if case == "tp2" else 4)
    for g in ranks:
        assert g["tokens"] == want["tokens"], (want["tokens"], g["tokens"])
        for w, x in zip(want["logits"], g["logits"]):
            np.testing.assert_allclose(x, w, rtol=tol, atol=tol)


def test_sp_context_capacity_scales(world):
    """Each sp rank's cache holds S/sp = 16 of the 64 context slots."""
    _, got = world
    for g in got[:4]:
        assert g["sp4"]["cache_shape"] == (1, 16, 4, 32)
    assert got[0]["tp2"]["cache_shape"] == (1, 64, 2, 32)  # heads over tp


@pytest.mark.parametrize("case", ["engine_sp4", "engine_dp2_sp2_tp2"])
def test_engine_mesh_matches_jax(world, case):
    refs, got = world
    want = refs[case]
    ranks = [g[case] for g in got if case in g]
    assert len(ranks) == (4 if case == "engine_sp4" else 8)
    assert all(len(t) == 6 for t in want)
    for g in ranks:
        assert g == want, (want, g)


def test_unported_mesh_methods_raise(world):
    """Every Context method (and session or on-device perplexity function)
    that JAX runs over a mesh runs over the port's: called on every rank of
    every mesh (the scaled-int8 cache's too), none raises
    NotImplementedError (tests/test_torch_mesh_serving.py holds their
    results to JAX's)."""
    _, got = world
    for g in got:
        for case in CONTEXTS:
            if case in g:
                assert g[case]["refused"] == [], (case, g[case]["refused"])
