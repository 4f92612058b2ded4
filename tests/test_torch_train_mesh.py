"""The port's training step over a mesh (``make_train_step(..., mesh=...)``,
``make_stacked_train_step(..., mesh=...)``, ``save_checkpoint(...,
mesh=...)``) in one 8-process gloo world on the CPU, against the JAX
package's GSPMD step on the same sharding of the virtual 8-device mesh.

The model and batch are ``__graft_entry__.dryrun_multichip``'s (vocab 256,
n_embd 128, 4 heads, 2 layers, n_ctx 32; b 4, t 32, tokens split over dp
and, sequence-parallel, over sp); both packages start from JAX's init,
carried across as numpy.  The cases:

  adam_d2s2t2  — dp 2 x sp 2 x tp 2, adamw chained after
                 clip_by_global_norm(CLIP), two steps; the gradient's norm
                 exceeds CLIP, so the clip scales every leaf;
  lbfgs_tp2    — tp 2, optax.lbfgs with its zoom line search, two steps;
  stacked_s2t2 — sp 2 x tp 2, the stacked step with remat=True (adamw);
  neox_stacked_tp2 — GPT-NeoX (layer norms with biases, biases on every
                 product, GELU, parallel residuals) stacked at tp 2, f32
                 compute only: JAX's put_weight splits a stacked 2-D bias
                 over its L (column) or its E (b_down), which the sharded
                 forward gathers.

Each runs in f32 compute and in the default bf16.  Each step's loss is
held within 1e-5 relative at f32, 2e-5 at bf16.  The gradient, gathered
whole, is taken at JAX's params of that step (carried across), so that it
is held where JAX took it: within rtol 1e-5 / atol 1e-5 at f32 and
tests/test_pipeline.py's rtol 1e-2 / atol 3e-4 at bf16.  The params after
each step follow each package's own trajectory: within rtol 1e-5 / atol
1e-5 at f32, except that Adam moves an element whose gradient was ever
within ADAM_NEAR of zero by up to 2 lr a step on the gradient's last bits
(its update g / (|g| + eps) is +-1 far from zero and swings through 0 near
it); at bf16, Adam's within 2 lr a step everywhere (a bf16 gradient's sign
may flip where it is near zero) and L-BFGS's not held (its losses and
gradients are).  Every rank's losses, gradients and params are the same
bits.  A checkpoint saved over the mesh after the adam and L-BFGS
cases has the keys, shapes, dtypes and meta.json of the one JAX saves from
its sharded arrays, holds the gathered tensors bit for bit, loads into
JAX's ``load_checkpoint`` and onto one device, and, put back on the mesh,
resumes bit for bit."""

import hashlib
import io
import json
import os
import zipfile

import numpy as np
import pytest

from torch_worlds import (jax_cfg_dict, load, np_tree, port_model, run_jax_parallel, run_world,
                          save)

HERE = os.path.abspath(__file__)
N_RANKS = 8
WIDTHS = dict(n_vocab=256, n_embd=128, n_mult=32, n_head=4, n_layer=2, n_rot=32, n_ctx=32)
B, T = 4, 32
LR = 1e-3
CLIP = 0.05
NEOX = dict(n_vocab=256, n_embd=128, n_head=4, n_layer=2, n_rot=32, n_ctx=32)
# case: (mesh axes, optimizer, grad_clip, stacked)
CASES = {"adam_d2s2t2": (dict(dp=2, sp=2, tp=2), "adam", CLIP, False),
         "lbfgs_tp2": (dict(tp=2), "lbfgs", 0.0, False),
         "stacked_s2t2": (dict(sp=2, tp=2), "adam", 0.0, True),
         "neox_stacked_tp2": (dict(tp=2), "adam", 0.0, True)}
RANKS = {"adam_d2s2t2": 8, "lbfgs_tp2": 2, "stacked_s2t2": 4, "neox_stacked_tp2": 2}
MODES = ("float32", "bfloat16")
CKPT = ("adam_d2s2t2", "lbfgs_tp2")
STEPS = 2
# Adam's update g / (|g| + eps) (a first step) moves by d eps / (|g| + eps)^2
# for an error d in g: at |g| >= ADAM_NEAR = 100 eps, 1e-9 (f32 sums in
# another order) moves it by at most 1e-5; nearer zero it swings by up to 2
ADAM_NEAR = 1e-6


def _batch():
    tokens = np.random.default_rng(0).integers(0, 256, (B, T)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


# ----------------------------------------------------------------- JAX side

def jax_refs(out: str, case: str, mode: str) -> None:
    """JAX's steps of one case in one compute mode (each its own process:
    the partitioned compiles dominate, the L-BFGS step's most)."""
    from functools import partial

    import jax
    import jax.numpy as jnp

    from llama_cpp_q_4_0_tpu.models.config import ModelConfig
    from llama_cpp_q_4_0_tpu.parallel import make_mesh, shard_tokens, shard_transformer
    from llama_cpp_q_4_0_tpu.parallel.shard import replicate
    from llama_cpp_q_4_0_tpu.training import (OptParams, init_opt_state, init_transformer,
                                              make_optimizer, make_train_step)
    from llama_cpp_q_4_0_tpu.training import checkpoint as jck
    from llama_cpp_q_4_0_tpu.training import stacked as jst
    from llama_cpp_q_4_0_tpu.training.train import lm_loss

    tokens, targets = _batch()
    if case.startswith("neox"):
        cfg = ModelConfig.gptneox(**NEOX, compute_dtype=mode)
    else:
        cfg = ModelConfig.llama(**WIDTHS, compute_dtype=mode)
    p0 = init_transformer(cfg, jax.random.key(0))
    if case in ("adam_d2s2t2", "neox_stacked_tp2") and mode == "float32":
        save(out, "model" if case == "adam_d2s2t2" else "neox",
             (jax_cfg_dict(cfg), np_tree(p0)))
    axes, kind, clip, stacked = CASES[case]
    mesh = make_mesh(**{"dp": 1, "sp": 1, "tp": 1, **axes})
    tx = make_optimizer(OptParams(kind=kind, lr=LR, grad_clip=clip))
    with mesh:
        p = shard_transformer(jst.stack_params(p0) if stacked else p0, mesh)
        s = replicate(init_opt_state(tx, p), mesh)
        if kind == "lbfgs":
            # the line search's info is weakly typed in optax's init and not
            # after a step (an output only: no number changes), which would
            # compile the step twice
            z = s[2]
            s = (*s[:2], z._replace(info=jax.tree.map(
                lambda x: jax.lax.convert_element_type(x, x.dtype), z.info)))
        # each step's outputs go back onto the inputs' shardings, so that
        # the second step runs the first's compiled program
        placed = jax.tree.map(lambda x: x.sharding, (p, s))
        p, s = jax.device_put((p, s), placed)
        tt = shard_tokens(jnp.asarray(tokens), mesh, sequence_parallel=True)
        ty = shard_tokens(jnp.asarray(targets), mesh, sequence_parallel=True)
        if stacked:
            loss_fn = partial(jst.stacked_lm_loss, cfg, remat=True)
            step = jst.make_stacked_train_step(cfg, tx, remat=True, donate=False)
        else:
            loss_fn = partial(lm_loss, cfg)
            step = make_train_step(cfg, tx, donate=False)
        grad = jax.jit(jax.grad(lambda q: loss_fn(q, tt, ty)))
        rows = []
        for _ in range(STEPS):
            # L-BFGS keeps the step's gradient (scale_by_lbfgs' updates, first
            # in its chain): no second program to compile
            g = None if kind == "lbfgs" else grad(p)
            p, s, loss = step(p, s, tt, ty)
            p, s = jax.device_put((p, s), placed)
            if kind == "lbfgs":
                g = s[0].updates
            row = {"loss": float(loss),
                   "grads": [np.asarray(x) for x in jax.tree.leaves(g)],
                   "params": [np.asarray(x) for x in jax.tree.leaves(p)]}
            if kind == "lbfgs":
                z = s[2]
                row["ls"] = (int(z.info.num_linesearch_steps), float(z.learning_rate))
            rows.append(row)
        if case in CKPT and mode == "float32":
            jck.save_checkpoint(os.path.join(out, f"jax-{case}.ckpt"), cfg, p, s,
                                step=STEPS, extra={"case": case})
    save(out, f"refs_{case}_{mode}", rows)


# ---------------------------------------------------------------- port side

def _digest(*arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _like(tree, arrays):
    """tree's structure with arrays (JAX's leaves, in order) as its leaves."""
    import torch

    from llama_cpp_q_4_0_tpu_torch.training.tree import tree_map

    it = iter(arrays)
    return tree_map(lambda _: torch.from_numpy(next(it)), tree)


def port_world(rank: int, out: str) -> None:
    import dataclasses
    from functools import partial

    import torch

    from llama_cpp_q_4_0_tpu_torch.parallel import (gather_params, make_mesh, shard_tokens,
                                                    shard_transformer, shard_tree)
    from llama_cpp_q_4_0_tpu_torch.training import OptParams, make_optimizer
    from llama_cpp_q_4_0_tpu_torch.training import checkpoint as tck
    from llama_cpp_q_4_0_tpu_torch.training import stacked as tst
    from llama_cpp_q_4_0_tpu_torch.training import train as T
    from llama_cpp_q_4_0_tpu_torch.training.tree import flatten_with_path, leaves

    models = {"model": port_model(out, "model"), "neox": port_model(out, "neox")}
    tokens, targets = (torch.from_numpy(a).long() for a in _batch())
    got = {}
    for case, mode in KEYS:
        axes, kind, clip, stacked = CASES[case]
        cfg0, params0 = models["neox" if case.startswith("neox") else "model"]
        cfg = dataclasses.replace(cfg0, compute_dtype=mode)
        mesh = make_mesh(**axes, device="cpu")
        if mesh.coords is None:
            continue
        tx = make_optimizer(OptParams(kind=kind, lr=LR, grad_clip=clip))
        whole = tst.stack_params(params0) if stacked else params0
        p = shard_transformer(whole, mesh)
        s = tx.init(p)
        # JAX's params before each step: the init, then its step's outputs
        at = [p] + [shard_transformer(_like(whole, row["params"]), mesh)
                    for row in load(out, f"refs_{case}_{mode}")[:-1]]
        tt = shard_tokens(tokens, mesh, sequence_parallel=True)
        ty = shard_tokens(targets, mesh, sequence_parallel=True)
        if stacked:
            loss_fn = partial(tst.stacked_lm_loss, cfg, remat=True, mesh=mesh)
            step = tst.make_stacked_train_step(cfg, tx, remat=True, mesh=mesh)
        else:
            loss_fn = partial(T.lm_loss, cfg, mesh=mesh)
            step = T.make_train_step(cfg, tx, mesh=mesh)
        rows = []
        for i in range(STEPS):
            _, g = T.value_and_grad(lambda q: loss_fn(q, tt, ty), at[i], mesh)
            p, s, loss = step(p, s, tt, ty)
            grads = [x.numpy() for x in leaves(gather_params(g, mesh))]
            params = [x.numpy() for x in leaves(gather_params(p, mesh))]
            row = {"loss": float(loss), "digest": _digest(loss.numpy(), *grads, *params)}
            if kind == "lbfgs":
                z = s[2]
                row["ls"] = (int(z.info.num_linesearch_steps), float(z.learning_rate))
            if rank == 0:
                row.update(grads=grads, params=params)
            rows.append(row)
        got[case, mode] = rows
        del at
        if case in CKPT and mode == "float32":
            path = os.path.join(out, f"port-{case}.ckpt")
            tck.save_checkpoint(path, cfg, p, s, step=STEPS, extra={"case": case}, mesh=mesh)
            gathered = (flatten_with_path(gather_params(p, mesh), "params")
                        + flatten_with_path(gather_params(s, mesh), "opt"))
            if rank == 0:
                # copies: a replicated leaf gathers as itself, and the step
                # below updates the state in place
                got["gathered", case] = {k: v.numpy().copy() for k, v in gathered}
            # resumed on the mesh: the file loaded whole, its params through
            # shard_transformer and its state through shard_tree, one more
            # step against a step from the live params and state
            _, lp, ls, _ = tck.load_checkpoint(path, whole, tx.init(whole))
            same_tree = all(torch.equal(a, b) for a, b in zip(
                leaves(shard_tree(lp, mesh)), leaves(shard_transformer(lp, mesh))))
            lp, ls = shard_transformer(lp, mesh), shard_tree(ls, mesh)
            live = step(p, s, tt, ty)
            back = step(lp, ls, tt, ty)
            got["resumed", case] = {
                "same_tree": same_tree, "loss": (float(live[2]), float(back[2])),
                "params": all(torch.equal(a, b) for a, b in zip(leaves(live[0]),
                                                                leaves(back[0]))),
                "state": all(torch.equal(a, b) for a, b in zip(leaves(live[1]),
                                                               leaves(back[1])))}
    save(out, f"got_{rank}", got)


# -------------------------------------------------------------------- tests

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("train_mesh"))
    run_jax_parallel(HERE, "jax_refs", out, KEYS, timeout=300)
    run_world(N_RANKS, HERE, "port_world", out, timeout=240)
    refs = {(c, m): load(out, f"refs_{c}_{m}") for c, m in KEYS}
    return out, refs, [load(out, f"got_{r}") for r in range(N_RANKS)]


def _ranks(got, key):
    return [g[key] for g in got if key in g]


KEYS = [(c, m) for c in CASES for m in MODES if c != "neox_stacked_tp2" or m == "float32"]
IDS = [f"{c}-{m}" for c, m in KEYS]


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_losses_match_jax(world, key):
    """Both steps' losses: 1e-5 relative at f32 compute, 2e-5 at bf16."""
    _, refs, got = world
    tol = 1e-5 if key[1] == "float32" else 2e-5
    for want, row in zip(refs[key], _ranks(got, key)[0]):
        assert abs(row["loss"] - want["loss"]) <= tol * abs(want["loss"]), (key, row["loss"],
                                                                           want["loss"])


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_gathered_grads_match_jax(world, key):
    """Each step's gradient at JAX's params of that step, gathered whole,
    against jax.grad of JAX's loss on its sharded params: rtol 1e-5 / atol
    1e-5 at f32 compute, test_pipeline's rtol 1e-2 / atol 3e-4 at bf16."""
    _, refs, got = world
    rtol, atol = (1e-5, 1e-5) if key[1] == "float32" else (1e-2, 3e-4)
    for want, row in zip(refs[key], _ranks(got, key)[0]):
        assert len(row["grads"]) == len(want["grads"])
        for a, b in zip(row["grads"], want["grads"]):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=str(key))


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_params_after_steps_match_jax(world, key):
    """The params after each step, each package on its own trajectory:
    rtol 1e-5 / atol 1e-5 at f32 compute, but for Adam's elements whose
    gradient was within ADAM_NEAR of zero at some step so far (2 lr a
    step, and fewer than 1% of the elements); at bf16 Adam's within 2 lr a
    step, L-BFGS's not held (its losses and gradients are)."""
    _, refs, got = world
    case, mode = key
    adam = CASES[case][1] == "adam"
    if mode == "bfloat16" and not adam:
        return
    near = None
    for k, (want, row) in enumerate(zip(refs[key], _ranks(got, key)[0]), 1):
        g = [(np.abs(x) < ADAM_NEAR) & (x != 0) for x in want["grads"]]
        near = g if near is None else [a | b for a, b in zip(near, g)]
        for a, b, m in zip(row["params"], want["params"], near):
            if mode == "bfloat16":
                np.testing.assert_allclose(a, b, rtol=0, atol=2 * LR * k, err_msg=str(key))
                continue
            far = ~m if adam else np.ones_like(m)
            np.testing.assert_allclose(a[far], b[far], rtol=1e-5, atol=1e-5, err_msg=str(key))
            np.testing.assert_allclose(a[~far], b[~far], rtol=0, atol=2 * LR * k,
                                       err_msg=str(key))
        if adam and mode == "float32":
            assert sum(int(m.sum()) for m in near) < 0.01 * sum(m.size for m in near)


@pytest.mark.parametrize("key", KEYS, ids=IDS)
def test_every_rank_bit_for_bit(world, key):
    """Every rank of the case's mesh: the same loss, gathered gradients and
    params, bit for bit (a digest of their bytes)."""
    _, _, got = world
    ranks = _ranks(got, key)
    assert len(ranks) == RANKS[key[0]]
    for i in range(STEPS):
        assert len({r[i]["digest"] for r in ranks}) == 1, (key, i)


@pytest.mark.parametrize("mode", MODES)
def test_lbfgs_line_search_matches_jax(world, mode):
    """The zoom line search over tp 2 takes optax's number of steps and its
    step size (1e-4 relative), on every rank."""
    _, refs, got = world
    key = ("lbfgs_tp2", mode)
    for i, want in enumerate(refs[key]):
        for r in _ranks(got, key):
            n, lr = r[i]["ls"]
            assert n == want["ls"][0], (mode, i, n, want["ls"])
            assert abs(lr - want["ls"][1]) <= 1e-4 * abs(want["ls"][1]), (mode, i, lr, want)


@pytest.mark.parametrize("mode", MODES)
def test_clip_triggers(world, mode):
    """Both steps' gradient norms of the Adam case, JAX's and the port's,
    are above CLIP, so clip_by_global_norm scales every leaf of both."""
    _, refs, got = world
    key = ("adam_d2s2t2", mode)
    for want, row in zip(refs[key], _ranks(got, key)[0]):
        for g in (want["grads"], row["grads"]):
            assert np.sqrt(sum(float((x.astype(np.float64) ** 2).sum()) for x in g)) > 2 * CLIP


def _zip_contents(path):
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        arrays = dict(np.load(io.BytesIO(z.read("arrays.npz"))))
    return meta, arrays


@pytest.mark.parametrize("case", CKPT)
def test_mesh_checkpoint_keys_and_meta_match_jax(world, case):
    """The checkpoint saved over the mesh: JAX's keys (in its order),
    shapes, dtypes and meta.json, as JAX writes them from sharded arrays."""
    out, _, _ = world
    jm, ja = _zip_contents(os.path.join(out, f"jax-{case}.ckpt"))
    tm, ta = _zip_contents(os.path.join(out, f"port-{case}.ckpt"))
    assert tm == jm
    assert list(ta) == list(ja)
    for k in ja:
        assert ta[k].shape == ja[k].shape and ta[k].dtype == ja[k].dtype, k


@pytest.mark.parametrize("case", CKPT)
def test_mesh_checkpoint_holds_gathered_tensors(world, case):
    """Every array of the file is the gathered params or state, bit for bit;
    the params the gathered params after the last step."""
    out, _, got = world
    _, ta = _zip_contents(os.path.join(out, f"port-{case}.ckpt"))
    whole = got[0]["gathered", case]
    assert list(ta) == list(whole)
    for k, v in whole.items():
        np.testing.assert_array_equal(ta[k], v, err_msg=k)
    last = got[0][case, "float32"][-1]["params"]
    params = [v for k, v in whole.items() if k.startswith("params")]
    for a, b in zip(params, last):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", CKPT)
def test_mesh_checkpoint_loads_into_jax(world, case):
    """JAX's load_checkpoint reads the file into JAX's trees, every leaf the
    file's array."""
    import jax

    from llama_cpp_q_4_0_tpu.models.config import ModelConfig
    from llama_cpp_q_4_0_tpu.training import (OptParams, init_opt_state, init_transformer,
                                              make_optimizer)
    from llama_cpp_q_4_0_tpu.training import checkpoint as jck

    out, _, _ = world
    _, kind, clip, _ = CASES[case]
    cfg = ModelConfig.llama(**WIDTHS, compute_dtype="float32")
    like = init_transformer(cfg, jax.random.key(1))
    tx = make_optimizer(OptParams(kind=kind, lr=LR, grad_clip=clip))
    path = os.path.join(out, f"port-{case}.ckpt")
    cfg2, p, s, step = jck.load_checkpoint(path, like, init_opt_state(tx, like))
    assert step == STEPS and cfg2 == cfg
    _, ta = _zip_contents(path)
    loaded = {**jck._flatten(p, "params"), **jck._flatten(s, "opt")}
    assert list(loaded) == list(ta)
    for k, v in loaded.items():
        np.testing.assert_array_equal(v, ta[k], err_msg=k)


@pytest.mark.parametrize("case", CKPT)
def test_mesh_checkpoint_resumes_on_the_mesh(world, case):
    """The checkpoint loaded whole and put back on the mesh (params through
    shard_transformer, the optimizer state through shard_tree, which
    splits params as shard_transformer does) takes the next step bit for bit
    as the live params and state do, on every rank of the case's mesh."""
    _, _, got = world
    ranks = _ranks(got, ("resumed", case))
    assert len(ranks) == RANKS[case]
    for r in ranks:
        assert r["same_tree"]
        assert r["loss"][0] == r["loss"][1]
        assert r["params"] and r["state"]


@pytest.mark.parametrize("case", CKPT)
def test_mesh_checkpoint_loads_on_one_device(world, case):
    """The port's load_checkpoint on one device (like trees of the whole
    model) gives the gathered tensors bit for bit."""
    import torch

    from llama_cpp_q_4_0_tpu_torch.training import OptParams, init_transformer, make_optimizer
    from llama_cpp_q_4_0_tpu_torch.training import checkpoint as tck
    from llama_cpp_q_4_0_tpu_torch.training.tree import flatten_with_path

    out, _, got = world
    cfg0, _ = port_model(out, "model")
    _, kind, clip, _ = CASES[case]
    like = init_transformer(cfg0, torch.Generator().manual_seed(3))
    tx = make_optimizer(OptParams(kind=kind, lr=LR, grad_clip=clip))
    _, p, s, step = tck.load_checkpoint(os.path.join(out, f"port-{case}.ckpt"), like,
                                        tx.init(like))
    assert step == STEPS
    whole = got[0]["gathered", case]
    loaded = dict(flatten_with_path(p, "params") + flatten_with_path(s, "opt"))
    assert list(loaded) == list(whole)
    for k, v in loaded.items():
        np.testing.assert_array_equal(v.numpy(), whole[k], err_msg=k)
