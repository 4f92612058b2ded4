"""The port's tensor-parallel forward (parallel/tp.py) in a 4-process gloo
world on the CPU, against the JAX ``tp_forward`` on the virtual 8-device
mesh, at the JAX tests' gate (rtol = atol = 2e-4, tests/test_tp.py): llama
at tp 4, MQA (one KV head, replicated) at tp 2, GPT-NeoX's biases at tp 2,
loader-fused params at tp 2, a per-row n_past with a kv_window at tp 4 (the
caches too), the speculative verify through ``spec_forward`` at tp 4, and
``BatchEngine(tp_mesh=...)`` at tp 4 (staggered occupancy, chunked and
speculative ticks) with greedy tokens equal.  tp 2 runs on a dp 2 x tp 2
mesh, which replicates it over dp.

Also the speculative ``forward_fn`` (repaired: the port's ``spec_chunk``
and ``BatchEngine`` refused it): a ``spec_chunk`` whose forward_fn wraps
``transformer.forward`` gives JAX's tokens, and a speculative engine with
such a forward_fn gives the plain speculative engine's."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from torch_worlds import (jax_cfg_dict, load, np_tree, port_model, run_jax, run_world,
                          save)

HERE = os.path.abspath(__file__)
TOL = dict(rtol=2e-4, atol=2e-4)
RNG_PROMPT, RNG_STEP = (2, 8), (2, 1)
ENGINE_PROMPTS = {"staggered": [[3, 5, 7], [11, 13], [100, 90, 80, 70, 60]],
                  "chunked": [[3, 5, 7], [11, 13, 17, 19]],
                  "spec": [[3, 5, 7, 3, 5, 7, 3], [11, 13, 11, 13, 11]]}
FORWARD_CASES = ("llama_tp4", "mqa_tp2", "neox_tp2", "fused_tp2")


# ----------------------------------------------------------------- JAX side

def _neox_model():
    import jax.numpy as jnp

    from llama_cpp_q_4_0_tpu.models.config import ModelConfig
    from llama_cpp_q_4_0_tpu.models.transformer import Block, TransformerParams
    from llama_cpp_q_4_0_tpu.ops.qtensor import QTensor
    from llama_cpp_q_4_0_tpu.quant.types import GGMLType

    e, heads, f, v = 128, 4, 256, 256
    cfg = ModelConfig.gptneox(n_vocab=v, n_embd=e, n_head=heads, n_layer=1, n_rot=16,
                              use_parallel_residual=0, n_ctx=64)
    rng = np.random.default_rng(3)
    q = lambda n, k: QTensor.quantize(
        rng.standard_normal((n, k), dtype=np.float32) * 0.05, GGMLType.Q4_0)
    vec = lambda n: jnp.asarray(rng.standard_normal(n) * 0.01, jnp.float32)
    blocks = (Block(attn_norm_w=jnp.ones((e,)), attn_norm_b=vec(e), wq=q(e, e), wk=q(e, e),
                    wv=q(e, e), bq=vec(e), bk=vec(e), bv=vec(e), wo=q(e, e), bo=vec(e),
                    ffn_norm_w=jnp.ones((e,)), ffn_norm_b=vec(e), w_up=q(f, e),
                    b_up=vec(f), w_down=q(e, f), b_down=vec(e)),)
    params = TransformerParams(tok_embeddings=q(v, e), blocks=blocks,
                               out_norm_w=jnp.ones((e,)), out_norm_b=vec(e), output=q(v, e))
    return cfg, params


def _jax_models():
    from llama_cpp_q_4_0_tpu.models.fuse import fuse_projections
    from test_parallel import tiny_q_model
    from test_tp import _tiny_mqa

    llama = tiny_q_model(n_layer=1)
    return {"llama_tp4": (llama, 4), "mqa_tp2": (_tiny_mqa(), 2),
            "neox_tp2": (_neox_model(), 2),
            "fused_tp2": ((llama[0], fuse_projections(*llama)), 2)}


def _jit_tp(cfg, mesh, **kw):
    """tp_forward under one jax.jit (its docstring asks for one: eagerly,
    each call partitions anew, ~80 s a call on the CPU)."""
    import jax

    from llama_cpp_q_4_0_tpu.parallel.tp import tp_forward

    return jax.jit(lambda p, t, n, ck, cv: tp_forward(cfg, p, t, n, ck, cv, mesh, **kw))


def _jax_pair(cfg, params, tp):
    """test_tp._run_pair's prefill and decode through tp_forward."""
    import jax.numpy as jnp

    from llama_cpp_q_4_0_tpu.models import transformer
    from llama_cpp_q_4_0_tpu.parallel import make_mesh
    from llama_cpp_q_4_0_tpu.parallel.shard import shard_cache
    from llama_cpp_q_4_0_tpu.parallel.tp import prepare_tp_params

    mesh = make_mesh(dp=1, sp=1, tp=tp)
    rng = np.random.default_rng(1)
    prompt = jnp.asarray(rng.integers(0, 255, RNG_PROMPT), jnp.int32)
    step = jnp.asarray(rng.integers(0, 255, RNG_STEP), jnp.int32)
    sp = prepare_tp_params(params, mesh, cfg)
    ck, cv = shard_cache(*transformer.init_cache(cfg, 2, 32, dtype=jnp.float32), cfg, mesh)
    fwd = _jit_tp(cfg, mesh, last_only=True)
    got1, ck, cv = fwd(sp, prompt, jnp.int32(0), ck, cv)
    got2, ck, cv = fwd(sp, step, jnp.int32(8), ck, cv)
    return {"prompt": np.asarray(prompt), "step": np.asarray(step),
            "prefill": np.asarray(got1), "decode": np.asarray(got2),
            "k": np.stack([np.asarray(c) for c in ck]),
            "v": np.stack([np.asarray(c) for c in cv])}


def _jax_per_row(cfg, params):
    """test_tp.test_tp_forward_per_row_n_past_and_window's inputs and JAX's
    tp outputs."""
    import jax
    import jax.numpy as jnp

    from llama_cpp_q_4_0_tpu.models import transformer
    from llama_cpp_q_4_0_tpu.parallel import make_mesh
    from llama_cpp_q_4_0_tpu.parallel.shard import shard_cache
    from llama_cpp_q_4_0_tpu.parallel.tp import prepare_tp_params

    mesh = make_mesh(dp=1, sp=1, tp=4)
    rng = np.random.default_rng(7)
    offs = jnp.asarray([0, 3, 7], jnp.int32)
    tok = jnp.asarray(rng.integers(0, 255, (3, 1)), jnp.int32)
    ck, cv = transformer.init_cache(cfg, 3, 32, dtype=jnp.float32)
    prim = jnp.asarray(rng.integers(0, 255, (3, 8)), jnp.int32)
    _, ck, cv = jax.jit(transformer.forward, static_argnames=("cfg", "last_only"))(
        cfg, params, prim, jnp.int32(0), ck, cv, last_only=True)
    k0 = np.stack([np.asarray(c) for c in ck])
    v0 = np.stack([np.asarray(c) for c in cv])
    tck, tcv = shard_cache(ck, cv, cfg, mesh)
    got, gck, gcv = _jit_tp(cfg, mesh, last_only=True, kv_window=16)(
        prepare_tp_params(params, mesh, cfg), tok, offs, tck, tcv)
    return {"offs": np.asarray(offs), "tok": np.asarray(tok), "k0": k0, "v0": v0,
            "logits": np.asarray(got), "k": np.stack([np.asarray(c) for c in gck]),
            "v": np.stack([np.asarray(c) for c in gcv])}


def _jax_spec(cfg, params):
    """test_tp.test_tp_speculative_verify_matches_plain's run through the tp
    verify: its emitted tokens."""
    import jax
    import jax.numpy as jnp

    from llama_cpp_q_4_0_tpu.models import transformer
    from llama_cpp_q_4_0_tpu.parallel import make_mesh
    from llama_cpp_q_4_0_tpu.parallel.shard import shard_cache
    from llama_cpp_q_4_0_tpu.parallel.tp import prepare_tp_params, spec_forward
    from llama_cpp_q_4_0_tpu.runtime.device_sample import DeviceSampling
    from llama_cpp_q_4_0_tpu.runtime.device_spec import spec_chunk

    mesh = make_mesh(dp=1, sp=1, tp=4)
    prompt = np.random.default_rng(3).integers(0, 255, 10).tolist()
    p = prepare_tp_params(params, mesh, cfg)
    ck, cv = shard_cache(*transformer.init_cache(cfg, 1, 64, dtype=jnp.float32), cfg, mesh)
    _, ck, cv = _jit_tp(cfg, mesh, last_only=True)(
        p, jnp.asarray([prompt[:-1]], jnp.int32), jnp.int32(0), ck, cv)
    hist = jnp.zeros((1, 64), jnp.int32).at[0, :len(prompt)].set(jnp.asarray(prompt))
    out = spec_chunk(cfg, p, hist, jnp.asarray([len(prompt)], jnp.int32), ck, cv,
                     jax.random.key(0), jnp.zeros((1,), bool), k=3, n_steps=4,
                     ds=DeviceSampling(temp=-1.0), kv_window=64, max_ngram=3, min_ngram=1,
                     eos=-1, ignore_eos=True, forward_fn=spec_forward(mesh))
    toks, ns = np.asarray(out[7])[:, 0], np.asarray(out[8])[:, 0]
    return {"prompt": prompt,
            "tokens": sum((toks[s, :int(ns[s])].tolist() for s in range(len(ns))), [])}


def _jax_engines(cfg, params):
    from llama_cpp_q_4_0_tpu.parallel import make_mesh
    from llama_cpp_q_4_0_tpu.runtime.device_sample import DeviceSampling
    from test_tp import _run_engine

    mesh = make_mesh(dp=1, sp=1, tp=4)
    ds = DeviceSampling(temp=-1.0)
    return {
        "staggered": _run_engine(cfg, params, ENGINE_PROMPTS["staggered"], tp_mesh=mesh),
        "chunked": _run_engine(cfg, params, ENGINE_PROMPTS["chunked"], chunk=2,
                               device_sampling=ds, tp_mesh=mesh),
        "spec": _run_engine(cfg, params, ENGINE_PROMPTS["spec"], spec_draft=2, chunk=2,
                            device_sampling=ds, tp_mesh=mesh)}


def jax_refs(out: str) -> None:
    from test_parallel import tiny_q_model
    from test_tp import _tiny_mqa

    for name, ((cfg, params), tp) in _jax_models().items():
        save(out, "model_" + name, (jax_cfg_dict(cfg), np_tree(params)))
        save(out, "ref_" + name, _jax_pair(cfg, params, tp))
    cfg, params = tiny_q_model(n_layer=1)
    save(out, "model_per_row", (jax_cfg_dict(cfg), np_tree(params)))
    save(out, "ref_per_row", _jax_per_row(cfg, params))
    save(out, "ref_engines", _jax_engines(cfg, params))
    cfg, params = _tiny_mqa(n_head=4)
    save(out, "model_spec", (jax_cfg_dict(cfg), np_tree(params)))
    save(out, "ref_spec", _jax_spec(cfg, params))


# ---------------------------------------------------------------- port side

def _gather_heads(caches, mesh):
    from llama_cpp_q_4_0_tpu_torch.parallel.mesh import all_gather

    return np.stack([all_gather(c, mesh, "tp", dim=2).numpy() for c in caches])


def _port_pair(cfg, params, mesh, ref):
    from llama_cpp_q_4_0_tpu_torch.models.transformer import init_cache
    from llama_cpp_q_4_0_tpu_torch.parallel.shard import kv_sharded, shard_cache
    from llama_cpp_q_4_0_tpu_torch.parallel.tp import prepare_tp_params, tp_forward

    p = prepare_tp_params(params, mesh, cfg)
    spec = (None, None, "tp" if kv_sharded(cfg, mesh.shape["tp"]) else None, None)
    ck, cv = shard_cache(*init_cache(cfg, 2, 32, torch.float32, "cpu"), cfg, mesh, spec)
    got1 = tp_forward(cfg, p, torch.from_numpy(ref["prompt"]).long(), 0, ck, cv, mesh)
    got2 = tp_forward(cfg, p, torch.from_numpy(ref["step"]).long(), 8, ck, cv, mesh)
    gather = kv_sharded(cfg, mesh.shape["tp"])
    return {"prefill": got1.numpy(), "decode": got2.numpy(),
            "k": _gather_heads(ck, mesh) if gather else np.stack([c.numpy() for c in ck]),
            "v": _gather_heads(cv, mesh) if gather else np.stack([c.numpy() for c in cv])}


def _port_per_row(cfg, params, mesh, ref):
    from llama_cpp_q_4_0_tpu_torch.parallel.shard import shard_cache
    from llama_cpp_q_4_0_tpu_torch.parallel.tp import prepare_tp_params, tp_forward

    spec = (None, None, "tp", None)
    ck, cv = shard_cache([torch.from_numpy(a) for a in ref["k0"]],
                         [torch.from_numpy(a) for a in ref["v0"]], cfg, mesh, spec)
    got = tp_forward(cfg, prepare_tp_params(params, mesh, cfg),
                     torch.from_numpy(ref["tok"]).long(), torch.from_numpy(ref["offs"]).long(),
                     ck, cv, mesh, last_only=True, kv_window=16)
    return {"logits": got.numpy(), "k": _gather_heads(ck, mesh), "v": _gather_heads(cv, mesh)}


def _port_spec(cfg, params, mesh, ref):
    from llama_cpp_q_4_0_tpu_torch.parallel.shard import kv_sharded, local_cache
    from llama_cpp_q_4_0_tpu_torch.parallel.tp import prepare_tp_params, spec_forward, tp_forward
    from llama_cpp_q_4_0_tpu_torch.runtime.device_sample import DeviceSampling, prng_key
    from llama_cpp_q_4_0_tpu_torch.runtime.device_spec import spec_chunk

    prompt = ref["prompt"]
    p = prepare_tp_params(params, mesh, cfg)
    heads = "tp" if kv_sharded(cfg, mesh.shape["tp"]) else None
    ck, cv = local_cache(cfg, 1, 64, torch.float32, mesh, (None, None, heads, None))
    tp_forward(cfg, p, torch.tensor([prompt[:-1]]), 0, ck, cv, mesh)
    hist = torch.zeros((1, 64), dtype=torch.int64)
    hist[0, :len(prompt)] = torch.tensor(prompt)
    out = spec_chunk(cfg, p, hist, torch.tensor([len(prompt)]), ck, cv, prng_key(0, "cpu"),
                     torch.zeros((1,), dtype=torch.bool), k=3, n_steps=4,
                     ds=DeviceSampling(temp=-1.0), kv_window=64, max_ngram=3, min_ngram=1,
                     eos=-1, ignore_eos=True, forward_fn=spec_forward(mesh))
    toks, ns = out[7][:, 0].numpy(), out[8][:, 0].numpy()
    return sum((toks[s, :int(ns[s])].tolist() for s in range(len(ns))), [])


def port_engine(cfg, params, prompts, samplings=None, **kw):
    """tests/test_tp.py's _run_engine on the port's engine (2 slots, n_ctx
    64, greedy unless samplings names a (SamplingParams, seed) a request, 6
    tokens a request), on the CPU."""
    from llama_cpp_q_4_0_tpu_torch.runtime.batch_engine import BatchEngine, Request
    from llama_cpp_q_4_0_tpu_torch.runtime.sampling import SamplingParams

    greedy = SamplingParams(temp=-1.0, top_k=0, repeat_penalty=1.0, repeat_last_n=0)
    samplings = samplings or [(greedy, -1)] * len(prompts)
    eng = BatchEngine(cfg, params, n_slots=2, n_ctx=64, device="cpu", **kw)
    reqs = [eng.submit(Request(p, n_predict=6, sampling=sp, seed=seed))
            for p, (sp, seed) in zip(prompts, samplings)]
    eng.start()
    try:
        return [list(r.tokens(timeout=120)) for r in reqs]
    finally:
        eng.stop()


def _port_mirostat(cfg, params, ds, mesh):
    """A mirostat request beside a greedy one on per-request device ticks:
    its first token is a host draw that moves the sampler's mu, which the
    next window seeds the device mu from.  In f32 products and an f32
    cache (the bf16 routes of the shards and of the whole weights part by
    ~1e-3 of the logits, which moves a random draw)."""
    from llama_cpp_q_4_0_tpu_torch.runtime.sampling import SamplingParams

    greedy = SamplingParams(temp=-1.0, top_k=0, repeat_penalty=1.0, repeat_last_n=0)
    mirostat = SamplingParams(temp=0.9, mirostat=2, mirostat_tau=4.0, mirostat_eta=0.2)
    return port_engine(dataclasses.replace(cfg, compute_dtype="float32"), params,
                       [[3, 5, 7, 11], [13, 17, 19]], samplings=[(mirostat, 1), (greedy, -1)],
                       chunk=2, per_request_sampling=True, device_sampling=ds,
                       cache_dtype=torch.float32, tp_mesh=mesh)


def port_world(rank: int, out: str) -> None:
    from llama_cpp_q_4_0_tpu_torch.parallel import make_mesh
    from llama_cpp_q_4_0_tpu_torch.runtime.device_sample import DeviceSampling

    tp4 = make_mesh(tp=4, device="cpu")
    tp2 = make_mesh(dp=2, tp=2, device="cpu")
    got = {}
    for name in FORWARD_CASES:
        cfg, params = port_model(out, "model_" + name)
        got[name] = _port_pair(cfg, params, tp4 if name.endswith("tp4") else tp2,
                               load(out, "ref_" + name))
    cfg, params = port_model(out, "model_per_row")
    got["per_row"] = _port_per_row(cfg, params, tp4, load(out, "ref_per_row"))
    ds = DeviceSampling(temp=-1.0)
    got["engines"] = {
        "staggered": port_engine(cfg, params, ENGINE_PROMPTS["staggered"], tp_mesh=tp4),
        "chunked": port_engine(cfg, params, ENGINE_PROMPTS["chunked"], chunk=2,
                               device_sampling=ds, tp_mesh=tp4),
        "spec": port_engine(cfg, params, ENGINE_PROMPTS["spec"], spec_draft=2, chunk=2,
                            device_sampling=ds, tp_mesh=tp4)}
    got["mirostat"] = {name: _port_mirostat(cfg, params, ds, mesh)
                       for name, mesh in (("tp4", tp4), ("plain", None))}
    cfg, params = port_model(out, "model_spec")
    got["spec"] = _port_spec(cfg, params, tp4, load(out, "ref_spec"))
    save(out, f"got_{rank}", got)


# -------------------------------------------------------------------- tests

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp"))
    run_jax(HERE, "jax_refs", out)
    run_world(4, HERE, "port_world", out)
    return out, [load(out, f"got_{r}") for r in range(4)]


@pytest.mark.parametrize("case", FORWARD_CASES)
def test_tp_forward_matches_jax(world, case):
    """Prefill then decode through the port's tp_forward: every rank's
    logits, and the caches (gathered over the heads), against JAX's."""
    out, got = world
    ref = load(out, "ref_" + case)
    for g in got:
        for key in ("prefill", "decode", "k", "v"):
            np.testing.assert_allclose(g[case][key], ref[key], **TOL, err_msg=key)


def test_tp_forward_per_row_n_past_and_window(world):
    out, got = world
    ref = load(out, "ref_per_row")
    for g in got:
        for key in ("logits", "k", "v"):
            np.testing.assert_allclose(g["per_row"][key], ref[key], **TOL, err_msg=key)


def test_tp_speculative_verify_matches_jax(world):
    out, got = world
    want = load(out, "ref_spec")["tokens"]
    assert want and all(g["spec"] == want for g in got), (want, [g["spec"] for g in got])


@pytest.mark.parametrize("mode", sorted(ENGINE_PROMPTS))
def test_tp_engine_matches_jax(world, mode):
    """BatchEngine(tp_mesh=tp 4): greedy tokens equal to JAX's tp engine on
    every rank."""
    out, got = world
    want = load(out, "ref_engines")[mode]
    assert all(len(t) == 6 for t in want)
    for g in got:
        assert g["engines"][mode] == want, (mode, want, g["engines"][mode])


def test_tp_engine_mirostat_same_on_every_rank(world):
    """BatchEngine(tp_mesh=tp 4) with per-request sampling and a seeded
    mirostat request: every rank emits the same tokens, and they are the
    unsharded engine's (rank 0's host draw is broadcast with its mu, so the
    device mu each window starts from is the same on every rank)."""
    _, got = world
    want = got[0]["mirostat"]["plain"]
    assert [len(t) for t in want] == [6, 6], want
    for g in got:
        assert g["mirostat"]["tp4"] == want, (want, g["mirostat"]["tp4"])


def test_tp_shards_route_as_the_jax_dispatch():
    """prepare_tp_params at LLaMA-7B's widths, tp 2 (the card's run): the
    column shards and the per-shard row repacks keep the shapes the JAX
    gate takes (n % 128 == 0 and k % 256 == 0) except w_down, whose local K
    5504 is off it; no process group is needed for the shapes."""
    from llama_cpp_q_4_0_tpu_torch.ops.qtensor import QTensor
    from llama_cpp_q_4_0_tpu_torch.parallel.tp import _localize
    from llama_cpp_q_4_0_tpu_torch.quant.types import GGMLType

    rng = np.random.default_rng(0)
    w = QTensor.quantize(rng.standard_normal((256, 11008), dtype=np.float32),
                         GGMLType.Q4_0, device="cpu")
    rs = w.repack_row_shards(2)
    local = _localize(dataclasses.replace(rs, levels_t=rs.levels_t[:rs.levels_t.shape[0] // 2],
                                          gscale_t=rs.gscale_t[:2]))
    assert local.shape == (256, 5504) and local.packed
    assert local.n_in % 256 == 128  # off the gate: the bf16 product, no kernel


# ------------------------------------------------------- the spec forward_fn

@pytest.fixture(scope="module")
def spec_models(tmp_path_factory):
    import jax.numpy as jnp  # noqa: F401  (the JAX side of the fixture)

    from llama_cpp_q_4_0_tpu.formats.fixtures import make_llama_ggjt
    from test_torch_spec import _load

    p = str(tmp_path_factory.mktemp("specfn") / "m.bin")
    make_llama_ggjt(p, n_vocab=256, n_embd=64, n_head=4, n_layer=2)
    return _load(p)


def _wrapped_forward():
    from llama_cpp_q_4_0_tpu_torch.models import transformer

    calls = []

    def fwd(cfg, params, toks, n_past, ck, cv, *, last_only, kv_window):
        calls.append(toks.shape)
        return transformer.forward(cfg, params, toks, n_past, ck, cv, last_only=last_only,
                                   kv_window=kv_window)

    return fwd, calls


def test_spec_chunk_forward_fn_matches_jax(spec_models):
    """The port's spec_chunk with a forward_fn that wraps transformer.forward
    (which the parent refused) emits JAX's spec_chunk tokens."""
    import jax
    import jax.numpy as jnp

    from llama_cpp_q_4_0_tpu.models import transformer as jtr
    from llama_cpp_q_4_0_tpu.runtime.device_sample import DeviceSampling as JDS
    from llama_cpp_q_4_0_tpu.runtime.device_spec import spec_chunk as jspec
    from llama_cpp_q_4_0_tpu_torch.models import transformer as ttr
    from llama_cpp_q_4_0_tpu_torch.runtime.device_sample import DeviceSampling, prng_key
    from llama_cpp_q_4_0_tpu_torch.runtime.device_spec import spec_chunk

    (jcfg, jp), (tcfg, tp) = spec_models
    prompt = ([5, 9, 13, 21, 5, 9, 13] * 3)[:16]
    static = dict(k=3, n_steps=4, kv_window=64, max_ngram=3, min_ngram=1, eos=-1,
                  ignore_eos=True)
    ck, cv = jtr.init_cache(jcfg, 1, 64, dtype=jnp.float32)
    _, ck, cv = jtr.forward(jcfg, jp, jnp.asarray([prompt[:-1]], jnp.int32), jnp.int32(0),
                            ck, cv, last_only=True)
    hist = jnp.zeros((1, 64), jnp.int32).at[0, :len(prompt)].set(jnp.asarray(prompt))
    out = jspec(jcfg, jp, hist, jnp.asarray([len(prompt)], jnp.int32), ck, cv,
                jax.random.key(0), jnp.zeros((1,), bool), ds=JDS(temp=-1.0), **static)
    want = (np.asarray(out[7])[:, 0], np.asarray(out[8])[:, 0])

    fwd, calls = _wrapped_forward()
    tck, tcv = ttr.init_cache(tcfg, 1, 64, torch.float32, "cpu")
    ttr.forward(tcfg, tp, torch.tensor([prompt[:-1]]), 0, tck, tcv, last_only=True)
    thist = torch.zeros((1, 64), dtype=torch.int64)
    thist[0, :len(prompt)] = torch.tensor(prompt)
    got = spec_chunk(tcfg, tp, thist, torch.tensor([len(prompt)]), tck, tcv,
                     prng_key(0, "cpu"), torch.zeros((1,), dtype=torch.bool),
                     ds=DeviceSampling(temp=-1.0), forward_fn=fwd, **static)
    assert len(calls) == 4  # every verify went through forward_fn
    np.testing.assert_array_equal(got[7][:, 0].numpy(), want[0])
    np.testing.assert_array_equal(got[8][:, 0].numpy(), want[1])
    assert int(want[1].sum()) > 4  # drafts were accepted


def test_spec_engine_forward_fn_matches_plain(spec_models):
    """A speculative BatchEngine given a forward_fn (refused by the parent)
    emits the plain speculative engine's greedy tokens."""
    from llama_cpp_q_4_0_tpu_torch.runtime.device_sample import DeviceSampling

    _, (tcfg, tp) = spec_models
    prompts = [[5, 9, 13, 5, 9, 13, 5], [7, 8, 7, 8, 7], [21, 22, 23]]
    ds = DeviceSampling(temp=-1.0)
    kw = dict(spec_draft=3, chunk=2, device_sampling=ds, cache_dtype=torch.float32)
    want = port_engine(tcfg, tp, prompts, **kw)
    fwd, calls = _wrapped_forward()
    got = port_engine(tcfg, tp, prompts, forward_fn=fwd, **kw)
    assert calls and got == want, (want, got)
