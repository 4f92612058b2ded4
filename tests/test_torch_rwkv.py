"""RWKV v4 on the CPU: the port's fixture files, config, loader, forward
(sequential and parallel, padded, every position's state), associative scan,
RwkvContext, sessions, perplexity, `load` and `main --arch rwkv` against the
JAX package's on the same files.

Both packages run every RWKV matmul in bf16 (the JAX forward calls
``q_matmul`` with its default whatever ``compute_dtype`` says), so an
activation one f32 ulp apart (a sum taken in another order) can round to
another bf16 value and move the logits by ~1e-3; the JAX package's own
parallel forward departs from its sequential one that far on such inputs.
So the recurrence is held to JAX's gates (rtol 2e-4, atol 2e-5) layer by
layer on shared inputs and through whole forwards, contexts and greedy runs
with both packages' products in f32 (``f32_products``: each package's
``_mm`` given compute_dtype float32, the JAX one run op by op); the default
bf16 forward is held to the repo's bf16 limit (1e-2 of the logit scale), and
the CLI's default-arithmetic text to JAX's on its short greedy run."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llama_cpp_q_4_0_tpu_torch
from llama_cpp_q_4_0_tpu.formats import fixtures as jax_fixtures
from llama_cpp_q_4_0_tpu.formats.ggjt import read_ggjt as jax_read_ggjt
from llama_cpp_q_4_0_tpu.models import rwkv as jr
from llama_cpp_q_4_0_tpu.models.loading import (config_from_ggjt as jax_config,
                                                load_rwkv as jax_load)
from llama_cpp_q_4_0_tpu.ops.qmatmul import q_matmul as jax_q_matmul
from llama_cpp_q_4_0_tpu.ops.qtensor import QTensor as JaxQTensor
from llama_cpp_q_4_0_tpu.quant.types import GGMLType as JaxGGMLType
from llama_cpp_q_4_0_tpu.runtime import session as js
from llama_cpp_q_4_0_tpu.runtime.context import RwkvContext as JaxRwkvContext
from llama_cpp_q_4_0_tpu.runtime.generate import (GenerateParams as JaxGenerateParams,
                                                  generate as jax_generate)
from llama_cpp_q_4_0_tpu.runtime.perplexity import perplexity as jax_perplexity
from llama_cpp_q_4_0_tpu.runtime.sampling import SamplingParams as JaxSampling
from llama_cpp_q_4_0_tpu_torch.convert import rwkv_params_from_numpy
from llama_cpp_q_4_0_tpu_torch.formats import fixtures
from llama_cpp_q_4_0_tpu_torch.formats.ggjt import read_ggjt
from llama_cpp_q_4_0_tpu_torch.models import rwkv as tr
from llama_cpp_q_4_0_tpu_torch.models.loading import config_from_ggjt, load_rwkv
from llama_cpp_q_4_0_tpu_torch.ops.qmatmul import q_matmul
from llama_cpp_q_4_0_tpu_torch.ops.qtensor import QTensor
from llama_cpp_q_4_0_tpu_torch.quant.types import GGMLType
from llama_cpp_q_4_0_tpu_torch.runtime import session as ts
from llama_cpp_q_4_0_tpu_torch.runtime.context import RwkvContext
from llama_cpp_q_4_0_tpu_torch.runtime.generate import GenerateParams, generate
from llama_cpp_q_4_0_tpu_torch.runtime.perplexity import perplexity
from llama_cpp_q_4_0_tpu_torch.runtime.sampling import SamplingParams

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE = dict(rtol=2e-4, atol=2e-5)  # tests/test_rwkv.py's parallel-vs-sequential gate
QTYPES = ("F32", "Q4_0")


def _write(tmp_path_factory, qtype, **kw):
    p = str(tmp_path_factory.mktemp(f"rwkv_{qtype}") / "rwkv.ggjt")
    jax_fixtures.make_rwkv_ggjt(p, qtype=JaxGGMLType[qtype], **kw)
    return p


@pytest.fixture(scope="module", params=QTYPES)
def path(request, tmp_path_factory):
    """4 layers, n_embd 64, rescale every 2 layers, a 512-entry vocabulary."""
    return _write(tmp_path_factory, request.param, n_layer=4, rescale_every=2)


def _jax(path, mode="float32"):
    gf = jax_read_ggjt(path, "rwkv")
    cfg = dataclasses.replace(jax_config(gf), compute_dtype=mode)
    return cfg, jax_load(gf, cfg)


def _port(path, mode="float32"):
    gf = read_ggjt(path, "rwkv")
    cfg = dataclasses.replace(config_from_ggjt(gf), compute_dtype=mode)
    return cfg, load_rwkv(gf, cfg, device="cpu")


@pytest.fixture
def f32_products(monkeypatch):
    """Both packages' RWKV matmuls in f32 (the JAX forward op by op, so no
    jit cache holds the bf16 trace)."""
    monkeypatch.setattr(jr, "_mm", lambda x, w: jax_q_matmul(x, w,
                                                             compute_dtype=jnp.float32))
    monkeypatch.setattr(tr, "_mm", lambda x, w: q_matmul(x, w, compute_dtype=torch.float32))
    with jax.disable_jit():
        yield


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close_states(got: dict, want: dict, **tol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), err_msg=k, **(tol or GATE))


def _inputs(n_vocab=512, b=2, t=16, lens=(13, 16), seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, n_vocab, (b, t))
    valid = np.arange(t)[None, :] < np.asarray(lens)[:, None]
    return toks, valid


def _jfwd(cfg, params, toks, valid=None, state=None, **kw):
    st = state if state is not None else jr.init_state(cfg, toks.shape[0])
    return jr.forward(cfg, params, jnp.asarray(toks, jnp.int32), st,
                      valid=None if valid is None else jnp.asarray(valid), **kw)


def _tfwd(cfg, params, toks, valid=None, state=None, **kw):
    st = state if state is not None else tr.init_state(cfg, toks.shape[0], "cpu")
    return tr.forward(cfg, params, torch.from_numpy(toks), st,
                      valid=None if valid is None else torch.from_numpy(valid), **kw)


# ---------------------------------------------------------- file and loader

@pytest.mark.parametrize("kw", [dict(), dict(qtype="F32", n_embd=32, seed=3),
                                dict(qtype="Q8_0", n_layer=3, rescale_every=2),
                                dict(qtype="F16", n_vocab=300, seed=5)],
                         ids=["q4_0", "f32", "q8_0", "f16"])
def test_fixture_files_equal_jax(tmp_path, kw):
    """The port's make_rwkv_ggjt writes the JAX generator's file byte for byte."""
    pa, pb = str(tmp_path / "jax.ggjt"), str(tmp_path / "port.ggjt")
    jkw, tkw = dict(kw), dict(kw)
    if "qtype" in kw:
        jkw["qtype"], tkw["qtype"] = JaxGGMLType[kw["qtype"]], GGMLType[kw["qtype"]]
    want = jax_fixtures.make_rwkv_ggjt(pa, **jkw)
    got = fixtures.make_rwkv_ggjt(pb, **tkw)
    with open(pa, "rb") as fa, open(pb, "rb") as fb:
        assert fa.read() == fb.read()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_config_equals_jax(path):
    want = dataclasses.asdict(jax_config(jax_read_ggjt(path, "rwkv"), n_ctx=256))
    got = dataclasses.asdict(config_from_ggjt(read_ggjt(path, "rwkv"), n_ctx=256))
    assert got == want and got["rescale_every"] == 2 and got["arch"] == "rwkv"


def _leaves(params):
    out = []
    for f in ("wte", "ln_pre_g", "ln_pre_b", "ln_out_g", "ln_out_b", "head"):
        out.append((f, getattr(params, f)))
    for i, lay in enumerate(params.layers):
        out += [(f"layers.{i}.{f.name}", getattr(lay, f.name))
                for f in dataclasses.fields(lay)]
    flat = []
    for name, v in out:
        if isinstance(v, (QTensor, JaxQTensor)):
            flat += [(name + ".levels_t", v.levels_t), (name + ".gscale_t", v.gscale_t),
                     (name + ".meta", np.asarray([*v.shape, v.gsize, int(v.qtype),
                                                  -1 if v.pack_zero is None
                                                  else v.pack_zero]))]
            assert v.gbias_t is None, name
        else:
            flat.append((name, v))
    return [(n, _np(a) if (isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16)
             or getattr(a, "dtype", None) == jnp.bfloat16 else np.asarray(a))
            for n, a in flat]


@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_load_rwkv_bytes_equal_jax(path, mode):
    """Every level byte, scale plane and 1-D parameter of load_rwkv equals
    the JAX loader's, with its dtype (1-D parameters f32, a dense 2-D weight
    in the compute dtype's)."""
    a, b = _leaves(_port(path, mode)[1]), _leaves(_jax(path, mode)[1])
    assert [n for n, _ in a] == [n for n, _ in b]
    for (name, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def _numpy_tree(params):
    def leaf(v):
        if isinstance(v, JaxQTensor):
            return {"levels_t": np.asarray(v.levels_t), "gscale_t": np.asarray(v.gscale_t),
                    "gbias_t": None, "gsize": v.gsize, "qtype": int(v.qtype),
                    "shape": tuple(v.shape), "pack_zero": v.pack_zero}
        return np.asarray(v)

    tree = {f: leaf(getattr(params, f)) for f in ("wte", "ln_pre_g", "ln_pre_b",
                                                   "ln_out_g", "ln_out_b", "head")}
    tree["layers"] = [{f.name: leaf(getattr(lay, f.name)) for f in dataclasses.fields(lay)}
                      for lay in params.layers]
    return tree


def test_rwkv_params_from_numpy_matches_loader(path):
    """convert.rwkv_params_from_numpy of the JAX params gives the port's
    loader's tensors."""
    conv = rwkv_params_from_numpy(_numpy_tree(_jax(path)[1]), device="cpu")
    a, b = _leaves(conv), _leaves(_port(path)[1])
    for (name, x), (_, y) in zip(a, b):
        np.testing.assert_array_equal(x, y, err_msg=name)


# -------------------------------------------------------------------- scan

@pytest.mark.parametrize("t", [1, 2, 3, 5, 8, 13, 16, 33])
def test_associative_scan_matches_jax(t):
    """The port's associative_scan of both combines against
    jax.lax.associative_scan over odd and even T, on the same inputs: the
    same brackets, so the same f32 values bit for bit."""
    rng = np.random.default_rng(t)
    a = rng.standard_normal((2, t, 24)).astype(np.float32)
    b = rng.standard_normal((2, t, 24)).astype(np.float32)
    for jcomb, tcomb in ((lambda l, r: (l[0] + r[0], jnp.maximum(l[1] + r[0], r[1])),
                          tr._max_combine),
                         (lambda l, r: (l[0] * r[0], r[0] * l[1] + r[1]), tr._lin_combine)):
        want = jax.lax.associative_scan(jcomb, (jnp.asarray(a), jnp.asarray(b)), axis=1)
        got = tr.associative_scan(tcomb, [torch.from_numpy(a), torch.from_numpy(b)])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ----------------------------------------------------------------- forward

@pytest.mark.parametrize("kind", ["step", "parallel", "parallel_valid", "all_states"])
def test_layers_match_jax(path, kind, f32_products):
    """Each layer on shared inputs (the port's own output of the layer
    before, halved where rescale_every says): its output and state within
    JAX's gate."""
    jcfg, jp = _jax(path)
    tcfg, tp = _port(path)
    rng = np.random.default_rng(1)
    b, t, e = 2, 16, jcfg.n_embd
    x = rng.standard_normal((b, e) if kind == "step" else (b, t, e)).astype(np.float32)
    valid = _inputs()[1] if kind == "parallel_valid" else None
    st = {k: rng.standard_normal((b, e)).astype(np.float32) * 0.5 for k in tr.STATE_KEYS}
    st["maxv"] = st["maxv"] - 1.0
    for i, (jl, tl) in enumerate(zip(jp.layers, tp.layers)):
        jst = {k: jnp.asarray(v) for k, v in st.items()}
        tst = {k: torch.from_numpy(v) for k, v in st.items()}
        if kind == "step":
            wx, wst = jr._layer_step(jcfg, jl, jst, jnp.asarray(x))
            gx, gst = tr._layer_step(tcfg, tl, tst, torch.from_numpy(x))
        else:
            jv = None if valid is None else jnp.asarray(valid)
            tv = None if valid is None else torch.from_numpy(valid)
            wx, wst = jr._layer_parallel(jcfg, jl, jst, jnp.asarray(x), jv,
                                         kind == "all_states")
            gx, gst = tr._layer_parallel(tcfg, tl, tst, torch.from_numpy(x), tv,
                                         kind == "all_states")
        mask = np.ones(x.shape[:-1], bool) if valid is None else valid
        np.testing.assert_allclose(_np(gx)[mask], _np(wx)[mask], err_msg=f"layer {i}", **GATE)
        _close_states(gst, wst)
        x = _np(gx) * (0.5 if (i + 1) % tcfg.rescale_every == 0 else 1.0)


@pytest.mark.parametrize("parallel", [False, True], ids=["sequential", "parallel"])
def test_forward_matches_jax(path, parallel, f32_products):
    """rwkv.forward over a ragged batch (valid masks of 13 and 16 of 16
    tokens), from a fresh state and again from the state it leaves: the
    logits of every valid position and all five state tensors within JAX's
    gate."""
    jcfg, jp = _jax(path)
    tcfg, tp = _port(path)
    toks, valid = _inputs()
    wl, wst = _jfwd(jcfg, jp, toks, valid, parallel=parallel)
    gl, gst = _tfwd(tcfg, tp, toks, valid, parallel=parallel)
    np.testing.assert_allclose(_np(gl)[valid], _np(wl)[valid], **GATE)
    _close_states(gst, wst)
    toks2, valid2 = _inputs(t=8, lens=(8, 5), seed=1)
    wl, wst = _jfwd(jcfg, jp, toks2, valid2, state=wst, parallel=parallel, last_only=True)
    gl, gst = _tfwd(tcfg, tp, toks2, valid2, state=gst, parallel=parallel, last_only=True)
    np.testing.assert_allclose(_np(gl), _np(wl), **GATE)
    _close_states(gst, wst)


def test_forward_all_states_matches_jax(path, f32_products):
    """all_states: the state after every position, 5 x [L, B, T, E], within
    JAX's gate, and its last position equal to the carried state."""
    jcfg, jp = _jax(path)
    tcfg, tp = _port(path)
    toks, _ = _inputs(t=6)
    wl, wst = _jfwd(jcfg, jp, toks, all_states=True)
    gl, gst = _tfwd(tcfg, tp, toks, all_states=True)
    np.testing.assert_allclose(_np(gl), _np(wl), **GATE)
    _close_states(gst, wst)
    _, last = _tfwd(tcfg, tp, toks, parallel=True)
    for k in tr.STATE_KEYS:
        assert gst[k].shape == (tcfg.n_layer, 2, 6, tcfg.n_embd)
        np.testing.assert_array_equal(gst[k][:, :, -1].numpy(), last[k].numpy())


@pytest.mark.parametrize("parallel", [False, True], ids=["sequential", "parallel"])
def test_forward_bf16_products_match_jax(path, parallel):
    """The default arithmetic (bf16 products): the logits of every valid
    position within the repo's bf16 limit, 1e-2 of the logit scale (one
    activation rounded to another bf16 value moves them ~1e-3), and the
    state of the last valid position within 1e-2 of its scale."""
    jcfg, jp = _jax(path, "bfloat16")
    tcfg, tp = _port(path, "bfloat16")
    toks, valid = _inputs()
    wl, wst = _jfwd(jcfg, jp, toks, valid, parallel=parallel)
    gl, gst = _tfwd(tcfg, tp, toks, valid, parallel=parallel)
    w = _np(wl)[valid]
    assert np.abs(_np(gl)[valid] - w).max() <= 1e-2 * np.abs(w).max()
    for k in wst:
        assert np.abs(_np(gst[k]) - _np(wst[k])).max() <= 1e-2 * np.abs(_np(wst[k])).max(), k


@pytest.mark.parametrize("rescale_every", [0, 1, 3])
def test_rescale_every_matches_jax(tmp_path, rescale_every, f32_products):
    """x halved after every rescale_every layers (0: never), as JAX does it:
    the logits within JAX's gate on both paths, and each setting gives other
    logits than no rescale."""
    p = str(tmp_path / "r.ggjt")
    jax_fixtures.make_rwkv_ggjt(p, qtype=JaxGGMLType.F32, n_layer=3,
                                rescale_every=rescale_every, n_vocab=128)
    jcfg, jp = _jax(p)
    tcfg, tp = _port(p)
    toks, _ = _inputs(n_vocab=128, t=8)
    for parallel in (False, True):
        wl, _ = _jfwd(jcfg, jp, toks, parallel=parallel)
        gl, _ = _tfwd(tcfg, tp, toks, parallel=parallel)
        np.testing.assert_allclose(_np(gl), _np(wl), **GATE)
        if rescale_every:
            none, _ = _tfwd(dataclasses.replace(tcfg, rescale_every=0), tp, toks,
                            parallel=parallel)
            assert np.abs(_np(none) - _np(gl)).max() > 1e-3


def test_parallel_prefill_matches_sequential(path):
    """tests/test_rwkv.py's parallel-vs-sequential gate on the port alone,
    in the default arithmetic, on that test's inputs (n_vocab 128, a ragged
    batch of 13 and 16 tokens)."""
    p = os.path.join(os.path.dirname(path), "v128.ggjt")
    qtype = JaxGGMLType.F32 if "F32" in path else JaxGGMLType.Q4_0
    jax_fixtures.make_rwkv_ggjt(p, qtype=qtype, n_vocab=128, n_embd=64, n_layer=4,
                                rescale_every=2)
    cfg, params = _port(p, "bfloat16")
    toks, valid = _inputs(n_vocab=128)
    sl, sst = _tfwd(cfg, params, toks, valid, parallel=False)
    pl, pst = _tfwd(cfg, params, toks, valid, parallel=True)
    np.testing.assert_allclose(_np(pl)[valid], _np(sl)[valid], **GATE)
    _close_states(pst, sst)


# ----------------------------------------------------------------- context

def test_bucket_padding_state_exact(tmp_path):
    """A prompt padded to its bucket (3 -> 8) leaves the logits and the
    state of the unpadded forward (tests/test_rwkv.py's 1e-5), and the
    context's state tensors are written in place (never rebound)."""
    p = str(tmp_path / "r.ggjt")
    fixtures.make_rwkv_ggjt(p, qtype=GGMLType.F32, n_vocab=128, n_embd=32, n_layer=2)
    cfg, params = _port(p, "bfloat16")
    toks = np.asarray([[5, 9, 11]])
    ref_l, ref_st = _tfwd(cfg, params, toks, last_only=True)
    ctx = RwkvContext(cfg, params, device="cpu")
    ptrs = [t.data_ptr() for t in ctx.state.values()]
    got = ctx.eval(toks)
    assert ctx.last_call.x.shape == (1, 8) and ctx.last_call.valid.sum() == 3
    np.testing.assert_allclose(got, _np(ref_l), rtol=1e-5, atol=1e-5)
    _close_states(ctx.state, ref_st, rtol=1e-5, atol=1e-5)
    ctx.reset()
    assert [t.data_ptr() for t in ctx.state.values()] == ptrs
    assert (ctx.state["maxv"] == -1e30).all() and (ctx.state["num"] == 0).all()
    ctx.set_state({k: v.numpy() for k, v in ref_st.items()})
    assert [t.data_ptr() for t in ctx.state.values()] == ptrs


def _steps(ctx, seq=([1, 5, 10, 42, 7, 9, 11, 3, 60, 2], [3], [100], [200]), **kw):
    return [np.asarray(ctx.eval(np.asarray([s]), **kw)) for s in seq]


@pytest.mark.parametrize("logits_all", [False, True])
def test_context_matches_jax(path, logits_all, f32_products):
    """RwkvContext against the JAX RwkvContext: a 10-token prompt (bucket
    32, the parallel path) and three decode steps, logits (every row with
    logits_all) and state within JAX's gate; n_past and the timings'
    counts agree."""
    jcfg, jp = _jax(path)
    tcfg, tp = _port(path)
    jctx, tctx = JaxRwkvContext(jcfg, jp), RwkvContext(tcfg, tp, device="cpu")
    for a, b in zip(_steps(tctx, logits_all=logits_all), _steps(jctx, logits_all=logits_all)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **GATE)
    _close_states(tctx.state, jctx.state)
    assert tctx.n_past == jctx.n_past == 13
    assert (tctx.timings.n_prompt, tctx.timings.n_eval) == (10, 3)


GREEDY = dict(temp=-1.0, top_k=0, repeat_penalty=1.0, repeat_last_n=0)


def test_greedy_tokens_equal_jax(path, f32_products):
    """16 greedy tokens through generate on each package's context."""
    jcfg, jp = _jax(path)
    tcfg, tp = _port(path)
    prompt = [7, 9, 23, 7, 9, 23, 7, 9, 100, 5]
    want = list(jax_generate(JaxRwkvContext(jcfg, jp), prompt, JaxGenerateParams(
        n_predict=16, sampling=JaxSampling(**GREEDY), ignore_eos=True), eos_token=-1))
    got = list(generate(RwkvContext(tcfg, tp, device="cpu"), prompt, GenerateParams(
        n_predict=16, sampling=SamplingParams(**GREEDY), ignore_eos=True), eos_token=-1))
    assert got == want and len(got) == 16


def test_perplexity_host_loop_matches_jax(path, f32_products):
    """runtime/perplexity.py's host loop takes an RwkvContext (reset and
    eval with logits_all per chunk): the JAX value to 1e-5."""
    jcfg, jp = _jax(path)
    tcfg, tp = _port(path)
    toks = np.random.default_rng(2).integers(3, 512, 64).tolist()
    want = jax_perplexity(JaxRwkvContext(jcfg, jp), toks, n_ctx=32, n_batch=16)
    got = perplexity(RwkvContext(tcfg, tp, device="cpu"), toks, n_ctx=32, n_batch=16)
    assert np.isfinite(got.ppl) and got.count == want.count
    np.testing.assert_allclose(got.ppl, want.ppl, rtol=1e-5)


# ---------------------------------------------------------------- sessions

@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_zip_session_loads_across_packages(tmp_path, path, direction, f32_products):
    """A zip session of an RWKV context saved by one package loads in the
    other (the s_ keys of the state blob): the token list, n_past, the
    state and the next 4 greedy tokens; the port restores in place."""
    jcfg, jp = _jax(path)
    tcfg, tp = _port(path)
    tokens = [1, 9, 27, 5, 100, 42, 7, 300]
    p = str(tmp_path / "s.bin")
    if direction == "jax_to_port":
        src, dst = JaxRwkvContext(jcfg, jp), RwkvContext(tcfg, tp, device="cpu")
        save, load = js.save_session, ts.load_session
    else:
        src, dst = RwkvContext(tcfg, tp, device="cpu"), JaxRwkvContext(jcfg, jp)
        save, load = ts.save_session, js.load_session
    src.eval(np.asarray([tokens]))
    save(p, src, tokens)
    ptrs = ([t.data_ptr() for t in dst.state.values()] if isinstance(dst, RwkvContext)
            else None)
    assert load(p, dst) == tokens and dst.n_past == src.n_past
    if ptrs is not None:
        assert [t.data_ptr() for t in dst.state.values()] == ptrs
    for k in src.state:
        np.testing.assert_array_equal(_np(dst.state[k]), _np(src.state[k]), err_msg=k)

    def greedy(ctx):
        out = []
        for _ in range(4):
            out.append(int(np.argmax(np.asarray(ctx.logits)[0, -1])))
            ctx.eval(np.asarray([[out[-1]]]))
        return out

    assert greedy(dst) == greedy(src)


def test_state_size_matches_jax(path):
    """get_state_size: the same npz blob size (n_past, the s_ arrays, the
    logits)."""
    jcfg, jp = _jax(path)
    tcfg, tp = _port(path)
    jctx, tctx = JaxRwkvContext(jcfg, jp), RwkvContext(tcfg, tp, device="cpu")
    for ctx in (jctx, tctx):
        ctx.eval(np.asarray([[1, 5, 9]]))
    assert ts.get_state_size(tctx) == js.get_state_size(jctx)


# --------------------------------------------------------- entry points

def test_load_one_call(path):
    """llama_cpp_q_4_0_tpu_torch.load: an RwkvContext for an RWKV file on
    the device asked for; without CUDA the default device raises."""
    ctx, tok = llama_cpp_q_4_0_tpu_torch.load(path, device="cpu")
    assert isinstance(ctx, RwkvContext) and ctx.device.type == "cpu"
    assert ctx.cfg.arch == "rwkv" and tok.vocab.n_vocab == 512
    assert np.isfinite(ctx.eval([tok.tokenize("hello")])).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            llama_cpp_q_4_0_tpu_torch.load(path)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            RwkvContext(ctx.cfg, ctx.params)


@pytest.mark.parametrize("extra", [[], ["--draft", "3"]], ids=["plain", "draft"])
def test_main_arch_rwkv_prints_the_jax_text(path, extra, capsysbinary):
    """`main --arch rwkv` (no BOS for RWKV prompts), greedy, 6 tokens,
    against the JAX package's `main` on the same file; with --draft both
    take the device loop over the recurrent state."""
    import llama_cpp_q_4_0_tpu.cli.main as jax_main

    args = ["-m", path, "--arch", "rwkv", "-p", "hello world", "-n", "6", "-c", "64",
            "-s", "1", "--temp", "-1", "--ignore-eos", *extra]
    assert jax_main.main(args) == 0
    want = capsysbinary.readouterr().out
    r = subprocess.run([sys.executable, "-m", "llama_cpp_q_4_0_tpu_torch", "main", *args,
                        "--device", "cpu"], capture_output=True, cwd=ROOT, timeout=300,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout == want and len(r.stdout) > len(b"hello world")
