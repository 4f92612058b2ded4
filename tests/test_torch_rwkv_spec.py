"""RWKV speculative decoding on the CPU (runtime/device_spec.py
``rwkv_spec_round`` / ``rwkv_spec_chunk`` / ``generate_ondevice_spec_rwkv``
and ``RwkvContext.spec_chunk``): greedy tokens equal to plain decoding's and
to the JAX package's, the state after a run equal to a sequential replay of
the consumed history, the penalized chain equal to the host chain's, sampled
tokens on the sampler's support, and one chunk against the JAX
``rwkv_spec_chunk`` on the same history and state.  The fixture is
tests/test_rwkv_spec.py's (F32, 4 layers, n_embd 64, a 256-entry
vocabulary)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_q_4_0_tpu.formats.fixtures import make_rwkv_ggjt
from llama_cpp_q_4_0_tpu.formats.ggjt import read_ggjt as jax_read_ggjt
from llama_cpp_q_4_0_tpu.models import rwkv as jr
from llama_cpp_q_4_0_tpu.models.loading import (config_from_ggjt as jax_config,
                                                load_rwkv as jax_load)
from llama_cpp_q_4_0_tpu.ops.qmatmul import q_matmul as jax_q_matmul
from llama_cpp_q_4_0_tpu.quant.types import GGMLType
from llama_cpp_q_4_0_tpu.runtime import device_spec as jdsp
from llama_cpp_q_4_0_tpu.runtime.context import RwkvContext as JaxRwkvContext
from llama_cpp_q_4_0_tpu.runtime.device_sample import DeviceSampling as JDS
from llama_cpp_q_4_0_tpu.runtime.speculative import SpecParams as JSpecParams
from llama_cpp_q_4_0_tpu_torch.formats.ggjt import read_ggjt
from llama_cpp_q_4_0_tpu_torch.models import rwkv as tr
from llama_cpp_q_4_0_tpu_torch.models.loading import config_from_ggjt, load_rwkv
from llama_cpp_q_4_0_tpu_torch.ops.qmatmul import q_matmul
from llama_cpp_q_4_0_tpu_torch.runtime import device_spec as tdsp
from llama_cpp_q_4_0_tpu_torch.runtime.context import RwkvContext
from llama_cpp_q_4_0_tpu_torch.runtime.device_sample import DeviceSampling, prng_key
from llama_cpp_q_4_0_tpu_torch.runtime.generate import GenerateParams, generate
from llama_cpp_q_4_0_tpu_torch.runtime.sampling import SamplingParams
from llama_cpp_q_4_0_tpu_torch.runtime.speculative import SpecParams, SpecStats

torch.set_num_threads(1)

GREEDY = SamplingParams(temp=-1.0, top_k=0, repeat_penalty=1.0, repeat_last_n=0)
GATE = dict(rtol=2e-4, atol=2e-5)
REPETITIVE = [7, 9, 23, 7, 9, 23, 7, 9, 23, 7, 9, 23]


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("rspec") / "m.ggjt")
    make_rwkv_ggjt(p, qtype=GGMLType.F32, n_vocab=256, n_embd=64, n_layer=4)
    return p


@pytest.fixture(scope="module")
def model(path):
    gf = read_ggjt(path, "rwkv")
    cfg = config_from_ggjt(gf)
    return cfg, load_rwkv(gf, cfg, device="cpu")


def _ctx(model):
    return RwkvContext(*model, device="cpu")


def _plain(model, prompt, n, sp=GREEDY):
    return list(generate(_ctx(model), prompt, GenerateParams(n_predict=n, sampling=sp,
                                                             ignore_eos=True), eos_token=-1))


@pytest.mark.parametrize("prompt_kind", ["repetitive", "random"])
def test_rwkv_spec_greedy_matches_plain(model, prompt_kind):
    """generate_ondevice_spec_rwkv's greedy tokens are plain decoding's; on
    the repeating pattern a verify emits more than 1.5 tokens."""
    prompt = (REPETITIVE if prompt_kind == "repetitive"
              else np.random.default_rng(3).integers(3, 250, 12).tolist())
    want = _plain(model, prompt, 24)
    stats = SpecStats()
    got = tdsp.generate_ondevice_spec_rwkv(_ctx(model), prompt, 24,
                                           sampling=DeviceSampling(temp=-1.0),
                                           spec=SpecParams(n_draft=5), n_steps=3,
                                           ignore_eos=True, stats=stats)
    assert got == want and stats.n_verify >= 1
    if prompt_kind == "repetitive":
        assert stats.tokens_per_step > 1.5


@pytest.mark.parametrize("prompt_kind", ["repetitive", "random"])
def test_rwkv_spec_greedy_equals_jax(path, model, prompt_kind):
    """The port's greedy tokens and SpecStats equal the JAX
    generate_ondevice_spec_rwkv's on the same file and prompt."""
    prompt = (REPETITIVE if prompt_kind == "repetitive"
              else np.random.default_rng(3).integers(3, 250, 12).tolist())
    gf = jax_read_ggjt(path, "rwkv")
    jcfg = jax_config(gf)
    jstats, tstats = jdsp.SpecStats(), SpecStats()
    want = jdsp.generate_ondevice_spec_rwkv(
        JaxRwkvContext(jcfg, jax_load(gf, jcfg)), prompt, 20, sampling=JDS(temp=-1.0),
        spec=JSpecParams(n_draft=4), n_steps=2, ignore_eos=True, stats=jstats)
    got = tdsp.generate_ondevice_spec_rwkv(_ctx(model), prompt, 20,
                                           sampling=DeviceSampling(temp=-1.0),
                                           spec=SpecParams(n_draft=4), n_steps=2,
                                           ignore_eos=True, stats=tstats)
    assert got == want
    assert dataclasses.asdict(tstats) == dataclasses.asdict(jstats)


def test_rwkv_spec_penalized_matches_host_chain(model):
    """Greedy with a repetition penalty: the device verify applies the
    penalty window the host sampler chain does."""
    prompt = [5, 8, 5, 8, 5, 8, 5, 8, 5, 8]
    sp = SamplingParams(temp=-1.0, top_k=0, repeat_penalty=1.3, repeat_last_n=16)
    want = _plain(model, prompt, 20, sp)
    got = tdsp.generate_ondevice_spec_rwkv(
        _ctx(model), prompt, 20,
        sampling=DeviceSampling(temp=-1.0, repeat_penalty=1.3, repeat_last_n=16),
        spec=SpecParams(n_draft=4), n_steps=2, ignore_eos=True)
    assert got == want


def test_rwkv_spec_sampled_on_support(model):
    """Sampled speculation (temp 0.8, top-k 5, a repetition penalty): n
    tokens, each among the 5 most likely of the plain logits after the
    history before it, penalties applied (the chain's support)."""
    prompt = REPETITIVE
    ds = DeviceSampling(temp=0.8, top_k=5, repeat_penalty=1.1, repeat_last_n=16)
    got = tdsp.generate_ondevice_spec_rwkv(_ctx(model), prompt, 16, sampling=ds,
                                           spec=SpecParams(n_draft=4), n_steps=2,
                                           ignore_eos=True, seed=5)
    assert len(got) == 16
    ctx = _ctx(model)
    logits = ctx.eval(np.asarray([prompt]))[0, -1]
    hist = list(prompt)
    for tok in got:
        pen = logits.copy()
        for t in set(hist[-16:]):
            pen[t] = pen[t] / 1.1 if pen[t] > 0 else pen[t] * 1.1
        assert tok in np.argsort(-pen)[:5]
        hist.append(tok)
        logits = ctx.eval(np.asarray([[tok]]))[0, -1]


def test_rwkv_spec_state_matches_sequential_replay(model):
    """After a speculative run the state equals a replay of the consumed
    history (prompt + the plain chain up to ctx.n_past) from scratch: no
    rejected draft is left in it.  The context's state tensors are never
    rebound."""
    prompt = [11, 4, 11, 4, 11, 4, 11, 4]
    chain = _plain(model, prompt, 40)
    ctx = _ctx(model)
    ptrs = [t.data_ptr() for t in ctx.state.values()]
    out = tdsp.generate_ondevice_spec_rwkv(ctx, prompt, 16, sampling=DeviceSampling(temp=-1.0),
                                           spec=SpecParams(n_draft=5), n_steps=2,
                                           ignore_eos=True)
    assert out == chain[:16] and [t.data_ptr() for t in ctx.state.values()] == ptrs
    g = ctx.n_past - len(prompt)
    assert g >= 15
    replay = _ctx(model)
    replay.eval(np.asarray([prompt + chain[:g]]))
    for k in ctx.state:
        np.testing.assert_allclose(ctx.state[k].numpy(), replay.state[k].numpy(), err_msg=k,
                                   **GATE)


@pytest.fixture
def f32_products(monkeypatch):
    monkeypatch.setattr(jr, "_mm", lambda x, w: jax_q_matmul(x, w,
                                                             compute_dtype=jnp.float32))
    monkeypatch.setattr(tr, "_mm", lambda x, w: q_matmul(x, w, compute_dtype=torch.float32))
    with jax.disable_jit():
        yield


@pytest.mark.parametrize("ignore_eos", [True, False])
def test_rwkv_spec_chunk_matches_jax(path, model, ignore_eos, f32_products):
    """One 3-round chunk on two rows, one of them frozen, from the same
    history and state (a prefill of each row's prompt): the emitted tokens,
    counts, history, lengths and frozen rows equal the JAX
    ``rwkv_spec_chunk``'s, the state within JAX's gate, the frozen row's
    state untouched.  Without ignore_eos the EOS is a token the chunk
    emits, so its row freezes mid-chunk and keeps the state of its last
    token before it."""
    cfg, params = model
    gf = jax_read_ggjt(path, "rwkv")
    jcfg = jax_config(gf)
    jp = jax_load(gf, jcfg)
    prompts = [REPETITIVE, [5, 8, 5, 8, 5, 8, 5, 8, 5, 8, 3, 1]]
    h, k = 48, 3
    hist = np.zeros((2, h), np.int64)
    for i, p in enumerate(prompts):
        hist[i, :len(p)] = p
    n_hist = np.asarray([len(p) for p in prompts])
    toks = hist[:, :11]  # each row's prompt but its last token, into the state
    _, jst = jr.forward(jcfg, jp, jnp.asarray(toks, jnp.int32), jr.init_state(jcfg, 2))
    _, tst = tr.forward(cfg, params, torch.from_numpy(toks), tr.init_state(cfg, 2, "cpu"))
    if ignore_eos:
        eos = 2
    else:  # the first token the free row's second round emits
        probe = tdsp.rwkv_spec_chunk(cfg, params, torch.from_numpy(hist),
                                     torch.from_numpy(n_hist),
                                     {key: v.clone() for key, v in tst.items()},
                                     prng_key(0, "cpu"), torch.tensor([False, True]), k=k,
                                     n_steps=2, ds=DeviceSampling(temp=-1.0), max_ngram=3,
                                     min_ngram=1, eos=-1, ignore_eos=True)
        eos = int(probe[6][1, 0, 0])
    done = np.asarray([False, True])
    kw = dict(k=k, n_steps=3, max_ngram=3, min_ngram=1, eos=eos, ignore_eos=ignore_eos)
    want = jdsp.rwkv_spec_chunk(jcfg, jp, jnp.asarray(hist, jnp.int32),
                                jnp.asarray(n_hist, jnp.int32), jst, jax.random.key(0),
                                jnp.asarray(done), ds=JDS(temp=-1.0), **kw)
    frozen = {key: v[:, 1].clone() for key, v in tst.items()}
    got = tdsp.rwkv_spec_chunk(cfg, params, torch.from_numpy(hist), torch.from_numpy(n_hist),
                               tst, prng_key(0, "cpu"), torch.from_numpy(done),
                               ds=DeviceSampling(temp=-1.0), **kw)
    for i in (0, 1, 4, 5, 6, 7):  # hist, n_hist, done, eosed, emit_toks, emit_ns
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]), err_msg=str(i))
    assert got[2] is tst
    for key in tst:
        np.testing.assert_allclose(tst[key].numpy(), np.asarray(want[2][key]), err_msg=key,
                                   **GATE)
        assert torch.equal(tst[key][:, 1], frozen[key]), key
    assert got[7][:, 1].sum() == 0 and got[7][:, 0].sum() > 0
    assert bool(got[5][0]) == (not ignore_eos)


def test_rwkv_context_spec_chunk_cpu_is_the_eager_chunk(model):
    """RwkvContext.spec_chunk on the CPU is rwkv_spec_chunk on its params
    and state: the same outputs, the state written in place."""
    prompt = REPETITIVE
    hist = torch.zeros((1, 40), dtype=torch.int64)
    hist[0, :len(prompt)] = torch.tensor(prompt)
    kw = dict(k=4, n_steps=2, ds=DeviceSampling(temp=-1.0), max_ngram=3, min_ngram=1, eos=2,
              ignore_eos=True)
    a, b = _ctx(model), _ctx(model)
    for c in (a, b):
        c.eval(np.asarray([prompt[:-1]]))
    ptrs = [t.data_ptr() for t in a.state.values()]
    got = a.spec_chunk(hist, torch.tensor([len(prompt)]), prng_key(0, "cpu"),
                       torch.tensor([False]), **kw)
    want = tdsp.rwkv_spec_chunk(a.cfg, b.params, hist, torch.tensor([len(prompt)]), b.state,
                                prng_key(0, "cpu"), torch.tensor([False]), **kw)
    for g, w in zip(got, (*want[:2], *want[3:])):
        assert torch.equal(g, w)
    assert [t.data_ptr() for t in a.state.values()] == ptrs
    for key in a.state:
        assert torch.equal(a.state[key], b.state[key])
    assert a.timings.n_eval == 2


def test_chip_smoke_near_tie_rule():
    """chip_smoke.py's rule for RWKV spec and engine tokens (rwkv_held): a
    token the plain decode's argmax, or led by at most twice the logits gate
    of the row's scale, passes; one further behind fails, and a run that
    ends early must end at a near tie of EOS.  routes_held takes the logits
    gate for the logits and the state gate for the state tensors."""
    import chip_smoke

    gate = chip_smoke.RWKV_ROUTE_GATE
    row = np.array([10.0, 10.0 - 1.9 * gate["logits"] * 10.0, -10.0, 0.0], np.float32)
    rows = [row] * 3
    ok, same, n, _ = chip_smoke.rwkv_held(rows, [0, 1])
    assert ok and same == 1 and n == 2
    assert not chip_smoke.rwkv_held(rows, [0, 3])[0]
    assert not chip_smoke.rwkv_held(rows, [0, 0], eos=2, n_predict=3)[0]
    assert chip_smoke.rwkv_held(rows, [0, 0], eos=1, n_predict=3)[0]
    assert chip_smoke.rwkv_held(rows, [0, 0, 0], eos=2, n_predict=3)[0]
    assert chip_smoke.routes_held({"logits": gate["logits"], "num": gate["state"]})
    assert not chip_smoke.routes_held({"logits": gate["state"]})
