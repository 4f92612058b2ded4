"""The port's speculative decoding (runtime/speculative.py, runtime/device_spec.py
and the Context's verify and round graphs) against the JAX package on the
CPU: the vectorized prompt lookup draft for draft, the three loops' greedy
tokens and SpecStats exact (penalized greedy, EOS, the context's end, the
context swap), the sampled paths on their support and length, the caches
never rebound, and `main --draft`.  The replayed rounds need the card (the
``gpu`` test).

The fixture is tests/test_speculative.py's (2 layers, n_embd 64, 4 heads, a
256-entry vocabulary, n_ctx 128), in f32 compute with f32 caches, where the
two packages' greedy tokens agree (trap 2 of ROADMAP.md queue 3)."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_q_4_0_tpu.formats.fixtures import make_llama_ggjt
from llama_cpp_q_4_0_tpu.formats.ggjt import read_ggjt as jax_read_ggjt
from llama_cpp_q_4_0_tpu.models.loading import (
    config_from_ggjt as jax_config, load_transformer as jax_load)
from llama_cpp_q_4_0_tpu.runtime import device_spec as jdsp
from llama_cpp_q_4_0_tpu.runtime import speculative as jsp
from llama_cpp_q_4_0_tpu.runtime.context import Context as JaxContext
from llama_cpp_q_4_0_tpu.runtime.device_sample import DeviceSampling as JDS
from llama_cpp_q_4_0_tpu_torch.formats.ggjt import read_ggjt
from llama_cpp_q_4_0_tpu_torch.models.loading import config_from_ggjt, load_transformer
from llama_cpp_q_4_0_tpu_torch.runtime import device_spec as tdsp
from llama_cpp_q_4_0_tpu_torch.runtime import speculative as tsp
from llama_cpp_q_4_0_tpu_torch.runtime.context import Context
from llama_cpp_q_4_0_tpu_torch.runtime.device_sample import DeviceSampling as TDS
from llama_cpp_q_4_0_tpu_torch.runtime.device_sample import prng_key
from llama_cpp_q_4_0_tpu_torch.runtime.generate import GenerateParams, generate
from llama_cpp_q_4_0_tpu_torch.runtime.sampling import SamplingParams

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 256
PEN = dict(temp=-1.0, repeat_penalty=1.1, repeat_last_n=64, frequency_penalty=0.05)


def _load(path, n_ctx=128):
    gf = jax_read_ggjt(path, "llama")
    jcfg = dataclasses.replace(jax_config(gf, n_ctx=n_ctx), compute_dtype="float32")
    g2 = read_ggjt(path)
    tcfg = dataclasses.replace(config_from_ggjt(g2, n_ctx=n_ctx), compute_dtype="float32")
    return (jcfg, jax_load(gf, jcfg)), (tcfg, load_transformer(g2, tcfg, device="cpu"))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("spec") / "m.bin")
    make_llama_ggjt(p, n_vocab=V, n_embd=64, n_head=4, n_layer=2)
    return _load(p)


@pytest.fixture(scope="module")
def weak(tmp_path_factory):
    """The weak draft model of tests/test_device_spec.py (other random
    weights, one layer, n_embd 32, the same vocabulary): its q4_0 rows of
    one 32-group pair take the planar repack, as in JAX."""
    p = str(tmp_path_factory.mktemp("weak") / "w.bin")
    make_llama_ggjt(p, n_vocab=V, n_embd=32, n_head=2, n_layer=1, seed=99)
    return _load(p)


def _pair(m):
    (jcfg, jp), (tcfg, tp) = m
    return (JaxContext(jcfg, jp, cache_dtype=jnp.float32),
            Context(tcfg, tp, cache_dtype=torch.float32, device="cpu"))


def _ptrs(ctx):
    return [c.data_ptr() for c in ctx.cache_k + ctx.cache_v]


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(3, 250, n).tolist()


def _plain(m, prompt, n, ds):
    """The plain host loop's greedy tokens (runtime/generate.py) under ds's
    penalties."""
    (_, _), (tcfg, tp) = m
    sp = SamplingParams(temp=-1.0, top_k=0, repeat_penalty=ds.get("repeat_penalty", 1.0),
                        repeat_last_n=ds.get("repeat_last_n", 0),
                        frequency_penalty=ds.get("frequency_penalty", 0.0))
    ctx = Context(tcfg, tp, cache_dtype=torch.float32, device="cpu")
    return list(generate(ctx, prompt, GenerateParams(n_predict=n, sampling=sp, ignore_eos=True),
                         eos_token=-1))


def _stats_equal(a, b):
    return dataclasses.asdict(a) == dataclasses.asdict(b)


# ------------------------------------------------------------- the lookup

@pytest.mark.parametrize("k,max_ngram,min_ngram,h", [(6, 3, 1, 64), (7, 3, 1, 24),
                                                     (4, 2, 2, 32)])
def test_lookup_drafts_match_jax_and_the_host_drafter(k, max_ngram, min_ngram, h):
    """The batched lookup on random histories over a small alphabet (many
    matches), all rows in one call, against JAX's _lookup_drafts row by row
    token for token (no match: zeros; histories shorter than the n-gram and
    lengths near H exercise both of JAX's clamps), and against the port's
    PromptLookupDrafter wherever it proposes; at least 20 matches."""
    rng = np.random.default_rng(k * 100 + h)
    fn = jax.jit(lambda b, m: jdsp._lookup_drafts(b, m, k=k, max_ngram=max_ngram,
                                                  min_ngram=min_ngram))
    host = tsp.PromptLookupDrafter(tsp.SpecParams(n_draft=k, max_ngram=max_ngram,
                                                  min_ngram=min_ngram))
    ms = np.concatenate([[1, 2, h - 1, h], rng.integers(1, h + 1, 36)])
    buf = rng.integers(0, 4, (len(ms), h))
    got = tdsp._lookup_drafts(torch.from_numpy(buf), torch.from_numpy(ms), k=k,
                              max_ngram=max_ngram, min_ngram=min_ngram).numpy()
    matched = 0
    for i, m in enumerate(ms):
        want = np.asarray(fn(jnp.asarray(buf[i], jnp.int32), jnp.int32(m)))
        np.testing.assert_array_equal(got[i], want, err_msg=f"row {i}, m {m}")
        drafts = host.draft(buf[i, :m].tolist(), k)
        if drafts:
            assert got[i].tolist() == drafts
            matched += 1
        else:
            assert got[i].tolist() == [0] * k
    assert matched >= 20


@pytest.mark.parametrize("hist,k,ngram,want", [
    ([10, 11, 12, 13, 14, 10, 11, 12], 3, 3, [13, 14, 10]),
    ([5, 6, 7, 5, 6, 8, 9, 5, 6], 2, 2, [8, 9]),  # the most recent occurrence
    ([1, 2, 8, 9, 8, 9, 8], 4, 3, [9, 8, 9, 8]),  # the periodic tail
    ([1, 2, 3, 4], 4, 3, []),
    ([7], 4, 3, []),
])
def test_prompt_lookup_drafter_matches_jax(hist, k, ngram, want):
    """tests/test_speculative.py's drafter cases, port and JAX alike."""
    got = tsp.PromptLookupDrafter(tsp.SpecParams(max_ngram=ngram)).draft(hist, k)
    assert got == want == jsp.PromptLookupDrafter(jsp.SpecParams(max_ngram=ngram)).draft(
        hist, k)


# -------------------------------------------------------------- the host loop

@pytest.mark.parametrize("ds,drafter,n_draft", [
    ({"temp": -1.0}, False, 7), ({"temp": -1.0}, True, 4), (PEN, False, 7), (PEN, True, 4)],
    ids=["lookup", "self_draft", "lookup_penalized", "draft_penalized"])
def test_generate_speculative_matches_jax(models, ds, drafter, n_draft):
    """Greedy host-loop speculation (prompt lookup, or the model as its own
    draft model; with CLI-default penalties too): the tokens and SpecStats
    of JAX's generate_speculative, and the plain loop's tokens; the caches
    never rebound."""
    prompt = _prompt(17, 12)
    (jc, tc), (jd, td) = _pair(models), _pair(models)
    sj, st = jsp.SpecStats(), tsp.SpecStats()
    ptrs = _ptrs(tc)
    want = jsp.generate_speculative(
        jc, prompt, 24, sampling=JDS(**ds), spec=jsp.SpecParams(n_draft=n_draft),
        drafter=jsp.DraftModelDrafter(jd) if drafter else None, ignore_eos=True, stats=sj)
    got = tsp.generate_speculative(
        tc, prompt, 24, sampling=TDS(**ds), spec=tsp.SpecParams(n_draft=n_draft),
        drafter=tsp.DraftModelDrafter(td) if drafter else None, ignore_eos=True, stats=st)
    assert got == want and len(got) == 24 and _stats_equal(st, sj)
    assert tc.n_past == jc.n_past and _ptrs(tc) == ptrs
    if drafter and ds["temp"] < 0 and "repeat_penalty" not in ds:
        assert st.n_accepted == st.n_drafted > 0  # a perfect drafter
    assert got == _plain(models, prompt, 24, ds)


def test_generate_speculative_eos_and_context_end_match_jax(models):
    """An EOS the greedy run emits mid-verify stops both at the same token;
    a 100-token prompt in n_ctx 128 stops both at the context's end with
    the same tokens and stats."""
    prompt = _prompt(13, 8)
    jc, tc = _pair(models)
    full = tsp.generate_speculative(tc, prompt, 8, sampling=TDS(temp=-1.0), ignore_eos=True)
    for eos in (full[3], full[0]):
        jc, tc = _pair(models)
        want = jsp.generate_speculative(jc, prompt, 8, sampling=JDS(temp=-1.0), eos_token=eos)
        got = tsp.generate_speculative(tc, prompt, 8, sampling=TDS(temp=-1.0), eos_token=eos)
        assert got == want == full[:full.index(eos)]
    prompt = _prompt(7, 100)
    jc, tc = _pair(models)
    sj, st = jsp.SpecStats(), tsp.SpecStats()
    want = jsp.generate_speculative(jc, prompt, 64, sampling=JDS(temp=-1.0), ignore_eos=True,
                                    stats=sj)
    got = tsp.generate_speculative(tc, prompt, 64, sampling=TDS(temp=-1.0), ignore_eos=True,
                                   stats=st)
    assert got == want and 0 < len(got) < 64 and _stats_equal(st, sj)
    assert tc.n_past == jc.n_past <= tc.n_ctx


def test_generate_speculative_sampled_support_and_length(models):
    """temp 0.9, top-k 40: JAX's key streams are not reproduced, so the
    sampled run is held on its length and its support (every token among
    the 40 best of the verify's own logits at its position, which the
    plain forward of the emitted prefix gives)."""
    prompt = _prompt(11, 8)
    _, tc = _pair(models)
    st = tsp.SpecStats()
    got = tsp.generate_speculative(tc, prompt, 16, sampling=TDS(temp=0.9, top_k=40), seed=1,
                                   ignore_eos=True, stats=st)
    assert len(got) == 16 and st.n_tokens == 16
    _, ref = _pair(models)
    logits = ref.eval(np.asarray([prompt + got[:-1]]), logits_all=True)[0]
    for i, t in enumerate(got):
        top = np.argsort(-logits[len(prompt) - 1 + i])[:40]
        assert t in top


# ----------------------------------------------------------- the device loops

@pytest.mark.parametrize("ds,n_draft,n_steps", [({"temp": -1.0}, 5, 3), (PEN, 7, 2)],
                         ids=["greedy", "penalized"])
def test_generate_ondevice_spec_matches_jax(models, ds, n_draft, n_steps):
    """Prompt-lookup rounds on the device: JAX's tokens and SpecStats, the
    plain greedy loop's tokens, ctx.n_past alike, caches never rebound."""
    prompt = _prompt(3, 12)
    jc, tc = _pair(models)
    sj, st = jsp.SpecStats(), tsp.SpecStats()
    ptrs = _ptrs(tc)
    want = jdsp.generate_ondevice_spec(jc, prompt, 24, sampling=JDS(**ds),
                                       spec=jsp.SpecParams(n_draft=n_draft), n_steps=n_steps,
                                       ignore_eos=True, stats=sj)
    got = tdsp.generate_ondevice_spec(tc, prompt, 24, sampling=TDS(**ds),
                                      spec=tsp.SpecParams(n_draft=n_draft), n_steps=n_steps,
                                      ignore_eos=True, stats=st)
    assert got == want and len(got) == 24 and _stats_equal(st, sj) and st.n_verify >= 1
    assert tc.n_past == jc.n_past and _ptrs(tc) == ptrs
    assert got == _plain(models, prompt, 24, ds)


def test_generate_ondevice_spec_eos_end_and_swap_match_jax(models):
    """EOS mid-chunk, the context's end (no swap: stops early) and the
    infinite-text swap (n_keep 4: 120 tokens past the 128-slot context),
    each equal to JAX's tokens and stats."""
    prompt = _prompt(13, 8)
    cases = [(prompt, 10, dict(spec_n=4, n_steps=3), None, "eos"),
             (_prompt(7, 100), 64, dict(spec_n=4, n_steps=2), None, "end"),
             (_prompt(41, 100), 120, dict(spec_n=4, n_steps=2), 4, "swap")]
    for p, n, kw, n_keep, name in cases:
        jc, tc = _pair(models)
        eos = -1
        if name == "eos":
            eos = tdsp.generate_ondevice_spec(tc, p, n, sampling=TDS(temp=-1.0),
                                              ignore_eos=True)[4]
            jc, tc = _pair(models)
        sj, st = jsp.SpecStats(), tsp.SpecStats()
        common = dict(n_steps=kw["n_steps"], eos_token=eos, ignore_eos=eos < 0)
        want = jdsp.generate_ondevice_spec(jc, p, n, sampling=JDS(temp=-1.0),
                                           spec=jsp.SpecParams(n_draft=kw["spec_n"]),
                                           stats=sj, n_keep=n_keep, **common)
        got = tdsp.generate_ondevice_spec(tc, p, n, sampling=TDS(temp=-1.0),
                                          spec=tsp.SpecParams(n_draft=kw["spec_n"]),
                                          stats=st, n_keep=n_keep, **common)
        assert got == want, name
        assert _stats_equal(st, sj) and tc.n_past == jc.n_past, name
        if name == "eos":
            assert eos not in got and len(got) < n
        if name == "end":
            assert 0 < len(got) < n
        if name == "swap":
            assert len(got) == n


@pytest.mark.parametrize("draft,n_draft,n_steps", [("self", 4, 3), ("weak", 3, 2)])
def test_generate_ondevice_spec_draft_matches_jax(models, weak, draft, n_draft, n_steps):
    """Draft-model rounds on the device, the model as its own draft (every
    draft accepted) and a weak draft model (some rejected): JAX's tokens and
    SpecStats, the plain loop's tokens, both Contexts' caches never
    rebound."""
    prompt = _prompt(21, 10)
    jc, tc = _pair(models)
    jd, td = _pair(models if draft == "self" else weak)
    sj, st = jsp.SpecStats(), tsp.SpecStats()
    ptrs = _ptrs(tc) + _ptrs(td)
    want = jdsp.generate_ondevice_spec_draft(jc, jd, prompt, 20, sampling=JDS(temp=-1.0),
                                             n_draft=n_draft, n_steps=n_steps,
                                             ignore_eos=True, stats=sj)
    got = tdsp.generate_ondevice_spec_draft(tc, td, prompt, 20, sampling=TDS(temp=-1.0),
                                            n_draft=n_draft, n_steps=n_steps,
                                            ignore_eos=True, stats=st)
    assert got == want and len(got) == 20 and _stats_equal(st, sj)
    assert tc.n_past == td.n_past == jc.n_past and _ptrs(tc) + _ptrs(td) == ptrs
    if draft == "self":
        assert st.n_accepted == st.n_drafted > 0
    else:
        assert st.acceptance < 1.0
    assert got == _plain(models, prompt, 20, {})


@pytest.mark.parametrize("loop", ["lookup", "draft"])
def test_ondevice_spec_sampled_support_and_length(models, loop):
    """Sampled device loops (temp 0.9, top-k 40, penalties): n_predict
    tokens, each among the 40 best of the plain forward's logits after the
    penalties at its position (the window of the tokens before it), and a
    second run with the same seed gives the same tokens."""
    prompt = _prompt(11, 8)
    ds = TDS(temp=0.9, top_k=40, repeat_penalty=1.1, repeat_last_n=16)

    def run():
        _, tc = _pair(models)
        if loop == "lookup":
            return tdsp.generate_ondevice_spec(tc, prompt, 16, sampling=ds, seed=3,
                                               spec=tsp.SpecParams(n_draft=4), n_steps=2,
                                               ignore_eos=True)
        _, td = _pair(models)
        return tdsp.generate_ondevice_spec_draft(tc, td, prompt, 16, sampling=ds, seed=3,
                                                 n_draft=4, n_steps=2, ignore_eos=True)

    got = run()
    assert len(got) == 16 and got == run()
    _, ref = _pair(models)
    logits = ref.eval(np.asarray([prompt + got[:-1]]), logits_all=True)[0]
    from llama_cpp_q_4_0_tpu_torch.runtime.device_sample import _apply_penalties, make_recent

    seq = prompt + got
    for i, t in enumerate(got):
        at = len(prompt) - 1 + i
        row = _apply_penalties(torch.from_numpy(logits[at][None]),
                               make_recent([seq[:at + 1]], 16, V, device="cpu"), ds)[0]
        assert t in torch.topk(row, 40).indices.tolist()


def test_spec_chunk_rows_match_jax_with_a_frozen_row(models):
    """spec_chunk at B=2, one row frozen on entry, against JAX's spec_chunk
    on the same prefilled caches: emit counts of both rows, the active row's
    tokens, every history column below H (the frozen row's untouched: its
    writes go to the pad past H, JAX's are dropped), lengths, done and
    eosed equal; the port's caches keep their addresses."""
    (jcfg, jp), (tcfg, tp) = models
    p0, p1 = _prompt(5, 10), _prompt(6, 10)
    jc = JaxContext(jcfg, jp, batch=2, cache_dtype=jnp.float32)
    tc = Context(tcfg, tp, batch=2, cache_dtype=torch.float32, device="cpu")
    jc.eval(np.asarray([p0, p1]))
    tc.eval(np.asarray([p0, p1]))
    h = 128
    hist = np.zeros((2, h), np.int64)
    hist[0, :11] = p0 + [p0[2]]
    hist[1, :11] = p1 + [p1[2]]
    kw = dict(k=4, n_steps=3, ds=TDS(temp=-1.0), kv_window=32, max_ngram=3, min_ngram=1,
              eos=-1, ignore_eos=True)
    jkw = dict(kw, ds=JDS(temp=-1.0))
    want = jdsp.spec_chunk(jcfg, jc.params, jnp.asarray(hist, jnp.int32),
                           jnp.asarray([11, 11], jnp.int32), jc.cache_k, jc.cache_v,
                           jax.random.key(0), jnp.asarray([False, True]), **jkw)
    ptrs = _ptrs(tc)
    got = tc.spec_chunk(torch.from_numpy(hist), torch.tensor([11, 11]), prng_key(0, "cpu"),
                        torch.tensor([False, True]), **kw)
    g_hist, g_n, _, g_done, g_eosed, g_toks, g_ns = got
    np.testing.assert_array_equal(g_ns.numpy(), np.asarray(want[8]))
    assert (g_ns.numpy()[:, 1] == 0).all() and (g_ns.numpy()[:, 0] > 0).all()
    np.testing.assert_array_equal(g_toks.numpy()[:, 0], np.asarray(want[7])[:, 0])
    np.testing.assert_array_equal(g_hist.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(g_hist.numpy()[1], hist[1])
    np.testing.assert_array_equal(g_n.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(g_done.numpy(), np.asarray(want[5]))
    np.testing.assert_array_equal(g_eosed.numpy(), np.asarray(want[6]))
    assert _ptrs(tc) == ptrs and tc.n_past == 10  # n_past is the caller's


def test_rwkv_spec_paths_raise(tmp_path):
    """The RWKV speculative paths run (tests/test_torch_rwkv_spec.py holds
    them against JAX): generate_ondevice_spec_rwkv's greedy tokens are the
    plain decode's, and rwkv_spec_chunk writes the state it is given in
    place."""
    from llama_cpp_q_4_0_tpu_torch.formats.fixtures import make_rwkv_ggjt
    from llama_cpp_q_4_0_tpu_torch.models.loading import load_rwkv
    from llama_cpp_q_4_0_tpu_torch.runtime.context import RwkvContext

    p = str(tmp_path / "rwkv.ggjt")
    make_rwkv_ggjt(p, n_vocab=V, n_layer=2)
    gf = read_ggjt(p, "rwkv")
    cfg = config_from_ggjt(gf)
    params = load_rwkv(gf, cfg, device="cpu")
    prompt = [7, 9, 23, 7, 9, 23, 7, 9]
    greedy = SamplingParams(temp=-1.0, top_k=0, repeat_penalty=1.0, repeat_last_n=0)
    want = list(generate(RwkvContext(cfg, params, device="cpu"), prompt,
                         GenerateParams(n_predict=12, sampling=greedy, ignore_eos=True),
                         eos_token=-1))
    got = tdsp.generate_ondevice_spec_rwkv(RwkvContext(cfg, params, device="cpu"), prompt, 12,
                                           spec=tsp.SpecParams(n_draft=3), n_steps=2,
                                           ignore_eos=True)
    assert got == want
    ctx = RwkvContext(cfg, params, device="cpu")
    ctx.eval(np.asarray([prompt[:-1]]))
    ptrs = [t.data_ptr() for t in ctx.state.values()]
    hist = torch.zeros((1, 32), dtype=torch.int64)
    hist[0, :len(prompt)] = torch.tensor(prompt)
    out = tdsp.rwkv_spec_chunk(cfg, ctx.params, hist, torch.tensor([len(prompt)]),
                               ctx.state, prng_key(0, "cpu"), torch.tensor([False]), k=3,
                               n_steps=2, ds=TDS(temp=-1.0), max_ngram=3, min_ngram=1,
                               eos=2, ignore_eos=True)
    assert out[2] is ctx.state and [t.data_ptr() for t in ctx.state.values()] == ptrs
    assert out[1].item() == len(prompt) + int(out[7].sum()) and out[7].min() >= 1


# ------------------------------------------------------------------ the CLI

@pytest.fixture(scope="module")
def cli_model(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("speccli") / "llama.ggjt")
    make_llama_ggjt(p)
    return p


@pytest.mark.parametrize("extra", [
    ["--draft", "7"],
    ["--draft", "7", "--ondevice-sampling"],
    ["--draft", "3", "--draft-model", "SELF"],
    ["--draft", "3", "--draft-model", "SELF", "--ondevice-sampling"],
], ids=["host", "ondevice", "host_draft_model", "ondevice_draft_model"])
def test_main_draft_prints_the_jax_text(cli_model, extra, capsysbinary):
    """`main --draft` in each of the JAX main's three loops (and the host
    loop with a draft model), greedy, 4 tokens, an f32 cache: the JAX
    main's stdout, and the stats line on stderr."""
    import llama_cpp_q_4_0_tpu.cli.main as jax_main

    extra = [cli_model if a == "SELF" else a for a in extra]
    args = ["-m", cli_model, "-p", "hello", "-n", "4", "-c", "64", "-s", "1",
            "--temp", "-1", "--ignore-eos", "--memory-f32", *extra]
    assert jax_main.main(args) == 0
    want = capsysbinary.readouterr().out
    r = subprocess.run([sys.executable, "-m", "llama_cpp_q_4_0_tpu_torch", "main", *args,
                        "--device", "cpu"], capture_output=True, cwd=ROOT, timeout=300,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout == want and len(r.stdout) > len(b"hello")
    assert b"speculative: " in r.stderr and b"drafts accepted" in r.stderr


# ------------------------------------------------------------- on the card

@pytest.mark.gpu
def test_spec_rounds_replay_equal_eager_on_card(tmp_path):
    """spec_chunk and draft_spec_chunk on the card (replays of one captured
    round) against the eager loops on twin caches: tokens, histories and
    caches bit for bit, addresses unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = str(tmp_path / "llama.ggjt")
    make_llama_ggjt(p, n_embd=256, n_mult=256, n_head=2)
    gf = read_ggjt(p)
    cfg = config_from_ggjt(gf, n_ctx=256)
    params = load_transformer(gf, cfg, device="cuda")
    ctx = Context(cfg, params, n_ctx=256, device="cuda")
    prompt = [1, 5, 10, 42, 7, 9, 5, 10, 42]
    ctx.eval([prompt])
    ck = [c.clone() for c in ctx.cache_k]
    cv = [c.clone() for c in ctx.cache_v]
    ptrs = _ptrs(ctx)
    hist = torch.zeros((1, 256), dtype=torch.int64, device="cuda")
    hist[0, :10] = torch.tensor(prompt + [7])
    kw = dict(k=7, n_steps=4, ds=TDS(temp=-1.0), kv_window=64, max_ngram=3, min_ngram=1,
              eos=-1, ignore_eos=True)
    n = torch.tensor([10], device="cuda")
    done = torch.zeros(1, dtype=torch.bool, device="cuda")
    for _ in range(2):  # the capture, then replays only
        got = ctx.spec_chunk(hist, n, prng_key(0, "cuda"), done, **kw)
        want = tdsp.spec_chunk(cfg, ctx.params, hist, n, ck, cv, prng_key(0, "cuda"), done, **kw)
        assert torch.equal(got[5], want[7]) and torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(ctx.cache_k + ctx.cache_v, ck + cv))
    assert _ptrs(ctx) == ptrs
