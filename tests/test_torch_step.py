"""The compiled step on the CPU: ``forward`` with n_past and last_index as
device tensors, ``Context.eval_embd`` and ``Context.embed`` against the JAX
package, the ``embedding`` CLI, the graph key and the launch accounting of
replays.  The graph replays themselves need the card (the ``gpu`` tests)."""

import copy
import dataclasses
import io
import os
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_q_4_0_tpu.formats.fixtures import make_llama_ggjt
from llama_cpp_q_4_0_tpu.formats.ggjt import read_ggjt as jax_read_ggjt
from llama_cpp_q_4_0_tpu.models.loading import (
    config_from_ggjt as jax_config, load_transformer as jax_load)
from llama_cpp_q_4_0_tpu.models.transformer import _embed as jax_embed
from llama_cpp_q_4_0_tpu.runtime.context import Context as JaxContext
from llama_cpp_q_4_0_tpu_torch.cli import dispatch
from llama_cpp_q_4_0_tpu_torch.formats.ggjt import read_ggjt
from llama_cpp_q_4_0_tpu_torch.models import transformer
from llama_cpp_q_4_0_tpu_torch.models.loading import (config_from_ggjt,
                                                      load_transformer)
from llama_cpp_q_4_0_tpu_torch.runtime import context as context_mod
from llama_cpp_q_4_0_tpu_torch.runtime.context import (
    SWITCHES, Context, add_launches, record_launches, step_key)
from llama_cpp_q_4_0_tpu_torch.runtime.generate import GenerateParams, generate
from llama_cpp_q_4_0_tpu_torch.runtime.sampling import SamplingParams

# small shapes: one intra-op thread keeps the suite's parallel workers from
# oversubscribing the cores
torch.set_num_threads(1)

PROMPT = [1, 5, 10, 42, 7, 9]


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    """The JAX tests' aux fixture (tests/test_aux.py): 2 layers, n_embd 64,
    4 heads, a 256-entry vocabulary, q4_0."""
    p = str(tmp_path_factory.mktemp("step") / "llama.ggjt")
    make_llama_ggjt(p, n_vocab=256, n_embd=64, n_head=4, n_layer=2)
    return p


def _jax(path, mode, n_ctx):
    gf = jax_read_ggjt(path)
    cfg = dataclasses.replace(jax_config(gf, n_ctx=n_ctx), compute_dtype=mode)
    return cfg, jax_load(gf, cfg)


def _port(path, mode, n_ctx):
    gf = read_ggjt(path)
    cfg = dataclasses.replace(config_from_ggjt(gf, n_ctx=n_ctx), compute_dtype=mode)
    return cfg, load_transformer(gf, cfg, device="cpu")


def _flat(caches):
    out = []
    for c in caches:
        out += [c] if isinstance(c, torch.Tensor) else [c.data, c.scale]
    return out


CACHES = {"f32": torch.float32, "bf16": torch.bfloat16, "q8": torch.int8}


@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("n_past,t", [(0, 7), (6, 1), (6, 5), (10, 40), (63, 1)],
                         ids=["prefill", "decode", "ragged", "clamp", "last-slot"])
def test_forward_tensor_n_past_equals_int(path, cache, n_past, t):
    """forward with n_past and last_index as 0-d int64 tensors (the graph's
    inputs) equals the int form bit for bit, logits and caches: on every
    cache type, at a decode step, a bucket-padded call (last_index), the
    last slot, and n_past 10 with 40 tokens in a 64-slot cache, whose insert
    clamps to slot 0 as JAX's dynamic_update_slice does."""
    cfg, params = _port(path, "bfloat16", 64)
    rng = np.random.default_rng(n_past + t)
    ck, cv = transformer.init_cache(cfg, 1, 64, CACHES[cache], device="cpu")
    if n_past:  # a cache that holds n_past tokens
        transformer.forward(cfg, params, torch.from_numpy(rng.integers(3, 250, (1, n_past))),
                            0, ck, cv, kv_window=64)
    ck2, cv2 = copy.deepcopy(ck), copy.deepcopy(cv)
    bt = context_mod._bucket(t)
    toks = torch.zeros((1, bt), dtype=torch.int64)
    toks[0, :t] = torch.from_numpy(rng.integers(3, 250, t))
    window = min(context_mod._bucket(n_past + t), 64)
    last = t - 1 if bt != t else None
    a = transformer.forward(cfg, params, toks, n_past, ck, cv, kv_window=window,
                            last_only=last is None, last_index=last)
    b = transformer.forward(cfg, params, toks, torch.tensor(n_past), ck2, cv2,
                            kv_window=window, last_only=last is None,
                            last_index=None if last is None else torch.tensor(last))
    assert a.shape == (1, 1, cfg.n_vocab) and torch.isfinite(a).all()
    assert torch.equal(a, b)
    for x, y in zip(_flat(ck + cv), _flat(ck2 + cv2)):
        assert torch.equal(x, y)


def test_forward_with_embedding_and_raw_input(path):
    """with_embedding returns the post-norm state beside the logits; raw
    embeddings [B, T, E] enter as x, so the model's own rows give the token
    forward's logits exactly (the same f32 rows, the same arithmetic)."""
    cfg, params = _port(path, "float32", 64)
    toks = torch.tensor([[3, 7, 11, 5]])
    caches = [transformer.init_cache(cfg, 1, 64, torch.float32, "cpu") for _ in range(2)]
    logits, x = transformer.forward(cfg, params, toks, 0, *caches[0], with_embedding=True)
    raw = transformer.forward(cfg, params, transformer._embed(params, toks), 0, *caches[1])
    assert x.shape == (1, 4, cfg.n_embd) and logits.shape == (1, 4, cfg.n_vocab)
    assert torch.equal(logits, raw)
    ms = (x * x).mean(-1)  # rms_norm with unit weights: mean square 1
    np.testing.assert_allclose(ms.numpy(), 1.0, rtol=1e-4)


def test_eval_embd_matches_token_eval(path):
    """The port of tests/test_aux.py::test_eval_embd_matches_token_eval:
    feeding the model's own embedding rows equals token eval (to 1e-5, the
    JAX test's limit: eval pads 3 tokens to bucket 8 and keeps the last row,
    eval_embd runs T = 3), and n_past advances by T."""
    cfg, params = _port(path, "bfloat16", 64)
    toks = np.asarray([[3, 7, 11]])
    ref = Context(cfg, params, n_ctx=64, cache_dtype=torch.float32, device="cpu")
    emb = transformer._embed(params, torch.from_numpy(toks)).numpy()
    ctx = Context(cfg, params, n_ctx=64, cache_dtype=torch.float32, device="cpu")
    got = ctx.eval_embd(emb)
    assert got.shape == (1, 1, cfg.n_vocab) and ctx.n_past == 3
    np.testing.assert_allclose(got[:, -1], ref.eval(toks)[:, -1], rtol=1e-5, atol=1e-5)
    # the cache it wrote: a next step as a one-row embedding, all logits
    nxt = transformer._embed(params, torch.tensor([[5]])).numpy()
    np.testing.assert_allclose(ctx.eval_embd(nxt, logits_all=True)[:, -1],
                               ref.eval([[5]])[:, -1], rtol=1e-5, atol=1e-5)
    assert ctx.n_past == ref.n_past == 4


def test_eval_embd_matches_jax(path):
    """Context.eval_embd of the same embedding rows against the JAX
    package's, in f32 compute with an f32 cache: the same arithmetic in
    another summation order, 1e-4 (test_torch_model.py's
    test_f32_mode_matches_jax), over an embedding prefill, a token step and
    an all-logits embedding step."""
    jcfg, jp = _jax(path, "float32", 64)
    tcfg, tp = _port(path, "float32", 64)
    toks = np.asarray([PROMPT])
    emb = np.asarray(jax_embed(jp, jnp.asarray(toks, jnp.int32)))
    jc = JaxContext(jcfg, jp, n_ctx=64, cache_dtype=jnp.float32)
    tc = Context(tcfg, tp, n_ctx=64, cache_dtype=torch.float32, device="cpu")
    pairs = [(jc.eval_embd(emb), tc.eval_embd(emb)),
             (jc.eval([[3]]), tc.eval([[3]])),
             (jc.eval_embd(emb[:, :2], logits_all=True),
              tc.eval_embd(emb[:, :2], logits_all=True))]
    for a, b in pairs:
        assert b.shape == a.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)
    assert tc.n_past == jc.n_past == len(PROMPT) + 3


def test_embed_matches_jax(path):
    """Context.embed against the JAX package's, f32 compute and cache, at
    test_f32_mode_matches_jax's 1e-4: the hidden state of the last real
    token, the logits of the real tokens, then a second call after n_past."""
    jcfg, jp = _jax(path, "float32", 64)
    tcfg, tp = _port(path, "float32", 64)
    jc = JaxContext(jcfg, jp, n_ctx=64, cache_dtype=jnp.float32)
    tc = Context(tcfg, tp, n_ctx=64, cache_dtype=torch.float32, device="cpu")
    for toks in (PROMPT, [4, 8]):
        want, got = jc.embed(toks), tc.embed(toks)
        assert got.shape == want.shape == (1, tcfg.n_embd)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        assert tc.logits.shape == jc.logits.shape == (1, len(toks), tcfg.n_vocab)
        np.testing.assert_allclose(tc.logits, jc.logits, rtol=0, atol=1e-4)
    assert tc.n_past == jc.n_past == len(PROMPT) + 2


def test_embedding_cli_prints_the_jax_values(path, capsys):
    """`embedding` prints what the JAX tool prints on the same fixture
    (tests/test_cli.py's test_embedding_cli): one line of n_embd values, then
    the timings report.  Both compute in bf16 with f32 sums in another
    order, so a value may move by one bf16 rounding of an activation; 1e-2
    of the unit-scale state bounds it (test_torch_model.py,
    test_prefill_equals_incremental)."""
    from llama_cpp_q_4_0_tpu.cli import embedding as jax_embedding

    args = ["-m", path, "-p", "hello world", "-c", "64"]
    assert jax_embedding.main(args) == 0
    want = capsys.readouterr().out.splitlines()
    out = io.StringIO()
    with redirect_stdout(out):
        assert dispatch(["embedding", *args, "--device", "cpu"]) == 0
    got = out.getvalue().splitlines()
    a = np.asarray([float(v) for v in want[0].split()])
    b = np.asarray([float(v) for v in got[0].split()])
    assert len(b) == len(a) == 64 and np.isfinite(b).all()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-2 * np.abs(a).max())
    assert got[1] == want[1] == "" and got[2].startswith("load time =")


# ------------------------------------------------------------- graph keys

BASE = dict(kind="eval", t=8, kv_window=64, last_only=False, slice_last=True,
            attention_fn=None, view="decode")
OTHER = dict(kind=["eval_embd", "embed"], t=[1, 512], kv_window=[8, None],
             last_only=[True], slice_last=[False], attention_fn=[
                 context_mod.flash_prefill], view=["prefill"])


@pytest.mark.parametrize("arg", list(OTHER))
def test_step_key_one_key_per_static_value(arg):
    keys = {step_key(**BASE)}
    for v in OTHER[arg]:
        keys.add(step_key(**{**BASE, arg: v}))
    assert len(keys) == 1 + len(OTHER[arg])


@pytest.mark.parametrize("switch", SWITCHES)
def test_step_key_one_key_per_switch_value(switch, monkeypatch):
    """Every switch the routing reads at call time keys the graph: unset,
    and each of two values."""
    monkeypatch.delenv(switch, raising=False)
    keys = {step_key(**BASE)}
    for v in ("0", "1"):
        monkeypatch.setenv(switch, v)
        keys.add(step_key(**BASE))
    assert len(keys) == 3


def test_context_keys_shared_across_n_past_and_t(path):
    """Calls that differ only in n_past, or in t within a bucket, share a key
    (one static-input set, one graph on the card); the window's bucket, the
    bucket and the routing switches do not."""
    cfg, params = _port(path, "bfloat16", 64)
    a = Context(cfg, params, n_ctx=64, device="cpu")
    b = Context(cfg, params, n_ctx=64, device="cpu")
    a.eval([1, 2, 3])
    b.eval([1, 2, 3, 4, 5])  # t 5: bucket 8 as t 3
    assert a.last_call.key == b.last_call.key
    keys = [a.last_call.key]
    for tok in (4, 5, 6):  # n_past 3, 4, 5: window 8, bucket 1
        a.eval([tok])
        keys.append(a.last_call.key)
    assert keys[1] == keys[2] == keys[3] != keys[0]
    a.eval([7, 8, 9])  # n_past 6 + 3 -> window 32
    assert a.last_call.key not in keys
    a.eval([10])  # n_past 9: window 32, bucket 1
    keys.append(a.last_call.key)
    assert len(a._steps) == 4
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ATTN_MXU", "1" if os.environ.get("ATTN_MXU") == "0" else "0")
        a.eval([11])  # the same shapes, another switch value
    assert a.last_call.key not in keys
    assert len(a._steps) == 5 and a.n_past == 11


# ------------------------------------------------------ launch accounting

def test_capture_adds_no_launch_and_replays_add_its_delta():
    """record_launches runs a capture and hands back what it added to each
    counter, with the counters put back; add_launches adds that delta once
    a replay."""
    counters = ({"k1": 3, "k2": 0}, {"k3": 5})

    def capture():
        counters[0]["k1"] += 2
        counters[1]["k3"] += 1
        return "graph"

    out, delta = record_launches(counters, capture)
    assert out == "graph"
    assert delta == [{"k1": 2, "k2": 0}, {"k3": 1}]
    assert counters == ({"k1": 3, "k2": 0}, {"k3": 5})
    for _ in range(3):
        add_launches(counters, delta)
    assert counters == ({"k1": 9, "k2": 0}, {"k3": 8})


def test_failed_capture_restores_the_counters():
    counters = ({"k1": 1},)

    def capture():
        counters[0]["k1"] += 4
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        record_launches(counters, capture)
    assert counters == ({"k1": 1},)


def test_context_counts_the_port_wrappers():
    from llama_cpp_q_4_0_tpu_torch.ops import flash_prefill, mha_decode, qmm

    """A replay moves the counters chip_smoke.py reads: the wrappers' own
    dicts, not copies of them."""
    assert len(context_mod.LAUNCH_COUNTERS) == 3
    assert all(a is b for a, b in zip(context_mod.LAUNCH_COUNTERS,
                                      (qmm.launches, flash_prefill.launches,
                                       mha_decode.launches)))


# ------------------------------------------------------------ on the card

@pytest.fixture(scope="module")
def path256(tmp_path_factory):
    """A q4_0 LLaMA inside the kernels' gate (n_embd 256, 2 layers), so that
    the graphs hold K1, K2 and K3."""
    p = str(tmp_path_factory.mktemp("step256") / "llama.ggjt")
    make_llama_ggjt(p, n_embd=256, n_mult=256, n_head=2)
    return p


@pytest.mark.gpu
def test_replay_equals_eager_on_card(path256):
    """Every replayed step's logits equal an eager transformer.forward of the
    same inputs on a twin cache, bit for bit, and so do the caches after a
    128-token prefill (K1, K3) and 12 decode steps (K2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gf = read_ggjt(path256)
    cfg = config_from_ggjt(gf, n_ctx=256)
    params = load_transformer(gf, cfg, device="cuda")
    ctx = Context(cfg, params, n_ctx=256, device="cuda")
    ck, cv = transformer.init_cache(cfg, 1, 256, device="cuda")
    rng = np.random.default_rng(0)
    toks = [rng.integers(3, cfg.n_vocab, 128).tolist()]
    for _ in range(12):
        got = ctx.eval([toks[-1]])
        c = ctx.last_call
        want = transformer.forward(
            cfg, c.params, torch.from_numpy(c.x).cuda(), c.n_past, ck, cv,
            last_only=c.last_only, kv_window=c.kv_window, last_index=c.last_index,
            attention_fn=c.attention_fn)
        np.testing.assert_array_equal(got, want[:, -1:].float().cpu().numpy())
        toks.append([int(np.argmax(got[0, -1]))])
    assert len(ctx.graphs()) == 2  # the prefill, then window 256 from n_past 128
    assert all(torch.equal(a, b) for a, b in zip(ctx.cache_k + ctx.cache_v, ck + cv))


@pytest.mark.gpu
def test_reset_gives_the_same_tokens_on_card(path256):
    """reset() zeroes the captured caches in place: a second generation
    replays every graph and gives the first one's greedy tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gf = read_ggjt(path256)
    cfg = config_from_ggjt(gf, n_ctx=256)
    ctx = Context(cfg, load_transformer(gf, cfg, device="cuda"), n_ctx=256, device="cuda")
    gp = GenerateParams(n_predict=16, ignore_eos=True, sampling=SamplingParams(temp=0.0))
    first = list(generate(ctx, PROMPT, gp))
    captured = len(ctx.graphs())
    ctx.reset()
    assert list(generate(ctx, PROMPT, gp)) == first and len(first) == 16
    assert len(ctx.graphs()) == captured
