"""The port's embd-input surface (runtime/embd_input.py) and multimodal
adapters (runtime/mm_adapters.py) against the JAX package on the CPU: the
projector, the projector checkpoints' key layouts, EmbdInput's token and
embedding calls with greedy generation, and the LLaVA, MiniGPT-4 and
PandaGPT token protocols call for call with their generated text.

The fixture is tests/test_mm_adapters.py's (2 layers, n_embd 64, 4 heads, a
256-entry vocabulary), in f32 compute with f32 caches; the encoders are stubs
that return fixed features, as there."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_q_4_0_tpu.formats.fixtures import make_llama_ggjt
from llama_cpp_q_4_0_tpu.formats.ggjt import read_ggjt as jax_read_ggjt
from llama_cpp_q_4_0_tpu.models.loading import (
    config_from_ggjt as jax_config, load_transformer as jax_load)
from llama_cpp_q_4_0_tpu.runtime import embd_input as jei
from llama_cpp_q_4_0_tpu.runtime import mm_adapters as jmm
from llama_cpp_q_4_0_tpu.runtime.context import Context as JaxContext
from llama_cpp_q_4_0_tpu.runtime.sampling import SamplingParams as JaxSP
from llama_cpp_q_4_0_tpu.runtime.tokenizer import Tokenizer as JaxTokenizer
from llama_cpp_q_4_0_tpu.runtime.tokenizer import Vocab as JaxVocab
from llama_cpp_q_4_0_tpu_torch.formats.ggjt import read_ggjt
from llama_cpp_q_4_0_tpu_torch.models.loading import config_from_ggjt, load_transformer
from llama_cpp_q_4_0_tpu_torch.runtime import embd_input as tei
from llama_cpp_q_4_0_tpu_torch.runtime import mm_adapters as tmm
from llama_cpp_q_4_0_tpu_torch.runtime.context import Context
from llama_cpp_q_4_0_tpu_torch.runtime.sampling import SamplingParams
from llama_cpp_q_4_0_tpu_torch.runtime.tokenizer import Tokenizer, Vocab

torch.set_num_threads(1)

VIS_DIM = 16


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mm") / "m.bin")
    make_llama_ggjt(path, n_vocab=256, n_embd=64, n_head=4, n_layer=2)
    gf = jax_read_ggjt(path, "llama")
    jcfg = dataclasses.replace(jax_config(gf, n_ctx=256), compute_dtype="float32")
    g2 = read_ggjt(path)
    tcfg = dataclasses.replace(config_from_ggjt(g2, n_ctx=256), compute_dtype="float32")
    return ((jcfg, jax_load(gf, jcfg), JaxTokenizer(JaxVocab.from_ggjt(gf))),
            (tcfg, load_transformer(g2, tcfg, device="cpu"), Tokenizer(Vocab.from_ggjt(g2))))


@pytest.fixture(scope="module")
def proj_weights(tmp_path_factory):
    """One synthetic nn.Linear [64 x VIS_DIM] in each of the three reference
    checkpoint layouts."""
    rng = np.random.default_rng(7)
    w = rng.standard_normal((64, VIS_DIM)).astype(np.float32) * 0.1
    b = rng.standard_normal(64).astype(np.float32) * 0.01
    d = tmp_path_factory.mktemp("proj")
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    torch.save({"model.mm_projector.weight": tw, "model.mm_projector.bias": tb},
               d / "llava.pth")
    torch.save({"model": {"llama_proj.weight": tw, "llama_proj.bias": tb}}, d / "minigpt4.pth")
    torch.save({"llama_proj.weight": tw, "llama_proj.bias": tb}, d / "panda.pth")
    return d, w, b


def _logged(ctx, log):
    """ctx with its eval and eval_embd calls recorded in log: ("tok", ids)
    and ("embd", the f32 embeddings' values)."""
    ev, ee = ctx.eval, ctx.eval_embd

    def eval_(tokens, **kw):
        log.append(("tok", np.asarray(tokens).tolist()))
        return ev(tokens, **kw)

    def eval_embd(emb, **kw):
        log.append(("embd", np.asarray(emb, np.float32).round(6).tolist()))
        return ee(emb, **kw)

    ctx.eval, ctx.eval_embd = eval_, eval_embd
    return ctx


def _pair(loaded, seed=-1, temp=-1.0):
    """(JAX EmbdInput, port EmbdInput, JAX log, port log) over fresh f32
    contexts, greedy unless temp > 0."""
    (jcfg, jp, jtok), (tcfg, tp, ttok) = loaded
    jl, tl = [], []
    jc = _logged(JaxContext(jcfg, jp, n_ctx=256, cache_dtype=jnp.float32), jl)
    tc = _logged(Context(tcfg, tp, n_ctx=256, cache_dtype=torch.float32, device="cpu"), tl)
    return (jei.EmbdInput(jc, jtok, JaxSP(temp=temp), seed=seed),
            tei.EmbdInput(tc, ttok, SamplingParams(temp=temp), seed=seed), jl, tl)


def test_linear_projector_and_checkpoint_layouts_match_jax(proj_weights):
    """LinearProjector's product, and load_torch_projector on the LLaVA,
    MiniGPT-4 and PandaGPT key layouts, equal JAX's."""
    d, w, b = proj_weights
    feats = np.random.default_rng(1).standard_normal((5, VIS_DIM)).astype(np.float32)
    np.testing.assert_array_equal(tei.LinearProjector(w, b)(feats),
                                  jei.LinearProjector(w, b)(feats))
    np.testing.assert_array_equal(tei.LinearProjector(w)(feats), jei.LinearProjector(w)(feats))
    for fname, keys, root in (("llava.pth", ("model.mm_projector.weight",
                                             "model.mm_projector.bias"), None),
                              ("minigpt4.pth", ("llama_proj.weight", "llama_proj.bias"), "model"),
                              ("panda.pth", ("llama_proj.weight", "llama_proj.bias"), None)):
        got = tmm.load_torch_projector(str(d / fname), *keys, root_key=root)
        want = jmm.load_torch_projector(str(d / fname), *keys, root_key=root)
        np.testing.assert_array_equal(got(feats), want(feats))
        np.testing.assert_allclose(got(feats), feats @ w.T + b, rtol=1e-6, atol=1e-6)


def test_embd_input_eval_float_generate_matches_jax(loaded):
    """eval_text, eval_float of projected features, eval_token, then greedy
    generate: the same calls, the same last-token logits (1e-4) and the
    same 8 tokens as JAX's EmbdInput; a generate before any eval raises."""
    ja, ta, jl, tl = _pair(loaded)
    with pytest.raises(RuntimeError, match="prime"):
        next(ta.generate(4))
    rng = np.random.default_rng(0)
    proj = rng.standard_normal((64, VIS_DIM)).astype(np.float32) * 0.1
    feats = rng.standard_normal((4, VIS_DIM)).astype(np.float32)
    for m in (ja, ta):
        m.eval_text("hi", bos=True)
        m.eval_float((feats @ proj.T)[None])
        m.eval_token(7)
    np.testing.assert_allclose(ta.ctx.logits, ja.ctx.logits, rtol=1e-4, atol=1e-4)
    want = list(ja.generate(8, eos_token=-1))
    got = list(ta.generate(8, eos_token=-1))
    assert got == want and len(got) == 8
    assert tl == jl
    # the text, 4 embedding rows, the marker, then each generated token fed back
    n_text = len(ta.tokenizer.tokenize("hi", bos=True))
    assert ta.ctx.n_past == ja.ctx.n_past == n_text + 4 + 1 + 8


def test_generate_text_stops_on_the_end_string(loaded):
    """generate_text(end=...) stops once the decoded text ends with it."""
    _, ta, _, _ = _pair(loaded)
    hash_id = next((i for i in range(256) if ta.tokenizer.detokenize([i]) == b"#"), None)
    if hash_id is None:
        pytest.skip("fixture vocab has no '#' piece")
    ta.generate = lambda n: iter([5, hash_id, hash_id, hash_id, 6, 7])
    want = ta.tokenizer.detokenize([5, hash_id, hash_id, hash_id])
    assert ta.generate_text(10, end="###") == want.decode("utf-8", errors="replace")


def _encoder(n, value):
    calls = []

    def enc(x):
        calls.append(x)
        return np.full((n, VIS_DIM), value, np.float32)

    return enc, calls


@pytest.mark.parametrize("name", ["llava", "llava_text", "minigpt4", "pandagpt"])
def test_adapter_protocols_match_jax(loaded, proj_weights, name):
    """Each front end over the port's EmbdInput makes JAX's calls in JAX's
    order (token ids, image markers, projected embedding spans, the
    PandaGPT second turn) and generates JAX's greedy text."""
    d, _, _ = proj_weights
    ja, ta, jl, tl = _pair(loaded)
    outs = []
    for mod, m in ((jmm, ja), (tmm, ta)):
        enc, calls = _encoder(3, 0.25)
        if name.startswith("llava"):
            lv = mod.Llava(m, enc, image_token_len=8, im_patch=250, im_start=251, im_end=252)
            lv.load_projection(str(d / "llava.pth"))
            out = (lv.chat("hello", n_predict=3) if name == "llava_text"
                   else lv.chat_with_image("IMG", "q", n_predict=4))
        elif name == "minigpt4":
            mg = mod.MiniGPT4(m, enc)
            mg.load_projection(str(d / "minigpt4.pth"))
            out = mg.chat_with_image("IMG", "what?", n_predict=3)
        else:
            audio, acalls = _encoder(2, 0.1)
            pg = mod.PandaGPT(m, {"image": enc, "audio": audio})
            pg.load_projection(str(d / "panda.pth"))
            out = pg.chat_with_image({"image_paths": ["a.png"], "audio_paths": ["b.wav"]},
                                     "q", n_predict=3)
            out += pg.chat("followup", n_predict=2)
            assert acalls == [["b.wav"]]
        outs.append((out, calls, m.ctx.n_past, list(m._last_tokens)))
    assert outs[1] == outs[0]
    assert tl == jl and any(kind == "embd" for kind, _ in tl) != (name == "llava_text")
