"""Perplexity (runtime/perplexity.py) against the JAX package's on the same
fixture and token stream: the host loop (f64 logsumexp) with -b equal to
and smaller than -c, and the on-device loop (f32 logsumexp) on f32 and q8
caches."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_q_4_0_tpu.formats.fixtures import make_llama_ggjt
from llama_cpp_q_4_0_tpu.formats.ggjt import read_ggjt as jax_read_ggjt
from llama_cpp_q_4_0_tpu.models.loading import (config_from_ggjt as jax_config,
                                                load_transformer as jax_load)
from llama_cpp_q_4_0_tpu.runtime import perplexity as jp
from llama_cpp_q_4_0_tpu.runtime.context import Context as JaxContext
from llama_cpp_q_4_0_tpu.runtime.tokenizer import Tokenizer as JaxTokenizer
from llama_cpp_q_4_0_tpu.runtime.tokenizer import Vocab as JaxVocab
from llama_cpp_q_4_0_tpu_torch.formats.ggjt import read_ggjt
from llama_cpp_q_4_0_tpu_torch.models.loading import config_from_ggjt, load_transformer
from llama_cpp_q_4_0_tpu_torch.runtime import perplexity as tp
from llama_cpp_q_4_0_tpu_torch.runtime.context import Context
from llama_cpp_q_4_0_tpu_torch.runtime.tokenizer import Tokenizer, Vocab

# small shapes: one intra-op thread keeps the suite's parallel workers from
# oversubscribing the cores
torch.set_num_threads(1)

N_CTX = 64
CACHES = {"f32": (torch.float32, jnp.float32), "q8": (torch.int8, jnp.int8)}


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("ppl") / "llama.ggjt")
    make_llama_ggjt(p, seed=3)
    return p


@pytest.fixture(scope="module")
def models(path):
    gf = jax_read_ggjt(path)
    jcfg = dataclasses.replace(jax_config(gf, n_ctx=N_CTX), compute_dtype="float32")
    tgf = read_ggjt(path)
    tcfg = dataclasses.replace(config_from_ggjt(tgf, n_ctx=N_CTX), compute_dtype="float32")
    return (jcfg, jax_load(gf, jcfg)), (tcfg, load_transformer(tgf, tcfg, device="cpu"))


def _contexts(models, cache="f32"):
    (jcfg, jparams), (tcfg, tparams) = models
    return (JaxContext(jcfg, jparams, n_ctx=N_CTX, cache_dtype=CACHES[cache][1]),
            Context(tcfg, tparams, n_ctx=N_CTX, cache_dtype=CACHES[cache][0], device="cpu"))


def _stream(n_chunks=3, seed=5):
    return np.random.default_rng(seed).integers(3, 512, n_chunks * N_CTX + 7)


@pytest.mark.parametrize("n_batch", [64, 32, 16])
def test_host_loop_matches_jax(models, n_batch):
    """-b 64 (one piece a chunk) and -b 32, 16 (later pieces take the
    cache-window attention at n_past > 0): |Δ ln ppl| <= 1e-5, the same
    count and chunk values."""
    jctx, tctx = _contexts(models)
    seen = []
    want = jp.perplexity(jctx, _stream(), n_ctx=N_CTX, n_batch=n_batch)
    got = tp.perplexity(tctx, _stream(), n_ctx=N_CTX, n_batch=n_batch, progress=seen.append)
    assert got.count == want.count == 3 * (N_CTX - 1 - N_CTX // 2)
    assert abs(np.log(got.ppl) - np.log(want.ppl)) <= 1e-5
    np.testing.assert_allclose(np.log(got.chunk_ppls), np.log(want.chunk_ppls), rtol=0,
                               atol=1e-5)
    assert len(seen) == 3 and seen[0].startswith("[1]")


@pytest.mark.parametrize("cache", list(CACHES))
def test_ondevice_loop_matches_jax(models, cache):
    """The on-device loop (its own cache of the Context's dtype, the f32
    logsumexp) against JAX's on the same cache type: |Δ ln ppl| <= 1e-4."""
    jctx, tctx = _contexts(models, cache)
    want = jp.perplexity_ondevice(jctx, _stream(), n_ctx=N_CTX)
    got = tp.perplexity_ondevice(tctx, _stream(), n_ctx=N_CTX)
    assert got.count == want.count
    assert abs(np.log(got.ppl) - np.log(want.ppl)) <= 1e-4
    np.testing.assert_allclose(np.log(got.chunk_ppls), np.log(want.chunk_ppls), rtol=0,
                               atol=1e-4)


def test_ondevice_equals_host_loop(models):
    """On the port alone the two loops agree to the f32-vs-f64 logsumexp
    difference (the JAX docstring's ~1e-5 in ppl): |Δ ln ppl| <= 1e-4; the
    on-device loop leaves the Context's own cache and n_past alone."""
    _, tctx = _contexts(models)
    host = tp.perplexity(tctx, _stream(), n_ctx=N_CTX, n_batch=N_CTX)
    tctx.reset()
    dev = tp.perplexity_ondevice(tctx, _stream(), n_ctx=N_CTX)
    assert abs(np.log(host.ppl) - np.log(dev.ppl)) <= 1e-4
    assert tctx.n_past == 0 and not any(c.any() for c in tctx.cache_k)


def test_perplexity_file_matches_jax(models, path, tmp_path):
    """perplexity_file tokenizes the text (BOS first) as JAX does: the same
    result on a text file."""
    text = tmp_path / "t.txt"
    text.write_text(" ".join(f"word{i % 37} and more" for i in range(120)))
    jctx, tctx = _contexts(models)
    jtok = JaxTokenizer(JaxVocab.from_ggjt(jax_read_ggjt(path)))
    ttok = Tokenizer(Vocab.from_ggjt(read_ggjt(path)))
    want = jp.perplexity_file(jctx, jtok, str(text), n_ctx=N_CTX, n_batch=32)
    got = tp.perplexity_file(tctx, ttok, str(text), n_ctx=N_CTX, n_batch=32)
    assert got.count == want.count > 0
    assert abs(np.log(got.ppl) - np.log(want.ppl)) <= 1e-5
