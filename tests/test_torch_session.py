"""State blobs, session files (zip and GGSN v1) and the KV shift
(runtime/session.py, formats/ggsn.py) against the JAX package's on the same
fixture and inputs: blobs and files written by either package load in the
other, GGSN files written by both from one state are byte-identical, every
restore and the shift write into the cache tensors in place, and the shift
against the jitted JAX ``_shift_kv`` on identical caches."""

import dataclasses
import json
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_q_4_0_tpu.formats import ggsn as jax_ggsn
from llama_cpp_q_4_0_tpu.formats.fixtures import make_gptneox_ggjt, make_llama_ggjt
from llama_cpp_q_4_0_tpu.formats.ggjt import read_ggjt as jax_read_ggjt
from llama_cpp_q_4_0_tpu.models.config import ModelConfig as JaxConfig
from llama_cpp_q_4_0_tpu.models.loading import (config_from_ggjt as jax_config,
                                                load_transformer as jax_load)
from llama_cpp_q_4_0_tpu.ops.kvcache import QuantKV as JaxQuantKV
from llama_cpp_q_4_0_tpu.runtime import session as js
from llama_cpp_q_4_0_tpu.runtime.context import Context as JaxContext
from llama_cpp_q_4_0_tpu_torch.formats import ggsn
from llama_cpp_q_4_0_tpu_torch.formats.ggjt import read_ggjt
from llama_cpp_q_4_0_tpu_torch.models.config import ModelConfig
from llama_cpp_q_4_0_tpu_torch.models.loading import config_from_ggjt, load_transformer
from llama_cpp_q_4_0_tpu_torch.ops.kvcache import QuantKV
from llama_cpp_q_4_0_tpu_torch.runtime import session as ts
from llama_cpp_q_4_0_tpu_torch.runtime.context import Context

# small shapes: one intra-op thread keeps the suite's parallel workers from
# oversubscribing the cores
torch.set_num_threads(1)

N_CTX = 64
PROMPT = [1, 9, 27, 5, 100, 42, 7, 300]
CACHES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16),
          "f8": (torch.float8_e4m3fn, jnp.float8_e4m3fn), "q8": (torch.int8, jnp.int8)}


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("sess") / "llama.ggjt")
    make_llama_ggjt(p, n_vocab=512, n_embd=64, n_head=4, n_layer=2, seed=7)
    return p


@pytest.fixture(scope="module")
def models(path):
    """(JAX cfg, params), (port cfg, params) in compute_dtype float32."""
    gf = jax_read_ggjt(path)
    jcfg = dataclasses.replace(jax_config(gf, n_ctx=N_CTX), compute_dtype="float32")
    tgf = read_ggjt(path)
    tcfg = dataclasses.replace(config_from_ggjt(tgf, n_ctx=N_CTX), compute_dtype="float32")
    return (jcfg, jax_load(gf, jcfg)), (tcfg, load_transformer(tgf, tcfg, device="cpu")), tgf


def _jctx(models, cache="f32", n_ctx=N_CTX):
    (cfg, params), _, _ = models
    return JaxContext(cfg, params, n_ctx=n_ctx, cache_dtype=CACHES[cache][1])


def _tctx(models, cache="f32", n_ctx=N_CTX):
    _, (cfg, params), _ = models
    return Context(cfg, params, n_ctx=n_ctx, cache_dtype=CACHES[cache][0], device="cpu")


def _greedy(ctx, n=4):
    out = []
    for _ in range(n):
        out.append(int(np.argmax(np.asarray(ctx.logits)[0, -1])))
        ctx.eval(np.asarray([[out[-1]]]))
    return out


def _ptrs(ctx):
    return [t.data_ptr() for c in (*ctx.cache_k, *ctx.cache_v)
            for t in ((c.data, c.scale) if isinstance(c, QuantKV) else (c,))]


# ---------------------------------------------------------------- state blob

def test_get_state_matches_jax(models):
    """The same tokens through both packages (f32 cache): the same keys, and
    caches and logits within the f32 logits' limit of test_torch_model.py."""
    jctx, tctx = _jctx(models), _tctx(models)
    jctx.eval(np.asarray([PROMPT]))
    tctx.eval(np.asarray([PROMPT]))
    sj, st = js.get_state(jctx), ts.get_state(tctx)
    assert sorted(sj) == sorted(st) and sj["n_past"] == st["n_past"] == len(PROMPT)
    for k in sj:
        if k != "n_past":
            assert st[k].dtype == sj[k].dtype and st[k].shape == sj[k].shape, k
            np.testing.assert_allclose(st[k], sj[k], rtol=0, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_blob_loads_across_packages(models, direction):
    """A blob written by one package's state_to_bytes restores through the
    other's set_state, and the next 4 greedy tokens equal those of the
    context that wrote it."""
    if direction == "jax_to_port":
        (src, writer), (dst, reader) = (_jctx(models), js), (_tctx(models), ts)
    else:
        (src, writer), (dst, reader) = (_tctx(models), ts), (_jctx(models), js)
    src.eval(np.asarray([PROMPT]))
    blob = writer.state_to_bytes(writer.get_state(src))
    reader.set_state(dst, reader.state_from_bytes(blob))
    assert dst.n_past == len(PROMPT)
    np.testing.assert_array_equal(np.asarray(dst.logits), np.asarray(src.logits))
    assert _greedy(dst) == _greedy(src)


@pytest.mark.parametrize("cache", list(CACHES))
def test_state_roundtrip_in_place(models, cache):
    """get_state -> bytes -> set_state into a fresh port Context of each cache
    type: the same cache contents, every cache tensor (and QuantKV plane) at
    its old address, and decoding continues as the uninterrupted context."""
    a = _tctx(models, cache)
    a.eval(np.asarray([PROMPT]))
    blob = ts.state_to_bytes(ts.get_state(a))
    b = _tctx(models, cache)
    ptrs = _ptrs(b)
    ts.set_state(b, ts.state_from_bytes(blob))
    assert _ptrs(b) == ptrs
    sa, sb = ts.get_state(a), ts.get_state(b)
    for k in sa:
        np.testing.assert_array_equal(sb[k], sa[k], err_msg=k)
    assert _greedy(b) == _greedy(a)


@pytest.mark.parametrize("saved,into", [("q8", "f32"), ("f32", "q8"), ("f32", "f8")])
def test_set_state_converts_as_jax(models, saved, into):
    """A blob of one cache type into a context of another (q8 levels
    dequantized into a float cache, f32 values quantized into q8 or cast to
    e4m3): the caches equal JAX's set_state of the same blob."""
    src = _tctx(models, saved)
    src.eval(np.asarray([PROMPT]))
    state = ts.get_state(src)
    jdst, tdst = _jctx(models, into), _tctx(models, into)
    js.set_state(jdst, state)
    ts.set_state(tdst, state)
    for jc, tc in zip((*jdst.cache_k, *jdst.cache_v), (*tdst.cache_k, *tdst.cache_v)):
        if isinstance(tc, QuantKV):
            np.testing.assert_array_equal(tc.data.numpy(), np.asarray(jc.data))
            np.testing.assert_array_equal(tc.scale.numpy(), np.asarray(jc.scale))
        else:
            np.testing.assert_array_equal(tc.view(torch.uint8).numpy() if into == "f8"
                                          else tc.numpy(),
                                          np.asarray(jc).view(np.uint8) if into == "f8"
                                          else np.asarray(jc))


def test_state_size_matches_jax(models):
    jctx, tctx = _jctx(models), _tctx(models)
    jctx.eval(np.asarray([PROMPT]))
    tctx.eval(np.asarray([PROMPT]))
    assert ts.get_state_size(tctx) == js.get_state_size(jctx)


def test_recurrent_state_raises():
    class Recurrent:
        n_past = 0
        logits = None

    with pytest.raises(NotImplementedError):
        ts.get_state(Recurrent())


# ------------------------------------------------------------- session files

@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_zip_session_loads_across_packages(tmp_path, models, direction):
    """A zip session saved by one package loads in the other: the token
    list, n_past, the sampler's RNG state and the next 4 greedy tokens."""
    tokens = PROMPT
    rng = np.random.default_rng(7)
    rng.integers(0, 100)  # advance
    p = str(tmp_path / "s.bin")
    if direction == "jax_to_port":
        src, dst, save, load = _jctx(models), _tctx(models), js.save_session, ts.load_session
    else:
        src, dst, save, load = _tctx(models), _jctx(models), ts.save_session, js.load_session
    src.eval(np.asarray([tokens]))
    save(p, src, tokens, rng=rng)
    rng2 = np.random.default_rng(0)
    assert load(p, dst, rng=rng2) == tokens
    assert dst.n_past == src.n_past
    assert rng2.bit_generator.state == rng.bit_generator.state
    assert _greedy(dst) == _greedy(src)


def test_session_bad_magic(tmp_path, models):
    p = str(tmp_path / "bad.bin")
    with zipfile.ZipFile(p, "w") as z:
        z.writestr("meta.json", json.dumps({"magic": "nope", "version": 1}))
    with pytest.raises(ValueError, match="magic"):
        ts.load_session(p, _tctx(models))


def test_session_bad_version(tmp_path, models):
    p = str(tmp_path / "bad.bin")
    with zipfile.ZipFile(p, "w") as z:
        z.writestr("meta.json", json.dumps({"magic": "ggsn", "version": 2}))
    with pytest.raises(ValueError, match="version"):
        ts.load_session(p, _tctx(models))


@pytest.mark.parametrize("a,b,n", [([1, 2, 3], [1, 2, 4], 2), ([], [1], 0),
                                   ([1, 2], [1, 2, 3], 2), ([5, 6], [7], 0)])
def test_prefix_match(a, b, n):
    assert ts.session_prefix_match(a, b) == js.session_prefix_match(a, b) == n


def _shared_state(models, cache="f32"):
    """One numpy state (a port context's, after the prompt)."""
    ctx = _tctx(models, cache)
    ctx.eval(np.asarray([PROMPT]))
    return ts.get_state(ctx)


@pytest.mark.parametrize("cache", ["f32", "bf16", "q8"])
def test_ggsn_byte_identical(tmp_path, models, cache):
    """One numpy state set into both packages' contexts, saved as .ggsn by
    each: the files are byte-identical."""
    state = _shared_state(models, cache)
    tgf = models[2]
    jctx, tctx = _jctx(models, cache), _tctx(models, cache)
    js.set_state(jctx, state)
    ts.set_state(tctx, state)
    pj, pt = str(tmp_path / "j.ggsn"), str(tmp_path / "t.ggsn")
    js.save_session(pj, jctx, PROMPT, hparams=tgf.hparams, ftype=tgf.ftype)
    ts.save_session(pt, tctx, PROMPT, hparams=tgf.hparams, ftype=tgf.ftype)
    with open(pj, "rb") as f, open(pt, "rb") as g:
        assert f.read() == g.read()
    assert ggsn.is_ggsn(pt) and not ggsn.is_ggsn(str(tmp_path / "none"))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_ggsn_loads_across_packages(tmp_path, models, direction):
    """A .ggsn saved by one package loads in the other (detected by magic):
    tokens, n_past, logits and the f16-rounded caches equal the loader of the
    writing package's own file."""
    tgf = models[2]
    p = str(tmp_path / "s.ggsn")
    if direction == "jax_to_port":
        src = _jctx(models)
        src.eval(np.asarray([PROMPT]))
        js.save_session(p, src, PROMPT, hparams=tgf.hparams, ftype=tgf.ftype)
    else:
        src = _tctx(models)
        src.eval(np.asarray([PROMPT]))
        ts.save_session(p, src, PROMPT, hparams=tgf.hparams, ftype=tgf.ftype)
    jdst, tdst = _jctx(models), _tctx(models)
    assert js.load_session(p, jdst) == ts.load_session(p, tdst) == PROMPT
    assert tdst.n_past == jdst.n_past == len(PROMPT)
    np.testing.assert_array_equal(tdst.logits, np.asarray(jdst.logits))
    for jc, tc in zip((*jdst.cache_k, *jdst.cache_v), (*tdst.cache_k, *tdst.cache_v)):
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert _greedy(tdst) == _greedy(jdst)


def test_ggsn_load_in_place_and_f16_rounding(tmp_path, models):
    """Loading a .ggsn into a bf16 context writes in place, and its cache is
    the saved cache cast through f16."""
    tgf = models[2]
    src = _tctx(models, "bf16")
    src.eval(np.asarray([PROMPT]))
    p = str(tmp_path / "s.ggsn")
    ts.save_session(p, src, PROMPT, hparams=tgf.hparams, ftype=tgf.ftype)
    dst = _tctx(models, "bf16")
    ptrs = _ptrs(dst)
    ggsn.load_session_ggsn(p, dst)
    assert _ptrs(dst) == ptrs
    n = len(PROMPT)
    for a, b in zip((*src.cache_k, *src.cache_v), (*dst.cache_k, *dst.cache_v)):
        assert torch.equal(b[:, :n], a[:, :n].float().half().to(torch.bfloat16))
        assert not b[:, n:].any()


def test_ggsn_rejects_mismatched_context(tmp_path, models):
    tgf = models[2]
    src = _tctx(models)
    src.eval(np.asarray([PROMPT]))
    p = str(tmp_path / "s.ggsn")
    ts.save_session(p, src, PROMPT, hparams=tgf.hparams, ftype=tgf.ftype)
    with pytest.raises(ValueError, match="n_ctx"):
        ggsn.load_session_ggsn(p, _tctx(models, n_ctx=32))
    with pytest.raises(ValueError, match="n_ctx"):
        jax_ggsn.load_session_ggsn(p, _jctx(models, n_ctx=32))
    bad = tmp_path / "bad.ggsn"
    bad.write_bytes(b"\x00" * 64)
    with pytest.raises(ValueError, match="GGSN"):
        ggsn.load_session_ggsn(str(bad), _tctx(models))


def test_ggsn_gptneox_raises(tmp_path):
    """GGSN is LLaMA only: a GPT-NeoX context raises as in JAX."""
    p = str(tmp_path / "neox.ggjt")
    make_gptneox_ggjt(p, n_rot=8)
    gf = read_ggjt(p, "gptneox")
    cfg = config_from_ggjt(gf, n_ctx=N_CTX)
    ctx = Context(cfg, load_transformer(gf, cfg, device="cpu"), n_ctx=N_CTX,
                  cache_dtype=torch.float32, device="cpu")
    ctx.eval(np.asarray([[1, 5, 9]]))
    with pytest.raises(ValueError, match="llama-architecture only"):
        ts.save_session(str(tmp_path / "n.ggsn"), ctx, [1, 5, 9], hparams=gf.hparams,
                        ftype=gf.ftype)
    with pytest.raises(ValueError, match="hparams"):
        ts.save_session(str(tmp_path / "n.ggsn"), ctx, [1, 5, 9])


def test_mt19937_stream_matches_jax():
    assert ggsn.mt19937_stream(5489) == jax_ggsn.mt19937_stream(5489)
    assert ggsn.mt19937_stream(42) == jax_ggsn.mt19937_stream(42)


@pytest.mark.parametrize("cache", list(CACHES))
def test_load_session_in_place(tmp_path, models, cache):
    """load_session (zip) and shift_kv_cache leave every cache tensor (and
    QuantKV plane) at its address."""
    src = _tctx(models, cache)
    src.eval(np.asarray([PROMPT]))
    p = str(tmp_path / "s.bin")
    ts.save_session(p, src, PROMPT)
    dst = _tctx(models, cache)
    ptrs = _ptrs(dst)
    assert ts.load_session(p, dst) == PROMPT
    assert _ptrs(dst) == ptrs
    ts.shift_kv_cache(dst, 2, 3)
    assert _ptrs(dst) == ptrs and dst.n_past == len(PROMPT) - 3


# ----------------------------------------------------------------- KV shift

SHIFT_CFGS = {
    "llama": (lambda M: M.llama(n_vocab=64, n_embd=64, n_mult=32, n_head=4, n_layer=2,
                                n_rot=16, n_ctx=N_CTX), 4),
    "gptneox_partial": (lambda M: M.gptneox(n_vocab=64, n_embd=64, n_head=4, n_layer=2,
                                            n_rot=8, n_ctx=N_CTX), 4),
}


def _ordered_bf16(a: np.ndarray) -> np.ndarray:
    """bf16 bit patterns as integers ordered like their values (ulp steps)."""
    b = a.view(np.uint16).astype(np.int64)
    return np.where(b & 0x8000, -(b & 0x7FFF), b)


@pytest.mark.parametrize("cache", ["f32", "bf16", "q8"])
@pytest.mark.parametrize("arch", list(SHIFT_CFGS))
def test_shift_matches_jax(arch, cache):
    """shift_layer against the jitted JAX _shift_kv on identical random
    caches: f32 within 1e-6, bf16 within one ulp, q8 scales within 1e-6
    relative and levels within one, V bit-identical."""
    make, kv_heads = SHIFT_CFGS[arch]
    jcfg, tcfg = make(JaxConfig), make(ModelConfig)
    rng = np.random.default_rng(11)
    shape = (1, N_CTX, kv_heads, 16)
    k = [(rng.standard_normal(shape) * 2).astype(np.float32) for _ in range(2)]
    v = [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]
    n_keep, n_discard = 5, 17
    if cache == "q8":
        from llama_cpp_q_4_0_tpu.ops.kvcache import quantize_kv as jq

        jk = tuple(JaxQuantKV(*jq(jnp.asarray(a))) for a in k)
        jv = tuple(JaxQuantKV(*jq(jnp.asarray(a))) for a in v)
        tk = [QuantKV(torch.from_numpy(np.array(c.data)), torch.from_numpy(np.array(c.scale)))
              for c in jk]
        tv = [QuantKV(torch.from_numpy(np.array(c.data)), torch.from_numpy(np.array(c.scale)))
              for c in jv]
    else:
        tdt, jdt = CACHES[cache]
        jk = tuple(jnp.asarray(a, jdt) for a in k)
        jv = tuple(jnp.asarray(a, jdt) for a in v)
        tk = [torch.from_numpy(a).to(tdt) for a in k]
        tv = [torch.from_numpy(a).to(tdt) for a in v]
    nk, nv = js._shift_kv(jcfg, jk, jv, n_keep, n_discard)
    for layer in range(2):
        gk, gv = ts.shift_layer(tcfg, tk[layer], tv[layer], n_keep, n_discard)
        if cache == "q8":
            np.testing.assert_array_equal(gv.data.numpy(), np.asarray(nv[layer].data))
            np.testing.assert_array_equal(gv.scale.numpy(), np.asarray(nv[layer].scale))
            np.testing.assert_allclose(gk.scale.numpy(), np.asarray(nk[layer].scale),
                                       rtol=1e-6, atol=0)
            lv = np.abs(gk.data.numpy().astype(np.int32)
                        - np.asarray(nk[layer].data).astype(np.int32))
            assert lv.max() <= 1
        elif cache == "bf16":
            assert torch.equal(gv, torch.from_numpy(
                np.array(nv[layer]).view(np.int16)).view(torch.bfloat16))
            got = _ordered_bf16(gk.view(torch.int16).numpy().view(np.uint16))
            want = _ordered_bf16(np.asarray(nk[layer]))
            assert np.abs(got - want).max() <= 1
        else:
            np.testing.assert_array_equal(gv.numpy(), np.asarray(nv[layer]))
            np.testing.assert_allclose(gk.numpy(), np.asarray(nk[layer]), rtol=0, atol=1e-6)


def _pair_ulps(got: torch.Tensor, want: torch.Tensor, n_rot: int, neox: bool) -> float:
    """The largest |got - want| of a rotated K in bf16 ulps of its rotation
    pair's magnitude: a shifted slot's K was rounded to bf16 at its old
    position and rotated again, which spreads the first rounding's error
    (at most half an ulp of each component) over both components of the
    pair; with the two final roundings the difference stays within about
    1.7 ulps of the pair's magnitude, while a small component of a large
    pair may move by many of its own ulps."""
    g, w = got.float(), want.float()
    half = n_rot // 2
    if neox:
        a, b = w[..., :half], w[..., half:n_rot]
    else:
        a, b = w[..., 0:n_rot:2], w[..., 1:n_rot:2]
    mag = torch.sqrt(a * a + b * b)
    mag = torch.cat([mag, mag], dim=-1) if neox else mag.repeat_interleave(2, dim=-1)
    mag = torch.cat([mag, w[..., n_rot:].abs()], dim=-1)
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp(min=1e-30))) - 7)
    return float(((g - w).abs() / ulp).max())


@pytest.mark.parametrize("cache", ["f32", "bf16"])
def test_kv_shift_layer0_exact(models, cache):
    """tests/test_session.py's gate on the port: after a shift, layer 0's
    slots (which depend only on the input tokens) equal a from-scratch eval
    of the surviving tokens: f32 within 1e-5; bf16 V (moved, not rotated)
    within one ulp, bf16 K within two ulps of each rotation pair's magnitude
    (``_pair_ulps``).  Decoding continues with finite logits."""
    toks = [3, 5, 7, 11, 13, 17]
    n_keep, n_discard = 2, 2
    survive = toks[:n_keep] + toks[n_keep + n_discard:]
    ctx = _tctx(models, cache)
    ctx.eval(np.asarray([toks]))
    ts.shift_kv_cache(ctx, n_keep, n_discard)
    assert ctx.n_past == len(survive)
    ref = _tctx(models, cache)
    ref.eval(np.asarray([survive]))
    n = len(survive)
    (k, rk), (v, rv) = ((ctx.cache_k[0][:, :n], ref.cache_k[0][:, :n]),
                        (ctx.cache_v[0][:, :n], ref.cache_v[0][:, :n]))
    if cache == "f32":
        for a, b in ((k, rk), (v, rv)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    else:
        cfg = ctx.cfg
        assert _pair_ulps(k, rk, cfg.n_rot, cfg.rope_neox) <= 2
        got = _ordered_bf16(v.contiguous().view(torch.int16).numpy().view(np.uint16))
        want = _ordered_bf16(rv.contiguous().view(torch.int16).numpy().view(np.uint16))
        assert np.abs(got - want).max() <= 1
    out = ctx.eval(np.asarray([[19]]))
    assert np.isfinite(out).all()


def test_shift_context_matches_jax(models):
    """shift_kv_cache on a whole Context against the JAX one after the same
    prompt (f32): caches within 1e-4 and the same greedy continuation."""
    jctx, tctx = _jctx(models), _tctx(models)
    jctx.eval(np.asarray([PROMPT]))
    tctx.eval(np.asarray([PROMPT]))
    js.shift_kv_cache(jctx, 3, 2)
    ts.shift_kv_cache(tctx, 3, 2)
    assert tctx.n_past == jctx.n_past == len(PROMPT) - 2
    for jc, tc in zip((*jctx.cache_k, *jctx.cache_v), (*tctx.cache_k, *tctx.cache_v)):
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-4)
    jctx.eval(np.asarray([[19]]))
    tctx.eval(np.asarray([[19]]))
    assert _greedy(tctx) == _greedy(jctx)


@pytest.mark.gpu
def test_restore_into_captured_context_on_card(models):
    """On the card: a set_state into a Context whose step graphs are already
    captured continues bit for bit like the uninterrupted run."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA")
    _, (cfg, _), tgf = models
    a = Context(cfg, load_transformer(tgf, cfg, device="cuda"), n_ctx=N_CTX,
                cache_dtype=torch.bfloat16)
    a.eval(np.asarray([PROMPT]))
    _greedy(a, 2)
    state = ts.get_state(a)
    want = _greedy(a, 4)
    ptrs = _ptrs(a)
    ts.set_state(a, state)
    assert _ptrs(a) == ptrs and _greedy(a, 4) == want
