"""Files of 64-element k-quant super-blocks (the reference's -DGGML_QKK_64
build) in the port against the JAX package (CPU): the planar repack and the
device layout of each 64-block type, the reader finding the build with no
hint (and failing on a corrupt file as JAX does), the fixture's bytes, the
loader's arrays, and Context logits."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_q_4_0_tpu.formats import ggjt as jax_ggjt
from llama_cpp_q_4_0_tpu.formats.fixtures import make_llama_ggjt as jax_make_llama
from llama_cpp_q_4_0_tpu.formats.quantize import QuantizeParams, quantize_model
from llama_cpp_q_4_0_tpu.models.loading import config_from_ggjt as jax_config
from llama_cpp_q_4_0_tpu.models.loading import load_transformer as jax_load
from llama_cpp_q_4_0_tpu.ops.qtensor import QTensor as JaxQTensor
from llama_cpp_q_4_0_tpu.quant import pack as jax_pack
from llama_cpp_q_4_0_tpu.quant import registry as jax_registry
from llama_cpp_q_4_0_tpu.quant import types as jax_types
from llama_cpp_q_4_0_tpu.runtime.context import Context as JaxContext
from llama_cpp_q_4_0_tpu_torch.formats.fixtures import make_llama_ggjt
from llama_cpp_q_4_0_tpu_torch.formats.ggjt import read_ggjt
from llama_cpp_q_4_0_tpu_torch.models.loading import config_from_ggjt, load_transformer
from llama_cpp_q_4_0_tpu_torch.ops import qmatmul
from llama_cpp_q_4_0_tpu_torch.ops.qtensor import QTensor
from llama_cpp_q_4_0_tpu_torch.quant.pack import pack_planar, quantize_planar
from llama_cpp_q_4_0_tpu_torch.quant.types import GGMLType
from llama_cpp_q_4_0_tpu_torch.runtime.context import Context
from test_torch_model import _to_numpy_tree, _to_numpy_tree_port

torch.set_num_threads(1)

WEIGHT_TYPES = ["Q2_K", "Q3_K", "Q4_K", "Q5_K", "Q6_K"]
PROMPT = [1, 5, 10, 42, 7, 9]


def _same(a, b, what):
    """Arrays equal bit for bit (floats compared as their raw bits)."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=what)


def _rows(n, k, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    w[1] = 0.0
    w[2, ::2], w[2, 1::2] = 0.5, -0.5
    return w


@pytest.mark.parametrize("name", WEIGHT_TYPES)
@pytest.mark.parametrize("n,k", [(16, 192), (8, 512)])
def test_pack_planar_64_equals_jax(name, n, k):
    """pack_planar(qk_k=64) gives JAX's levels, scales and biases; from_planar
    JAX's device arrays (packed where the levels span 16 values: q2_K, q3_K
    with pack zero 4, q4_K; int8 for q5_K and q6_K, q5_K with no bias) and
    quantize_planar the same planes."""
    jt = jax_types.GGMLType[name]
    w = _rows(n, k, seed=k + len(name))
    with np.errstate(all="ignore"):
        blocks = jax_registry.quantize(w, jt, 64)
        jp = jax_pack.pack_planar(blocks, jt, (n, k), qk_k=64)
        p = pack_planar(blocks, GGMLType[name], (n, k), 64)
        pq = quantize_planar(w, GGMLType[name], qk_k=64)
    assert p.gsize == jp.gsize == pq.gsize and p.shape == tuple(jp.shape)
    for field in ("levels", "gscale", "gbias"):
        a, b, c = getattr(jp, field), getattr(p, field), getattr(pq, field)
        assert (a is None) == (b is None) == (c is None), field
        if a is not None:
            _same(a, b, field)
            _same(a, c, field)
    jq = JaxQTensor.from_planar(jp)
    q = QTensor.from_planar(p, device="cpu")
    assert q.pack_zero == jq.pack_zero and q.gsize == jq.gsize
    assert q.packed == (name in ("Q2_K", "Q3_K", "Q4_K"))
    assert (q.gbias_t is None) == (name in ("Q3_K", "Q5_K", "Q6_K"))
    for field in ("levels_t", "gscale_t", "gbias_t"):
        a, b = getattr(jq, field), getattr(q, field)
        assert (a is None) == (b is None), field
        if a is not None:
            _same(np.asarray(a), b.numpy(), field)
    _same(np.asarray(jq.dequantize_t()), q.dequantize_t().numpy(), "dequantize_t")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A 128-wide llama (n_ff 384: rows of multiples of 64, not of 256) in f32
    and quantized by the JAX package's quantize_model with qk_k 64, in the
    mixes whose layers take every 64-block type; and a 256-wide Q5_K_M file
    of 64-blocks, inside the kernels' gate."""
    d = tmp_path_factory.mktemp("qkk64")
    f32 = str(d / "f32.ggjt")
    jax_make_llama(f32, n_vocab=256, n_embd=128, n_mult=64, n_head=2, n_layer=2,
                   qtype=jax_types.GGMLType.F32, seed=4)
    f32_256 = str(d / "f32_256.ggjt")
    jax_make_llama(f32_256, n_vocab=256, n_embd=256, n_mult=256, n_head=2, n_layer=2,
                   qtype=jax_types.GGMLType.F32, seed=5)
    out = {"f32": f32}
    for ft, src in (("Q2_K", f32), ("Q3_K_M", f32), ("Q4_K_M", f32), ("Q5_K_M", f32),
                    ("Q6_K", f32), ("Q5_K_M_256", f32_256)):
        out[ft] = str(d / f"{ft}.ggjt")
        lf = jax_types.LlamaFType[f"MOSTLY_{ft.removesuffix('_256')}"]
        quantize_model(src, out[ft], QuantizeParams(ftype=lf, qk_k=64),
                       progress=lambda *a: None)
    return out


MIXES = ["Q2_K", "Q3_K_M", "Q4_K_M", "Q5_K_M", "Q6_K"]


@pytest.mark.parametrize("ftype", MIXES)
def test_reader_finds_64_and_loads_jax_arrays(files, ftype):
    """read_ggjt with no hint finds qk_k 64 (JAX's entries, and dequantized
    tensors equal to JAX's bits); the loader gives every tensor JAX's packed
    levels, planes, pack zero and group size."""
    path = files[ftype]
    gf, jgf = read_ggjt(path), jax_ggjt.read_ggjt(path)
    assert gf.qk_k == jgf.qk_k == 64
    assert [(n, int(t.qtype), t.ne, t.file_off, t.size) for n, t in gf.tensors.items()] == \
        [(n, int(t.qtype), t.ne, t.file_off, t.size) for n, t in jgf.tensors.items()]
    for name in ("layers.0.attention.wq.weight", "layers.1.feed_forward.w2.weight",
                 "output.weight"):
        _same(jgf.tensor_f32(name), gf.tensor_f32(name), name)
    jp = jax_load(jgf, jax_config(jgf, n_ctx=64), fuse=False)
    tp = load_transformer(gf, config_from_ggjt(gf, n_ctx=64), device="cpu", fuse=False)
    jt, tt = _to_numpy_tree(jp), _to_numpy_tree_port(tp)
    leaves = [("tok_embeddings", jt["tok_embeddings"], tt["tok_embeddings"]),
              ("output", jt["output"], tt["output"])]
    for i, (jb, tb) in enumerate(zip(jt["blocks"], tt["blocks"])):
        leaves += [(f"{i}.{k}", jb[k], tb[k]) for k in jb if jb[k] is not None]
    for name, a, b in leaves:
        if isinstance(a, dict):
            assert a["pack_zero"] == b["pack_zero"] and a["gsize"] == b["gsize"], name
            for key in ("levels_t", "gscale_t", "gbias_t"):
                assert (a[key] is None) == (b[key] is None), (name, key)
                if a[key] is not None:
                    _same(a[key], b[key], f"{name}.{key}")
        else:
            _same(np.asarray(a, np.float32), np.asarray(b, np.float32), name)


def test_fixture_and_hint(tmp_path):
    """make_llama_ggjt(qk_k=64) writes the JAX fixture's bytes; an explicit
    hint reads the same, the wrong one raises as JAX's does."""
    a, b = str(tmp_path / "jax.ggjt"), str(tmp_path / "port.ggjt")
    jax_make_llama(a, n_vocab=64, n_embd=64, n_mult=64, qtype=jax_types.GGMLType.Q4_K,
                   qk_k=64)
    make_llama_ggjt(b, n_vocab=64, n_embd=64, n_mult=64, qtype=GGMLType.Q4_K, qk_k=64)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert read_ggjt(b, qk_k=64).tensors.keys() == read_ggjt(b).tensors.keys()
    with pytest.raises(ValueError) as je:
        jax_ggjt.read_ggjt(a, qk_k=256)
    with pytest.raises(ValueError) as pe:
        read_ggjt(b, qk_k=256)
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("damage", ["truncated", "garbage_header", "tail_byte"])
def test_corrupt_file_raises_jax_error(files, tmp_path, damage):
    """A file that parses in neither build raises JAX's error (the QK_K =
    256 one), type and message."""
    raw = bytearray(open(files["Q4_K_M"], "rb").read())
    gf = read_ggjt(files["Q4_K_M"])
    off = gf.tensors["layers.1.attention.wq.weight"].file_off
    if damage == "truncated":
        raw = raw[:-100]
    elif damage == "garbage_header":
        raw[off - 64:off] = b"\xff" * 64
    else:
        raw += b"\x00"
    path = str(tmp_path / f"{damage}.ggjt")
    with open(path, "wb") as f:
        f.write(raw)
    with pytest.raises(Exception) as je:
        jax_ggjt.read_ggjt(path)
    with pytest.raises(Exception) as pe:
        read_ggjt(path)
    assert type(pe.value).__name__ == type(je.value).__name__
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("ftype", MIXES[:4])
def test_context_f32_matches_jax(files, ftype):
    """compute_dtype float32 with an f32 cache (the 1e-4 of the JAX
    package's own QK_K = 64 end-to-end test): a prefill and three decode
    steps of the port's Context against JAX's."""
    path = files[ftype]
    jgf, gf = jax_ggjt.read_ggjt(path), read_ggjt(path)
    jcfg = dataclasses.replace(jax_config(jgf, n_ctx=64), compute_dtype="float32")
    cfg = dataclasses.replace(config_from_ggjt(gf, n_ctx=64), compute_dtype="float32")
    jctx = JaxContext(jcfg, jax_load(jgf, jcfg), n_ctx=64, cache_dtype=jnp.float32)
    ctx = Context(cfg, load_transformer(gf, cfg, device="cpu"), n_ctx=64,
                  cache_dtype=torch.float32, device="cpu")
    for toks in (PROMPT, [3], [100], [200]):
        want = np.asarray(jctx.eval(np.asarray([toks], np.int32)))
        got = ctx.eval(np.asarray([toks]))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_q5_k_64_takes_k6_with_no_bias(files, monkeypatch):
    """At QK_K = 64 q5_K is symmetric: the loader gives it int8 levels and
    no bias, so inside the kernels' gate (the 256-wide file) its matmuls take
    K6 (qmm_int8), never K6b; the bf16 logits stay within the 2e-2 of the
    k-quant files' default-mode test of the JAX package's."""
    path = files["Q5_K_M_256"]
    gf, jgf = read_ggjt(path), jax_ggjt.read_ggjt(path)
    assert gf.qk_k == 64 and gf.tensors["layers.0.attention.wq.weight"].qtype == GGMLType.Q5_K
    tp = load_transformer(gf, config_from_ggjt(gf, n_ctx=64), device="cpu")
    blk = tp.blocks[0]
    wq = blk.wq if blk.wqkv is None else blk.wqkv
    assert not wq.packed and wq.gbias_t is None and wq.gsize == 16
    calls = {"qmm_int8": 0, "qmm_int8_bias": 0}
    for name in calls:
        real = getattr(qmatmul, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(qmatmul, name, counted)
    ctx = Context(config_from_ggjt(gf, n_ctx=64), tp, n_ctx=64, device="cpu")
    jctx = JaxContext(jax_config(jgf, n_ctx=64), jax_load(jgf, jax_config(jgf, n_ctx=64)),
                      n_ctx=64)
    for toks in (PROMPT, [3]):
        got = ctx.eval(np.asarray([toks]))
        want = np.asarray(jctx.eval(np.asarray([toks], np.int32)))
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()
    assert calls["qmm_int8"] > 0 and calls["qmm_int8_bias"] == 0, calls
