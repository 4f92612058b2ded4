"""2-byte scale planes: the port's cast and fold maps, its plain kernel
versions on f16 and bf16 planes, and its Context's two views under
QMM_F16_SCALES and QMM_ZERO_FOLD, against the JAX package's (CPU)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_q_4_0_tpu.formats.fixtures import make_llama_ggjt
from llama_cpp_q_4_0_tpu.formats.ggjt import read_ggjt as jax_read_ggjt
from llama_cpp_q_4_0_tpu.models.loading import (
    config_from_ggjt as jax_config, load_transformer as jax_load)
from llama_cpp_q_4_0_tpu.ops import qtensor as jqt
from llama_cpp_q_4_0_tpu.ops.pallas.qmm import qmm as jax_qmm
from llama_cpp_q_4_0_tpu.ops.pallas.qmm import qmm_packed as jax_qmm_packed
from llama_cpp_q_4_0_tpu.ops.pallas.qmm import qmm_packed_q8x as jax_q8x
from llama_cpp_q_4_0_tpu.quant.types import GGMLType as JaxGGMLType
from llama_cpp_q_4_0_tpu.runtime.context import Context as JaxContext
from llama_cpp_q_4_0_tpu_torch.convert import params_from_numpy
from llama_cpp_q_4_0_tpu_torch.formats.ggjt import read_ggjt
from llama_cpp_q_4_0_tpu_torch.models import transformer
from llama_cpp_q_4_0_tpu_torch.models.loading import config_from_ggjt, load_transformer
from llama_cpp_q_4_0_tpu_torch.ops import qmatmul, qmm
from llama_cpp_q_4_0_tpu_torch.ops import qtensor as pqt
from llama_cpp_q_4_0_tpu_torch.ops.qtensor import QTensor
from llama_cpp_q_4_0_tpu_torch.quant.types import GGMLType
from llama_cpp_q_4_0_tpu_torch.runtime.context import Context

# small shapes: one intra-op thread keeps the suite's parallel workers from
# oversubscribing the cores
torch.set_num_threads(1)

N, K = 256, 512
QTYPES = ["Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0", "Q2_K", "Q3_K", "Q4_K", "Q5_K", "Q6_K"]
EXACT = {"Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0"}


def _w(seed, n=N, k=K):
    return (np.random.default_rng(seed).standard_normal((n, k)) * 0.05).astype(np.float32)


def _x(b, k, seed):
    return (np.random.default_rng(seed).standard_normal((b, k)) * 0.5).astype(np.float32)


def _both(qtype, seed=0, n=N, k=K):
    """The same weight quantized by both packages (byte-identical layouts)."""
    w = _w(seed, n, k)
    return (jqt.QTensor.quantize(w, JaxGGMLType[qtype]),
            QTensor.quantize(w, GGMLType[qtype], device="cpu"))


def _bits(a):
    """A plane's bytes as uint16 (2-byte planes) or uint32 (f32), numpy."""
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16) if a.element_size() == 2 else a.view(torch.int32)).numpy()
    else:
        a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _same_planes(jt, pt):
    assert jt.pack_zero == pt.pack_zero
    assert str(np.asarray(jt.gscale_t).dtype) == str(pt.gscale_t.dtype).split(".")[1]
    np.testing.assert_array_equal(_bits(pt.gscale_t), _bits(jt.gscale_t))
    assert (jt.gbias_t is None) == (pt.gbias_t is None)
    if pt.gbias_t is not None:
        np.testing.assert_array_equal(_bits(pt.gbias_t), _bits(jt.gbias_t))


@pytest.mark.parametrize("qtype", QTYPES)
@pytest.mark.parametrize("fn", ["cast_scales_f16", "cast_scales_bf16", "fold_zero_points",
                                "cast_then_fold"])
def test_maps_give_the_jax_plane_bytes(qtype, fn):
    """Each map gives the JAX map's plane bytes bit for bit (f16 only for the
    exact formats, bf16 for every f32-plane tensor, the fold only for a
    packed tensor with a pack zero and no bias), and the port's tensors share
    the levels (and the planes the map leaves) with their input."""
    jt, pt = _both(qtype, seed=len(qtype) + len(fn))
    if fn == "cast_then_fold":
        jo = jqt.fold_zero_points(jqt.cast_scales_f16({"w": jt}))["w"]
        po = pqt.fold_zero_points(pqt.cast_scales_f16(pt))
    else:
        jo = getattr(jqt, fn)({"w": jt})["w"]
        po = getattr(pqt, fn)(pt)
    _same_planes(jo, po)
    assert po.levels_t is pt.levels_t
    if fn == "cast_scales_f16":
        want = torch.float16 if qtype in EXACT else torch.float32
        assert po.gscale_t.dtype == want
        if qtype not in EXACT:
            assert po is pt
        else:  # exact: the f16 values are the f32 ones
            assert torch.equal(po.gscale_t.float(), pt.gscale_t)
    if fn == "fold_zero_points":
        folded = pt.packed and pt.pack_zero and pt.gbias_t is None
        assert (po is pt) == (not folded)
        if folded:
            assert po.pack_zero == 0 and po.gscale_t is pt.gscale_t
            assert torch.equal(po.dequantize_t(), pt.dequantize_t())


def test_fold_zero_method_matches_jax():
    jt, pt = _both("Q4_0", seed=3)
    _same_planes(jt.fold_zero(), pt.fold_zero())
    _same_planes(jt.scales_f16().fold_zero(), pt.scales_f16().fold_zero())
    h = pt.scales_f16()
    assert h.scales_f16() is h


def _small_params(qtype="Q4_0"):
    """A TransformerParams of QTensors and dense leaves (no forward)."""
    w = {f: QTensor.quantize(_w(i), GGMLType[qtype], device="cpu")
         for i, f in enumerate(("wqkv", "wo", "w_gateup", "w_down"))}
    blk = transformer.Block(attn_norm_w=torch.ones(K), ffn_norm_w=torch.ones(K), **w)
    return transformer.TransformerParams(
        tok_embeddings=QTensor.quantize(_w(9), GGMLType[qtype], device="cpu"),
        blocks=(blk, blk), out_norm_w=torch.ones(K), out_norm_b=None,
        output=QTensor.quantize(_w(10), GGMLType[qtype], device="cpu"))


@pytest.mark.parametrize("value,cast", [("1", True), ("0", False), ("", False),
                                        ("true", False), (None, False)])
def test_switches_opt_in_only_at_1(monkeypatch, value, cast):
    """QMM_F16_SCALES and QMM_ZERO_FOLD act at "1" only (the JAX parsing);
    the maps walk TransformerParams, keep dense leaves, and share levels."""
    params = _small_params()
    for name in ("QMM_F16_SCALES", "QMM_ZERO_FOLD"):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    c = pqt.maybe_cast_scales_f16(params)
    f = pqt.maybe_fold_zero_points(params)
    if not cast:
        assert c is params and f is params
        return
    assert isinstance(c, transformer.TransformerParams) and len(c.blocks) == 2
    assert c.blocks[0].wqkv.gscale_t.dtype == torch.float16
    assert c.tok_embeddings.gscale_t.dtype == torch.float16
    assert c.blocks[0].attn_norm_w is params.blocks[0].attn_norm_w
    assert c.output.levels_t is params.output.levels_t
    assert f.blocks[1].w_down.pack_zero == 0 and f.blocks[1].w_down.gbias_t is not None
    assert f.blocks[1].w_down.gscale_t is params.blocks[1].w_down.gscale_t


@pytest.mark.parametrize("qtype", QTYPES)
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_qtensor_readers_widen_exactly(qtype, dtype):
    """levels_full, gscale_full, gbias_full, dequantize_t and rows on 2-byte
    planes equal the same readers on f32 planes holding the same values."""
    _, pt = _both(qtype, seed=5)
    h = dataclasses.replace(pt, gscale_t=pt.gscale_t.to(dtype), gbias_t=None
                            if pt.gbias_t is None else pt.gbias_t.to(dtype))
    f = dataclasses.replace(h, gscale_t=h.gscale_t.float(), gbias_t=None
                            if h.gbias_t is None else h.gbias_t.float())
    assert h.gscale_full().dtype == torch.float32
    assert torch.equal(h.gscale_full(), f.gscale_full())
    if h.gbias_t is not None:
        assert torch.equal(h.gbias_full(), f.gbias_full())
    assert torch.equal(h.dequantize_t(), f.dequantize_t())
    idx = torch.tensor([[0, 7], [255, 3]])
    assert torch.equal(h.rows(idx), f.rows(idx))
    assert h.to("cpu").gscale_t.dtype == dtype


# ---------------------------------------------------------------- kernels
def _np_planes(t):
    """A JAX plane as numpy f32 (its exact values) plus its dtype name."""
    a = np.asarray(t)
    return a.astype(np.float32), str(a.dtype)


def _torch_plane(a32, dtype):
    return torch.from_numpy(a32).to(getattr(torch, dtype))


def _cases(qtype, dtype, fold=False, n=N, k=K):
    """(JAX QTensor, port levels, port planes, f32 twins) of one weight with
    dtype planes: cast (and folded) by the JAX maps, carried over exactly."""
    jt, _ = _both(qtype, seed=11, n=n, k=k)
    jt = (jqt.cast_scales_f16 if dtype == "float16" else jqt.cast_scales_bf16)({"w": jt})["w"]
    if fold:
        jt = jqt.fold_zero_points({"w": jt})["w"]
    s32, sdt = _np_planes(jt.gscale_t)
    assert sdt == dtype
    planes = [_torch_plane(s32, dtype)]
    if jt.gbias_t is not None:
        planes.append(_torch_plane(_np_planes(jt.gbias_t)[0], dtype))
    return jt, torch.from_numpy(np.array(jt.levels_t)), planes, [p.float() for p in planes]


# (B): K1 above 32 rows, K2 at 32 or fewer, as the dispatch sends them
@pytest.mark.parametrize("b", [1, 8, 33])
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_k1_k2_on_q4_0_match_pallas_interpret(b, dtype):
    """K1 (b=33) and K2 (b=1, 8) on q4_0 with 2-byte planes against the JAX
    kernels in interpret mode with the same planes: the same bf16-rounded
    products, only f32 summation order differs (2e-6 of the output scale,
    the f32-plane tests' limit); the port's plain version on 2-byte planes
    equals it on f32 planes of the same values bit for bit."""
    kfold = b <= 32
    jt, lv, planes, planes32 = _cases("Q4_0", dtype)
    x = _x(b, K, seed=b)
    want = np.asarray(jax_qmm_packed(
        jnp.asarray(x), jt.levels_t, jt.gscale_t, None, gsize=32, zero=8, block_n=128,
        block_k=lv.shape[0], kfold=kfold, interpret=True))
    plain = qmm.qmm_packed_kfold_plain if kfold else qmm.qmm_packed_plain
    xt = torch.from_numpy(x)
    got = plain(xt, lv, *planes)
    assert torch.equal(got, plain(xt, lv, *planes32))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6 * np.abs(want).max())
    wrapper = qmm.qmm_packed_kfold if kfold else qmm.qmm_packed
    assert torch.equal(wrapper(xt, lv, *planes), got)


@pytest.mark.parametrize("b", [1, 8, 33])
@pytest.mark.parametrize("qtype,dtype,fold", [("Q4_0", "float16", True),
                                              ("Q4_1", "float16", False),
                                              ("Q4_K", "bfloat16", False),
                                              ("Q2_K", "bfloat16", False)])
def test_k5_matches_pallas_interpret(b, qtype, dtype, fold):
    """K5 on the folded q4_0 (pack zero 0, an f16 bias plane -8 d), q4_1 on
    f16 planes and q4_K / q2_K on bf16 planes, against _qmm_packed_bias_kernel
    in interpret mode: 2e-6 of the output scale (summation order)."""
    jt, lv, planes, planes32 = _cases(qtype, dtype, fold)
    x = _x(b, K, seed=b + 1)
    want = np.asarray(jax_qmm_packed(
        jnp.asarray(x), jt.levels_t, jt.gscale_t, jt.gbias_t, gsize=jt.gsize,
        zero=jt.pack_zero, block_n=128, block_k=lv.shape[0], interpret=True))
    xt = torch.from_numpy(x)
    kw = {"zero": jt.pack_zero, "gsize": jt.gsize}
    got = qmm.qmm_packed_bias_plain(xt, lv, *planes, **kw)
    assert torch.equal(got, qmm.qmm_packed_bias_plain(xt, lv, *planes32, **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6 * np.abs(want).max())
    assert torch.equal(qmm.qmm_packed_bias(xt, lv, *planes, **kw), got)


@pytest.mark.parametrize("b", [1, 8, 33])
@pytest.mark.parametrize("qtype,dtype", [("Q8_0", "float16"), ("Q5_0", "float16"),
                                         ("Q5_1", "float16"), ("Q6_K", "bfloat16"),
                                         ("Q5_K", "bfloat16")])
def test_k6_k6b_match_pallas_interpret(b, qtype, dtype):
    """K6 (q8_0, q5_0 on f16 planes, q6_K on bf16) and K6b (q5_1 on f16, q5_K
    on bf16) against _qmm_kernel / _qmm_bias_kernel in interpret mode, 2e-6
    of the output scale (summation order)."""
    jt, lv, planes, planes32 = _cases(qtype, dtype)
    x = _x(b, K, seed=b + 2)
    want = np.asarray(jax_qmm(jnp.asarray(x), jt.levels_t, jt.gscale_t, jt.gbias_t,
                              gsize=jt.gsize, block_n=N, block_k=K, interpret=True))
    xt = torch.from_numpy(x)
    plain = qmm.qmm_int8_bias_plain if len(planes) == 2 else qmm.qmm_int8_plain
    wrapper = qmm.qmm_int8_bias if len(planes) == 2 else qmm.qmm_int8
    got = plain(xt, lv, *planes, gsize=jt.gsize)
    assert torch.equal(got, plain(xt, lv, *planes32, gsize=jt.gsize))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6 * np.abs(want).max())
    assert torch.equal(wrapper(xt, lv, *planes, gsize=jt.gsize), got)


@pytest.mark.parametrize("b", [1, 8, 33])
@pytest.mark.parametrize("qtype,dtype", [("Q4_0", "float16"), ("Q3_K", "bfloat16")])
def test_k7_matches_pallas_interpret(b, qtype, dtype):
    """K7 on q4_0 with f16 planes and q3_K with bf16 planes against the JAX
    kernel in interpret mode (int8_mxu, as the existing K7 test): exact
    integer dots, f32 order only (2e-5 relative and absolute, that test's)."""
    jt, lv, planes, planes32 = _cases(qtype, dtype, n=N, k=1024)
    x = _x(b, 1024, seed=b + 3)
    want = np.asarray(jax_q8x(jnp.asarray(x), jt.levels_t, jt.gscale_t, gsize=jt.gsize,
                              zero=jt.pack_zero, block_n=128, block_k=256,
                              int8_mxu=True, interpret=True))
    xt = torch.from_numpy(x)
    kw = {"zero": jt.pack_zero, "gsize": jt.gsize}
    got = qmm.qmm_packed_q8x_plain(xt, lv, *planes, **kw)
    assert torch.equal(got, qmm.qmm_packed_q8x_plain(xt, lv, *planes32, **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    assert torch.equal(qmm.qmm_packed_q8x(xt, lv, *planes, **kw), got)


def test_check_takes_one_plane_dtype():
    _, lv, planes, planes32 = _cases("Q4_1", "float16")
    x = torch.from_numpy(_x(2, K, seed=0))
    kw = {"zero": 0, "gsize": 32}
    with pytest.raises(TypeError):  # mixed plane dtypes
        qmm.qmm_packed_bias(x, lv, planes[0], planes32[1], **kw)
    with pytest.raises(TypeError):  # no f64 planes
        qmm.qmm_packed_bias(x, lv, planes[0].double(), planes[1].double(), **kw)
    assert qmm.SCALE_CODES == {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


@pytest.mark.parametrize("b,route", [(1, "qmm_packed_bias"), (64, "qmm_packed_bias")])
def test_folded_q4_0_routes_to_k5(monkeypatch, b, route):
    """A folded q4_0 (pack zero 0 with a bias plane) goes to K5 at every row
    count: use_kfold refuses a biased tensor, as in JAX; the f16 q4_0 keeps
    K2 / K1."""
    _, pt = _both("Q4_0", seed=2)
    folded = pqt.fold_zero_points(pqt.cast_scales_f16(pt))
    calls = []
    for name in ("qmm_packed", "qmm_packed_kfold", "qmm_packed_bias"):
        orig = getattr(qmatmul, name)
        monkeypatch.setattr(qmatmul, name, lambda *a, _n=name, _o=orig, **kw:
                            calls.append(_n) or _o(*a, **kw))
    x = torch.from_numpy(_x(b, K, seed=4))
    qmatmul.q_matmul(x, folded)
    qmatmul.q_matmul(x, pqt.cast_scales_f16(pt))
    assert calls == [route, "qmm_packed_kfold" if b <= 32 else "qmm_packed"]
    f32 = qmatmul.q_matmul(x, folded, compute_dtype=torch.float32)
    assert torch.equal(f32, qmatmul.dequant_matmul(x, folded))


# ---------------------------------------------------------------- Context
PROMPT = [1, 5, 10, 42, 7, 9]


@pytest.fixture(scope="module")
def path256(tmp_path_factory):
    """A q4_0 LLaMA inside the kernels' gate (n_embd 256, n_ff 768)."""
    p = str(tmp_path_factory.mktemp("m256") / "llama.ggjt")
    make_llama_ggjt(p, n_embd=256, n_mult=256, n_head=2)
    return p


def _jax(path, mode):
    gf = jax_read_ggjt(path)
    cfg = dataclasses.replace(jax_config(gf, n_ctx=128), compute_dtype=mode)
    return cfg, jax_load(gf, cfg)


def _port(path, mode):
    gf = read_ggjt(path)
    cfg = dataclasses.replace(config_from_ggjt(gf, n_ctx=128), compute_dtype=mode)
    return cfg, load_transformer(gf, cfg, device="cpu")


def _greedy(ctx, n):
    toks, logits = [], [ctx.eval(np.asarray([PROMPT]))]
    for _ in range(n):
        toks.append(int(np.argmax(logits[-1][0, -1])))
        logits.append(ctx.eval(np.asarray([[toks[-1]]])))
    return toks, logits


@pytest.mark.parametrize("mode", ["bfloat16", "float32"])
def test_f16_scales_context_is_bit_identical(monkeypatch, path256, mode):
    """QMM_F16_SCALES=1: the Context's planes are f16, and its greedy tokens
    and logits equal the f32-plane Context's bit for bit (the file's d are
    fp16 values); in f32 mode they match the JAX Context under the same
    switch within the f32 gate (1e-4, test_torch_model)."""
    cfg, params = _port(path256, mode)
    ref_toks, ref = _greedy(Context(cfg, params, n_ctx=128, device="cpu",
                                    cache_dtype=torch.float32), 6)
    monkeypatch.setenv("QMM_F16_SCALES", "1")
    ctx = Context(cfg, params, n_ctx=128, device="cpu", cache_dtype=torch.float32)
    assert ctx.params.blocks[0].wqkv.gscale_t.dtype == torch.float16
    assert ctx.params is ctx._params_prefill
    toks, got = _greedy(ctx, 6)
    assert toks == ref_toks
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b, a)
    if mode == "float32":
        jcfg, jp = _jax(path256, mode)
        jctx = JaxContext(jcfg, jp, n_ctx=128, cache_dtype=jnp.float32)
        assert np.asarray(jctx.params.blocks[0].wqkv.gscale_t).dtype == np.float16
        jtoks, jl = _greedy(jctx, 6)
        assert jtoks == toks
        for a, b in zip(jl, got):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)


@pytest.mark.parametrize("switches", [{"QMM_ZERO_FOLD": "1"},
                                      {"QMM_ZERO_FOLD": "1", "QMM_F16_SCALES": "1"}],
                         ids=["fold", "fold+f16"])
def test_zero_fold_context_views(monkeypatch, path256, switches):
    """QMM_ZERO_FOLD=1 (alone and with QMM_F16_SCALES=1): a decode step's
    forward gets the folded view (pack zero 0, a bias plane; K5 runs), a
    33-token prompt (bucket 64) the raw one (K1); the two views share levels
    and scale planes.  Logits match the JAX Context under the same switches
    within the bf16 gate (3e-2 of the logits' scale, test_torch_model)."""
    for k, v in switches.items():
        monkeypatch.setenv(k, v)
    cfg, params = _port(path256, "bfloat16")
    ctx = Context(cfg, params, n_ctx=128, device="cpu")
    raw, folded = ctx._params_prefill.blocks[0].wqkv, ctx.params.blocks[0].wqkv
    assert raw.pack_zero == 8 and raw.gbias_t is None
    assert folded.pack_zero == 0 and folded.gbias_t is not None
    assert folded.levels_t is raw.levels_t and folded.gscale_t is raw.gscale_t
    want_dtype = torch.float16 if "QMM_F16_SCALES" in switches else torch.float32
    assert folded.gbias_t.dtype == raw.gscale_t.dtype == want_dtype

    seen = []
    orig = transformer.forward
    monkeypatch.setattr(transformer, "forward",
                        lambda c, p, *a, **kw: seen.append(p) or orig(c, p, *a, **kw))
    routes = []
    for name in ("qmm_packed", "qmm_packed_kfold", "qmm_packed_bias"):
        fn = getattr(qmatmul, name)
        monkeypatch.setattr(qmatmul, name, lambda *a, _n=name, _o=fn, **kw:
                            routes.append(_n) or _o(*a, **kw))
    prompt33 = (PROMPT * 6)[:33]
    got = [ctx.eval(np.asarray([prompt33])), ctx.eval(np.asarray([[3]]))]
    assert seen == [ctx._params_prefill, ctx.params]
    n_mm = 4 * cfg.n_layer + 1
    # the prefill: K1 for the 64-row layer matmuls, K2 for the head's last row
    assert routes[:n_mm] == (["qmm_packed"] * (n_mm - 1) + ["qmm_packed_kfold"])
    assert routes[n_mm:] == ["qmm_packed_bias"] * n_mm

    jcfg, jp = _jax(path256, "bfloat16")
    jctx = JaxContext(jcfg, jp, n_ctx=128)
    want = [jctx.eval(np.asarray([prompt33])), jctx.eval(np.asarray([[3]]))]
    for a, b in zip(want, got):
        assert np.isfinite(b).all()
        assert np.abs(b - a).max() <= 3e-2 * np.abs(a).max()


def _to_numpy_tree(params):
    """JAX params as the numpy tree params_from_numpy takes."""
    def leaf(v):
        if v is None:
            return None
        if isinstance(v, jqt.QTensor):
            return {"levels_t": np.asarray(v.levels_t), "gscale_t": np.asarray(v.gscale_t),
                    "gbias_t": None if v.gbias_t is None else np.asarray(v.gbias_t),
                    "gsize": v.gsize, "qtype": int(v.qtype), "shape": tuple(v.shape),
                    "pack_zero": v.pack_zero}
        return np.asarray(v)

    return {"tok_embeddings": leaf(params.tok_embeddings),
            "blocks": [{f.name: leaf(getattr(b, f.name)) for f in dataclasses.fields(b)}
                       for b in params.blocks],
            "out_norm_w": leaf(params.out_norm_w), "out_norm_b": leaf(params.out_norm_b),
            "output": leaf(params.output)}


def test_params_from_numpy_keeps_f16_planes(path256):
    """JAX params after cast_scales_f16, handed over as numpy, give the port
    f16 planes and exactly the logits of its own loader's weights cast by the
    port."""
    _, jp = _jax(path256, "bfloat16")
    cfg, tp = _port(path256, "bfloat16")
    conv = params_from_numpy(_to_numpy_tree(jqt.cast_scales_f16(jp)), device="cpu")
    assert conv.blocks[0].wqkv.gscale_t.dtype == torch.float16
    assert conv.output.gscale_t.dtype == torch.float16
    own = pqt.cast_scales_f16(tp)
    a = Context(cfg, own, n_ctx=128, device="cpu").eval(np.asarray([PROMPT]))
    b = Context(cfg, conv, n_ctx=128, device="cpu").eval(np.asarray([PROMPT]))
    np.testing.assert_array_equal(a, b)
