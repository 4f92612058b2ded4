"""The Q3_K_M slice on the CPU: a LLaMA quantized by the JAX package to
MOSTLY_Q3_K_M (q3_K for wq, wk, w1, w3 and the token embeddings, q4_K for wv,
wo and w2, q6_K for the head) loaded and run by both packages, and the
synthetic Q3_K_M mix of ``synth.build_llama``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_q_4_0_tpu.formats.fixtures import make_llama_ggjt
from llama_cpp_q_4_0_tpu.formats.ggjt import read_ggjt as jax_read_ggjt
from llama_cpp_q_4_0_tpu.models.loading import (
    config_from_ggjt as jax_config, load_transformer as jax_load)
from llama_cpp_q_4_0_tpu.ops.qtensor import QTensor as JaxQTensor
from llama_cpp_q_4_0_tpu.runtime.context import Context as JaxContext
from llama_cpp_q_4_0_tpu.runtime.generate import (
    GenerateParams as JaxGenerateParams, generate as jax_generate)
from llama_cpp_q_4_0_tpu.runtime.sampling import SamplingParams as JaxSampling
from llama_cpp_q_4_0_tpu_torch.convert import params_from_numpy
from llama_cpp_q_4_0_tpu_torch.formats.ggjt import read_ggjt
from llama_cpp_q_4_0_tpu_torch.models.loading import config_from_ggjt, load_transformer
from llama_cpp_q_4_0_tpu_torch.ops import qmatmul
from llama_cpp_q_4_0_tpu_torch.ops.qtensor import QTensor
from llama_cpp_q_4_0_tpu_torch.quant.types import GGMLType
from llama_cpp_q_4_0_tpu_torch.runtime.context import Context
from llama_cpp_q_4_0_tpu_torch.runtime.generate import GenerateParams, generate
from llama_cpp_q_4_0_tpu_torch.runtime.sampling import SamplingParams
from llama_cpp_q_4_0_tpu_torch.synth import build_llama

# small shapes: one intra-op thread keeps the suite's parallel workers from
# oversubscribing the cores
torch.set_num_threads(1)

PROMPT = [1, 5, 10, 42, 7, 9]
SEQ = [PROMPT, [3], [100]]  # a prefill and two decode steps
KERNELS = ("qmm_packed", "qmm_packed_kfold", "qmm_packed_bias", "qmm_int8",
           "qmm_int8_bias", "qmm_packed_q8x")


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    """A tiny LLaMA (n_embd 256, n_ff 768, 2 layers: k-quants need row widths
    that are multiples of 256) written in F32 and quantized by the JAX
    package's quantize_model to MOSTLY_Q3_K_M."""
    from llama_cpp_q_4_0_tpu.formats.quantize import QuantizeParams, quantize_model
    from llama_cpp_q_4_0_tpu.quant.types import GGMLType as JaxGGMLType, LlamaFType

    d = tmp_path_factory.mktemp("q3k")
    f32 = str(d / "f32.ggjt")
    make_llama_ggjt(f32, n_embd=256, n_mult=256, n_head=2, n_vocab=512, n_layer=2,
                    qtype=JaxGGMLType.F32)
    out = str(d / "q3_k_m.ggjt")
    quantize_model(f32, out, QuantizeParams(ftype=LlamaFType.MOSTLY_Q3_K_M),
                   progress=lambda *a: None)
    return out


def _jax(path, mode, n_ctx=128, fuse=True):
    gf = jax_read_ggjt(path)
    cfg = dataclasses.replace(jax_config(gf, n_ctx=n_ctx), compute_dtype=mode)
    return cfg, jax_load(gf, cfg, fuse=fuse)


def _port(path, mode, n_ctx=128, fuse=True):
    gf = read_ggjt(path)
    cfg = dataclasses.replace(config_from_ggjt(gf, n_ctx=n_ctx), compute_dtype=mode)
    return cfg, load_transformer(gf, cfg, device="cpu", fuse=fuse)


def _steps(ctx, seq):
    return [ctx.eval(np.asarray([toks])) for toks in seq]


def _greedy(ctx_jax, ctx_port, n):
    jt = list(jax_generate(ctx_jax, PROMPT, JaxGenerateParams(
        sampling=JaxSampling(temp=0.0), n_predict=n, ignore_eos=True)))
    tt = list(generate(ctx_port, PROMPT, GenerateParams(
        sampling=SamplingParams(temp=0.0), n_predict=n, ignore_eos=True)))
    return jt, tt


def _routes(monkeypatch):
    calls = []
    for name in KERNELS:
        orig = getattr(qmatmul, name)
        monkeypatch.setattr(qmatmul, name, lambda *a, _n=name, _o=orig, **kw:
                            calls.append(_n) or _o(*a, **kw))
    return calls


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_q3_k_m_mix_loads_as_jax(path, fuse):
    """The file holds the Q3_K_M mix, and the port loads it to the JAX
    loader's arrays byte for byte: q3_K packed with zero 4 over 16-groups
    and no bias; fused, both packages leave wq, wk and wv apart (q3_K
    beside q4_K) and join w1 and w3."""
    gf = read_ggjt(path)
    types = {n: t.qtype.name for n, t in gf.tensors.items() if len(t.shape) == 2}
    for i in range(2):
        p = f"layers.{i}."
        for nm in ("attention.wq", "attention.wk", "feed_forward.w1", "feed_forward.w3"):
            assert types[p + nm + ".weight"] == "Q3_K"
        for nm in ("attention.wv", "attention.wo", "feed_forward.w2"):
            assert types[p + nm + ".weight"] == "Q4_K"
    assert types["tok_embeddings.weight"] == "Q3_K" and types["output.weight"] == "Q6_K"
    _, jp = _jax(path, "bfloat16", fuse=fuse)
    _, tp = _port(path, "bfloat16", fuse=fuse)
    pairs = [(tp.tok_embeddings, jp.tok_embeddings), (tp.output, jp.output)]
    for jb, tb in zip(jp.blocks, tp.blocks):
        for f in dataclasses.fields(tb):
            a, b = getattr(jb, f.name), getattr(tb, f.name)
            assert (a is None) == (b is None), f.name
            if a is not None:
                pairs.append((b, a))
        if fuse:
            assert tb.wqkv is None and tb.w_gateup is not None
    for mine, ref in pairs:
        if not isinstance(mine, QTensor):
            np.testing.assert_array_equal(mine.float().numpy(), np.asarray(ref, np.float32))
            continue
        assert isinstance(ref, JaxQTensor)
        assert (mine.pack_zero, mine.gsize, mine.shape) == (ref.pack_zero, ref.gsize,
                                                            tuple(ref.shape))
        if mine.qtype == GGMLType.Q3_K:
            assert (mine.pack_zero, mine.gsize, mine.gbias_t) == (4, 16, None)
        for key in ("levels_t", "gscale_t", "gbias_t"):
            a, b = getattr(ref, key), getattr(mine, key)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_q3_k_m_f32_matches_jax(path):
    """compute_dtype float32 with an f32 cache: the same f32 arithmetic in
    another summation order, so logits agree to 1e-4 of their scale and 24
    greedy tokens are identical."""
    jcfg, jp = _jax(path, "float32")
    tcfg, tp = _port(path, "float32")
    jl = _steps(JaxContext(jcfg, jp, n_ctx=128, cache_dtype=jnp.float32), SEQ)
    tl = _steps(Context(tcfg, tp, n_ctx=128, cache_dtype=torch.float32, device="cpu"), SEQ)
    for a, b in zip(jl, tl):
        assert np.abs(b - a).max() <= 1e-4 * np.abs(a).max()
    jt, tt = _greedy(JaxContext(jcfg, jp, n_ctx=128, cache_dtype=jnp.float32),
                     Context(tcfg, tp, n_ctx=128, cache_dtype=torch.float32, device="cpu"),
                     24)
    assert tt == jt and len(tt) == 24


def test_q3_k_m_bf16_matches_jax(path, monkeypatch):
    """bf16 compute with a bf16 cache, on the slice's routes: q3_K takes K1
    for the prompt and K2 (kfold) for each decode step, q4_K K5, the q6_K
    head K6.  On the CPU the JAX package takes its unfolded bf16 product
    everywhere, so the port's kfold differs from it by design (ROADMAP queue
    3, trap 3); logits stay within the k-quant bf16 limit of
    ``tests/test_torch_model.py``, 2e-2 of their scale, and the first 4
    greedy tokens are identical."""
    jcfg, jp = _jax(path, "bfloat16")
    tcfg, tp = _port(path, "bfloat16")
    jl = _steps(JaxContext(jcfg, jp, n_ctx=128), SEQ)
    calls = _routes(monkeypatch)
    tl = _steps(Context(tcfg, tp, n_ctx=128, device="cpu"), SEQ)
    # prefill (8 rows after bucketing): every call <= 32 rows; then 2 decodes
    per_eval = {"qmm_packed_kfold": 6, "qmm_packed_bias": 6, "qmm_int8": 1}
    assert {k: calls.count(k) for k in set(calls)} == {k: 3 * v for k, v in per_eval.items()}
    for a, b in zip(jl, tl):
        assert np.isfinite(b).all()
        assert np.abs(b - a).max() <= 2e-2 * np.abs(a).max()
    monkeypatch.undo()
    jt, tt = _greedy(JaxContext(jcfg, jp, n_ctx=128),
                     Context(tcfg, tp, n_ctx=128, device="cpu"), 4)
    assert tt == jt and len(tt) == 4


def test_q3_k_m_prompt_takes_the_prefill_kernel(path, monkeypatch):
    """A 40-token prompt (bucket 64) sends q3_K through K1 and q4_K through
    K5's tile form, while the head's last row takes K6; with QMM_KFOLD=1 the
    q3_K calls move to K2, as in the JAX dispatch."""
    tcfg, tp = _port(path, "bfloat16")
    prompt = [1] + list(range(3, 42))
    calls = _routes(monkeypatch)
    Context(tcfg, tp, n_ctx=128, device="cpu").eval(np.asarray([prompt]))
    assert sorted(set(calls)) == ["qmm_int8", "qmm_packed", "qmm_packed_bias"]
    assert calls.count("qmm_packed") == 6
    calls.clear()
    monkeypatch.setenv("QMM_KFOLD", "1")
    Context(tcfg, tp, n_ctx=128, device="cpu").eval(np.asarray([prompt]))
    assert calls.count("qmm_packed_kfold") == 6 and "qmm_packed" not in calls


def _to_numpy_tree(params):
    def leaf(v):
        if v is None:
            return None
        if isinstance(v, JaxQTensor):
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


def test_q3_k_m_params_from_numpy(path):
    """The JAX package's fused Q3_K_M params (q3_K with pack zero 4 and
    16-groups among them) handed over as numpy through convert.py keep their
    pack zero and group size, and give exactly the logits of the port's own
    loader."""
    _, jp = _jax(path, "bfloat16", n_ctx=64)
    cfg, tp = _port(path, "bfloat16", n_ctx=64)
    conv = params_from_numpy(_to_numpy_tree(jp), device="cpu")
    q3 = conv.blocks[0].w_gateup
    assert (q3.qtype, q3.pack_zero, q3.gsize) == (GGMLType.Q3_K, 4, 16)
    a = _steps(Context(cfg, tp, n_ctx=64, device="cpu"), [PROMPT, [3]])
    b = _steps(Context(cfg, conv, n_ctx=64, device="cpu"), [PROMPT, [3]])
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_synthetic_q3_k_m_mix(monkeypatch):
    """``build_llama(ftype="q3_K_M")``: the mix of the JAX quantizer (q3_K
    with zero 4, 16-groups and nibbles 0..7; q4_K for wv, wo, w2; q6_K head;
    q3_K embeddings), w1/w3 fused and wq/wk/wv apart, and per decode token
    3 K2 + 3 K5 launches a layer and 1 K6 for the head (96 + 96 + 1 at 32
    layers)."""
    cfg, params = build_llama(n_layer=2, n_embd=256, n_head=2, n_ff=768, n_vocab=512,
                              n_ctx=128, device="cpu", ftype="q3_K_M")
    blk = params.blocks[0]
    assert blk.wqkv is None and blk.w_gate is None and blk.w_up is None
    for w in (blk.wq, blk.wk, blk.w_gateup, params.tok_embeddings):
        assert w.qtype == GGMLType.Q3_K and (w.pack_zero, w.gsize, w.gbias_t) == (4, 16, None)
        assert int((w.levels_t & 0x88).max()) == 0  # nibbles 0..7: levels -4..3
    for w in (blk.wv, blk.wo, blk.w_down):
        assert w.qtype == GGMLType.Q4_K and w.gbias_t is not None
    assert params.output.qtype == GGMLType.Q6_K
    ctx = Context(cfg, params, n_ctx=128, device="cpu")
    ctx.eval(np.asarray([PROMPT]))
    calls = _routes(monkeypatch)
    logits = ctx.eval(np.asarray([[3]]))
    assert np.isfinite(logits).all()
    assert {k: calls.count(k) for k in set(calls)} == {
        "qmm_packed_kfold": 6, "qmm_packed_bias": 6, "qmm_int8": 1}
