"""The slice as a whole on the CPU: the port's Context + generate against the
JAX package's on the same GGJT fixture."""

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
from llama_cpp_q_4_0_tpu_torch.models.loading import (config_from_ggjt,
                                                      load_transformer)
from llama_cpp_q_4_0_tpu_torch.runtime.context import Context
from llama_cpp_q_4_0_tpu_torch.runtime.generate import GenerateParams, generate
from llama_cpp_q_4_0_tpu_torch.runtime.sampling import SamplingParams


# small shapes: one intra-op thread keeps the suite's parallel workers from
# oversubscribing the cores
torch.set_num_threads(1)

PROMPT = [1, 5, 10, 42, 7, 9]


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("m") / "llama.ggjt")
    make_llama_ggjt(p)
    return p


@pytest.fixture(scope="module")
def path256(tmp_path_factory):
    """A q4_0 LLaMA whose every matmul lies inside the kernels' gate (N % 128
    == 0, K % 256 == 0): n_embd 256, n_ff 768, a 512-entry vocabulary.  The
    default fixture's n_embd 64 lies outside it, where both packages take the
    plain bf16 product."""
    p = str(tmp_path_factory.mktemp("m256") / "llama.ggjt")
    make_llama_ggjt(p, n_embd=256, n_mult=256, n_head=2)
    return p


def _jax(path, mode, n_ctx):
    gf = jax_read_ggjt(path)
    cfg = dataclasses.replace(jax_config(gf, n_ctx=n_ctx), compute_dtype=mode)
    return cfg, jax_load(gf, cfg)


def _port(path, mode, n_ctx):
    gf = read_ggjt(path)
    cfg = dataclasses.replace(config_from_ggjt(gf, n_ctx=n_ctx),
                              compute_dtype=mode)
    return cfg, load_transformer(gf, cfg, device="cpu")


def _steps(ctx, tokens_list):
    return [ctx.eval(np.asarray([toks])) for toks in tokens_list]


def _greedy(n):
    return dict(n_predict=n, ignore_eos=True)


def test_f32_mode_matches_jax(path):
    """compute_dtype float32 with an f32 cache: the same f32 arithmetic in a
    different summation order, so logits agree to 1e-4 and greedy tokens are
    identical."""
    jcfg, jp = _jax(path, "float32", 128)
    tcfg, tp = _port(path, "float32", 128)
    seq = [PROMPT, [3], [100], [200]]
    jl = _steps(JaxContext(jcfg, jp, n_ctx=128, cache_dtype=jnp.float32), seq)
    tl = _steps(Context(tcfg, tp, n_ctx=128, cache_dtype=torch.float32,
                        device="cpu"), seq)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)
    jt = list(jax_generate(JaxContext(jcfg, jp, n_ctx=128, cache_dtype=jnp.float32),
                           PROMPT, JaxGenerateParams(
                               sampling=JaxSampling(temp=0.0), **_greedy(24))))
    tt = list(generate(Context(tcfg, tp, n_ctx=128, cache_dtype=torch.float32,
                               device="cpu"),
                       PROMPT, GenerateParams(sampling=SamplingParams(temp=0.0),
                                              **_greedy(24))))
    assert tt == jt and len(tt) == 24


def test_default_mode_within_kfold_class(path256):
    """bf16 compute with a bf16 cache.  On the CPU the JAX package takes its
    unfolded XLA matmul while the port's decode-shaped calls (<= 32 rows, as
    on the card) take the kfold form, whose documented drift from the
    unfolded path is ~3e-2 of the logits (JAX ops/qmatmul.py use_kfold).
    The fixture's matmuls lie inside the kernels' gate, so kfold runs."""
    jcfg, jp = _jax(path256, "bfloat16", 128)
    tcfg, tp = _port(path256, "bfloat16", 128)
    seq = [PROMPT, [3], [100]]
    jl = _steps(JaxContext(jcfg, jp, n_ctx=128), seq)
    tl = _steps(Context(tcfg, tp, n_ctx=128, device="cpu"), seq)
    for a, b in zip(jl, tl):
        assert np.isfinite(b).all()
        assert np.abs(b - a).max() <= 3e-2 * np.abs(a).max()


@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_prefill_equals_incremental(path, cache):
    """A prompt evaluated in one shot equals token-by-token decode over the
    same cache type (the KV-cache gate of the JAX package's
    test_model_runtime).  Calls of 7 rows and of 1 row sum in different
    orders, which can flip the bf16 rounding of an activation by one ulp
    (2^-8): 1e-2 of unit-scale logits bounds it."""
    cfg, params = _port(path, "bfloat16", 64)
    prompt = [1, 7, 19, 3, 25, 4, 9]
    la = Context(cfg, params, n_ctx=64, cache_dtype=cache, device="cpu").eval(
        np.asarray([prompt]), logits_all=True)
    ctx_b = Context(cfg, params, n_ctx=64, cache_dtype=cache, device="cpu")
    lb = np.stack([ctx_b.eval(np.asarray([[t]]))[0, -1] for t in prompt])
    assert la.shape == (1, len(prompt), cfg.n_vocab)
    np.testing.assert_allclose(la[0], lb, rtol=0, atol=1e-2)


def _to_numpy_tree(params):
    def leaf(v):
        if v is None:
            return None
        if isinstance(v, JaxQTensor):
            return {"levels_t": np.asarray(v.levels_t),
                    "gscale_t": np.asarray(v.gscale_t),
                    "gbias_t": None if v.gbias_t is None else np.asarray(v.gbias_t),
                    "gsize": v.gsize, "qtype": int(v.qtype),
                    "shape": tuple(v.shape), "pack_zero": v.pack_zero}
        return np.asarray(v)

    return {
        "tok_embeddings": leaf(params.tok_embeddings),
        "blocks": [{f.name: leaf(getattr(b, f.name))
                    for f in dataclasses.fields(b)} for b in params.blocks],
        "out_norm_w": leaf(params.out_norm_w),
        "out_norm_b": leaf(params.out_norm_b),
        "output": leaf(params.output),
    }


@pytest.mark.parametrize("mode", ["float32", "bfloat16"])
def test_f8_cache_matches_jax(path, mode):
    """An e4m3 cache (--cache-type f8) against the JAX package's
    jnp.float8_e4m3fn cache, a prefill and three decode steps: the logits
    within the bf16-cache limit of test_prefill_equals_incremental (1e-2;
    both feed bf16 operands to attention over a non-f32 cache) and the
    cache bytes equal after every insert (the JAX insert is a plain cast)."""
    jcfg, jp = _jax(path, mode, 128)
    tcfg, tp = _port(path, mode, 128)
    jctx = JaxContext(jcfg, jp, n_ctx=128, cache_dtype=jnp.float8_e4m3fn)
    tctx = Context(tcfg, tp, n_ctx=128, cache_dtype=torch.float8_e4m3fn, device="cpu")
    for toks in (PROMPT, [3], [100], [200]):
        a, b = jctx.eval(np.asarray([toks])), tctx.eval(np.asarray([toks]))
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-2)
        for jc, tc in zip((*jctx.cache_k, *jctx.cache_v), (*tctx.cache_k, *tctx.cache_v)):
            assert tc.dtype == torch.float8_e4m3fn
            np.testing.assert_array_equal(tc.view(torch.uint8).numpy(),
                                          np.asarray(jc).view(np.uint8))


def test_f8_cast_is_the_jax_cast():
    """to_f8 rounds as the JAX cast (nearest even, subnormals) and gives NaN
    beyond 464, where PyTorch's own CPU cast saturates at 448."""
    from llama_cpp_q_4_0_tpu_torch.ops.kvcache import to_f8

    rng = np.random.default_rng(0)
    x = (rng.standard_normal(20000) * np.exp(rng.uniform(-14, 7, 20000))).astype(np.float32)
    x = np.concatenate([x, [448.0, 460.0, 464.0, 464.1, 500.0, -1e4, np.inf, np.nan, 0.0,
                            -0.0]]).astype(np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)).view(np.uint8)
    got = to_f8(torch.from_numpy(x)).view(torch.uint8).numpy()
    nan = np.isnan(np.asarray(jnp.asarray(x).astype(jnp.float8_e4m3fn)).astype(np.float32))
    np.testing.assert_array_equal(got[~nan], want[~nan])
    assert np.isnan(to_f8(torch.from_numpy(x)).float().numpy()[nan]).all()


def test_params_from_numpy_matches_loader(path):
    """The JAX package's fused params, handed over as numpy, give the port
    exactly the logits of its own loader (the same bytes)."""
    _, jp = _jax(path, "bfloat16", 64)
    cfg, tp = _port(path, "bfloat16", 64)
    conv = params_from_numpy(_to_numpy_tree(jp), device="cpu")
    a = _steps(Context(cfg, tp, n_ctx=64, device="cpu"), [PROMPT, [3]])
    b = _steps(Context(cfg, conv, n_ctx=64, device="cpu"), [PROMPT, [3]])
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_cache_clamp_near_n_ctx(path):
    """n_past 10 plus a 40-token call pads to bucket 64 = n_ctx: the insert
    start clamps to 0 as JAX's dynamic_update_slice does, overwriting the
    first slots.  The port reproduces the reference, step for step."""
    jcfg, jp = _jax(path, "float32", 64)
    tcfg, tp = _port(path, "float32", 64)
    rng = np.random.default_rng(0)
    seq = [rng.integers(3, 500, 10).tolist(), rng.integers(3, 500, 40).tolist(),
           [5], [6], rng.integers(3, 500, 11).tolist()]
    jl = _steps(JaxContext(jcfg, jp, n_ctx=64, cache_dtype=jnp.float32), seq)
    tl = _steps(Context(tcfg, tp, n_ctx=64, cache_dtype=torch.float32,
                        device="cpu"), seq)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)


def test_other_families_raise(tmp_path):
    """RWKV, the one family the port does not run, raises at the config,
    at the loader and in the CLI (gptneox, falcon and bonsai run:
    tests/test_torch_families.py)."""
    import argparse

    from llama_cpp_q_4_0_tpu.formats.fixtures import make_rwkv_ggjt
    from llama_cpp_q_4_0_tpu_torch.cli.common import load_model
    from llama_cpp_q_4_0_tpu_torch.models.config import ModelConfig

    p = str(tmp_path / "rwkv.ggjt")
    make_rwkv_ggjt(p)
    gf = read_ggjt(p, "rwkv")
    with pytest.raises(NotImplementedError):
        config_from_ggjt(gf)
    with pytest.raises(NotImplementedError):
        load_transformer(gf, ModelConfig(arch="rwkv", n_vocab=512, n_embd=64, n_layer=2),
                         device="cpu")
    with pytest.raises(NotImplementedError):
        load_model(argparse.Namespace(model=p, arch=None, n_ctx=64, cache_type="f32",
                                      device="cpu"))


# ------------------------------------------------------------ k-quant files

KQ_FTYPES = ["MOSTLY_Q4_K_M", "MOSTLY_Q5_K_M"]
KQ_SEQ = [PROMPT, [3], [100]]  # a prefill and two decode steps


@pytest.fixture(scope="module")
def kquant_paths(tmp_path_factory):
    """A tiny LLaMA written in F32 and quantized by the JAX package's
    quantize_model: k-quants need row widths that are multiples of 256, so
    n_embd 256 and n_ff 768; with 2 layers, layer 1 takes q6_K for wv and w2
    (use_more_bits), so packed/affine and int8 layouts both appear."""
    from llama_cpp_q_4_0_tpu.formats.quantize import QuantizeParams, quantize_model
    from llama_cpp_q_4_0_tpu.quant.types import GGMLType as JaxGGMLType, LlamaFType

    d = tmp_path_factory.mktemp("kq")
    f32 = str(d / "f32.ggjt")
    make_llama_ggjt(f32, n_embd=256, n_mult=256, n_head=2, n_vocab=512,
                    n_layer=2, qtype=JaxGGMLType.F32)
    out = {}
    for ft in KQ_FTYPES:
        out[ft] = str(d / f"{ft}.ggjt")
        quantize_model(f32, out[ft], QuantizeParams(ftype=LlamaFType[ft]),
                       progress=lambda *a: None)
    return out


@pytest.mark.parametrize("ftype", KQ_FTYPES)
def test_kquant_layouts_and_loader_match_jax(kquant_paths, ftype):
    """The file holds the _M mix (q6_K output, q6_K wv/w2 in layer 1) and
    the port loads every tensor to JAX's arrays, byte for byte."""
    path = kquant_paths[ftype]
    gf = read_ggjt(path)
    want = "Q4_K" if ftype == "MOSTLY_Q4_K_M" else "Q5_K"
    types = {n: t.qtype.name for n, t in gf.tensors.items() if len(t.shape) == 2}
    assert types["output.weight"] == "Q6_K"
    assert types["layers.1.attention.wv.weight"] == "Q6_K"
    assert types["layers.1.feed_forward.w2.weight"] == "Q6_K"
    assert types["layers.0.attention.wv.weight"] == want
    assert types["tok_embeddings.weight"] == want
    jgf = jax_read_ggjt(path)
    jp = jax_load(jgf, jax_config(jgf, n_ctx=64), fuse=False)
    tp = load_transformer(gf, config_from_ggjt(gf, n_ctx=64), device="cpu",
                          fuse=False)
    jt, tt = _to_numpy_tree(jp), _to_numpy_tree_port(tp)
    leaves = [("tok_embeddings", jt["tok_embeddings"], tt["tok_embeddings"]),
              ("output", jt["output"], tt["output"])]
    for i, (jb, tb) in enumerate(zip(jt["blocks"], tt["blocks"])):
        leaves += [(f"{i}.{k}", jb[k], tb[k]) for k in jb if jb[k] is not None]
    for name, a, b in leaves:
        if isinstance(a, dict):
            assert a["pack_zero"] == b["pack_zero"] and a["gsize"] == b["gsize"], name
            for key in ("levels_t", "gscale_t", "gbias_t"):
                if a[key] is None:
                    assert b[key] is None, (name, key)
                else:
                    np.testing.assert_array_equal(a[key], b[key], err_msg=name)
        else:
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          np.asarray(b, np.float32), err_msg=name)


def _to_numpy_tree_port(params):
    from llama_cpp_q_4_0_tpu_torch.ops.qtensor import QTensor

    def leaf(v):
        if v is None:
            return None
        if isinstance(v, QTensor):
            return {"levels_t": v.levels_t.numpy(), "gscale_t": v.gscale_t.numpy(),
                    "gbias_t": None if v.gbias_t is None else v.gbias_t.numpy(),
                    "gsize": v.gsize, "pack_zero": v.pack_zero}
        return v.float().numpy()

    return {"tok_embeddings": leaf(params.tok_embeddings),
            "output": leaf(params.output),
            "blocks": [{f.name: leaf(getattr(b, f.name))
                        for f in dataclasses.fields(b)} for b in params.blocks]}


@pytest.mark.parametrize("ftype", KQ_FTYPES)
def test_kquant_f32_mode_matches_jax(kquant_paths, ftype):
    """compute_dtype float32 with an f32 cache on the k-quant mix: logits
    within 1e-4 and 24 identical greedy tokens, as for q4_0."""
    path = kquant_paths[ftype]
    jcfg, jp = _jax(path, "float32", 128)
    tcfg, tp = _port(path, "float32", 128)
    seq = [PROMPT, [3], [100], [200]]
    jl = _steps(JaxContext(jcfg, jp, n_ctx=128, cache_dtype=jnp.float32), seq)
    tl = _steps(Context(tcfg, tp, n_ctx=128, cache_dtype=torch.float32,
                        device="cpu"), seq)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)
    jt = list(jax_generate(JaxContext(jcfg, jp, n_ctx=128, cache_dtype=jnp.float32),
                           PROMPT, JaxGenerateParams(
                               sampling=JaxSampling(temp=0.0), **_greedy(24))))
    tt = list(generate(Context(tcfg, tp, n_ctx=128, cache_dtype=torch.float32,
                               device="cpu"),
                       PROMPT, GenerateParams(sampling=SamplingParams(temp=0.0),
                                              **_greedy(24))))
    assert tt == jt and len(tt) == 24


@pytest.mark.parametrize("ftype", KQ_FTYPES)
def test_kquant_default_mode_matches_jax(kquant_paths, ftype):
    """bf16 compute with a bf16 cache.  No tensor of this file takes kfold
    (every packed one has a bias), so both packages run the same arithmetic:
    bf16(level * d) products, f32 sums, the f32 bias seed; single matmuls
    agree to 1e-6 of their scale.  Only f32 summation order differs, and it
    flips the bf16 rounding of some activations by one ulp.  On this file
    that class alone moves the logits by more than 1e-2 of their scale
    (test_kquant_bf16_one_ulp_class_exceeds_1e_2), so the limit is 2e-2,
    below kfold's 3e-2 drift."""
    path = kquant_paths[ftype]
    jcfg, jp = _jax(path, "bfloat16", 128)
    tcfg, tp = _port(path, "bfloat16", 128)
    jl = _steps(JaxContext(jcfg, jp, n_ctx=128), KQ_SEQ)
    tl = _steps(Context(tcfg, tp, n_ctx=128, device="cpu"), KQ_SEQ)
    for a, b in zip(jl, tl):
        assert np.isfinite(b).all()
        assert np.abs(b - a).max() <= 2e-2 * np.abs(a).max()


def _drift(ref, got):
    """Largest logit difference of any step, over that step's logit scale."""
    return max(float(np.abs(b - a).max() / np.abs(a).max())
               for a, b in zip(ref, got))


@pytest.mark.parametrize("ftype", KQ_FTYPES)
def test_kquant_bf16_one_ulp_class_exceeds_1e_2(kquant_paths, ftype):
    """The size of the one-ulp class on this file, the port against itself:
    its token embeddings' scales times 1 + 1e-7 noise (an f32 ulp) flip the
    bf16 rounding of some activations, as a change of f32 summation order
    does.  Over 8 noise draws the logits move by more than 1e-2 of their
    scale (1.28e-2 and 2.29e-2 at most on the development machine), and
    the JAX package's bf16 logits lie no further from the port's than
    that."""
    path = kquant_paths[ftype]
    tcfg, tp = _port(path, "bfloat16", 128)
    base = _steps(Context(tcfg, tp, n_ctx=128, device="cpu"), KQ_SEQ)
    e = tp.tok_embeddings
    noise = []
    for seed in range(8):
        g = torch.Generator().manual_seed(seed)
        noisy = dataclasses.replace(e, gscale_t=e.gscale_t * (
            1 + 1e-7 * torch.randn(e.gscale_t.shape, generator=g)))
        ctx = Context(tcfg, dataclasses.replace(tp, tok_embeddings=noisy),
                      n_ctx=128, device="cpu")
        noise.append(_drift(base, _steps(ctx, KQ_SEQ)))
    assert max(noise) > 1e-2, noise
    jcfg, jp = _jax(path, "bfloat16", 128)
    assert _drift(base, _steps(JaxContext(jcfg, jp, n_ctx=128), KQ_SEQ)) <= max(noise)


def test_kquant_params_from_numpy(kquant_paths):
    """The JAX package's fused k-quant params (packed with biases, int8,
    mixed-format blocks left unfused) handed over as numpy give the port's
    own loader's logits exactly."""
    path = kquant_paths["MOSTLY_Q4_K_M"]
    _, jp = _jax(path, "bfloat16", 64)
    cfg, tp = _port(path, "bfloat16", 64)
    assert tp.blocks[1].wqkv is None and tp.blocks[0].wqkv is not None
    conv = params_from_numpy(_to_numpy_tree(jp), device="cpu")
    a = _steps(Context(cfg, tp, n_ctx=64, device="cpu"), [PROMPT, [3]])
    b = _steps(Context(cfg, conv, n_ctx=64, device="cpu"), [PROMPT, [3]])
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
