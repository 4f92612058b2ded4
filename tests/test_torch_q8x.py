"""The int8-activation path: the activation quantizer, K7's plain version
(q4_0's packing and q3_K's: any pack zero, 16-groups) and
``q_matmul_ref_int8`` against the JAX package, the ``QMM_Q8X`` routing, and
the model in ``ref_int8`` and in the int8 configuration (CPU)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_q_4_0_tpu.formats.fixtures import make_llama_ggjt
from llama_cpp_q_4_0_tpu.formats.ggjt import read_ggjt as jax_read_ggjt
from llama_cpp_q_4_0_tpu.models.loading import (
    config_from_ggjt as jax_config, load_transformer as jax_load)
from llama_cpp_q_4_0_tpu.ops.pallas.qmm import _quantize_q8x
from llama_cpp_q_4_0_tpu.ops.pallas.qmm import qmm_packed_q8x as jax_q8x
from llama_cpp_q_4_0_tpu.ops.qmatmul import q_matmul_ref_int8 as jax_ref_int8
from llama_cpp_q_4_0_tpu.ops.qtensor import QTensor as JaxQTensor
from llama_cpp_q_4_0_tpu.quant.blockq import _int_nibbles, f16_to_f32, quantize_q8_0
from llama_cpp_q_4_0_tpu.quant.registry import QUANT_FNS, quantize_bytes
from llama_cpp_q_4_0_tpu.quant.types import GGMLType as JaxGGMLType
from llama_cpp_q_4_0_tpu.runtime.context import Context as JaxContext
from llama_cpp_q_4_0_tpu.runtime.generate import (
    GenerateParams as JaxGenerateParams, generate as jax_generate)
from llama_cpp_q_4_0_tpu.runtime.sampling import SamplingParams as JaxSampling
from llama_cpp_q_4_0_tpu_torch.formats.ggjt import read_ggjt
from llama_cpp_q_4_0_tpu_torch.models.loading import config_from_ggjt, load_transformer
from llama_cpp_q_4_0_tpu_torch.ops import qmatmul, qmm
from llama_cpp_q_4_0_tpu_torch.ops.qtensor import QTensor
from llama_cpp_q_4_0_tpu_torch.quant.q4_0 import pack_q4_0
from llama_cpp_q_4_0_tpu_torch.quant.types import GGMLType
from llama_cpp_q_4_0_tpu_torch.runtime.context import Context
from llama_cpp_q_4_0_tpu_torch.runtime.generate import GenerateParams, generate
from llama_cpp_q_4_0_tpu_torch.runtime.sampling import SamplingParams

# small shapes: one intra-op thread keeps the suite's parallel workers from
# oversubscribing the cores
torch.set_num_threads(1)


def _weight(n, k, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    packed, scales = pack_q4_0(quantize_bytes(w, JaxGGMLType.Q4_0), n, k)
    return w, packed, scales


def _x(b, k, seed):
    return (np.random.default_rng(seed).standard_normal((b, k)) * 0.5).astype(np.float32)


def _tie_rows(k):
    """Row 0: a group whose amax is 127, so d = 1 and x/d = x lands exactly
    on the ties 2.5, -3.5, 0.5 (roundf: 3, -4, 1; round-half-even: 2, -4, 0),
    and a group of zeros (d = 0, q = 0)."""
    x = _x(3, k, seed=5)
    x[0, :32] = 0.25
    x[0, :4] = [127.0, 2.5, -3.5, 0.5]
    x[1, 32:64] = 0.0
    return x


@pytest.mark.parametrize("k", [256, 1024, 704])
def test_quantize_q8x_exact(k):
    """xq and d equal the JAX ``_quantize_q8x`` bit for bit, its split-half
    planes rearranged into the logical [B, K] and [B, K/32] order."""
    x = _tie_rows(k)
    k2p = -(-(k // 2) // 256) * 256
    g2 = k // 64
    lo, hi, slo, shi = (np.asarray(a) for a in _quantize_q8x(jnp.asarray(x), 32, k2p))
    want_q = np.concatenate([lo[:g2], hi[:g2]], 0).transpose(2, 0, 1).reshape(3, k)
    want_d = np.concatenate([slo[:, :g2], shi[:, :g2]], 1)
    xq, d = qmm.quantize_q8x(torch.from_numpy(x))
    np.testing.assert_array_equal(xq.numpy(), want_q)
    np.testing.assert_array_equal(d.numpy().view(np.uint32), want_d.view(np.uint32))
    assert xq[0, 1] == 3 and xq[0, 2] == -4 and xq[0, 3] == 1  # ties away from 0
    assert (xq[1, 32:64] == 0).all() and d[1, 1] == 0


@pytest.mark.parametrize("k", [256, 1024, 704])
def test_quantize_q8x_16_groups_exact(k):
    """At 16-groups (q3_K) the plain quantizer and the wrapper equal the JAX
    ``_quantize_q8x`` bit for bit, its split-half planes rearranged into the
    logical [B, K] and [B, K/16] order."""
    x = _tie_rows(k)
    x[2, 16:32] = 0.0  # a zero 16-group beside a nonzero one
    k2p = -(-(k // 2) // 256) * 256
    g2 = k // 32
    lo, hi, slo, shi = (np.asarray(a) for a in _quantize_q8x(jnp.asarray(x), 16, k2p))
    want_q = np.concatenate([lo[:g2], hi[:g2]], 0).transpose(2, 0, 1).reshape(3, k)
    want_d = np.concatenate([slo[:, :g2], shi[:, :g2]], 1)
    for xq, d in (qmm.quantize_q8x_plain(torch.from_numpy(x), 16),
                  qmm.quantize_q8x(torch.from_numpy(x), 16)):
        assert tuple(d.shape) == (3, k // 16)
        np.testing.assert_array_equal(xq.numpy(), want_q)
        np.testing.assert_array_equal(d.numpy().view(np.uint32), want_d.view(np.uint32))
    assert d[2, 1] == 0 and d[2, 0] > 0


def _ref64(w, x):
    """The reference's quantize_row_q8_0 + vec_dot_q4_0_q8_0 in float64
    (tests/test_qmatmul.py): associativity-free."""
    n, k = w.shape
    b = x.shape[0]
    wb = QUANT_FNS[JaxGGMLType.Q4_0].quantize_row(w)
    qlv = _int_nibbles(wb.reshape(-1), 8).reshape(n, k // 32, 32)
    wd = f16_to_f32(wb["d"]).reshape(n, k // 32)
    yb = quantize_q8_0(x)
    xqv = yb["qs"].astype(np.int64).reshape(b, k // 32, 32)
    xd = f16_to_f32(yb["d"]).reshape(b, k // 32)
    sumi = np.einsum("bgk,ngk->bgn", xqv, qlv.astype(np.int64))
    return np.einsum("bgn,bg,ng->bn", sumi.astype(np.float64), xd.astype(np.float64),
                     wd.astype(np.float64))


@pytest.mark.parametrize("b", [1, 4, 8, 128])
def test_q8x_plain_matches_pallas_interpret(b):
    """K7's plain version against the JAX kernel in interpret mode and the
    float64 reference: the integer dots are exact on every side, so only f32
    summation order differs (2e-5 relative and absolute, the JAX test's)."""
    n, k = 256, 1024
    w, packed, scales = _weight(n, k, seed=b)
    x = _x(b, k, seed=100 + b)
    want = np.asarray(jax_q8x(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales),
                              gsize=32, zero=8, block_n=128, block_k=256,
                              interpret=True))
    got = qmm.qmm_packed_q8x(torch.from_numpy(x), torch.from_numpy(packed),
                             torch.from_numpy(scales)).numpy()
    assert got.shape == (b, n)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, _ref64(w, x), rtol=2e-5, atol=2e-5)


def test_q8x_wrappers_take_the_plain_version_on_cpu():
    _, packed, scales = _weight(128, 256, seed=1)
    x = torch.from_numpy(_x(3, 256, seed=2))
    p, s = torch.from_numpy(packed), torch.from_numpy(scales)
    before = dict(qmm.launches)
    assert torch.equal(qmm.qmm_packed_q8x(x, p, s), qmm.qmm_packed_q8x_plain(x, p, s))
    assert qmm.launches == before
    with pytest.raises(NotImplementedError):  # the kernels take 16- and 32-groups
        qmm.qmm_packed_q8x(x, p, torch.zeros(2, 4, 128), zero=4, gsize=64)


def _q3_k_weight(n, k, zero, seed):
    """Random q3_K-layout arrays: split-half nibbles 0..7 whose levels are
    nibble - zero, 16-group scale planes (padding rows zero)."""
    rng = np.random.default_rng(seed)
    k2, k2p = k // 2, -(-(k // 2) // 256) * 256
    packed = np.zeros((k2p, n), np.uint8)
    packed[:k2] = rng.integers(0, 256, (k2, n), dtype=np.uint8) & 0x77
    scales = np.zeros((2, k2p // 16, n), np.float32)
    scales[:, :k2 // 16] = rng.uniform(0.01, 0.03, (2, k2 // 16, n))
    return packed, scales


def _q8x_ref64(x, packed, scales, zero, gsize):
    """K7's function in float64 from the plain quantizer's xq and d: exact
    integer group dots, then the scaled sum (associativity-free)."""
    b, k = x.shape
    k2, n = k // 2, packed.shape[1]
    xq, d = qmm.quantize_q8x_plain(torch.from_numpy(x), gsize)
    p = packed[:k2].astype(np.int64)
    lv = np.concatenate([(p & 0xF) - zero, (p >> 4) - zero]).reshape(-1, gsize, n)
    sc = np.concatenate([scales[0, :k2 // gsize], scales[1, :k2 // gsize]])
    dots = np.einsum("bgk,gkn->bgn", xq.numpy().astype(np.int64).reshape(b, -1, gsize), lv)
    return np.einsum("bgn,bg,gn->bn", dots.astype(np.float64), d.numpy().astype(np.float64),
                     sc.astype(np.float64))


@pytest.mark.parametrize("b", [1, 4, 8, 128])
@pytest.mark.parametrize("zero", [4, 3])
def test_q8x_plain_16_groups_matches_pallas_interpret(b, zero):
    """K7 on the q3_K layout (16-groups, pack zero 4, and an odd zero 3):
    the plain version against the JAX kernel in interpret mode and a float64
    version of the same function; the integer dots are exact on every side,
    so only f32 summation order differs (2e-5 relative and absolute, as at
    32-groups)."""
    n, k = 256, 1024
    packed, scales = _q3_k_weight(n, k, zero, seed=b + zero)
    x = _x(b, k, seed=200 + b)
    want = np.asarray(jax_q8x(jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales),
                              gsize=16, zero=zero, block_n=128, block_k=256,
                              interpret=True))
    got = qmm.qmm_packed_q8x(torch.from_numpy(x), torch.from_numpy(packed),
                             torch.from_numpy(scales), zero=zero, gsize=16).numpy()
    assert got.shape == (b, n)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, _q8x_ref64(x, packed, scales, zero, 16),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name", ["Q4_0", "Q4_1", "Q8_0", "Q4_K", "Q6_K"])
def test_q_matmul_ref_int8_matches_jax(name):
    """q8_0 activations for the 32-group symmetric formats, q8_1 for the
    affine ones and q8_K for the k-quants: integer dots and the same f32
    rescale on both sides, 1e-6 (the JAX test's own limit)."""
    n, k, b = 64, 512, 4
    rng = np.random.default_rng(len(name))
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    x = (rng.standard_normal((2, b, k)) * 0.5).astype(np.float32)
    want = np.asarray(jax_ref_int8(jnp.asarray(x),
                                   JaxQTensor.quantize(w, JaxGGMLType[name])))
    got = qmatmul.q_matmul_ref_int8(torch.from_numpy(x),
                                    QTensor.quantize(w, GGMLType[name], device="cpu"))
    assert got.shape == (2, b, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def _qtensor(n, k, packed, scales):
    return QTensor(levels_t=torch.from_numpy(packed), gscale_t=torch.from_numpy(scales),
                   gsize=32, qtype=GGMLType.Q4_0, shape=(n, k), pack_zero=8)


def _routes(monkeypatch):
    calls = []
    for name in ("qmm_packed", "qmm_packed_kfold", "qmm_packed_q8x", "qmm_packed_bias",
                 "qmm_int8", "qmm_int8_bias"):
        orig = getattr(qmatmul, name)
        monkeypatch.setattr(qmatmul, name,
                            lambda *a, _n=name, _o=orig, **kw: calls.append(_n)
                            or _o(*a, **kw))
    return calls


@pytest.mark.parametrize("env,b,route", [
    (None, 1, "qmm_packed_kfold"), (None, 64, "qmm_packed"),
    ("1", 1, "qmm_packed_q8x"), ("1", 32, "qmm_packed_q8x"),
    ("1", 128, "qmm_packed_q8x"), ("1", 129, "qmm_packed"),
    ("bf16", 8, "qmm_packed_q8x"), ("512", 200, "qmm_packed_q8x")])
def test_q8x_routing(monkeypatch, env, b, route):
    """With QMM_Q8X set, a q4_0 call of at most QMM_Q8X_MAX_B rows (128
    unless set; the "512" case sets it to 512) takes K7, decode included;
    above the cap K1; without the variable today's routes hold."""
    monkeypatch.delenv("QMM_Q8X", raising=False)
    monkeypatch.delenv("QMM_Q8X_MAX_B", raising=False)
    if env == "512":
        monkeypatch.setenv("QMM_Q8X", "1")
        monkeypatch.setenv("QMM_Q8X_MAX_B", "512")
    elif env:
        monkeypatch.setenv("QMM_Q8X", env)
    _, packed, scales = _weight(128, 256, seed=b)
    w = _qtensor(128, 256, packed, scales)
    calls = _routes(monkeypatch)
    x = torch.from_numpy(_x(b, 256, seed=1))
    out = qmatmul.q_matmul(x, w)
    assert calls == [route] and out.shape == (b, 128)
    calls.clear()
    qmatmul.q_matmul(x, w, compute_dtype=torch.float32)
    assert calls == []


@pytest.mark.parametrize("name,route", [("Q4_K", "qmm_packed_bias"),
                                        ("Q8_0", "qmm_int8"), ("Q5_K", "qmm_int8_bias")])
def test_q8x_leaves_biased_and_unpacked_weights(monkeypatch, name, route):
    """(N = 128: a weight inside the kernels' gate, N % 128 == 0.)"""
    monkeypatch.setenv("QMM_Q8X", "1")
    w = (np.random.default_rng(0).standard_normal((128, 256)) * 0.05).astype(np.float32)
    qt = QTensor.quantize(w, GGMLType[name], device="cpu")
    calls = _routes(monkeypatch)
    qmatmul.q_matmul(torch.from_numpy(_x(2, 256, seed=3)), qt)
    assert calls == [route]


@pytest.mark.parametrize("b,route", [(1, "qmm_packed_q8x"), (64, "qmm_packed_q8x"),
                                     (129, "qmm_packed")])
def test_q8x_takes_q3_k(monkeypatch, b, route):
    """q3_K (packed, no bias, zero 4, 16-groups) takes K7 under QMM_Q8X up to
    its row cap, as q4_0 does, with its own zero and group size."""
    monkeypatch.setenv("QMM_Q8X", "1")
    monkeypatch.delenv("QMM_Q8X_MAX_B", raising=False)
    w = (np.random.default_rng(1).standard_normal((128, 512)) * 0.05).astype(np.float32)
    qt = QTensor.quantize(w, GGMLType.Q3_K, device="cpu")
    assert (qt.pack_zero, qt.gsize, qt.gbias_t) == (4, 16, None)
    calls = _routes(monkeypatch)
    x = torch.from_numpy(_x(b, 512, seed=b))
    out = qmatmul.q_matmul(x, qt)
    assert calls == [route]
    if route == "qmm_packed_q8x":
        assert torch.equal(out, qmm.qmm_packed_q8x_plain(x, qt.levels_t, qt.gscale_t,
                                                         zero=4, gsize=16))


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("m") / "llama.ggjt")
    make_llama_ggjt(p)
    return p


@pytest.fixture(scope="module")
def path256(tmp_path_factory):
    """A q4_0 LLaMA whose every matmul lies inside the kernels' gate (N % 128
    == 0, K % 256 == 0): n_embd 256, n_ff 768, a 512-entry vocabulary."""
    p = str(tmp_path_factory.mktemp("m256") / "llama.ggjt")
    make_llama_ggjt(p, n_embd=256, n_mult=256, n_head=2)
    return p


PROMPT = [1, 5, 10, 42, 7, 9]


def _steps(ctx, seq):
    return [ctx.eval(np.asarray([toks])) for toks in seq]


def _port(path, mode):
    gf = read_ggjt(path)
    cfg = dataclasses.replace(config_from_ggjt(gf, n_ctx=256), compute_dtype=mode)
    return cfg, load_transformer(gf, cfg, device="cpu")


@pytest.mark.parametrize("qtype", ["Q8_0", "Q4_1"])
def test_ref_int8_model_matches_jax(tmp_path, qtype):
    """compute_dtype="ref_int8" with an f32 cache: both packages quantize the
    activations and take exact integer dots; logits within 1e-4 of their
    scale, and the same 16 greedy tokens.  Not on the q4_0 fixture: there a
    token's rms-normed q4_0 embedding group puts every level of +-4 exactly
    on a q8 tie (x/d = 127 * 4/8 = 63.5), so the last ulp of rms_norm's
    rsqrt, which differs between XLA and PyTorch, decides the rounding
    (test_ref_int8_q4_0_ties_follow_rms_norm_ulps)."""
    path = str(tmp_path / f"{qtype}.ggjt")
    make_llama_ggjt(path, qtype=JaxGGMLType[qtype])
    gf = jax_read_ggjt(path)
    jcfg = dataclasses.replace(jax_config(gf, n_ctx=256), compute_dtype="ref_int8")
    jp = jax_load(gf, jcfg)
    tcfg, tp = _port(path, "ref_int8")
    seq = [PROMPT, [3], [100], [200]]
    jl = _steps(JaxContext(jcfg, jp, n_ctx=256, cache_dtype=jnp.float32), seq)
    tl = _steps(Context(tcfg, tp, n_ctx=256, cache_dtype=torch.float32, device="cpu"), seq)
    for a, b in zip(jl, tl):
        assert np.abs(b - a).max() <= 1e-4 * np.abs(a).max()
    jt = list(jax_generate(JaxContext(jcfg, jp, n_ctx=256, cache_dtype=jnp.float32),
                           PROMPT, JaxGenerateParams(sampling=JaxSampling(temp=0.0),
                                                     n_predict=16, ignore_eos=True)))
    tt = list(generate(Context(tcfg, tp, n_ctx=256, cache_dtype=torch.float32,
                               device="cpu"),
                       PROMPT, GenerateParams(sampling=SamplingParams(temp=0.0),
                                              n_predict=16, ignore_eos=True)))
    assert tt == jt and len(tt) == 16


def test_ref_int8_q4_0_ties_follow_rms_norm_ulps(path):
    """Why the cross-package ref_int8 test avoids q4_0 embeddings: for token
    100 of the q4_0 fixture, the first matmul's q8 input (the rms-normed
    embedding row) holds exact ties, and the port's and JAX's rms_norm,
    which agree to 1e-6, round some of them apart."""
    from llama_cpp_q_4_0_tpu.ops import layers as jl
    from llama_cpp_q_4_0_tpu.ops import qmatmul as jq
    from llama_cpp_q_4_0_tpu_torch.ops import layers as tl

    cfg, tp = _port(path, "ref_int8")
    e = tp.tok_embeddings.rows(torch.tensor([[100]]))[0]
    w = tp.blocks[0].attn_norm_w
    xt = tl.rms_norm(e, w, cfg.norm_eps)
    xj = np.asarray(jl.rms_norm(jnp.asarray(e.numpy()), jnp.asarray(w.numpy()),
                                cfg.norm_eps))
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-6, atol=0)
    qt, _ = qmatmul._quantize_row_q8_0(xt, 32, f16_d=True)
    qj, _ = jq._quantize_row_q8_0(jnp.asarray(xj), 32, True)
    qj = np.asarray(qj).reshape(qt.shape)
    lv = tp.tok_embeddings.rows(torch.tensor([[100]]))[0] / tp.tok_embeddings.gscale_full()[
        :, 100].repeat_interleave(32)
    ties = (lv.abs() == 4).numpy().reshape(qt.shape)  # x/d lands on +-63.5
    flips = qt.numpy() != qj
    assert flips.any() and (flips <= ties).all()
    # fed the same input, the two quantizers agree exactly
    qj_same, _ = jq._quantize_row_q8_0(jnp.asarray(xt.numpy()), 32, True)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj_same).reshape(qt.shape))


def test_q8x_model_equals_ref_int8(path256, monkeypatch):
    """bf16 compute with QMM_Q8X=1 sends every q4_0 matmul of a prompt of at
    most 128 tokens (and every decode step) through K7, whose arithmetic is
    ref_int8's in another summation order: logits within 1e-4 of their
    scale.  The fixture's matmuls all lie inside the kernels' gate: outside
    it the dispatch takes the bf16 product, as the JAX package does."""
    monkeypatch.setenv("QMM_Q8X", "1")
    rng = np.random.default_rng(4)
    seq = [PROMPT, [3], rng.integers(3, 500, 100).tolist(), [7]]
    ref = _steps(Context(*_port(path256, "ref_int8"), n_ctx=256, cache_dtype=torch.float32,
                         device="cpu"), seq)
    before = qmm.launches["qmm_q8x"]
    calls = _routes(monkeypatch)
    got = _steps(Context(*_port(path256, "bfloat16"), n_ctx=256, cache_dtype=torch.float32,
                         device="cpu"), seq)
    assert set(calls) == {"qmm_packed_q8x"}
    assert qmm.launches["qmm_q8x"] == before  # the plain version on the CPU
    drift = max(float(np.abs(b - a).max() / np.abs(a).max()) for a, b in zip(ref, got))
    assert drift <= 1e-4, drift


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 8, 33, 64, 128, 512, 2048])
def test_q8x_kernel_matches_plain_on_card(b):
    """On the card: the quantizer bit for bit, the matmul (the decode form up
    to 32 rows, the shared tile's q8 mode above) within 1e-4 of the output
    scale (f32 summation order only), two launches bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    _, packed, scales = _weight(4096, 11008, seed=b)
    x = torch.from_numpy(_x(b, 11008, seed=b)).cuda()
    p, s = torch.from_numpy(packed).cuda(), torch.from_numpy(scales).cuda()
    xq, d = qmm.quantize_q8x(x)
    pq, pd = qmm.quantize_q8x_plain(x)
    got, want = qmm.qmm_packed_q8x(x, p, s), qmm.qmm_packed_q8x_plain(x, p, s)
    again = qmm.qmm_packed_q8x(x, p, s)
    torch.cuda.synchronize()
    assert torch.equal(xq, pq) and torch.equal(d, pd)
    assert torch.equal(got, again)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 8, 33, 64, 128, 512, 2048])
@pytest.mark.parametrize("zero", [4, 3])
def test_q8x_16_groups_kernel_matches_plain_on_card(b, zero):
    """On the card, the q3_K layout (16-groups): the quantizer bit for bit,
    the matmul within 1e-4 of the output scale, two launches bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    packed, scales = _q3_k_weight(4096, 4096, zero, seed=b)
    x = torch.from_numpy(_x(b, 4096, seed=b)).cuda()
    p, s = torch.from_numpy(packed).cuda(), torch.from_numpy(scales).cuda()
    xq, d = qmm.quantize_q8x(x, 16)
    pq, pd = qmm.quantize_q8x_plain(x, 16)
    kw = {"zero": zero, "gsize": 16}
    got, again = qmm.qmm_packed_q8x(x, p, s, **kw), qmm.qmm_packed_q8x(x, p, s, **kw)
    want = qmm.qmm_packed_q8x_plain(x, p, s, **kw)
    torch.cuda.synchronize()
    assert torch.equal(xq, pq) and torch.equal(d, pd)
    assert torch.equal(got, again)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


# ------------------------------------------ K7's prefill form on the shared tile

@pytest.mark.parametrize("case", ["max_pos", "max_neg", "mixed_extremes", "random"])
def test_bf16_integer_group_dot_is_exact(case):
    """The tile's q8 mode feeds xq and the levels nib - 8 to bf16 wgmma with
    f32 accumulators: both are exact in bf16 (|xq| <= 127, |level| <= 8),
    each product below 2^10 and every partial sum of a 32-group below 2^15,
    so the f32 sum is the int32 dot exactly in any order (limit: 0)."""
    rng = np.random.default_rng(len(case))
    if case == "max_pos":
        xq = np.full((64, 32), 127)
        lv = np.full((64, 32), 7)
    elif case == "max_neg":
        xq = np.full((64, 32), -127)
        lv = np.full((64, 32), -8)
    elif case == "mixed_extremes":
        xq = rng.choice([-127, 127], (64, 32))
        lv = rng.choice([-8, 7], (64, 32))
    else:
        xq = rng.integers(-127, 128, (4096, 32))
        lv = rng.integers(-8, 8, (4096, 32))
    want = (xq.astype(np.int64) * lv).sum(-1)
    xb = torch.from_numpy(xq).to(torch.bfloat16)
    lb = torch.from_numpy(lv).to(torch.bfloat16)
    assert torch.equal(xb.to(torch.int64), torch.from_numpy(xq))  # exact in bf16
    prods = xb.float() * lb.float()
    for order in (np.arange(32), np.arange(32)[::-1].copy(), rng.permutation(32)):
        acc = torch.zeros(xq.shape[0], dtype=torch.float32)
        for j in order:
            acc = acc + prods[:, j]
        np.testing.assert_array_equal(acc.numpy().astype(np.int64), want)


@pytest.mark.parametrize("k", [256, 1024, 704])
def test_q8x_tile_prep_16_groups_orders_four_groups_a_step(k):
    """At 16-groups a tile step holds four groups: xa is laid out as at
    32-groups, and dx holds the step's two low-panel groups' d, then its two
    high-panel groups', bit for bit the quantizer's."""
    x = torch.from_numpy(_tie_rows(k))
    xq, d = qmm.quantize_q8x_plain(x, 16)
    xa, dx = qmm.q8x_tile_prep_plain(x, 16)
    b, steps = 3, k // 64
    assert tuple(dx.shape) == (b, k // 16)
    st = dx.reshape(b, steps, 4)
    got_d = torch.cat([st[:, :, 0:2].reshape(b, -1), st[:, :, 2:4].reshape(b, -1)], 1)
    np.testing.assert_array_equal(got_d.numpy().view(np.uint32), d.numpy().view(np.uint32))
    steps_q = xa.float().reshape(b, steps, 2, 32)
    got_q = torch.cat([steps_q[:, :, 0], steps_q[:, :, 1]], 1).reshape(b, k).to(torch.int8)
    assert torch.equal(got_q, xq)


@pytest.mark.parametrize("k", [256, 1024, 704])
def test_q8x_tile_prep_layout_unpacks_to_the_quantizer(k):
    """The q8 tile's prep layout (xa bf16 in the nibble order, dx a step's
    two d side by side) unpacks to quantize_q8x_plain's xq and d bit for bit."""
    x = torch.from_numpy(_tie_rows(k))
    xq, d = qmm.quantize_q8x_plain(x)
    xa, dx = qmm.q8x_tile_prep_plain(x)
    b, g2 = 3, k // 64
    assert xa.dtype == torch.bfloat16 and tuple(xa.shape) == (b, k)
    assert dx.dtype == torch.float32 and tuple(dx.shape) == (b, k // 32)
    steps = xa.float().reshape(b, g2, 2, 32)
    assert torch.equal(steps, steps.round())  # integers, exact in bf16
    got_q = torch.cat([steps[:, :, 0], steps[:, :, 1]], 1).reshape(b, k).to(torch.int8)
    assert torch.equal(got_q, xq)
    got_d = torch.cat([dx.reshape(b, g2, 2)[:, :, 0], dx.reshape(b, g2, 2)[:, :, 1]], 1)
    np.testing.assert_array_equal(got_d.numpy().view(np.uint32), d.numpy().view(np.uint32))
    # step v's columns are the low panel's group v, then the high panel's
    np.testing.assert_array_equal(xa[:, 32:64].float().numpy(), xq[:, k // 2:k // 2 + 32].float().numpy())


SHAPES_7B = [(12288, 4096), (4096, 4096), (22016, 4096), (4096, 11008), (32000, 4096)]


@pytest.mark.parametrize("b", [33, 64, 128, 512, 2048])
@pytest.mark.parametrize("n,k", SHAPES_7B)
def test_tile_plan_q8_is_well_formed(b, n, k):
    """K7's plan at every 7B shape and prefill row count: a q8 unit height
    (one m64 tile per consumer warpgroup) that is not mostly padding, K splits
    of at least 4 steps and at most TILE_SPLITS, K/64 steps and no seed."""
    plan = qmm.tile_plan(b, k, n, 32, packed=True, bias=False, sms=132, q8=True)
    assert plan.bm in qmm.TILE_ROWS_Q8 and (plan.bm == 64 or plan.bm // 2 < b)
    assert plan.steps == k // 64 and plan.ka == k
    assert plan.splits in qmm.TILE_SPLITS
    assert plan.splits == 1 or plan.steps // plan.splits >= 4
    units = -(-b // plan.bm) * -(-n // qmm.TILE_N) * plan.splits
    assert units >= 1


@pytest.mark.parametrize("b", [33, 512])
def test_q8x_tile_scratch_matches_the_plan(monkeypatch, b):
    """The wrapper's scratch for K7's tile: bf16 x of width K (no seed) and
    partial sums only when K is split (shapes a CUDA call would get)."""
    monkeypatch.setattr(qmm, "_sm_count", lambda index: 132)
    x = torch.zeros((b, 4096))
    plan, xa, partial = qmm._tile_scratch(x, 4096, 32, packed=True, bias=False, q8=True)
    assert xa.dtype == torch.bfloat16 and tuple(xa.shape) == (b, 4096)
    assert (partial is None) == (plan.splits == 1)
    if partial is not None:
        assert tuple(partial.shape) == (plan.splits, b, 4096)
