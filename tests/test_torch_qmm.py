"""Quantized matmuls: the port's plain kernel versions against the JAX
package's Pallas kernels in interpret mode, and the routing by layout and row
count."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_q_4_0_tpu.ops.pallas.qmm import qmm_packed as jax_qmm_packed
from llama_cpp_q_4_0_tpu.quant.registry import quantize_bytes
from llama_cpp_q_4_0_tpu.quant.types import GGMLType as JaxGGMLType
from llama_cpp_q_4_0_tpu_torch.ops import qmatmul, qmm
from llama_cpp_q_4_0_tpu_torch.ops.qtensor import QTensor
from llama_cpp_q_4_0_tpu_torch.quant.q4_0 import pack_q4_0
from llama_cpp_q_4_0_tpu_torch.quant.types import GGMLType


# small shapes: one intra-op thread keeps the suite's parallel workers from
# oversubscribing the cores
torch.set_num_threads(1)


def _weight(n, k, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    packed, scales = pack_q4_0(quantize_bytes(w, JaxGGMLType.Q4_0), n, k)
    return packed, scales


def _x(b, k, seed):
    return (np.random.default_rng(seed).standard_normal((b, k))
            * 0.5).astype(np.float32)


# (B, K, N): K = 704 and 11008 have K/2 (352, 5504) off a multiple of 256, so
# the packed rows carry zero padding up to K2P (512, 5632)
CASES = [(1, 1024, 256), (8, 704, 128), (32, 11008, 128), (33, 1024, 256),
         (64, 704, 384)]


@pytest.mark.parametrize("kfold", [False, True], ids=["prefill", "kfold"])
@pytest.mark.parametrize("b,k,n", CASES)
def test_plain_matches_pallas_interpret(b, k, n, kfold):
    """Both sides round the same weights and x to bf16, so every product is
    the same exact f32 value: only the f32 summation order differs.  The
    tolerance is that noise: 2e-6 of the output scale."""
    packed, scales = _weight(n, k, seed=b + k)
    x = _x(b, k, seed=n)
    k2p = packed.shape[0]
    want = np.asarray(jax_qmm_packed(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales), None,
        gsize=32, zero=8, block_n=128, block_k=k2p, kfold=kfold,
        interpret=True))
    plain = qmm.qmm_packed_kfold_plain if kfold else qmm.qmm_packed_plain
    got = plain(torch.from_numpy(x), torch.from_numpy(packed),
                torch.from_numpy(scales)).numpy()
    assert got.shape == (b, n)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-6 * np.abs(want).max())


def test_wrappers_take_the_plain_version_on_cpu():
    packed, scales = _weight(128, 704, seed=3)
    x = torch.from_numpy(_x(4, 704, seed=4))
    p, s = torch.from_numpy(packed), torch.from_numpy(scales)
    before = dict(qmm.launches)
    assert torch.equal(qmm.qmm_packed(x, p, s), qmm.qmm_packed_plain(x, p, s))
    assert torch.equal(qmm.qmm_packed_kfold(x, p, s),
                       qmm.qmm_packed_kfold_plain(x, p, s))
    assert qmm.launches == before  # no kernel launched on the CPU
    with pytest.raises(TypeError):
        qmm.qmm_packed(x.double(), p, s)
    with pytest.raises(ValueError):  # K/2 beyond the packed rows
        qmm.qmm_packed(torch.zeros(4, 1088), p, s)


@pytest.mark.parametrize("b,kfold", [(1, True), (32, True), (33, False),
                                     (64, False)])
def test_routing_by_row_count(monkeypatch, b, kfold):
    """bf16 calls of <= 32 rows (B*T) take the kfold kernel, larger ones the
    prefill kernel; f32 compute never reaches either."""
    packed, scales = _weight(128, 256, seed=b)
    w = QTensor(levels_t=torch.from_numpy(packed),
                gscale_t=torch.from_numpy(scales), gsize=32,
                qtype=GGMLType.Q4_0, shape=(128, 256), pack_zero=8)
    calls = []
    for name in ("qmm_packed", "qmm_packed_kfold"):
        orig = getattr(qmatmul, name)
        monkeypatch.setattr(qmatmul, name,
                            lambda *a, _n=name, _o=orig, **kw: calls.append(_n)
                            or _o(*a, **kw))
    x = torch.from_numpy(_x(b, 256, seed=1)).reshape(1, b, 256)
    out = qmatmul.q_matmul(x, w)
    assert out.shape == (1, b, 128)
    assert calls == ["qmm_packed_kfold" if kfold else "qmm_packed"]
    calls.clear()
    ref = x.reshape(b, 256) @ w.dequantize_t()
    f32 = qmatmul.q_matmul(x, w, compute_dtype=torch.float32).reshape(b, 128)
    assert calls == []
    torch.testing.assert_close(f32, ref, rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 8, 32, 33, 64, 200, 512, 2048])
def test_kernels_match_plain_on_card(b):
    """On the card: each kernel against its plain version (f32 summation-order
    noise; tensor-core accumulation differs from the f32 matmul), K = 11008
    (172 steps of the prefill tile, split unevenly where the plan splits);
    the prefill tile's two launches bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    packed, scales = _weight(4096, 11008, seed=b)
    x = torch.from_numpy(_x(b, 11008, seed=b)).cuda()
    p, s = torch.from_numpy(packed).cuda(), torch.from_numpy(scales).cuda()
    kern, plain = ((qmm.qmm_packed_kfold, qmm.qmm_packed_kfold_plain)
                   if b <= 32 else (qmm.qmm_packed, qmm.qmm_packed_plain))
    got, again, want = kern(x, p, s), kern(x, p, s), plain(x, p, s)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-3 * want.abs().max().item()
    assert torch.equal(got, again)


# ---------------------------------------------------------------- K5, K6, K6b

from llama_cpp_q_4_0_tpu.ops import qmatmul as jax_qmatmul  # noqa: E402
from llama_cpp_q_4_0_tpu.ops.pallas.qmm import qmm as jax_qmm  # noqa: E402
from llama_cpp_q_4_0_tpu.ops.qtensor import QTensor as JaxQTensor  # noqa: E402
from llama_cpp_q_4_0_tpu.quant.pack import pack_planar as jax_pack_planar  # noqa: E402
from llama_cpp_q_4_0_tpu.quant.registry import quantize  # noqa: E402
from llama_cpp_q_4_0_tpu_torch.quant.pack import pack_planar  # noqa: E402
from llama_cpp_q_4_0_tpu_torch.quant.types import type_traits  # noqa: E402


def _planes(rng, shape, lo, hi):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _packed_affine(n, k, gsize, zero, seed):
    """Random split-half nibbles with scale and bias planes, padding zero:
    the layout of q4_K (zero 0, 32-groups) and q2_K (16-groups)."""
    rng = np.random.default_rng(seed)
    k2 = k // 2
    k2p = -(-k2 // 256) * 256
    g2, g2p = k2 // gsize, k2p // gsize
    packed = np.zeros((k2p, n), np.uint8)
    packed[:k2] = rng.integers(0, 256, (k2, n), dtype=np.uint8)
    scales = np.zeros((2, g2p, n), np.float32)
    bias = np.zeros((2, g2p, n), np.float32)
    scales[:, :g2] = _planes(rng, (2, g2, n), 0.005, 0.015)
    bias[:, :g2] = _planes(rng, (2, g2, n), -0.08, 0.0)
    return packed, scales, bias


def _int8_weight(n, k, gsize, seed, lo=-32, hi=31):
    rng = np.random.default_rng(seed)
    levels = rng.integers(lo, hi + 1, (k, n), dtype=np.int8)
    scales = _planes(rng, (k // gsize, n), 0.0005, 0.0015)
    bias = _planes(rng, (k // gsize, n), -0.08, 0.0)
    return levels, scales, bias


ROWS = [1, 8, 33, 64]


@pytest.mark.parametrize("b", ROWS)
@pytest.mark.parametrize("gsize,zero,k", [(32, 0, 768), (16, 0, 512), (32, 3, 512),
                                          (16, -1, 768)])
def test_packed_bias_plain_matches_pallas_interpret(b, gsize, zero, k):
    """K5's plain version against _qmm_packed_bias_kernel in interpret mode.
    The same bf16-rounded products and the same f32 seed: only the f32
    summation order differs, 2e-6 of the output scale.  K = 768 pads K/2 =
    384 up to 512 packed rows."""
    n = 128
    packed, scales, bias = _packed_affine(n, k, gsize, zero, seed=b + k + gsize)
    x = _x(b, k, seed=b)
    k2p = packed.shape[0]
    want = np.asarray(jax_qmm_packed(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales), jnp.asarray(bias),
        gsize=gsize, zero=zero, block_n=n, block_k=k2p, interpret=True))
    t = torch.from_numpy
    got = qmm.qmm_packed_bias_plain(t(x), t(packed), t(scales), t(bias), zero=zero,
                                    gsize=gsize).numpy()
    assert got.shape == (b, n)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("b", ROWS)
@pytest.mark.parametrize("gsize", [16, 32])
@pytest.mark.parametrize("bias", [False, True], ids=["K6", "K6b"])
def test_int8_plain_matches_pallas_interpret(b, gsize, bias):
    """K6 (_qmm_kernel) and K6b (_qmm_bias_kernel) plain versions against the
    Pallas kernels in interpret mode, 2e-6 of the output scale (summation
    order only)."""
    n, k = 256, 768
    levels, scales, gbias = _int8_weight(n, k, gsize, seed=b + gsize)
    x = _x(b, k, seed=b + 1)
    want = np.asarray(jax_qmm(
        jnp.asarray(x), jnp.asarray(levels), jnp.asarray(scales),
        jnp.asarray(gbias) if bias else None, gsize=gsize, block_n=n, block_k=k,
        interpret=True))
    t = torch.from_numpy
    if bias:
        got = qmm.qmm_int8_bias_plain(t(x), t(levels), t(scales), t(gbias),
                                      gsize=gsize)
    else:
        got = qmm.qmm_int8_plain(t(x), t(levels), t(scales), gsize=gsize)
    assert got.shape == (b, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2e-6 * np.abs(want).max())


def _layouts(n, k, seed):
    """One weight of each layout, as (port QTensor, JAX QTensor): q4_0
    (packed, no bias), q4_K (packed with bias), q6_K (int8), q5_K (int8 with
    bias)."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    out = {}
    for name in ("Q4_0", "Q4_K", "Q6_K", "Q5_K"):
        blocks = quantize(w, JaxGGMLType[name])
        mine = np.frombuffer(blocks.tobytes(),
                             dtype=type_traits(GGMLType[name]).block_dtype)
        out[name] = (QTensor.from_planar(pack_planar(mine, GGMLType[name], (n, k)),
                                         device="cpu"),
                     JaxQTensor.from_planar(jax_pack_planar(
                         blocks, JaxGGMLType[name], (n, k))))
    return out


_JAX_KERNEL = {("qmm_packed", False, False): "qmm_packed",
               ("qmm_packed", True, False): "qmm_packed_kfold",
               ("qmm_packed", False, True): "qmm_packed_bias",
               ("qmm", False, False): "qmm_int8",
               ("qmm", False, True): "qmm_int8_bias"}


@pytest.mark.parametrize("b", [1, 8, 32, 33, 64])
def test_routing_matches_jax_dispatch(monkeypatch, b):
    """For each layout and row count the port calls the kernel that the JAX
    dispatch's default TPU route calls (recorded, not run)."""
    n, k = 128, 512
    x = _x(b, k, seed=b)
    for name, (w, jw) in _layouts(n, k, seed=1).items():
        jax_calls, calls = [], []

        def rec_packed(x2, lv, gs, gb=None, **kw):
            jax_calls.append(("qmm_packed", bool(kw.get("kfold")), gb is not None))
            return jnp.zeros((x2.shape[0], lv.shape[1]), jnp.float32)

        def rec_qmm(x2, lv, gs, gb=None, **kw):
            jax_calls.append(("qmm", False, gb is not None))
            return jnp.zeros((x2.shape[0], lv.shape[1]), jnp.float32)

        monkeypatch.setattr(jax_qmatmul, "qmm_packed", rec_packed)
        monkeypatch.setattr(jax_qmatmul, "qmm", rec_qmm)
        jax_qmatmul.q_matmul(jnp.asarray(x), jw, use_pallas=True)
        for fn in _JAX_KERNEL.values():
            orig = getattr(qmatmul, fn)
            monkeypatch.setattr(qmatmul, fn,
                                lambda *a, _n=fn, _o=orig, **kw: calls.append(_n)
                                or _o(*a, **kw))
        qmatmul.q_matmul(torch.from_numpy(x), w)
        assert len(jax_calls) == 1, name
        assert calls == [_JAX_KERNEL[jax_calls[0]]], (name, b, calls, jax_calls)
        monkeypatch.undo()


@pytest.mark.parametrize("zero,gsize", [(7, 32), (4, 16), (8, 16)])
@pytest.mark.parametrize("b", [1, 64])
def test_other_pack_zero_raises_on_q4_0_route(zero, gsize, b):
    """A packed weight without a bias whose zero or group size is not q4_0's
    raises on the K1/K2 route instead of being computed as q4_0."""
    packed, scales = _weight(128, 512, seed=2)
    g2p = packed.shape[0] // gsize
    w = QTensor(levels_t=torch.from_numpy(packed),
                gscale_t=torch.zeros((2, g2p, 128)), gsize=gsize,
                qtype=GGMLType.Q3_K, shape=(128, 512), pack_zero=zero)
    x = torch.from_numpy(_x(b, 512, seed=3))
    with pytest.raises(NotImplementedError, match="zero 8 and 32-groups"):
        qmatmul.q_matmul(x, w)
    assert not qmatmul.use_kfold(1, dataclasses.replace(
        w, gbias_t=torch.zeros_like(w.gscale_t)))


def test_q3_k_file_raises_at_load(tmp_path):
    """q3_K packs as symmetric nibbles (zero 4, 16-groups), which K1/K2 do
    not take: loading such a file raises and names the tensor's type."""
    from llama_cpp_q_4_0_tpu.formats.fixtures import make_llama_ggjt

    from llama_cpp_q_4_0_tpu_torch.formats.ggjt import read_ggjt
    from llama_cpp_q_4_0_tpu_torch.models.loading import (config_from_ggjt,
                                                          load_transformer)

    path = str(tmp_path / "q3k.ggjt")
    make_llama_ggjt(path, n_embd=256, n_mult=256, n_head=2, n_vocab=256,
                    n_layer=1, qtype=JaxGGMLType.Q3_K)
    gf = read_ggjt(path)
    with pytest.raises(NotImplementedError, match="Q3_K packs with zero 4"):
        load_transformer(gf, config_from_ggjt(gf), device="cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 8, 33, 64, 200, 512, 2048])
@pytest.mark.parametrize("gsize", [16, 32])
@pytest.mark.parametrize("zero", [0, 8])
def test_affine_and_int8_kernels_match_plain_on_card(b, gsize, zero):
    """On the card: K5, K6 and K6b against their plain versions at a 7B
    shape, on 16-groups (q2_K; q6_K) and 32-groups (q4_K, q4_1; q5_0, q8_0,
    q5_K), K5 with pack zero 0 and 8, f32 summation-order noise as K1/K2's
    check; above 32 rows two launches bit-identical (the fused seed and the
    K splits add in a fixed order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    n, k = 4096, 11008
    t = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    x = t(_x(b, k, seed=b))
    packed, scales, bias = _packed_affine(n, k, gsize, zero, seed=b)
    levels, iscales, ibias = _int8_weight(n, k, gsize, seed=b)
    calls = [
        (lambda: qmm.qmm_packed_bias(x, t(packed), t(scales), t(bias), zero=zero,
                                     gsize=gsize),
         qmm.qmm_packed_bias_plain(x, t(packed), t(scales), t(bias), zero=zero,
                                   gsize=gsize)),
        (lambda: qmm.qmm_int8(x, t(levels), t(iscales), gsize=gsize),
         qmm.qmm_int8_plain(x, t(levels), t(iscales), gsize=gsize)),
        (lambda: qmm.qmm_int8_bias(x, t(levels), t(iscales), t(ibias), gsize=gsize),
         qmm.qmm_int8_bias_plain(x, t(levels), t(iscales), t(ibias), gsize=gsize)),
    ]
    for kern, want in calls:
        got, again = kern(), kern()
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= 1e-3 * want.abs().max().item()
        if b > qmm.GEMV_MAX_ROWS:
            assert torch.equal(got, again)


# ------------------------------------------------- the prefill tile's plan

SHAPES_7B = [(12288, 4096), (4096, 4096), (22016, 4096), (4096, 11008),
             (32000, 4096)]


@pytest.mark.parametrize("b", [33, 64, 128, 200, 512, 2048])
@pytest.mark.parametrize("n,k", SHAPES_7B)
@pytest.mark.parametrize("packed,bias,gsize", [(True, False, 32), (True, True, 32),
                                               (True, True, 16), (False, False, 16),
                                               (False, True, 32)])
def test_tile_plan_is_well_formed(b, n, k, packed, bias, gsize):
    """The plan of every 7B shape and prefill row count: a compiled unit
    height that is not mostly padding, K splits of at least 4 steps, and the
    step count and bf16 scratch width the kernel checks against (K/64 main
    steps plus one seed step per 16 groups of each plane)."""
    plan = qmm.tile_plan(b, k, n, gsize, packed=packed, bias=bias, sms=132)
    planes = 2 if packed else 1
    seed = planes * -(-(k // planes // gsize) // 16) if bias else 0
    assert plan.steps == k // 64 + seed
    assert plan.ka == k + 64 * seed
    assert plan.bm in qmm.TILE_ROWS and (plan.bm == 64 or plan.bm // 2 < b)
    assert plan.splits in qmm.TILE_SPLITS
    assert plan.splits == 1 or plan.steps // plan.splits >= 4


@pytest.mark.parametrize("b,n,k,want", [
    (512, 32000, 4096, (256, 1)), (512, 4096, 11008, (256, 2)),
    (512, 4096, 4096, (128, 1)), (128, 4096, 4096, (128, 4)),
    (128, 12288, 4096, (128, 1)), (64, 4096, 11008, (64, 4)),
    (2048, 4096, 4096, (256, 1))])
def test_tile_plan_picks_the_measured_best(b, n, k, want):
    """Plans the cost model picks where the sweep that fitted it measured
    them fastest (q4_0, H100 80GB HBM3 at 700 W)."""
    plan = qmm.tile_plan(b, k, n, 32, packed=True, bias=False, sms=132)
    assert (plan.bm, plan.splits) == want


def test_tile_scratch_matches_the_plan(monkeypatch):
    """The wrapper's scratch for a tile call: bf16 x of the plan's width and
    partial sums only when K is split (on the CPU the wrappers never build
    it; the shapes are the ones a CUDA call would get)."""
    monkeypatch.setattr(qmm, "_sm_count", lambda index: 132)
    x = torch.zeros((128, 4096))
    plan, xa, partial = qmm._tile_scratch(x, 4096, 32, packed=False, bias=True)
    assert xa.dtype == torch.bfloat16 and tuple(xa.shape) == (128, plan.ka)
    assert plan.ka == 4096 + 64 * 8
    assert (partial is None) == (plan.splits == 1)
    if partial is not None:
        assert tuple(partial.shape) == (plan.splits, 128, 4096)
