"""The decode GEMV of K2, K5, K6 and K6b (csrc/qmm_common.cuh gemv_kernel):
its K-split plan, the scratch its wrappers allocate (none: the splits are
reduced inside the kernel; K7's GEMV keeps its partial sums), and the plain
versions the card holds it to at the rows and shapes the redesign added
(b = 3 and 17, a ragged N = 4224), against the Pallas kernels in interpret
mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_q_4_0_tpu.ops.pallas.qmm import qmm as jax_qmm
from llama_cpp_q_4_0_tpu.ops.pallas.qmm import qmm_packed as jax_qmm_packed
from llama_cpp_q_4_0_tpu_torch.ops import qmm

torch.set_num_threads(1)

# (N, K) of the 7B matmuls (wqkv, wo, w_gateup, w_down, output; Q3_K_M's wq
# and gate/up are among them), the ragged N and uneven K
SHAPES = [(12288, 4096), (4096, 4096), (22016, 4096), (4096, 11008), (32000, 4096),
          (4224, 4096), (4096, 8640), (128, 256), (256, 64 * 7)]


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "packed"])
@pytest.mark.parametrize("n,k", SHAPES)
@pytest.mark.parametrize("clusters", [qmm.H100_GEMV_CLUSTERS,
                                      {s: max(1, 20 // s) for s in range(1, 9)}],
                         ids=["h100", "small-card"])
def test_gemv_plan_covers_every_step_once(n, k, packed, clusters):
    """Every 32-row step of the weight lies in exactly one split, in order;
    every split has at least one step; at most GEMV_MAX_SPLITS splits (the
    portable cluster size)."""
    plan = qmm.gemv_plan(k, n, packed, clusters=clusters)
    assert plan.steps == (k // 64 if packed else k // 32)
    assert 1 <= plan.splits <= qmm.GEMV_MAX_SPLITS
    ranges = plan.ranges()
    assert len(ranges) == plan.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.steps
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0
    assert all(t1 > t0 for t0, t1 in ranges)
    assert sorted(t for t0, t1 in ranges for t in range(t0, t1)) == list(range(plan.steps))


@pytest.mark.parametrize("n,k,want", [(4096, 4096, 6), (12288, 4096, 2), (22016, 4096, 4),
                                      (4096, 11008, 6), (32000, 4096, 1)])
@pytest.mark.parametrize("packed", [False, True], ids=["int8", "packed"])
def test_gemv_plan_picks_the_measured_best(n, k, want, packed):
    """The splits the plan picks at the 7B shapes on the H100's cluster
    occupancy: those a sweep of 1..8 splits measured fastest there
    (chip_smoke.py --phases splits)."""
    assert qmm.gemv_plan(k, n, packed).splits == want


def test_gemv_plan_fits_one_wave_where_it_can():
    """With 16 column tiles (N = 4096) the H100 runs 17 clusters of 6 (102
    blocks) but 15 of 8 (120 < 128): 6 splits run in one wave, 8 would take
    two."""
    c = qmm.H100_GEMV_CLUSTERS
    assert 16 * 6 <= c[6] * 6 and 16 * 8 > c[8] * 8
    assert qmm.gemv_plan(4096, 4096, False).splits == 6


class _FakeLib:
    """Records the arguments of each C entry point and returns success."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        if name.endswith("_splits"):
            return lambda k: 3
        return lambda *args: self.calls.setdefault(name, args) and 0


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(qmm, "_lib", lambda source: lib)
    monkeypatch.setattr(qmm, "_stream", lambda x: 0)
    monkeypatch.setattr(qmm, "_sm_count", lambda index: 132)
    monkeypatch.setattr(qmm, "_gemv_clusters", lambda source, index: qmm.H100_GEMV_CLUSTERS)
    monkeypatch.setattr(qmm, "launches", dict(qmm.launches))
    return lib


@pytest.mark.parametrize("b", [1, 3, 17, 32])
def test_decode_forms_take_no_scratch(fake_lib, b):
    """At 32 rows or fewer K2, K5, K6 and K6b pass no scratch and no x
    buffer, only the plan's splits (the tensors here lie on the CPU; the
    shapes and pointers are what a CUDA call gets)."""
    n, k = 4096, 4096
    x = torch.zeros((b, k))
    levels = torch.zeros((k, n), dtype=torch.int8)
    planes = torch.zeros((k // 32, n))
    packed = torch.zeros((k // 2, n), dtype=torch.uint8)
    pplanes = torch.zeros((2, k // 64, n))
    want = qmm.gemv_plan(k, n, False).splits
    qmm._int8(x, levels, planes, planes, 32, "qmm_int8_bias", 0)
    args = fake_lib.calls["qmm_int8"]
    assert args[4] is None and args[5] is None  # scratch, xa
    assert args[11] == 0 and args[12] == want and args[13] == 0  # bm, splits, ka
    qmm._packed_bias(x, packed, pplanes, pplanes, 0, 32, 0)
    args = fake_lib.calls["qmm_packed_bias"]
    assert args[4] is None and args[5] is None and args[14] == want
    qmm._kfold(x, packed, pplanes, 8, 32, 0)
    args = fake_lib.calls["qmm_q4_0_kfold"]
    assert len(args) == 13 and args[10] == want  # no scratch argument at all
    assert qmm.launches["qmm_int8_bias"] == qmm.launches["qmm_packed_bias"] == 1
    assert qmm.launches["qmm_q4_0_kfold"] == 1


def test_k7_and_the_tile_keep_their_partials(fake_lib):
    """K7's decode GEMV still writes [splits, B, N] partial sums for its
    reduce pass; above 32 rows the tile's plan decides (K6b at b = 128)."""
    x = torch.zeros((8, 4096))
    part = qmm._scratch(fake_lib, "qmm_q8x_splits", x, 4096)
    assert tuple(part.shape) == (3, 8, 4096) and part.dtype == torch.float32
    assert qmm._scratch(fake_lib, "qmm_q8x_splits", torch.zeros((33, 4096)), 4096) is None
    plan, xa, scratch = qmm._decode_or_tile(torch.zeros((128, 4096)), 4096, 32,
                                            packed=False, bias=True)
    assert isinstance(plan, qmm.TilePlan) and xa.shape == (128, plan.ka)
    assert (scratch is None) == (plan.splits == 1)


# ------------------------------------------------ plain versions vs Pallas

def _x(b, k, seed):
    return (np.random.default_rng(seed).standard_normal((b, k)) * 0.5).astype(np.float32)


def _packed(n, k, gsize, zero, seed, bias):
    rng = np.random.default_rng(seed)
    k2 = k // 2
    k2p = -(-k2 // 256) * 256
    g2, g2p = k2 // gsize, k2p // gsize
    packed = np.zeros((k2p, n), np.uint8)
    packed[:k2] = rng.integers(0, 256, (k2, n), dtype=np.uint8)
    scales = np.zeros((2, g2p, n), np.float32)
    scales[:, :g2] = rng.uniform(0.005, 0.015, (2, g2, n))
    gbias = None
    if bias:
        gbias = np.zeros((2, g2p, n), np.float32)
        gbias[:, :g2] = rng.uniform(-0.08, 0.0, (2, g2, n))
    return packed, scales, gbias


def _int8(n, k, gsize, seed):
    rng = np.random.default_rng(seed)
    levels = rng.integers(-32, 32, (k, n), dtype=np.int8)
    scales = rng.uniform(0.0005, 0.0015, (k // gsize, n)).astype(np.float32)
    gbias = rng.uniform(-0.08, 0.0, (k // gsize, n)).astype(np.float32)
    return levels, scales, gbias


ROWS = [3, 17]
WIDTHS = [256, 4224]  # 4224 = 33 x 128: inside the JAX gate, half a 256-column tile


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("b", ROWS)
@pytest.mark.parametrize("kernel", ["K2", "K5"])
def test_packed_decode_plain_matches_pallas_interpret(kernel, b, n):
    """K2 (zero folded, q4_0's zero 8) and K5 (affine, zero 0) plain versions
    against _qmm_packed_kfold_kernel and _qmm_packed_bias_kernel in interpret
    mode: the same bf16-rounded products and f32 seed, summation order only
    (2e-6 of the output scale, the limit of the existing K1/K2/K5 tests)."""
    k, gsize = 512, 32
    zero = 8 if kernel == "K2" else 0
    packed, scales, gbias = _packed(n, k, gsize, zero, seed=b + n, bias=kernel == "K5")
    x = _x(b, k, seed=n + b)
    want = np.asarray(jax_qmm_packed(
        jnp.asarray(x), jnp.asarray(packed), jnp.asarray(scales),
        None if gbias is None else jnp.asarray(gbias), gsize=gsize, zero=zero,
        block_n=128, block_k=packed.shape[0], kfold=kernel == "K2", interpret=True))
    t = torch.from_numpy
    if kernel == "K2":
        got = qmm.qmm_packed_kfold_plain(t(x), t(packed), t(scales), zero=zero, gsize=gsize)
    else:
        got = qmm.qmm_packed_bias_plain(t(x), t(packed), t(scales), t(gbias), zero=zero,
                                        gsize=gsize)
    assert got.shape == (b, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("b", ROWS)
@pytest.mark.parametrize("bias", [False, True], ids=["K6", "K6b"])
def test_int8_decode_plain_matches_pallas_interpret(bias, b, n):
    """K6 (16-groups, as q6_K) and K6b (32-groups, as q5_K) plain versions
    against _qmm_kernel and _qmm_bias_kernel in interpret mode, 2e-6 of the
    output scale (summation order only)."""
    k = 512
    gsize = 32 if bias else 16
    levels, scales, gbias = _int8(n, k, gsize, seed=b + n + gsize)
    x = _x(b, k, seed=b + 7)
    want = np.asarray(jax_qmm(
        jnp.asarray(x), jnp.asarray(levels), jnp.asarray(scales),
        jnp.asarray(gbias) if bias else None, gsize=gsize, block_n=128, block_k=k,
        interpret=True))
    t = torch.from_numpy
    got = (qmm.qmm_int8_bias_plain(t(x), t(levels), t(scales), t(gbias), gsize=gsize)
           if bias else qmm.qmm_int8_plain(t(x), t(levels), t(scales), gsize=gsize))
    assert got.shape == (b, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6 * np.abs(want).max())


# ------------------------------------------------------------- on the card

def _forms(n, k, seed):
    """(name, kernel call, plain call, 2-byte twin call, its f32 call) of the
    four decode forms on one random weight each, tensors on the card."""
    c = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    packed, pscales, pbias = _packed(n, k, 32, 0, seed, bias=True)
    levels, iscales, ibias = _int8(n, k, 32, seed)
    p, ps, pb, lv, is_, ib = map(c, (packed, pscales, pbias, levels, iscales, ibias))
    bf = lambda t: t.to(torch.bfloat16)  # noqa: E731
    f16 = lambda t: t.to(torch.float16)  # noqa: E731
    back = lambda t: t.float()  # noqa: E731
    return [
        ("K2", lambda x, s=ps: qmm.qmm_packed_kfold(x, p, s, zero=8, gsize=32),
         lambda x: qmm.qmm_packed_kfold_plain(x, p, ps, zero=8, gsize=32), f16(ps)),
        ("K5", lambda x, s=ps, g=pb: qmm.qmm_packed_bias(x, p, s, g, zero=0, gsize=32),
         lambda x: qmm.qmm_packed_bias_plain(x, p, ps, pb, zero=0, gsize=32), (bf(ps), bf(pb))),
        ("K6", lambda x, s=is_: qmm.qmm_int8(x, lv, s, gsize=32),
         lambda x: qmm.qmm_int8_plain(x, lv, is_, gsize=32), bf(is_)),
        ("K6b", lambda x, s=is_, g=ib: qmm.qmm_int8_bias(x, lv, s, g, gsize=32),
         lambda x: qmm.qmm_int8_bias_plain(x, lv, is_, ib, gsize=32), (bf(is_), bf(ib))),
    ], back


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 3, 17, 32])
@pytest.mark.parametrize("n,k", [(4224, 4096), (4096, 11008)])
def test_decode_forms_on_card(n, k, b):
    """On the card, each decode form: within 1e-3 of its plain version's
    scale, two launches bit-identical, one launch captured in a CUDA graph
    and replayed 10 times bit-identical (the in-kernel reduce leaves no
    state), and on 2-byte planes equal bit for bit to f32 planes holding the
    same values."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    forms, back = _forms(n, k, seed=n + b)
    x = torch.from_numpy(_x(b, k, seed=b)).cuda()
    for name, kern, plain, two in forms:
        got, again, want = kern(x), kern(x), plain(x)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            gout = kern(x)
        replays = []
        for _ in range(10):
            g.replay()
            replays.append(torch.equal(gout, got))
        if isinstance(two, tuple):
            a2, a32 = kern(x, *two), kern(x, *map(back, two))
        else:
            a2, a32 = kern(x, two), kern(x, back(two))
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= 1e-3 * want.abs().max().item(), name
        assert torch.equal(got, again) and all(replays), name
        assert torch.equal(a2, a32), name
