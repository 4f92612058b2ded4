"""The decode GEMV of K2, K5, K6, K6b and K7 (csrc/qmm_common.cuh
gemv_kernel): its K-split plan, the scratch its wrappers allocate (none: the
splits are reduced inside the kernel; the prefill tiles keep their partial
sums), the plain versions the card holds it to at the rows and shapes the
redesign added (b = 3 and 17, a ragged N = 4224) against the Pallas kernels
in interpret mode, and K7's single-group tie rows, on which the card must
equal the plain version bit for bit."""

import unittest.mock as mock

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


@pytest.mark.parametrize("source", ["qmm_int8", "qmm_q4_0", "qmm_q8x"],
                         ids=["int8", "packed", "q8x"])
@pytest.mark.parametrize("n,k", SHAPES)
@pytest.mark.parametrize("clusters", [qmm.H100_GEMV_CLUSTERS,
                                      {s: max(1, 20 // s) for s in range(1, 9)}],
                         ids=["h100", "small-card"])
def test_gemv_plan_covers_every_step_once(n, k, source, clusters):
    """Every 32-row step of the weight lies in exactly one split, in order;
    every split has at least one step; at most GEMV_MAX_SPLITS splits (the
    portable cluster size).  Each body with its own fill cost (K7, q8x, on
    the packed layout)."""
    packed = source != "qmm_int8"
    plan = qmm.gemv_plan(k, n, packed, clusters=clusters, fill=qmm.GEMV_FILL[source])
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


@pytest.mark.parametrize("n,k,want", [(4096, 4096, 8), (12288, 4096, 4), (22016, 4096, 2),
                                      (4096, 11008, 8)])
def test_q8x_plan_picks_the_measured_best(n, k, want):
    """K7's splits at the 7B shapes on the H100's occupancy of its one-row
    form (two blocks an SM) with its own fill: those a sweep measured fastest
    (chip_smoke.py --phases splits; at the 32000-row head 1 and 2 tie)."""
    plan = qmm.gemv_plan(k, n, True, clusters=qmm.H100_Q8X_GEMV_CLUSTERS,
                         fill=qmm.GEMV_FILL["qmm_q8x"])
    assert plan.splits == want


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
        return lambda *args: self.calls.setdefault(name, args) and 0


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(qmm, "_lib", lambda source: lib)
    monkeypatch.setattr(qmm, "_stream", lambda x: 0)
    monkeypatch.setattr(qmm, "_sm_count", lambda index: 132)
    monkeypatch.setattr(qmm, "_gemv_clusters",
                        lambda source, index, rows=1: qmm.H100_GEMV_CLUSTERS)
    monkeypatch.setattr(qmm, "launches", dict(qmm.launches))
    return lib


@pytest.mark.parametrize("b", [1, 3, 17, 32])
def test_decode_forms_take_no_scratch(fake_lib, b):
    """At 32 rows or fewer K2, K5, K6, K6b and K7 pass no scratch and no x
    buffer, only the plan's splits (the tensors here lie on the CPU; the
    shapes and pointers are what a CUDA call gets)."""
    n, k = 4096, 4096
    x = torch.zeros((b, k))
    levels = torch.zeros((k, n), dtype=torch.int8)
    planes = torch.zeros((k // 32, n))
    packed = torch.zeros((k // 2, n), dtype=torch.uint8)
    pplanes = torch.zeros((2, k // 64, n))
    want = qmm.gemv_plan(k, n, False).splits
    want_q8x = qmm.gemv_plan(k, n, True, fill=qmm.GEMV_FILL["qmm_q8x"]).splits
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
    qmm._q8x(x, packed, pplanes, 8, 32, 0)
    args = fake_lib.calls["qmm_q8x"]
    assert args[3] is None and args[4] is None and args[5] is None  # d, partial, xa
    assert args[13] == 0 and args[14] == want_q8x and args[15] == 0  # bm, splits, ka
    assert qmm.launches["qmm_int8_bias"] == qmm.launches["qmm_packed_bias"] == 1
    assert qmm.launches["qmm_q4_0_kfold"] == qmm.launches["qmm_q8x"] == 1


@pytest.mark.parametrize("b", [1, 8, 32])
def test_k7_decode_form_takes_no_scratch(fake_lib, b):
    """K7's decode form is one launch that quantizes x inside the kernel: no
    x levels, no d_x and no partial sums are allocated, at every row count of
    the decode buckets, with the plan of its own occupancy query."""
    n, k = 4096, 11008
    allocated = []
    real_empty = torch.empty
    x, packed = torch.zeros((b, k)), torch.zeros((k // 2, n), dtype=torch.uint8)
    pplanes = torch.zeros((2, k // 64, n))
    with mock.patch.object(qmm.torch, "empty",
                           lambda *a, **kw: allocated.append(a) or real_empty(*a, **kw)):
        qmm._q8x(x, packed, pplanes, 8, 32, 0)
    assert allocated == [((b, n),)]  # the output alone
    args = fake_lib.calls["qmm_q8x"]
    assert args[3:6] == (None, None, None)
    assert args[14] == qmm.gemv_plan(k, n, True, fill=qmm.GEMV_FILL["qmm_q8x"]).splits


def test_k7_and_the_tile_keep_their_partials(fake_lib):
    """Above 32 rows the prefill tiles keep their partial sums where the
    tile's plan splits K: K7's tile (with its d_x and bf16 x scratch) at
    b = 33, and K6b's at b = 128."""
    x = torch.zeros((33, 4096))
    packed, pplanes = torch.zeros((2048, 4096), dtype=torch.uint8), torch.zeros((2, 64, 4096))
    qmm._q8x(x, packed, pplanes, 8, 32, 0)
    args = fake_lib.calls["qmm_q8x"]
    plan = qmm.tile_plan(33, 4096, 4096, 32, packed=True, bias=False, sms=132, q8=True)
    assert args[3] is not None  # d_x [B, K/32] for the prep pass
    assert args[13] == plan.bm and args[14] == plan.splits and args[15] == plan.ka
    assert (args[4] is None) == (plan.splits == 1) and args[5] is not None
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


# ------------------------------------------------ K7's single-group tie rows

def _tie_rows(b, k, gsize, seed):
    """chip_smoke.py's q8x_tie_rows in numpy: row i zero but for group
    7 i + 3 (logical order), 127 and half-integers in (-127, 127)."""
    rng = np.random.default_rng(seed)
    x = np.zeros((b, k), np.float32)
    groups = []
    for i in range(b):
        g = (7 * i + 3) % (k // gsize)
        vals = rng.integers(-127, 127, gsize).astype(np.float32) + 0.5
        vals[i % gsize] = 127.0
        x[i, g * gsize:(g + 1) * gsize] = vals
        groups.append(g)
    return x, groups


@pytest.mark.parametrize("gsize,zero", [(32, 8), (16, 4), (32, 7)])
def test_k7_tie_rows_are_one_term(gsize, zero):
    """On the tie rows K7's plain version gives each column one f32 term,
    float32(dot * 1 * d_w) of its float64 value (d_x = 1 exactly; every
    other group has d_x = 0); so the card, whose order is the same there,
    must equal it bit for bit.  Rounding any one tie toward zero instead of
    away (round-half-even's choice for half of them) changes every column
    whose level at that row is nonzero: the card check sees a wrong tie."""
    n, k, b = 256, 1024, 4
    packed, scales, _ = _packed(n, k, gsize, zero, seed=gsize + zero, bias=False)
    x, groups = _tie_rows(b, k, gsize, seed=zero)
    t = torch.from_numpy
    got = qmm.qmm_packed_q8x_plain(t(x), t(packed), t(scales), zero=zero, gsize=gsize).numpy()
    xq, d = (a.numpy() for a in qmm.quantize_q8x_plain(t(x), gsize))
    g2 = k // 2 // gsize
    nib = packed[:k // 2].astype(np.int64)
    for i, g in enumerate(groups):
        h, gg = divmod(g, g2)
        rows = slice(gg * gsize, (gg + 1) * gsize)
        lv = (nib[rows] & 0xF if h == 0 else nib[rows] >> 4) - zero
        xs = x[i, g * gsize:(g + 1) * gsize]
        q = xq[i, g * gsize:(g + 1) * gsize].astype(np.int64)
        np.testing.assert_array_equal(q, np.sign(xs) * np.floor(np.abs(xs) + 0.5))
        assert d[i, g] == 1.0 and np.count_nonzero(d[i]) == 1
        term = (q @ lv).astype(np.float64) * scales[h, gg].astype(np.float64)
        np.testing.assert_array_equal(got[i].view(np.uint32),
                                      term.astype(np.float32).view(np.uint32))
        j = next(j for j in range(gsize) if xs[j] != 127.0)
        q2 = q.copy()
        q2[j] -= int(np.sign(xs[j]))
        wrong = ((q2 @ lv).astype(np.float64) * scales[h, gg]).astype(np.float32)
        seen = lv[j] != 0
        assert seen.any() and (wrong[seen] != got[i][seen]).all()


# ------------------------------------------------------------- on the card

def _forms(n, k, seed):
    """(name, kernel call, plain call, 2-byte twin planes) of the five
    decode forms on one random weight each (K7 also on q3_K's layout: zero 4,
    16-groups), tensors on the card; and the widening back to f32."""
    c = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    packed, pscales, pbias = _packed(n, k, 32, 0, seed, bias=True)
    levels, iscales, ibias = _int8(n, k, 32, seed)
    q3packed, q3scales, _ = _packed(n, k, 16, 4, seed + 1, bias=False)
    p, ps, pb, lv, is_, ib, q3, q3s = map(c, (packed, pscales, pbias, levels, iscales, ibias,
                                              q3packed, q3scales))
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
        ("K7", lambda x, s=ps: qmm.qmm_packed_q8x(x, p, s, zero=8, gsize=32),
         lambda x: qmm.qmm_packed_q8x_plain(x, p, ps, zero=8, gsize=32), f16(ps)),
        ("K7 q3_K", lambda x, s=q3s: qmm.qmm_packed_q8x(x, q3, s, zero=4, gsize=16),
         lambda x: qmm.qmm_packed_q8x_plain(x, q3, q3s, zero=4, gsize=16), bf(q3s)),
    ], back


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 3, 17, 32])
@pytest.mark.parametrize("n,k", [(4224, 4096), (4096, 11008)])
def test_decode_forms_on_card(n, k, b):
    """On the card, each decode form: within 1e-3 of its plain version's
    scale (K7: 1e-4, its group dots are exact), two launches bit-identical,
    one launch captured in a CUDA graph and replayed 10 times bit-identical
    (the in-kernel reduce leaves no state), and on 2-byte planes equal bit
    for bit to f32 planes holding the same values.  K7 on the tie rows equals
    its plain version bit for bit."""
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
        tol = 1e-4 if name.startswith("K7") else 1e-3
        assert (got - want).abs().max().item() <= tol * want.abs().max().item(), name
        assert torch.equal(got, again) and all(replays), name
        assert torch.equal(a2, a32), name
        if name.startswith("K7"):
            xt = torch.from_numpy(_tie_rows(b, k, 16 if "q3_K" in name else 32, seed=b)[0])
            assert torch.equal(kern(xt.cuda()), plain(xt.cuda())), name
