"""The port's on-device decode (runtime/device_sample.py and the per-row
n_past of models/transformer.py) against the JAX package on the CPU: the
deterministic sampling transforms, the per-row forward and its out-of-range
insert, greedy decode_chunk and generate_ondevice token for token, the
stochastic paths on their support and distribution, the draw's integers,
and the chunk's graph key and launch accounting.  The replayed chunk itself
needs the card (the ``gpu`` test).

The fixture is tests/test_device_penalties.py's (2 layers, n_embd 64, 4
heads, a 256-entry vocabulary), in f32 compute with f32 caches where tokens
or logits are compared (trap 2 of ROADMAP.md queue 3)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_q_4_0_tpu.formats.fixtures import make_llama_ggjt
from llama_cpp_q_4_0_tpu.formats.ggjt import read_ggjt as jax_read_ggjt
from llama_cpp_q_4_0_tpu.models import transformer as jt
from llama_cpp_q_4_0_tpu.models.loading import (
    config_from_ggjt as jax_config, load_transformer as jax_load)
from llama_cpp_q_4_0_tpu.runtime import device_sample as jds
from llama_cpp_q_4_0_tpu.runtime.context import Context as JaxContext
from llama_cpp_q_4_0_tpu.runtime.sampling import SamplingParams as JaxSP
from llama_cpp_q_4_0_tpu_torch.formats.ggjt import read_ggjt
from llama_cpp_q_4_0_tpu_torch.models import transformer as tt
from llama_cpp_q_4_0_tpu_torch.models.loading import config_from_ggjt, load_transformer
from llama_cpp_q_4_0_tpu_torch.ops.kvcache import QuantKV
from llama_cpp_q_4_0_tpu_torch.runtime import device_sample as tds
from llama_cpp_q_4_0_tpu_torch.runtime.context import (Context, add_launches,
                                                       chunk_key, record_launches)
from llama_cpp_q_4_0_tpu_torch.runtime.sampling import SamplingParams

torch.set_num_threads(1)

PEN = dict(repeat_penalty=1.3, repeat_last_n=8, frequency_penalty=0.1,
           presence_penalty=0.2)
DEV = dict(temp=-1.0, **PEN)
BIAS = ((5, float("-inf")), (17, 2.5), (200, -1.25))
V = 256


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("ds") / "m.bin")
    make_llama_ggjt(p, n_vocab=V, n_embd=64, n_head=4, n_layer=2)
    return p


@pytest.fixture(scope="module")
def models(path):
    """(JAX cfg, params), (port cfg, params): f32 compute, n_ctx 128."""
    gf = jax_read_ggjt(path, "llama")
    jcfg = dataclasses.replace(jax_config(gf, n_ctx=128), compute_dtype="float32")
    g2 = read_ggjt(path)
    tcfg = dataclasses.replace(config_from_ggjt(g2, n_ctx=128), compute_dtype="float32")
    return (jcfg, jax_load(gf, jcfg)), (tcfg, load_transformer(g2, tcfg, device="cpu"))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jit(fn, *static):
    """fn of the JAX package under jax.jit, its trailing arguments static:
    how decode_chunk runs it (XLA then multiplies by a constant's reciprocal
    where op-by-op JAX divides)."""
    return jax.jit(lambda *a: fn(*a, *static))


def _ulp_equal(got, want, maxulp=1):
    """Equal where infinite, within maxulp f32 ulps elsewhere."""
    got, want = _np(got).astype(np.float32), _np(want).astype(np.float32)
    assert got.shape == want.shape
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    np.testing.assert_array_max_ulp(got[fin], want[fin], maxulp=maxulp)


def _logits(seed, b=3, v=V):
    """Tie-free logits [b, v] (continuous normal draws)."""
    return np.random.default_rng(seed).normal(0, 3, (b, v)).astype(np.float32)


ROWS = [
    SamplingParams(temp=0.8, top_k=12, top_p=0.9, tfs_z=0.95, typical_p=0.9,
                   repeat_penalty=1.3, repeat_last_n=8, frequency_penalty=0.1,
                   presence_penalty=0.2, logit_bias={5: float("-inf"), 9: 1.5}),
    None,
    SamplingParams(temp=-1.0, top_k=0, top_p=1.0, repeat_penalty=1.1,
                   repeat_last_n=64, mirostat=2, mirostat_tau=4.0, mirostat_eta=0.2,
                   logit_bias={17: 2.5, 18: -2.0, 19: 0.5}),
]


def _jax_rows(rows):
    return [None if r is None else JaxSP(**dataclasses.asdict(r)) for r in rows]


def _recent_rows(seed, b=3, n=20):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, V, n - 7 * i).tolist() for i in range(b)]


# ------------------------------------------------- deterministic transforms

def test_apply_logit_bias_matches_jax():
    """A static bias adds exactly as JAX's scatter-add (-inf bans)."""
    x = _logits(0)
    got = tds._apply_logit_bias(torch.from_numpy(x), tds.DeviceSampling(logit_bias=BIAS))
    want = _jit(jds._apply_logit_bias, jds.DeviceSampling(logit_bias=BIAS))(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.isneginf(got.numpy()[:, 5]).all()


@pytest.mark.parametrize("n", [8, 64])
def test_make_recent_matches_jax(n):
    rows = _recent_rows(1)
    got = tds.make_recent(rows, n, V, device="cpu")
    want = jds.make_recent(rows, n, V)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("pen", [PEN, dict(repeat_penalty=0.7, frequency_penalty=0.3),
                                 dict(presence_penalty=0.5, repeat_last_n=16)])
def test_apply_penalties_matches_jax(pen):
    """The scalar penalties bit for bit against JAX's under jit (the
    division by the penalty is XLA's reciprocal multiply in both)."""
    x = _logits(2)
    rows = _recent_rows(3)
    n = pen.get("repeat_last_n", 64)
    got = tds._apply_penalties(torch.from_numpy(x), tds.make_recent(rows, n, V, device="cpu"),
                               tds.DeviceSampling(**pen))
    want = _jit(jds._apply_penalties, jds.DeviceSampling(**pen))(
        jnp.asarray(x), jds.make_recent(rows, n, V))
    _ulp_equal(got, want, maxulp=0)


def test_make_sampling_vec_matches_jax():
    """Every field, the optional ones' presence and the bias width's
    power-of-two bucket (3 entries -> 4) equal JAX's."""
    got = tds.make_sampling_vec(ROWS, seeds=[7, -1, None], device="cpu")
    want = jds.make_sampling_vec(_jax_rows(ROWS), seeds=[7, -1, None])
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert (a is None) == (b is None), f.name
        if b is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f.name)
    assert got.bias_ids.shape == (3, 4)
    assert set(got.present()) == {f.name for f in dataclasses.fields(want)}


def test_make_sampling_vec_leaves_unused_fields_absent():
    sv = tds.make_sampling_vec([SamplingParams(temp=-1.0), None], device="cpu")
    assert sv.mirostat is None and sv.bias_ids is None and sv.bias_vals is None


def test_apply_penalties_vec_matches_jax():
    """Per-row penalties (true divisions by the per-row penalty in both)
    bit for bit against JAX's under jit."""
    x = _logits(4)
    rows = _recent_rows(5, n=tds.VEC_WINDOW)
    tsv = tds.make_sampling_vec(ROWS, device="cpu")
    jsv = jds.make_sampling_vec(_jax_rows(ROWS))
    got = tds._apply_penalties_vec(
        torch.from_numpy(x), tds.make_recent(rows, tds.VEC_WINDOW, V, device="cpu"), tsv)
    want = jax.jit(jds._apply_penalties_vec)(
        jnp.asarray(x), jds.make_recent(rows, tds.VEC_WINDOW, V), jsv)
    _ulp_equal(got, want, maxulp=0)


def _sorted(seed, b=3, k=40):
    """Descending-sorted candidate logits [b, k] (JAX's top_k of tie-free
    logits), as both packages' filters take them."""
    vals, _ = jax.lax.top_k(jnp.asarray(_logits(seed, b)), k)
    return np.array(vals)


# (name, port fn, JAX fn, scalar or per-row parameters)
FILTERS = {
    "tfs": (tds._tfs_mask, jds._tfs_mask, (0.95, 0.8, [[0.5], [0.9], [1.0]])),
    "typical": (tds._typical_mask, jds._typical_mask, (0.9, 0.5, [[0.3], [0.95], [1.0]])),
    "top_p": (tds._top_p_mask, jds._top_p_mask, (0.9, 0.5, [[0.2], [0.7], [1.0]])),
}


@pytest.mark.parametrize("name", list(FILTERS))
@pytest.mark.parametrize("which", [0, 1, 2], ids=["p_a", "p_b", "per_row"])
def test_filters_match_jax(name, which):
    """Kept sets equal; kept values are the inputs, so equal exactly."""
    fn, jfn, params = FILTERS[name]
    p = params[which]
    vals = _sorted(10 + which)
    arg = np.asarray(p, np.float32) if isinstance(p, list) else p
    if isinstance(p, list):
        got = fn(torch.from_numpy(vals), torch.from_numpy(arg))
        want = jax.jit(jfn)(jnp.asarray(vals), jnp.asarray(arg))
    else:
        got = fn(torch.from_numpy(vals), p)
        want = _jit(jfn, p)(jnp.asarray(vals))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.isfinite(got.numpy()).any(axis=-1).all()  # min_keep = 1
    assert (~np.isfinite(got.numpy())).any()


def test_tfs_mask_n_valid_matches_jax():
    """The per-row form after a top-k cut: derivative entries past each
    row's n_valid are excluded, as JAX's."""
    vals = _sorted(20)
    tk = np.asarray([5, 40, 17])
    cut = np.where(np.arange(40)[None, :] < tk[:, None], vals, -np.inf).astype(np.float32)
    z = np.asarray([[0.9], [0.95], [0.7]], np.float32)
    got = tds._tfs_mask(torch.from_numpy(cut), torch.from_numpy(z), n_valid=torch.from_numpy(tk))
    want = jax.jit(lambda c, zz, n: jds._tfs_mask(c, zz, n_valid=n))(
        jnp.asarray(cut), jnp.asarray(z), jnp.asarray(tk))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mu", [[3.0, 6.0, 10.0], [0.5, 1.5, 2.5]])
def test_mirostat_masks_match_jax(mu):
    """v2 and v1 truncations of temp-scaled sorted logits: kept sets equal
    (values are the inputs)."""
    vals = _sorted(30, k=V) / 0.8
    m = np.asarray(mu, np.float32)
    for fn, jfn, extra in ((tds._mirostat2_mask_vec, jds._mirostat2_mask_vec, ()),
                           (tds._mirostat1_mask_vec, jds._mirostat1_mask_vec, (V,))):
        got = fn(torch.from_numpy(vals), torch.from_numpy(m), *extra)
        want = _jit(jfn, *extra)(jnp.asarray(vals), jnp.asarray(m))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_logits_vec_greedy_rows_match_jax():
    """Greedy rows take the argmax after the per-row bias and penalties:
    equal to JAX's tokens (no draw involved)."""
    rows = [SamplingParams(temp=-1.0, top_k=0, **PEN, logit_bias={3: -1.0}),
            SamplingParams(temp=-1.0, top_k=0, repeat_penalty=1.0, repeat_last_n=0),
            SamplingParams(temp=-1.0, top_k=0, repeat_penalty=2.0, repeat_last_n=32,
                           logit_bias={7: float("-inf")})]
    x = _logits(40)
    x[2, 7] = 100.0  # row 2's favourite, banned
    hist = _recent_rows(41, n=tds.VEC_WINDOW)
    got = tds.sample_logits_vec(torch.from_numpy(x), tds.prng_key(0, "cpu"),
                                tds.make_sampling_vec(rows, device="cpu"),
                                tds.make_recent(hist, tds.VEC_WINDOW, V, device="cpu"))
    want = jax.jit(jds.sample_logits_vec)(jnp.asarray(x), jax.random.key(0),
                                          jds.make_sampling_vec(_jax_rows(rows)),
                                          jds.make_recent(hist, tds.VEC_WINDOW, V))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[2] != 7


# ------------------------------------------------------- per-row forward

def _jax_cache(cfg, b, s, q8):
    return jt.init_cache(cfg, b, s, dtype=jnp.int8 if q8 else jnp.float32)


def _flat(caches):
    out = []
    for c in caches:
        out += [c.data, c.scale] if isinstance(c, (QuantKV, jt.QuantKV)) else [c]
    return [_np(a) for a in out]


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
def test_per_row_forward_matches_jax(models, q8):
    """tests/test_batch_engine.py::test_per_row_n_past_matches_scalar in
    both packages: rows primed alone at offsets 0, 3, 7 (T = 2 at each row's
    own position), then the port's per-row forward against JAX's (logits
    rtol = atol = 1e-4) and against the port's row-by-row scalar forwards
    (the same); the caches equal JAX's (f32: 1e-4; q8: levels within one
    step where a value sits on a rounding edge, scales 1e-4)."""
    (jcfg, jp), (tcfg, tp) = models
    b, s, offs = 3, 32, [0, 3, 7]
    rng = np.random.default_rng(0)
    tok = rng.integers(0, 255, (b, 2))
    prim = rng.integers(0, 255, (b, 8))
    jrows, trows = [], []
    for i in range(b):
        jck, jcv = _jax_cache(jcfg, 1, s, q8)
        tck, tcv = tt.init_cache(tcfg, 1, s, torch.int8 if q8 else torch.float32, "cpu")
        if offs[i]:
            _, jck, jcv = jt.forward(jcfg, jp, jnp.asarray(prim[i:i + 1, :offs[i]], jnp.int32),
                                     jnp.int32(0), jck, jcv)
            tt.forward(tcfg, tp, torch.from_numpy(prim[i:i + 1, :offs[i]]), 0, tck, tcv)
        jrows.append((jck, jcv))
        trows.append((tck, tcv))

    def cat_j(k):
        return tuple(jax.tree.map(lambda *a: jnp.concatenate(a, 0), *[r[k][l] for r in jrows])
                     for l in range(jcfg.n_layer))

    def cat_t(k):
        out = []
        for l in range(tcfg.n_layer):
            parts = [r[k][l] for r in trows]
            out.append(QuantKV(torch.cat([p.data for p in parts]), torch.cat([p.scale for p in parts]))
                       if q8 else torch.cat(parts))
        return out

    jck, jcv = cat_j(0), cat_j(1)
    tck, tcv = cat_t(0), cat_t(1)
    want, jck, jcv = jt.forward(jcfg, jp, jnp.asarray(tok, jnp.int32),
                                jnp.asarray(offs, jnp.int32), jck, jcv)
    got = tt.forward(tcfg, tp, torch.from_numpy(tok), torch.tensor(offs), tck, tcv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    for i in range(b):
        one = tt.forward(tcfg, tp, torch.from_numpy(tok[i:i + 1]), offs[i], *trows[i])
        np.testing.assert_allclose(got[i].numpy(), one[0].numpy(), rtol=1e-4, atol=1e-4)
    for a, w in zip(_flat(tck + tcv), _flat(jck + jcv)):
        if a.dtype == np.int8:
            assert np.abs(a.astype(int) - w.astype(int)).max() <= 1
            assert (a != w).mean() < 1e-3
        else:
            np.testing.assert_allclose(a, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("q8", [False, True], ids=["f32", "q8"])
def test_out_of_range_row_insert_is_dropped(models, q8):
    """Row 1 at n_past S-1 with T = 2 writes slot S-1 and drops slot S (a
    frozen speculative row): no exception; row 0 (in range) equals JAX's
    logits and cache (row 1 is not compared with JAX, whose write there is
    out of bounds); row 1's slot S-1 holds its first token's K/V, as a
    one-token forward at S-1 writes it (the dropped write did not land on
    it), and nothing else of row 1 moved."""
    (jcfg, jp), (tcfg, tp) = models
    s = 16
    rng = np.random.default_rng(1)
    tok = rng.integers(3, 255, (2, 2))
    prim = rng.integers(3, 255, (2, 15))
    dt = torch.int8 if q8 else torch.float32
    tck, tcv = tt.init_cache(tcfg, 2, s, dt, "cpu")
    tt.forward(tcfg, tp, torch.from_numpy(prim), 0, tck, tcv)
    before = [a.copy() for a in _flat(tck + tcv)]
    jck, jcv = _jax_cache(jcfg, 2, s, q8)
    _, jck, jcv = jt.forward(jcfg, jp, jnp.asarray(prim, jnp.int32), jnp.int32(0), jck, jcv)
    got = tt.forward(tcfg, tp, torch.from_numpy(tok), torch.tensor([5, s - 1]), tck, tcv)
    want, jck2, jcv2 = jt.forward(jcfg, jp, jnp.asarray(tok, jnp.int32),
                                  jnp.asarray([5, s - 1], jnp.int32), jck, jcv)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-4, atol=1e-4)
    for a, w in zip(_flat(tck + tcv), _flat(jck2 + jcv2)):
        if a.dtype == np.int8:
            assert np.abs(a[0].astype(int) - w[0].astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(a[0], w[0], rtol=1e-4, atol=1e-4)
    # row 1: slot S-1 holds its first token's K/V, as a one-token forward at
    # S-1 after the same prefill writes it (the dropped write did not land
    # on it), and its slots below S-1 are as they were
    ref = tt.init_cache(tcfg, 1, s, dt, "cpu")
    tt.forward(tcfg, tp, torch.from_numpy(prim[1:2]), 0, *ref)
    tt.forward(tcfg, tp, torch.from_numpy(tok[1:2, :1]), s - 1, *ref)
    for a, r, b0 in zip(_flat(tck + tcv), _flat(ref[0] + ref[1]), before):
        if a.dtype == np.int8:
            assert np.abs(a[1, s - 1].astype(int) - r[0, s - 1].astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(a[1, s - 1], r[0, s - 1], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(a[1, :s - 1], b0[1, :s - 1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_row_insert_slots(dtype):
    """_cache_insert_rows alone: in-range rows write exactly their T slots;
    a row partly past S writes its in-range tokens and slot S-1 gets its own
    token there (never the dropped one's); a row wholly past S leaves the
    cache as it was."""
    s, t, h, d = 8, 3, 2, 4
    gen = torch.Generator().manual_seed(0)
    old = torch.randn((3, s, h, d), generator=gen) * 10
    val = torch.randn((3, t, h, d), generator=gen) * 10
    n_past = torch.tensor([2, s - 2, s + 1])
    if dtype == torch.int8:
        cache = QuantKV(old.round().clamp(-127, 127).to(torch.int8), old[..., 0].abs() + 0.5)
        q, sc = tt.quantize_kv(val)
        want_d, want_s = cache.data.clone(), cache.scale.clone()
        for r, p in ((0, 2), (0, 3), (0, 4), (1, s - 2), (1, s - 1)):
            j = p - int(n_past[r])
            want_d[r, p], want_s[r, p] = q[r, j], sc[r, j]
        tt._cache_insert_rows(cache, val, tt._row_slots(n_past, s, t))
        assert torch.equal(cache.data, want_d) and torch.equal(cache.scale, want_s)
        return
    cache = old.to(dtype)
    want = cache.clone()
    for r, p in ((0, 2), (0, 3), (0, 4), (1, s - 2), (1, s - 1)):
        want[r, p] = val[r, p - int(n_past[r])].to(dtype)
    tt._cache_insert_rows(cache, val.to(dtype), tt._row_slots(n_past, s, t))
    assert torch.equal(cache, want)


# ------------------------------------------------------ decode_chunk, greedy

def _prefill_both(models, prompt, b=1):
    """JAX and port caches (f32) after the same prompt rows [b, T]."""
    (jcfg, jp), (tcfg, tp) = models
    jck, jcv = jt.init_cache(jcfg, b, 128, dtype=jnp.float32)
    _, jck, jcv = jt.forward(jcfg, jp, jnp.asarray(prompt, jnp.int32), jnp.int32(0), jck, jcv)
    tck, tcv = tt.init_cache(tcfg, b, 128, torch.float32, "cpu")
    tt.forward(tcfg, tp, torch.from_numpy(np.asarray(prompt)), 0, tck, tcv)
    return (jck, jcv), (tck, tcv)


@pytest.mark.parametrize("bias", [(), BIAS], ids=["penalties", "penalties_bias"])
def test_decode_chunk_greedy_matches_jax(models, bias):
    """Greedy decode_chunk with DEV's penalties (and a logit bias): tokens
    equal to JAX's, token for token, over two chunks of 6 (the recent window
    carried), in f32 compute on f32 caches."""
    (jcfg, jp), (tcfg, tp) = models
    prompt = [np.random.default_rng(1).integers(3, 250, 10).tolist()]
    (jck, jcv), (tck, tcv) = _prefill_both(models, prompt)
    jd = jds.DeviceSampling(**DEV, logit_bias=bias)
    td = tds.DeviceSampling(**DEV, logit_bias=bias)
    jtok, ttok = jnp.asarray([prompt[0][-1]], jnp.int32), torch.tensor([prompt[0][-1]])
    jrec = jds.make_recent(prompt, jd.repeat_last_n, V)
    trec = tds.make_recent(prompt, td.repeat_last_n, V, device="cpu")
    jkey, tkey = jax.random.key(0), tds.prng_key(0, "cpu")
    n_past = 9  # the last prompt token is fed again, as a chunk's tok
    got, want = [], []
    for _ in range(2):
        jt_, jck, jcv, jkey, jrec, _ = jds.decode_chunk(
            jcfg, jp, jtok, jnp.int32(n_past), jck, jcv, jkey, n_steps=6, ds=jd,
            kv_window=32, recent=jrec)
        tt_, _, _, tkey, trec, _ = tds.decode_chunk(
            tcfg, tp, ttok, n_past, tck, tcv, tkey, n_steps=6, ds=td, kv_window=32,
            recent=trec)
        want += np.asarray(jt_)[0].tolist()
        got += tt_[0].tolist()
        jtok, ttok = jt_[:, -1], tt_[:, -1]
        n_past += 6
        np.testing.assert_array_equal(trec.numpy(), np.asarray(jrec))
    assert got == want
    if bias:
        assert 5 not in got


def test_decode_chunk_per_row_greedy_vec_matches_jax(models):
    """[B] n_past (rows at 10 and 7: row 1 rewound past three prompt
    tokens) and a greedy SamplingVec (row 0 penalized, row 1 banning a
    token): tokens equal to JAX's over 8 steps."""
    (jcfg, jp), (tcfg, tp) = models
    rng = np.random.default_rng(2)
    prompt = rng.integers(3, 250, (2, 10)).tolist()
    (jck, jcv), (tck, tcv) = _prefill_both(models, prompt, b=2)
    rows = [SamplingParams(temp=-1.0, top_k=0, **PEN),
            SamplingParams(temp=-1.0, top_k=0, repeat_penalty=1.0, repeat_last_n=0,
                           logit_bias={int(prompt[1][6]): float("-inf")})]
    hist = [prompt[0], prompt[1][:8]]
    offs = [9, 7]
    tok = [prompt[0][9], prompt[1][7]]
    jsv = jds.make_sampling_vec(_jax_rows(rows))
    tsv = tds.make_sampling_vec(rows, device="cpu")
    want = jds.decode_chunk(jcfg, jp, jnp.asarray(tok, jnp.int32), jnp.asarray(offs, jnp.int32),
                            jck, jcv, jax.random.key(0), n_steps=8, ds=jds.DeviceSampling(temp=-1.0),
                            kv_window=32, recent=jds.make_recent(hist, jds.VEC_WINDOW, V), sv=jsv)
    got = tds.decode_chunk(tcfg, tp, torch.tensor(tok), torch.tensor(offs), tck, tcv,
                           tds.prng_key(0, "cpu"), n_steps=8, ds=tds.DeviceSampling(temp=-1.0),
                           kv_window=32, recent=tds.make_recent(hist, tds.VEC_WINDOW, V,
                                                                device="cpu"), sv=tsv)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    assert int(prompt[1][6]) not in got[0][1].tolist()


def _contexts(models):
    (jcfg, jp), (tcfg, tp) = models
    return (JaxContext(jcfg, jp, n_ctx=128, cache_dtype=jnp.float32),
            Context(tcfg, tp, n_ctx=128, cache_dtype=torch.float32, device="cpu"))


def test_generate_ondevice_greedy_matches_jax_with_eos_rewind(models):
    """generate_ondevice greedy with DEV's penalties, chunk 6: the same
    tokens as JAX's; then with EOS set to a token the chunks emit mid-chunk,
    the same tokens up to it and the same ctx.n_past after the rewind."""
    prompt = np.random.default_rng(1).integers(3, 250, 10).tolist()
    jc, tc = _contexts(models)
    want = jds.generate_ondevice(jc, prompt, 24, sampling=jds.DeviceSampling(**DEV), chunk=6,
                                 eos_token=-1)
    got = tds.generate_ondevice(tc, prompt, 24, sampling=tds.DeviceSampling(**DEV), chunk=6,
                                eos_token=-1)
    assert got == want and len(got) == 24 and tc.n_past == jc.n_past
    # an EOS inside the second chunk, first seen there
    i = next(i for i in range(8, 12) if got[i] not in got[:i])
    jc, tc = _contexts(models)
    want = jds.generate_ondevice(jc, prompt, 24, sampling=jds.DeviceSampling(**DEV), chunk=6,
                                 eos_token=got[i])
    got2 = tds.generate_ondevice(tc, prompt, 24, sampling=tds.DeviceSampling(**DEV), chunk=6,
                                 eos_token=got[i])
    assert got2 == want == got[:i]
    assert tc.n_past == jc.n_past == len(prompt) + i
    assert tc.timings.n_eval == 12  # two chunks of 6


def test_generate_ondevice_first_token_eos_returns_nothing(models):
    prompt = np.random.default_rng(1).integers(3, 250, 10).tolist()
    _, tc = _contexts(models)
    first = tds.generate_ondevice(tc, prompt, 1, sampling=tds.DeviceSampling(**DEV))[0]
    _, tc = _contexts(models)
    assert tds.generate_ondevice(tc, prompt, 8, sampling=tds.DeviceSampling(**DEV),
                                 eos_token=first) == []


# ------------------------------------------------------- stochastic paths

def test_draw_integers_are_exact():
    """The hash of the draws, in int64 tensors, equals the same hash in
    Python's unbounded integers (no product wraps): the same integers on
    every device."""
    def h32(x):
        x = (((x >> 16) ^ x) * 0x45D9F3B) % (1 << 32)
        x = (((x >> 16) ^ x) * 0x45D9F3B) % (1 << 32)
        return (x >> 16) ^ x

    xs = [0, 1, 2, 12345, (1 << 31) - 1, 1 << 31, (1 << 32) - 1, 0xDEADBEEF]
    ys = [0, 1, 7, 255, (1 << 32) - 1]
    got = tds._mix(torch.tensor(xs)[:, None], torch.tensor(ys)[None, :])
    want = [[h32(x ^ h32((y + 0x9E3779B9) % (1 << 32))) for y in ys] for x in xs]
    assert got.tolist() == want
    assert int(got.max()) < (1 << 32) and int(got.min()) >= 0


def test_keys_split_and_differ():
    k = tds.prng_key(0, "cpu")
    carried, sub = tds.split_key(k)
    assert k.dim() == 0 and k.dtype == torch.int64
    assert len({int(k), int(carried), int(sub), int(tds.prng_key(1, "cpu"))}) == 4
    assert torch.equal(tds.split_key(k)[0], carried)  # a pure function of the key


def _empirical(draw, n):
    counts = {}
    for i in range(n):
        t = draw(tds.prng_key(i, "cpu"))
        counts[t] = counts.get(t, 0) + 1
    return counts


def _filtered_softmax(x, ds):
    """The host chain's distribution over the kept candidates."""
    from llama_cpp_q_4_0_tpu_torch.runtime.sampling import (
        Candidates, sample_softmax, sample_tail_free, sample_top_k, sample_top_p,
        sample_typical)

    c = Candidates.from_logits(x)
    sample_top_k(c, ds.top_k, 1)
    sample_tail_free(c, ds.tfs_z, 1)
    sample_typical(c, ds.typical_p, 1)
    sample_top_p(c, ds.top_p, 1)
    c.logits = c.logits / np.float32(ds.temp)
    c.sorted = False
    sample_softmax(c)
    return dict(zip(c.ids.tolist(), c.p.tolist()))


@pytest.mark.parametrize("ds_kw", [dict(temp=0.7, top_k=6, top_p=0.9),
                                   dict(temp=1.2, top_k=8, tfs_z=0.9, typical_p=0.95)],
                         ids=["topk_topp", "tfs_typical"])
def test_sample_logits_distribution(ds_kw):
    """_sample_logits over 1,500 keys: the support is the filtered set and
    the frequencies are the filtered softmax's within 0.05 (over 5 sigma of
    a frequency at n = 1,500)."""
    x = np.random.default_rng(50).normal(0, 1.0, V).astype(np.float32)
    ds = tds.DeviceSampling(**ds_kw)
    p = _filtered_softmax(x, ds)
    row = torch.from_numpy(x)
    counts = _empirical(lambda k: int(tds._sample_logits(row, k, ds)), 1500)
    assert set(counts) <= set(p)
    for t, q in p.items():
        assert abs(counts.get(t, 0) / 1500 - q) < 0.05, (t, q)


def test_sample_logits_vec_distribution():
    """A sampled row of sample_logits_vec (top-k 6, top-p 0.9, temp 0.7,
    no penalty) over 1,500 keys against the filtered softmax, as above; a
    greedy row beside it takes its argmax every time."""
    x = np.random.default_rng(51).normal(0, 1.0, (2, V)).astype(np.float32)
    sp = SamplingParams(temp=0.7, top_k=6, top_p=0.9, repeat_penalty=1.0, repeat_last_n=0)
    sv = tds.make_sampling_vec([sp, None], device="cpu")
    rec = torch.full((2, 1), V)
    p = _filtered_softmax(x[0], tds.DeviceSampling(temp=0.7, top_k=6, top_p=0.9))
    logits = torch.from_numpy(x)
    toks = [tds.sample_logits_vec(logits, tds.prng_key(i, "cpu"), sv, rec).tolist()
            for i in range(1500)]
    assert all(t[1] == int(np.argmax(x[1])) for t in toks)
    counts = {}
    for t in toks:
        counts[t[0]] = counts.get(t[0], 0) + 1
    assert set(counts) <= set(p)
    for t, q in p.items():
        assert abs(counts.get(t, 0) / 1500 - q) < 0.05, (t, q)


def test_mirostat2_forced_choice_and_distribution():
    """tests/test_sampling.py's mirostat-v2 check: mu below every
    non-top surprise forces the argmax and mu moves by -eta*(0 - tau); a
    huge mu truncates nothing, and 400 keys follow the softmax within
    0.07."""
    ds = tds.DeviceSampling(temp=1.0, mirostat=2, mirostat_tau=5.0, mirostat_eta=0.1)
    logits = torch.tensor([[4.0, 2.0, 1.0, -1.0]])
    tok, mu2 = tds._mirostat2_sample(logits, tds.prng_key(0, "cpu"), ds, torch.tensor([0.01]))
    assert int(tok[0]) == 0
    np.testing.assert_allclose(mu2.numpy(), [0.01 - 0.1 * (0.0 - 5.0)], rtol=1e-5)
    p = np.exp(logits[0].numpy())
    p /= p.sum()
    counts = np.zeros(4)
    for i in range(400):
        tok, _ = tds._mirostat2_sample(logits, tds.prng_key(i, "cpu"), ds, torch.tensor([100.0]))
        counts[int(tok[0])] += 1
    assert np.abs(counts / 400 - p).max() < 0.07


def test_mirostat1_forced_choice_matches_jax():
    """Mirostat v1 with a low mu keeps k = 1: the argmax, and mu' =
    mu - eta * (0 - tau), equal to JAX's (no draw decides it)."""
    ds = dict(temp=0.9, mirostat=1, mirostat_tau=4.0, mirostat_eta=0.3)
    x = _logits(60, b=2)
    mu = np.asarray([-20.0, -15.0], np.float32)
    tok, mu2 = tds._mirostat1_sample(torch.from_numpy(x), tds.prng_key(0, "cpu"),
                                     tds.DeviceSampling(**ds), torch.from_numpy(mu))
    jtok, jmu2 = jax.jit(lambda a, k, m: jds._mirostat1_sample(a, k, jds.DeviceSampling(**ds), m))(
        jnp.asarray(x), jax.random.key(0), jnp.asarray(mu))
    np.testing.assert_array_equal(tok.numpy(), np.argmax(x, -1))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    _ulp_equal(mu2, jmu2)
    np.testing.assert_allclose(mu2.numpy(), mu + 0.3 * 4.0, rtol=1e-6)


def test_sample_logits_vec_mirostat_rows_forced_choice():
    """Per-row mirostat v1 and v2 rows with a low mu take their argmax and
    move mu by -eta*(0 - tau); a non-mirostat row's mu stays."""
    rows = [SamplingParams(temp=1.0, mirostat=1, mirostat_tau=5.0, mirostat_eta=0.1),
            SamplingParams(temp=1.0, mirostat=2, mirostat_tau=3.0, mirostat_eta=0.2),
            SamplingParams(temp=1.0, top_k=1)]
    sv = tds.make_sampling_vec(rows, device="cpu")
    x = _logits(61)
    mu = torch.tensor([-20.0, 0.001, 1.0])
    tok, mu2 = tds.sample_logits_vec(torch.from_numpy(x), tds.prng_key(0, "cpu"), sv,
                                     torch.full((3, 1), V), mu=mu)
    np.testing.assert_array_equal(tok.numpy(), np.argmax(x, -1))
    np.testing.assert_allclose(mu2.numpy(), [-20.0 + 0.5, 0.001 + 0.6, 1.0], rtol=1e-5)


def test_seeded_rows_do_not_depend_on_their_batch():
    """A row with seed >= 0 draws from (seed, position) alone: the same
    tokens whatever key and whatever rows share its batch, at each of
    several positions; unseeded rows depend on the key."""
    x = _logits(70, b=3)
    sp = SamplingParams(temp=1.5, top_k=50, top_p=1.0, repeat_penalty=1.0, repeat_last_n=0)
    rec = torch.full((3, 1), V)
    for pos in (5, 6, 900):
        a = tds.sample_logits_vec(torch.from_numpy(x), tds.prng_key(1, "cpu"),
                                  tds.make_sampling_vec([sp, sp, sp], seeds=[42, -1, 9],
                                                        device="cpu"),
                                  rec, position=torch.tensor([pos, pos, pos]))
        swapped = x[[2, 0, 1]]
        b = tds.sample_logits_vec(torch.from_numpy(swapped), tds.prng_key(2, "cpu"),
                                  tds.make_sampling_vec([sp, sp, sp], seeds=[-1, 42, 3],
                                                        device="cpu"),
                                  rec, position=torch.tensor([pos, pos, pos]))
        assert int(a[0]) == int(b[1])
    draws = {int(tds.sample_logits_vec(torch.from_numpy(x), tds.prng_key(k, "cpu"),
                                       tds.make_sampling_vec([sp] * 3, device="cpu"),
                                       rec)[0]) for k in range(30)}
    assert len(draws) > 1


def test_sampled_chunk_same_key_same_tokens(models):
    """A sampled decode_chunk (temp 0.8, top-k 40, top-p 0.95, repeat
    penalty 1.1) gives the same tokens from the same key and caches, and
    other tokens from another key."""
    (_, _), (tcfg, tp) = models
    prompt = [np.random.default_rng(3).integers(3, 250, 10).tolist()]
    ds = tds.DeviceSampling(temp=0.8, top_k=40, top_p=0.95, repeat_penalty=1.1)
    out = []
    for seed in (4, 4, 5):
        ck, cv = tt.init_cache(tcfg, 1, 128, torch.float32, "cpu")
        tt.forward(tcfg, tp, torch.tensor(prompt), 0, ck, cv)
        toks = tds.decode_chunk(tcfg, tp, torch.tensor([prompt[0][-1]]), 9, ck, cv,
                                tds.prng_key(seed, "cpu"), n_steps=12, ds=ds, kv_window=32,
                                recent=tds.make_recent(prompt, 64, V, device="cpu"))[0]
        out.append(toks[0].tolist())
    assert out[0] == out[1] != out[2]


# ------------------------------------------------- graph key and launches

BASE = dict(n_steps=16, kv_window=256, ds=tds.DeviceSampling(temp=-1.0), sv=None,
            recent_width=1, per_row=False)
SV = tds.make_sampling_vec([SamplingParams(temp=-1.0), None], device="cpu")
SV_BIAS = tds.make_sampling_vec([SamplingParams(temp=-1.0, logit_bias={3: 1.0}), None],
                                device="cpu")
OTHER = dict(n_steps=[8], kv_window=[1024, None],
             ds=[tds.DeviceSampling(temp=0.8), tds.DeviceSampling(temp=-1.0, logit_bias=BIAS)],
             sv=[SV, SV_BIAS], recent_width=[64], per_row=[True])


@pytest.mark.parametrize("arg", list(OTHER))
def test_chunk_key_one_key_per_static_value(arg):
    """The chunk's own fields key its graph, each value apart; the key
    differs from a one-token eval step's."""
    keys = {chunk_key(**BASE)}
    for v in OTHER[arg]:
        keys.add(chunk_key(**{**BASE, arg: v}))
    assert len(keys) == 1 + len(OTHER[arg])
    assert chunk_key(**BASE)[0] == "chunk"


def test_chunk_key_shared_across_carry_values():
    """Values of the carry (n_past, key, recent, mu) and of a SamplingVec of
    the same shapes are inputs, not keys: one graph serves them."""
    other = tds.make_sampling_vec([SamplingParams(temp=0.5, top_k=3), None], device="cpu")
    assert chunk_key(**{**BASE, "sv": SV}) == chunk_key(**{**BASE, "sv": other})


def test_chunk_replays_count_as_their_capture():
    """A chunk of n steps on the card is one eager step, a capture
    (recorded, counted as no launch) and n - 1 replays, each adding the
    capture's delta: n steps' launches in all, as n eager steps add."""
    counters = ({"qmm_q4_0_kfold": 0}, {"mha_decode": 0})

    def step():
        counters[0]["qmm_q4_0_kfold"] += 129
        counters[1]["mha_decode"] += 32

    n = 16
    step()
    _, delta = record_launches(counters, step)
    add_launches(counters, delta, n - 1)
    assert counters == ({"qmm_q4_0_kfold": 129 * n}, {"mha_decode": 32 * n})


def test_context_decode_chunk_on_cpu_is_the_eager_loop(models):
    """Context.decode_chunk on the CPU: the tokens of device_sample's
    eager loop on a twin cache, host tokens [B, n_steps], the caches
    written alike, ctx.n_past left to the caller; a scalar n_past past the
    context raises."""
    (_, _), (tcfg, tp) = models
    ctx = Context(tcfg, tp, n_ctx=128, cache_dtype=torch.float32, device="cpu")
    prompt = [3, 9, 27, 81]
    ctx.eval([prompt])
    ck = [c.clone() for c in ctx.cache_k]
    cv = [c.clone() for c in ctx.cache_v]
    ds = tds.DeviceSampling(**DEV)
    rec = tds.make_recent([prompt], 8, V, device="cpu")
    toks, key, recent, _ = ctx.decode_chunk(torch.tensor([81]), 4, tds.prng_key(0, "cpu"),
                                            n_steps=5, ds=ds, kv_window=32, recent=rec)
    want = tds.decode_chunk(tcfg, tp, torch.tensor([81]), 4, ck, cv, tds.prng_key(0, "cpu"),
                            n_steps=5, ds=ds, kv_window=32, recent=rec)
    assert isinstance(toks, np.ndarray) and toks.shape == (1, 5)
    np.testing.assert_array_equal(toks, want[0].numpy())
    assert torch.equal(recent, want[4]) and ctx.n_past == 4
    assert all(torch.equal(a, b) for a, b in zip(ctx.cache_k + ctx.cache_v, ck + cv))
    with pytest.raises(ValueError, match="overflow"):
        ctx.decode_chunk(torch.tensor([81]), 125, key, n_steps=5, ds=ds, recent=rec)


# ------------------------------------------------------------ on the card

@pytest.fixture(scope="module")
def path256(tmp_path_factory):
    """A q4_0 LLaMA inside the kernels' gate (n_embd 256, 2 layers): the
    chunk's graph holds K2."""
    p = str(tmp_path_factory.mktemp("ds256") / "llama.ggjt")
    make_llama_ggjt(p, n_embd=256, n_mult=256, n_head=2)
    return p


@pytest.mark.gpu
def test_chunk_replays_equal_eager_on_card(path256):
    """generate_ondevice's chunks on the card (replays of one captured
    step) against the eager decode_chunk on a twin cache: greedy and
    sampled tokens bit for bit, caches equal after the run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    gf = read_ggjt(path256)
    cfg = config_from_ggjt(gf, n_ctx=256)
    params = load_transformer(gf, cfg, device="cuda")
    for ds in (tds.DeviceSampling(temp=-1.0), tds.DeviceSampling(temp=0.8, repeat_penalty=1.1)):
        ctx = Context(cfg, params, n_ctx=256, device="cuda")
        prompt = [1, 5, 10, 42, 7, 9]
        ctx.eval([prompt])
        ck = [c.clone() for c in ctx.cache_k]
        cv = [c.clone() for c in ctx.cache_v]
        tok = torch.tensor([9], device="cuda")
        rec = tds.make_recent([prompt], ds.repeat_last_n, cfg.n_vocab, device="cuda")
        key = tds.prng_key(3, "cuda")
        kw = dict(n_steps=8, ds=ds, kv_window=32, recent=rec)
        for _ in range(2):  # the capture, then a chunk of replays only
            got = ctx.decode_chunk(tok, 6, key, **kw)
            want = tds.decode_chunk(cfg, ctx.params, tok, 6, ck, cv, key, **kw)
            np.testing.assert_array_equal(got[0], want[0].cpu().numpy())
        assert all(torch.equal(a, b) for a, b in zip(ctx.cache_k + ctx.cache_v, ck + cv))
