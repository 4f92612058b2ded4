"""Norm, RoPE and attention of the port against the JAX package's ops, and
the flash-prefill plain version against JAX attention (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_q_4_0_tpu.ops import layers as jl
from llama_cpp_q_4_0_tpu.ops.kvcache import QuantKV as JaxQuantKV
from llama_cpp_q_4_0_tpu.ops.kvcache import quantize_kv as jax_quantize_kv
from llama_cpp_q_4_0_tpu.ops.pallas.attention import mha_decode
from llama_cpp_q_4_0_tpu_torch.ops import layers as tl
from llama_cpp_q_4_0_tpu_torch.ops.flash_prefill import (flash_prefill,
                                                         flash_prefill_plain)
from llama_cpp_q_4_0_tpu_torch.ops.kvcache import QuantKV, quantize_kv


# small shapes: one intra-op thread keeps the suite's parallel workers from
# oversubscribing the cores
torch.set_num_threads(1)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_rms_norm_and_silu():
    """f32 elementwise chains; 1e-6 covers rsqrt/sigmoid ulp differences."""
    x = _rng(0).standard_normal((2, 5, 64)).astype(np.float32)
    w = _rng(1).standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(tl.rms_norm(_t(x), _t(w), 1e-6).numpy(),
                               np.asarray(jl.rms_norm(jnp.asarray(x),
                                                      jnp.asarray(w), 1e-6)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tl.silu(_t(x)).numpy(),
                               np.asarray(jl.silu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("neox", [False, True], ids=["adjacent", "neox"])
@pytest.mark.parametrize("n_rot", [16, 8])
def test_rope(neox, n_rot):
    """cos/sin of the same f32 angles: 2e-5 covers the two libraries' trig
    ulps at positions up to 2000."""
    x = _rng(2).standard_normal((2, 6, 4, 16)).astype(np.float32)
    pos = np.stack([np.arange(6) + 3, np.arange(6) + 1990]).astype(np.int32)
    want = np.asarray(jl.rope(jnp.asarray(x), jnp.asarray(pos), n_rot,
                              neox=neox))
    got = tl.rope(_t(x), _t(pos).long(), n_rot, neox=neox).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_quantize_kv_exact():
    v = _rng(3).standard_normal((2, 7, 4, 16)).astype(np.float32)
    v[0, 0, 0] = 0.0  # all-zero vector: scale 1
    jq, js = jax_quantize_kv(jnp.asarray(v))
    tq, ts = quantize_kv(_t(v))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _attn_case(cache, g, t=3, s=32, h=4, d=16, n_past=10, seed=0):
    rng = _rng(seed)
    q = rng.standard_normal((2, t, h, d)).astype(np.float32)
    k = rng.standard_normal((2, s, g, d)).astype(np.float32)
    v = rng.standard_normal((2, s, g, d)).astype(np.float32)
    pos = np.broadcast_to(n_past + np.arange(t), (2, t)).astype(np.int32)
    mask = np.broadcast_to(np.arange(s) < n_past + t, (2, s))
    if cache == "int8":
        jk, jv = (JaxQuantKV(*jax_quantize_kv(jnp.asarray(a))) for a in (k, v))
        tk, tv = (QuantKV(*quantize_kv(_t(a))) for a in (k, v))
    else:
        jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[cache]
        tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[cache]
        jk, jv = jnp.asarray(k, jdt), jnp.asarray(v, jdt)
        tk, tv = _t(k).to(tdt), _t(v).to(tdt)
    return q, (jk, jv), (tk, tv), pos, mask, 1.0 / np.sqrt(d)


@pytest.mark.parametrize("g", [4, 2, 1], ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
def test_attention(cache, g):
    """f32 caches take the exact f32 chain on both sides; bf16/int8 caches
    feed the same bf16-rounded q, K/V and probabilities to f32-accumulated
    products on both sides.  Only the f32 summation order differs: 2e-5."""
    q, (jk, jv), (tk, tv), pos, mask, scale = _attn_case(cache, g, seed=g)
    want = np.asarray(jl.attention(jnp.asarray(q), jk, jv, jnp.asarray(pos),
                                   jnp.asarray(mask), scale))
    got = tl.attention(_t(q), tk, tv, _t(pos).long(), _t(mask.copy()),
                       scale).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("g", [4, 2])
def test_flash_prefill_plain_matches_attention(g):
    """The flash kernel's contract: over the call's fresh K/V with n_past 0
    it equals cache-window attention (f32 chain, 2e-5)."""
    rng = _rng(7 + g)
    b, t, h, d = 2, 20, 4, 16
    q, k, v = (rng.standard_normal((b, t, n, d)).astype(np.float32)
               for n in (h, g, g))
    pos = np.broadcast_to(np.arange(t), (b, t)).astype(np.int32)
    mask = np.ones((b, t), bool)
    want = np.asarray(jl.attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(pos),
                                   jnp.asarray(mask), 0.25))
    got = flash_prefill_plain(_t(q), _t(k), _t(v), 0.25).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    # the wrapper takes the plain version on the CPU
    np.testing.assert_array_equal(flash_prefill(_t(q), _t(k), _t(v), 0.25).numpy(),
                                  got)


@pytest.mark.parametrize("hd", [64, 128, 192, 256, 384])
@pytest.mark.parametrize("t", [1, 64, 127, 128, 200, 256, 512])
def test_use_flash_prefill_is_the_jax_rule(monkeypatch, t, hd):
    """The port routes a prefill to the flash kernel exactly where the JAX
    package does on its accelerator, and never on the CPU."""
    monkeypatch.delenv("FLASH_PREFILL", raising=False)
    monkeypatch.setattr(jl.jax, "default_backend", lambda: "tpu")
    assert tl.use_flash_prefill(t, hd, torch.device("cuda")) == \
        jl.use_flash_prefill(t, hd)
    assert not tl.use_flash_prefill(t, hd, torch.device("cpu"))


@pytest.mark.parametrize("t", [128, 512])
@pytest.mark.parametrize("env", ["0", "1"])
def test_flash_prefill_switch_matches_jax(monkeypatch, env, t):
    """FLASH_PREFILL=0 turns the flash prefill off in both packages, and any
    other value leaves the rule as it is."""
    monkeypatch.setenv("FLASH_PREFILL", env)
    monkeypatch.setattr(jl.jax, "default_backend", lambda: "tpu")
    want = jl.use_flash_prefill(t, 128)
    assert want == (env != "0")
    assert tl.use_flash_prefill(t, 128, torch.device("cuda")) == want


@pytest.mark.parametrize("g", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_attn_mxu_off_takes_the_f32_chain(monkeypatch, cache, g):
    """ATTN_MXU=0 on a bf16 or int8 cache: both packages take the exact f32
    chain on the stored values (no bf16 rounding of q or the
    probabilities), so they agree to the f32 cache's 2e-5; on a bf16 cache
    the port equals its own attention over the same values in an f32
    cache."""
    monkeypatch.setenv("ATTN_MXU", "0")
    q, (jk, jv), (tk, tv), pos, mask, scale = _attn_case(cache, g, seed=20 + g)
    want = np.asarray(jl.attention(jnp.asarray(q), jk, jv, jnp.asarray(pos),
                                   jnp.asarray(mask), scale))
    got = tl.attention(_t(q), tk, tv, _t(pos).long(), _t(mask.copy()), scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    if cache == "bf16":  # the stored values held in an f32 cache
        chain = tl.attention(_t(q), tk.float(), tv.float(), _t(pos).long(),
                             _t(mask.copy()), scale)
        torch.testing.assert_close(got, chain, rtol=0, atol=0)
    monkeypatch.delenv("ATTN_MXU")
    mxu = tl.attention(_t(q), tk, tv, _t(pos).long(), _t(mask.copy()), scale)
    assert not torch.equal(mxu, got)  # the default path rounds to bf16


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "q8kv"])
def test_decode_attention_matches_mha_decode(quant):
    """Second witness: the JAX package's Pallas decode kernel (interpret
    mode) on an f32 or int8 cache; both compute in f32 (2e-5)."""
    rng = _rng(11)
    b, t, s, h, g, d, n_past = 1, 1, 256, 4, 2, 128, 100
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, g, d)).astype(np.float32)
    v = rng.standard_normal((b, s, g, d)).astype(np.float32)
    pos = np.full((b, t), n_past, np.int32)
    mask = np.broadcast_to(np.arange(s) < n_past + t, (b, s)).copy()
    scale = 1.0 / np.sqrt(d)
    if quant:
        kq, ks = jax_quantize_kv(jnp.asarray(k))
        vq, vs = jax_quantize_kv(jnp.asarray(v))
        tk = QuantKV(_t(np.asarray(kq)), _t(np.asarray(ks)))
        tv = QuantKV(_t(np.asarray(vq)), _t(np.asarray(vs)))
        # the int8 cache's default path rounds q and probs to bf16; compare
        # the exact chain: dequantized f32 cache values
        tk = (tk.data.float() * tk.scale[..., None])
        tv = (tv.data.float() * tv.scale[..., None])
    else:
        kq, ks, vq, vs = jnp.asarray(k), None, jnp.asarray(v), None
        tk, tv = _t(k), _t(v)
    want = np.asarray(mha_decode(jnp.asarray(q), kq, ks, vq, vs,
                                 jnp.asarray(pos), jnp.asarray(mask), scale,
                                 block_s=128, interpret=True))
    got = tl.attention(_t(q), tk, tv, _t(pos).long(), _t(mask), scale).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("t", [128, 200, 512, 2048])
@pytest.mark.parametrize("g,d", [(8, 128), (2, 128), (2, 256)],
                         ids=["mha128", "gqa128", "gqa256"])
def test_flash_kernel_matches_plain_on_card(g, d, t):
    """The 3xTF32 kernel against the f32 plain version within 1e-4 of the
    output scale (T = 200: the ragged edge), two launches bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = _rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, t, n, d))
                                .astype(np.float32)).cuda() for n in (8, g, g))
    got = flash_prefill(q, k, v, d ** -0.5)
    again = flash_prefill(q, k, v, d ** -0.5)
    want = flash_prefill_plain(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_flash_kernel_raises_for_other_head_widths():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q = torch.zeros((1, 128, 4, 384), device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        flash_prefill(q, q, q, 384 ** -0.5)


def _recip_sensitive_kv(n=64, d=16, seed=9):
    """[n, d] rows whose amax x makes x * float32(1/127) differ from the
    correctly rounded x / 127 (found with numpy), the rest of each row below."""
    rng = _rng(seed)
    cand = rng.uniform(0.0, 10.0, 100000).astype(np.float32)
    cand = cand[cand * np.float32(1 / 127) != cand / np.float32(127)][:n]
    assert len(cand) == n
    v = rng.uniform(-1.0, 1.0, (n, d)).astype(np.float32) * cand[:, None] * 0.9
    v[:, 3] = cand * np.where(np.arange(n) % 2, 1, -1)
    return v, cand


def test_quantize_kv_scale_is_a_correct_division():
    """quantize_kv's scale is amax / 127 correctly rounded (numpy's and the
    JAX package's division), not amax times the rounded reciprocal: on these
    rows the two differ in every scale (limit: bit for bit)."""
    v, amax = _recip_sensitive_kv()
    _, ts = quantize_kv(_t(v))
    want = amax / np.float32(127)
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), want.view(np.uint32))
    assert (ts.numpy() != amax * np.float32(1 / 127)).all()
    jq, js = jax_quantize_kv(jnp.asarray(v))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
    np.testing.assert_array_equal(quantize_kv(_t(v))[0].numpy(), np.asarray(jq))


@pytest.mark.gpu
def test_quantize_kv_on_card_equals_cpu():
    """The q8 cache's levels and scales on the card equal the CPU's bit for
    bit, on rows where a reciprocal multiply would be an ulp off."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    v, _ = _recip_sensitive_kv(n=256, d=128)
    cq, cs = quantize_kv(_t(v))
    gq, gs = quantize_kv(_t(v).cuda())
    assert torch.equal(gq.cpu(), cq)
    assert torch.equal(gs.cpu().view(torch.int32), cs.view(torch.int32))


# ---------------------------------------------- the flash kernel's 3xTF32

def test_tf32_round_bit_patterns():
    """tf32_round keeps 10 mantissa bits with ties away from zero (PTX
    cvt.rna.tf32.f32), on chosen bit patterns; limit: bit for bit."""
    from llama_cpp_q_4_0_tpu_torch.ops.flash_prefill import split_tf32, tf32_round
    ulp = 2.0 ** -10
    cases = [(1.0, 1.0), (1 + ulp / 2, 1 + ulp), (1 + 3 * ulp / 2, 1 + 2 * ulp),
             (-(1 + ulp / 2), -(1 + ulp)), (1 + ulp / 2 - 2.0 ** -23, 1.0),
             (1 + ulp / 2 + 2.0 ** -23, 1 + ulp), (0.0, 0.0), (-0.0, -0.0),
             (2.0 ** -130, 2.0 ** -130),
             (3.0 * 2.0 ** 100, 3.0 * 2.0 ** 100)]
    x = torch.tensor([c[0] for c in cases], dtype=torch.float32)
    want = torch.tensor([c[1] for c in cases], dtype=torch.float32)
    got = tf32_round(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    # hi + lo recovers a to 2^-21 relative; lo is TF32 too
    a = torch.from_numpy(_rng(4).standard_normal(10000).astype(np.float32))
    hi, lo = split_tf32(a)
    assert torch.equal(hi, tf32_round(hi)) and torch.equal(lo, tf32_round(lo))
    assert ((hi.double() + lo.double() - a.double()).abs() <= a.double().abs() * 2.0 ** -21).all()


@pytest.mark.parametrize("g,d,t", [(32, 128, 128), (8, 128, 128), (4, 256, 64)],
                         ids=["7b", "gqa", "d256"])
def test_flash_3xtf32_plain_matches_jax_attention(g, d, t):
    """The kernel's arithmetic (both products in 3xTF32, ~2^-21 relative per
    product) against the JAX package's f32 attention over the prompt's own
    K/V, at the 7B attention width (32 heads of 128; GQA 32/8) and at head
    width 256: within 1e-4 of the output scale, the kernel's limit on the
    card.  Single-pass TF32 misses that limit on the same inputs."""
    from llama_cpp_q_4_0_tpu_torch.ops.flash_prefill import (flash_prefill_3xtf32_plain,
                                                             tf32_round)
    h = 32 if d == 128 else 8
    rng = _rng(20 + g)
    q = (rng.standard_normal((1, t, h, d)) * 2.0).astype(np.float32)
    k = (rng.standard_normal((1, t, g, d)) * 2.0).astype(np.float32)
    v = rng.standard_normal((1, t, g, d)).astype(np.float32)
    pos = np.arange(t)[None].astype(np.int32)
    mask = np.ones((1, t), bool)
    scale = d ** -0.5
    want = np.asarray(jl.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   jnp.asarray(pos), jnp.asarray(mask), scale))
    got = flash_prefill_3xtf32_plain(_t(q), _t(k), _t(v), scale).numpy()
    lim = 1e-4 * np.abs(want).max()
    assert np.abs(got - want).max() <= lim
    one_pass = flash_prefill_plain(tf32_round(_t(q)), tf32_round(_t(k)), tf32_round(_t(v)),
                                   scale).numpy()
    assert np.abs(one_pass - want).max() > lim
