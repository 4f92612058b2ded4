"""Decode attention over the KV cache (K4): the port's plain ``mha_decode``
and the plain twin of the kernel's split-and-merge order against the JAX
package's Pallas kernel in interpret mode, the kernel's split plan, the
``FUSED_ATTN`` routing rule, and the kernel against its plain version on the
card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_q_4_0_tpu.ops import layers as jl
from llama_cpp_q_4_0_tpu.ops.kvcache import quantize_kv as jax_quantize_kv
from llama_cpp_q_4_0_tpu.ops.pallas.attention import mha_decode as jax_mha_decode
from llama_cpp_q_4_0_tpu_torch.ops import layers as tl
from llama_cpp_q_4_0_tpu_torch.ops import mha_decode as md
from llama_cpp_q_4_0_tpu_torch.ops.kvcache import QuantKV, quantize_kv

# small shapes: one intra-op thread keeps the suite's parallel workers from
# oversubscribing the cores
torch.set_num_threads(1)


def _case(cache, t, h, g, *, b=2, s=256, d=64, seed=0, empty_row=False):
    """Inputs on both sides: rows at positions 150+ and 40+ over a mask of
    the first 160 slots; empty_row masks every slot of batch row 1."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, g, d)).astype(np.float32)
    v = rng.standard_normal((b, s, g, d)).astype(np.float32)
    pos = np.stack([150 + np.arange(t), 40 + np.arange(t)])[:b].astype(np.int32)
    mask = np.broadcast_to(np.arange(s) < 160, (b, s)).copy()
    if empty_row:
        mask[1] = False
    if cache == "int8":
        jk, js = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(k)))
        jv, jvs = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(v)))
        jax_args = (jnp.asarray(jk), jnp.asarray(js), jnp.asarray(jv), jnp.asarray(jvs))
        port_args = tuple(torch.from_numpy(a.copy()) for a in (jk, js, jv, jvs))
    else:
        jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "f8": jnp.float8_e4m3fn}[cache]
        tdt = {"f32": torch.float32, "bf16": torch.bfloat16,
               "f8": torch.float8_e4m3fn}[cache]
        jax_args = (jnp.asarray(k, jdt), None, jnp.asarray(v, jdt), None)
        port_args = (torch.from_numpy(k).to(tdt), None, torch.from_numpy(v).to(tdt), None)
    return q, pos, mask, jax_args, port_args, 1.0 / np.sqrt(d)


@pytest.mark.parametrize("g", [4, 2, 1], ids=["rep1", "rep2", "mqa"])
@pytest.mark.parametrize("t", [1, 5, 8, 16])
@pytest.mark.parametrize("cache", ["f32", "bf16", "int8", "f8"])
def test_plain_matches_pallas_interpret(cache, t, g):
    """Both compute the f32 chain on the stored values (an e4m3 cache
    included: the JAX kernel reads any float cache through astype(f32));
    only the f32 summation order differs (2e-5, tests/test_fused_attention.py's
    limit).
    Batch row 1 has no valid slot in the t=16 cases: both give 0."""
    q, pos, mask, ja, pa, scale = _case(cache, t, 4, g, seed=t + g, empty_row=t == 16)
    want = np.asarray(jax_mha_decode(jnp.asarray(q), *ja, jnp.asarray(pos),
                                     jnp.asarray(mask), scale, block_s=128,
                                     interpret=True))
    got = md.mha_decode(torch.from_numpy(q), *pa, torch.from_numpy(pos).long(),
                        torch.from_numpy(mask), scale).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    if t == 16:
        assert (got[1] == 0).all()


@pytest.mark.parametrize("g", [4, 2, 1], ids=["rep1", "rep2", "mqa"])
@pytest.mark.parametrize("t", [1, 5, 8, 16])
@pytest.mark.parametrize("cache", ["f32", "bf16", "int8", "f8"])
def test_split_plain_matches_pallas_interpret(cache, t, g):
    """The kernel's order in plain torch (mha_plan's slices, each slice's
    (m, l, acc) alone, merged in rank order) against the JAX kernel in
    interpret mode, at the limit of test_plain_matches_pallas_interpret
    (2e-5: f32 summation order only).  The window of 256 slots splits 4 ways,
    so rank 3 (slots 192+) holds no valid slot; batch row 1 has none at all
    in the t=16 cases: both give 0."""
    q, pos, mask, ja, pa, scale = _case(cache, t, 4, g, seed=t + g, empty_row=t == 16)
    want = np.asarray(jax_mha_decode(jnp.asarray(q), *ja, jnp.asarray(pos),
                                     jnp.asarray(mask), scale, block_s=128,
                                     interpret=True))
    assert md.mha_plan(256, t * (4 // g)).splits == 4
    got = md.mha_decode_split_plain(torch.from_numpy(q), *pa, torch.from_numpy(pos).long(),
                                    torch.from_numpy(mask), scale).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    if t == 16:
        assert (got[1] == 0).all()


@pytest.mark.parametrize("rows", [1, 2, 4, 8, 9, 16, 32, 64])
@pytest.mark.parametrize("s", [1, 31, 32, 100, 128, 255, 256, 1000, 2048, 4096])
def test_mha_plan_covers_every_slot_once(s, rows):
    """Every slot of the window lies in exactly one rank's slice, in rank
    order; at most MAX_SPLITS (8) ranks, each with MIN_SLICE slots or more
    when there are two or more; the row block is a compiled one that holds
    the rows (16 beyond, several blocks)."""
    plan = md.mha_plan(s, rows)
    assert 1 <= plan.splits <= md.MAX_SPLITS == 8 and plan.slots == s
    ranges = plan.ranges()
    assert len(ranges) == plan.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == s
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(ranges, ranges[1:]))
    assert sorted(x for lo, hi in ranges for x in range(lo, hi)) == list(range(s))
    if plan.splits > 1:
        assert all(hi - lo >= md.MIN_SLICE for lo, hi in ranges)
    assert plan.rows in md.ROW_BLOCKS and plan.rows >= min(rows, 16)
    assert all(r < min(rows, 16) for r in md.ROW_BLOCKS if r < plan.rows)  # the smallest


def test_plain_takes_a_strided_window():
    """The cache reaches attention as cache[:, :w]: strided over the batch for
    B > 1.  The plain version (and the kernel's contract) take the view as it
    is and equal the result on a copy."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 64)).astype(np.float32))
    cache = QuantKV(*quantize_kv(torch.from_numpy(
        rng.standard_normal((2, 512, 2, 64)).astype(np.float32))))
    kd, ks = cache.data[:, :256], cache.scale[:, :256]
    assert not kd.is_contiguous()
    pos = torch.tensor([[200], [100]])
    mask = (torch.arange(256) < 201)[None].expand(2, 256)
    got = md.mha_decode(q, kd, ks, kd, ks, pos, mask, 0.125)
    want = md.mha_decode_plain(q, kd.contiguous(), ks.contiguous(), kd.contiguous(),
                               ks.contiguous(), pos, mask.contiguous(), 0.125)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("max_t", [None, "16"])
@pytest.mark.parametrize("hd", [64, 96, 128, 256])
@pytest.mark.parametrize("s", [8, 128, 256, 384, 2048])
@pytest.mark.parametrize("t", [1, 8, 9, 16])
def test_use_fused_decode_is_the_jax_rule(monkeypatch, t, s, hd, max_t):
    """With FUSED_ATTN set the port routes to the kernel exactly where the
    JAX package does on its accelerator; never on the CPU, never unset."""
    monkeypatch.setenv("FUSED_ATTN", "1")
    if max_t:
        monkeypatch.setenv("FUSED_MAX_T", max_t)
    else:
        monkeypatch.delenv("FUSED_MAX_T", raising=False)
    monkeypatch.setattr(jl.jax, "default_backend", lambda: "tpu")
    for rep in (1, 4):
        assert tl.use_fused_decode(rep, t, s, hd, torch.device("cuda")) == \
            jl._use_fused_decode(rep, t, s, hd)
        assert not tl.use_fused_decode(rep, t, s, hd, torch.device("cpu"))
    monkeypatch.delenv("FUSED_ATTN")
    assert not tl.use_fused_decode(1, t, s, hd, torch.device("cuda"))


def test_attention_routes_to_mha_decode(monkeypatch):
    """Where the rule holds, attention() returns the kernel wrapper's result
    (the plain version on the CPU): the exact f32 chain, not the default
    path's bf16-rounded q and probabilities."""
    q, pos, mask, _, (kd, ks, vd, vs), scale = _case("int8", 1, 4, 2, seed=9)
    q, pos, mask = torch.from_numpy(q), torch.from_numpy(pos).long(), torch.from_numpy(mask)
    kc, vc = QuantKV(kd, ks), QuantKV(vd, vs)
    calls = []
    monkeypatch.setattr(tl, "use_fused_decode", lambda *a: calls.append(a) or True)
    got = tl.attention(q, kc, vc, pos, mask, scale)
    assert calls == [(2, 1, 256, 64, torch.device("cpu"))]
    torch.testing.assert_close(got, md.mha_decode_plain(q, kd, ks, vd, vs, pos, mask, scale),
                               rtol=0, atol=0)
    monkeypatch.setattr(tl, "use_fused_decode", lambda *a: False)
    default = tl.attention(q, kc, vc, pos, mask, scale)
    assert (default - got).abs().max() > 0  # the bf16-operand chain


@pytest.mark.gpu
@pytest.mark.parametrize("cache", ["f32", "bf16", "int8", "f8"])
@pytest.mark.parametrize("t,h,g,d", [(1, 32, 32, 128), (8, 32, 32, 128), (8, 32, 8, 128),
                                     (16, 8, 1, 256), (3, 8, 4, 64)])
def test_kernel_matches_plain_on_card(cache, t, h, g, d):
    """The CUDA kernel (one launch, every row block of mha_plan) against its
    plain version: f32 order noise, 1e-4 of the output scale; row 1 with no
    valid slot gives 0; two launches and 10 replays of a CUDA graph of one
    launch bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q, pos, mask, _, pa, scale = _case(cache, t, h, g, d=d, s=384, seed=t, empty_row=True)
    args = [torch.from_numpy(q).cuda(), *(a.cuda() if a is not None else None for a in pa),
            torch.from_numpy(pos).long().cuda(), torch.from_numpy(mask).cuda(), scale]
    got, again, want = md.mha_decode(*args), md.mha_decode(*args), md.mha_decode_plain(*args)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gout = md.mha_decode(*args)
    replays = []
    for _ in range(10):
        graph.replay()
        replays.append(torch.equal(gout, got))
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    assert (got[1] == 0).all()
    assert torch.equal(got, again) and all(replays)
