"""The port's LoRA adapters (formats/ggla.py, ops/lowrank.py, models/lora.py,
cli/convert_lora.py, `main --lora`) against the JAX package on the CPU: ggla
files byte for byte and read across packages, merged weights' bytes, the
unmerged product within JAX's 1e-4 with the base untouched, the adapted
model's logits, PEFT conversion, params_from_numpy of adapted params, and the
CLI's tokens.

The fixture is tests/test_lora.py's (2 layers, n_embd 64, 4 heads, a
256-entry vocabulary) in q4_0, q8_0 and f32, f32 compute where logits are
compared."""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_q_4_0_tpu.formats import ggla as jggla
from llama_cpp_q_4_0_tpu.formats.fixtures import make_llama_ggjt
from llama_cpp_q_4_0_tpu.formats.ggjt import read_ggjt as jax_read_ggjt
from llama_cpp_q_4_0_tpu.models import lora as jlora
from llama_cpp_q_4_0_tpu.models.fuse import fuse_projections as jax_fuse
from llama_cpp_q_4_0_tpu.models.loading import (
    config_from_ggjt as jax_config, load_transformer as jax_load)
from llama_cpp_q_4_0_tpu.ops.lowrank import LowRankPatched as JaxLowRank
from llama_cpp_q_4_0_tpu.ops.qmatmul import q_matmul as jax_q_matmul
from llama_cpp_q_4_0_tpu.ops.qtensor import QTensor as JaxQTensor
from llama_cpp_q_4_0_tpu.quant.types import GGMLType
from llama_cpp_q_4_0_tpu.runtime.context import Context as JaxContext
from llama_cpp_q_4_0_tpu_torch.convert import params_from_numpy
from llama_cpp_q_4_0_tpu_torch.formats import ggla
from llama_cpp_q_4_0_tpu_torch.formats.ggjt import read_ggjt
from llama_cpp_q_4_0_tpu_torch.models import lora
from llama_cpp_q_4_0_tpu_torch.models.fuse import fuse_projections
from llama_cpp_q_4_0_tpu_torch.models.loading import config_from_ggjt, load_transformer
from llama_cpp_q_4_0_tpu_torch.ops.lowrank import LowRankPatched
from llama_cpp_q_4_0_tpu_torch.ops.qmatmul import q_matmul
from llama_cpp_q_4_0_tpu_torch.ops.qtensor import QTensor
from llama_cpp_q_4_0_tpu_torch.runtime.context import Context

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E, F = 64, 192  # the fixture's n_embd and n_ff
QKV = ("attention.wq", "attention.wk", "attention.wv")
SHAPES = {"attention.wq": (E, E), "attention.wk": (E, E), "attention.wv": (E, E),
          "attention.wo": (E, E), "feed_forward.w1": (F, E), "feed_forward.w2": (E, F),
          "feed_forward.w3": (F, E)}


def _tensors(targets, layers=(0, 1), r=4, seed=1, k=None):
    """ggla tensors of a rank-r adapter on targets of each layer: A stored
    [K, r], B [N, r]."""
    rng = np.random.default_rng(seed)
    out = {}
    for layer in layers:
        for name in targets:
            n, kk = SHAPES[name]
            base = f"layers.{layer}.{name}.weight"
            out[base + ".loraA"] = (rng.standard_normal((k or kk, r)) * 0.1).astype(np.float32)
            out[base + ".loraB"] = (rng.standard_normal((n, r)) * 0.1).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("lora")
    out = {}
    for qtype in (GGMLType.Q4_0, GGMLType.Q8_0, GGMLType.F32):
        p = str(d / f"{qtype.name}.bin")
        make_llama_ggjt(p, n_vocab=256, n_embd=E, n_head=4, n_layer=2, qtype=qtype)
        out[qtype.name] = p
    return out


def _models(path, mode="float32", fuse=True):
    gf = jax_read_ggjt(path, "llama")
    jcfg = dataclasses.replace(jax_config(gf, n_ctx=64), compute_dtype=mode)
    g2 = read_ggjt(path)
    tcfg = dataclasses.replace(config_from_ggjt(g2, n_ctx=64), compute_dtype=mode)
    return ((jcfg, jax_load(gf, jcfg, fuse=fuse)),
            (tcfg, load_transformer(g2, tcfg, device="cpu", fuse=fuse)))


def _logits(jcfg, jp, tcfg, tp, toks=((1, 5, 9, 33, 70),)):
    a = JaxContext(jcfg, jp, n_ctx=64, cache_dtype=jnp.float32)
    b = Context(tcfg, tp, n_ctx=64, cache_dtype=torch.float32, device="cpu")
    x = np.asarray(toks)
    return a.eval(x, logits_all=True), b.eval(x, logits_all=True)


# ------------------------------------------------------------------ ggla

def test_ggla_bytes_equal_and_read_across_packages(tmp_path):
    """write_ggla of either package gives the same bytes; each reads the
    other's file (r, alpha, scaling, tensors, pairs, delta)."""
    t = _tensors(("attention.wq", "feed_forward.w2"), r=3)
    pj, pt = str(tmp_path / "j.ggla"), str(tmp_path / "t.ggla")
    jggla.write_ggla(pj, 3, 12, t)
    ggla.write_ggla(pt, 3, 12, t)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    for got, want in ((ggla.read_ggla(pj), jggla.read_ggla(pt)),
                      (ggla.read_ggla(pt), jggla.read_ggla(pj))):
        assert (got.r, got.alpha, got.scaling) == (want.r, want.alpha, want.scaling) == (3, 12, 4.0)
        assert list(got.tensors) == list(want.tensors) == list(t)
        for name, v in t.items():
            np.testing.assert_array_equal(got.tensors[name], v)
        assert list(got.pairs()) == list(want.pairs())
        for base in got.pairs():
            np.testing.assert_array_equal(got.delta(base), want.delta(base))


@pytest.mark.parametrize("head,match", [(b"\x00" * 16, "magic"),
                                        (np.array([0x67676C61, 2, 4, 8], np.uint32).tobytes(),
                                         "version")])
def test_ggla_bad_header_raises(tmp_path, head, match):
    p = str(tmp_path / "bad.ggla")
    with open(p, "wb") as f:
        f.write(head)
    with pytest.raises(ValueError, match=match):
        ggla.read_ggla(p)


# ------------------------------------------------------------- merged

@pytest.mark.parametrize("qtype", ["Q4_0", "Q8_0", "F32"])
def test_apply_lora_merged_matches_jax(files, qtype):
    """Merged into every projection of both layers: each patched QTensor's
    levels, planes and pack zero byte for byte JAX's (a dense weight's
    values too), untouched tensors kept; then fused, the adapted model's
    logits within 1e-4 of JAX's."""
    (jcfg, jp), (tcfg, tp) = _models(files[qtype], fuse=False)
    ad = jggla.GglaFile(r=4, alpha=8, tensors=_tensors(tuple(SHAPES)))
    jout = jlora.apply_lora(jp, ad)
    tout = lora.apply_lora(tp, ggla.GglaFile(r=4, alpha=8, tensors=ad.tensors))
    for jb, tb, tb0 in zip(jout.blocks, tout.blocks, tp.blocks):
        for f in ("wq", "wk", "wv", "wo", "w_gate", "w_down", "w_up"):
            jw, tw = getattr(jb, f), getattr(tb, f)
            if isinstance(tw, QTensor):
                assert tw.qtype.name == qtype and tw.pack_zero == jw.pack_zero
                np.testing.assert_array_equal(tw.levels_t.numpy(), np.asarray(jw.levels_t))
                np.testing.assert_array_equal(tw.gscale_t.numpy(), np.asarray(jw.gscale_t))
            else:
                np.testing.assert_array_equal(tw.float().numpy(), np.asarray(jw, np.float32))
                assert tw.dtype == getattr(tb0, f).dtype
        assert tb.attn_norm_w is tb0.attn_norm_w
    la, lb = _logits(jcfg, jax_fuse(jcfg, jout), tcfg, fuse_projections(tcfg, tout))
    np.testing.assert_allclose(lb, la, rtol=1e-4, atol=1e-4)


def test_apply_lora_base_weights_and_errors(files):
    """--lora-base: the f32 base model's weights take the place of the
    dequantized ones (JAX's bytes); a dimension mismatch, an unknown tensor
    and a missing one raise as JAX's."""
    (_, jp), (_, tp) = _models(files["Q4_0"], fuse=False)
    base = read_ggjt(files["F32"])
    bw = {n: base.tensor_f32(n) for n in base.tensors}
    ad = jggla.GglaFile(r=4, alpha=8, tensors=_tensors(("attention.wo",)))
    jw = jlora.apply_lora(jp, ad, base_weights=bw).blocks[1].wo
    tw = lora.apply_lora(tp, ggla.GglaFile(4, 8, ad.tensors), base_weights=bw).blocks[1].wo
    np.testing.assert_array_equal(tw.levels_t.numpy(), np.asarray(jw.levels_t))
    np.testing.assert_array_equal(tw.gscale_t.numpy(), np.asarray(jw.gscale_t))
    for tensors, match in ((_tensors(("attention.wo",), k=E // 2), "incompatible"),
                           ({"layers.0.attention.wz.weight.loraA": np.ones((E, 2), np.float32),
                             "layers.0.attention.wz.weight.loraB": np.ones((E, 2), np.float32)},
                            "unknown lora tensor")):
        with pytest.raises(ValueError, match=match):
            jlora.apply_lora(jp, jggla.GglaFile(2, 4, tensors))
        with pytest.raises(ValueError, match=match):
            lora.apply_lora(tp, ggla.GglaFile(2, 4, tensors))


# ------------------------------------------------------------ unmerged

@pytest.mark.parametrize("qtype", ["Q4_0", "F32"])
def test_unmerged_q_matmul_within_jax_tolerance(files, qtype):
    """merge=False: a LowRankPatched weight holding the very base tensor
    (its bytes unchanged); q_matmul equals JAX's and base + x @ delta^T
    within JAX's 1e-4, in f32 and bf16 compute."""
    (_, jp), (_, tp) = _models(files[qtype], fuse=False)
    ad = jggla.GglaFile(r=4, alpha=8, tensors=_tensors(("attention.wo",), layers=(1,)))
    base = tp.blocks[1].wo
    before = (base.levels_t.clone() if isinstance(base, QTensor) else base.clone())
    tout = lora.apply_lora(tp, ggla.GglaFile(4, 8, ad.tensors), merge=False)
    jout = jlora.apply_lora(jp, ad, merge=False)
    w = tout.blocks[1].wo
    assert isinstance(w, LowRankPatched) and w.base is base
    assert isinstance(jout.blocks[1].wo, JaxLowRank)
    assert torch.equal(base.levels_t if isinstance(base, QTensor) else base, before)
    x = np.random.default_rng(7).standard_normal((3, E)).astype(np.float32)
    delta = ad.delta("layers.1.attention.wo.weight")
    for cd, jcd in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = q_matmul(torch.from_numpy(x), w, compute_dtype=cd).numpy()
        want = np.asarray(jax_q_matmul(jnp.asarray(x), jout.blocks[1].wo, use_pallas=False,
                                       compute_dtype=jcd))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        plain = q_matmul(torch.from_numpy(x), base, compute_dtype=cd).numpy() + x @ delta.T
        np.testing.assert_allclose(got, plain, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(w.delta().numpy(), delta, rtol=1e-5, atol=1e-6)


def test_unmerged_qkv_stays_unfused_and_matches_jax_unfused(files):
    """An unmerged adapter on wq, wk and wv of every block (and the gate):
    the port's fuse leaves those groups unfused (JAX's fuse raises on them,
    a trap of the reference: its _concat_n takes a list with no QTensor for
    dense arrays), and the model's logits match JAX's unfused params within
    1e-4; the fused remainder and the untouched bases stay as they were."""
    (jcfg, jp), (tcfg, tp) = _models(files["Q4_0"], fuse=False)
    ad = jggla.GglaFile(r=4, alpha=8, tensors=_tensors(QKV + ("feed_forward.w1",)))
    jout = jlora.apply_lora(jp, ad, merge=False)
    with pytest.raises(AttributeError, match="dtype"):
        jax_fuse(jcfg, jout)
    tout = fuse_projections(tcfg, lora.apply_lora(tp, ggla.GglaFile(4, 8, ad.tensors),
                                                  merge=False))
    for blk, blk0 in zip(tout.blocks, tp.blocks):
        assert blk.wqkv is None and blk.w_gateup is None
        assert isinstance(blk.wq, LowRankPatched) and blk.wq.base is blk0.wq
        assert blk.wo is blk0.wo and blk.w_up is blk0.w_up
    la, lb = _logits(jcfg, jout, tcfg, tout)
    np.testing.assert_allclose(lb, la, rtol=1e-4, atol=1e-4)


def test_params_from_numpy_carries_lowrank_leaves(files):
    """JAX's unmerged params as a numpy tree (LowRankPatched leaves: base,
    a, b, scale) give the port the same model: logits equal to the port's
    own apply_lora(merge=False) bit for bit."""
    (jcfg, jp), (tcfg, tp) = _models(files["Q4_0"], fuse=False)
    ad = jggla.GglaFile(r=4, alpha=8, tensors=_tensors(("attention.wo", "feed_forward.w2")))
    jout = jlora.apply_lora(jp, ad, merge=False)

    def leaf(v):
        if v is None:
            return None
        if isinstance(v, JaxLowRank):
            return {"base": leaf(v.base), "a": np.asarray(v.a), "b": np.asarray(v.b),
                    "scale": v.scale}
        if isinstance(v, JaxQTensor):
            return {"levels_t": np.asarray(v.levels_t), "gscale_t": np.asarray(v.gscale_t),
                    "gbias_t": None if v.gbias_t is None else np.asarray(v.gbias_t),
                    "gsize": v.gsize, "qtype": int(v.qtype), "shape": tuple(v.shape),
                    "pack_zero": v.pack_zero}
        return np.asarray(v)

    tree = {"tok_embeddings": leaf(jout.tok_embeddings),
            "blocks": [{f.name: leaf(getattr(b, f.name)) for f in dataclasses.fields(b)}
                       for b in jout.blocks],
            "out_norm_w": leaf(jout.out_norm_w), "out_norm_b": None,
            "output": leaf(jout.output)}
    conv = params_from_numpy(tree, device="cpu")
    assert isinstance(conv.blocks[0].wo, LowRankPatched)
    own = lora.apply_lora(tp, ggla.GglaFile(4, 8, ad.tensors), merge=False)
    a = Context(tcfg, conv, n_ctx=64, cache_dtype=torch.float32, device="cpu")
    b = Context(tcfg, own, n_ctx=64, cache_dtype=torch.float32, device="cpu")
    x = np.asarray([[1, 5, 9, 33]])
    np.testing.assert_array_equal(a.eval(x, logits_all=True), b.eval(x, logits_all=True))


# ------------------------------------------------------------------ PEFT

def _peft_dir(d, r=4, alpha=16):
    rng = np.random.default_rng(3)
    sd = {}
    for layer in range(2):
        for hf, n in (("self_attn.q_proj", E), ("self_attn.v_proj", E), ("mlp.down_proj", E)):
            k = F if hf == "mlp.down_proj" else E
            pre = f"base_model.model.model.layers.{layer}.{hf}"
            sd[f"{pre}.lora_A.weight"] = torch.from_numpy(
                rng.standard_normal((r, k)).astype(np.float32))
            sd[f"{pre}.lora_B.default.weight"] = torch.from_numpy(
                rng.standard_normal((n, r)).astype(np.float32))
    sd["base_model.model.lm_head.weight"] = torch.zeros(2, 2)  # not a LoRA tensor
    os.makedirs(d, exist_ok=True)
    torch.save(sd, os.path.join(d, "adapter_model.bin"))
    with open(os.path.join(d, "adapter_config.json"), "w") as f:
        json.dump({"peft_type": "LORA", "r": r, "lora_alpha": alpha,
                   "fan_in_fan_out": False}, f)
    return d


def test_convert_peft_dir_bytes_equal_jax(tmp_path):
    """A PEFT directory written with torch.save converts to the bytes JAX's
    convert_peft_dir writes, through the function and through the
    `convert-lora` tool; a non-LORA config raises."""
    d = _peft_dir(str(tmp_path / "peft"))
    jlora.convert_peft_dir(d, str(tmp_path / "j.ggla"))
    lora.convert_peft_dir(d, str(tmp_path / "t.ggla"))
    want = open(tmp_path / "j.ggla", "rb").read()
    assert open(tmp_path / "t.ggla", "rb").read() == want
    assert len(ggla.read_ggla(str(tmp_path / "t.ggla")).pairs()) == 6
    r = subprocess.run([sys.executable, "-m", "llama_cpp_q_4_0_tpu_torch", "convert-lora", d,
                        "-o", str(tmp_path / "cli.ggla")], capture_output=True, cwd=ROOT,
                       timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr.decode()
    assert open(tmp_path / "cli.ggla", "rb").read() == want
    with open(os.path.join(d, "adapter_config.json"), "w") as f:
        json.dump({"peft_type": "PREFIX_TUNING", "r": 4, "lora_alpha": 8}, f)
    with pytest.raises(ValueError, match="LORA"):
        lora.convert_peft_dir(d, str(tmp_path / "x.ggla"))


# ------------------------------------------------------------------- the CLI

@pytest.mark.parametrize("extra", [[], ["--lora-unmerged"], ["--lora-base", "F32"],
                                   ["--lora-base", "Q4_0"]],
                         ids=["merged", "unmerged", "lora_base", "lora_base_q4_0"])
def test_main_lora_prints_the_jax_text(files, extra, tmp_path, capsysbinary):
    """`main --lora` merged, unmerged and over an f32 or a q4_0 --lora-base
    (dequantized on the host), greedy, 4 tokens, an f32 cache, on the q4_0
    file: the JAX main's stdout."""
    import llama_cpp_q_4_0_tpu.cli.main as jax_main

    ad = str(tmp_path / "a.ggla")
    # unmerged, JAX's main fuses a patched QKV group and raises (the trap
    # above): its adapter leaves wq, wk and wv alone
    targets = ("attention.wo", "feed_forward.w2")
    jggla.write_ggla(ad, 4, 8, _tensors(targets if "--lora-unmerged" in extra
                                        else QKV + targets, seed=5))
    extra = [files.get(a, a) for a in extra]
    args = ["-m", files["Q4_0"], "-p", "hello", "-n", "4", "-c", "64", "-s", "1",
            "--temp", "-1", "--ignore-eos", "--memory-f32", "--lora", ad, *extra]
    assert jax_main.main(args) == 0
    want = capsysbinary.readouterr().out
    r = subprocess.run([sys.executable, "-m", "llama_cpp_q_4_0_tpu_torch", "main", *args,
                        "--device", "cpu"], capture_output=True, cwd=ROOT, timeout=300,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout == want and len(r.stdout) > len(b"hello")
