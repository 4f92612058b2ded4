"""The GPT-NeoX, Falcon and Bonsai families on the CPU: the port's fixture
files, config, loader, fuse, forward and Context against the JAX package's
on the same files, and the parity modes (rms_norm_ref, act_f16_table,
ref_f16_softmax) against the JAX ops, with the model-level ref_int8
comparison on a q4_0 LLaMA they unblock."""

import dataclasses
import io
import os
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_cpp_q_4_0_tpu.formats import fixtures as jax_fixtures
from llama_cpp_q_4_0_tpu.formats.ggjt import read_ggjt as jax_read_ggjt
from llama_cpp_q_4_0_tpu.models import fuse as jax_fuse
from llama_cpp_q_4_0_tpu.models import transformer as jax_transformer
from llama_cpp_q_4_0_tpu.models.loading import (
    config_from_ggjt as jax_config, load_transformer as jax_load)
from llama_cpp_q_4_0_tpu.ops import layers as jax_layers
from llama_cpp_q_4_0_tpu.ops.qtensor import QTensor as JaxQTensor
from llama_cpp_q_4_0_tpu.quant.types import GGMLType as JaxGGMLType
from llama_cpp_q_4_0_tpu.runtime.context import Context as JaxContext
from llama_cpp_q_4_0_tpu.runtime.generate import (
    GenerateParams as JaxGenerateParams, generate as jax_generate)
from llama_cpp_q_4_0_tpu.runtime.sampling import SamplingParams as JaxSampling
from llama_cpp_q_4_0_tpu_torch import synth
from llama_cpp_q_4_0_tpu_torch.cli import dispatch
from llama_cpp_q_4_0_tpu_torch.formats import fixtures
from llama_cpp_q_4_0_tpu_torch.formats.ggjt import read_ggjt
from llama_cpp_q_4_0_tpu_torch.models import fuse, transformer
from llama_cpp_q_4_0_tpu_torch.models.loading import config_from_ggjt, load_transformer
from llama_cpp_q_4_0_tpu_torch.ops import layers
from llama_cpp_q_4_0_tpu_torch.ops.kvcache import QuantKV, quantize_kv
from llama_cpp_q_4_0_tpu_torch.ops.qtensor import QTensor
from llama_cpp_q_4_0_tpu_torch.quant.types import GGMLType
from llama_cpp_q_4_0_tpu_torch.runtime.context import Context
from llama_cpp_q_4_0_tpu_torch.runtime.device_sample import DeviceSampling, generate_ondevice
from llama_cpp_q_4_0_tpu_torch.runtime.generate import GenerateParams, generate
from llama_cpp_q_4_0_tpu_torch.runtime.sampling import SamplingParams

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# small shapes: one intra-op thread keeps the suite's parallel workers from
# oversubscribing the cores
torch.set_num_threads(1)

PROMPT = [1, 5, 10, 42, 7, 9]
SEQ = [PROMPT, [3], [100], [200]]  # a prefill and three decode steps

# (arch, the port's fixture, its arguments): each family in its parallel
# residual and in its serial one.  GPT-NeoX ropes 4 of its 16 head dims
# (partial NeoX RoPE, rotary_pct 0.25); a serial Falcon or Bonsai file holds
# the optional post_attn_layernorm, which the JAX generator never writes.
VARIANTS = {
    "gptneox": ("gptneox", fixtures.make_gptneox_ggjt, dict(n_rot=4)),
    "gptneox_serial": ("gptneox", fixtures.make_gptneox_ggjt,
                       dict(n_rot=4, use_parallel_residual=0)),
    "falcon": ("falcon", fixtures.make_falcon_like_ggjt, dict(arch="falcon")),
    "falcon_serial": ("falcon", fixtures.make_falcon_like_ggjt,
                      dict(arch="falcon", parallel_attn=0, post_attn_norm=True)),
    "bonsai": ("bonsai", fixtures.make_falcon_like_ggjt, dict(arch="bonsai")),
    "bonsai_serial": ("bonsai", fixtures.make_falcon_like_ggjt,
                      dict(arch="bonsai", parallel_attn=0, post_attn_norm=True)),
}
# n_embd 256 (head_dim 64, as Falcon-7B's; GPT-NeoX 128): every matmul inside
# the kernels' gate, so the port's bf16 path takes the kernels' routes
WIDE = dict(n_embd=256, n_head=4)


def _write(tmp_path_factory, name, **extra):
    arch, make, kw = VARIANTS[name]
    kw = {**kw, **extra}
    path = str(tmp_path_factory.mktemp(name) / f"{name}.ggjt")
    if "arch" in kw:
        make(path, kw.pop("arch"), **kw)
    else:
        make(path, **kw)
    return arch, path


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request, tmp_path_factory):
    return _write(tmp_path_factory, request.param)


def _jax(arch, path, mode="float32", n_ctx=64, fuse_=True, **kw):
    gf = jax_read_ggjt(path, arch)
    cfg = dataclasses.replace(jax_config(gf, n_ctx=n_ctx), compute_dtype=mode, **kw)
    return cfg, jax_load(gf, cfg, fuse=fuse_)


def _port(arch, path, mode="float32", n_ctx=64, fuse_=True, **kw):
    gf = read_ggjt(path, arch)
    cfg = dataclasses.replace(config_from_ggjt(gf, n_ctx=n_ctx), compute_dtype=mode, **kw)
    return cfg, load_transformer(gf, cfg, device="cpu", fuse=fuse_)


def _contexts(arch, path, mode="float32", **kw):
    jcfg, jp = _jax(arch, path, mode, **kw)
    tcfg, tp = _port(arch, path, mode, **kw)
    cache = (jnp.float32, torch.float32) if mode != "bfloat16" else (jnp.bfloat16,
                                                                     torch.bfloat16)
    return (JaxContext(jcfg, jp, n_ctx=64, cache_dtype=cache[0]),
            Context(tcfg, tp, n_ctx=64, cache_dtype=cache[1], device="cpu"))


def _steps(ctx, seq=SEQ, **kw):
    return [ctx.eval(np.asarray([toks]), **kw) for toks in seq]


def _leaves(params):
    """(name, array) of every tensor of params, QTensor planes included."""
    out = []

    def add(name, v):
        if v is None:
            return
        if isinstance(v, (QTensor, JaxQTensor)):
            out.append((name + ".levels_t", v.levels_t))
            out.append((name + ".gscale_t", v.gscale_t))
            if v.gbias_t is not None:
                out.append((name + ".gbias_t", v.gbias_t))
            out.append((name + ".meta", np.asarray(
                [*v.shape, v.gsize, int(v.qtype), -1 if v.pack_zero is None else v.pack_zero])))
        else:
            out.append((name, v))

    for f in ("tok_embeddings", "out_norm_w", "out_norm_b", "output"):
        add(f, getattr(params, f))
    for i, blk in enumerate(params.blocks):
        for f in dataclasses.fields(blk):
            add(f"blocks.{i}.{f.name}", getattr(blk, f.name))
    return [(n, np.asarray(a.float() if isinstance(a, torch.Tensor) and
                           a.dtype == torch.bfloat16 else a)) for n, a in out]


def _assert_same_bytes(tp, jp):
    a, b = _leaves(tp), _leaves(jp)
    assert [n for n, _ in a] == [n for n, _ in b]
    for (name, x), (_, y) in zip(a, b):
        y = np.asarray(y, dtype=np.float32) if y.dtype.name == "bfloat16" else y
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


# -------------------------------------------------------------- fixtures

@pytest.mark.parametrize("name,jax_make,port_make,kw", [
    ("llama", jax_fixtures.make_llama_ggjt, fixtures.make_llama_ggjt, {}),
    ("llama_q8_0", jax_fixtures.make_llama_ggjt, fixtures.make_llama_ggjt,
     dict(qtype="Q8_0", seed=3)),
    ("gptneox", jax_fixtures.make_gptneox_ggjt, fixtures.make_gptneox_ggjt,
     dict(n_rot=4, use_parallel_residual=0)),
    ("falcon", jax_fixtures.make_falcon_like_ggjt, fixtures.make_falcon_like_ggjt,
     dict(arch="falcon", seed=5)),
    ("bonsai", jax_fixtures.make_falcon_like_ggjt, fixtures.make_falcon_like_ggjt,
     dict(arch="bonsai", n_embd=256, qtype="F16")),
])
def test_fixture_files_equal_jax(tmp_path, name, jax_make, port_make, kw):
    """The port's generators write the JAX package's files byte for byte."""
    pa, pb = str(tmp_path / "jax.ggjt"), str(tmp_path / "port.ggjt")
    args = [kw.pop("arch")] if "arch" in kw else []
    jkw, tkw = dict(kw), dict(kw)
    if "qtype" in kw:
        jkw["qtype"], tkw["qtype"] = JaxGGMLType[kw["qtype"]], GGMLType[kw["qtype"]]
    jax_make(pa, *args, **jkw)
    port_make(pb, *args, **tkw)
    with open(pa, "rb") as fa, open(pb, "rb") as fb:
        assert fa.read() == fb.read()


# ------------------------------------------------------- config and loader

def test_config_equals_jax(variant):
    arch, path = variant
    want = dataclasses.asdict(jax_config(jax_read_ggjt(path, arch), n_ctx=128))
    got = dataclasses.asdict(config_from_ggjt(read_ggjt(path, arch), n_ctx=128))
    assert want.pop("rescale_every") == 0  # RWKV's, not ported
    assert got == want


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
def test_loaded_bytes_equal_jax(variant, fused):
    """Every level byte, plane, bias and norm of the loaded params equals the
    JAX package's: Q, K and V split from the fused tensor by row groups
    through the planar repack (a group's pack zero is its own), then fused
    again at kv_heads width."""
    arch, path = variant
    _, jp = _jax(arch, path, "bfloat16", fuse_=fused)
    _, tp = _port(arch, path, "bfloat16", fuse_=fused)
    _assert_same_bytes(tp, jp)
    blk = tp.blocks[0]
    assert (blk.wqkv is not None) == fused and (blk.wq is None) == fused


def test_fuse_defuse_round_trip(variant):
    """defuse(fuse(split)) gives back the split tensors, fuse(defuse(fused))
    the fused ones, and the port's defused params equal the JAX package's."""
    arch, path = variant
    cfg, split = _port(arch, path, fuse_=False)
    _, fused = _port(arch, path)
    _assert_same_bytes(fuse.defuse_projections(cfg, fuse.fuse_projections(cfg, split)), split)
    _assert_same_bytes(fuse.fuse_projections(cfg, fuse.defuse_projections(cfg, fused)), fused)
    jcfg, jfused = _jax(arch, path)
    _assert_same_bytes(fuse.defuse_projections(cfg, fused),
                       jax_fuse.defuse_projections(jcfg, jfused))


# ------------------------------------------------------ forward and Context

def test_f32_logits_match_jax(variant):
    """compute_dtype float32 on f32 caches: the same arithmetic in another
    summation order, logits within 1e-4 (tests/test_torch_model.py's gate),
    over a prefill and three decode steps, with all logits of the prefill."""
    jc, tc = _contexts(*variant)
    first = [(jc.eval(np.asarray([PROMPT]), logits_all=True),
              tc.eval(np.asarray([PROMPT]), logits_all=True))]
    for (a, b) in first + list(zip(_steps(jc, SEQ[1:]), _steps(tc, SEQ[1:]))):
        assert b.shape == a.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)


def test_greedy_tokens_match_jax(variant):
    """generate with temp 0, f32 compute and cache: the same 16 tokens."""
    arch, path = variant
    jcfg, jp = _jax(arch, path, n_ctx=128)
    tcfg, tp = _port(arch, path, n_ctx=128)
    jt = list(jax_generate(JaxContext(jcfg, jp, n_ctx=128, cache_dtype=jnp.float32),
                           PROMPT, JaxGenerateParams(sampling=JaxSampling(temp=0.0),
                                                     n_predict=16, ignore_eos=True)))
    tt = list(generate(Context(tcfg, tp, n_ctx=128, cache_dtype=torch.float32, device="cpu"),
                       PROMPT, GenerateParams(sampling=SamplingParams(temp=0.0),
                                              n_predict=16, ignore_eos=True)))
    assert tt == jt and len(tt) == 16


def test_embed_and_eval_embd_match_jax(variant):
    """Context.embed and eval_embd against the JAX package's, f32, at 1e-4."""
    jc, tc = _contexts(*variant)
    np.testing.assert_allclose(tc.embed(PROMPT), jc.embed(PROMPT), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tc.logits, jc.logits, rtol=0, atol=1e-4)
    emb = transformer._embed(tc.params, torch.tensor([[4, 8, 15]])).numpy()
    np.testing.assert_allclose(tc.eval_embd(emb, logits_all=True),
                               jc.eval_embd(emb, logits_all=True), rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", ["gptneox", "falcon", "bonsai"])
def test_bf16_within_kfold_class(tmp_path_factory, name):
    """bf16 compute on a bf16 cache at n_embd 256, every matmul inside the
    kernels' gate: the port's decode-shaped calls take the kfold form (the
    plain version of K2 on the CPU), the JAX package its unfolded product,
    so logits agree within kfold's ~3e-2 of their scale (the LLaMA gate of
    tests/test_torch_model.py)."""
    arch, path = _write(tmp_path_factory, name, **WIDE)
    jc, tc = _contexts(arch, path, "bfloat16")
    for a, b in zip(_steps(jc), _steps(tc)):
        assert np.isfinite(b).all()
        assert np.abs(b - a).max() <= 3e-2 * np.abs(a).max()


def test_cache_has_kv_heads(variant):
    """The KV cache holds kv_heads heads a slot: one for Falcon and Bonsai."""
    arch, path = variant
    cfg, _ = _port(arch, path)
    ck, _ = transformer.init_cache(cfg, 1, 32, device="cpu")
    assert ck[0].shape == (1, 32, 1 if arch != "gptneox" else cfg.n_head, cfg.head_dim)


@pytest.mark.parametrize("cache", ["f32", "q8"])
@pytest.mark.parametrize("name", ["gptneox", "falcon"])
def test_generate_ondevice_greedy_matches_jax(tmp_path_factory, name, cache):
    """generate_ondevice greedy (decode_chunk, the eager loop on the CPU),
    chunk 4, f32 compute: the JAX package's tokens on an f32 cache and on a
    q8 one."""
    from llama_cpp_q_4_0_tpu.runtime import device_sample as jax_device_sample

    arch, path = _write(tmp_path_factory, name)
    jcfg, jp = _jax(arch, path, n_ctx=128)
    tcfg, tp = _port(arch, path, n_ctx=128)
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "q8": (jnp.int8, torch.int8)}[cache]
    want = jax_device_sample.generate_ondevice(
        JaxContext(jcfg, jp, n_ctx=128, cache_dtype=jdt), PROMPT, 12,
        sampling=jax_device_sample.DeviceSampling(temp=-1.0), chunk=4)
    got = generate_ondevice(Context(tcfg, tp, n_ctx=128, cache_dtype=tdt, device="cpu"),
                            PROMPT, 12, sampling=DeviceSampling(temp=-1.0), chunk=4)
    assert got == want and len(got) == 12


@pytest.mark.parametrize("name", ["gptneox", "falcon", "bonsai"])
def test_synth_builders(name):
    """synth's family builders at small widths on the CPU: the loader's
    layout (fused QKV at kv_heads width, biases where the family has them)
    and finite logits through a Context."""
    build = {"gptneox": synth.build_gptneox, "falcon": synth.build_falcon,
             "bonsai": synth.build_bonsai}[name]
    cfg, params = build(n_layer=2, n_embd=256, n_head=4, n_vocab=512, n_ctx=64,
                        device="cpu", seed=1)
    blk = params.blocks[0]
    kvd = cfg.kv_heads * cfg.head_dim
    assert cfg.arch == name and blk.wqkv.shape == (cfg.n_embd + 2 * kvd, cfg.n_embd)
    assert (blk.b_qkv is not None) == (name == "gptneox") and blk.attn_norm_b is not None
    assert name != "gptneox" or cfg.n_rot == 16  # rotary_pct 0.25 of 64
    logits = _steps(Context(cfg, params, n_ctx=64, device="cpu"))
    assert all(np.isfinite(x).all() for x in logits)


# ----------------------------------------------------------------- the CLI

@pytest.fixture(scope="module")
def bonsai_file(tmp_path_factory):
    """A bonsai file of the port's generator: it reads as falcon unless
    --arch names it."""
    path = str(tmp_path_factory.mktemp("cli") / "bonsai.ggjt")
    fixtures.make_falcon_like_ggjt(path, "bonsai", seed=2)
    return path


def test_main_arch_bonsai_prints_the_jax_text(bonsai_file, capsysbinary):
    """`python -m llama_cpp_q_4_0_tpu_torch main --arch bonsai` prints what
    the JAX package's `main` prints: the prompt and 4 greedy tokens, both in
    bf16 off the kernels' gate (n_embd 64), as tests/test_torch_cli.py."""
    from llama_cpp_q_4_0_tpu.cli import main as jax_main

    args = ["-m", bonsai_file, "--arch", "bonsai", "-p", "hello", "-n", "4", "-c", "64",
            "-s", "1", "--temp", "0"]
    assert jax_main.main(args) == 0
    want = capsysbinary.readouterr().out
    r = subprocess.run([sys.executable, "-m", "llama_cpp_q_4_0_tpu_torch", "main", *args,
                        "--device", "cpu"], capture_output=True, cwd=ROOT, timeout=300,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout == want and r.stdout.startswith(b"hello") and len(r.stdout) > 5
    assert b"bonsai: loaded" in r.stderr


def test_embedding_arch_bonsai_prints_the_jax_values(bonsai_file, capsys):
    """`embedding --arch bonsai` against the JAX tool: n_embd values within
    1e-2 of their scale (tests/test_torch_step.py's embedding gate: bf16
    activations rounded apart by another summation order)."""
    from llama_cpp_q_4_0_tpu.cli import embedding as jax_embedding

    args = ["-m", bonsai_file, "--arch", "bonsai", "-p", "hello world", "-c", "64"]
    assert jax_embedding.main(args) == 0
    want = capsys.readouterr().out.splitlines()
    out = io.StringIO()
    with redirect_stdout(out):
        assert dispatch(["embedding", *args, "--device", "cpu"]) == 0
    a = np.asarray([float(v) for v in want[0].split()])
    b = np.asarray([float(v) for v in out.getvalue().splitlines()[0].split()])
    assert len(b) == len(a) == 64 and np.isfinite(b).all()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-2 * np.abs(a).max())


# ------------------------------------------------------------ parity modes

def _x(shape=(3, 5, 256), seed=0, scale=3.0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale


def test_rms_norm_ref_equals_jax_op_by_op():
    """The Kahan-summed rms_norm_ref equals the JAX function run op by op,
    bit for bit.  Under jax.jit XLA rewrites its 1/sqrt into an rsqrt, which
    rounds differently: the jitted function departs by an ulp in places."""
    x, w = _x(), _x((256,), 1, 1.0)
    want = np.asarray(jax_layers.rms_norm_ref(jnp.asarray(x), jnp.asarray(w), 1e-6))
    got = layers.rms_norm_ref(torch.from_numpy(x), torch.from_numpy(w), 1e-6).numpy()
    np.testing.assert_array_equal(got, want)
    jitted = np.asarray(jax.jit(jax_layers.rms_norm_ref)(jnp.asarray(x), jnp.asarray(w), 1e-6))
    assert (jitted != want).any()
    np.testing.assert_allclose(got, jitted, rtol=1e-6, atol=0)


@pytest.mark.parametrize("act", ["silu", "gelu", "bonsai_hybrid"])
def test_act_f16_table_matches_jax(act):
    """The fp16-table activations: silu bit for bit; gelu and grelu, whose
    tanh differs in the last f32 ulps between XLA and PyTorch, by at most one
    f16 step where that crosses a rounding boundary (a few percent of the
    values), plus the plain activations' own f32 noise (1e-5: 1 + tanh
    cancels for negative inputs)."""
    x = _x()
    jfn = {"silu": jax_layers.silu, "gelu": jax_layers.gelu,
           "bonsai_hybrid": jax_transformer.grelu}[act]
    tfn = transformer._ACTS[act]
    want = np.asarray(jax.jit(lambda v: jax_layers.act_f16_table(jfn, v))(jnp.asarray(x)))
    got = layers.act_f16_table(tfn, torch.from_numpy(x)).numpy()
    if act == "silu":
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -10, atol=1e-5)
    assert (got == want).mean() > 0.95
    plain = np.asarray(jax.jit(jfn)(jnp.asarray(x)))
    np.testing.assert_allclose(tfn(torch.from_numpy(x)).numpy(), plain, rtol=0, atol=1e-5)


def test_norms_and_alibi_match_jax():
    """layer_norm and bonsai_rms_norm (its default eps 1e-5) at f32
    summation-order noise; alibi_bias exactly."""
    x, w, b = _x(), _x((256,), 1, 1.0), _x((256,), 2, 0.1)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    jx, jw, jb = (jnp.asarray(a) for a in (x, w, b))
    np.testing.assert_allclose(layers.layer_norm(tx, tw, tb, 1e-5).numpy(),
                               np.asarray(jax_layers.layer_norm(jx, jw, jb, 1e-5)),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(transformer.bonsai_rms_norm(tx, tw, tb).numpy(),
                               np.asarray(jax_transformer.bonsai_rms_norm(jx, jw, jb)),
                               rtol=0, atol=1e-5)
    for n_head in (8, 12, 71):
        np.testing.assert_array_equal(layers.alibi_bias(n_head, 40).numpy(),
                                      np.asarray(jax_layers.alibi_bias(n_head, 40)))


@pytest.mark.parametrize("cache", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("g", [1, 2, 4], ids=["mqa", "gqa", "mha"])
def test_ref_f16_softmax_attention_matches_jax(cache, g):
    """attention(ref_f16_softmax=True): the fp16 exp-table softmax on the
    exact f32 chain, for every cache type (no bf16 operands, as in JAX),
    against the JAX package's at f32 summation-order noise."""
    rng = np.random.default_rng(g)
    b, t, h, d, s = 2, 3, 4, 16, 32
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, g, d)).astype(np.float32)
    v = rng.standard_normal((b, s, g, d)).astype(np.float32)
    pos = np.array([[5, 6, 7], [10, 11, 12]])
    mask = np.arange(s)[None] < pos[:, -1:] + 1
    if cache == "int8":
        (kq, ks), (vq, vs) = quantize_kv(torch.from_numpy(k)), quantize_kv(torch.from_numpy(v))
        tk, tv = QuantKV(kq, ks), QuantKV(vq, vs)
        from llama_cpp_q_4_0_tpu.ops.kvcache import QuantKV as JaxQuantKV

        jk = JaxQuantKV(jnp.asarray(kq.numpy()), jnp.asarray(ks.numpy()))
        jv = JaxQuantKV(jnp.asarray(vq.numpy()), jnp.asarray(vs.numpy()))
    else:
        tdt, jdt = {"f32": (torch.float32, jnp.float32),
                    "bf16": (torch.bfloat16, jnp.bfloat16)}[cache]
        tk, tv = torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt)
        jk, jv = jnp.asarray(k).astype(jdt), jnp.asarray(v).astype(jdt)
    want = np.asarray(jax.jit(lambda *a: jax_layers.attention(*a, 0.25, ref_f16_softmax=True))(
        jnp.asarray(q), jk, jv, jnp.asarray(pos), jnp.asarray(mask)))
    got = layers.attention(torch.from_numpy(q), tk, tv, torch.from_numpy(pos),
                           torch.from_numpy(mask), 0.25, ref_f16_softmax=True).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_parity_modes_model_matches_jax(variant):
    """act_f16_table on each family (the table activations and the table
    softmax; these families' norms are not rms_norm), f32 compute and cache,
    over a prefill (all logits) and three decode steps.  The tables round to
    fp16, so an f32 ulp between XLA's tanh and PyTorch's moves an activation
    by a whole fp16 step now and then: held at the JAX package's own gate
    for this mode (tests/test_reference_parity.py,
    test_gptneox_logits_parity_f32_table: 2e-3 absolute, argmax equal)."""
    jc, tc = _contexts(*variant, act_f16_table=True)
    for a, b in zip(_steps(jc, logits_all=True), _steps(tc, logits_all=True)):
        assert np.abs(b - a).max() < 2e-3
        assert (a.argmax(-1) == b.argmax(-1)).all()


@pytest.fixture(scope="module")
def llama_q4_0(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ri8") / "llama.ggjt")
    fixtures.make_llama_ggjt(path)
    return "llama", path


def test_ref_int8_q4_0_tables_match_jax_op_by_op(llama_q4_0):
    """The model-level ref_int8 comparison on the q4_0 LLaMA fixture, with
    act_f16_table on (rms_norm_ref, the fp16 tables), against the JAX
    package run op by op: logits within 1e-5 (the pinned exactness of JAX's
    own ref_int8 gate against the compiled reference), greedy argmax equal
    at every position.  The q8 roundf ties of the q4_0 embedding rows
    (tests/test_torch_q8x.py) now round alike, since both rms_norm_refs are
    the same f32 operations."""
    with jax.disable_jit():
        jc, tc = _contexts(*llama_q4_0, mode="ref_int8", act_f16_table=True)
        for toks in SEQ:
            a = jc.eval(np.asarray([toks]), logits_all=True)
            b = tc.eval(np.asarray([toks]), logits_all=True)
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
            assert (a.argmax(-1) == b.argmax(-1)).all()


def test_ref_int8_q4_0_tables_within_jax_gate(llama_q4_0):
    """The same against the JAX Context as it runs (jitted): XLA's rsqrt in
    place of rms_norm_ref's 1/sqrt moves some norms by an ulp, which flips
    q8 ties downstream (test_rms_norm_ref_equals_jax_op_by_op).  Held at
    JAX's own ref_int8 gate against the compiled reference
    (tests/test_reference_parity.py): the largest logit error under 5e-2 of
    the largest logit, the argmax equal at every position, and the same 16
    greedy tokens."""
    jc, tc = _contexts(*llama_q4_0, mode="ref_int8", act_f16_table=True)
    for toks in SEQ:
        a = jc.eval(np.asarray([toks]), logits_all=True)
        b = tc.eval(np.asarray([toks]), logits_all=True)
        assert np.abs(b - a).max() < 5e-2 * np.abs(a).max()
        assert (a.argmax(-1) == b.argmax(-1)).all()
    jc, tc = _contexts(*llama_q4_0, mode="ref_int8", act_f16_table=True)
    jt = list(jax_generate(jc, PROMPT, JaxGenerateParams(
        sampling=JaxSampling(temp=0.0), n_predict=16, ignore_eos=True)))
    tt = list(generate(tc, PROMPT, GenerateParams(
        sampling=SamplingParams(temp=0.0), n_predict=16, ignore_eos=True)))
    assert tt == jt
