"""Two repairs of the port against the JAX package on the CPU.

- A q4_0 tensor whose K is not a multiple of 64 loads through the planar
  repack, as the JAX loader's ``_q4_0_native`` hands it on: the params of
  ``make_llama_ggjt(n_embd=32, n_layer=1)`` equal JAX's byte for byte, and
  the model's f32 logits JAX's.
- Host dequantization (``quant/registry.py::dequantize`` and
  ``dequantize_bytes``, ``GGJTFile.tensor_f32``) gives JAX's float32 bit for
  bit for every QK_K = 256 type, on quantized rows and on random block bytes
  (NaN and infinite scales included).  The ``main --lora-base`` test over a
  q4_0 base lies in tests/test_torch_lora.py."""

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
from llama_cpp_q_4_0_tpu.quant import registry as jax_registry
from llama_cpp_q_4_0_tpu.quant.types import GGMLType as JaxType
from llama_cpp_q_4_0_tpu.runtime.context import Context as JaxContext
from llama_cpp_q_4_0_tpu_torch.formats.ggjt import read_ggjt
from llama_cpp_q_4_0_tpu_torch.models.loading import config_from_ggjt, load_transformer
from llama_cpp_q_4_0_tpu_torch.ops.qtensor import QTensor
from llama_cpp_q_4_0_tpu_torch.quant import registry
from llama_cpp_q_4_0_tpu_torch.quant.types import GGMLType, type_traits
from llama_cpp_q_4_0_tpu_torch.runtime.context import Context

torch.set_num_threads(1)

TYPES = sorted(registry.DEQUANTIZERS, key=int)


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    """q4_0 at n_embd 32: every wq..w3 and the output head has K = 32 or
    n_ff, off the direct repack's K % 64."""
    p = str(tmp_path_factory.mktemp("narrow") / "w.bin")
    make_llama_ggjt(p, n_vocab=256, n_embd=32, n_head=2, n_layer=1, seed=99)
    return p


def _leaves(params):
    out = {"tok_embeddings": params.tok_embeddings, "output": params.output,
           "out_norm_w": params.out_norm_w}
    for i, b in enumerate(params.blocks):
        for f in dataclasses.fields(b):
            out[f"{i}.{f.name}"] = getattr(b, f.name)
    return out


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
    return np.asarray(v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v)


def test_q4_0_k32_loads_the_jax_bytes(narrow):
    """Every leaf of the port's params equals JAX's: levels, scale planes,
    pack zero, group size and shape of each QTensor; dense and norm arrays."""
    jgf, gf = jax_read_ggjt(narrow), read_ggjt(narrow)
    jp = jax_load(jgf, jax_config(jgf, n_ctx=64))
    tp = load_transformer(gf, config_from_ggjt(gf, n_ctx=64), device="cpu")
    jl, tl = _leaves(jp), _leaves(tp)
    assert jl.keys() == tl.keys()
    n_q = 0
    for name, j in jl.items():
        t = tl[name]
        if j is None:
            assert t is None, name
            continue
        if isinstance(j, JaxQTensor):
            n_q += 1
            assert isinstance(t, QTensor), name
            assert (t.gsize, int(t.qtype), tuple(t.shape), t.pack_zero) == (
                j.gsize, int(j.qtype), tuple(j.shape), j.pack_zero), name
            for f in ("levels_t", "gscale_t", "gbias_t"):
                a, b = getattr(j, f), getattr(t, f)
                assert (a is None) == (b is None), (name, f)
                if a is not None:
                    np.testing.assert_array_equal(_host(b), _host(a), err_msg=f"{name}.{f}")
        else:
            np.testing.assert_array_equal(_host(t), _host(j), err_msg=name)
    assert n_q >= 4


def test_q4_0_k32_model_logits_match_jax(narrow):
    """The narrow model in f32 compute with an f32 cache: a prompt and two
    decode steps give JAX's logits within 1e-5 (both take the plain
    dequantizing product: K = 32 lies off the kernel gate)."""
    jgf, gf = jax_read_ggjt(narrow), read_ggjt(narrow)
    jcfg = dataclasses.replace(jax_config(jgf, n_ctx=64), compute_dtype="float32")
    tcfg = dataclasses.replace(config_from_ggjt(gf, n_ctx=64), compute_dtype="float32")
    jctx = JaxContext(jcfg, jax_load(jgf, jcfg), cache_dtype=jnp.float32)
    tctx = Context(tcfg, load_transformer(gf, tcfg, device="cpu"), cache_dtype=torch.float32,
                   device="cpu")
    for toks in ([1, 5, 10, 42], [7], [9]):
        a, b = jctx.eval(np.asarray([toks])), tctx.eval(np.asarray([toks]))
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)


def _same_bits(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("t", TYPES, ids=lambda t: t.name)
def test_dequantize_equals_jax_bit_for_bit(t):
    """Quantized rows of several shapes, and random block bytes, through the
    port's dequantize and dequantize_bytes: JAX's float32 bits."""
    jt = JaxType(int(t))
    tr = type_traits(t)
    rng = np.random.default_rng(int(t))
    for shape in ((tr.block_size,), (3, 2 * tr.block_size), (2, 2, tr.block_size)):
        x = (rng.standard_normal(shape) * 3).astype(np.float32)
        blocks = jax_registry.quantize(x, jt)
        _same_bits(registry.dequantize(blocks, t), jax_registry.dequantize(blocks, jt))
    raw = rng.integers(0, 256, size=5 * tr.type_size, dtype=np.uint8)
    with np.errstate(all="ignore"):
        _same_bits(registry.dequantize(raw.view(tr.block_dtype), t),
                   jax_registry.dequantize(raw.view(tr.block_dtype), jt))
        _same_bits(registry.dequantize_bytes(raw.tobytes(), t, (5, tr.block_size)),
                   jax_registry.dequantize_bytes(raw.tobytes(), jt, (5, tr.block_size)))


def test_dequantize_bytes_float_and_errors():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    _same_bits(registry.dequantize_bytes(x.tobytes(), GGMLType.F32, (3, 4)), x)
    _same_bits(registry.dequantize_bytes(x.astype(np.float16).tobytes(), GGMLType.F16,
                                         (3, 4)), x)
    with pytest.raises(ValueError, match="do not hold"):
        registry.dequantize_bytes(bytes(18), GGMLType.Q4_0, (64,))
    with pytest.raises(NotImplementedError):
        registry.dequantize(np.zeros(1, np.float32), GGMLType.I8)


@pytest.mark.parametrize("qtype", ["Q4_0", "Q5_1", "Q8_0"])
def test_tensor_f32_dequantizes_as_jax(tmp_path, qtype):
    """GGJTFile.tensor_f32 of every tensor of a quantized file: JAX's."""
    p = str(tmp_path / "m.bin")
    make_llama_ggjt(p, n_vocab=256, n_embd=64, n_head=2, n_layer=1, qtype=JaxType[qtype])
    jgf, gf = jax_read_ggjt(p), read_ggjt(p)
    assert any(t.qtype == GGMLType[qtype] for t in gf.tensors.values())
    for name in gf.tensors:
        _same_bits(gf.tensor_f32(name), np.asarray(jgf.tensor_f32(name), np.float32))
