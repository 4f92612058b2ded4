"""The port's quantizers (quant/registry.py), planar repack (quant/pack.py),
QTensor.from_planar and QTensor.quantize against the JAX package's, format
by format (CPU)."""

import numpy as np
import pytest
import torch

from llama_cpp_q_4_0_tpu.ops.qtensor import QTensor as JaxQTensor
from llama_cpp_q_4_0_tpu.quant.pack import pack_planar as jax_pack_planar
from llama_cpp_q_4_0_tpu.quant.registry import quantize
from llama_cpp_q_4_0_tpu_torch.quant.registry import quantize as port_quantize
from llama_cpp_q_4_0_tpu.quant.types import GGMLType as JaxGGMLType
from llama_cpp_q_4_0_tpu_torch.formats.ggjt import read_ggjt
from llama_cpp_q_4_0_tpu_torch.ops.qtensor import QTensor
from llama_cpp_q_4_0_tpu_torch.quant.pack import pack_planar
from llama_cpp_q_4_0_tpu_torch.quant.types import GGMLType, type_traits

torch.set_num_threads(1)

FORMATS = ["Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0", "Q2_K", "Q3_K", "Q4_K",
           "Q5_K", "Q6_K"]


def _blocks(name, n, k, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    blocks = quantize(w, JaxGGMLType[name])
    # the port reads the same bytes through its own block dtype
    mine = np.frombuffer(blocks.tobytes(), dtype=type_traits(GGMLType[name]).block_dtype)
    return blocks, mine


def _same(a, b, what):
    """Arrays equal bit for bit (float planes compared as their raw bits)."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape,
                                                       a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=what)


# K = 768: K/2 = 384 rounds up to 512 packed rows, so packing pads
@pytest.mark.parametrize("name", FORMATS)
@pytest.mark.parametrize("n,k", [(48, 768), (16, 512)])
def test_repack_equals_jax(name, n, k):
    """pack_planar gives JAX's levels, scales and biases exactly, and
    from_planar JAX's device arrays byte for byte, packed or unpacked."""
    jblocks, blocks = _blocks(name, n, k, seed=k + len(name))
    jp = jax_pack_planar(jblocks, JaxGGMLType[name], (n, k))
    p = pack_planar(blocks, GGMLType[name], (n, k))
    assert p.gsize == jp.gsize and p.shape == tuple(jp.shape)
    _same(jp.levels, p.levels, "levels")
    _same(jp.gscale, p.gscale, "gscale")
    assert (p.gbias is None) == (jp.gbias is None)
    if p.gbias is not None:
        _same(jp.gbias, p.gbias, "gbias")
    jq = JaxQTensor.from_planar(jp)
    q = QTensor.from_planar(p, device="cpu")
    assert q.pack_zero == jq.pack_zero and q.gsize == jq.gsize
    _same(jq.levels_t, q.levels_t.numpy(), "levels_t")
    _same(jq.gscale_t, q.gscale_t.numpy(), "gscale_t")
    assert (q.gbias_t is None) == (jq.gbias_t is None)
    if q.gbias_t is not None:
        _same(jq.gbias_t, q.gbias_t.numpy(), "gbias_t")
    # the views every consumer reads: levels, scale/bias groups, W^T, rows
    _same(jq.levels_full(), q.levels_full().numpy(), "levels_full")
    _same(jq.gscale_full(), q.gscale_full().numpy(), "gscale_full")
    _same(jq.dequantize_t(), q.dequantize_t().numpy(), "dequantize_t")
    idx = np.array([[0, 5, n - 1], [3, 3, 1]], np.int32)
    _same(jq.rows(idx), q.rows(torch.from_numpy(idx).long()).numpy(), "rows")


def test_qkk64_file_raises(tmp_path):
    """A file with 64-element k-quant super-blocks does not parse as QK_K=256:
    the reader says so instead of misreading it."""
    from llama_cpp_q_4_0_tpu.formats.fixtures import make_llama_ggjt

    path = str(tmp_path / "qkk64.ggjt")
    make_llama_ggjt(path, n_embd=64, n_mult=64, n_vocab=64,
                    qtype=JaxGGMLType.Q4_K, qk_k=64)
    with pytest.raises(NotImplementedError, match="QKK_64"):
        read_ggjt(path)


QUANTIZED = FORMATS + ["Q8_1", "Q8_K"]


def _rows(n, k, seed):
    """Weights with the corner cases of the scalar loops: a row of zeros, a
    row whose blocks hold one repeated value, and one repeated magnitude with
    both signs (signed-absmax ties, first occurrence wins)."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    w[1] = 0.0
    w[2] = 0.25
    w[3, ::2], w[3, 1::2] = 0.5, -0.5
    return w


@pytest.mark.parametrize("name", QUANTIZED)
@pytest.mark.parametrize("k", [256, 768])
def test_quantize_bytes_equal_jax(name, k):
    """The port's quantize(x, t) writes the JAX quantizer's blocks byte for
    byte, for rows of 256 * k elements."""
    w = _rows(6, k, seed=k + len(name))
    want = quantize(w, JaxGGMLType[name])
    got = port_quantize(w, GGMLType[name])
    assert got.dtype.itemsize == want.dtype.itemsize and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("name", FORMATS)
def test_qtensor_quantize_equals_jax(name):
    """QTensor.quantize gives the JAX QTensor.quantize planes exactly."""
    w = _rows(32, 512, seed=len(name))
    jq = JaxQTensor.quantize(w, JaxGGMLType[name])
    q = QTensor.quantize(w, GGMLType[name], device="cpu")
    assert q.pack_zero == jq.pack_zero and q.gsize == jq.gsize and q.shape == tuple(jq.shape)
    _same(jq.levels_t, q.levels_t.numpy(), "levels_t")
    _same(jq.gscale_t, q.gscale_t.numpy(), "gscale_t")
    assert (q.gbias_t is None) == (jq.gbias_t is None)
    if q.gbias_t is not None:
        _same(jq.gbias_t, q.gbias_t.numpy(), "gbias_t")
