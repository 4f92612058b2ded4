"""The kernels as ``torch.library`` custom ops, in the ``llama_cpp_q4``
namespace, so that a traced graph (``torch.export``: runtime/export.py,
utils/profiling.py) holds each kernel as one node by name:

  llama_cpp_q4::qmm_packed        K1   csrc/qmm_q4_0.cu  qmm_q4_0
  llama_cpp_q4::qmm_packed_kfold  K2   csrc/qmm_q4_0.cu  qmm_q4_0_kfold
  llama_cpp_q4::qmm_packed_bias   K5   csrc/qmm_q4_0.cu  qmm_packed_bias
  llama_cpp_q4::qmm_int8          K6   csrc/qmm_int8.cu  qmm_int8
  llama_cpp_q4::qmm_int8_bias     K6b  csrc/qmm_int8.cu  qmm_int8 with a bias
  llama_cpp_q4::qmm_packed_q8x    K7   csrc/qmm_q8x.cu   qmm_q8x
  llama_cpp_q4::quantize_q8x      K7's activation quantizer (q8x_quantize)
  llama_cpp_q4::flash_prefill     K3   csrc/flash_prefill.cu
  llama_cpp_q4::mha_decode        K4   csrc/mha_decode.cu

Each op's CUDA implementation is the kernel's wrapper (its launch, counted
in the wrapper's ``launches``), its CPU implementation the plain version,
and its fake implementation gives the output's shape and dtype.  The
wrappers themselves call the launch directly; only while a graph is traced
(``torch.compiler.is_compiling()``, which ``torch.export`` sets) do they
return the op instead, so eager and replayed steps launch as before.  K8
(``ops/stream.py``, the read stream of the ``benchmark-matmult`` tool) is on
no model path and has no op.
"""

from __future__ import annotations

import torch

from . import flash_prefill as fp
from . import mha_decode as md
from . import qmm

NAMESPACE = "llama_cpp_q4"


def _define(name: str, schema: str, plain, kernel, fake):
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", plain, mutates_args=(),
                                 device_types="cpu", schema=schema)
    op.register_kernel("cuda")(kernel)
    op.register_fake(fake)
    return op


def _mm_out(x, w, *rest):
    return x.new_empty((x.shape[0], w.shape[1]), dtype=torch.float32)


_PACKED = "(Tensor x, Tensor packed, Tensor scales, int zero, int gsize) -> Tensor"
qmm_packed = _define(
    "qmm_packed", _PACKED,
    lambda x, p, s, zero, gsize: qmm.qmm_packed_plain(x, p, s, zero=zero, gsize=gsize),
    lambda x, p, s, zero, gsize: qmm.qmm_packed(x, p, s, zero=zero, gsize=gsize), _mm_out)
qmm_packed_kfold = _define(
    "qmm_packed_kfold", _PACKED,
    lambda x, p, s, zero, gsize: qmm.qmm_packed_kfold_plain(x, p, s, zero=zero, gsize=gsize),
    lambda x, p, s, zero, gsize: qmm.qmm_packed_kfold(x, p, s, zero=zero, gsize=gsize),
    _mm_out)
qmm_packed_q8x = _define(
    "qmm_packed_q8x", _PACKED,
    lambda x, p, s, zero, gsize: qmm.qmm_packed_q8x_plain(x, p, s, zero=zero, gsize=gsize),
    lambda x, p, s, zero, gsize: qmm.qmm_packed_q8x(x, p, s, zero=zero, gsize=gsize),
    _mm_out)
qmm_packed_bias = _define(
    "qmm_packed_bias",
    "(Tensor x, Tensor packed, Tensor scales, Tensor gbias, int zero, int gsize) -> Tensor",
    lambda x, p, s, b, zero, gsize: qmm.qmm_packed_bias_plain(x, p, s, b, zero=zero,
                                                              gsize=gsize),
    lambda x, p, s, b, zero, gsize: qmm.qmm_packed_bias(x, p, s, b, zero=zero, gsize=gsize),
    _mm_out)
qmm_int8 = _define(
    "qmm_int8", "(Tensor x, Tensor levels, Tensor scales, int gsize) -> Tensor",
    lambda x, lv, s, gsize: qmm.qmm_int8_plain(x, lv, s, gsize=gsize),
    lambda x, lv, s, gsize: qmm.qmm_int8(x, lv, s, gsize=gsize), _mm_out)
qmm_int8_bias = _define(
    "qmm_int8_bias",
    "(Tensor x, Tensor levels, Tensor scales, Tensor gbias, int gsize) -> Tensor",
    lambda x, lv, s, b, gsize: qmm.qmm_int8_bias_plain(x, lv, s, b, gsize=gsize),
    lambda x, lv, s, b, gsize: qmm.qmm_int8_bias(x, lv, s, b, gsize=gsize), _mm_out)
quantize_q8x = _define(
    "quantize_q8x", "(Tensor x, int gsize) -> (Tensor, Tensor)",
    lambda x, gsize: tuple(qmm.quantize_q8x_plain(x, gsize)),
    lambda x, gsize: tuple(qmm.quantize_q8x(x, gsize)),
    lambda x, gsize: (x.new_empty(x.shape, dtype=torch.int8),
                      x.new_empty((x.shape[0], x.shape[1] // gsize), dtype=torch.float32)))
flash_prefill = _define(
    "flash_prefill", "(Tensor q, Tensor k, Tensor v, float scale) -> Tensor",
    fp.flash_prefill_plain, fp.flash_prefill,
    lambda q, k, v, scale: q.new_empty(q.shape, dtype=torch.float32))
mha_decode = _define(
    "mha_decode",
    "(Tensor q, Tensor kd, Tensor? ks, Tensor vd, Tensor? vs, Tensor q_positions, "
    "Tensor kv_mask, float scale) -> Tensor",
    md.mha_decode_plain, md.mha_decode,
    lambda q, kd, ks, vd, vs, qp, mask, scale: q.new_empty(q.shape, dtype=torch.float32))

# every op, by name: a wrapper returns OPS[name](...) while a graph is traced
OPS = {"qmm_packed": qmm_packed, "qmm_packed_kfold": qmm_packed_kfold,
       "qmm_packed_bias": qmm_packed_bias, "qmm_int8": qmm_int8,
       "qmm_int8_bias": qmm_int8_bias, "qmm_packed_q8x": qmm_packed_q8x,
       "quantize_q8x": quantize_q8x, "flash_prefill": flash_prefill,
       "mha_decode": mha_decode}
