"""ggml tensor types and block sizes (ggml.h ``enum ggml_type``, llama.h
``enum llama_ftype``).

Every type keeps its block byte size so a model file can be walked whatever it
holds.  The block layouts (numpy structured dtypes, byte-compatible with the C
structs) are those of the formats the port reads and writes: q4_0, q4_1,
q5_0, q5_1, q8_0, the k-quants q2_K..q6_K and the activation formats q8_1
and q8_K.  The k-quants come in both of the reference's compile-time
super-block sizes (k_quants.h:10-16): QK_K = 256, the default build, and
QK_K = 64 (``-DGGML_QKK_64``), whose q3_K, q4_K and q5_K change layout and not
only size.  ``type_traits(t, qk_k)`` and ``row_size_bytes(..., qk_k)`` pick
the variant; a file does not say which one wrote it (formats/ggjt.py finds
out).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

QK4_0 = 32
QK_K = 256
K_SCALE_SIZE = 12


class GGMLType(enum.IntEnum):
    """Tensor data types; values match ggml.h for file compatibility."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    I8 = 16
    I16 = 17
    I32 = 18


# block_q4_0: fp16 d, then 16 bytes holding elements (j, j + 16) in the low
# and high nibble of byte j
BLOCK_Q4_0 = np.dtype([("d", "<f2"), ("qs", "u1", (QK4_0 // 2,))])
BLOCK_Q4_1 = np.dtype([("d", "<f2"), ("m", "<f2"), ("qs", "u1", (16,))])
BLOCK_Q5_0 = np.dtype([("d", "<f2"), ("qh", "u1", (4,)), ("qs", "u1", (16,))])
BLOCK_Q5_1 = np.dtype([("d", "<f2"), ("m", "<f2"), ("qh", "u1", (4,)),
                       ("qs", "u1", (16,))])
BLOCK_Q8_0 = np.dtype([("d", "<f2"), ("qs", "i1", (32,))])
BLOCK_Q8_1 = np.dtype([("d", "<f4"), ("s", "<f4"), ("qs", "i1", (32,))])
BLOCK_Q2_K = np.dtype([("scales", "u1", (QK_K // 16,)), ("qs", "u1", (QK_K // 4,)),
                       ("d", "<f2"), ("dmin", "<f2")])
BLOCK_Q3_K = np.dtype([("hmask", "u1", (QK_K // 8,)), ("qs", "u1", (QK_K // 4,)),
                       ("scales", "u1", (12,)), ("d", "<f2")])
BLOCK_Q4_K = np.dtype([("d", "<f2"), ("dmin", "<f2"),
                       ("scales", "u1", (K_SCALE_SIZE,)), ("qs", "u1", (QK_K // 2,))])
BLOCK_Q5_K = np.dtype([("d", "<f2"), ("dmin", "<f2"),
                       ("scales", "u1", (K_SCALE_SIZE,)), ("qh", "u1", (QK_K // 8,)),
                       ("qs", "u1", (QK_K // 2,))])
BLOCK_Q6_K = np.dtype([("ql", "u1", (QK_K // 2,)), ("qh", "u1", (QK_K // 4,)),
                       ("scales", "i1", (QK_K // 16,)), ("d", "<f2")])
BLOCK_Q8_K = np.dtype([("d", "<f4"), ("qs", "i1", (QK_K,)),
                       ("bsums", "<i2", (QK_K // 16,))])

# the GGML_QKK_64 super-blocks: 2-byte 4-bit scales (q3), two fp16 scales and
# 4-bit codes (q4), symmetric int8 scales with no mins (q5)
BLOCK_Q2_K64 = np.dtype([("scales", "u1", (4,)), ("qs", "u1", (16,)), ("d", "<f2"),
                         ("dmin", "<f2")])
BLOCK_Q3_K64 = np.dtype([("hmask", "u1", (8,)), ("qs", "u1", (16,)),
                         ("scales", "u1", (2,)), ("d", "<f2")])
BLOCK_Q4_K64 = np.dtype([("d", "<f2", (2,)), ("scales", "u1", (2,)), ("qs", "u1", (32,))])
BLOCK_Q5_K64 = np.dtype([("d", "<f2"), ("scales", "i1", (4,)), ("qh", "u1", (8,)),
                         ("qs", "u1", (32,))])
BLOCK_Q6_K64 = np.dtype([("ql", "u1", (32,)), ("qh", "u1", (16,)), ("scales", "i1", (4,)),
                         ("d", "<f2")])
BLOCK_Q8_K64 = np.dtype([("d", "<f4"), ("qs", "i1", (64,)), ("bsums", "<i2", (4,))])


@dataclass(frozen=True)
class TypeTraits:
    name: str
    block_size: int  # elements per block
    type_size: int  # bytes per block
    block_dtype: np.dtype | None = None  # the block layout of a quantized type

    @property
    def is_quantized(self) -> bool:
        return self.block_dtype is not None


TYPE_TRAITS: dict[GGMLType, TypeTraits] = {
    GGMLType.F32: TypeTraits("f32", 1, 4),
    GGMLType.F16: TypeTraits("f16", 1, 2),
    GGMLType.Q4_0: TypeTraits("q4_0", 32, 18, BLOCK_Q4_0),
    GGMLType.Q4_1: TypeTraits("q4_1", 32, 20, BLOCK_Q4_1),
    GGMLType.Q5_0: TypeTraits("q5_0", 32, 22, BLOCK_Q5_0),
    GGMLType.Q5_1: TypeTraits("q5_1", 32, 24, BLOCK_Q5_1),
    GGMLType.Q8_0: TypeTraits("q8_0", 32, 34, BLOCK_Q8_0),
    GGMLType.Q8_1: TypeTraits("q8_1", 32, 40, BLOCK_Q8_1),
    GGMLType.Q2_K: TypeTraits("q2_K", 256, 84, BLOCK_Q2_K),
    GGMLType.Q3_K: TypeTraits("q3_K", 256, 110, BLOCK_Q3_K),
    GGMLType.Q4_K: TypeTraits("q4_K", 256, 144, BLOCK_Q4_K),
    GGMLType.Q5_K: TypeTraits("q5_K", 256, 176, BLOCK_Q5_K),
    GGMLType.Q6_K: TypeTraits("q6_K", 256, 210, BLOCK_Q6_K),
    GGMLType.Q8_K: TypeTraits("q8_K", 256, 292, BLOCK_Q8_K),
    GGMLType.I8: TypeTraits("i8", 1, 1),
    GGMLType.I16: TypeTraits("i16", 1, 2),
    GGMLType.I32: TypeTraits("i32", 1, 4),
}

# the QK_K = 64 build: the k-quant rows take 64-element super-blocks, every
# other type is the default build's
TYPE_TRAITS_64: dict[GGMLType, TypeTraits] = {
    **TYPE_TRAITS,
    GGMLType.Q2_K: TypeTraits("q2_K", 64, 24, BLOCK_Q2_K64),
    GGMLType.Q3_K: TypeTraits("q3_K", 64, 28, BLOCK_Q3_K64),
    GGMLType.Q4_K: TypeTraits("q4_K", 64, 38, BLOCK_Q4_K64),
    GGMLType.Q5_K: TypeTraits("q5_K", 64, 46, BLOCK_Q5_K64),
    GGMLType.Q6_K: TypeTraits("q6_K", 64, 54, BLOCK_Q6_K64),
    GGMLType.Q8_K: TypeTraits("q8_K", 64, 76, BLOCK_Q8_K64),
}

for _t in (*TYPE_TRAITS.values(), *TYPE_TRAITS_64.values()):
    assert _t.block_dtype is None or _t.block_dtype.itemsize == _t.type_size, _t

K_QUANTS = (GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_K, GGMLType.Q5_K,
            GGMLType.Q6_K, GGMLType.Q8_K)


def type_traits(t: GGMLType, qk_k: int = 256) -> TypeTraits:
    """A type's block size and layout in the QK_K = qk_k build (256 or 64)."""
    if qk_k not in (256, 64):
        raise ValueError(f"QK_K is 256 or 64, not {qk_k}")
    return (TYPE_TRAITS if qk_k == 256 else TYPE_TRAITS_64)[t]


def is_quantized(t: GGMLType) -> bool:
    return TYPE_TRAITS[t].is_quantized


def row_size_bytes(t: GGMLType, n_elements: int, qk_k: int = 256) -> int:
    tr = type_traits(t, qk_k)
    if n_elements % tr.block_size != 0:
        raise ValueError(f"{tr.name}: {n_elements} elements not divisible by "
                         f"block size {tr.block_size} (QK_K={qk_k})")
    return n_elements // tr.block_size * tr.type_size


class LlamaFType(enum.IntEnum):
    """Model file types (llama.h ``enum llama_ftype``)."""

    ALL_F32 = 0
    MOSTLY_F16 = 1
    MOSTLY_Q4_0 = 2
    MOSTLY_Q4_1 = 3
    MOSTLY_Q4_1_SOME_F16 = 4
    MOSTLY_Q8_0 = 7
    MOSTLY_Q5_0 = 8
    MOSTLY_Q5_1 = 9
    MOSTLY_Q2_K = 10
    MOSTLY_Q3_K_S = 11
    MOSTLY_Q3_K_M = 12
    MOSTLY_Q3_K_L = 13
    MOSTLY_Q4_K_S = 14
    MOSTLY_Q4_K_M = 15
    MOSTLY_Q5_K_S = 16
    MOSTLY_Q5_K_M = 17
    MOSTLY_Q6_K = 18


# the type each file type quantizes its 2-D weights to, before the k-quant
# layer policy of formats/quantize.py
FTYPE_BASE_TYPE: dict[LlamaFType, GGMLType] = {
    LlamaFType.ALL_F32: GGMLType.F32,
    LlamaFType.MOSTLY_F16: GGMLType.F16,
    LlamaFType.MOSTLY_Q4_0: GGMLType.Q4_0,
    LlamaFType.MOSTLY_Q4_1: GGMLType.Q4_1,
    LlamaFType.MOSTLY_Q4_1_SOME_F16: GGMLType.Q4_1,
    LlamaFType.MOSTLY_Q8_0: GGMLType.Q8_0,
    LlamaFType.MOSTLY_Q5_0: GGMLType.Q5_0,
    LlamaFType.MOSTLY_Q5_1: GGMLType.Q5_1,
    LlamaFType.MOSTLY_Q2_K: GGMLType.Q2_K,
    LlamaFType.MOSTLY_Q3_K_S: GGMLType.Q3_K,
    LlamaFType.MOSTLY_Q3_K_M: GGMLType.Q3_K,
    LlamaFType.MOSTLY_Q3_K_L: GGMLType.Q3_K,
    LlamaFType.MOSTLY_Q4_K_S: GGMLType.Q4_K,
    LlamaFType.MOSTLY_Q4_K_M: GGMLType.Q4_K,
    LlamaFType.MOSTLY_Q5_K_S: GGMLType.Q5_K,
    LlamaFType.MOSTLY_Q5_K_M: GGMLType.Q5_K,
    LlamaFType.MOSTLY_Q6_K: GGMLType.Q6_K,
}
