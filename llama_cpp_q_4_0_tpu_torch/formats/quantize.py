"""Model-file (re)quantization, llama_model_quantize (llama.cpp:2309-2542).

Reads any container the reader takes (ggml/ggmf/ggjt, any family),
dequantizes each tensor to float32 on the host, requantizes it by the
reference's layer rules and writes a ggjt file.  The k-quant layer policy is
the reference's: output.weight -> Q6_K, attention.wv / feed_forward.w2
upgraded on the S/M/L mixes through use_more_bits, attention.wo on Q3_K_M,
Q3_K_L and Q2_K (llama.cpp:2368-2440); a 16-bin histogram of the quant
levels (llama.cpp:2506-2540).  Byte for byte the JAX package's
``formats/quantize.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..quant.blockq import _qh_bits
from ..quant.registry import quantize
from ..quant.types import (FTYPE_BASE_TYPE, K_QUANTS, TYPE_TRAITS, GGMLType, LlamaFType,
                           is_quantized)
from .ggjt import GGJTWriter, read_ggjt


@dataclass
class QuantizeParams:
    """llama_model_quantize_params (llama.h:130-135).

    qk_k picks the k-quant super-block build variant (the reference's
    compile-time GGML_QKK_64, k_quants.h:10-16) — 64 admits tensors whose
    row sizes are 64- but not 256-divisible; readers auto-detect."""

    ftype: LlamaFType = LlamaFType.MOSTLY_Q4_0
    allow_requantize: bool = False
    quantize_output_tensor: bool = True
    qk_k: int = 256


def use_more_bits(i_layer: int, num_layers: int) -> bool:
    """The layers whose wv and w2 a _M k-quant mix stores in q6_K."""
    return (i_layer < num_layers // 8 or i_layer >= 7 * num_layers // 8
            or (i_layer - num_layers // 8) % 3 == 2)


def _histogram(blocks: np.ndarray, qtype: GGMLType) -> np.ndarray:
    """16-bin histogram of quant levels, exactly what the reference's
    ggml_quantize_* collect (ggml.c:19157-19283):

      q4_0/q4_1 — both nibbles of every qs byte;
      q5_0/q5_1 — the reconstructed 5-bit value (nibble | qh-bit<<4)
                  halved into 16 bins;
      q8_0      — vi/16 + 8 with C truncating division;
      k-quants  — nothing (k_quants.c:405 '(void)hist' for every format).
    """
    hist = np.zeros(16, dtype=np.int64)
    flat = blocks.reshape(-1)
    if qtype in (GGMLType.Q4_0, GGMLType.Q4_1):
        qs = flat["qs"]
        hist += np.bincount((qs & 0x0F).ravel(), minlength=16)
        hist += np.bincount((qs >> 4).ravel(), minlength=16)
    elif qtype in (GGMLType.Q5_0, GGMLType.Q5_1):
        # the reference's hist loop steps j by 2 over the 32 elements while
        # indexing qs[j/2], so byte i's high bits come from qh bits 2i and
        # 2i+16 — and for i >= 8 both shift counts in
        # ((qh & (1u << (j+16))) >> (j+12)) reach 32+, C UB that x86 wraps
        # mod 32: bytes 8-9 get NO high bit and bytes 10-15 read bit 2i-16.
        # Reproduced bit-for-bit (gated against the compiled oracle); this
        # histogram does NOT reflect the actual q5 element values.
        i = np.arange(16)
        hi_idx = np.where(i <= 7, 2 * i + 16, 2 * i - 16)
        hi_bit_on = (i <= 7) | (i >= 10)
        qs = flat["qs"].astype(np.uint8)
        bits = _qh_bits(flat["qh"]).astype(np.uint8)
        lo = (qs & 0x0F) | (bits[:, 2 * i] << 4)
        hi = (qs >> 4) | ((bits[:, hi_idx] * hi_bit_on) << 4).astype(np.uint8)
        hist += np.bincount((lo // 2).ravel(), minlength=16)
        hist += np.bincount((hi // 2).ravel(), minlength=16)
    elif qtype == GGMLType.Q8_0:
        vi = flat["qs"].astype(np.int64).ravel()
        bins = np.trunc(vi / 16).astype(np.int64) + 8  # C int division
        hist += np.bincount(bins, minlength=16)[:16]
    return hist


def _mix_type(ftype: LlamaFType, upgrade: bool):
    """The type a k-quant mix gives wv and w2 (upgrade: use_more_bits picks
    the layer), or None to keep the mix's base type."""
    if ftype in (LlamaFType.MOSTLY_Q3_K_M, LlamaFType.MOSTLY_Q2_K):
        return GGMLType.Q4_K
    if ftype == LlamaFType.MOSTLY_Q3_K_L:
        return GGMLType.Q5_K
    if ftype in (LlamaFType.MOSTLY_Q4_K_M, LlamaFType.MOSTLY_Q5_K_M) and upgrade:
        return GGMLType.Q6_K
    return None


class TypePolicy:
    """The type each quantized 2-D weight of one file takes under ftype
    (llama.cpp:2368-2440).  Ask for the weights in file order: wv and w2
    count their layers."""

    def __init__(self, ftype, names, qk_k: int = 256):
        self.ftype = LlamaFType(ftype)
        self.base = FTYPE_BASE_TYPE[self.ftype]
        self.qk_k = qk_k
        self.n_wv = sum("attention.wv.weight" in n for n in names)
        self.n_w2 = sum("feed_forward.w2.weight" in n for n in names)
        self.i_wv = self.i_w2 = 0

    def __call__(self, name: str, ne) -> GGMLType:
        qk_k, kq = self.qk_k, self.base in K_QUANTS
        if kq and (ne[0] % qk_k or ne[1] % qk_k):
            raise ValueError(f"tensor {name} sizes {ne[0]}x{ne[1]} not divisible by {qk_k} "
                             "(required for k-quants; try qk_k=64)")
        if name == "output.weight":
            return GGMLType.Q6_K if kq else self.base
        if "attention.wv.weight" in name:
            self.i_wv += 1
            return _mix_type(self.ftype, use_more_bits(self.i_wv - 1, self.n_wv)) or self.base
        if "feed_forward.w2.weight" in name:
            self.i_w2 += 1
            return _mix_type(self.ftype, use_more_bits(self.i_w2 - 1, self.n_w2)) or self.base
        if "attention.wo.weight" in name:
            return _mix_type(self.ftype, False) or self.base
        return self.base


def quantize_model(fname_inp: str, fname_out: str, params: QuantizeParams,
                   arch: str = "llama", progress=print) -> dict:
    """Requantize fname_inp into fname_out; progress gets one line a tensor
    and the size line.  Returns the sizes in MiB and the level histogram."""
    gf = read_ggjt(fname_inp, arch)
    ftype = LlamaFType(params.ftype)
    quantized_type = FTYPE_BASE_TYPE[ftype]
    qk_k = params.qk_k
    names = list(gf.tensors)
    policy = TypePolicy(ftype, names, qk_k)
    total_org = 0
    total_new = 0
    hist_all = np.zeros(16, dtype=np.int64)

    with GGJTWriter(fname_out, gf.arch, gf.hparams, int(ftype), gf.vocab, qk_k=qk_k) as w:
        for idx, name in enumerate(names):
            t = gf.tensors[name]
            tag = f"[{idx+1:4d}/{len(names):4d}] {name:40s}"
            do_quant = (name.endswith("weight") and len(t.ne) == 2
                        and (params.quantize_output_tensor or name != "output.weight")
                        and quantized_type != t.qtype and quantized_type != GGMLType.F32)
            total_org += t.size
            if not do_quant:
                w.write_tensor(name, t.qtype, t.ne, gf.tensor_bytes(name).tobytes())
                total_new += t.size
                progress(f"{tag} kept {TYPE_TRAITS[t.qtype].name}")
                continue
            new_type = policy(name, t.ne)
            if is_quantized(t.qtype) and not params.allow_requantize:
                raise ValueError(f"requantizing from {TYPE_TRAITS[t.qtype].name} is disabled "
                                 "(pass allow_requantize)")
            f32 = gf.tensor_f32(name)
            if new_type == GGMLType.F16:
                data = f32.astype(np.float16).tobytes()
            else:
                blocks = quantize(f32, new_type, qk_k)
                data = blocks.tobytes()
                hist_all += _histogram(blocks, new_type)
            w.write_tensor(name, new_type, t.ne, data)
            total_new += len(data)
            progress(f"{tag} {TYPE_TRAITS[t.qtype].name} -> {TYPE_TRAITS[new_type].name} "
                     f"({t.size/1e6:.2f} -> {len(data)/1e6:.2f} MB)")

    stats = {"size_org_mb": total_org / 1024 / 1024, "size_new_mb": total_new / 1024 / 1024,
             "hist": hist_all.tolist()}
    progress(f"model size: {stats['size_org_mb']:.2f} MB -> {stats['size_new_mb']:.2f} MB")
    return stats
