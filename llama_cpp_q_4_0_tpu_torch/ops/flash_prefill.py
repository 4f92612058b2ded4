"""Causal prefill attention kernel (csrc/flash_prefill.cu) and its plain version.

Replaces the TPU flash-attention kernel that the JAX package's
``ops/layers.py::_flash_prefill`` calls for whole-prompt prefills.  It is an
``attention_fn`` in the sense of ``models/transformer.forward``: it attends
over the call's fresh (cache-round-tripped) K/V with ``n_past == 0``, which
equals the cache-window attention of that call.

For a CPU tensor the wrapper runs the plain version; for a CUDA tensor it
launches the kernel or raises; in a traced graph it is the custom op
``llama_cpp_q4::flash_prefill`` (ops/library.py).  The kernel computes both products in 3xTF32
on the tensor cores; ``flash_prefill_3xtf32_plain`` repeats that arithmetic
in plain PyTorch (the tests hold it to f32 attention).
"""

from __future__ import annotations

import ctypes

import torch

HEAD_DIMS = (128, 256)  # the head widths the kernel is compiled for
launches = {"flash_prefill": 0}


def flash_prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> torch.Tensor:
    """softmax(q k^T * scale, causal) v in f32; q [B,T,H,D], k/v [B,T,G,D]."""
    b, t, h, d = q.shape
    g = k.shape[2]
    qg = q.float().reshape(b, t, g, h // g, d)
    scores = torch.einsum("btgrd,bsgd->bgrts", qg, k.float()) * scale
    causal = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrts,bsgd->btgrd", probs, v.float())
    return out.reshape(b, t, h, d)


def tf32_round(a: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from zero,
    as PTX cvt.rna.tf32.f32 rounds: add half a TF32 ulp to the magnitude's
    bits and clear the 13 low ones."""
    bits = a.float().contiguous().view(torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return ((bits & ~0x7FFFFFFF) | mag).view(torch.float32)


def split_tf32(a: torch.Tensor):
    """a ~ hi + lo, both TF32: hi = tf32(a), lo = tf32(a - hi)."""
    hi = tf32_round(a)
    return hi, tf32_round(a.float() - hi)


def _mm_3xtf32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum eq of a and b as three TF32 products in f32 (each product of two
    TF32 values is exact in f32): lo.hi' + hi.lo' + hi.hi'."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)) + torch.einsum(eq, ah, bh)


def flash_prefill_3xtf32_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               scale: float) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: flash_prefill_plain with both
    products in 3xTF32 (the probabilities split after the softmax)."""
    b, t, h, d = q.shape
    g = k.shape[2]
    qg = q.float().reshape(b, t, g, h // g, d)
    scores = _mm_3xtf32("btgrd,bsgd->bgrts", qg, k.float()) * scale
    causal = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = _mm_3xtf32("bgrts,bsgd->btgrd", probs, v.float())
    return out.reshape(b, t, h, d)


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "flash_prefill": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P],
                      _I),
    "flash_prefill_smem": ([_I], _I),
}


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """Causal attention over the prompt's own K/V -> f32 [B, T, H, D]."""
    if torch.compiler.is_compiling():  # a traced graph holds the op (ops/library.py)
        from . import library

        return library.OPS["flash_prefill"](q, k, v, float(scale))
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    b, t, h, d = q.shape
    g = k.shape[2]
    if k.shape[:2] != (b, t) or k.shape[3] != d or h % g:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q {tuple(q.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v lie on different devices")
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if any(a.dtype != torch.float32 for a in (q, k, v)):
        raise TypeError("the CUDA kernel takes float32 q, k, v")
    if not all(a.is_contiguous() for a in (q, k, v)):
        raise ValueError("the CUDA kernel takes contiguous q, k, v")
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim in {HEAD_DIMS}, not {d}")
    if any(a.data_ptr() % 16 for a in (q, k, v)):
        raise ValueError("the CUDA kernel takes 16-byte aligned q, k, v")
    from ..kernels import build

    lib = build.load("flash_prefill", _SIGNATURES)
    out = torch.empty_like(q)
    err = lib.flash_prefill(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), b, t, h, g, d, float(scale),
                            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_prefill launch failed: CUDA error {err}")
    launches["flash_prefill"] += 1
    return out
