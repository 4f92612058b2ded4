"""Decode / verify attention over the KV cache (csrc/mha_decode.cu) and its
plain version.

Replaces the JAX package's ``ops/pallas/attention.py::mha_decode``, which
``ops/layers.py::attention`` calls under ``FUSED_ATTN`` for small T.  It
computes the f32 chain on the stored cache values (q not rounded): scores
``(q . k) * scale`` times K's scale, ``NEG`` where a slot is masked or after
the row's position, the softmax numerator zeroed there, V's scale on the
probabilities, and ``acc / max(l, 1e-30)``, so a row with no valid slot
gives 0.  The default ``attention`` rounds q and the probabilities to bf16 on
a bf16 or int8 cache; this function never does.

The kernel is one launch a call: the window's slots are split over the
blocks of a thread-block cluster (``mha_plan``), each keeping its slice's
softmax state, merged in rank order inside the kernel.
``mha_decode_split_plain`` is that order in plain PyTorch.

For a CPU tensor the wrapper runs the plain version; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

NEG = -1e30
HEAD_DIMS = (64, 128, 256)  # the head widths the kernel is compiled for
MAX_T = 16
KV_TYPES = {torch.int8: 0, torch.bfloat16: 1, torch.float16: 2, torch.float32: 3,
            torch.float8_e4m3fn: 4}
MAX_SPLITS = 8  # the portable cluster size
MIN_SLICE = 64  # slots a split keeps at least (a sweep of 16, 32, 64 on the H100)
ROW_BLOCKS = (1, 4, 8, 16)  # query rows a block, compiled instances
launches = {"mha_decode": 0}


@dataclasses.dataclass(frozen=True)
class MhaPlan:
    """One call: the window's ``slots`` split over ``splits`` blocks of a
    cluster, ``rows`` query rows a block."""
    splits: int
    rows: int
    slots: int

    def ranges(self) -> list[tuple[int, int]]:
        """The slots [s0, s1) of each rank, as the kernel computes them."""
        return [(q * self.slots // self.splits, (q + 1) * self.slots // self.splits)
                for q in range(self.splits)]


def mha_plan(s: int, rows: int) -> MhaPlan:
    """The split of a window of s slots for T x rep = rows query rows of a KV
    head: as many ranks as keep MIN_SLICE slots each, at most MAX_SPLITS; the
    smallest compiled row block that holds the rows (16 beyond, several
    blocks)."""
    splits = max(1, min(MAX_SPLITS, s // MIN_SLICE))
    rb = next((r for r in ROW_BLOCKS if r >= rows), ROW_BLOCKS[-1])
    return MhaPlan(splits, rb, s)


def mha_decode_plain(q: torch.Tensor, kd: torch.Tensor, ks: torch.Tensor | None,
                     vd: torch.Tensor, vs: torch.Tensor | None,
                     q_positions: torch.Tensor, kv_mask: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """q [B,T,H,D]; kd/vd [B,S,G,D] int8, bf16, f16, f32 or e4m3 (ks/vs
    [B,S,G] f32 for an int8 cache, else None); q_positions [B,T]; kv_mask
    [B,S] bool -> f32 [B,T,H,D]."""
    b, t, h, d = q.shape
    s, g = kd.shape[1], kd.shape[2]
    qg = q.float().reshape(b, t, g, h // g, d)
    scores = torch.einsum("btgrd,bsgd->bgrts", qg, kd.float()) * scale
    if ks is not None:
        scores = scores * ks.permute(0, 2, 1)[:, :, None, None, :]
    slot = torch.arange(s, device=q.device)
    valid = (kv_mask[:, None, None, None, :]
             & (slot <= q_positions[:, None, None, :, None]))
    scores = torch.where(valid, scores, torch.full((), NEG, device=q.device))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(scores - m), torch.zeros((), device=q.device))
    l = p.sum(dim=-1)
    if vs is not None:
        p = p * vs.permute(0, 2, 1)[:, :, None, None, :]
    acc = torch.einsum("bgrts,bsgd->btgrd", p, vd.float())
    out = acc / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, t, h, d)


def mha_decode_split_plain(q: torch.Tensor, kd: torch.Tensor, ks: torch.Tensor | None,
                           vd: torch.Tensor, vs: torch.Tensor | None,
                           q_positions: torch.Tensor, kv_mask: torch.Tensor, scale: float,
                           splits: int | None = None) -> torch.Tensor:
    """The kernel's order in plain PyTorch: the slots split as ``mha_plan``
    splits them (or in ``splits``), each slice's (m, l, acc) computed alone,
    the slices merged in rank order: M = max m, L = sum l exp(m - M),
    out = (sum acc exp(m - M)) / max(L, 1e-30)."""
    b, t, h, d = q.shape
    s, g = kd.shape[1], kd.shape[2]
    plan = mha_plan(s, t * (h // g))
    if splits is not None:
        plan = dataclasses.replace(plan, splits=splits)
    qg = q.float().reshape(b, t, g, h // g, d)
    state = []
    for lo, hi in plan.ranges():
        sc = torch.einsum("btgrd,bsgd->bgrts", qg, kd[:, lo:hi].float()) * scale
        if ks is not None:
            sc = sc * ks[:, lo:hi].permute(0, 2, 1)[:, :, None, None, :]
        slot = torch.arange(lo, hi, device=q.device)
        valid = (kv_mask[:, None, None, None, lo:hi]
                 & (slot <= q_positions[:, None, None, :, None]))
        sc = torch.where(valid, sc, torch.full((), NEG, device=q.device))
        m = (sc.amax(dim=-1) if hi > lo
             else torch.full(sc.shape[:-1], NEG, device=q.device))
        p = torch.where(valid, torch.exp(sc - m[..., None]), torch.zeros((), device=q.device))
        l = p.sum(dim=-1)
        if vs is not None:
            p = p * vs[:, lo:hi].permute(0, 2, 1)[:, :, None, None, :]
        state.append((m, l, torch.einsum("bgrts,bsgd->bgrtd", p, vd[:, lo:hi].float())))
    big = torch.stack([m for m, _, _ in state]).amax(dim=0)
    l_all = torch.zeros_like(big)
    o_all = torch.zeros_like(state[0][2])
    for m, l, acc in state:
        w = torch.exp(m - big)
        l_all = l_all + l * w
        o_all = o_all + acc * w[..., None]
    out = o_all / torch.clamp(l_all, min=1e-30)[..., None]  # [b, g, r, t, d]
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, d)


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "mha_decode": ([_P, _P, _P, _P, _P, _P, _L, _P, _L, _P, _I, _I, _I, _I, _I, _I,
                    _L, _L, _I, ctypes.c_float, _I, _I, _P], _I),
}


def _check_cuda(q, kd, ks, vd, vs, q_positions, kv_mask):
    """What the kernel takes: a contiguous f32 q; K/V of one stored type,
    contiguous inside a batch row and sharing their batch stride; f32 scales
    laid out the same way; int64 positions and a bool mask with unit stride
    along T and S; 16-byte aligned K/V."""
    b, t, h, d = q.shape
    s, g = kd.shape[1], kd.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes head_dim in {HEAD_DIMS}, not {d}")
    if t > MAX_T:
        raise ValueError(f"the CUDA kernel takes at most {MAX_T} query tokens, not {t}")
    if q.dtype != torch.float32 or not q.is_contiguous():
        raise ValueError("the CUDA kernel takes a contiguous f32 q")
    if kd.dtype not in KV_TYPES or vd.dtype != kd.dtype:
        raise TypeError(f"K/V dtypes {kd.dtype}, {vd.dtype}")
    for a in (kd, vd):
        if a.stride()[1:] != (g * d, d, 1) or a.stride(0) != kd.stride(0):
            raise ValueError("K/V must be contiguous inside a batch row, with one "
                             "batch stride")
        if a.data_ptr() % 16 or (a.stride(0) * a.element_size()) % 16:
            raise ValueError("the CUDA kernel takes 16-byte aligned K/V rows")
    if (ks is None) != (kd.dtype != torch.int8) or (vs is None) != (ks is None):
        raise ValueError("an int8 cache needs its K and V scales, a float one none")
    if ks is not None:
        for a in (ks, vs):
            if (a.dtype != torch.float32 or a.shape != kd.shape[:3]
                    or a.stride()[1:] != (g, 1) or a.stride(0) != ks.stride(0)):
                raise ValueError("scales must be f32 [B, S, G], contiguous inside a "
                                 "batch row, with one batch stride")
    if q_positions.dtype != torch.int64 or (t > 1 and q_positions.stride(1) != 1):
        raise ValueError("q_positions must be int64 with a unit stride along T")
    if kv_mask.dtype != torch.bool or kv_mask.stride(1) != 1:
        raise ValueError("kv_mask must be bool with a unit stride along S")


def mha_decode(q: torch.Tensor, kd: torch.Tensor, ks: torch.Tensor | None,
               vd: torch.Tensor, vs: torch.Tensor | None, q_positions: torch.Tensor,
               kv_mask: torch.Tensor, scale: float) -> torch.Tensor:
    """Attention of T <= 16 query tokens over the cache window -> f32
    [B, T, H, D].  The window may be a strided ``cache[:, :w]`` view: the
    kernel takes its batch stride and copies nothing, and no scratch."""
    b, t, h, d = q.shape
    s, g = kd.shape[1], kd.shape[2]
    if kd.shape != vd.shape or kd.shape[0] != b or kd.shape[3] != d or h % g:
        raise ValueError(f"K/V {tuple(kd.shape)} do not match q {tuple(q.shape)}")
    if tuple(q_positions.shape) != (b, t) or tuple(kv_mask.shape) != (b, s):
        raise ValueError("q_positions must be [B, T] and kv_mask [B, S]")
    tensors = [q, kd, vd, q_positions, kv_mask] + [a for a in (ks, vs) if a is not None]
    if any(a.device != q.device for a in tensors):
        raise ValueError("the inputs lie on different devices")
    if q.device.type == "cpu":
        return mha_decode_plain(q, kd, ks, vd, vs, q_positions, kv_mask, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda(q, kd, ks, vd, vs, q_positions, kv_mask)
    from ..kernels import build

    lib = build.load("mha_decode", _SIGNATURES)
    plan = mha_plan(s, t * (h // g))
    out = torch.empty_like(q)
    err = lib.mha_decode(
        q.data_ptr(), kd.data_ptr(), None if ks is None else ks.data_ptr(),
        vd.data_ptr(), None if vs is None else vs.data_ptr(),
        q_positions.data_ptr(), q_positions.stride(0), kv_mask.data_ptr(),
        kv_mask.stride(0), out.data_ptr(), b, t, h, g, s, d, kd.stride(0),
        0 if ks is None else ks.stride(0), KV_TYPES[kd.dtype], float(scale), plan.splits,
        plan.rows, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"mha_decode launch failed: CUDA error {err}")
    launches["mha_decode"] += 1
    return out
