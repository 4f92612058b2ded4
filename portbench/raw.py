"""A configuration's weights as a GGJT file would hold them, made on the
device from the seed: every 2-D weight as q4_0 blocks (an fp16 scale and 32
4-bit levels, 18 bytes), every 1-D parameter in f32.  The bytes end on the
host, where the program's loader and the plain reference both read them, as
both would read one file.

Each layer draws from a generator of its own (the seed and the layer's
index), in two or three large calls: the levels of all its matrices, their
scales, and its vectors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

Q4_0_BLOCK_BYTES = 18  # fp16 d, then 16 bytes of nibbles: element j low, j + 16 high
QK = 32
# the q4_0 group scales: uniform in this range (the levels -8..7 then give
# weights of about 0.046 spread, as the program's own synthetic models use)
SCALE_RANGE = (0.005, 0.015)


@dataclass
class RawTensor:
    qtype: str  # "q4_0" | "f32"
    shape: tuple  # row-major: (N, K) of a matrix, (n,) of a vector
    data: np.ndarray  # q4_0: the blocks' bytes, uint8; f32: the values


def generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of one part (a layer, or the embedding and head) of a
    seed's weights: any whole seed, mixed with the part's index."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + 7919 * (index + 1)) % (1 << 63))
    return g


def q4_0_matrices(gen, mats, device, scales=None) -> dict:
    """{name: RawTensor} of the matrices mats = [(name, n, k)]: the levels of
    all of them in one draw, their scales in another.  scales: {name: (lo,
    hi)} for matrices whose group scales take another range than
    SCALE_RANGE."""
    counts = [n * k // QK for _, n, k in mats]
    total = sum(counts)
    qs = torch.randint(0, 256, (total, QK // 2), generator=gen, device=device,
                       dtype=torch.uint8)
    lo = torch.empty((total, 1), device=device)
    hi = torch.empty((total, 1), device=device)
    off = 0
    for (name, _, _), c in zip(mats, counts):
        a, b = (scales or {}).get(name, SCALE_RANGE)
        lo[off:off + c], hi[off:off + c] = a, b
        off += c
    d = (lo + (hi - lo) * torch.rand((total, 1), generator=gen, device=device)).half()
    blocks = torch.cat([d.view(torch.uint8), qs], dim=1).cpu().numpy()
    out, off = {}, 0
    for (name, n, k), c in zip(mats, counts):
        out[name] = RawTensor("q4_0", (n, k), blocks[off:off + c].reshape(-1))
        off += c
    return out


def f32_vectors(gen, specs, device) -> dict:
    """{name: RawTensor} of the vectors specs = [(name, n, kind)], in one
    normal and one uniform draw.  kind: "gain" 1 + N(0, 0.1^2) (a norm's
    weight), "bias" N(0, 0.01^2), "mix" U(0.1, 0.9), "first" N(0, 0.3^2) (an
    RWKV time_first), "decay" -exp(N(0, 0.5^2)) (an RWKV time_decay as its
    file stores it)."""
    total = sum(n for _, n, _ in specs)
    normal = torch.randn((total,), generator=gen, device=device)
    uniform = torch.rand((total,), generator=gen, device=device)
    out, off = {}, 0
    for name, n, kind in specs:
        z, u = normal[off:off + n], uniform[off:off + n]
        off += n
        if kind == "gain":
            v = 1.0 + 0.1 * z
        elif kind == "bias":
            v = 0.01 * z
        elif kind == "mix":
            v = 0.1 + 0.8 * u
        elif kind == "first":
            v = 0.3 * z
        elif kind == "decay":
            v = -torch.exp(0.5 * z)
        else:
            raise ValueError(f"unknown vector kind {kind}")
        out[name] = RawTensor("f32", (n,), v.float().cpu().numpy())
    return out


def dequantize_q4_0(t: RawTensor, device) -> torch.Tensor:
    """A q4_0 matrix as f32 [N, K] on device, from its blocks alone."""
    n, k = t.shape
    b = torch.from_numpy(t.data).to(device).view(-1, Q4_0_BLOCK_BYTES)
    d = b[:, :2].contiguous().view(torch.float16).float()  # [nb, 1]
    qs = b[:, 2:]
    q = torch.cat([qs & 0x0F, qs >> 4], dim=1).float() - 8.0  # [nb, 32]
    return (q * d).reshape(n, k)


def vector(t: RawTensor, device) -> torch.Tensor:
    return torch.from_numpy(t.data).to(device)


def q4_0_rows(t: RawTensor, rows: torch.Tensor, device) -> torch.Tensor:
    """Rows of a q4_0 matrix (an embedding lookup) as f32 [len(rows), K]."""
    n, k = t.shape
    nb = k // QK
    blocks = torch.from_numpy(t.data.reshape(n, nb * Q4_0_BLOCK_BYTES))
    sub = RawTensor("q4_0", (len(rows), k), blocks[rows.cpu()].numpy().reshape(-1))
    return dequantize_q4_0(sub, device)
