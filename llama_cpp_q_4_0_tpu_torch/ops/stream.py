"""HBM read stream (csrc/stream.cu) and its plain version: the kernel of
``benchmark-matmult --stream``.

Replaces the TPU kernel of the JAX package's ``cli/benchmark.py::
_stream_once``.  Over a uint8 ``[rows, 65536]`` buffer cut into tiles of
``tile_rows`` rows it returns the sum of every byte (a checksum that proves
every byte was read; the TPU's tile DMA moved whole tiles, a GPU thread reads
only what it loads) and the TPU kernel's own output, the f32 ``[8, 128]`` sum
of each tile's corner.

For a CPU tensor the wrapper runs the plain version; for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

LANES = 65536  # bytes per row
launches = {"hbm_stream": 0}


def stream_shape(gib: float, tile_mib: float) -> tuple[int, int]:
    """(rows, tile_rows) of the JAX tool: tiles of tile_mib MiB (at least 8
    rows) and as many whole tiles as fit in gib GiB."""
    tile_rows = max(8, int(tile_mib * (1 << 20)) // LANES)
    rows = int(gib * (1 << 30)) // LANES
    rows -= rows % tile_rows
    if rows == 0:
        raise ValueError(f"{gib} GiB holds no whole tile of {tile_mib} MiB")
    return rows, tile_rows


def hbm_stream_plain(buf: torch.Tensor, tile_rows: int):
    """(checksum int64 scalar, corner f32 [8, 128])."""
    rows = buf.shape[0]
    tiles = buf.reshape(rows // tile_rows, tile_rows, LANES)
    return (buf.sum(dtype=torch.int64),
            tiles[:, :8, :128].to(torch.float32).sum(dim=0))


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "hbm_stream": ([_P, _L, _I, _I, _P, _P, _P, _P, _P], _I),
    "hbm_stream_blocks": ([_L], _I),
}


def hbm_stream(buf: torch.Tensor, tile_rows: int):
    """Read every byte of buf (uint8 [rows, 65536], rows a multiple of
    tile_rows >= 8): (checksum int64 scalar, corner f32 [8, 128])."""
    if (buf.dtype != torch.uint8 or buf.dim() != 2 or buf.shape[1] != LANES
            or tile_rows < 8 or buf.shape[0] % tile_rows or buf.shape[0] == 0):
        raise ValueError(f"buf must be uint8 [k * {tile_rows}, {LANES}] with "
                         f"tile_rows >= 8, not {buf.dtype} {tuple(buf.shape)}")
    if buf.device.type == "cpu":
        return hbm_stream_plain(buf, tile_rows)
    if buf.device.type != "cuda":
        raise ValueError(f"unsupported device {buf.device}")
    if not buf.is_contiguous() or buf.data_ptr() % 16:
        raise ValueError("the CUDA kernel takes a contiguous, 16-byte aligned buffer")
    from ..kernels import build

    lib = build.load("stream", _SIGNATURES)
    n_tiles = buf.shape[0] // tile_rows
    n_blocks = lib.hbm_stream_blocks(n_tiles)
    dev = buf.device
    sums = torch.empty(n_blocks, dtype=torch.int64, device=dev)
    corners = torch.empty((n_blocks, 8, 128), dtype=torch.float32, device=dev)
    checksum = torch.empty((), dtype=torch.int64, device=dev)
    corner = torch.empty((8, 128), dtype=torch.float32, device=dev)
    err = lib.hbm_stream(buf.data_ptr(), n_tiles, tile_rows, n_blocks, sums.data_ptr(),
                         corners.data_ptr(), checksum.data_ptr(), corner.data_ptr(),
                         torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"hbm_stream launch failed: CUDA error {err}")
    launches["hbm_stream"] += 1
    return checksum, corner
