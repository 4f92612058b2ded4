"""`benchmark-matmult` — quantized against dense matmul throughput
(examples/benchmark/benchmark-matmult.cpp:60-203) at the reference's shapes
(11008 x 4096 x 128): GFLOPS and the weight stream's GB/s.  ``--vdot``
compares the quantized dot with the float dot (pocs/vdot); ``--stream`` and
``--stream-sweep`` measure the card's practical HBM read rate with the
hbm_stream kernel (ops/stream.py).  Runs on the card unless ``--device cpu``
(the kernels' plain versions; times are then the CPU's)."""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import resolve_device
from ..ops.qmatmul import dequant_matmul, q_matmul
from ..ops.qtensor import QTensor
from ..ops.stream import LANES, hbm_stream, stream_shape
from ..quant.types import GGMLType


def build_parser(p: argparse.ArgumentParser | None = None):
    p = p or argparse.ArgumentParser("benchmark-matmult", description=__doc__)
    p.add_argument("-i", "--iterations", type=int, default=10)
    p.add_argument("--sizex", type=int, default=11008)
    p.add_argument("--sizey", type=int, default=4096)
    p.add_argument("--sizez", type=int, default=128)
    p.add_argument("-t", "--type", default="q4_0")
    p.add_argument("--vdot", action="store_true",
                   help="quantized dot against the float dot: error and GEMV speed")
    p.add_argument("--stream", action="store_true",
                   help="HBM read stream: the practical read bandwidth")
    p.add_argument("--stream-gib", type=float, default=2.0)
    p.add_argument("--stream-tile-mib", type=int, default=4)
    p.add_argument("--stream-sweep", action="store_true",
                   help="the read stream at tiles of 4, 8, 16, 32 and 56 MiB; "
                        "reports the best GB/s")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no silent CPU fallback")
    return p


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _time(fn, iters: int, dev: torch.device) -> float:
    """Seconds per call: one warm-up call, then iters calls between two
    synchronisations."""
    fn()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(dev)
    return (time.perf_counter() - t0) / iters


def _stream_once(gib: float, tile_mib: int, iterations: int, dev: torch.device) -> float:
    """One read-stream measurement over a buffer of ones -> GB/s.  The
    checksum and the corner sums are exact on ones: a mismatch raises."""
    rows, tile_rows = stream_shape(gib, tile_mib)
    buf = torch.ones((rows, LANES), dtype=torch.uint8, device=dev)
    checksum, corner = hbm_stream(buf, tile_rows)
    if (int(checksum) != rows * LANES
            or not bool((corner == rows // tile_rows).all())):
        raise RuntimeError(f"read stream checksum {int(checksum)} != {rows * LANES} "
                           "or a corner sum is off: not every byte was read")
    t = _time(lambda: hbm_stream(buf, tile_rows), iterations, dev)
    return rows * LANES / 1e9 / t


def run_stream(args, dev: torch.device) -> int:
    if args.stream_sweep:
        best = (0.0, 0)
        for tile_mib in (4, 8, 16, 32, 56):
            gbs = _stream_once(args.stream_gib, tile_mib, args.iterations, dev)
            print(f"HBM read-stream: tile {tile_mib:4d} MiB -> {gbs:.1f} GB/s "
                  "(checksum ok)", flush=True)
            if gbs > best[0]:
                best = (gbs, tile_mib)
        print(f"HBM read-stream BEST: {best[0]:.1f} GB/s (tile {best[1]} MiB) "
              f"over {args.stream_gib:.2f} GiB")
        return 0
    gbs = _stream_once(args.stream_gib, args.stream_tile_mib, args.iterations, dev)
    print(f"HBM read-stream: {args.stream_gib:.2f} GiB at {gbs:.1f} GB/s  "
          f"(tile {args.stream_tile_mib} MiB, checksum ok)")
    return 0


def run_vdot(args, dev: torch.device) -> int:
    """Over 16 trials at K = sizey: the quantized dot (the JAX package's
    dequantize-then-bf16-dot path) against the exact f32 dot and against the
    dot with the dequantized weight; then the GEMV latency of the kernels."""
    k = args.sizey
    qtype = GGMLType[args.type.upper()]
    rng = np.random.default_rng(0)
    errs = []
    for _ in range(16):
        w = (rng.standard_normal((1, k)) * 0.5).astype(np.float32)
        x = (rng.standard_normal((1, k)) * 0.5).astype(np.float32)
        qw = QTensor.quantize(w, qtype, device="cpu")
        exact = float(x[0] @ w[0])
        qdot = float(dequant_matmul(torch.from_numpy(x), qw, torch.bfloat16)[0, 0])
        deq = float(x[0] @ qw.dequantize_t()[:, 0].numpy())
        errs.append((abs(qdot - exact), abs(qdot - deq)))
    errs = np.asarray(errs)
    print(f"{qtype.name} vdot over K={k}, 16 trials:")
    print(f"  |qdot - exact f32 dot|   avg {errs[:, 0].mean():.5f}  "
          f"max {errs[:, 0].max():.5f}  (quantization error)")
    print(f"  |qdot - dequant dot|     avg {errs[:, 1].mean():.5f}  "
          f"max {errs[:, 1].max():.5f}  (compute error)")
    w = (rng.standard_normal((128, k)) * 0.5).astype(np.float32)
    qw = QTensor.quantize(w, qtype, device=dev)
    x = torch.from_numpy((rng.standard_normal((1, k)) * 0.5).astype(np.float32)).to(dev)
    t = _time(lambda: q_matmul(x, qw), args.iterations, dev)
    print(f"  GEMV latency: {t * 1e6:.1f} us ({2 * 128 * k / t / 1e9:.2f} GFLOPS, "
          f"{dev.type})")
    return 0


def run(args) -> int:
    dev = resolve_device(args.device)
    if args.vdot:
        return run_vdot(args, dev)
    if args.stream or args.stream_sweep:
        return run_stream(args, dev)
    n, k, b = args.sizex, args.sizey, args.sizez
    qtype = GGMLType[args.type.upper()]
    rng = np.random.default_rng(0)
    w = rng.standard_normal((n, k), dtype=np.float32) * 0.1
    x = torch.from_numpy(rng.standard_normal((b, k), dtype=np.float32)).to(dev)
    qw = QTensor.quantize(w, qtype, device=dev)
    dw = torch.from_numpy(w).to(dev, torch.bfloat16)
    flops = 2.0 * n * k * b
    t_dense = _time(lambda: q_matmul(x, dw), args.iterations, dev)
    t_quant = _time(lambda: q_matmul(x, qw), args.iterations, dev)
    qbytes = sum(t.numel() * t.element_size()
                 for t in (qw.levels_t, qw.gscale_t, qw.gbias_t) if t is not None)
    print(f"dense bf16 : {t_dense * 1e3:8.3f} ms  {flops / t_dense / 1e9:10.1f} GFLOPS")
    print(f"{qtype.name:10s} : {t_quant * 1e3:8.3f} ms  {flops / t_quant / 1e9:10.1f} GFLOPS"
          f"  ({qbytes / t_quant / 1e9:.1f} GB/s weight stream)")
    print(f"speedup quantized/dense: {t_dense / t_quant:.2f}x  ({dev.type})")
    return 0


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
