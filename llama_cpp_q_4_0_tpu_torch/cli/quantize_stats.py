"""`quantize-stats` — per-layer / per-format round-trip error analysis
(examples/quantize-stats/quantize-stats.cpp:29-438): RMSE, max error,
error quantiles and histogram for every quantizable tensor x format, with
layer include/exclude regex.  Host only: the card is not used."""

from __future__ import annotations

import argparse
import re
import sys

import numpy as np

from ..formats.ggjt import detect_arch, read_ggjt
from ..quant.registry import QUANT_FNS, dequantize, quantize
from ..quant.types import GGMLType, is_quantized

HISTOGRAM_BUCKETS = 150
HISTOGRAM_RANGE = 0.03


def build_parser(p: argparse.ArgumentParser | None = None):
    p = p or argparse.ArgumentParser("quantize-stats", description=__doc__)
    p.add_argument("-m", "--model", required=True)
    p.add_argument("--arch", default=None)
    p.add_argument("-t", "--type", action="append", default=[],
                   help="restrict to format(s), e.g. q4_0")
    p.add_argument("-l", "--include-layer", action="append", default=[])
    p.add_argument("-L", "--exclude-layer", action="append", default=[])
    p.add_argument("-p", "--per-layer-stats", action="store_true")
    p.add_argument("--histogram", action="store_true")
    p.add_argument("--qkk64", action="store_true",
                   help="measure k-quants with 64-element super-blocks "
                        "(the -DGGML_QKK_64 variant); admits rows that are "
                        "64- but not 256-divisible")
    return p


class ErrorStats:
    """Squared-error sum, max error and a histogram of |error| over
    HISTOGRAM_BUCKETS buckets of [0, HISTOGRAM_RANGE)."""

    def __init__(self):
        self.num_samples = 0
        self.total_error = 0.0
        self.max_error = 0.0
        self.hist = np.zeros(HISTOGRAM_BUCKETS, dtype=np.int64)

    def update(self, ref: np.ndarray, got: np.ndarray):
        err = got.astype(np.float64) - ref.astype(np.float64)
        self.num_samples += err.size
        self.total_error += float((err * err).sum())
        self.max_error = max(self.max_error, float(np.abs(err).max()))
        idx = np.minimum((np.abs(err) / HISTOGRAM_RANGE * HISTOGRAM_BUCKETS).astype(np.int64),
                         HISTOGRAM_BUCKETS - 1)
        self.hist += np.bincount(idx.ravel(), minlength=HISTOGRAM_BUCKETS)

    def merge(self, other: "ErrorStats"):
        self.num_samples += other.num_samples
        self.total_error += other.total_error
        self.max_error = max(self.max_error, other.max_error)
        self.hist += other.hist

    @property
    def rmse(self):
        return (self.total_error / max(1, self.num_samples)) ** 0.5

    def quantile(self, q: float) -> float:
        """The error below which a fraction q of the samples fall."""
        i = int(np.searchsorted(np.cumsum(self.hist), q * self.num_samples))
        return (i + 0.5) * HISTOGRAM_RANGE / HISTOGRAM_BUCKETS

    def report(self, name: str):
        print(f"{name:26s}: rmse {self.rmse:.8f}, maxerr {self.max_error:.8f}, "
              f"95pct<{self.quantile(0.95):.4f}, median<{self.quantile(0.5):.4f}")


def run(args) -> int:
    arch = args.arch or detect_arch(args.model)
    gf = read_ggjt(args.model, arch)
    types = ([GGMLType[t.upper()] for t in args.type] if args.type
             else [t for t in QUANT_FNS if is_quantized(t)])
    inc = [re.compile(r) for r in args.include_layer]
    exc = [re.compile(r) for r in args.exclude_layer]
    qk_k = 64 if args.qkk64 else 256
    names = [name for name, t in gf.tensors.items()
             if len(t.shape) == 2 and t.shape[1] % qk_k == 0
             and (not inc or any(r.search(name) for r in inc))
             and not any(r.search(name) for r in exc)]
    print(f"testing {len(names)} layers x {len(types)} formats", file=sys.stderr)

    for qt in types:
        total = ErrorStats()
        for name in names:
            ref = gf.tensor_f32(name).astype(np.float32)
            rt = dequantize(quantize(ref, qt, qk_k), qt, qk_k).reshape(ref.shape)
            if args.per_layer_stats:
                st = ErrorStats()
                st.update(ref, rt)
                st.report(f"{qt.name} {name}")
                total.merge(st)
            else:
                total.update(ref, rt)
        total.report(qt.name)
        if args.histogram:
            print("  error histogram:", " ".join(str(int(x)) for x in total.hist[:32]), "...")
    return 0


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
