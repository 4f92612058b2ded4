"""`quantize` — model-file requantization (examples/quantize/quantize.cpp),
on every family's ggjt file.  Host only: the card is not used."""

from __future__ import annotations

import argparse
import sys
import time

from ..formats.ggjt import detect_arch
from ..formats.quantize import QuantizeParams, quantize_model
from ..quant.types import LlamaFType

# name -> ftype (quantize.cpp QUANT_OPTIONS table)
FTYPE_MAP = {
    "q4_0": LlamaFType.MOSTLY_Q4_0,
    "q4_1": LlamaFType.MOSTLY_Q4_1,
    "q5_0": LlamaFType.MOSTLY_Q5_0,
    "q5_1": LlamaFType.MOSTLY_Q5_1,
    "q8_0": LlamaFType.MOSTLY_Q8_0,
    "q2_k": LlamaFType.MOSTLY_Q2_K,
    "q3_k_s": LlamaFType.MOSTLY_Q3_K_S,
    "q3_k_m": LlamaFType.MOSTLY_Q3_K_M,
    "q3_k_l": LlamaFType.MOSTLY_Q3_K_L,
    "q3_k": LlamaFType.MOSTLY_Q3_K_M,
    "q4_k_s": LlamaFType.MOSTLY_Q4_K_S,
    "q4_k_m": LlamaFType.MOSTLY_Q4_K_M,
    "q4_k": LlamaFType.MOSTLY_Q4_K_M,
    "q5_k_s": LlamaFType.MOSTLY_Q5_K_S,
    "q5_k_m": LlamaFType.MOSTLY_Q5_K_M,
    "q5_k": LlamaFType.MOSTLY_Q5_K_M,
    "q6_k": LlamaFType.MOSTLY_Q6_K,
    "f16": LlamaFType.MOSTLY_F16,
}


def build_parser(p: argparse.ArgumentParser | None = None):
    p = p or argparse.ArgumentParser("quantize", description=__doc__)
    p.add_argument("model_in")
    p.add_argument("model_out")
    p.add_argument("ftype", help="|".join(FTYPE_MAP))
    p.add_argument("--arch", default=None)
    p.add_argument("--allow-requantize", action="store_true")
    p.add_argument("--leave-output-tensor", action="store_true",
                   help="skip the output.weight -> Q6_K upgrade")
    p.add_argument("--qkk64", action="store_true",
                   help="write k-quants as 64-element super-blocks (the "
                        "reference's -DGGML_QKK_64 build variant; for "
                        "tensors 64- but not 256-divisible)")
    return p


def run(args) -> int:
    key = args.ftype.lower()
    if key not in FTYPE_MAP:
        print(f"invalid ftype '{args.ftype}'; choose from "
              f"{' '.join(FTYPE_MAP)}", file=sys.stderr)
        return 1
    arch = args.arch or detect_arch(args.model_in)
    t0 = time.perf_counter()
    qp = QuantizeParams(ftype=FTYPE_MAP[key], allow_requantize=args.allow_requantize,
                        quantize_output_tensor=not args.leave_output_tensor,
                        qk_k=64 if args.qkk64 else 256)
    stats = quantize_model(args.model_in, args.model_out, qp, arch=arch)
    print(f"\nquantize time = {(time.perf_counter() - t0) * 1e3:.2f} ms")
    for k, v in stats.items():
        if not isinstance(v, (list, dict)):
            print(f"  {k}: {v}")
    return 0


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
