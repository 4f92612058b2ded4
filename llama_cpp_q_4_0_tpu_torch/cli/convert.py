"""`convert` — local HF checkpoint dir -> ggjt model file (convert.py and
scripts/*/convert-*-to-ggml.py).  The vocabulary comes from the checkpoint's
tokenizer.model (sentencepiece) or its HF tokenizer (transformers); where
neither package is installed, call ``formats.convert_hf.CONVERTERS[arch]``
with ``vocab=`` instead."""

from __future__ import annotations

import argparse

from ..formats.convert_hf import CONVERTERS, detect_hf_arch


def build_parser(p: argparse.ArgumentParser | None = None):
    p = p or argparse.ArgumentParser("convert", description=__doc__)
    p.add_argument("model_dir", help="local HF checkpoint directory")
    p.add_argument("out", help="output ggjt path")
    p.add_argument("--arch", default=None,
                   help="llama|gptneox|falcon|rwkv|bonsai (default: detect "
                        "from config.json model_type)")
    p.add_argument("--outtype", choices=("f16", "f32", "q4_0", "q4_1"),
                   default="f16",
                   help="q4_0/q4_1 quantize at conversion time "
                        "(convert.py GGMLFileType; llama only)")
    p.add_argument("--vocab-only", action="store_true",
                   help="write a vocab-only ggjt v1 file, no weights "
                        "(convert.py --vocab-only)")
    return p


def run(args) -> int:
    arch = args.arch or detect_hf_arch(args.model_dir)
    if args.vocab_only:
        from ..formats.convert_hf import auto_vocab, load_config, \
            write_vocab_only

        cfg = load_config(args.model_dir)
        n_vocab = cfg.get("vocab_size", 0)
        write_vocab_only(args.out, auto_vocab(args.model_dir, n_vocab))
        print(f"wrote {args.out} (vocab only, {n_vocab} tokens)")
        return 0
    if args.outtype in ("q4_0", "q4_1"):
        if arch != "llama":
            print(f"--outtype {args.outtype} is llama-only (the reference's "
                  "convert.py; other archs use the quantize tool)")
            return 1
        CONVERTERS[arch](args.model_dir, args.out, outtype=args.outtype)
    else:
        CONVERTERS[arch](args.model_dir, args.out,
                         f16=(args.outtype == "f16"))
    print(f"wrote {args.out} ({arch}, {args.outtype})")
    return 0


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
