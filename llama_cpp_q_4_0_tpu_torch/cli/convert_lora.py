"""`convert-lora` — a PEFT LoRA adapter directory -> a ggla file
(convert-lora-to-ggml.py)."""

from __future__ import annotations

import argparse
import os

from ..models.lora import convert_peft_dir


def build_parser(p: argparse.ArgumentParser | None = None):
    p = p or argparse.ArgumentParser("convert-lora", description=__doc__)
    p.add_argument("peft_dir", help="dir with adapter_config.json + adapter_model.bin")
    p.add_argument("-o", "--out", default=None,
                   help="output path (default <dir>/ggml-adapter-model.bin)")
    return p


def run(args) -> int:
    out = args.out or os.path.join(args.peft_dir, "ggml-adapter-model.bin")
    convert_peft_dir(args.peft_dir, out)
    print(f"wrote {out}")
    return 0


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
