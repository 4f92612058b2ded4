"""`update` — rewrite an older ggml/ggmf/ggjt file as current ggjt
(llama_model_update, llama.cpp:2211-2244).  Host only: the card is not
used."""

from __future__ import annotations

import argparse

from ..formats.update import update_model


def build_parser(p: argparse.ArgumentParser | None = None):
    p = p or argparse.ArgumentParser("update", description=__doc__)
    p.add_argument("model_in")
    p.add_argument("model_out")
    p.add_argument("--arch", default=None)
    return p


def run(args) -> int:
    stats = update_model(args.model_in, args.model_out, args.arch)
    print(f"updated {args.model_in} -> {args.model_out}: "
          f"{stats['tensors']} tensors, arch={stats['arch']}, "
          f"ftype={stats['ftype']}")
    return 0


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
