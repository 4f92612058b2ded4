"""`perplexity` — the wikitext-2 quality gate (examples/perplexity)."""

from __future__ import annotations

import argparse
import sys

from ..runtime.perplexity import perplexity_file
from .common import add_model_args, load_model


def build_parser(p: argparse.ArgumentParser | None = None):
    p = p or argparse.ArgumentParser("perplexity", description=__doc__)
    add_model_args(p)
    p.add_argument("-f", "--file", required=True, help="raw text file "
                   "(e.g. wiki.test.raw)")
    p.add_argument("--on-device", action="store_true",
                   help="reduce the NLL on the device (f32 logsumexp; avoids "
                        "copying [n_ctx, vocab] logits to the host per chunk)")
    return p


def run(args) -> int:
    lm = load_model(args, logits_all=True)
    print(f"calculating perplexity over chunks of {args.n_ctx}",
          file=sys.stderr)
    res = perplexity_file(
        lm.ctx, lm.tokenizer, args.file, on_device=args.on_device,
        n_ctx=args.n_ctx, n_batch=args.n_batch,
        progress=lambda s: print(s, end="", flush=True, file=sys.stderr),
    )
    print(file=sys.stderr)
    print(f"Final estimate: PPL = {res.ppl:.4f} over {res.count} tokens")
    return 0


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
