"""`embedding` — print the model's final hidden state for a prompt
(examples/embedding): the output-norm state of the prompt's last token, then
the timings report."""

from __future__ import annotations

import argparse

from ..runtime.tokenizer import TOKEN_BOS
from .common import add_model_args, load_model


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("embedding", description=__doc__)
    add_model_args(p)
    p.add_argument("-p", "--prompt", required=True)
    return p


def run(args) -> int:
    lm = load_model(args)
    # an empty prompt tokenizes to nothing; start from a bare BOS
    toks = lm.tokenizer.tokenize(args.prompt, bos=True) or [TOKEN_BOS]
    emb = lm.ctx.embed(toks)  # [1, n_embd]
    print(" ".join(f"{x:f}" for x in emb[0]))
    print("\n" + lm.ctx.timings.report())
    return 0


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
