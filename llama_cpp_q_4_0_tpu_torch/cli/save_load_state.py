"""`save-load-state` — determinism self-test (examples/save-load-state):
generate, snapshot the state, keep generating, restore the snapshot into a
second context, regenerate, and require identical output."""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..runtime.context import Context
from ..runtime.sampling import Candidates, sample_token
from ..runtime.session import get_state, set_state, state_from_bytes, state_to_bytes
from ..runtime.tokenizer import TOKEN_BOS
from .common import add_model_args, cache_dtype, load_model


def build_parser(p: argparse.ArgumentParser | None = None):
    p = p or argparse.ArgumentParser("save-load-state", description=__doc__)
    add_model_args(p)
    p.add_argument("-p", "--prompt", default="The quick brown fox")
    p.add_argument("-n", "--n-predict", type=int, default=16)
    p.add_argument("-s", "--seed", type=int, default=42)
    return p


def _sample_n(ctx, first_logits, n, rng):
    out = []
    logits = first_logits
    for _ in range(n):
        c = Candidates.from_logits(logits[0, -1])
        tok = sample_token(c, rng)
        out.append(tok)
        logits = ctx.eval(np.asarray([[tok]], np.int64))
    return out


def run(args) -> int:
    lm = load_model(args)
    ctx, tok = lm.ctx, lm.tokenizer
    prompt_tokens = tok.tokenize(args.prompt, bos=True) or [TOKEN_BOS]
    logits = ctx.eval(np.asarray([prompt_tokens], np.int64))

    # snapshot (llama_copy_state_data)
    blob = state_to_bytes(get_state(ctx))
    rng_state = np.random.default_rng(args.seed)
    first = _sample_n(ctx, logits, args.n_predict, rng_state)
    print("first run :", tok.detokenize(first).decode(errors="replace"))

    # restore into a fresh context of the same cache type
    ctx2 = Context(lm.cfg, ctx.params, n_ctx=args.n_ctx, cache_dtype=cache_dtype(args),
                   device=ctx.device)
    set_state(ctx2, state_from_bytes(blob))
    rng_state2 = np.random.default_rng(args.seed)
    second = _sample_n(ctx2, ctx2.logits, args.n_predict, rng_state2)
    print("second run:", tok.detokenize(second).decode(errors="replace"))

    if first != second:
        print("error: generations differ", file=sys.stderr)
        return 1
    print("state round-trip OK: generations identical")
    return 0


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
