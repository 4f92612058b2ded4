"""`main` — the text-generation CLI (examples/main), non-interactive.

Prints the prompt, then each generated token as it is sampled, and the
timings report on stderr.  Takes the sampling chain's flags;
``--ondevice-sampling`` samples on the device in chunked decode loops
(runtime/device_sample.py)."""

from __future__ import annotations

import argparse
import sys

from ..runtime.device_sample import DeviceSampling, generate_ondevice
from ..runtime.generate import GenerateParams, generate
from ..runtime.tokenizer import TOKEN_BOS, TOKEN_EOS
from .common import add_model_args, add_sampling_args, load_model, sampling_from_args


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("main", description=__doc__)
    add_model_args(p)
    add_sampling_args(p)
    p.add_argument("-p", "--prompt", default="")
    p.add_argument("--ondevice-sampling", action="store_true",
                   help="sample on the device in chunked decode loops, one host "
                        "round trip a chunk (temp/top-k/top-p/tfs/typical, "
                        "repetition penalties, logit bias)")
    return p


def run(args) -> int:
    lm = load_model(args)
    ctx, tok = lm.ctx, lm.tokenizer
    gp = GenerateParams(n_predict=args.n_predict, ignore_eos=args.ignore_eos,
                        sampling=sampling_from_args(args), seed=args.seed)
    # an empty prompt tokenizes to nothing; start from a bare BOS
    prompt_tokens = tok.tokenize(args.prompt, bos=True) or [TOKEN_BOS]
    print(args.prompt, end="", flush=True)

    def emit(t: int):
        sys.stdout.buffer.write(tok.token_text(t))
        sys.stdout.flush()

    if args.ondevice_sampling:
        # the JAX main's fields: no mirostat on this path
        sp = gp.sampling
        out = generate_ondevice(
            ctx, prompt_tokens, args.n_predict,
            sampling=DeviceSampling(
                temp=sp.temp, top_k=sp.top_k, top_p=sp.top_p,
                repeat_penalty=sp.repeat_penalty, repeat_last_n=sp.repeat_last_n,
                frequency_penalty=sp.frequency_penalty,
                presence_penalty=sp.presence_penalty, tfs_z=sp.tfs_z,
                typical_p=sp.typical_p, logit_bias=tuple(sorted(sp.logit_bias.items()))),
            seed=max(0, args.seed))
        for t in out:
            emit(t)
    else:
        for t in generate(ctx, prompt_tokens, gp, eos_token=TOKEN_EOS):
            emit(t)
    print("\n" + ctx.timings.report(), file=sys.stderr)
    return 0


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
