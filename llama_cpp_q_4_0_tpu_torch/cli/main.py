"""`main` — the text-generation CLI (examples/main).

The reference's decode loop end to end, as the JAX package's ``cli/main.py``
drives it: a prompt from ``-p`` or ``-f``, prompt-cache sessions with prefix
reuse (zip or ``.ggsn``), the infinite-text context swap (``--n-keep``), the
full sampling chain, antiprompts (``-r``), the interactive, instruct and
OpenAssistant modes through the console (cli/console.py), and the timings
report on stderr.  ``--ondevice-sampling`` samples on the device in chunked
decode loops (runtime/device_sample.py).  The speculative flags
(``--draft``, ``--draft-model``) are not ported."""

from __future__ import annotations

import argparse
import os
import sys

from ..runtime.device_sample import DeviceSampling, generate_ondevice
from ..runtime.generate import GenerateParams, generate
from ..runtime.session import load_session, save_session, session_prefix_match
from ..runtime.tokenizer import TOKEN_BOS, TOKEN_EOS
from .common import add_model_args, add_sampling_args, load_model, sampling_from_args
from .console import Color, Console


def build_parser(p: argparse.ArgumentParser | None = None):
    p = p or argparse.ArgumentParser("main", description=__doc__)
    add_model_args(p)
    add_sampling_args(p)
    p.add_argument("-p", "--prompt", default="")
    p.add_argument("-f", "--file", default=None, help="prompt file")
    p.add_argument("--n-keep", type=int, default=0,
                   help="tokens kept on context swap (-1 = whole prompt)")
    p.add_argument("--prompt-cache", default=None, dest="path_prompt_cache",
                   help="session file for prompt state reuse (.ggsn: the "
                        "reference's binary format)")
    p.add_argument("-r", "--reverse-prompt", action="append", default=[],
                   dest="antiprompt")
    p.add_argument("-i", "--interactive", action="store_true")
    p.add_argument("--interactive-first", action="store_true")
    p.add_argument("-ins", "--instruct", action="store_true",
                   help="instruction mode (alpaca framing)")
    p.add_argument("--oasst", action="store_true",
                   help="OpenAssistant chat framing with <|prompter|>/"
                        "<|assistant|> tokens")
    p.add_argument("--ondevice-sampling", action="store_true",
                   help="sample on the device in chunked decode loops, one host "
                        "round trip a chunk (temp/top-k/top-p/tfs/typical, "
                        "repetition penalties, logit bias)")
    p.add_argument("--color", action="store_true")
    p.add_argument("--multiline-input", action="store_true",
                   dest="multiline_input",
                   help="reverse the `\\` convention: lines continue until "
                        "a trailing `\\` or `/`")
    p.add_argument("--in-prefix", default="", dest="input_prefix",
                   help="string prepended to every interactive input")
    p.add_argument("--in-suffix", default="", dest="input_suffix",
                   help="string appended to every interactive input")
    p.add_argument("--verbose-prompt", action="store_true")
    return p


def _reuse_session(args, ctx, tok, prompt: str, prompt_tokens: list[int]):
    """--prompt-cache: load the saved state and keep its longest prefix
    shared with the prompt (the JAX main's rewind).  Returns the session's
    reused tokens and the prompt tokens still to evaluate."""
    session_tokens: list[int] = []
    if os.path.exists(args.path_prompt_cache):
        session_tokens = load_session(args.path_prompt_cache, ctx)
        n_match = session_prefix_match(session_tokens, prompt_tokens)
        if n_match == len(prompt_tokens) and n_match > 0:
            # exact match: evaluate the real last token again for fresh
            # logits (a duplicate token would shift the first new token's
            # distribution)
            n_match -= 1
        if n_match <= ctx.n_past:
            # rewind to the matched prefix: slots >= n_past are masked until
            # rewritten
            ctx.n_past = n_match
        else:
            ctx.reset()
            n_match = 0
        # the saved token list follows the cache: slots past n_match will be
        # overwritten
        session_tokens = session_tokens[:n_match]
        prompt_tokens = prompt_tokens[n_match:]
        print(f"session: reused {n_match} tokens", file=sys.stderr)
    if not prompt_tokens:
        prompt_tokens = [(tok.tokenize(prompt, bos=True) or [TOKEN_BOS])[-1]]
    return session_tokens, prompt_tokens


def run(args) -> int:
    lm = load_model(args)
    ctx, tok = lm.ctx, lm.tokenizer
    gp = GenerateParams(n_predict=args.n_predict, n_keep=args.n_keep,
                        ignore_eos=args.ignore_eos,
                        sampling=sampling_from_args(args), seed=args.seed)

    prompt = args.prompt
    if args.file:
        with open(args.file) as f:
            prompt = f.read()
    if args.instruct:
        prompt = f"### Instruction:\n\n{prompt}\n\n### Response:\n\n"

    def frame_oasst(text: str) -> list[int]:
        """<|prompter|>text<|endoftext|><|assistant|> token framing; plain
        text markers when the vocabulary lacks the special tokens."""
        t2i = tok.vocab.token_to_id
        pid = t2i.get(b"<|prompter|>")
        aid = t2i.get(b"<|assistant|>")
        if pid is None or aid is None:
            return tok.tokenize(f"<|prompter|>{text}<|endoftext|><|assistant|>")
        return [pid] + tok.tokenize(text) + [TOKEN_EOS, aid]

    if args.oasst:
        prompt_tokens = frame_oasst(prompt)
    else:
        # an empty prompt tokenizes to nothing; start from a bare BOS
        prompt_tokens = tok.tokenize(prompt, bos=True) or [TOKEN_BOS]
    if args.verbose_prompt:
        for t in prompt_tokens:
            print(f"{t:6d} -> '{tok.token_text(t).decode(errors='replace')}'",
                  file=sys.stderr)

    session_tokens: list[int] = []
    if args.path_prompt_cache:
        session_tokens, prompt_tokens = _reuse_session(args, ctx, tok, prompt,
                                                       prompt_tokens)

    antiprompts = tuple(tok.tokenize(a) for a in args.antiprompt)

    def emit(token_id: int):
        sys.stdout.buffer.write(tok.token_text(token_id))
        sys.stdout.flush()

    console = Console(use_color=args.color and sys.stdout.isatty(),
                      multiline_input=args.multiline_input)

    all_tokens = list(session_tokens) + list(prompt_tokens)
    console.set_color(Color.PROMPT)  # the prompt's echo
    print(prompt, end="", flush=True)
    console.set_color(Color.DEFAULT)
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
        print("\n" + ctx.timings.report(), file=sys.stderr)
        return 0
    interactive = (args.interactive or args.interactive_first
                   or args.instruct or args.oasst)
    try:
        while True:
            for t in generate(ctx, prompt_tokens, gp, antiprompts=antiprompts,
                              eos_token=TOKEN_EOS):
                emit(t)
                all_tokens.append(t)
            if not interactive:
                break
            print("\n> ", end="", flush=True)
            if args.input_prefix:
                print(args.input_prefix, end="", flush=True)
            buffer = console.read_input()
            if buffer is None:  # EOF / Ctrl-D
                break
            # a bare Enter passes control back without new tokens; the
            # reference adds input_prefix before that length check
            text = args.input_prefix + buffer
            if len(text) <= 1:
                prompt_tokens = []
                continue
            if args.input_suffix:
                text += args.input_suffix
                print(args.input_suffix, end="", flush=True)
            if args.instruct:
                text = f"### Instruction:\n\n{text}\n\n### Response:\n\n"
            if args.oasst:
                prompt_tokens = frame_oasst(text)
            else:
                prompt_tokens = tok.tokenize(text)
            all_tokens += prompt_tokens
    except KeyboardInterrupt:
        console.cleanup()
        print(file=sys.stderr)
    console.cleanup()

    if args.path_prompt_cache:
        # a .ggsn path writes the reference's binary session format
        save_session(args.path_prompt_cache, ctx, all_tokens,
                     hparams=lm.hparams, ftype=lm.ftype)
        print(f"session: saved to {args.path_prompt_cache}", file=sys.stderr)
    print("\n" + ctx.timings.report(), file=sys.stderr)
    return 0


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
