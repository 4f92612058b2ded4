"""`main` — the text-generation CLI (examples/main).

The reference's decode loop end to end, as the JAX package's ``cli/main.py``
drives it: a prompt from ``-p`` or ``-f``, prompt-cache sessions with prefix
reuse (zip or ``.ggsn``), the infinite-text context swap (``--n-keep``), the
full sampling chain, antiprompts (``-r``), the interactive, instruct and
OpenAssistant modes through the console (cli/console.py), and the timings
report on stderr.  ``--ondevice-sampling`` samples on the device in chunked
decode loops (runtime/device_sample.py).  ``--draft K`` decodes
speculatively, K drafts a verify: prompt-lookup drafts through the host loop
(runtime/speculative.py), or with ``--ondevice-sampling`` the whole
draft-verify loop on the device (runtime/device_spec.py); ``--draft-model``
drafts with a small model of the same vocabulary instead, in either loop.
An RWKV model's prompt takes no BOS, and its ``--draft K`` always runs the
device loop over the recurrent state (``generate_ondevice_spec_rwkv``).
The speculative run prints its stats line on stderr."""

from __future__ import annotations

import argparse
import copy
import os
import sys

from ..runtime.device_sample import DeviceSampling, generate_ondevice
from ..runtime.context import RwkvContext
from ..runtime.device_spec import (generate_ondevice_spec, generate_ondevice_spec_draft,
                                   generate_ondevice_spec_rwkv)
from ..runtime.generate import GenerateParams, generate
from ..runtime.session import load_session, save_session, session_prefix_match
from ..runtime.speculative import (DraftModelDrafter, SpecParams, SpecStats,
                                   generate_speculative)
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
    p.add_argument("--draft", type=int, default=0, metavar="K",
                   help="speculative decoding: verify K drafted tokens a forward "
                        "(prompt-lookup drafts; exact for greedy, unbiased for "
                        "sampling)")
    p.add_argument("--draft-model", default=None, metavar="PATH",
                   help="a small model of the same vocabulary that drafts for --draft "
                        "(default: prompt-lookup drafts, no model)")
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


def _draft_context(args):
    """The --draft-model file loaded as main loads its model (no --lora)."""
    dargs = copy.copy(args)
    dargs.model, dargs.lora = args.draft_model, None
    return load_model(dargs).ctx


def _speculative(args, ctx, prompt_tokens, ds):
    """--draft K, one of the JAX main's four loops: the host loop (prompt
    lookup or a DraftModelDrafter), or with --ondevice-sampling the device
    loop of prompt-lookup rounds or of draft-model rounds; an RWKV context
    always takes the device loop of prompt-lookup rounds (its state cannot
    rewind for the host loop).  Returns (tokens, SpecStats)."""
    stats = SpecStats()
    spec = SpecParams(n_draft=args.draft)
    common = dict(sampling=ds, seed=max(0, args.seed), ignore_eos=args.ignore_eos,
                  stats=stats)
    if isinstance(ctx, RwkvContext):
        if args.draft_model:
            print("warning: --draft-model is not supported for rwkv; using prompt-lookup "
                  "drafting", file=sys.stderr)
        out = generate_ondevice_spec_rwkv(ctx, prompt_tokens, args.n_predict, spec=spec,
                                          **common)
    elif args.ondevice_sampling and not args.draft_model:
        out = generate_ondevice_spec(ctx, prompt_tokens, args.n_predict, spec=spec,
                                     n_keep=args.n_keep, **common)
    elif args.ondevice_sampling:
        out = generate_ondevice_spec_draft(ctx, _draft_context(args), prompt_tokens,
                                           args.n_predict, n_draft=args.draft, **common)
    else:
        drafter = DraftModelDrafter(_draft_context(args)) if args.draft_model else None
        out = generate_speculative(ctx, prompt_tokens, args.n_predict, spec=spec,
                                   drafter=drafter, **common)
    return out, stats


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
        # RWKV prompts take no BOS; an empty prompt tokenizes to nothing, and
        # the transformers then start from a bare BOS
        rwkv = lm.arch == "rwkv"
        prompt_tokens = tok.tokenize(prompt, bos=not rwkv) or ([] if rwkv else [TOKEN_BOS])
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
    # the JAX main's fields for the device loops: no mirostat there
    sp = gp.sampling
    ds = DeviceSampling(
        temp=sp.temp, top_k=sp.top_k, top_p=sp.top_p,
        repeat_penalty=sp.repeat_penalty, repeat_last_n=sp.repeat_last_n,
        frequency_penalty=sp.frequency_penalty, presence_penalty=sp.presence_penalty,
        tfs_z=sp.tfs_z, typical_p=sp.typical_p,
        logit_bias=tuple(sorted(sp.logit_bias.items())))
    if args.draft > 0:
        out, stats = _speculative(args, ctx, prompt_tokens, ds)
        for t in out:
            emit(t)
        print("\n" + stats.report(), file=sys.stderr)
        print(ctx.timings.report(), file=sys.stderr)
        return 0
    if args.ondevice_sampling:
        for t in generate_ondevice(ctx, prompt_tokens, args.n_predict, sampling=ds,
                                   seed=max(0, args.seed)):
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
