"""`train` — train a llama-family model from scratch on raw text
(examples/train-text-from-scratch/train-text-from-scratch.cpp).

Takes the vocab from an existing ggjt model file (--vocab-model, like the
reference), random-inits or resumes from a checkpoint, runs Adam or L-BFGS
over random n_ctx windows of the tokenized corpus, saves a checkpoint with
the optimizer state, optionally exports an inference-ready ggjt
(--model-out), and samples a few tokens at the end (the reference's
post-train generation).  Runs on the card unless --device cpu."""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..formats.ggjt import read_ggjt
from ..models.config import ModelConfig
from ..runtime.tokenizer import Tokenizer, Vocab


def build_parser(p: argparse.ArgumentParser | None = None):
    p = p or argparse.ArgumentParser("train", description=__doc__)
    p.add_argument("--vocab-model", required=True,
                   help="ggjt file supplying the tokenizer vocab")
    p.add_argument("--train-data", required=True, help="raw text corpus")
    p.add_argument("--checkpoint-in", default=None)
    p.add_argument("--checkpoint-out", default="checkpoint.bin")
    p.add_argument("--model-out", default=None,
                   help="export trained model as ggjt f32")
    p.add_argument("--embd", type=int, default=256)
    p.add_argument("--head", type=int, default=8)
    p.add_argument("--layer", type=int, default=16)
    p.add_argument("--mult", type=int, default=256)
    p.add_argument("--rotmax", type=int, default=0, help="0 = full head_dim")
    p.add_argument("-c", "--ctx", type=int, default=64)
    p.add_argument("-b", "--batch", type=int, default=8)
    p.add_argument("-n", "--iterations", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--adam", action="store_true", default=True)
    p.add_argument("--lbfgs", dest="adam", action="store_false")
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument("--predict", type=int, default=16,
                   help="sample N tokens after training")
    p.add_argument("--use-scan", action="store_true",
                   help="stacked-layer forward (the JAX package's scan over "
                        "layers; the checkpoint keeps [L, ...] leaves)")
    p.add_argument("--use-remat", action="store_true",
                   help="recompute each layer's activations in the backward "
                        "(torch.utils.checkpoint); implies --use-scan")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no silent CPU fallback")
    return p


def run(args) -> int:
    from ..training import (OptParams, init_opt_state, init_transformer, load_checkpoint,
                            make_optimizer, make_train_step, save_checkpoint)

    dev = resolve_device(args.device)
    gf = read_ggjt(args.vocab_model)
    vocab = Vocab.from_ggjt(gf)
    tok = Tokenizer(vocab)

    cfg = ModelConfig.llama(
        n_vocab=vocab.n_vocab, n_embd=args.embd, n_mult=args.mult,
        n_head=args.head, n_layer=args.layer,
        n_rot=args.rotmax or args.embd // args.head, n_ctx=args.ctx,
    )
    with open(args.train_data, "rb") as f:
        text = f.read()
    data = np.asarray(tok.tokenize(text, bos=True), dtype=np.int32)
    print(f"corpus: {len(data)} tokens, model: {cfg.n_embd}x{cfg.n_layer} "
          f"heads={cfg.n_head} n_ff={cfg.n_ff}", file=sys.stderr)

    op = OptParams(kind="adam" if args.adam else "lbfgs",
                   lr=args.learning_rate, grad_clip=args.grad_clip)
    tx = make_optimizer(op)
    use_scan = args.use_scan or args.use_remat
    params = init_transformer(cfg, torch.Generator(device=dev).manual_seed(args.seed))
    if use_scan:
        from ..training.stacked import make_stacked_train_step, stack_params, unstack_params

        params = stack_params(params)
        step = make_stacked_train_step(cfg, tx, remat=args.use_remat)
    else:
        step = make_train_step(cfg, tx)
    opt_state = init_opt_state(tx, params)
    start = 0
    if args.checkpoint_in:
        # the checkpoint's layout (stacked or per-layer) must match the
        # mode: the 'like' trees below carry the chosen structure
        cfg, params, opt_state, start = load_checkpoint(args.checkpoint_in, params, opt_state)
        print(f"resumed from {args.checkpoint_in} at step {start}", file=sys.stderr)
    rng = np.random.default_rng(args.seed)
    n_ctx, n_batch = args.ctx, args.batch
    t0 = time.perf_counter()
    loss = float("nan")
    for it in range(start, start + args.iterations):
        # random example windows (get_example_targets)
        starts = rng.integers(0, len(data) - n_ctx - 1, size=n_batch)
        tokens = np.stack([data[s : s + n_ctx] for s in starts])
        targets = np.stack([data[s + 1 : s + n_ctx + 1] for s in starts])
        params, opt_state, loss = step(params, opt_state,
                                       torch.from_numpy(tokens).long().to(dev),
                                       torch.from_numpy(targets).long().to(dev))
        if (it - start) % 8 == 0 or it == start + args.iterations - 1:
            print(f"iter {it}: loss {float(loss):.4f} "
                  f"({time.perf_counter() - t0:.1f}s)", file=sys.stderr)

    save_checkpoint(args.checkpoint_out, cfg, params, opt_state,
                    step=start + args.iterations, extra={"stacked": use_scan})
    print(f"checkpoint saved to {args.checkpoint_out}", file=sys.stderr)
    if use_scan:  # inference below wants per-layer params
        params = unstack_params(params, cfg.n_layer)

    if args.model_out:
        from ..formats.export import save_llama_ggjt

        save_llama_ggjt(args.model_out, cfg, params,
                        [(vocab.tokens[i], vocab.scores[i]) for i in range(vocab.n_vocab)])
        print(f"model exported to {args.model_out}", file=sys.stderr)

    if args.predict > 0:
        from ..runtime.context import Context
        from ..training.tree import tree_map

        ctx = Context(cfg, tree_map(lambda t: t.detach(), params), n_ctx=args.ctx,
                      device=dev)
        seed_toks = data[: min(8, n_ctx // 2)].tolist()
        logits = ctx.eval(np.asarray([seed_toks], np.int32))
        out = []
        for _ in range(args.predict):
            t = int(np.argmax(logits[0, -1]))
            out.append(t)
            if ctx.n_past + 1 > args.ctx:
                break
            logits = ctx.eval(np.asarray([[t]], np.int32))
        print("sample:", tok.detokenize(seed_toks).decode(errors="replace"),
              "->", tok.detokenize(out).decode(errors="replace"))
    print(f"final loss {float(loss):.4f}")
    return 0


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
