"""`export-graph` — export the decode step with its weights, or replay an
exported file standalone (llama_eval_export llama.cpp:3413 + examples/metal
static-graph runner).  ``save`` traces on --device (cuda unless cpu is
named), with the kernels as custom ops in the graph; ``run`` replays on the
device the file was exported on."""

from __future__ import annotations

import argparse

import numpy as np


def build_parser(p: argparse.ArgumentParser | None = None):
    p = p or argparse.ArgumentParser("export-graph", description=__doc__)
    sub = p.add_subparsers(dest="action", required=True)
    s = sub.add_parser("save", help="export model decode step + weights")
    from .common import add_model_args

    add_model_args(s)
    s.add_argument("-o", "--out", required=True)
    s.add_argument("--n-tokens", type=int, default=1)
    r = sub.add_parser("run", help="replay an exported artifact (no model code)")
    r.add_argument("artifact")
    r.add_argument("--tokens", default="1",
                   help="comma-separated token ids to feed, one step each")
    return p


def run(args) -> int:
    if args.action == "save":
        from ..runtime.export import export_decode
        from .common import cache_dtype, load_model

        lm = load_model(args)
        export_decode(lm.cfg, lm.ctx.params, args.out, n_tokens=args.n_tokens,
                      n_ctx=args.n_ctx, device=args.device, cache_dtype=cache_dtype(args))
        print(f"exported decode step to {args.out}")
        return 0

    from ..runtime.export import load_exported

    m = load_exported(args.artifact)
    print(f"loaded {args.artifact}: {m.cfg.arch} n_embd={m.cfg.n_embd} "
          f"n_layer={m.cfg.n_layer} batch={m.batch}")
    for tid in [int(t) for t in args.tokens.split(",") if t]:
        logits = m.step(np.asarray([[tid]], np.int64))
        print(f"token {tid} -> argmax {int(np.argmax(logits[0, -1]))} "
              f"max {float(np.max(logits)):.4f}")
    return 0


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
