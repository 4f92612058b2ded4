"""RWKV online training: rwkv_opt parity (rwkv.h:163-166, rwkv.cpp:1767-1840).

The reference fork's own feature: after observing that ``actual`` should
follow the current state instead of the model's prediction, run a few
L-BFGS iterations on the single-token squared-error (or cross-entropy) loss
and report the error before and after.  torch.autograd and the port of
optax.lbfgs (training/train.py) replace ggml_build_backward and ggml_opt; the
recurrent state is the fixed input and advances with the updated weights
afterwards, as the reference's final graph compute does.

The RwkvContext holds its params views and its state by address in its
replayed graphs, so the optimised weights and the advanced state are
written into its tensors with ``copy_``: rebinding them would leave the next
replayed step on the old weights without an error."""

from __future__ import annotations

from functools import partial

import torch

from ..models import rwkv as rwkv_mod
from ..models.config import ModelConfig
from ..ops.qtensor import QTensor
from .train import apply_updates, lbfgs, squared_error_loss, value_and_grad
from .tree import leaves


def _loss_fn(cfg: ModelConfig, params, token, state, target_onehot, kind: str):
    logits, new_state = rwkv_mod.forward(cfg, params, token, state, last_only=True)
    last = logits[0, -1]
    if kind == "squared_error":
        # the reference reads errors[actual] (rwkv.cpp:1812) but optimises
        # the whole vector's sum
        loss = squared_error_loss(last, target_onehot)
    elif kind == "cross_entropy":  # rwkv_cross_entropy_loss (rwkv.cpp:1389)
        loss = -torch.sum(torch.log_softmax(last.float(), dim=-1) * target_onehot)
    else:
        raise ValueError(kind)
    d = last - target_onehot
    return loss, torch.sum((d * d) * target_onehot), new_state


def rwkv_opt(ctx, token: int, actual: int, *, n_iter: int = 16,
             loss: str = "squared_error") -> tuple[float, float]:
    """One online-training step on (state, token) -> actual, with
    optax.lbfgs()'s defaults (a history of 10, the zoom line search).

    Writes the optimised weights into ctx's params tensors and the state
    advanced by one token with them into ctx.state, in place.  Returns
    (error_before, error_after): the squared error of the target logit, as
    state.error_before / _after (rwkv.cpp:1812-1836)."""
    cfg, params = ctx.cfg, ctx.params
    if any(isinstance(v, QTensor) for v in leaves(params)):
        raise ValueError("rwkv_opt needs dense (f32/f16) weights — "
                         "quantized levels have no gradient")
    dev = ctx.device
    tok = torch.full((1, 1), token, dtype=torch.int64, device=dev)
    target = torch.zeros(cfg.n_vocab, dtype=torch.float32, device=dev)
    target[actual] = 1.0
    loss_of = partial(_loss_fn, cfg, token=tok, state=ctx.state, target_onehot=target,
                      kind=loss)

    def value_fn(p):
        return loss_of(p)[0]

    tx = lbfgs()
    with torch.no_grad():
        _, err0, _ = loss_of(params)
    p, s = params, tx.init(params)
    for _ in range(n_iter):
        value, grads = value_and_grad(value_fn, p)
        updates, s = tx.update(grads, s, p, value=value, grad=grads, value_fn=value_fn)
        p = apply_updates(p, updates)
    with torch.no_grad():
        _, err1, new_state = loss_of(p)
        done = set()
        for view in (ctx.params, ctx._params_prefill):
            for old, new in zip(leaves(view), leaves(p)):
                if id(old) not in done:
                    old.copy_(new)
                    done.add(id(old))
        for k, t in ctx.state.items():
            t.copy_(new_state[k])
    ctx.n_past += 1
    return float(err0), float(err1)
