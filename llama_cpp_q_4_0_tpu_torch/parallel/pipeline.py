"""Pipeline parallelism: GPipe-style layer stages over a ``pp`` mesh axis.

The JAX package splits the stacked layer params (training/stacked.py) into
pp contiguous stages under ``shard_map``, sends microbatches through the
stages with ``ppermute`` and differentiates the whole schedule with one
``jax.grad``.  Here each stage is one rank of a ``make_pp_mesh`` world
holding its own L/pp layers (``shard_stages``); the embedding, the output
norm and the head are whole on every stage, as ``stage_specs`` has them.

Schedule: M microbatches over pp stages, M + pp - 1 ticks, every stage
computing every tick (the bubbles compute on what they hold, and
``torch.where`` drops it, as JAX's SPMD program does).  Stage 0 injects
microbatch i; the last stage takes the head and the loss of microbatch
i - (pp - 1); each tick but the last ends with one hop s -> s + 1
(``ppermute_ad``).  JAX's ring also sends the last stage's output to stage
0, whose ``jnp.where`` drops it: here stage 0 receives zeros from no one.

One ``torch.autograd.grad`` on every rank gives JAX's gradients, because
every rank's graph has the same shape:
  - each rank keeps what every hop delivers in its graph
    (``torch.where(stage == 0, injected, x_prev)`` on every stage) and
    computes the head and loss every tick (``torch.where(take, loss, 0)``),
    so every rank runs the backward of every hop, later ticks first; a rank
    that dropped a delivery would never run that hop's backward and its
    sender would wait forever;
  - the replicated leaves enter through one ``copy_to_many`` over pp, whose
    backward sums their cotangents over the stages (JAX's transpose of a
    replicated ``shard_map`` input): only stage 0 reaches the embedding and
    only the last stage the head, and every stage then holds the whole
    gradient.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.config import ModelConfig
from ..models.transformer import Block, TransformerParams, _embed, _mm, _norm
from ..training.stacked import layer_apply
from ..training.train import cross_entropy_loss
from ..training.tree import leaves, tree_map
from .mesh import Mesh, all_gather, axis_index, copy_to_many, ppermute_ad, reduce_from
from .shard import local_slice

_REPLICATED = ("tok_embeddings", "out_norm_w", "out_norm_b", "output")


def stage_specs(params: TransformerParams) -> TransformerParams:
    """Stacked params' specs: every block leaf's leading [L] axis over pp,
    the embedding, the norm and the head replicated (a spec per leaf, None
    where the leaf is None)."""
    (blk,) = params.blocks
    blk_specs = Block(**{f.name: None if getattr(blk, f.name) is None else ("pp",)
                         for f in dataclasses.fields(Block)})
    return TransformerParams(**{f: None if getattr(params, f) is None else ()
                                for f in _REPLICATED}, blocks=(blk_specs,))


def shard_stages(params: TransformerParams, mesh: Mesh) -> TransformerParams:
    """This stage's slices of whole stacked params: its L/pp contiguous
    layers and the replicated leaves, on the mesh's device."""
    specs = stage_specs(params)

    def put(x, spec):
        return None if x is None else local_slice(x, mesh, spec)

    (blk,), (bspec,) = params.blocks, specs.blocks
    return TransformerParams(
        **{f: put(getattr(params, f), getattr(specs, f)) for f in _REPLICATED},
        blocks=(Block(**{f.name: put(getattr(blk, f.name), getattr(bspec, f.name))
                         for f in dataclasses.fields(Block)}),))


def gather_stages(params: TransformerParams, mesh: Mesh) -> TransformerParams:
    """The inverse of shard_stages (of params or of their gradients): the
    stacked layers of every stage, in order, on every rank."""
    (blk,) = params.blocks
    with torch.no_grad():
        whole = tree_map(lambda x: all_gather(x, mesh, "pp", dim=0), blk)
    return dataclasses.replace(params, blocks=(whole,))


def pp_loss(cfg: ModelConfig, params: TransformerParams, tokens: torch.Tensor,
            targets: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Mean LM loss across microbatches, computed through the pipeline, the
    same on every stage.  params: this stage's slices of stacked params
    (``shard_stages``); tokens, targets: [M, mb, T], whole on every rank;
    mesh: a ``make_pp_mesh``.  Every rank of the mesh calls it (and its
    backward)."""
    pp = mesh.shape["pp"]
    m, mb, t = tokens.shape
    dev = mesh.device
    stage = axis_index(mesh, "pp")
    tokens, targets = tokens.to(dev), targets.to(dev)
    (blk_stage,) = params.blocks
    n_local = leaves(blk_stage)[0].shape[0]
    if n_local * pp != cfg.n_layer:
        raise ValueError(f"a stage holds {n_local} layers; {cfg.n_layer} layers over pp={pp} "
                         "give each stage its L/pp (shard_stages)")
    names = [f for f in _REPLICATED if getattr(params, f) is not None]
    rep = dict(zip(names, copy_to_many([getattr(params, f) for f in names], mesh, "pp")))
    params = dataclasses.replace(params, **rep)
    blocks = [tree_map(lambda w, j=j: w[j], blk_stage) for j in range(n_local)]
    first = torch.full((), stage == 0, dtype=torch.bool, device=dev)
    perm = [(s, s + 1) for s in range(pp - 1)]
    zero = torch.zeros((), device=dev)
    x_prev = torch.zeros((mb, t, cfg.n_embd), dtype=torch.float32, device=dev)
    loss_sum = torch.zeros((), device=dev)
    for i in range(m + pp - 1):
        x = torch.where(first, _embed(params, tokens[min(i, m - 1)]), x_prev)
        for blk in blocks:
            x = layer_apply(cfg, blk, x)
        out = i - (pp - 1)
        h = _norm(cfg, x, params.out_norm_w, params.out_norm_b)
        loss = cross_entropy_loss(_mm(h, params.output, cfg), targets[min(max(out, 0), m - 1)])
        take = stage == pp - 1 and 0 <= out < m
        loss_sum = loss_sum + torch.where(torch.full((), take, device=dev), loss, zero)
        if i < m + pp - 2:
            x_prev = ppermute_ad(x, mesh, "pp", perm)
    # only the last stage takes a loss, M of them: the sum over the stages
    return reduce_from(loss_sum, mesh, "pp") / m
