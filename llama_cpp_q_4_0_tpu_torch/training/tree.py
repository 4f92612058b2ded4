"""Pytrees of the port: the params dataclasses, the optimizer states'
NamedTuples, tuples, lists and dicts, with torch tensors as leaves.

Paths are spelled as JAX's ``keystr`` spells them (``.blocks[0].wq``,
``[1][0].mu.output``, ``['k']``), and None is no leaf, as in
``jax.tree_util``, so that a checkpoint's keys are the JAX package's."""

from __future__ import annotations

import dataclasses

import torch

from ..ops.lowrank import LowRankPatched
from ..ops.qtensor import QTensor


def _children(node):
    """[(path part, child)] of an inner node; None for a leaf (a tensor, a
    QTensor or a LowRankPatched weight)."""
    if isinstance(node, (QTensor, LowRankPatched)):
        return None
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f".{f.name}", getattr(node, f.name)) for f in dataclasses.fields(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{n}", v) for n, v in zip(node._fields, node)]
    if isinstance(node, (tuple, list)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    if isinstance(node, dict):
        return [(f"[{k!r}]", v) for k, v in node.items()]
    return None


def _rebuild(node, children: list):
    if dataclasses.is_dataclass(node):
        return type(node)(**{f.name: c for f, c in zip(dataclasses.fields(node), children)})
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*children)
    if isinstance(node, (tuple, list)):
        return type(node)(children)
    return dict(zip(node.keys(), children))


def _walk(node, path: str, out: list) -> None:
    # a module-level recursion: a nested one would be a reference cycle
    # (the function and its own closure cell) holding every leaf it saw
    # until the cyclic collector runs
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        out.append((path, node))
        return
    for part, child in kids:
        _walk(child, path + part, out)


def flatten_with_path(tree, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, leaf) in JAX's leaf order, None dropped."""
    out = []
    _walk(tree, prefix, out)
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def tree_map(fn, tree, *rest):
    """fn over the leaves of tree and the matching leaves of rest; None stays
    None."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    others = [[c for _, c in _children(r)] for r in rest]
    return _rebuild(tree, [tree_map(fn, c, *(o[i] for o in others))
                           for i, (_, c) in enumerate(kids)])


def map_with_path(fn, tree, prefix: str = ""):
    """fn(path, leaf) over the leaves; None stays None."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    return _rebuild(tree, [map_with_path(fn, c, prefix + part) for part, c in kids])
