"""Parameters handed over as numpy arrays -> the port's TransformerParams.

The tests use this to give the JAX package and the port the same weights: the
test extracts each JAX leaf into plain numpy (this module imports nothing of
the JAX package).  The structure mirrors TransformerParams:

  {"tok_embeddings": leaf, "blocks": [{field: leaf, ...}, ...],
   "out_norm_w": leaf, "out_norm_b": leaf, "output": leaf}

where a leaf is None, a numpy array (a dense weight, a norm or a bias of
the gptneox, falcon and bonsai blocks' fields), or a dict describing a
QTensor in either form: {"levels_t", "gscale_t", "gbias_t", "gsize",
"qtype", "shape", "pack_zero"} with the arrays as numpy (``gbias_t`` None for
a symmetric format, ``pack_zero`` None for unpacked int8 levels).  float16
planes (the JAX params after ``cast_scales_f16``) stay float16; any other
plane becomes float32.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .models.transformer import Block, TransformerParams
from .ops.qtensor import QTensor
from .quant.types import GGMLType


def _leaf(v, device: torch.device):
    if v is None:
        return None
    if isinstance(v, dict):
        pz = v.get("pack_zero")
        gb = v.get("gbias_t")

        def put(a, dt):
            return torch.from_numpy(np.array(a, dt)).to(device)

        def plane(a):
            return put(a, np.float16 if np.asarray(a).dtype == np.float16 else np.float32)

        return QTensor(
            levels_t=put(v["levels_t"], np.int8 if pz is None else np.uint8),
            gscale_t=plane(v["gscale_t"]),
            gbias_t=None if gb is None else plane(gb),
            gsize=int(v["gsize"]), qtype=GGMLType(int(v["qtype"])),
            shape=tuple(int(s) for s in v["shape"]),
            pack_zero=None if pz is None else int(pz))
    arr = np.asarray(v)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        # ml_dtypes bfloat16 has no torch counterpart in from_numpy
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


def params_from_numpy(tree: dict, device=None) -> TransformerParams:
    dev = resolve_device(device)
    return TransformerParams(
        tok_embeddings=_leaf(tree["tok_embeddings"], dev),
        # None fields (a family's missing biases and norms) keep Block's
        # default; a field Block lacks raises
        blocks=tuple(Block(**{k: _leaf(v, dev) for k, v in blk.items()
                              if v is not None})
                     for blk in tree["blocks"]),
        out_norm_w=_leaf(tree["out_norm_w"], dev),
        out_norm_b=_leaf(tree.get("out_norm_b"), dev),
        output=_leaf(tree["output"], dev))
