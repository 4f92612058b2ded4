"""Apply a ggla LoRA adapter to loaded params: w += (alpha/r) * BA.

llama_apply_lora_from_file_internal (llama.cpp:2716-2991), as the JAX
package's ``models/lora.py``: merged, the delta is added on the host once at
load time, and a quantized target is dequantized, patched and quantized
again to its own format (the reference warns that this costs quality; so
does this); an optional f16/f32 base model file supplies clean weights
(--lora-base).  Unmerged, the quantized base stays as it is and the delta is
applied at matmul time (ops/lowrank.py).  ``convert_peft_dir`` is
convert-lora-to-ggml.py.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import sys

import numpy as np
import torch

from ..formats.ggla import GglaFile, read_ggla, write_ggla
from ..ops.lowrank import patch
from ..ops.qtensor import QTensor
from .transformer import TransformerParams

# ggml tensor base name -> Block field (convert-lora-to-ggml.py:12-25)
_FIELD_MAP = {
    "attention.wq": "wq",
    "attention.wk": "wk",
    "attention.wv": "wv",
    "attention.wo": "wo",
    "feed_forward.w1": "w_gate",
    "feed_forward.w2": "w_down",
    "feed_forward.w3": "w_up",
    "attention_norm": "attn_norm_w",
    "ffn_norm": "ffn_norm_w",
}


def _parse_base(base_name: str) -> tuple[int, str] | None:
    """"layers.{i}.{sub}.weight" -> (i, the Block field), else None."""
    parts = base_name.split(".")
    if parts[0] != "layers" or parts[-1] != "weight":
        return None
    field = _FIELD_MAP.get(".".join(parts[2:-1]))
    return (int(parts[1]), field) if field else None


def _patched(w, delta: np.ndarray, base: np.ndarray | None):
    """w (QTensor or dense) + delta, in w's storage format and device."""
    if isinstance(w, QTensor):
        basef = base if base is not None else w.dequantize_t().T.cpu().numpy()
        return QTensor.quantize(basef.astype(np.float32) + delta, w.qtype, device=w.device)
    basef = base if base is not None else w.float().cpu().numpy()
    return torch.from_numpy(np.asarray(basef + delta, np.float32)).to(device=w.device,
                                                                       dtype=w.dtype)


def apply_lora(params: TransformerParams, adapter: str | GglaFile, *,
               base_weights: dict[str, np.ndarray] | None = None, merge: bool = True,
               progress=None) -> TransformerParams:
    """params with the adapter applied; the given params are left as they
    are (an unmerged patch holds the very base tensor, untouched).

    merge=True is the reference's w += (alpha/r) BA, quantized targets
    quantized again.  merge=False attaches the delta as a LowRankPatched
    weight: the base stays bit for bit, the adapter costs two skinny
    products a matmul.  base_weights maps ggml base names to f32 arrays of
    an unquantized base model (--lora-base).  Load the params unfused: a
    patched projection does not fuse (models/fuse.py)."""
    gf = read_ggla(adapter) if isinstance(adapter, str) else adapter
    pairs = gf.pairs()
    blocks = list(params.blocks)
    warned = False
    for i, base_name in enumerate(sorted(pairs)):
        parsed = _parse_base(base_name)
        if parsed is None:
            raise ValueError(f"unknown lora tensor '{base_name}'")
        layer, fieldname = parsed
        blk = blocks[layer]
        w = getattr(blk, fieldname)
        if w is None:
            raise ValueError(f"model has no tensor for '{base_name}'")
        a, b = pairs[base_name]
        n, k = w.shape
        if (b.shape[0], a.shape[0]) != (n, k):
            raise ValueError(f"incompatible lora dims for {base_name}: "
                             f"{(b.shape[0], a.shape[0])} vs {(n, k)}")
        if not merge:
            new_w = patch(w, a.T, b, gf.scaling)  # a is stored [K, r]
        else:
            if isinstance(w, QTensor) and not warned:
                print("apply_lora: warning: merging into quantized weights quantizes "
                      "them again, which may cost quality; use merge=False or an "
                      "f16/f32 --lora-base", file=sys.stderr)
                warned = True
            base = base_weights.get(base_name) if base_weights else None
            new_w = _patched(w, gf.delta(base_name), base)
        blocks[layer] = dataclasses.replace(blk, **{fieldname: new_w})
        if progress:
            progress(i + 1, len(pairs))
    return dataclasses.replace(params, blocks=tuple(blocks))


_HF_MAP = {
    "self_attn.q_proj": "attention.wq", "self_attn.k_proj": "attention.wk",
    "self_attn.v_proj": "attention.wv", "self_attn.o_proj": "attention.wo",
    "mlp.gate_proj": "feed_forward.w1", "mlp.down_proj": "feed_forward.w2",
    "mlp.up_proj": "feed_forward.w3",
}


def convert_peft_dir(peft_dir: str, out_path: str) -> None:
    """A PEFT adapter directory (adapter_config.json, adapter_model.bin) ->
    a ggla file (convert-lora-to-ggml.py)."""
    with open(os.path.join(peft_dir, "adapter_config.json")) as f:
        cfgj = json.load(f)
    if cfgj["peft_type"] != "LORA":
        raise ValueError(f"peft_type {cfgj['peft_type']} is not LORA")
    if cfgj.get("fan_in_fan_out"):
        raise ValueError("fan_in_fan_out adapters are not supported")
    model = torch.load(os.path.join(peft_dir, "adapter_model.bin"), map_location="cpu",
                       weights_only=True)
    tensors = {}
    for name, v in model.items():
        name = name.replace(".default.weight", ".weight")
        m = re.match(r".*layers\.(\d+)\.(\w+\.\w+)\.lora_(A|B)\.weight", name)
        if not m:
            continue
        t = v.float().numpy()
        if m.group(3) == "A":
            t = t.T
        tensors[f"layers.{m.group(1)}.{_HF_MAP[m.group(2)]}.weight.lora{m.group(3)}"] = t
    write_ggla(out_path, int(cfgj["r"]), int(cfgj["lora_alpha"]), tensors)
