"""PyTorch and CUDA port of llama_cpp_q_4_0_tpu for one NVIDIA H100.

The entry points (``load``, ``runtime.context.Context`` and ``RwkvContext``,
``models.loading.load_transformer`` and ``load_rwkv``, the ``main`` CLI) run
on ``cuda`` by default and raise when CUDA is absent, unless the caller asks
for the CPU (``device="cpu"``, CLI ``--device cpu``), where every kernel
wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

import torch

# f32 means f32: products of the compute_dtype="float32" parity path and of the
# plain kernel versions must not drop to TF32 on the card
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: cuda unless the caller names one.
    Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' "
                           "(CLI: --device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def load(model_path: str, *, n_ctx: int = 2048, arch: str | None = None, cache_dtype=None,
         device=None):
    """One-call bring-up: (context, tokenizer) of a GGJT file, an
    RwkvContext for an RWKV file and a Context (cache_dtype, default bf16)
    for the others, on cuda unless device names the CPU.

    >>> ctx, tok = llama_cpp_q_4_0_tpu_torch.load("7b-q4_0.bin")
    >>> logits = ctx.eval([tok.tokenize("Hello", bos=True)])
    """
    from .formats.ggjt import detect_arch, read_ggjt
    from .models.loading import config_from_ggjt, load_rwkv, load_transformer
    from .runtime.context import Context, RwkvContext
    from .runtime.tokenizer import Tokenizer, Vocab

    dev = resolve_device(device)
    arch = arch or detect_arch(model_path)
    gf = read_ggjt(model_path, arch)
    cfg = config_from_ggjt(gf, n_ctx=n_ctx)
    tokenizer = Tokenizer(Vocab.from_ggjt(gf))
    if arch == "rwkv":
        return RwkvContext(cfg, load_rwkv(gf, cfg, device=dev), device=dev), tokenizer
    ctx = Context(cfg, load_transformer(gf, cfg, device=dev), n_ctx=n_ctx,
                  cache_dtype=cache_dtype or torch.bfloat16, device=dev)
    return ctx, tokenizer
