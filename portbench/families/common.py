"""What every family hands the program: the raw tensors as a GGJT file in
memory for the program's own loader, and the serving objects built as the
program's ``server --parallel`` and ``main`` build them."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# a configuration's ``cache_type``, by the server's ``--cache-type`` names:
# the KV cache's dtype, and (bytes a value, an f32 scale a head and position)
CACHE_DTYPES = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32,
                "f8": torch.float8_e4m3fn, "q8": torch.int8}
CACHE_BYTES = {"bf16": (2, False), "f16": (2, False), "f32": (4, False), "f8": (1, False),
               "q8": (1, True)}


@dataclass
class _Entry:
    qtype: object  # the program's GGMLType
    shape: tuple


class MemGGJT:
    """The raw tensors in the reading surface of the program's GGJTFile:
    ``tensors`` (qtype, shape), ``tensor_bytes``, ``tensor_blocks``,
    ``tensor_f32``.  The loader reads it as it reads a file on disk."""

    def __init__(self, arch: str, hparams: dict, raw: dict):
        from llama_cpp_q_4_0_tpu_torch.quant.types import GGMLType

        self.arch, self.hparams, self.qk_k = arch, hparams, 256
        self.path = "<memory>"
        self._raw = raw
        kinds = {"q4_0": GGMLType.Q4_0, "f32": GGMLType.F32}
        self.tensors = {name: _Entry(kinds[t.qtype], t.shape) for name, t in raw.items()}

    def tensor_bytes(self, name: str) -> np.ndarray:
        return self._raw[name].data.view(np.uint8)

    def tensor_blocks(self, name: str) -> np.ndarray:
        from llama_cpp_q_4_0_tpu_torch.quant.types import BLOCK_Q4_0

        return self.tensor_bytes(name).view(BLOCK_Q4_0)

    def tensor_f32(self, name: str) -> np.ndarray:
        t = self._raw[name]
        if t.qtype != "f32":
            raise ValueError(f"{name} is {t.qtype}")
        return t.data.reshape(t.shape)


def cache_dtype(conf):
    """The torch dtype of the configuration's ``cache_type``."""
    return CACHE_DTYPES[conf["cache_type"]]


def sampling_params(s: dict):
    """The program's SamplingParams of a request's sampling dict."""
    from llama_cpp_q_4_0_tpu_torch.runtime.sampling import SamplingParams

    return SamplingParams(**s)


def request(prompt, n_predict, sampling: dict, seed: int, out):
    """The program's Request, its tokens delivered into out (a queue)."""
    from llama_cpp_q_4_0_tpu_torch.runtime.batch_engine import Request

    return Request(prompt_tokens=list(prompt), n_predict=n_predict,
                   sampling=sampling_params(sampling), seed=seed, out=out)


def generate(ctx, prompt, n_predict, sampling: dict, seed: int):
    """main's path: runtime.generate.generate over a Context, one token at a
    time, from a fresh context."""
    from llama_cpp_q_4_0_tpu_torch.runtime.generate import GenerateParams
    from llama_cpp_q_4_0_tpu_torch.runtime.generate import generate as gen

    ctx.reset()
    gp = GenerateParams(n_predict=n_predict, sampling=sampling_params(sampling), seed=seed)
    return gen(ctx, list(prompt), gp)
