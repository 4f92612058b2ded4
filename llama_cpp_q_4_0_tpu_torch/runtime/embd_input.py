"""embd-input: drive generation from raw embeddings (examples/embd-input).

The reference ships libembdinput.so (embd-input-lib.cpp: eval_tokens /
eval_float / sampling over a context primed with external embeddings) and
Python multimodal front ends (llava.py, minigpt4.py, panda_gpt.py).  As in
the JAX package, the same surface is Python over ``Context.eval_embd`` (on
the card one replayed graph per T); the vision encoders are supplied by the
caller (runtime/mm_adapters.py), and ``LinearProjector`` is the LLaVA-style
mm_projector matmul."""

from __future__ import annotations

import numpy as np

from .context import Context
from .sampling import Sampler, SamplingParams


class LinearProjector:
    """An nn.Linear projector: vision features [T, D_vis] -> [T, n_embd]
    (llava.py:17-25 applies ``mm_projector`` weights from the checkpoint)."""

    def __init__(self, weight: np.ndarray, bias: np.ndarray | None = None):
        self.weight = np.asarray(weight, np.float32)  # [n_embd, D_vis]
        self.bias = None if bias is None else np.asarray(bias, np.float32)

    def __call__(self, feats: np.ndarray) -> np.ndarray:
        out = np.asarray(feats, np.float32) @ self.weight.T
        if self.bias is not None:
            out = out + self.bias
        return out


class EmbdInput:
    """MyModel of embd_input.py: interleave token prompts and raw embedding
    spans, then sample (embd-input-lib.cpp eval_tokens / eval_float /
    sampling)."""

    def __init__(self, ctx: Context, tokenizer, sampling: SamplingParams | None = None,
                 seed: int = -1):
        self.ctx = ctx
        self.tokenizer = tokenizer
        self.sampling = sampling or SamplingParams()
        self.seed = seed
        self._last_tokens: list[int] = []

    def eval_tokens(self, tokens: list[int]) -> None:
        self.ctx.eval(np.asarray([tokens], np.int64))
        self._last_tokens += tokens

    def eval_text(self, text: str, bos: bool = False) -> None:
        self.eval_tokens(self.tokenizer.tokenize(text, bos=bos))

    def eval_token(self, token: int) -> None:
        """One special token (embd_input.py:34 eval_id; the adapters' image
        markers)."""
        self.eval_tokens([int(token)])

    def eval_float(self, embeddings: np.ndarray) -> None:
        """embeddings: [T, n_embd] (or [1, T, n_embd]) raw input vectors."""
        emb = np.asarray(embeddings, np.float32)
        if emb.ndim == 2:
            emb = emb[None]
        self.ctx.eval_embd(emb)

    def generate(self, n_predict: int = 128, *, eos_token: int = 2):
        """The continuation of the primed context on the host sampler; yields
        ids (embd-input-lib.cpp's sampling loop)."""
        sampler = Sampler(self.sampling, self.ctx.cfg.n_vocab, self.seed)
        logits = self.ctx.logits
        if logits is None:
            raise RuntimeError("prime the context first (eval_*)")
        for _ in range(n_predict):
            tok = sampler.sample(logits[0, -1], self._last_tokens)
            if tok == eos_token:
                break
            self._last_tokens.append(tok)
            yield tok
            if self.ctx.n_past + 1 > self.ctx.n_ctx:
                break
            logits = self.ctx.eval(np.asarray([[tok]], np.int64))

    def generate_text(self, n_predict: int = 128, end: str | None = None) -> str:
        """Decode to text, stopping once the output ends with ``end``
        (embd_input.py:42-49; the MiniGPT-4 and PandaGPT adapters stop on
        "###")."""
        out = b""
        end_b = end.encode() if end else None
        for tok in self.generate(n_predict):
            out += self.tokenizer.detokenize([tok])
            if end_b and out.endswith(end_b):
                break
        return out.decode("utf-8", errors="replace")
