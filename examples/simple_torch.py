"""Minimal library usage of the PyTorch port — examples/simple/simple.cpp
parity, the twin of examples/simple.py.

Load a ggjt model, evaluate a prompt, greedy-decode a few tokens, print
them.  Runs on the card (cuda) unless --device cpu is given.

    python examples/simple_torch.py <model.bin> "Hello my name is" [--device cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from llama_cpp_q_4_0_tpu_torch.formats.ggjt import detect_arch, read_ggjt  # noqa: E402
from llama_cpp_q_4_0_tpu_torch.models.loading import (config_from_ggjt,  # noqa: E402
                                                      load_transformer)
from llama_cpp_q_4_0_tpu_torch.runtime.context import Context  # noqa: E402
from llama_cpp_q_4_0_tpu_torch.runtime.tokenizer import Tokenizer, Vocab  # noqa: E402


def main(model_path: str, prompt: str, n_predict: int = 32, device: str = "cuda") -> int:
    gf = read_ggjt(model_path, detect_arch(model_path))
    cfg = config_from_ggjt(gf, n_ctx=512)
    tokenizer = Tokenizer(Vocab.from_ggjt(gf))
    ctx = Context(cfg, load_transformer(gf, cfg, device=device), n_ctx=512, device=device)

    tokens = tokenizer.tokenize(prompt, bos=True)
    print(prompt, end="", flush=True)
    logits = ctx.eval(np.asarray([tokens], np.int64))
    for _ in range(n_predict):
        tok = int(np.argmax(logits[0, -1]))
        if tok == 2:  # EOS
            break
        sys.stdout.buffer.write(tokenizer.token_text(tok))
        sys.stdout.flush()
        logits = ctx.eval(np.asarray([[tok]], np.int64))
    print()
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("model")
    ap.add_argument("prompt", nargs="?", default="Hello my name is")
    ap.add_argument("-n", "--n-predict", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    raise SystemExit(main(a.model, a.prompt, a.n_predict, a.device))
