"""Speculative decoding from the PyTorch port's library API, the twin of
examples/speculative.py.

Loads a ggjt model and greedy-decodes with on-device speculative decoding
(runtime/device_spec.py): n-gram prompt-lookup drafting, one T=k+1 verify
forward per round, the rounds of a chunk replayed as one captured CUDA graph
on the card.  The output is token for token plain greedy decoding's.  Runs
on the card (cuda) unless --device cpu is given.

    python examples/speculative_torch.py <model.bin> "The quick brown fox" [k] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from llama_cpp_q_4_0_tpu_torch.formats.ggjt import detect_arch, read_ggjt  # noqa: E402
from llama_cpp_q_4_0_tpu_torch.models.loading import (config_from_ggjt,  # noqa: E402
                                                      load_transformer)
from llama_cpp_q_4_0_tpu_torch.runtime.context import Context  # noqa: E402
from llama_cpp_q_4_0_tpu_torch.runtime.device_sample import DeviceSampling  # noqa: E402
from llama_cpp_q_4_0_tpu_torch.runtime.device_spec import generate_ondevice_spec  # noqa: E402
from llama_cpp_q_4_0_tpu_torch.runtime.speculative import SpecParams, SpecStats  # noqa: E402
from llama_cpp_q_4_0_tpu_torch.runtime.tokenizer import Tokenizer, Vocab  # noqa: E402


def main(model_path: str, prompt: str, n_draft: int = 7, n_predict: int = 128,
         device: str = "cuda") -> int:
    gf = read_ggjt(model_path, detect_arch(model_path))
    cfg = config_from_ggjt(gf, n_ctx=512)
    tokenizer = Tokenizer(Vocab.from_ggjt(gf))
    ctx = Context(cfg, load_transformer(gf, cfg, device=device), n_ctx=512, device=device)

    tokens = tokenizer.tokenize(prompt, bos=True)
    stats = SpecStats()
    out = generate_ondevice_spec(
        ctx, tokens, n_predict,
        sampling=DeviceSampling(temp=-1.0),  # greedy: exact
        spec=SpecParams(n_draft=n_draft), stats=stats,
    )
    print(prompt + tokenizer.detokenize(out).decode("utf-8", errors="replace"))
    print(f"\n{stats.tokens_per_step:.2f} tokens/verify-step, "
          f"{100 * stats.acceptance:.0f}% drafts accepted", file=sys.stderr)
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("model")
    ap.add_argument("prompt")
    ap.add_argument("n_draft", nargs="?", type=int, default=7)
    ap.add_argument("-n", "--n-predict", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    raise SystemExit(main(a.model, a.prompt, a.n_draft, a.n_predict, a.device))
