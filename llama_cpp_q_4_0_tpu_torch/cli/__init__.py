"""Application entry points, dispatched as
``python -m llama_cpp_q_4_0_tpu_torch <tool> ...``."""

from __future__ import annotations

import sys

TOOLS = {
    "main": ("generate text (examples/main)", "main"),
    "perplexity": ("wikitext perplexity gate (examples/perplexity)", "perplexity"),
    "benchmark-matmult": ("quantized vs dense matmul, vdot, HBM read stream",
                          "benchmark"),
    "embedding": ("print the final hidden state of a prompt's last token",
                  "embedding"),
    "save-load-state": ("state determinism self-test", "save_load_state"),
    "convert-lora": ("PEFT LoRA adapter dir -> ggla file", "convert_lora"),
    "server": ("HTTP completion API, --parallel N for continuous batching", "server"),
    "quantize": ("requantize a model file (examples/quantize)", "quantize"),
    "quantize-stats": ("per-layer quant error stats (examples/quantize-stats)",
                       "quantize_stats"),
    "update": ("rewrite old ggml/ggmf file as current ggjt", "update"),
    "verify-checksums": ("SHA256 model integrity check", "verify_checksums"),
    "train": ("train a model from scratch (examples/train-text-from-scratch)", "train"),
    "convert": ("convert a HF checkpoint to ggjt (convert.py)", "convert"),
    "export-graph": ("AOT export / replay decode step (llama_eval_export)",
                     "export_graph"),
}


def dispatch(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m llama_cpp_q_4_0_tpu_torch <tool> [args]\n\ntools:")
        for name, (desc, _) in TOOLS.items():
            print(f"  {name:18s} {desc}")
        return 0
    tool = argv.pop(0)
    if tool not in TOOLS:
        print(f"unknown tool '{tool}' (try --help)", file=sys.stderr)
        return 1
    import importlib

    mod = importlib.import_module(f".{TOOLS[tool][1]}", __package__)
    return mod.main(argv)
