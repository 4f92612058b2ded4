"""Import hygiene of the port, checked in a fresh interpreter (the test
process itself has imported jax through conftest)."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, json, pkgutil, sys
import llama_cpp_q_4_0_tpu_torch as port

mods = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "optax" or m.startswith("optax.")
                or m == "ml_dtypes" or m.startswith("ml_dtypes.")
                or m == "llama_cpp_q_4_0_tpu"
                or m.startswith("llama_cpp_q_4_0_tpu."))

import torch
from llama_cpp_q_4_0_tpu_torch.models.config import ModelConfig
from llama_cpp_q_4_0_tpu_torch.runtime.context import Context, RwkvContext
from llama_cpp_q_4_0_tpu_torch.runtime.rwkv_engine import RwkvBatchEngine
from llama_cpp_q_4_0_tpu_torch.synth import build_llama, build_rwkv
from llama_cpp_q_4_0_tpu_torch.cli import train as train_cli

raised = {}
cfg = ModelConfig.llama(n_vocab=64, n_embd=64, n_head=4, n_layer=1, n_rot=16)
rcfg = ModelConfig.rwkv(n_vocab=64, n_embd=64, n_layer=1)
for name, fn in (("Context", lambda: Context(cfg, None)),
                 ("build_llama", lambda: build_llama(n_layer=1, n_embd=64,
                                                     n_head=4, n_ff=128,
                                                     n_vocab=64)),
                 ("RwkvContext", lambda: RwkvContext(rcfg, None)),
                 ("RwkvBatchEngine", lambda: RwkvBatchEngine(rcfg, None, n_slots=1)),
                 ("build_rwkv", lambda: build_rwkv(n_layer=1, n_embd=64, n_vocab=64)),
                 ("load", lambda: port.load(sys.argv[1])),
                 ("train", lambda: train_cli.main(["--vocab-model", sys.argv[1],
                                                   "--train-data", sys.argv[1]]))):
    try:
        fn()
        raised[name] = None
    except RuntimeError as e:
        raised[name] = str(e)
print(json.dumps({"mods": mods, "leaked": leaked, "raised": raised,
                  "cuda": torch.cuda.is_available()}))
"""


def _probe(tmp_path):
    # an RWKV file for load(), written by the port's generator
    from llama_cpp_q_4_0_tpu_torch.formats.fixtures import make_rwkv_ggjt

    path = str(tmp_path / "rwkv.ggjt")
    make_rwkv_ggjt(path, n_vocab=64, n_layer=1)
    r = subprocess.run([sys.executable, "-c", PROBE, path], capture_output=True,
                       text=True, cwd=ROOT, timeout=300,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax_and_no_jax_package(tmp_path):
    """Every module of the port, kernel modules included, imports without
    jax, optax, ml_dtypes, the JAX package, nvcc or a card."""
    out = _probe(tmp_path)
    assert out["leaked"] == []
    for m in ("ops.qmm", "ops.flash_prefill", "ops.mha_decode", "ops.stream",
              "kernels.build", "runtime.context", "runtime.device_sample", "cli.main",
              "cli.benchmark", "runtime.session", "runtime.perplexity", "formats.ggsn",
              "cli.console", "cli.perplexity", "cli.save_load_state",
              "quant.registry", "convert", "synth", "runtime.speculative",
              "runtime.device_spec", "runtime.embd_input", "runtime.mm_adapters",
              "ops.lowrank", "models.lora", "formats.ggla", "cli.convert_lora",
              "runtime.batch_engine", "cli.server", "models.rwkv", "runtime.rwkv_engine",
              "quant.kquants64", "formats.quantize", "formats.update", "cli.quantize",
              "cli.quantize_stats", "cli.update", "cli.verify_checksums",
              "training", "training.model", "training.train", "training.checkpoint",
              "training.stacked", "training.rwkv_opt", "training.tree", "formats.export",
              "utils.memory", "cli.train", "parallel", "parallel.mesh",
              "parallel.distributed", "parallel.shard", "parallel.tp",
              "parallel.ring_attention", "parallel.pipeline", "parallel.mesh_train",
              "native", "formats.convert_hf", "cli.convert", "utils.profiling",
              "utils.compile_cache", "runtime.export", "cli.export_graph", "ops.library"):
        assert f"llama_cpp_q_4_0_tpu_torch.{m}" in out["mods"], m
    if not out["cuda"]:
        # entry points refuse to run on the CPU unless asked to
        for name, msg in out["raised"].items():
            assert msg and "CUDA is not available" in msg, name


def test_kernel_build_needs_nvcc(tmp_path, monkeypatch):
    """Without nvcc the build raises a clear error instead of falling back."""
    import shutil

    from llama_cpp_q_4_0_tpu_torch.kernels import build

    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        return  # a CUDA machine: the build is exercised by chip_smoke.py
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    try:
        build.build_all()
    except RuntimeError as e:
        assert "nvcc not found" in str(e)
    else:
        raise AssertionError("build_all did not raise without nvcc")
