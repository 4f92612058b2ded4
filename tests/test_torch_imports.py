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
                or m == "llama_cpp_q_4_0_tpu"
                or m.startswith("llama_cpp_q_4_0_tpu."))

import torch
from llama_cpp_q_4_0_tpu_torch.models.config import ModelConfig
from llama_cpp_q_4_0_tpu_torch.runtime.context import Context
from llama_cpp_q_4_0_tpu_torch.synth import build_llama

raised = {}
cfg = ModelConfig.llama(n_vocab=64, n_embd=64, n_head=4, n_layer=1, n_rot=16)
for name, fn in (("Context", lambda: Context(cfg, None)),
                 ("build_llama", lambda: build_llama(n_layer=1, n_embd=64,
                                                     n_head=4, n_ff=128,
                                                     n_vocab=64))):
    try:
        fn()
        raised[name] = None
    except RuntimeError as e:
        raised[name] = str(e)
print(json.dumps({"mods": mods, "leaked": leaked, "raised": raised,
                  "cuda": torch.cuda.is_available()}))
"""


def _probe():
    r = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                       text=True, cwd=ROOT, timeout=300,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax_and_no_jax_package():
    """Every module of the port, kernel modules included, imports without
    jax, without the JAX package and without nvcc or a card."""
    out = _probe()
    assert out["leaked"] == []
    for m in ("ops.qmm", "ops.flash_prefill", "ops.mha_decode", "ops.stream",
              "kernels.build", "runtime.context", "runtime.device_sample", "cli.main",
              "cli.benchmark", "runtime.session", "runtime.perplexity", "formats.ggsn",
              "cli.console", "cli.perplexity", "cli.save_load_state",
              "quant.registry", "convert", "synth", "runtime.speculative",
              "runtime.device_spec", "runtime.embd_input", "runtime.mm_adapters",
              "ops.lowrank", "models.lora", "formats.ggla", "cli.convert_lora",
              "runtime.batch_engine", "cli.server"):
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
