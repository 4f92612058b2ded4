"""The port is complete: its CLI has every tool of the JAX package's, and
every module of the JAX package has a module at the same path in the port,
apart from ``ops/pallas/*``, whose kernels are the port's ``csrc/*.cu``
(each with its wrapper in ``ops/`` and its custom op in ``ops/library.py``)."""

import os

import llama_cpp_q_4_0_tpu
import llama_cpp_q_4_0_tpu_torch
from llama_cpp_q_4_0_tpu.cli import TOOLS as JAX_TOOLS
from llama_cpp_q_4_0_tpu_torch.cli import TOOLS


def _modules(pkg) -> set[str]:
    root = os.path.dirname(pkg.__file__)
    out = set()
    for d, _, files in os.walk(root):
        rel = os.path.relpath(d, root)
        if "__pycache__" in rel or rel.split(os.sep)[0] == "build":
            continue
        for f in files:
            if f.endswith((".py", ".cpp")):
                out.add(os.path.normpath(os.path.join(rel, f)))
    return out


def test_cli_tools_equal_jax():
    assert set(TOOLS) == set(JAX_TOOLS)
    for name, (desc, mod) in JAX_TOOLS.items():
        assert TOOLS[name][1] == mod, name


def test_every_jax_module_has_a_port_module():
    jax_mods = {m for m in _modules(llama_cpp_q_4_0_tpu)
                if not m.startswith(os.path.join("ops", "pallas") + os.sep)}
    missing = sorted(jax_mods - _modules(llama_cpp_q_4_0_tpu_torch))
    assert missing == []


def test_every_pallas_kernel_has_a_cuda_source():
    """ops/pallas holds the JAX package's Pallas kernels (qmm.py: K1, K2, K5,
    K6, K6b, K7; attention.py: K4); the port's csrc/ holds their CUDA
    sources and K3's (the bundled TPU flash kernel) and K8's."""
    pallas = {m for m in _modules(llama_cpp_q_4_0_tpu) if m.startswith("ops/pallas/")}
    assert {"ops/pallas/qmm.py", "ops/pallas/attention.py"} <= pallas
    csrc = set(os.listdir(os.path.join(os.path.dirname(llama_cpp_q_4_0_tpu_torch.__file__),
                                       "csrc")))
    assert {"qmm_q4_0.cu", "qmm_int8.cu", "qmm_q8x.cu", "mha_decode.cu", "flash_prefill.cu",
            "stream.cu"} <= csrc
