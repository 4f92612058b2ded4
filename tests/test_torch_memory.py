"""The `mem estimate:` line `main` prints at load, and utils/memory.py
behind it, against the JAX package's."""

import re

import pytest

from llama_cpp_q_4_0_tpu.formats.fixtures import make_llama_ggjt, make_rwkv_ggjt
from llama_cpp_q_4_0_tpu.models.config import ModelConfig as JaxConfig
from llama_cpp_q_4_0_tpu.quant.types import GGMLType as JaxType
from llama_cpp_q_4_0_tpu.utils.memory import estimate as jax_estimate
from llama_cpp_q_4_0_tpu_torch.models.config import ModelConfig
from llama_cpp_q_4_0_tpu_torch.quant.types import FTYPE_BASE_TYPE, GGMLType
from llama_cpp_q_4_0_tpu_torch.utils.memory import estimate


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from llama_cpp_q_4_0_tpu.formats.quantize import QuantizeParams, quantize_model
    from llama_cpp_q_4_0_tpu.quant.types import LlamaFType

    d = tmp_path_factory.mktemp("mem")
    out = {"q4_0": str(d / "q4_0.ggjt"), "Q4_K_M": str(d / "q4_k_m.ggjt"),
           "rwkv": str(d / "rwkv.ggjt")}
    make_llama_ggjt(out["q4_0"], qtype=JaxType.Q4_0)
    make_llama_ggjt(str(d / "f32.ggjt"), n_embd=256, n_mult=256, n_head=2, n_vocab=512,
                    n_layer=2, qtype=JaxType.F32)
    quantize_model(str(d / "f32.ggjt"), out["Q4_K_M"],
                   QuantizeParams(ftype=LlamaFType.MOSTLY_Q4_K_M), progress=lambda *a: None)
    make_rwkv_ggjt(out["rwkv"], n_vocab=512, n_embd=32, n_layer=1)
    return out


def _mem_lines(text: str):
    return re.findall(r"^mem estimate: .*$", text, re.M)


@pytest.mark.parametrize("name", ["q4_0", "Q4_K_M", "rwkv"])
def test_main_prints_the_jax_mem_estimate(files, name, capsys):
    """The port's stderr carries JAX's `mem estimate:` line, the same text,
    for a q4_0 and a Q4_K_M file; neither package prints one for RWKV."""
    import llama_cpp_q_4_0_tpu.cli.main as jax_main

    from llama_cpp_q_4_0_tpu_torch.cli import main as main_cli

    args = ["-m", files[name], "-p", "hello", "-n", "1", "-c", "64", "--temp", "0"]
    assert jax_main.main(args) == 0
    want = _mem_lines(capsys.readouterr().err)
    assert main_cli.main(args + ["--device", "cpu"]) == 0
    got = _mem_lines(capsys.readouterr().err)
    assert got == want
    assert len(want) == (0 if name == "rwkv" else 1)


@pytest.mark.parametrize("ftype", sorted(FTYPE_BASE_TYPE, key=int), ids=lambda f: f.name)
def test_estimate_matches_jax(ftype):
    """estimate() of every file type's base type, at 7B and at a narrow
    GQA width with batch, context and cache bytes, equals JAX's."""
    base = FTYPE_BASE_TYPE[ftype]
    for kw, call in ((dict(), dict()),
                     (dict(n_vocab=512, n_embd=256, n_mult=64, n_head=8, n_layer=3,
                           n_kv_head=2), dict(n_ctx=96, batch=3, cache_bytes_per_el=1))):
        got = estimate(ModelConfig.llama(**kw), base, **call)
        want = jax_estimate(JaxConfig.llama(**kw), JaxType(int(base)), **call)
        assert got.report() == want.report()
        assert (got.weights_bytes, got.kv_bytes, got.activation_bytes, got.logits_bytes) == (
            want.weights_bytes, want.kv_bytes, want.activation_bytes, want.logits_bytes)
