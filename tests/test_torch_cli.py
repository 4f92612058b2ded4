"""`python -m llama_cpp_q_4_0_tpu_torch main --device cpu` against the JAX
package's `main` on the same fixture, greedy."""

import os
import subprocess
import sys

import pytest

from llama_cpp_q_4_0_tpu.formats.fixtures import make_llama_ggjt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def model_path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("cli") / "llama.ggjt")
    make_llama_ggjt(p)
    return p


def _port_main(args):
    return subprocess.run(
        [sys.executable, "-m", "llama_cpp_q_4_0_tpu_torch", "main", *args],
        capture_output=True, cwd=ROOT, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})


@pytest.mark.parametrize("prompt", ["hello", "the quick brown fox"])
def test_main_prints_the_jax_text(model_path, prompt, capsysbinary):
    """Same stdout: the prompt, then 4 greedy tokens.  The CLI computes in
    bf16; every matmul of this fixture (n_embd 64) lies outside the kernels'
    gate, so both packages take the plain bf16 product, summed in another
    order.  On fixtures inside the gate the port's decode takes the kfold
    form, whose ~3e-2 logit drift flips near-tied choices later in a
    sequence, so the comparison stops at 4 tokens, as on those."""
    import llama_cpp_q_4_0_tpu.cli.main as jax_main

    args = ["-m", model_path, "-p", prompt, "-n", "4", "-c", "64", "-s", "1",
            "--temp", "0"]
    assert jax_main.main(args) == 0
    want = capsysbinary.readouterr().out
    r = _port_main([*args, "--device", "cpu"])
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout == want
    assert r.stdout.startswith(prompt.encode()) and len(r.stdout) > len(prompt)
    assert b"eval time" in r.stderr


@pytest.mark.parametrize("extra", [
    ["--ondevice-sampling"],
    ["--repeat-penalty", "1.3", "--repeat-last-n", "8", "--frequency-penalty", "0.1",
     "--presence-penalty", "0.2", "-l", "100-inf", "-l", "7+1.5"],
], ids=["ondevice", "host_penalties_bias"])
def test_main_sampling_flags_print_the_jax_text(model_path, extra, capsysbinary):
    """Greedy (`--temp -1 --ignore-eos`, 4 tokens) with the sampling flags:
    on-device sampling in chunks, and the host chain with penalties and
    logit biases, each printing what the JAX package's `main` prints with
    the same flags on the same fixture."""
    import llama_cpp_q_4_0_tpu.cli.main as jax_main

    args = ["-m", model_path, "-p", "hello", "-n", "4", "-c", "64", "-s", "1",
            "--temp", "-1", "--ignore-eos", *extra]
    assert jax_main.main(args) == 0
    want = capsysbinary.readouterr().out
    r = _port_main([*args, "--device", "cpu"])
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout == want and len(r.stdout) > len(b"hello")


@pytest.mark.parametrize("flags", [
    [],
    ["--top-k", "5", "--top-p", "0.9", "--temp", "0.7", "--repeat-penalty", "1.2",
     "--repeat-last-n", "16", "--frequency-penalty", "0.1", "--presence-penalty", "0.3",
     "--tfs", "0.95", "--typical", "0.9", "--mirostat", "2", "--mirostat-lr", "0.2",
     "--mirostat-ent", "4", "-l", "2-inf", "-l", "15+1.5", "-l", "9-0.5", "-s", "3",
     "-n", "9"],
    ["-l", "2-Infinity", "--ignore-eos", "-l", "3+0.25"],
], ids=["defaults", "every_flag", "inf_forms"])
def test_sampling_flags_parse_as_jax(flags):
    """add_sampling_args and sampling_from_args give JAX's SamplingParams
    field for field (`-l 2-inf` bans token 2, `--ignore-eos` bans EOS)."""
    import argparse
    import dataclasses

    from llama_cpp_q_4_0_tpu.cli import common as jax_common
    from llama_cpp_q_4_0_tpu_torch.cli import common

    pj, pt = argparse.ArgumentParser(), argparse.ArgumentParser()
    jax_common.add_sampling_args(pj)
    common.add_sampling_args(pt)
    aj, at = pj.parse_args(flags), pt.parse_args(flags)
    assert vars(at) == vars(aj)
    assert (dataclasses.asdict(common.sampling_from_args(at))
            == dataclasses.asdict(jax_common.sampling_from_args(aj)))


def test_main_without_cuda_raises(model_path):
    """No silent CPU fallback: without --device cpu the CLI needs CUDA."""
    r = _port_main(["-m", model_path, "-p", "hi", "-n", "1",
                    "--device", "cuda"])
    import torch

    if torch.cuda.is_available():
        assert r.returncode == 0
    else:
        assert r.returncode != 0
        assert b"CUDA is not available" in r.stderr


@pytest.fixture(scope="module")
def q4_k_m_path(tmp_path_factory):
    """The tiny LLaMA (n_embd 256, 2 layers) quantized to MOSTLY_Q4_K_M by the
    JAX package: q4_K (packed, affine) and q6_K (int8) tensors."""
    from llama_cpp_q_4_0_tpu.formats.quantize import QuantizeParams, quantize_model
    from llama_cpp_q_4_0_tpu.quant.types import GGMLType, LlamaFType

    d = tmp_path_factory.mktemp("cli_kq")
    make_llama_ggjt(str(d / "f32.ggjt"), n_embd=256, n_mult=256, n_head=2,
                    n_vocab=512, n_layer=2, qtype=GGMLType.F32)
    p = str(d / "q4_k_m.ggjt")
    quantize_model(str(d / "f32.ggjt"), p,
                   QuantizeParams(ftype=LlamaFType.MOSTLY_Q4_K_M),
                   progress=lambda *a: None)
    return p


@pytest.mark.parametrize("prompt", ["hello", "the quick brown fox"])
def test_main_q4_k_m_prints_the_jax_text(q4_k_m_path, prompt, capsysbinary):
    """A k-quant file through `main --device cpu`: the load line names its
    ftype, and the text equals the JAX package's `main` for 4 greedy tokens
    (no kfold on this file: both run the same bf16 arithmetic)."""
    import llama_cpp_q_4_0_tpu.cli.main as jax_main

    args = ["-m", q4_k_m_path, "-p", prompt, "-n", "4", "-c", "64", "-s", "1",
            "--temp", "0"]
    assert jax_main.main(args) == 0
    want = capsysbinary.readouterr().out
    r = _port_main([*args, "--device", "cpu"])
    assert r.returncode == 0, r.stderr.decode()
    assert b"ftype=MOSTLY_Q4_K_M" in r.stderr
    assert r.stdout == want
    assert r.stdout.startswith(prompt.encode()) and len(r.stdout) > len(prompt)


@pytest.fixture(scope="module")
def q3_k_m_path(tmp_path_factory):
    """The tiny LLaMA quantized to MOSTLY_Q3_K_M by the JAX package: q3_K
    (packed, pack zero 4, 16-groups), q4_K and q6_K tensors."""
    from llama_cpp_q_4_0_tpu.formats.quantize import QuantizeParams, quantize_model
    from llama_cpp_q_4_0_tpu.quant.types import GGMLType, LlamaFType

    d = tmp_path_factory.mktemp("cli_q3k")
    make_llama_ggjt(str(d / "f32.ggjt"), n_embd=256, n_mult=256, n_head=2,
                    n_vocab=512, n_layer=2, qtype=GGMLType.F32)
    p = str(d / "q3_k_m.ggjt")
    quantize_model(str(d / "f32.ggjt"), p,
                   QuantizeParams(ftype=LlamaFType.MOSTLY_Q3_K_M),
                   progress=lambda *a: None)
    return p


def test_main_q3_k_m_prints_the_jax_text(q3_k_m_path, capsysbinary):
    """A Q3_K_M file through `main --device cpu`: the load line names its
    ftype, and the text equals the JAX package's `main` for 4 greedy tokens
    (the port's q3_K decode takes kfold, whose drift stays below these
    tokens' margins)."""
    import llama_cpp_q_4_0_tpu.cli.main as jax_main

    args = ["-m", q3_k_m_path, "-p", "hello", "-n", "4", "-c", "64", "-s", "1",
            "--temp", "0"]
    assert jax_main.main(args) == 0
    want = capsysbinary.readouterr().out
    r = _port_main([*args, "--device", "cpu"])
    assert r.returncode == 0, r.stderr.decode()
    assert b"ftype=MOSTLY_Q3_K_M" in r.stderr
    assert r.stdout == want
    assert r.stdout.startswith(b"hello") and len(r.stdout) > len("hello")
