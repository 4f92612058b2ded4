"""`python -m llama_cpp_q_4_0_tpu_torch main --device cpu` against the JAX
package's `main` on the same fixture, greedy."""

import os
import re
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


def _port_tool(tool, args, stdin=b""):
    return subprocess.run(
        [sys.executable, "-m", "llama_cpp_q_4_0_tpu_torch", tool, *args],
        input=stdin, capture_output=True, cwd=ROOT, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})


def _port_main(args, stdin=b""):
    return _port_tool("main", args, stdin)


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


# ------------------------------------------- main's flags, sessions, tools

def _jax_main(args, capsysbinary, monkeypatch, stdin=""):
    import io

    import llama_cpp_q_4_0_tpu.cli.main as jax_main

    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    assert jax_main.main(args) == 0
    return capsysbinary.readouterr()


@pytest.fixture(scope="module")
def prompt_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("cli_prompt") / "prompt.txt"
    p.write_text("the quick brown fox jumps over")
    return str(p)


MAIN_FLAGS = {
    # a prompt file
    "file": ["-n", "6"],
    # n_ctx 32: the context swap keeps 4 tokens and refeeds half the rest,
    # several times over 60 tokens
    "n_keep_swap": ["-p", "hello world", "--n-keep", "4", "-c", "32", "-n", "60",
                    "--ignore-eos"],
    "n_keep_swap_f32": ["-p", "hello world", "--n-keep", "-1", "-c", "32", "-n", "60",
                        "--ignore-eos", "--memory-f32"],
    "verbose_prompt": ["-p", "hello", "-n", "4", "--verbose-prompt", "-b", "8", "-t", "4"],
}


@pytest.mark.parametrize("name", list(MAIN_FLAGS))
def test_main_flags_print_the_jax_text(model_path, prompt_file, name, capsysbinary,
                                       monkeypatch):
    """`main -f`, `--n-keep` with forced context swaps and the accepted
    reference flags: the port prints JAX's text (greedy, the fixture outside
    the kernels' gate: both packages take the plain product)."""
    args = ["-m", model_path, "-s", "1", "--temp", "0", *MAIN_FLAGS[name]]
    if "-c" not in args:
        args += ["-c", "64"]
    if name == "file":
        args += ["-f", prompt_file]
    want = _jax_main(args, capsysbinary, monkeypatch)
    r = _port_main([*args, "--device", "cpu"])
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout == want.out
    if name == "verbose_prompt":
        assert [l for l in r.stderr.decode().splitlines() if "->" in l] == \
            [l for l in want.err.decode().splitlines() if "->" in l]


def test_main_reverse_prompt_stops(model_path, capsysbinary, monkeypatch):
    """-r: generation stops at the antiprompt, as JAX's does (the antiprompt
    is a piece of the text the fixture generates without it)."""
    base = ["-m", model_path, "-s", "1", "--temp", "0", "-c", "64", "-p", "hello",
            "--ignore-eos"]
    full = _jax_main([*base, "-n", "16"], capsysbinary, monkeypatch).out
    from llama_cpp_q_4_0_tpu.formats.ggjt import read_ggjt as jax_read_ggjt
    from llama_cpp_q_4_0_tpu.runtime.tokenizer import Tokenizer, Vocab

    tok = Tokenizer(Vocab.from_ggjt(jax_read_ggjt(model_path)))
    # generated pieces that tokenize back to one token
    pieces = [p for p in re.findall(rb" tok\d+|<0x[0-9A-F]{2}>|[!-~]", full[len(b"hello"):])
              if len(tok.tokenize(p)) == 1]
    stop = pieces[1].decode()
    args = [*base, "-n", "16", "-r", stop]
    want = _jax_main(args, capsysbinary, monkeypatch).out
    r = _port_main([*args, "--device", "cpu"])
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout == want and want.endswith(stop.encode()) and len(want) < len(full)


@pytest.mark.parametrize("flags,stdin", [
    (["-p", "hello", "-i", "--in-prefix", "U: ", "--in-suffix", " A:"], "tell me more\n"),
    (["-p", "hello", "--interactive-first"], "a\\\nb\n\nlast line\n"),
    (["-p", "hello", "-i", "--multiline-input"], "one\ntwo/\n"),
    (["-p", "say hi", "-ins", "-c", "128"], "tell me more\n"),
    (["-p", "hi", "--oasst", "-c", "128"], "and then\n"),
], ids=["interactive", "interactive_first", "multiline", "instruct", "oasst"])
def test_main_interactive_prints_the_jax_text(model_path, flags, stdin, capsysbinary,
                                              monkeypatch):
    """-i, --interactive-first, --multiline-input, -ins and --oasst with the
    lines on stdin: the port prints JAX's text, each turn's tokens and the
    prompts, until EOF."""
    args = ["-m", model_path, "-s", "1", "--temp", "0", "-n", "4", *flags]
    if "-c" not in args:
        args += ["-c", "64"]
    want = _jax_main(args, capsysbinary, monkeypatch, stdin=stdin).out
    r = _port_main([*args, "--device", "cpu"], stdin=stdin.encode())
    assert r.returncode == 0, r.stderr.decode()
    assert r.stdout == want and want.count(b"\n> ") >= 2


@pytest.mark.parametrize("suffix", [".bin", ".ggsn"])
def test_main_prompt_cache_reuses_the_session(model_path, tmp_path, suffix, capsysbinary,
                                              monkeypatch):
    """--prompt-cache twice: the second run of each package prints `session:
    reused`, the same count and the same text as JAX's; the port's session
    file loads in the JAX main and the JAX one in the port's."""
    outs = {}
    for who in ("jax", "port"):
        path = str(tmp_path / f"{who}{suffix}")
        args = ["-m", model_path, "-s", "1", "--temp", "0", "-c", "64", "-n", "4",
                "-p", "hello there", "--prompt-cache", path]
        for i in range(2):
            if who == "jax":
                r = _jax_main(args, capsysbinary, monkeypatch)
                out, err = r.out, r.err.decode()
            else:
                r = _port_main([*args, "--device", "cpu"])
                assert r.returncode == 0, r.stderr.decode()
                out, err = r.stdout, r.stderr.decode()
            reused = [l for l in err.splitlines() if l.startswith("session: reused")]
            assert bool(reused) == (i == 1)
            outs[who, i] = out, reused
    assert outs["jax", 0] == outs["port", 0] and outs["jax", 1] == outs["port", 1]
    # each package's file in the other's main
    for who, other in (("jax", "port"), ("port", "jax")):
        args = ["-m", model_path, "-s", "1", "--temp", "0", "-c", "64", "-n", "4",
                "-p", "hello there", "--prompt-cache", str(tmp_path / f"{other}{suffix}")]
        if who == "jax":
            err = _jax_main(args, capsysbinary, monkeypatch).err.decode()
        else:
            r = _port_main([*args, "--device", "cpu"])
            assert r.returncode == 0, r.stderr.decode()
            err = r.stderr.decode()
        assert outs["jax", 1][1][0] in err


@pytest.fixture
def f32_compute(monkeypatch):
    """Both packages' CLIs load the model in compute_dtype float32 (the CLI
    has no flag for it): f32 arithmetic on both sides, so that the printed
    4-decimal perplexity is the same."""
    import dataclasses

    from llama_cpp_q_4_0_tpu.cli import common as jax_common
    from llama_cpp_q_4_0_tpu_torch.cli import common

    for mod in (jax_common, common):
        orig = mod.config_from_ggjt
        monkeypatch.setattr(mod, "config_from_ggjt", lambda gf, _o=orig, **kw: dataclasses.replace(
            _o(gf, **kw), compute_dtype="float32"))


@pytest.mark.parametrize("extra", [[], ["-b", "16"], ["--on-device"]],
                         ids=["one_piece", "two_pieces", "on_device"])
def test_perplexity_prints_the_jax_line(model_path, extra, f32_compute, capsysbinary):
    """`perplexity -f` on a text file of the repository, -c 32, an f32
    cache: the same `Final estimate` line as JAX's tool."""
    from llama_cpp_q_4_0_tpu.cli import perplexity as jax_ppl
    from llama_cpp_q_4_0_tpu_torch.cli import perplexity as port_ppl

    text = os.path.join(ROOT, "llama_cpp_q_4_0_tpu", "cli", "console.py")
    args = ["-m", model_path, "-c", "32", "-f", text, "--memory-f32", *extra]
    assert jax_ppl.main(args) == 0
    want = capsysbinary.readouterr().out
    assert port_ppl.main([*args, "--device", "cpu"]) == 0
    got = capsysbinary.readouterr()
    assert got.out == want and got.out.startswith(b"Final estimate: PPL = ")
    assert b"[1]" in got.err


@pytest.mark.parametrize("cache", ["bf16", "q8", "f8"])
def test_save_load_state_returns_0(model_path, cache, capsysbinary):
    """`save-load-state`: the run after restoring the snapshot into a fresh
    context equals the first, on each cache type; with the default cache
    the text equals JAX's tool's."""
    from llama_cpp_q_4_0_tpu.cli import save_load_state as jax_sls

    args = ["-m", model_path, "-c", "64", "-n", "8"]
    r = _port_tool("save-load-state", [*args, "--cache-type", cache, "--device", "cpu"])
    assert r.returncode == 0, r.stderr.decode()
    assert b"state round-trip OK" in r.stdout
    if cache == "bf16":
        assert jax_sls.main(args) == 0
        assert r.stdout == capsysbinary.readouterr().out


def test_model_flags_parse_as_jax():
    """add_model_args takes JAX's -b, --memory-f32, -t and --cache-type f8;
    an unset --cache-type means f32 under --memory-f32, else bf16."""
    import argparse

    import torch

    from llama_cpp_q_4_0_tpu_torch.cli import common

    p = argparse.ArgumentParser()
    common.add_model_args(p)
    a = p.parse_args(["-m", "x", "-b", "64", "-t", "8", "--memory-f32"])
    assert (a.n_batch, a.threads, a.cache_type) == (64, 8, None)
    assert common.cache_dtype(a) == torch.float32
    assert common.cache_dtype(p.parse_args(["-m", "x"])) == torch.bfloat16
    a = p.parse_args(["-m", "x", "--cache-type", "f8", "--memory-f32"])
    assert common.cache_dtype(a) == torch.float8_e4m3fn


def test_tools_are_registered():
    from llama_cpp_q_4_0_tpu_torch.cli import TOOLS

    assert {"main", "perplexity", "save-load-state", "embedding",
            "benchmark-matmult"} <= set(TOOLS)
