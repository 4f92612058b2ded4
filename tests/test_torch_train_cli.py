"""The port's `train` CLI against the JAX package's: the JAX CLI test's
flags (fresh, resumed, stacked with remat and resumed, the exported ggjt
generating through `main`), checkpoints written by either package resumed
by the other with the same printed losses, and the card required unless
--device cpu."""

import os
import re

import pytest
import torch

from llama_cpp_q_4_0_tpu.cli import train as jax_train
from llama_cpp_q_4_0_tpu.formats.fixtures import make_llama_ggjt
from llama_cpp_q_4_0_tpu_torch.cli import train as train_cli

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def vocab_model(tmp_path_factory):
    """tests/test_tools.py's vocab model."""
    p = str(tmp_path_factory.mktemp("tools") / "vocab.bin")
    make_llama_ggjt(p, n_vocab=300, n_embd=64, n_head=4, n_layer=1)
    return p


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("corpus") / "corpus.txt")
    with open(p, "w") as f:
        f.write("one two three four five. " * 80)
    return p


def test_train_cli_end_to_end(vocab_model, corpus, tmp_path, capsys):
    """tests/test_tools.py::test_train_cli_end_to_end's runs on the port (on
    the CPU): train and export, resume, the stacked remat trainer fresh and
    resumed, and `main` on the exported file."""
    ckpt = str(tmp_path / "ckpt.bin")
    model_out = str(tmp_path / "trained.bin")
    rc = train_cli.main([
        "--vocab-model", vocab_model, "--train-data", corpus,
        "--checkpoint-out", ckpt, "--model-out", model_out,
        "--embd", "32", "--head", "2", "--layer", "1", "--mult", "16",
        "-c", "16", "-b", "2", "-n", "2", "--predict", "2", *CPU])
    assert rc == 0
    assert os.path.exists(ckpt) and os.path.exists(model_out)
    out = capsys.readouterr()
    assert "sample:" in out.out and re.search(r"^final loss \d+\.\d{4}$", out.out, re.M)
    assert re.search(r"^iter 0: loss \d+\.\d{4} \(", out.err, re.M)
    assert "model exported to" in out.err

    rc = train_cli.main([
        "--vocab-model", vocab_model, "--train-data", corpus,
        "--checkpoint-in", ckpt, "--checkpoint-out", ckpt,
        "--embd", "32", "--head", "2", "--layer", "1", "--mult", "16",
        "-c", "16", "-b", "2", "-n", "1", "--predict", "0", *CPU])
    assert rc == 0
    assert "resumed" in capsys.readouterr().err

    ckpt2 = str(tmp_path / "ckpt_scan.bin")
    common = ["--vocab-model", vocab_model, "--train-data", corpus,
              "--embd", "32", "--head", "2", "--layer", "2", "--mult", "16",
              "-c", "16", "-b", "2", "--predict", "0", "--use-remat", *CPU]
    assert train_cli.main(common + ["--checkpoint-out", ckpt2, "-n", "2"]) == 0
    assert train_cli.main(common + ["--checkpoint-in", ckpt2,
                                    "--checkpoint-out", ckpt2, "-n", "1"]) == 0
    assert "resumed" in capsys.readouterr().err

    from llama_cpp_q_4_0_tpu_torch.cli import main as main_cli

    rc = main_cli.main(["-m", model_out, "-p", "one two", "-n", "4", "--temp", "0",
                        "-c", "32", *CPU])
    assert rc == 0
    assert "one two" in capsys.readouterr().out


def _losses(text: str):
    iters = re.findall(r"^iter (\d+): loss (\d+\.\d{4})", text, re.M)
    final = re.findall(r"^final loss (\d+\.\d{4})$", text, re.M)
    return iters, final


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("mode", ["adam", "remat"])
def test_checkpoint_resumes_across_packages(vocab_model, corpus, tmp_path, capsys, writer,
                                            mode):
    """A checkpoint of 2 steps written by one package, resumed for 3 steps
    by each (the same windows from default_rng(seed), the same params and
    Adam state): the same printed iter and final losses, each within one
    unit of its last printed digit (bf16-compute losses a few f32 ulps
    apart can round across a boundary of the fourth decimal)."""
    flags = ["--vocab-model", vocab_model, "--train-data", corpus,
             "--embd", "32", "--head", "2", "--layer", "2", "--mult", "16",
             "-c", "16", "-b", "2", "--predict", "0"]
    if mode == "remat":
        flags.append("--use-remat")
    ckpt = str(tmp_path / "w.ckpt")
    if writer == "jax":
        assert jax_train.main(flags + ["--checkpoint-out", ckpt, "-n", "2"]) == 0
    else:
        assert train_cli.main(flags + ["--checkpoint-out", ckpt, "-n", "2", *CPU]) == 0
    capsys.readouterr()
    resume = flags + ["--checkpoint-in", ckpt, "-n", "3"]
    assert jax_train.main(resume + ["--checkpoint-out", str(tmp_path / "j.ckpt")]) == 0
    jout = capsys.readouterr()
    assert train_cli.main(resume + ["--checkpoint-out", str(tmp_path / "t.ckpt"), *CPU]) == 0
    tout = capsys.readouterr()
    assert "resumed" in jout.err and "resumed" in tout.err
    j_iters, j_final = _losses(jout.err + jout.out)
    t_iters, t_final = _losses(tout.err + tout.out)
    assert len(j_final) == len(t_final) == 1
    assert abs(float(t_final[0]) - float(j_final[0])) <= 1.01e-4, (j_final, t_final)
    assert [i for i, _ in t_iters] == [i for i, _ in j_iters] == ["2", "4"]
    for (_, a), (_, b) in zip(j_iters, t_iters):
        assert abs(float(a) - float(b)) <= 1.01e-4, (j_iters, t_iters)


def test_train_needs_cuda_unless_device_cpu(vocab_model, corpus, tmp_path, capsys):
    """Without CUDA the trainer raises unless --device cpu; the tool is
    listed by the dispatcher."""
    from llama_cpp_q_4_0_tpu_torch.cli import dispatch

    assert dispatch(["--help"]) == 0
    assert re.search(r"^  train\s", capsys.readouterr().out, re.M)
    if torch.cuda.is_available():
        return  # a CUDA machine: the default is the card
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--vocab-model", vocab_model, "--train-data", corpus,
                        "--checkpoint-out", str(tmp_path / "c.bin"), "-n", "1"])
    assert not os.path.exists(str(tmp_path / "c.bin"))
