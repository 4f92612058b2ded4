"""The port's examples (examples/simple_torch.py, examples/speculative_torch.py)
with --device cpu on a fixture file, held to their JAX twins
(examples/simple.py, examples/speculative.py) run on the same file and
prompt: each exits 0 and its standard output equals the twin's byte for
byte (greedy tokens; speculation is exact under greedy)."""

import os
import subprocess
import sys

import pytest

from llama_cpp_q_4_0_tpu_torch.formats.fixtures import make_llama_ggjt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = "hello world"  # 32 greedy tokens on this fixture before any EOS


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("examples") / "llama.ggjt")
    make_llama_ggjt(p, n_vocab=256, n_embd=64, n_head=4, n_layer=2)
    return p


def _run(script, *args):
    env = {**os.environ, "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")])}
    r = subprocess.run([sys.executable, os.path.join(ROOT, "examples", script), *args],
                       capture_output=True, timeout=300, cwd="/", env=env)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    return r.stdout, r.stderr.decode()


def test_simple_example(model):
    """32 greedy tokens (both scripts' default -n), printed as the JAX twin
    prints them."""
    want, _ = _run("simple.py", model, PROMPT)
    out, _ = _run("simple_torch.py", model, PROMPT, "--device", "cpu")
    assert len(want) > len(PROMPT) + 32
    assert out == want


def test_speculative_example(model):
    """128 tokens with 3 drafts a round (the JAX twin's fixed n_predict): the
    text and the verify-step statistics equal the twin's."""
    want, want_err = _run("speculative.py", model, PROMPT, "3")
    out, err = _run("speculative_torch.py", model, PROMPT, "3", "--device", "cpu")
    assert out == want
    stats = [ln for ln in err.splitlines() if "tokens/verify-step" in ln]
    assert stats and stats == [ln for ln in want_err.splitlines() if "tokens/verify-step" in ln]


def test_examples_refuse_cpu_unless_asked(model):
    """Without --device the examples run on cuda, and without CUDA they
    raise rather than fall back."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for script in ("simple_torch.py", "speculative_torch.py"):
        r = subprocess.run([sys.executable, os.path.join(ROOT, "examples", script), model,
                            PROMPT], capture_output=True, timeout=300)
        assert r.returncode != 0 and b"CUDA is not available" in r.stderr
