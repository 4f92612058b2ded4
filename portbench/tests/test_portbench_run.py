"""The command itself: no card, no result; on the card, one short run of a
cell prints the result's line as the contract asks."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def run(cwd, *args, timeout=600):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=timeout)


def test_no_card_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = run(ROOT, "--workload", "stablelm-7b.solo", "--seed", str(2 ** 31 + 3),
            "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""
    # nor in a directory of BENCHMARK.json and the benchmark's files alone
    shutil.copytree(HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = run(str(tmp_path), "--workload", "stablelm-7b.solo", "--seed", "1", "--seconds", "1",
            "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.gpu
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = run(ROOT, "--workload", "stablelm-7b.solo", "--seed", str(2 ** 31 + 5),
            "--seconds", "5", "--trace", "1", timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks" and out["correct"]
    assert out["device"]["platform"] == "gpu" and out["device"]["busy_s"] > 0
    assert p.stderr.strip().splitlines()[-1].startswith("check ")
