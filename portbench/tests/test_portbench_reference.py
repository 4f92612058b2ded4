"""The plain references against the program at tiny widths on the CPU,
from the same raw tensors."""

import json
import os

import numpy as np
import pytest
import torch

from portbench import families, reference

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CPU = torch.device("cpu")


def load(name):
    with open(os.path.join(DATA, f"{name}.json")) as f:
        return json.load(f)


def program_logits(conf, raw, prompt, compute_dtype):
    from llama_cpp_q_4_0_tpu_torch.models.loading import (config_from_ggjt, load_rwkv,
                                                          load_transformer)
    from llama_cpp_q_4_0_tpu_torch.runtime.context import Context, RwkvContext

    fam = families.module(conf["family"])
    gf = families.common.MemGGJT(fam.ARCH, fam.hparams(conf, 256), raw)
    cfg = config_from_ggjt(gf, n_ctx=256, compute_dtype=compute_dtype)
    if fam.ARCH == "rwkv":
        ctx = RwkvContext(cfg, load_rwkv(gf, cfg, device=CPU), device=CPU)
    else:
        ctx = Context(cfg, load_transformer(gf, cfg, device=CPU), n_ctx=256,
                      cache_dtype=torch.float32, device=CPU)
    return torch.from_numpy(ctx.eval(np.asarray([prompt]), logits_all=True)[0]).double()


@pytest.mark.parametrize("seed", [3, 2 ** 32 + 17])
def test_gptneox_reference_is_the_program_in_f32(seed):
    conf = load("tiny-gptneox")
    raw = families.module("gptneox").raw_weights(conf, seed, CPU)
    prompt = np.random.default_rng(seed).integers(0, conf["vocab_size"], 40).tolist()
    ref = reference.module("gptneox").logits_at(conf, raw, [prompt], [list(range(40))], CPU)[0]
    got = program_logits(conf, raw, prompt, "float32")
    # the program's f32 path against f32: summation order alone (1e-4 of the
    # logits' spread)
    assert (got - ref.double()).abs().max().item() < 1e-4 * ref.std().item()
    assert torch.equal(got.argmax(1), ref.argmax(1))


@pytest.mark.parametrize("seed", [3, 2 ** 32 + 17])
def test_rwkv_reference_is_the_program_in_f32(seed, monkeypatch):
    """The program's RWKV products take bf16 operands whatever the compute
    dtype says; with them in f32 (its ``_mm`` and the head's product
    patched) the two part by summation order alone."""
    from llama_cpp_q_4_0_tpu_torch.models import rwkv
    from llama_cpp_q_4_0_tpu_torch.ops.qmatmul import q_matmul

    def f32(x, w, **_):
        return q_matmul(x, w, compute_dtype=torch.float32)

    monkeypatch.setattr(rwkv, "_mm", f32)
    monkeypatch.setattr(rwkv, "q_matmul", f32)  # the head's product
    conf = load("tiny-rwkv4")
    raw = families.module("rwkv4").raw_weights(conf, seed, CPU)
    prompt = np.random.default_rng(seed).integers(0, conf["vocab_size"], 40).tolist()
    ref = reference.module("rwkv4").logits_at(conf, raw, [prompt], [list(range(40))], CPU)[0]
    got = program_logits(conf, raw, prompt, "float32")
    assert (got - ref.double()).abs().max().item() < 1e-4 * ref.std().item()
    assert torch.equal(got.argmax(1), ref.argmax(1))


def test_rwkv_reference_is_the_program_in_bf16():
    """The program as it runs, bf16 operands: 3e-2 of the logits' spread
    (each product's operands rounded to 8 bits of mantissa)."""
    conf = load("tiny-rwkv4")
    raw = families.module("rwkv4").raw_weights(conf, 5, CPU)
    prompt = np.random.default_rng(5).integers(0, conf["vocab_size"], 40).tolist()
    ref = reference.module("rwkv4").logits_at(conf, raw, [prompt], [list(range(40))], CPU)[0]
    got = program_logits(conf, raw, prompt, "bfloat16")
    assert (got - ref.double()).abs().max().item() < 3e-2 * ref.std().item()


def test_the_control_rounds_to_float8():
    x = torch.tensor([[1.0, -0.3, 0.07, 448.0 / 3]])
    y = reference.fp8_rows(x)
    assert not torch.equal(x, y)
    assert (y - x).abs().max() <= x.abs().max() / 448.0 * 16  # e4m3: 3 mantissa bits
    assert y[0, 3] == pytest.approx(x[0, 3])  # the row's largest maps onto the format's
