"""The check that decides ``correct``, driven through a whole run on the
CPU at tiny widths (the look for a chip skipped): a sound program passes;
a token altered where it is produced, a step that leaves its state
unchanged, and the control (the reference in float8 in the program's place)
fail."""

import json
import os
import time

import pytest
import torch

from portbench import harness, reference, traffic

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CPU = torch.device("cpu")
SEED = 2 ** 31 + 99
# the tiny models' limits, set as a cell's are: above the widest gap that
# sound runs read on a dozen seeds, below the least the control reads at the
# same served positions (12 CPU seeds of each case: sound at most 0.0126
# (chat) and 0.0173 (solo) for GPT-NeoX, 0.0096 for RWKV; the control at
# least 0.0569 and 0.0303, and 0.0202)
TINY_LIMITS = {"tiny-gptneox": 0.025, "tiny-rwkv4": 0.015}
CASES = [("tiny-gptneox", "tiny-chat"), ("tiny-gptneox", "tiny-solo"),
         ("tiny-rwkv4", "tiny-solo")]


# the window of each tiny mix: long enough for the check's served greedy
# tokens (MIN_CHECK_TOKENS) on a loaded CPU
SECONDS = {"tiny-chat": 3.0, "tiny-solo": 8.0}


def run(conf_name, mix_name, seed=SEED, control=None):
    with open(os.path.join(DATA, f"{conf_name}.json")) as f:
        conf = json.load(f)
    mix = traffic.load(mix_name, DATA)
    limits = {"logit_gap": {"limit": TINY_LIMITS[conf_name]}}
    return harness.run_cell(conf, mix, limits, seed=seed, seconds=SECONDS[mix_name],
                            trace=False, device=CPU, t_process=time.time(), control=control,
                            end_to_end=[{"name": "output_tok_s", "unit": "tokens/s"}],
                            log=lambda *a, **k: None)


def alter_greedy_tokens(monkeypatch, vocab):
    """A fault: each greedy token replaced by its neighbour where it is
    produced, on the host and on the device."""
    from llama_cpp_q_4_0_tpu_torch.runtime import device_sample, sampling

    host = sampling.sample_token_greedy
    monkeypatch.setattr(sampling, "sample_token_greedy", lambda c: (host(c) + 1) % vocab)
    dev = device_sample.sample_logits_vec

    def shifted(logits, key, sv, *a, **k):
        out = dev(logits, key, sv, *a, **k)
        tok, rest = (out[0], out[1:]) if isinstance(out, tuple) else (out, None)
        tok = torch.where(sv.temp > 0, tok, (tok + 1) % vocab)
        return (tok, *rest) if rest is not None else tok

    monkeypatch.setattr(device_sample, "sample_logits_vec", shifted)


def freeze_state(monkeypatch, family):
    """A fault: every step returns its state unchanged (the KV cache is
    never written; the recurrence hands back the state it was given)."""
    if family == "gptneox":
        from llama_cpp_q_4_0_tpu_torch.models import transformer

        monkeypatch.setattr(transformer, "_cache_insert", lambda *a: None)
        monkeypatch.setattr(transformer, "_cache_insert_rows", lambda *a: None)
    else:
        from llama_cpp_q_4_0_tpu_torch.models import rwkv

        fwd = rwkv.forward
        monkeypatch.setattr(rwkv, "forward",
                            lambda cfg, params, tokens, state, **k:
                            (fwd(cfg, params, tokens, state, **k)[0], state))


@pytest.mark.parametrize("conf_name,mix_name", CASES)
def test_a_sound_run_is_correct(conf_name, mix_name):
    res = run(conf_name, mix_name)
    assert res["checks"]["tokens_checked"]["value"] >= harness.MIN_CHECK_TOKENS
    assert res["correct"], (res["checks"], res["failed"], res["forbidden_loaded"])
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("conf_name,mix_name", CASES)
def test_an_altered_token_is_not_correct(conf_name, mix_name, monkeypatch):
    with open(os.path.join(DATA, f"{conf_name}.json")) as f:
        vocab = json.load(f)["vocab_size"]
    alter_greedy_tokens(monkeypatch, vocab)
    res = run(conf_name, mix_name)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("conf_name,mix_name", CASES)
def test_a_state_left_unchanged_is_not_correct(conf_name, mix_name, monkeypatch):
    freeze_state(monkeypatch, "gptneox" if "gptneox" in conf_name else "rwkv4")
    res = run(conf_name, mix_name)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("conf_name,mix_name", CASES)
def test_the_control_is_not_correct(conf_name, mix_name):
    """The reference in float8 put in the program's place, at the same
    served positions, comes out not correct by the run's own rule, where the
    program's own reading of the same run passes."""
    res = run(conf_name, mix_name, control=reference.fp8_rows)
    assert not res["correct"], res["checks"]
    assert res["checks"]["logit_gap"]["value"] > TINY_LIMITS[conf_name]
    assert res["checks"]["tokens_checked"]["value"] >= harness.MIN_CHECK_TOKENS
    assert res["control"]["program_logit_gap"] <= TINY_LIMITS[conf_name], res["control"]


def test_fp8_is_the_step_below_bf16():
    x = torch.randn(4, 64)
    bf16 = (x.bfloat16().float() - x).abs().max()
    fp8 = (reference.fp8_rows(x) - x).abs().max()
    assert fp8 > 4 * bf16


def test_an_open_loop_with_a_shared_prefix():
    """Arrivals at the mix's own times (an open loop) and a system prompt the
    engine registers once: every request sent in the window is one that was
    due, every one is served, and the served tokens hold."""
    with open(os.path.join(DATA, "tiny-gptneox.json")) as f:
        conf = json.load(f)
    mix = dict(traffic.load("tiny-chat", DATA), shared_prefix=24, greedy_share=1.0,
               arrivals={"process": "poisson", "rate_per_s": 3.0})
    seconds = SECONDS["tiny-chat"]
    due = [t for t in traffic.arrival_times(mix, mix["pool"]) if t < seconds]
    res = harness.run_cell(conf, mix, {"logit_gap": {"limit": TINY_LIMITS["tiny-gptneox"]}},
                           seed=SEED, seconds=seconds, trace=False, device=CPU,
                           t_process=time.time(), log=lambda *a, **k: None)
    assert res["attempted"] == len(due) and res["failed"] == 0
    assert res["correct"], res["checks"]


def test_arrivals_are_the_mix_s_not_the_seed_s():
    mix = {"arrivals": {"process": "bursts", "size": [2, 4], "every_s": [1.0, 2.0]}}
    a = traffic.arrival_times(mix, 40)
    assert a == traffic.arrival_times(dict(mix), 40) and a == sorted(a) and len(a) == 40
    assert traffic.arrival_times({}, 5) is None
