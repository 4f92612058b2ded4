"""RwkvBatchEngine (runtime/rwkv_engine.py) on the CPU, the scenarios of
tests/test_rwkv_engine.py: each request's greedy tokens equal its single
session's across queueing past the slots, staggered admission, cancellation
and a per-request logit bias; `server --parallel` on an RWKV file; the
engine's state, history, lengths and frozen-row tensors written in place;
and the greedy tokens of a burst equal the JAX engine's on the same file."""

import http.client
import json
import threading

import numpy as np
import pytest
import torch

from llama_cpp_q_4_0_tpu.formats.ggjt import read_ggjt as jax_read_ggjt
from llama_cpp_q_4_0_tpu.models.loading import (config_from_ggjt as jax_config,
                                                load_rwkv as jax_load)
from llama_cpp_q_4_0_tpu.runtime.batch_engine import Request as JaxRequest
from llama_cpp_q_4_0_tpu.runtime.rwkv_engine import RwkvBatchEngine as JaxRwkvBatchEngine
from llama_cpp_q_4_0_tpu.runtime.sampling import SamplingParams as JaxSampling
from llama_cpp_q_4_0_tpu_torch.formats.fixtures import make_rwkv_ggjt
from llama_cpp_q_4_0_tpu_torch.formats.ggjt import read_ggjt
from llama_cpp_q_4_0_tpu_torch.models.loading import config_from_ggjt, load_rwkv
from llama_cpp_q_4_0_tpu_torch.quant.types import GGMLType
from llama_cpp_q_4_0_tpu_torch.runtime.batch_engine import Request
from llama_cpp_q_4_0_tpu_torch.runtime.context import RwkvContext
from llama_cpp_q_4_0_tpu_torch.runtime.generate import GenerateParams, generate
from llama_cpp_q_4_0_tpu_torch.runtime.rwkv_engine import RwkvBatchEngine
from llama_cpp_q_4_0_tpu_torch.runtime.sampling import SamplingParams

torch.set_num_threads(1)

GREEDY = dict(temp=-1.0, top_k=0, repeat_penalty=1.0, repeat_last_n=0)
PROMPTS = [[7, 9, 23, 7, 9, 23, 7, 9], [5, 8, 5, 8, 5],
           np.random.default_rng(0).integers(3, 250, 13).tolist()]


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("rweng") / "m.ggjt")
    make_rwkv_ggjt(p, qtype=GGMLType.F32, n_vocab=256, n_embd=64, n_layer=3)
    return p


@pytest.fixture(scope="module")
def model(path):
    gf = read_ggjt(path, "rwkv")
    cfg = config_from_ggjt(gf)
    return cfg, load_rwkv(gf, cfg, device="cpu")


def _plain(model, prompt, n):
    return list(generate(RwkvContext(*model, device="cpu"), prompt, GenerateParams(
        n_predict=n, sampling=SamplingParams(**GREEDY), ignore_eos=False)))


def _engine(model, **kw):
    return RwkvBatchEngine(*model, device="cpu", **kw)


def _ptrs(eng):
    return [t.data_ptr() for t in (*eng._state.values(), eng._hist, eng._n_hist, eng._done)]


def test_engine_greedy_parity_with_queueing(model):
    """3 ragged requests through 2 slots (the third queues): each equals its
    plain single-stream decode token for token; the engine's tensors are
    never rebound."""
    want = [_plain(model, p, 10) for p in PROMPTS]
    eng = _engine(model, n_slots=2, n_ctx=128, chunk=2, spec_draft=3)
    ptrs = _ptrs(eng)
    eng.start()
    try:
        reqs = [eng.submit(Request(prompt_tokens=p, n_predict=10,
                                   sampling=SamplingParams(**GREEDY))) for p in PROMPTS]
        got = [list(r.tokens(timeout=120)) for r in reqs]
    finally:
        eng.stop()
    assert got == want
    st = eng.stats()
    assert st["n_requests_done"] == 3 and st["n_tokens_out"] == sum(map(len, want))
    assert st["arch"] == "rwkv" and st["spec_rounds"] > 0
    assert _ptrs(eng) == ptrs and eng.ctx.state is eng._state


def test_engine_staggered_admission_parity(model):
    """A request admitted while another decodes perturbs neither stream."""
    p1, p2 = PROMPTS[0], [11, 4, 11, 4, 11, 4]
    want1, want2 = _plain(model, p1, 12), _plain(model, p2, 8)
    eng = _engine(model, n_slots=4, n_ctx=128, chunk=1, spec_draft=3)
    eng.start()
    try:
        r1 = eng.submit(Request(prompt_tokens=p1, n_predict=12,
                                sampling=SamplingParams(**GREEDY)))
        it1 = r1.tokens(timeout=120)
        first = next(it1)  # r1 is decoding
        r2 = eng.submit(Request(prompt_tokens=p2, n_predict=8,
                                sampling=SamplingParams(**GREEDY)))
        got1 = [first] + list(it1)
        got2 = list(r2.tokens(timeout=120))
    finally:
        eng.stop()
    assert got1 == want1 and got2 == want2


def test_engine_cancellation(model):
    """A cancelled request's stream ends; its row is frozen."""
    eng = _engine(model, n_slots=1, n_ctx=128)
    eng.start()
    try:
        r = eng.submit(Request(prompt_tokens=[3, 5, 7, 9], n_predict=10_000,
                               sampling=SamplingParams(**GREEDY)))
        it = r.tokens(timeout=120)
        next(it)
        r.cancel()
        out = list(it)
        assert len(out) < 10_000
    finally:
        eng.stop()
    assert bool(eng._done[0])


def test_rwkv_engine_per_request_logit_bias(model):
    """A per-request logit bias inside the speculative verify ticks: the
    banned token never appears."""
    eng = _engine(model, n_slots=2, n_ctx=128, chunk=2, spec_draft=3)
    eng.start()
    try:
        plain = list(eng.submit(Request([5, 9, 23, 5, 9], n_predict=8,
                                        sampling=SamplingParams(**GREEDY))).tokens(timeout=120))
        assert plain
        ban = max(set(plain), key=plain.count)
        sp_ban = SamplingParams(**GREEDY, logit_bias={ban: float("-inf"), 0: float("-inf")})
        banned = list(eng.submit(Request([5, 9, 23, 5, 9], n_predict=8,
                                         sampling=sp_ban)).tokens(timeout=120))
    finally:
        eng.stop()
    assert ban not in banned and len(banned) > 0


def test_engine_refuses_mirostat(model):
    eng = _engine(model, n_slots=1, n_ctx=64)
    with pytest.raises(ValueError, match="mirostat"):
        eng.submit(Request([1, 2, 3], n_predict=4,
                           sampling=SamplingParams(temp=0.8, mirostat=2)))


def test_engine_greedy_equals_jax_engine(path, model):
    """The same burst of 3 requests on 2 slots through the JAX engine and
    the port's: the same greedy tokens and stats counts."""
    gf = jax_read_ggjt(path, "rwkv")
    jcfg = jax_config(gf)
    outs = []
    for make, req, sp in (
            (lambda: JaxRwkvBatchEngine(jcfg, jax_load(gf, jcfg), n_slots=2, n_ctx=128,
                                        chunk=2, spec_draft=3), JaxRequest, JaxSampling),
            (lambda: _engine(model, n_slots=2, n_ctx=128, chunk=2, spec_draft=3), Request,
             SamplingParams)):
        eng = make()
        eng.start()
        try:
            reqs = [eng.submit(req(prompt_tokens=p, n_predict=10, sampling=sp(**GREEDY)))
                    for p in PROMPTS]
            outs.append(([list(r.tokens()) for r in reqs],
                         eng.stats()["n_tokens_out"]))
        finally:
            eng.stop()
    assert outs[1] == outs[0]


def test_server_parallel_rwkv_endpoint(tmp_path):
    """`server --parallel 2` on an RWKV file starts RwkvBatchEngine (with
    the --system-prompt warning) and answers concurrent /completion
    requests; /stats reports the RWKV engine."""
    import argparse

    from llama_cpp_q_4_0_tpu_torch.cli import server

    p = str(tmp_path / "m.ggjt")
    make_rwkv_ggjt(p, n_vocab=256, n_embd=64, n_layer=2)
    args = server.build_parser().parse_args(
        ["-m", p, "-c", "128", "--parallel", "2", "--device", "cpu", "--port", "0",
         "--system-prompt", "You are"])
    assert isinstance(args, argparse.Namespace)
    httpd, eng, lm = server.start_server(args)
    assert isinstance(eng, RwkvBatchEngine) and lm.arch == "rwkv"
    port = httpd.server_address[1]
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        results = {}

        def post(i):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
            conn.request("POST", "/completion",
                         json.dumps({"prompt": f"req {i}", "n_predict": 4, "seed": i}),
                         {"Content-Type": "application/json"})
            r = conn.getresponse()
            results[i] = (r.status, json.loads(r.read()))

        threads = [threading.Thread(target=post, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for i in range(3):
            st, body = results[i]
            assert st == 200 and 0 < body["tokens_predicted"] <= 4
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        assert stats["arch"] == "rwkv" and stats["n_requests_done"] == 3
    finally:
        httpd.shutdown()
        httpd.server_close()
        eng.stop()


def test_server_single_session_rwkv_reuses_only_the_whole_state(tmp_path):
    """Without --parallel one RwkvContext serves: a prompt that extends the
    last request's evaluated tokens reuses the state, any other starts from
    a reset (a recurrent state cannot rewind to a shorter prefix), and each
    answer equals a fresh context's."""
    from llama_cpp_q_4_0_tpu_torch.cli import server

    p = str(tmp_path / "m.ggjt")
    make_rwkv_ggjt(p, n_vocab=256, n_embd=64, n_layer=2)
    args = server.build_parser().parse_args(["-m", p, "-c", "128", "--device", "cpu",
                                             "--port", "0"])
    httpd, eng, lm = server.start_server(args)
    assert eng is None
    state = server.ServerState(lm, None)
    gp = GenerateParams(n_predict=4, sampling=SamplingParams(**GREEDY), ignore_eos=True)
    first = [1, 40, 41, 42, 43]
    todo = state.load_prompt(first)
    out = list(generate(lm.ctx, todo, gp))
    state.last_tokens = first + out
    longer = first + out + [50, 51]
    assert state.load_prompt(longer) == longer[lm.ctx.n_past:]  # extends: the state stays
    lm.ctx.reset()
    lm.ctx.n_past = 0
    state.last_tokens = first + out
    lm.ctx.eval([first + out[:-1]])
    shorter = first[:3] + [60]
    assert state.load_prompt(shorter) == shorter and lm.ctx.n_past == 0
    httpd.server_close()
