"""The port's `server` (cli/server.py) against the JAX package's on the CPU:
the endpoints of tests/test_cli.py and tests/test_batch_engine.py answer
with the same JSON keys, and their greedy content is JAX's, with one session
under a lock and through the engine's host, chunked and speculative ticks.
The fixture is tests/test_batch_engine.py's (n_vocab 256, n_embd 64, 4
heads, 2 layers), n_ctx 64, an f32 cache.  Also the `server` tool itself in
a subprocess (--parallel, --parallel-chunk and --system-prompt) and its
refusal to run off the card without --device cpu."""

import http.client
import json
import os
import re
import subprocess
import sys
import threading
from http.server import ThreadingHTTPServer

import pytest
import torch

from llama_cpp_q_4_0_tpu.cli import common as jcommon
from llama_cpp_q_4_0_tpu.cli import server as jserver
from llama_cpp_q_4_0_tpu.formats.fixtures import make_llama_ggjt
from llama_cpp_q_4_0_tpu.runtime import batch_engine as jbe
from llama_cpp_q_4_0_tpu.runtime import device_sample as jds
from llama_cpp_q_4_0_tpu_torch.cli import common as tcommon
from llama_cpp_q_4_0_tpu_torch.cli import server as tserver
from llama_cpp_q_4_0_tpu_torch.runtime import batch_engine as tbe
from llama_cpp_q_4_0_tpu_torch.runtime import device_sample as tds

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("srv") / "tiny.ggjt")
    make_llama_ggjt(p, n_vocab=256, n_embd=64, n_head=4, n_layer=2)
    return p


class Args:
    arch, n_ctx, n_batch = None, 64, 64
    lora = lora_base = None
    lora_unmerged = False
    memory_f32 = True
    cache_type = None
    device = "cpu"

    def __init__(self, model):
        self.model = model


@pytest.fixture(scope="module")
def lms(path):
    return {True: jcommon.load_model(Args(path)), False: tcommon.load_model(Args(path))}


ENGINES = {"single": None, "host": dict(),
           "chunked": dict(chunk=2, per_request_sampling=True, ds=dict(temp=-1.0)),
           "spec": dict(chunk=2, spec_draft=3, per_request_sampling=True,
                        ds=dict(temp=-1.0))}


def _engine(jax: bool, lm, kw):
    if kw is None:
        return None
    kw = dict(kw)
    ds = kw.pop("ds", None)
    if ds is not None:
        kw["device_sampling"] = (jds if jax else tds).DeviceSampling(**ds)
    if jax:
        import jax.numpy as jnp

        return jbe.BatchEngine(lm.cfg, lm.ctx.params, n_slots=2, n_ctx=64,
                               cache_dtype=jnp.float32, **kw)
    return tbe.BatchEngine(lm.cfg, lm.ctx.params, n_slots=2, n_ctx=64,
                           cache_dtype=torch.float32, device="cpu", **kw)


class Served:
    """A server of one package on a free localhost port, with an engine or
    not; stopped on exit."""

    def __init__(self, jax: bool, lm, engine_kw):
        mod = jserver if jax else tserver
        self.engine = _engine(jax, lm, engine_kw)
        if self.engine is not None:
            self.engine.start()
        lm.ctx.reset()
        self.httpd = ThreadingHTTPServer(
            ("127.0.0.1", 0), mod.make_handler(mod.ServerState(lm, self.engine,
                                                               model_id="tiny.ggjt")))
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        if self.engine is not None:
            self.engine.stop()

    def call(self, method, route, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=TIMEOUT)
        try:
            conn.request(method, route, None if body is None else json.dumps(body),
                         {"Content-Type": "application/json"})
            r = conn.getresponse()
            raw = r.read()
            ctype = r.getheader("Content-Type", "")
        finally:
            conn.close()
        if "event-stream" in ctype:
            events = [line[6:] for line in raw.decode().split("\n")
                      if line.startswith("data: ")]
            return r.status, [e if e == "[DONE]" else _plain(json.loads(e)) for e in events]
        return r.status, _plain(json.loads(raw))


def _plain(obj):
    """A response without the fields that differ by design: an OpenAI id, its
    creation time, and the package named as a model's owner."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()
                if k not in ("id", "created", "owned_by")}
    if isinstance(obj, list):
        return [_plain(v) for v in obj]
    return obj


GREEDY = {"temperature": -1.0}
CALLS = [
    ("GET", "/health", None),
    ("GET", "/v1/models", None),
    ("POST", "/tokenize", {"content": "hello world"}),
    ("POST", "/completion", {"prompt": "hello", "n_predict": 6, **GREEDY}),
    ("POST", "/completion", {"prompt": "hello there", "n_predict": 4, "stream": True,
                             **GREEDY}),
    ("POST", "/completion", {"prompt": "hello", "n_predict": 5, "stop": ["xyz"], **GREEDY}),
    ("POST", "/v1/completions", {"prompt": "hello", "max_tokens": 5, "temperature": -1.0}),
    ("POST", "/v1/completions", {"prompt": "hi", "max_tokens": 3, "temperature": -1.0,
                                 "stream": True}),
    ("POST", "/v1/chat/completions", {"messages": [{"role": "system", "content": "Be brief."},
                                                   {"role": "user", "content": "hi"}],
                                      "max_tokens": 4, "temperature": -1.0}),
    ("POST", "/v1/chat/completions", {"messages": [{"role": "user", "content": "hi"}],
                                      "max_tokens": 3, "stream": True, "temperature": -1.0}),
    ("POST", "/nope", {}),
    ("GET", "/nope", None),
]


@pytest.mark.parametrize("mode", list(ENGINES))
def test_endpoints_answer_as_jax(lms, mode):
    """Every call of CALLS, one after another: the status, the JSON (keys
    and values, ids and times aside) and the SSE events equal JAX's."""
    answers = {}
    for jax in (True, False):
        with Served(jax, lms[jax], ENGINES[mode]) as srv:
            answers[jax] = [srv.call(*c) for c in CALLS]
    for c, want, got in zip(CALLS, answers[True], answers[False]):
        assert got == want, (c, got, want)
    st, body = answers[False][3]
    assert st == 200 and body["tokens_predicted"] > 0 and body["content"]


def test_embedding_answers_as_jax(lms):
    """/embedding: the output-norm state of the last token, 64 values,
    within 1e-4 of JAX's."""
    got = {}
    for jax in (True, False):
        with Served(jax, lms[jax], None) as srv:
            st, body = srv.call("POST", "/embedding", {"content": "hello"})
            assert st == 200 and list(body) == ["embedding"]
            got[jax] = body["embedding"]
    assert len(got[False]) == 64
    assert max(abs(a - b) for a, b in zip(got[True], got[False])) < 1e-4


@pytest.mark.parametrize("mode", ["host", "chunked"])
def test_concurrent_completions_and_stats(lms, mode):
    """Three concurrent greedy /completion posts through two slots, then
    /stats: each content is the single-session server's, and /stats has
    JAX's keys and counts."""
    prompts = ["req 0", "req 1 is longer", "req 2"]
    single = {}
    with Served(False, lms[False], None) as srv:
        for p in prompts:
            single[p] = srv.call("POST", "/completion",
                                 {"prompt": p, "n_predict": 4, **GREEDY})[1]["content"]
    stats = {}
    for jax in (True, False):
        with Served(jax, lms[jax], ENGINES[mode]) as srv:
            results = {}

            def post(p):
                results[p] = srv.call("POST", "/completion",
                                      {"prompt": p, "n_predict": 4, **GREEDY})

            threads = [threading.Thread(target=post, args=(p,)) for p in prompts]
            for t in threads:
                t.start()
            for t in threads:
                t.join(TIMEOUT)
            for p in prompts:
                assert results[p][0] == 200 and results[p][1]["content"] == single[p]
            stats[jax] = srv.call("GET", "/stats")
    assert stats[False][0] == 200 and stats[False][1].keys() == stats[True][1].keys()
    for k in ("n_active", "n_pending", "n_tokens_out", "n_requests_done", "mode",
              "cache_dtype"):
        assert stats[False][1][k] == stats[True][1][k], k


def test_helpers_match_jax():
    """The request parsers, the chat template, the stop cut and the UTF-8
    stream give JAX's results."""
    body = {"top_k": 7, "temperature": 0.5, "repeat_last_n": 3, "mirostat": 2,
            "logit_bias": [[5, 1.5], [6, False], [7, True], ["x", 1], [-1, 2]],
            "ignore_eos": True}
    for fn in ("sampling_from_json",):
        a, b = getattr(jserver, fn)(body), getattr(tserver, fn)(body)
        assert vars(a) == vars(b)
    oa = {"temperature": 0.3, "top_p": 0.9, "presence_penalty": 0.1, "logit_bias": {"4": -2}}
    assert vars(jserver.sampling_from_openai(oa)) == vars(tserver.sampling_from_openai(oa))
    msgs = [{"role": "system", "content": "S"}, {"role": "user", "content": "U"},
            {"role": "assistant", "content": "A"}, {"role": "user"}]
    assert tserver.render_chat(msgs) == jserver.render_chat(msgs)
    assert tserver._strip_stops("abc### User:x", ["### User:", "c"]) == "ab"
    data = "héllo wörld €".encode()
    ja, ta = jserver._Utf8Stream(), tserver._Utf8Stream()
    for i in range(len(data)):
        assert ta.push(data[i:i + 1]) == ja.push(data[i:i + 1])
    assert ta.flush() == ja.flush()


def _serve_cli(path, *extra):
    """Start `server` in a subprocess on a free port; returns it and the
    port once it listens."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "llama_cpp_q_4_0_tpu_torch", "server", "-m", path, "-c", "64",
         "--memory-f32", "--port", "0", *extra],
        cwd=ROOT, stderr=subprocess.PIPE, stdout=subprocess.DEVNULL, text=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    lines = []
    for line in proc.stderr:
        lines.append(line)
        m = re.search(r"listening on http://127\.0\.0\.1:(\d+)", line)
        if m:
            threading.Thread(target=proc.stderr.read, daemon=True).start()
            return proc, int(m.group(1))
        if len(lines) > 50:
            break
    proc.kill()
    raise AssertionError("".join(lines))


def test_server_tool_parallel_with_system_prompt(path, lms):
    """`server --device cpu --parallel 2 --parallel-chunk 2 --system-prompt`:
    a greedy /completion whose prompt starts with the system prompt gives the
    single session's content, and /stats shows chunked ticks."""
    with Served(False, lms[False], None) as srv:
        want = srv.call("POST", "/completion", {"prompt": "hello world", "n_predict": 5,
                                                **GREEDY})[1]
    proc, port = _serve_cli(path, "--device", "cpu", "--parallel", "2", "--parallel-chunk",
                            "2", "--system-prompt", "hello")
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
        conn.request("POST", "/completion", json.dumps({"prompt": "hello world",
                                                        "n_predict": 5, **GREEDY}))
        got = json.loads(conn.getresponse().read())
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        proc.terminate()
        proc.wait(TIMEOUT)
    assert got == want
    assert stats["mode"] == "chunked" and stats["n_requests_done"] == 1


def test_server_needs_the_card_or_cpu(path):
    """Without CUDA and without --device cpu the tool refuses to start."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserver.main(["-m", path, "--port", "0"])
