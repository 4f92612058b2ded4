"""`server`: the HTTP completion API (examples/server/server.cpp:1-975).

Endpoints, with the reference's JSON contract:
  POST /completion  {"prompt", "n_predict", "stream", sampling params...}
                    -> {"content", "tokens_predicted", ...} or SSE chunks
  POST /tokenize    {"content"} -> {"tokens": [...]}
  POST /embedding   {"content"} -> {"embedding": [...]}

and an OpenAI-compatible surface:
  GET  /v1/models
  POST /v1/completions       (prompt, max_tokens, stream, logit_bias, ...)
  POST /v1/chat/completions  (messages -> a "### User/Assistant" template)
both with SSE streaming ("data: {...}" chunks, a final "data: [DONE]") and
usage counts; GET /health, and GET /stats with an engine.

Without --parallel one Context serves the requests one at a time under a
lock, reusing the prompt prefix it holds (server.cpp loadPrompt).  With
--parallel N a continuous-batching engine (runtime/batch_engine.py) serves
them concurrently; an RWKV model's is ``RwkvBatchEngine``
(runtime/rwkv_engine.py, speculative ticks only, no prefix cache).  The JAX
package's ``cli/server.py``."""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..runtime.generate import GenerateParams, generate
from ..runtime.sampling import SamplingParams
from ..runtime.session import session_prefix_match
from ..runtime.tokenizer import TOKEN_BOS
from .common import CACHE_TYPES, add_model_args, load_model


def build_parser(p: argparse.ArgumentParser | None = None):
    p = p or argparse.ArgumentParser("server", description=__doc__)
    add_model_args(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--parallel", type=int, default=1,
                   help=">1: continuous-batching engine with N slots "
                        "(requests decode concurrently)")
    p.add_argument("--parallel-chunk", type=int, default=1,
                   help=">1: throughput mode — decode+sample N tokens per "
                        "tick on device (engine-wide temp/top-k sampling "
                        "replaces per-request chains)")
    p.add_argument("--parallel-temp", type=float, default=0.8)
    p.add_argument("--parallel-top-k", type=int, default=40)
    p.add_argument("--parallel-top-p", type=float, default=1.0)
    p.add_argument("--parallel-uniform-sampling", action="store_true",
                   help="use ONE engine-wide sampler for device ticks "
                        "instead of honoring each request's temp/top-k/"
                        "top-p/tfs/typical/penalties per slot")
    p.add_argument("--system-prompt", default=None,
                   help="shared prompt prefix prefilled ONCE and KV-cached; "
                        "requests starting with it skip its prefill "
                        "(vLLM-style prefix caching; --parallel mode)")
    p.add_argument("--parallel-draft", type=int, default=0,
                   help=">0: speculative continuous batching: every tick "
                        "verifies K prompt-lookup drafts per slot on the "
                        "device (exact for greedy)")
    return p


def sampling_from_json(body: dict) -> SamplingParams:
    """server.cpp:713 parse_options_completion field names."""
    sp = SamplingParams()
    m = {
        "top_k": "top_k", "top_p": "top_p", "tfs_z": "tfs_z",
        "typical_p": "typical_p", "temperature": "temp", "temp": "temp",
        "repeat_penalty": "repeat_penalty", "repeat_last_n": "repeat_last_n",
        "frequency_penalty": "frequency_penalty",
        "presence_penalty": "presence_penalty", "mirostat": "mirostat",
        "mirostat_tau": "mirostat_tau", "mirostat_eta": "mirostat_eta",
    }
    for k, attr in m.items():
        if k in body:
            setattr(sp, attr, type(getattr(sp, attr))(body[k]))
    if isinstance(body.get("logit_bias"), list):
        # server.cpp:737-752: [tok, number] adds a bias; [tok, false] bans
        # the token (-inf); malformed entries and non-int tokens dropped
        sp.logit_bias = {}
        for el in body["logit_bias"]:
            if (isinstance(el, (list, tuple)) and len(el) == 2
                    and isinstance(el[0], int) and not isinstance(el[0], bool)
                    and el[0] >= 0):
                if isinstance(el[1], bool):
                    if not el[1]:
                        sp.logit_bias[el[0]] = float("-inf")
                elif isinstance(el[1], (int, float)):
                    sp.logit_bias[el[0]] = float(el[1])
    if body.get("ignore_eos"):
        sp.logit_bias[2] = float("-inf")
    return sp


def render_chat(messages: list[dict]) -> str:
    """messages -> a plain instruct template (the reference era predates
    model-carried chat templates; this mirrors the alpaca-style framing the
    fork's chat scripts use)."""
    parts = []
    for m in messages:
        role = m.get("role", "user")
        content = m.get("content", "") or ""
        if role == "system":
            parts.append(content + "\n\n")
        elif role == "assistant":
            parts.append(f"### Assistant:\n{content}\n\n")
        else:
            parts.append(f"### User:\n{content}\n\n")
    parts.append("### Assistant:\n")
    return "".join(parts)


class _Utf8Stream:
    """Incremental UTF-8 decoder: emit only complete characters so SSE
    deltas never split a multi-byte sequence into replacement chars."""

    def __init__(self):
        self.buf = b""

    def push(self, b: bytes) -> str:
        self.buf += b
        for cut in range(len(self.buf), max(len(self.buf) - 4, 0) - 1, -1):
            try:
                s = self.buf[:cut].decode("utf-8")
            except UnicodeDecodeError:
                continue
            self.buf = self.buf[cut:]
            return s
        return ""

    def flush(self) -> str:
        s = self.buf.decode("utf-8", errors="replace")
        self.buf = b""
        return s


def sampling_from_openai(body: dict) -> SamplingParams:
    sp = SamplingParams()
    if "temperature" in body:
        sp.temp = float(body["temperature"])
    if "top_p" in body:
        sp.top_p = float(body["top_p"])
    if "frequency_penalty" in body:
        sp.frequency_penalty = float(body["frequency_penalty"])
    if "presence_penalty" in body:
        sp.presence_penalty = float(body["presence_penalty"])
    if body.get("logit_bias"):
        sp.logit_bias = {int(t): float(b)
                         for t, b in body["logit_bias"].items()}
    return sp


class ServerState:
    """llama_server_context (server.cpp:40-200): one model, one lock,
    last-evaluated tokens kept for prefix reuse.  With engine != None,
    /completion requests run through the continuous-batching engine
    concurrently instead (runtime/batch_engine.py)."""

    def __init__(self, lm, engine=None, model_id: str = "model"):
        self.lm = lm
        self.engine = engine
        self.model_id = model_id
        self.lock = threading.Lock()
        self.last_tokens: list[int] = []

    def load_prompt(self, prompt_tokens: list[int]):
        ctx = self.lm.ctx
        n_match = session_prefix_match(self.last_tokens, prompt_tokens)
        if n_match and n_match <= ctx.n_past and n_match == len(prompt_tokens):
            n_match -= 1  # must eval at least one token for fresh logits
        # a KV cache rewinds to any prefix it holds; a recurrent (RWKV) state
        # is only ever the state after all n_past tokens
        fits = n_match <= ctx.n_past if hasattr(ctx, "cache_k") else n_match == ctx.n_past
        if n_match and fits:
            ctx.n_past = n_match
        else:
            ctx.reset()
            n_match = 0
        return prompt_tokens[n_match:]


def make_handler(state: ServerState):
    lm = state.lm

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *a):
            print("server:", fmt % a, file=sys.stderr)

        def _json(self, code: int, obj: dict):
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_GET(self):  # noqa: N802
            if self.path == "/stats" and state.engine is not None:
                return self._json(200, state.engine.stats())
            if self.path in ("/", "/health"):
                return self._json(200, {"status": "ok"})
            if self.path == "/v1/models":
                return self._json(200, {"object": "list", "data": [
                    {"id": state.model_id, "object": "model",
                     "owned_by": "llama_cpp_q_4_0_tpu_torch"}]})
            return self._json(404, {"error": "not found"})

        def do_POST(self):  # noqa: N802
            try:
                body = self._body()
                if self.path == "/tokenize":
                    toks = lm.tokenizer.tokenize(body.get("content", ""))
                    return self._json(200, {"tokens": toks})
                if self.path == "/embedding":
                    with state.lock:
                        lm.ctx.reset()
                        toks = lm.tokenizer.tokenize(body.get("content", ""),
                                                     bos=True) or [TOKEN_BOS]
                        emb = lm.ctx.embed(toks)
                    return self._json(200, {"embedding": emb[0].tolist()})
                if self.path == "/completion":
                    return self._completion(body)
                if self.path == "/v1/completions":
                    return self._v1(body, chat=False)
                if self.path == "/v1/chat/completions":
                    return self._v1(body, chat=True)
                return self._json(404, {"error": "unknown endpoint"})
            except Exception as e:  # noqa: BLE001
                return self._json(500, {"error": str(e)})

        def _completion(self, body: dict):
            prompt = body.get("prompt", "")
            sp = sampling_from_json(body)
            # server.cpp:743 drops out-of-vocab bias tokens
            sp.logit_bias = {t: b for t, b in sp.logit_bias.items()
                             if t < lm.cfg.n_vocab}
            gp = GenerateParams(
                n_predict=int(body.get("n_predict", 128)),
                sampling=sp,
                seed=int(body.get("seed", -1)),
            )
            stop = body.get("stop", [])
            if state.engine is not None:
                return self._completion_batched(body, prompt, gp, stop)
            with state.lock:
                toks = lm.tokenizer.tokenize(prompt, bos=True) or [TOKEN_BOS]
                todo = state.load_prompt(toks)
                antiprompts = tuple(lm.tokenizer.tokenize(s) for s in stop)
                produced: list[int] = []
                if body.get("stream"):
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()

                    def chunk(obj):
                        data = b"data: " + json.dumps(obj).encode() + b"\n\n"
                        self.wfile.write(hex(len(data))[2:].encode() + b"\r\n"
                                         + data + b"\r\n")

                    try:
                        for t in generate(lm.ctx, todo, gp,
                                          antiprompts=antiprompts):
                            produced.append(t)
                            chunk({"content": lm.tokenizer.token_text(t)
                                   .decode("utf-8", errors="replace"),
                                   "stop": False})
                        chunk({"content": "", "stop": True,
                               "tokens_predicted": len(produced)})
                        self.wfile.write(b"0\r\n\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        # client went away: stop generating; fall through so
                        # last_tokens still records what was produced
                        pass
                else:
                    for t in generate(lm.ctx, todo, gp, antiprompts=antiprompts):
                        produced.append(t)
                    text = lm.tokenizer.detokenize(produced).decode(
                        "utf-8", errors="replace")
                    self._json(200, {
                        "content": text,
                        "tokens_predicted": len(produced),
                        "tokens_evaluated": len(todo),
                        "stopped_eos": len(produced) < gp.n_predict,
                        "generation_settings": {"n_predict": gp.n_predict},
                    })
                state.last_tokens = toks + produced

        def _completion_batched(self, body: dict, prompt: str, gp, stop):
            from ..runtime.batch_engine import Request

            toks = lm.tokenizer.tokenize(prompt, bos=True) or [TOKEN_BOS]
            req = state.engine.submit(Request(
                prompt_tokens=toks,
                n_predict=gp.n_predict,
                sampling=gp.sampling,
                seed=gp.seed,
                stop_sequences=tuple(tuple(lm.tokenizer.tokenize(s))
                                     for s in stop),
            ))
            produced: list[int] = []
            if body.get("stream"):
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def chunk(obj):
                    data = b"data: " + json.dumps(obj).encode() + b"\n\n"
                    self.wfile.write(hex(len(data))[2:].encode() + b"\r\n"
                                     + data + b"\r\n")

                try:
                    for t in req.tokens():
                        produced.append(t)
                        chunk({"content": lm.tokenizer.token_text(t)
                               .decode("utf-8", errors="replace"),
                               "stop": False})
                    chunk({"content": "", "stop": True,
                           "tokens_predicted": len(produced)})
                    self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    # client went away: free the slot instead of decoding
                    # the rest of n_predict into the void
                    req.cancel()
                    for _ in req.tokens():
                        pass
            else:
                produced = list(req.tokens())
                self._json(200, {
                    "content": lm.tokenizer.detokenize(produced)
                    .decode("utf-8", errors="replace"),
                    "tokens_predicted": len(produced),
                    "tokens_evaluated": len(toks),
                    "stopped_eos": len(produced) < gp.n_predict,
                    "generation_settings": {"n_predict": gp.n_predict},
                })

        # ------------------------------------------------ OpenAI surface

        def _sse_chunk(self, obj):
            data = b"data: " + json.dumps(obj).encode() + b"\n\n"
            self.wfile.write(hex(len(data))[2:].encode() + b"\r\n"
                             + data + b"\r\n")

        def _v1(self, body: dict, chat: bool):
            import time
            import uuid

            if chat:
                prompt = render_chat(body.get("messages", []))
                auto_stop = ["### User:"]
                default_n = 256
            else:
                prompt = body.get("prompt", "")
                auto_stop = []
                default_n = 16  # the OpenAI completions default
            stop = body.get("stop") or []
            if isinstance(stop, str):
                stop = [stop]
            stop = list(stop) + auto_stop
            gp = GenerateParams(
                n_predict=int(body.get("max_tokens") or default_n),
                sampling=sampling_from_openai(body),
                seed=int(body.get("seed", -1)),
            )
            rid = ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:12]
            created = int(time.time())
            obj_kind = "chat.completion" if chat else "text_completion"
            toks = lm.tokenizer.tokenize(prompt, bos=True) or [TOKEN_BOS]
            antiprompts = tuple(lm.tokenizer.tokenize(s) for s in stop)

            def meta(**extra):
                return {"id": rid, "object": obj_kind, "created": created,
                        "model": state.model_id, **extra}

            if body.get("stream"):
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                dec = _Utf8Stream()
                n_out = 0

                def delta_obj(piece, fin=None):
                    if chat:
                        d = {"content": piece} if piece else {}
                        return meta(object="chat.completion.chunk", choices=[
                            {"index": 0, "delta": d, "finish_reason": fin}])
                    return meta(choices=[{"index": 0, "text": piece,
                                          "finish_reason": fin}])

                try:
                    if chat:
                        self._sse_chunk(meta(
                            object="chat.completion.chunk",
                            choices=[{"index": 0,
                                      "delta": {"role": "assistant"},
                                      "finish_reason": None}]))
                    for t in self._v1_tokens(toks, gp, antiprompts):
                        n_out += 1
                        piece = dec.push(lm.tokenizer.token_text(t))
                        if piece:
                            self._sse_chunk(delta_obj(piece))
                    tail = dec.flush()
                    if tail:
                        self._sse_chunk(delta_obj(tail))
                    fin = "length" if n_out >= gp.n_predict else "stop"
                    self._sse_chunk(delta_obj("", fin))
                    done = b"data: [DONE]\n\n"
                    self.wfile.write(hex(len(done))[2:].encode() + b"\r\n"
                                     + done + b"\r\n")
                    self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass
                return None

            produced = list(self._v1_tokens(toks, gp, antiprompts))
            text = _strip_stops(lm.tokenizer.detokenize(produced)
                                .decode("utf-8", errors="replace"), stop)
            fin = "length" if len(produced) >= gp.n_predict else "stop"
            usage = {"prompt_tokens": len(toks),
                     "completion_tokens": len(produced),
                     "total_tokens": len(toks) + len(produced)}
            if chat:
                choice = {"index": 0, "finish_reason": fin,
                          "message": {"role": "assistant", "content": text}}
            else:
                choice = {"index": 0, "finish_reason": fin, "text": text}
            return self._json(200, meta(choices=[choice], usage=usage))

        def _v1_tokens(self, toks, gp, antiprompts):
            """Token source shared by both OpenAI endpoints: the batching
            engine when running, else the locked single session."""
            if state.engine is not None:
                from ..runtime.batch_engine import Request

                # the engine compares tuples (the JAX server hands it
                # lists here, which never match)
                req = state.engine.submit(Request(
                    prompt_tokens=toks, n_predict=gp.n_predict,
                    sampling=gp.sampling, seed=gp.seed,
                    stop_sequences=tuple(tuple(a) for a in antiprompts)))
                try:
                    yield from req.tokens()
                except GeneratorExit:
                    req.cancel()
                    for _ in req.tokens():
                        pass
                    raise
                return
            with state.lock:
                todo = state.load_prompt(toks)
                produced = []
                try:
                    for t in generate(lm.ctx, todo, gp,
                                      antiprompts=antiprompts):
                        produced.append(t)
                        yield t
                finally:
                    state.last_tokens = toks + produced

    return Handler


def _strip_stops(text: str, stops: list[str]) -> str:
    """Cut the response at the first stop sequence (OpenAI excludes it)."""
    cut = len(text)
    for s in stops:
        if s:
            i = text.find(s)
            if i != -1:
                cut = min(cut, i)
    return text[:cut]


def start_server(args):
    """The model, the engine (started, with --parallel > 1) and the HTTP
    server of args, not yet serving: (httpd, engine or None, the loaded
    model)."""
    lm = load_model(args)
    engine = None
    if getattr(args, "parallel", 1) > 1 and lm.arch == "rwkv":
        from ..runtime.rwkv_engine import RwkvBatchEngine

        engine = RwkvBatchEngine(
            lm.cfg, lm.ctx.params, n_slots=args.parallel, n_ctx=args.n_ctx,
            chunk=max(getattr(args, "parallel_chunk", 1), 4),
            spec_draft=getattr(args, "parallel_draft", 0) or 5,
            per_request_sampling=not getattr(args, "parallel_uniform_sampling", False),
            device=lm.ctx.device)
        if getattr(args, "system_prompt", None):
            print("warning: --system-prompt prefix cache is not supported for rwkv serving",
                  file=sys.stderr)
        engine.start()
        print(f"continuous batching (rwkv): {args.parallel} slots", file=sys.stderr)
    elif getattr(args, "parallel", 1) > 1:
        from ..runtime.batch_engine import BatchEngine

        # --cache-type sets the serving cache; by default ("auto") bf16 when
        # slots x ctx fits the device, the scaled-int8 cache when only it does
        kw = {"cache_dtype": CACHE_TYPES.get(getattr(args, "cache_type", None) or "",
                                             "auto")}
        if (getattr(args, "parallel_chunk", 1) > 1
                or getattr(args, "parallel_draft", 0) > 0):
            from ..runtime.device_sample import DeviceSampling

            kw.update(chunk=args.parallel_chunk,
                      spec_draft=getattr(args, "parallel_draft", 0),
                      per_request_sampling=not getattr(
                          args, "parallel_uniform_sampling", False),
                      device_sampling=DeviceSampling(
                          temp=args.parallel_temp, top_k=args.parallel_top_k,
                          top_p=getattr(args, "parallel_top_p", 1.0)))
        engine = BatchEngine(lm.cfg, lm.ctx.params, n_slots=args.parallel,
                             n_ctx=args.n_ctx, device=lm.ctx.device, **kw)
        if getattr(args, "system_prompt", None):
            engine.register_prefix(
                lm.tokenizer.tokenize(args.system_prompt, bos=True))
        engine.start()
        print(f"continuous batching: {args.parallel} slots"
              + (f", chunk {args.parallel_chunk}"
                 if getattr(args, "parallel_chunk", 1) > 1 else ""),
              file=sys.stderr)
    state = ServerState(lm, engine,
                        model_id=os.path.basename(getattr(args, "model", "model")))
    return ThreadingHTTPServer((args.host, args.port), make_handler(state)), engine, lm


def run(args) -> int:
    httpd, engine, _ = start_server(args)
    print(f"server listening on http://{args.host}:{httpd.server_address[1]}",
          file=sys.stderr, flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        if engine is not None:
            engine.stop()
    return 0


def main(argv=None) -> int:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
