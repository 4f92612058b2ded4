"""The rest of the port's serving path over a mesh: ``Context(mesh=...)``'s
decode_chunk, verify, spec_chunk and draft_spec_chunk (so
``generate_ondevice``, ``generate_speculative`` and both
``generate_ondevice_spec*``), the state blob, session files and the KV shift,
``perplexity_ondevice``, the f16-table softmax over an sp split, and
``BatchEngine(mesh=..., forward_fn=...)``, in one 8-process gloo world on
the CPU against the JAX package on the virtual 8-device mesh, with
``ATTN_MXU=0`` pinned as tests/test_sp_serving.py pins it.

The meshes are sp 4, tp 2 (tp 4 for the JAX speculative cases' model, whose
4 heads it splits one a rank) and dp 2 x sp 2 x tp 2 where a case has a
batch.  Greedy tokens are compared for equality; logits and state at 2e-4
of their scale in f32 products; perplexity at test_torch_perplexity.py's
gates (|d ln ppl| <= 1e-4 on the device, 1e-5 for the host loop); the
f16-table mode at test_torch_families.py's (2e-3 absolute, argmax equal).
Where a greedy reference needs no mesh (the speculative and draft cases,
whose JAX tests hold their sharded runs to the unsharded greedy tokens),
JAX runs unsharded.

A mesh of fewer ranks than the world leaves the others idle: they build it
(new_group is collective) and skip its work."""

import dataclasses
import os

import numpy as np
import pytest

from torch_worlds import jax_cfg_dict, load, np_tree, port_model, run_jax, run_world, save

HERE = os.path.abspath(__file__)
N_RANKS = 8
MESHES = {"sp4": dict(sp=4), "tp2": dict(tp=2), "tp4": dict(tp=4),
          "d2s2t2": dict(dp=2, sp=2, tp=2)}
RANKS = {"sp4": 4, "tp2": 2, "tp4": 4, "d2s2t2": 8}
PROMPT = np.random.default_rng(0).integers(3, 255, 12).tolist()
BATCH = np.random.default_rng(1).integers(3, 255, (2, 12)).tolist()
SHIFT_PROMPT = np.random.default_rng(2).integers(3, 255, 40).tolist()
SHIFT = (4, 8)  # n_keep, n_discard: slot 12 in sp rank 0's block, n_past 40 in rank 2's
# the state cases' prompts: at sp 4 and at dp 2 x sp 2 x tp 2 they fill
# slots of more than one sp rank's block
STATE = {"sp4": [SHIFT_PROMPT], "tp2": [PROMPT],
         "d2s2t2": np.random.default_rng(3).integers(3, 255, (2, 40)).tolist()}
GEN = {"sp4_chunk2": ("sp4", 2), "tp2_chunk4": ("tp2", 4)}
SPEC_PROMPT = np.random.default_rng(31).integers(3, 250, 12).tolist()  # test_device_spec's
ENGINE_PROMPTS = [[3, 5, 7, 3, 5], [11, 13]]  # test_batch_engine_with_gspmd_sharded_params
TOL = 2e-4


def _ppl_tokens():
    return np.random.default_rng(5).integers(3, 255, 2 * 64 + 7)


# ----------------------------------------------------------------- JAX side

def _jax_models(out):
    """The f32-product tiny model (tests/test_parallel.py), its 1-layer
    draft, and test_device_spec.py's fixture model, saved for the port."""
    from llama_cpp_q_4_0_tpu.formats.fixtures import make_llama_ggjt
    from llama_cpp_q_4_0_tpu.formats.ggjt import read_ggjt
    from llama_cpp_q_4_0_tpu.models.loading import config_from_ggjt, load_transformer
    from test_parallel import tiny_q_model

    f32 = lambda m: (dataclasses.replace(m[0], compute_dtype="float32"), m[1])
    models = {"q": f32(tiny_q_model(n_layer=2)), "draft": f32(tiny_q_model(seed=5, n_layer=1))}
    path = os.path.join(out, "spec.ggjt")
    make_llama_ggjt(path, n_vocab=256, n_embd=64, n_head=4, n_layer=2)
    gf = read_ggjt(path, "llama")
    cfg = config_from_ggjt(gf, n_ctx=128)
    models["spec"] = (cfg, load_transformer(gf, cfg))
    for name, (cfg, params) in models.items():
        save(out, "model_" + name, (jax_cfg_dict(cfg), np_tree(params)))
    return models


def _jax_drive(ctx, prompt, steps):
    outs = [np.asarray(ctx.eval(np.asarray([prompt], np.int32)))]
    toks = []
    for _ in range(steps):
        toks.append(int(np.argmax(outs[-1][0, -1])))
        outs.append(np.asarray(ctx.eval(np.asarray([[toks[-1]]], np.int32))))
    return {"logits": outs, "tokens": toks}


def jax_refs(out: str) -> None:
    import jax
    import jax.numpy as jnp

    from llama_cpp_q_4_0_tpu.parallel import make_mesh
    from llama_cpp_q_4_0_tpu.runtime import perplexity as jp
    from llama_cpp_q_4_0_tpu.runtime.context import Context
    from llama_cpp_q_4_0_tpu.runtime.device_sample import (DeviceSampling, decode_chunk,
                                                           generate_ondevice)
    from llama_cpp_q_4_0_tpu.runtime.device_spec import (generate_ondevice_spec,
                                                         generate_ondevice_spec_draft)
    from llama_cpp_q_4_0_tpu.runtime.session import get_state, shift_kv_cache
    from llama_cpp_q_4_0_tpu.runtime.speculative import SpecParams, generate_speculative
    from test_device_spec import GREEDY
    from llama_cpp_q_4_0_tpu.runtime.generate import GenerateParams, generate

    os.environ["ATTN_MXU"] = "0"
    models = _jax_models(out)
    cfg, params = models["q"]
    meshes = {k: make_mesh(**{"dp": 1, "sp": 1, "tp": 1, **v}) for k, v in MESHES.items()}
    greedy = DeviceSampling(temp=-1.0)
    refs = {}
    for case, (m, chunk) in GEN.items():
        ctx = Context(cfg, params, n_ctx=64, mesh=meshes[m])
        refs[case] = generate_ondevice(ctx, PROMPT, 10, sampling=greedy, chunk=chunk)
    # a batch on dp 2 x sp 2 x tp 2: a scalar n_past, then one a row
    ctx = Context(cfg, params, batch=2, n_ctx=64, mesh=meshes["d2s2t2"])
    logits = np.asarray(ctx.eval(np.asarray(BATCH, np.int32)))
    tok = jnp.asarray(logits[:, -1].argmax(-1), jnp.int32)
    toks, ctx.cache_k, ctx.cache_v, _, _, _ = decode_chunk(
        cfg, ctx.params, tok, jnp.int32(12), ctx.cache_k, ctx.cache_v, jax.random.key(0),
        n_steps=4, ds=greedy, kv_window=32)
    rows, ctx.cache_k, ctx.cache_v, _, _, _ = decode_chunk(
        cfg, ctx.params, toks[:, -1], jnp.asarray([16, 13], jnp.int32), ctx.cache_k,
        ctx.cache_v, jax.random.key(0), n_steps=4, ds=greedy, kv_window=32)
    refs["batch"] = {"first": np.asarray(tok), "scalar": np.asarray(toks),
                     "rows": np.asarray(rows)}
    # the state blob after a prefill, on sp 4 and on the batch's mesh
    for m, b in (("sp4", 1), ("d2s2t2", 2)):
        ctx = Context(cfg, params, batch=b, n_ctx=64, cache_dtype=jnp.float32, mesh=meshes[m])
        ctx.eval(np.asarray(STATE[m], np.int32))
        refs["state_" + m] = get_state(ctx)
    # the shift across sp 4's blocks, then greedy steps
    ctx = Context(cfg, params, n_ctx=64, mesh=meshes["sp4"])
    logits = np.asarray(ctx.eval(np.asarray([SHIFT_PROMPT], np.int32)))
    shift_kv_cache(ctx, *SHIFT)
    refs["shift"] = _jax_drive_from(ctx, int(logits[0, -1].argmax()), 4)
    # perplexity, f32 caches (test_torch_perplexity.py's setting)
    for m in ("sp4", "tp2"):
        ctx = Context(cfg, params, n_ctx=64, cache_dtype=jnp.float32, mesh=meshes[m])
        refs["ppl_" + m] = {
            "device": dataclasses.asdict(jp.perplexity_ondevice(ctx, _ppl_tokens(), n_ctx=64)),
            "host": dataclasses.asdict(jp.perplexity(ctx, _ppl_tokens(), n_ctx=64,
                                                     n_batch=32))}
    # the f16-table mode at sp 4, and unsharded
    tcfg = dataclasses.replace(cfg, act_f16_table=True)
    refs["f16_sp4"] = _jax_drive(Context(tcfg, params, n_ctx=64, mesh=meshes["sp4"]),
                                 SHIFT_PROMPT, 3)
    refs["f16_one"] = _jax_drive(Context(tcfg, params, n_ctx=64), SHIFT_PROMPT, 3)
    # greedy references of the speculative cases (unsharded: JAX's tests
    # hold their sharded runs to these tokens)
    refs["plain"] = generate_ondevice(Context(cfg, params, n_ctx=64), PROMPT, 16,
                                      sampling=greedy, chunk=4)
    refs["draft"] = generate_ondevice_spec_draft(
        Context(cfg, params, n_ctx=64), Context(*models["draft"], n_ctx=64), PROMPT, 16,
        sampling=greedy, n_draft=3, n_steps=2, ignore_eos=True)
    scfg, sparams = models["spec"]
    refs["spec"] = generate_ondevice_spec(
        Context(scfg, sparams), SPEC_PROMPT, 20, sampling=greedy,
        spec=SpecParams(n_draft=4), n_steps=3, ignore_eos=True)
    refs["spec_host"] = generate_speculative(
        Context(scfg, sparams), SPEC_PROMPT, 20, sampling=greedy, spec=SpecParams(n_draft=4),
        ignore_eos=True)
    refs["engine"] = []
    for p in ENGINE_PROMPTS:  # test_batch_engine_with_gspmd_sharded_params's single()
        refs["engine"].append(list(generate(Context(scfg, sparams, n_ctx=64), p, GenerateParams(
            n_predict=8, sampling=GREEDY, ignore_eos=False), eos_token=2)))
    save(out, "refs", refs)


def _jax_drive_from(ctx, tok, steps):
    outs, toks = [], [tok]
    for _ in range(steps):
        outs.append(np.asarray(ctx.eval(np.asarray([[toks[-1]]], np.int32))))
        toks.append(int(np.argmax(outs[-1][0, -1])))
    return {"logits": outs, "tokens": toks}


# ---------------------------------------------------------------- port side

def _drive(ctx, prompt, steps):
    outs = [ctx.eval(np.asarray([prompt]))]
    toks = []
    for _ in range(steps):
        toks.append(int(np.argmax(outs[-1][0, -1])))
        outs.append(ctx.eval(np.asarray([[toks[-1]]])))
    return {"logits": outs, "tokens": toks}


def _drive_from(ctx, tok, steps):
    outs, toks = [], [tok]
    for _ in range(steps):
        outs.append(ctx.eval(np.asarray([[toks[-1]]])))
        toks.append(int(np.argmax(outs[-1][0, -1])))
    return {"logits": outs, "tokens": toks}


def _hparams(cfg) -> dict:
    return {"n_vocab": cfg.n_vocab, "n_embd": cfg.n_embd, "n_mult": 32, "n_head": cfg.n_head,
            "n_layer": cfg.n_layer, "n_rot": cfg.n_rot}


def _state_round_trip(cfg, params, mesh, batch, prompt, out, tag, dt):
    """mesh -> single-device -> mesh: the blob through a CPU Context and
    back into a second mesh Context, whose next step is held to the
    uninterrupted one's bit for bit; save_session / load_session (and a
    GGSN file for one row) into a third.  All caches of dtype dt."""
    from llama_cpp_q_4_0_tpu_torch.runtime import session
    from llama_cpp_q_4_0_tpu_torch.runtime.context import Context

    ctx = Context(cfg, params, batch=batch, n_ctx=64, mesh=mesh, cache_dtype=dt)
    first = ctx.eval(np.asarray(prompt))
    blob = session.get_state(ctx)
    one = Context(cfg, params, batch=batch, n_ctx=64, device="cpu", cache_dtype=dt)
    session.set_state(one, blob)
    blob_one = session.get_state(one)
    back = Context(cfg, params, batch=batch, n_ctx=64, mesh=mesh, cache_dtype=dt)
    at = [c.data_ptr() for c in (*back.cache_k, *back.cache_v)]
    session.set_state(back, blob_one)
    nxt = first[:, -1].argmax(-1)[:, None]
    res = {"blob": blob, "size": session.get_state_size(ctx),
           "same_blob": all(np.array_equal(blob[k], blob_one[k]) for k in blob),
           "next_one": one.eval(nxt), "next_mesh": ctx.eval(nxt)}
    ctx.n_past -= 1
    path = os.path.join(out, f"session-{tag}.zip")
    session.save_session(path, ctx, [int(t) for t in np.ravel(prompt)])
    loaded = Context(cfg, params, batch=batch, n_ctx=64, mesh=mesh, cache_dtype=dt)
    res["tokens"] = session.load_session(path, loaded)
    want = ctx.eval(nxt)
    res["next_equal"] = bool(np.array_equal(back.eval(nxt), want)
                             and np.array_equal(loaded.eval(nxt), want))
    res["in_place"] = at == [c.data_ptr() for c in (*back.cache_k, *back.cache_v)]
    if batch == 1:
        gpath = os.path.join(out, f"session-{tag}.ggsn")
        session.save_session(gpath, ctx, [int(t) for t in np.ravel(prompt)],
                             hparams=_hparams(cfg))
        g_mesh = Context(cfg, params, n_ctx=64, mesh=mesh, cache_dtype=dt)
        g_one = Context(cfg, params, n_ctx=64, device="cpu", cache_dtype=dt)
        session.load_session(gpath, g_mesh)
        session.load_session(gpath, g_one)
        a, b = session.get_state(g_mesh), session.get_state(g_one)
        res["ggsn_equal"] = all(np.array_equal(a[k], b[k]) for k in a if k != "n_past")
        res["ggsn_next"] = (g_mesh.eval(nxt), g_one.eval(nxt))
    return res


def _every_method(cfg, params, dcfg, dparams, mesh, batch):
    """verify, draft_spec_chunk (the draft on the same mesh), the shift and
    perplexity_ondevice on a mesh Context and on a single-device one of the
    same params, from the same prefill: (mesh results, single-device
    results)."""
    import torch

    from llama_cpp_q_4_0_tpu_torch.runtime import perplexity, session
    from llama_cpp_q_4_0_tpu_torch.runtime.context import Context
    from llama_cpp_q_4_0_tpu_torch.runtime.device_sample import DeviceSampling, prng_key

    greedy = DeviceSampling(temp=-1.0)
    res = []
    for place in (dict(mesh=mesh), dict(device="cpu")):
        ctx = Context(cfg, params, batch=batch, n_ctx=64, **place)
        draft = Context(dcfg, dparams, batch=batch, n_ctx=64, **place)
        prompt = np.asarray(BATCH[:batch])
        last = ctx.eval(prompt)[:, -1].argmax(-1)
        draft.eval(prompt)
        drafts = np.stack([last, last[::-1], last], axis=1)
        ids, _ = ctx.verify(drafts, 12, prng_key(0, "cpu"), ds=greedy, kv_window=32)
        got = {"verify": ids}
        n = torch.full((batch,), 12)
        tok = torch.from_numpy(last)
        out_ = ctx.draft_spec_chunk(draft, tok, n, prng_key(0, "cpu"),
                                    torch.zeros(batch, dtype=torch.bool),
                                    torch.zeros((batch, 1), dtype=torch.int64), k=3, n_steps=2,
                                    ds=greedy, kv_window=64, eos=2, ignore_eos=True)
        got["draft"] = [t.numpy() for t in out_[5:]]
        ctx.n_past = 12
        session.shift_kv_cache(ctx, 2, 6)
        got["shift"] = ctx.eval(last[:, None])
        got["ppl"] = perplexity.perplexity_ondevice(ctx, _ppl_tokens(), n_ctx=64).ppl
        res.append(got)
    return res


def port_world(rank: int, out: str) -> None:
    import torch

    from llama_cpp_q_4_0_tpu_torch.parallel import make_mesh
    from llama_cpp_q_4_0_tpu_torch.parallel.tp import mesh_forward
    from llama_cpp_q_4_0_tpu_torch.runtime import perplexity as tp_
    from llama_cpp_q_4_0_tpu_torch.runtime import session
    from llama_cpp_q_4_0_tpu_torch.runtime.context import Context
    from llama_cpp_q_4_0_tpu_torch.runtime.device_sample import (DeviceSampling,
                                                                 generate_ondevice, prng_key)
    from llama_cpp_q_4_0_tpu_torch.runtime.device_spec import (generate_ondevice_spec,
                                                               generate_ondevice_spec_draft)
    from llama_cpp_q_4_0_tpu_torch.runtime.speculative import (SpecParams,
                                                               generate_speculative)
    from test_torch_tp import port_engine

    os.environ["ATTN_MXU"] = "0"
    meshes = {k: make_mesh(**v, device="cpu") for k, v in MESHES.items()}
    on = {k: m.coords is not None for k, m in meshes.items()}
    cfg, params = port_model(out, "model_q")
    dcfg, dparams = port_model(out, "model_draft")
    scfg, sparams = port_model(out, "model_spec")
    greedy = DeviceSampling(temp=-1.0)
    got = {}

    def ctx_on(m, **kw):
        return Context(cfg, params, n_ctx=64, mesh=meshes[m], **kw)

    for case, (m, chunk) in GEN.items():
        if on[m]:
            got[case] = generate_ondevice(ctx_on(m), PROMPT, 10, sampling=greedy, chunk=chunk)
    ctx = ctx_on("d2s2t2", batch=2)
    logits = ctx.eval(np.asarray(BATCH))
    tok = torch.from_numpy(logits[:, -1].argmax(-1))
    toks, _, _, _ = ctx.decode_chunk(tok, 12, prng_key(0, "cpu"), n_steps=4, ds=greedy,
                                     kv_window=32)
    rows, _, _, _ = ctx.decode_chunk(torch.from_numpy(toks[:, -1]), torch.tensor([16, 13]),
                                     prng_key(0, "cpu"), n_steps=4, ds=greedy, kv_window=32,
                                     to_host=False)
    got["batch"] = {"first": tok.numpy(), "scalar": toks, "rows": rows.numpy(),
                    "rows_on_host": isinstance(rows, torch.Tensor)}

    # sampling at temp 0.8: top-k, mirostat 2 (its mu), and a speculative chunk
    sampled = {}
    for m, b in (("sp4", 1), ("d2s2t2", 2)):
        if not on[m]:
            continue
        ctx = ctx_on(m, batch=b)
        logits = ctx.eval(np.asarray(BATCH[:b]))
        tok = torch.from_numpy(logits[:, -1].argmax(-1))
        key = prng_key(7, "cpu")
        res = {"logits": logits}
        for name, ds in (("top_k", DeviceSampling(temp=0.8, top_k=40)),
                         ("mirostat", DeviceSampling(temp=0.8, mirostat=2, mirostat_tau=4.0,
                                                     mirostat_eta=0.2))):
            toks, key, _, mu = ctx.decode_chunk(tok, ctx.n_past, key, n_steps=6, ds=ds,
                                                kv_window=32)
            ctx.n_past += 6
            tok = torch.from_numpy(toks[:, -1])
            res[name] = (toks, mu.numpy())
        hist = torch.zeros((b, 64), dtype=torch.int64)
        hist[:, :12] = torch.tensor(BATCH[:b])
        hist[:, 12] = tok
        ctx.reset()
        ctx.eval(np.asarray(BATCH[:b]))
        out_ = ctx.spec_chunk(hist, torch.full((b,), 13), prng_key(3, "cpu"),
                              torch.zeros(b, dtype=bool), k=3, n_steps=3, ds=DeviceSampling(temp=0.8, top_k=40),
                              kv_window=64, max_ngram=3, min_ngram=1, eos=2, ignore_eos=True)
        res["spec"] = [t.numpy() for t in out_[5:]]
        sampled[m] = res
    got["sampled"] = sampled

    for m, b in (("sp4", 1), ("tp2", 1), ("d2s2t2", 2)):
        if on[m]:
            # f32 caches where the blob is held to JAX's (a bf16 cache
            # rounds f32-ulp differences of K/V to bf16-ulp ones now and
            # then), bf16 at tp 2
            dt = torch.bfloat16 if m == "tp2" else torch.float32
            got["state_" + m] = _state_round_trip(cfg, params, meshes[m], b, STATE[m], out, m,
                                                  dt)
    got["every_d2s2t2"] = _every_method(cfg, params, dcfg, dparams, meshes["d2s2t2"], 2)
    if on["tp2"]:
        got["every_tp2"] = _every_method(cfg, params, dcfg, dparams, meshes["tp2"], 1)
    if on["sp4"]:
        ctx = ctx_on("sp4")
        logits = ctx.eval(np.asarray([SHIFT_PROMPT]))
        k0 = [c.data_ptr() for c in ctx.cache_k]
        session.shift_kv_cache(ctx, *SHIFT)
        n_past = ctx.n_past
        got["shift"] = _drive_from(ctx, int(logits[0, -1].argmax()), 4)
        got["shift"]["in_place"] = k0 == [c.data_ptr() for c in ctx.cache_k]
        got["shift"]["n_past"] = n_past
    for m in ("sp4", "tp2"):
        if on[m]:
            ctx = ctx_on(m, cache_dtype=torch.float32)
            got["ppl_" + m] = {
                "device": dataclasses.asdict(tp_.perplexity_ondevice(ctx, _ppl_tokens(),
                                                                    n_ctx=64)),
                "host": dataclasses.asdict(tp_.perplexity(ctx, _ppl_tokens(), n_ctx=64,
                                                          n_batch=32))}
    if on["sp4"]:
        tcfg = dataclasses.replace(cfg, act_f16_table=True)
        got["f16_sp4"] = _drive(Context(tcfg, params, n_ctx=64, mesh=meshes["sp4"]),
                                SHIFT_PROMPT, 3)
        got["draft"] = {}
        for place in ("mesh", "device"):
            dctx = (Context(dcfg, dparams, n_ctx=64, mesh=meshes["sp4"]) if place == "mesh"
                    else Context(dcfg, dparams, n_ctx=64, device="cpu"))
            got["draft"][place] = generate_ondevice_spec_draft(
                ctx_on("sp4"), dctx, PROMPT, 16, sampling=greedy, n_draft=3, n_steps=2,
                ignore_eos=True)
        try:
            ctx_on("sp4").draft_spec_chunk(
                Context(dcfg, dparams, n_ctx=64, mesh=meshes["d2s2t2"], batch=2), None, None,
                None, None, None, k=3, n_steps=1, ds=greedy, kv_window=64, eos=2,
                ignore_eos=True)
            got["draft"]["other_mesh"] = "taken"
        except ValueError as e:
            got["draft"]["other_mesh"] = str(e)
    for m in ("tp4", "sp4"):
        if on[m]:
            sctx = lambda: Context(scfg, sparams, mesh=meshes[m])
            got["spec_" + m] = generate_ondevice_spec(
                sctx(), SPEC_PROMPT, 20, sampling=greedy, spec=SpecParams(n_draft=4),
                n_steps=3, ignore_eos=True)
            got["spec_host_" + m] = generate_speculative(
                sctx(), SPEC_PROMPT, 20, sampling=greedy, spec=SpecParams(n_draft=4),
                ignore_eos=True)

    calls = []

    def wrapped(*args, **kw):
        calls.append(kw["dp_rows"])
        return mesh_forward(*args, **kw)

    prompts = [[3, 5, 7], [11, 13], [100, 90, 80, 70]]
    got["engine_default"] = port_engine(cfg, params, prompts, mesh=meshes["d2s2t2"])
    got["engine_forward_fn"] = port_engine(cfg, params, prompts, mesh=meshes["d2s2t2"],
                                           forward_fn=wrapped)
    got["engine_calls"] = sorted(set(calls))
    if on["tp4"]:
        from llama_cpp_q_4_0_tpu_torch.runtime.batch_engine import BatchEngine, Request
        from llama_cpp_q_4_0_tpu_torch.runtime.sampling import SamplingParams

        eng = BatchEngine(scfg, sparams, n_slots=2, n_ctx=64, spec_draft=3, chunk=2,
                          device_sampling=greedy, mesh=meshes["tp4"])
        reqs = [eng.submit(Request(p, n_predict=8, sampling=SamplingParams(
            temp=-1.0, top_k=0, repeat_penalty=1.0, repeat_last_n=0)))
            for p in ENGINE_PROMPTS]
        eng.start()
        try:
            got["engine_spec_tp4"] = [list(r.tokens(timeout=120)) for r in reqs]
        finally:
            eng.stop()
    save(out, f"got_{rank}", got)


# -------------------------------------------------------------------- tests

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh_serving"))
    run_jax(HERE, "jax_refs", out)
    run_world(N_RANKS, HERE, "port_world", out)
    return load(out, "refs"), [load(out, f"got_{r}") for r in range(N_RANKS)]


def _ranks(got, case):
    return [g[case] for g in got if case in g]


@pytest.mark.parametrize("case", sorted(GEN))
def test_generate_ondevice_matches_jax(world, case):
    """generate_ondevice (greedy) on a mesh Context, chunks of 2 at sp 4 and
    of 4 at tp 2: JAX's tokens on the same mesh, on every rank."""
    refs, got = world
    ranks = _ranks(got, case)
    assert len(ranks) == RANKS[GEN[case][0]]
    for g in ranks:
        assert g == refs[case], (refs[case], g)


def test_decode_chunk_batch_rows_match_jax(world):
    """decode_chunk on dp 2 x sp 2 x tp 2 with a [2] batch: a scalar n_past,
    then a position per row (row 1 three slots back), JAX's tokens on every
    rank; with to_host=False the tokens come back as a tensor."""
    refs, got = world
    want = refs["batch"]
    for g in _ranks(got, "batch"):
        for k in ("first", "scalar", "rows"):
            np.testing.assert_array_equal(g[k], want[k])
        assert g["rows_on_host"]


def test_generate_ondevice_spec_matches_jax(world):
    """generate_ondevice_spec (greedy, k 4, 3 rounds a chunk) at tp 4 and sp
    4 on the JAX speculative tests' model and prompt: the tokens of JAX's
    test_ondevice_spec_with_gspmd_sharded_params case, on every rank; so
    does the host loop generate_speculative (Context.verify over the
    mesh)."""
    refs, got = world
    for m in ("tp4", "sp4"):
        assert len(_ranks(got, "spec_" + m)) == 4
        for g in _ranks(got, "spec_" + m):
            assert g == refs["spec"], (m, refs["spec"], g)
        for g in _ranks(got, "spec_host_" + m):
            assert g == refs["spec_host"] == refs["spec"], (m, refs["spec_host"], g)


def test_generate_ondevice_spec_draft_matches_jax(world):
    """generate_ondevice_spec_draft with the target at sp 4 and a 1-layer
    draft on the same mesh, and on the mesh's device whole on every rank:
    JAX's tokens (the target's greedy ones) either way; a draft on another
    mesh is refused."""
    refs, got = world
    assert refs["draft"] == refs["plain"]
    ranks = _ranks(got, "draft")
    assert len(ranks) == 4
    for g in ranks:
        assert g["mesh"] == refs["draft"], (refs["draft"], g["mesh"])
        assert g["device"] == refs["draft"], (refs["draft"], g["device"])
        assert "share the target's mesh" in g["other_mesh"]


@pytest.mark.parametrize("mesh", ["sp4", "d2s2t2"])
def test_sampling_same_on_every_rank(world, mesh):
    """Temperature 0.8 with top-k 40, mirostat 2 (its mu) and a speculative
    chunk with top-k: every rank draws the same tokens and carries the same
    mu, because every rank's logits are the same bits and its key the
    same."""
    _, got = world
    ranks = [g["sampled"][mesh] for g in got if mesh in g["sampled"]]
    assert len(ranks) == RANKS[mesh]
    r0 = ranks[0]
    assert len(set(r0["top_k"][0].ravel().tolist())) > 1  # a draw, not an argmax run
    for g in ranks[1:]:
        assert np.array_equal(g["logits"], r0["logits"])
        for k in ("top_k", "mirostat"):
            np.testing.assert_array_equal(g[k][0], r0[k][0])
            np.testing.assert_array_equal(g[k][1], r0[k][1])
        for a, b in zip(g["spec"], r0["spec"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mesh", ["sp4", "d2s2t2"])
def test_state_blob_matches_jax(world, mesh):
    """get_state of a mesh Context (f32 caches): JAX's get_state keys and
    shapes on the same mesh (the whole [B, S, H_kv, D] caches), values at
    2e-4 of the cache's scale, the same blob on every rank."""
    refs, got = world
    want = refs["state_" + mesh]
    ranks = _ranks(got, "state_" + mesh)
    assert len(ranks) == RANKS[mesh]
    for g in ranks:
        blob = g["blob"]
        assert sorted(blob) == sorted(want)
        for k, w in want.items():
            assert np.shape(blob[k]) == np.shape(w), k
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(blob[k], w, rtol=0, atol=TOL * scale, err_msg=k)
        for k in blob:
            assert np.array_equal(blob[k], ranks[0]["blob"][k])


@pytest.mark.parametrize("mesh", ["sp4", "tp2", "d2s2t2"])
def test_state_round_trip_and_session_files(world, mesh):
    """A blob passes mesh -> single-device -> mesh unchanged, into the
    caches in place, and the next step's logits are bit for bit the
    uninterrupted mesh Context's; save_session / load_session round-trip
    the same way; a GGSN file loads into a mesh Context and a
    single-device one alike."""
    _, got = world
    for g in _ranks(got, "state_" + mesh):
        assert g["same_blob"] and g["next_equal"] and g["in_place"]
        assert g["size"] > 0
        assert g["tokens"] == [int(t) for t in np.ravel(STATE[mesh])]
        np.testing.assert_allclose(g["next_one"], g["next_mesh"], rtol=TOL, atol=TOL)
        if mesh != "d2s2t2":
            assert g["ggsn_equal"]
            a, b = g["ggsn_next"]
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def test_shift_across_sp_blocks_matches_jax(world):
    """shift_kv_cache at sp 4 with n_keep + n_discard (12) in sp rank 0's
    block and n_past (40) in rank 2's: the slots move across the ranks'
    blocks, in place; the next steps' logits at 2e-4 of JAX's and its
    greedy tokens."""
    refs, got = world
    want = refs["shift"]
    ranks = _ranks(got, "shift")
    assert len(ranks) == 4
    for g in ranks:
        assert g["in_place"] and g["n_past"] == len(SHIFT_PROMPT) - SHIFT[1]
        assert g["tokens"] == want["tokens"]
        for a, w in zip(g["logits"], want["logits"]):
            np.testing.assert_allclose(a, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mesh", ["sp4", "tp2"])
def test_perplexity_matches_jax(world, mesh):
    """perplexity_ondevice (2 chunks of n_ctx 64, f32 caches) at
    test_torch_perplexity.py's gate for it, |d ln ppl| <= 1e-4, and the host
    loop (-b 32) at its gate, 1e-5, the same counts, on every rank."""
    refs, got = world
    want = refs["ppl_" + mesh]
    ranks = _ranks(got, "ppl_" + mesh)
    assert len(ranks) == RANKS[mesh]
    for g in ranks:
        for kind, tol in (("device", 1e-4), ("host", 1e-5)):
            a, w = g[kind], want[kind]
            assert a["count"] == w["count"] == 2 * (64 - 1 - 32)
            assert abs(np.log(a["ppl"]) - np.log(w["ppl"])) <= tol, (kind, a, w)
            np.testing.assert_allclose(np.log(a["chunk_ppls"]), np.log(w["chunk_ppls"]),
                                       rtol=0, atol=tol)
        assert g["device"] == ranks[0]["device"]


def test_f16_table_over_sp_matches_jax(world):
    """act_f16_table at sp 4, a 40-token prompt over three ranks' blocks:
    the prefill (the prompt whole on every rank,
    the two-pass table softmax over the split cache) and the decode steps
    (the row max all-reduced before the table exps) at
    test_torch_families.py's gate for the mode (2e-3 absolute, argmax
    equal), against JAX's Context(mesh) and its single-device Context."""
    refs, got = world
    ranks = _ranks(got, "f16_sp4")
    assert len(ranks) == 4
    for ref in (refs["f16_sp4"], refs["f16_one"]):
        for g in ranks:
            assert g["tokens"] == ref["tokens"]
            for a, w in zip(g["logits"], ref["logits"]):
                assert np.abs(a - w).max() < 2e-3
                assert (a.argmax(-1) == w.argmax(-1)).all()


def test_engine_mesh_forward_fn(world):
    """BatchEngine(mesh=dp 2 x sp 2 x tp 2, forward_fn=) with a forward_fn
    that wraps mesh_forward: the default mesh engine's tokens, the ticks
    called with dp_rows=True and the admissions with False."""
    _, got = world
    for g in got:
        assert g["engine_forward_fn"] == g["engine_default"]
        assert all(len(t) == 6 for t in g["engine_default"])
        assert g["engine_calls"] == [False, True]


def test_engine_spec_tp4_matches_jax(world):
    """BatchEngine(mesh=dp 1 x sp 1 x tp 4, spec_draft=3, chunk=2): the
    tokens of JAX's test_batch_engine_with_gspmd_sharded_params (its single
    sessions' greedy tokens), on every rank."""
    refs, got = world
    ranks = _ranks(got, "engine_spec_tp4")
    assert len(ranks) == 4
    for g in ranks:
        assert g == refs["engine"], (refs["engine"], g)


@pytest.mark.parametrize("mesh", ["d2s2t2", "tp2"])
def test_every_method_on_mesh_matches_single_device(world, mesh):
    """verify, draft_spec_chunk with a draft on the same mesh, the shift and
    perplexity_ondevice on dp 2 x sp 2 x tp 2 (a batch of 2) and tp 2
    (sp 4 is held to JAX above): the single-device port Context's ids and
    tokens, the next step's logits at 2e-4 after the shift, |d ln ppl| <=
    1e-4, on every rank."""
    _, got = world
    ranks = _ranks(got, "every_" + mesh)
    assert len(ranks) == RANKS[mesh]
    for m, one in ranks:
        np.testing.assert_array_equal(m["verify"], one["verify"])
        for a, b in zip(m["draft"], one["draft"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(m["shift"], one["shift"], rtol=TOL, atol=TOL)
        assert abs(np.log(m["ppl"]) - np.log(one["ppl"])) <= 1e-4
