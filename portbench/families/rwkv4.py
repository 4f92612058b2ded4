"""RWKV v4 (RWKV-4-Pile): its work, its raw weights under the names of
rwkv.cpp's files, the program's model built from them, and the program's
serving objects."""

from __future__ import annotations

from .. import raw as rawmod
from ..shapes import Shapes
from . import common

REFERENCE = "rwkv4"
ARCH = "rwkv"
STATE_VECTORS = 5  # ff_prev, attn_prev, num, den, max: f32 [E] each, a layer


def dims(conf):
    return conf["n_embd"], conf["ffn_size"], conf["vocab_size"], conf["n_layer"]


def shapes(conf) -> Shapes:
    e, f, v, n_layer = dims(conf)
    return Shapes(
        n_layer=n_layer,
        layer_matrices=[(e, e, "Q4_0")] * 4 + [(f, e, "Q4_0"), (e, e, "Q4_0"), (e, f, "Q4_0")],
        head_matrices=[(v, e, "Q4_0")],
        state_bytes_per_row=STATE_VECTORS * 4 * e * n_layer)


def raw_weights(conf, seed: int, device) -> dict:
    e, f, v, n_layer = dims(conf)
    out = {}
    g = rawmod.generator(seed, -1, device)
    out.update(rawmod.q4_0_matrices(g, [("rwkv.embeddings.weight", v, e),
                                        ("head.weight", v, e)], device))
    out.update(rawmod.f32_vectors(g, [
        ("rwkv.blocks.0.pre_ln.weight", e, "gain"), ("rwkv.blocks.0.pre_ln.bias", e, "bias"),
        ("rwkv.ln_out.weight", e, "gain"), ("rwkv.ln_out.bias", e, "bias")], device))
    for i in range(n_layer):
        p = f"rwkv.blocks.{i}"
        att, ff = p + ".attention.", p + ".feed_forward."
        g = rawmod.generator(seed, i, device)
        out.update(rawmod.q4_0_matrices(g, [
            (att + "key.weight", e, e), (att + "value.weight", e, e),
            (att + "receptance.weight", e, e), (att + "output.weight", e, e),
            (ff + "key.weight", f, e), (ff + "receptance.weight", e, e),
            (ff + "value.weight", e, f)], device))
        out.update(rawmod.f32_vectors(g, [
            (p + ".ln1.weight", e, "gain"), (p + ".ln1.bias", e, "bias"),
            (p + ".ln2.weight", e, "gain"), (p + ".ln2.bias", e, "bias"),
            (att + "time_mix_key", e, "mix"), (att + "time_mix_value", e, "mix"),
            (att + "time_mix_receptance", e, "mix"), (att + "time_first", e, "first"),
            (att + "time_decay", e, "decay"), (ff + "time_mix_key", e, "mix"),
            (ff + "time_mix_receptance", e, "mix")], device))
    return out


def hparams(conf, n_ctx: int) -> dict:
    e, f, v, n_layer = dims(conf)
    return {"n_vocab": v, "n_ctx": n_ctx, "n_embd": e, "n_layer": n_layer,
            "rescale_every": conf["rescale_every"]}


def port_model(conf, raw: dict, n_ctx: int, device):
    """(cfg, params) through the program's own loader: ``config_from_ggjt``
    and ``load_rwkv`` (each q4_0 matrix by the direct repack)."""
    from llama_cpp_q_4_0_tpu_torch.models.loading import config_from_ggjt, load_rwkv

    gf = common.MemGGJT(ARCH, hparams(conf, n_ctx), raw)
    cfg = config_from_ggjt(gf, n_ctx=n_ctx)
    return cfg, load_rwkv(gf, cfg, device=device)


def engine(conf, cfg, params, traffic: dict, device):
    """``server --parallel N``'s RWKV engine: RwkvBatchEngine with the
    server's chunk (at least 4) and draft (5 unless the mix names one), each
    request sampled with its own settings."""
    from llama_cpp_q_4_0_tpu_torch.runtime.rwkv_engine import RwkvBatchEngine

    return RwkvBatchEngine(cfg, params, n_slots=traffic["slots"], n_ctx=traffic["n_ctx"],
                           chunk=max(traffic.get("parallel_chunk", 1), 4),
                           spec_draft=traffic.get("parallel_draft", 0) or 5,
                           per_request_sampling=True, device=device)


def context(conf, cfg, params, n_ctx: int, device):
    """``load``'s RwkvContext: one row."""
    from llama_cpp_q_4_0_tpu_torch.runtime.context import RwkvContext

    return RwkvContext(cfg, params, device=device)
