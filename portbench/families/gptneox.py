"""GPT-NeoX with the parallel residual (StableLM-Alpha): its work, its raw
weights under the names of the program's GGJT files, the program's model
built from them, and the program's serving objects."""

from __future__ import annotations

from .. import raw as rawmod
from ..shapes import Shapes
from . import common

REFERENCE = "gptneox"
ARCH = "gptneox"


def dims(conf):
    e, h, f = conf["hidden_size"], conf["num_attention_heads"], conf["intermediate_size"]
    return e, h, e // h, f, conf["vocab_size"], conf["num_hidden_layers"]


def shapes(conf) -> Shapes:
    e, h, d, f, v, n_layer = dims(conf)
    # K and V of a position, every layer: the values, and a scaled cache's
    # f32 scale a head
    value_bytes, scaled = common.CACHE_BYTES[conf["cache_type"]]
    return Shapes(
        n_layer=n_layer,
        layer_matrices=[(3 * e, e, "Q4_0"), (e, e, "Q4_0"), (f, e, "Q4_0"), (e, f, "Q4_0")],
        head_matrices=[(v, e, "Q4_0")],
        kv_bytes_per_position=2 * n_layer * (e * value_bytes + (4 * h if scaled else 0)),
        attn_ops_per_position=4 * d * h * n_layer)


def layer_names(i):
    p = f"gpt_neox.layers.{i}"
    return {"qkv": p + ".attention.query_key_value", "dense": p + ".attention.dense",
            "up": p + ".mlp.dense_h_to_4h", "down": p + ".mlp.dense_4h_to_h",
            "ln1": p + ".input_layernorm", "ln2": p + ".post_attention_layernorm"}


def raw_weights(conf, seed: int, device) -> dict:
    """Every tensor of the file, q4_0 matrices and f32 vectors, from the seed:
    the embedding and the head from one generator, each layer from its own.
    The fused QKV's group scales take the configuration's
    ``qkv_scale_range`` where it names one."""
    e, h, d, f, v, n_layer = dims(conf)
    qkv_scales = tuple(conf.get("qkv_scale_range", rawmod.SCALE_RANGE))
    out = {}
    g = rawmod.generator(seed, -1, device)
    out.update(rawmod.q4_0_matrices(g, [("gpt_neox.embed_in.weight", v, e),
                                        ("embed_out.weight", v, e)], device))
    out.update(rawmod.f32_vectors(g, [("gpt_neox.final_layer_norm.weight", e, "gain"),
                                      ("gpt_neox.final_layer_norm.bias", e, "bias")], device))
    for i in range(n_layer):
        nm = layer_names(i)
        g = rawmod.generator(seed, i, device)
        out.update(rawmod.q4_0_matrices(g, [(nm["qkv"] + ".weight", 3 * e, e),
                                            (nm["dense"] + ".weight", e, e),
                                            (nm["up"] + ".weight", f, e),
                                            (nm["down"] + ".weight", e, f)], device,
                                           scales={nm["qkv"] + ".weight": qkv_scales}))
        out.update(rawmod.f32_vectors(g, [
            (nm["ln1"] + ".weight", e, "gain"), (nm["ln1"] + ".bias", e, "bias"),
            (nm["ln2"] + ".weight", e, "gain"), (nm["ln2"] + ".bias", e, "bias"),
            (nm["qkv"] + ".bias", 3 * e, "bias"), (nm["dense"] + ".bias", e, "bias"),
            (nm["up"] + ".bias", f, "bias"), (nm["down"] + ".bias", e, "bias")], device))
    return out


def hparams(conf, n_ctx: int) -> dict:
    e, h, d, f, v, n_layer = dims(conf)
    return {"n_vocab": v, "n_ctx": n_ctx, "n_embd": e, "n_head": h, "n_layer": n_layer,
            "n_rot": int(conf["rotary_pct"] * d),
            "use_parallel_residual": int(conf["use_parallel_residual"])}


def port_model(conf, raw: dict, n_ctx: int, device):
    """(cfg, params) through the program's own loader, as ``load`` reads a
    file: ``config_from_ggjt``, ``load_transformer`` (the q4_0 repack, the
    fused QKV split into row groups, ``fuse_projections``)."""
    from llama_cpp_q_4_0_tpu_torch.models.loading import config_from_ggjt, load_transformer

    gf = common.MemGGJT(ARCH, hparams(conf, n_ctx), raw)
    cfg = config_from_ggjt(gf, n_ctx=n_ctx)
    return cfg, load_transformer(gf, cfg, device=device)


def engine(conf, cfg, params, traffic: dict, device):
    """``server --parallel N``'s engine: BatchEngine with the configuration's
    cache type (``--cache-type``), host ticks unless the mix names a chunk or
    a draft (``--parallel-chunk``, ``--parallel-draft``)."""
    from llama_cpp_q_4_0_tpu_torch.runtime.batch_engine import BatchEngine

    kw = {}
    chunk, draft = traffic.get("parallel_chunk", 1), traffic.get("parallel_draft", 0)
    if chunk > 1 or draft > 0:
        kw.update(chunk=chunk, spec_draft=draft, per_request_sampling=True)
    return BatchEngine(cfg, params, n_slots=traffic["slots"], n_ctx=traffic["n_ctx"],
                       cache_dtype=common.cache_dtype(conf), device=device, **kw)


def context(conf, cfg, params, n_ctx: int, device):
    """``main``'s Context: one row, a cache of n_ctx in the configuration's
    cache type."""
    from llama_cpp_q_4_0_tpu_torch.runtime.context import Context

    return Context(cfg, params, n_ctx=n_ctx, cache_dtype=common.cache_dtype(conf),
                   device=device)
