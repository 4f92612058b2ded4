"""The port's HF checkpoint converters (formats/convert_hf.py, cli/convert.py)
against the JAX package's, file bytes for file bytes: tiny checkpoints of
all five families written in ``tmp_path`` as a torch ``.bin``, as f32
safetensors and as bf16 safetensors, each converted to f16 and f32 (llama
also to q4_0 and q4_1 at conversion time), a GPTQ group, ``--vocab-only``,
the lazy state dict and ``detect_hf_arch``.  The bf16 safetensors runs of
the port happen in a fresh interpreter that has imported neither jax nor
ml_dtypes (numpy alone cannot hold bf16; the port reads through torch).
The state dicts carry the key names each converter reads
(tests/test_tools.py's llama checkpoint; the HF names of GPT-NeoX, Falcon,
Bonsai and RWKV v4)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from llama_cpp_q_4_0_tpu.cli import convert as jax_convert_cli
from llama_cpp_q_4_0_tpu.formats import convert_hf as jax_hf
from llama_cpp_q_4_0_tpu_torch.cli import convert as convert_cli
from llama_cpp_q_4_0_tpu_torch.cli import dispatch
from llama_cpp_q_4_0_tpu_torch.formats import convert_hf as hf
from llama_cpp_q_4_0_tpu_torch.formats.fixtures import _fake_vocab

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E, HEADS, LAYERS, FF, VOCAB = 64, 4, 2, 192, 300  # llama_n_ff(64, 64) = 192
FAMILIES = ("llama", "gptneox", "falcon", "bonsai", "rwkv")
SOURCES = ("bin", "safetensors", "safetensors-bf16")
OUTTYPES = {"llama": ("f16", "f32", "q4_0", "q4_1")}


def _config(family: str) -> dict:
    if family == "llama":
        return {"model_type": "llama", "hidden_size": E, "num_attention_heads": HEADS,
                "num_hidden_layers": LAYERS, "vocab_size": VOCAB, "intermediate_size": FF}
    if family == "gptneox":
        return {"model_type": "gpt_neox", "hidden_size": E, "num_attention_heads": HEADS,
                "num_hidden_layers": LAYERS, "vocab_size": VOCAB,
                "max_position_embeddings": 128, "rotary_pct": 0.25,
                "use_parallel_residual": False}
    if family == "falcon":  # the RW config's own names
        return {"model_type": "RefinedWebModel", "hidden_size": E, "n_head": HEADS,
                "n_layer": LAYERS, "vocab_size": VOCAB, "parallel_attn": True}
    if family == "bonsai":  # the HF names, which the converter reads second
        return {"model_type": "bonsai", "hidden_size": E, "num_attention_heads": HEADS,
                "num_hidden_layers": LAYERS, "vocab_size": VOCAB}
    return {"model_type": "rwkv", "hidden_size": E, "num_hidden_layers": LAYERS,
            "vocab_size": VOCAB, "context_length": 128, "rescale_every": 1}


def _state_dict(family: str, seed: int) -> dict:
    """An f32 state dict with the names the family's converter reads."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape, s=0.05):
        return torch.randn(*shape, generator=g) * s

    d = E // HEADS
    if family == "llama":
        sd = {"model.embed_tokens.weight": r(VOCAB, E, s=1.0),
              "model.norm.weight": 1 + r(E), "lm_head.weight": r(VOCAB, E, s=1.0)}
        for i in range(LAYERS):
            p = f"model.layers.{i}."
            sd[p + "input_layernorm.weight"] = 1 + r(E)
            sd[p + "post_attention_layernorm.weight"] = 1 + r(E)
            for nm in ("q_proj", "k_proj", "v_proj", "o_proj"):
                sd[p + f"self_attn.{nm}.weight"] = r(E, E)
            sd[p + "mlp.gate_proj.weight"] = r(FF, E)
            sd[p + "mlp.down_proj.weight"] = r(E, FF)
            sd[p + "mlp.up_proj.weight"] = r(FF, E)
        return sd
    if family == "gptneox":
        sd = {"gpt_neox.embed_in.weight": r(VOCAB, E, s=1.0),
              "gpt_neox.final_layer_norm.weight": 1 + r(E),
              "gpt_neox.final_layer_norm.bias": r(E), "embed_out.weight": r(VOCAB, E)}
        for i in range(LAYERS):
            p = f"gpt_neox.layers.{i}."
            for nm in ("input_layernorm", "post_attention_layernorm"):
                sd[p + nm + ".weight"] = 1 + r(E)
                sd[p + nm + ".bias"] = r(E)
            sd[p + "attention.query_key_value.weight"] = r(3 * E, E)
            sd[p + "attention.query_key_value.bias"] = r(1, 3 * E)  # squeezed
            sd[p + "attention.dense.weight"] = r(E, E)
            sd[p + "attention.dense.bias"] = r(E)
            sd[p + "mlp.dense_h_to_4h.weight"] = r(4 * E, E)
            sd[p + "mlp.dense_h_to_4h.bias"] = r(4 * E)
            sd[p + "mlp.dense_4h_to_h.weight"] = r(E, 4 * E)
            sd[p + "mlp.dense_4h_to_h.bias"] = r(E)
            # buffers the converter drops
            sd[p + "attention.bias"] = torch.ones(1, 1, 8, 8).tril()
            sd[p + "attention.masked_bias"] = torch.tensor(-1e9)
            sd[p + "attention.rotary_emb.inv_freq"] = r(d // 8)
        return sd
    if family in ("falcon", "bonsai"):
        sd = {"transformer.word_embeddings.weight": r(VOCAB, E, s=1.0),
              "transformer.ln_f.weight": 1 + r(E), "transformer.ln_f.bias": r(E),
              "lm_head.weight": r(VOCAB, E)}
        for i in range(LAYERS):
            p = f"transformer.h.{i}."
            sd[p + "input_layernorm.weight"] = 1 + r(E)
            sd[p + "input_layernorm.bias"] = r(E)
            sd[p + "self_attention.query_key_value.weight"] = r(E + 2 * d, E)
            sd[p + "self_attention.dense.weight"] = r(E, E)
            sd[p + "mlp.dense_h_to_4h.weight"] = r(4 * E, E)
            sd[p + "mlp.dense_4h_to_h.weight"] = r(E, 4 * E)
        return sd
    sd = {"rwkv.embeddings.weight": r(VOCAB, E, s=1.0), "rwkv.blocks.0.pre_ln.weight": 1 + r(E),
          "rwkv.blocks.0.pre_ln.bias": r(E), "rwkv.ln_out.weight": 1 + r(E),
          "rwkv.ln_out.bias": r(E), "head.weight": r(VOCAB, E)}
    for i in range(LAYERS):
        p = f"rwkv.blocks.{i}."
        for nm in ("ln1", "ln2"):
            sd[p + nm + ".weight"] = 1 + r(E)
            sd[p + nm + ".bias"] = r(E)
        sd[p + "attention.time_decay"] = r(E, s=1.0)
        sd[p + "attention.time_first"] = r(E, s=1.0)
        for nm in ("time_mix_key", "time_mix_value", "time_mix_receptance"):
            sd[p + "attention." + nm] = torch.rand(1, 1, E, generator=g)
        for nm in ("key", "value", "receptance", "output"):
            sd[p + f"attention.{nm}.weight"] = r(E, E)
        for nm in ("time_mix_key", "time_mix_receptance"):
            sd[p + "feed_forward." + nm] = torch.rand(1, 1, E, generator=g)
        sd[p + "feed_forward.key.weight"] = r(4 * E, E)
        sd[p + "feed_forward.receptance.weight"] = r(E, E)
        sd[p + "feed_forward.value.weight"] = r(E, 4 * E)
    return sd


def _gptq_group(seed: int, out_d: int, in_d: int, gs: int = 32, g_idx: bool = False):
    """A GPTQ-for-LLaMa group (tests/test_tools.py's packing): int32
    qweight [in/8, out], qzeros [groups, out/8], f32 scales [groups, out]."""
    rng = np.random.default_rng(seed)
    groups = in_d // gs
    q = rng.integers(0, 16, (out_d, in_d)).astype(np.uint8)
    scales = rng.uniform(0.01, 0.1, (groups, out_d)).astype(np.float32)
    qz = rng.integers(0, 15, (groups, out_d)).astype(np.uint8)

    def pack(nibs):
        r, c = nibs.shape
        u32 = np.zeros((r, c // 8), np.uint32)
        for j in range(8):
            u32 |= nibs[:, j::8].astype(np.uint32) << (4 * j)
        return u32.view(np.int32)

    out = {"qweight": pack(q).T.copy(), "qzeros": pack(qz), "scales": scales}
    if g_idx:
        out["g_idx"] = np.repeat(np.arange(groups, dtype=np.int32), gs)
    return out


def _write(d, sd: dict, source: str, config: dict):
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(config, f)
    if source == "bin":
        torch.save(sd, os.path.join(d, "pytorch_model.bin"))
        return
    from safetensors.torch import save_file

    if source == "safetensors-bf16":
        sd = {k: v.to(torch.bfloat16) if v.is_floating_point() else v for k, v in sd.items()}
    # two shards, as a real checkpoint comes
    names = sorted(sd)
    half = len(names) // 2
    for i, part in enumerate((names[:half], names[half:])):
        save_file({k: sd[k].contiguous() for k in part},
                  os.path.join(d, f"model-0000{i + 1}-of-00002.safetensors"))


def _convert(mod, family: str, d: str, out: str, outtype: str):
    vocab = _fake_vocab(VOCAB)
    if outtype in ("q4_0", "q4_1"):
        mod.convert_llama(d, out, vocab=vocab, outtype=outtype)
    else:
        mod.CONVERTERS[family](d, out, f16=outtype == "f16", vocab=vocab)


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


CASES = [(fam, src, ot) for fam in FAMILIES for src in SOURCES
         for ot in OUTTYPES.get(fam, ("f16", "f32"))]

# the port's converter on the bf16 checkpoints, in a fresh interpreter: it
# must neither need nor load jax or ml_dtypes
_FRESH = """
import json, sys
sys.path.insert(0, {root!r})
from llama_cpp_q_4_0_tpu_torch.formats import convert_hf as hf
from llama_cpp_q_4_0_tpu_torch.formats.fixtures import _fake_vocab
for family, d, out, outtype in json.loads(sys.argv[1]):
    vocab = _fake_vocab({vocab})
    if outtype in ("q4_0", "q4_1"):
        hf.convert_llama(d, out, vocab=vocab, outtype=outtype)
    else:
        hf.CONVERTERS[family](d, out, f16=outtype == "f16", vocab=vocab)
loaded = sorted(m for m in ("jax", "ml_dtypes") if m in sys.modules)
assert not loaded, loaded
print("fresh ok")
"""


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """Every case's checkpoint, the JAX package's output (in this process) and
    the port's (here, or for bf16 in a fresh interpreter)."""
    root = tmp_path_factory.mktemp("hf")
    outs, fresh = {}, []
    for i, fam in enumerate(FAMILIES):
        sd = _state_dict(fam, seed=i)
        for src in SOURCES:
            d = str(root / f"{fam}-{src}")
            _write(d, sd, src, _config(fam))
            for ot in OUTTYPES.get(fam, ("f16", "f32")):
                want, got = str(root / f"{fam}-{src}-{ot}.jax"), str(root / f"{fam}-{src}-{ot}.port")
                _convert(jax_hf, fam, d, want, ot)
                if src == "safetensors-bf16":
                    fresh.append([fam, d, got, ot])
                else:
                    _convert(hf, fam, d, got, ot)
                outs[fam, src, ot] = (want, got)
    res = subprocess.run([sys.executable, "-c", _FRESH.format(root=ROOT, vocab=VOCAB),
                          json.dumps(fresh)], capture_output=True, text=True, timeout=600)
    assert res.returncode == 0 and "fresh ok" in res.stdout, res.stderr[-3000:]
    return outs


@pytest.mark.parametrize("family,source,outtype", CASES,
                         ids=[f"{f}-{s}-{o}" for f, s, o in CASES])
def test_converted_file_equals_jax(converted, family, source, outtype):
    want, got = converted[family, source, outtype]
    a, b = _read(want), _read(got)
    assert len(a) == len(b) and a == b, (len(a), len(b))


def test_converted_files_load_and_differ_by_source(converted):
    """The bf16 checkpoint's files hold the bf16-rounded weights (they differ
    from the f32 checkpoint's), a llama file is the same from a .bin as from
    safetensors, and a converted llama file loads in the port and evaluates
    to finite logits."""
    import dataclasses

    from llama_cpp_q_4_0_tpu_torch.formats.ggjt import read_ggjt
    from llama_cpp_q_4_0_tpu_torch.models.loading import config_from_ggjt, load_transformer
    from llama_cpp_q_4_0_tpu_torch.runtime.context import Context

    for fam in FAMILIES:
        assert _read(converted[fam, "safetensors", "f32"][1]) != \
            _read(converted[fam, "safetensors-bf16", "f32"][1])
    # llama writes its tensors in its own order, the passthrough families in
    # the checkpoint's (the shards' sorted names here)
    assert _read(converted["llama", "safetensors", "f32"][1]) == \
        _read(converted["llama", "bin", "f32"][1])
    gf = read_ggjt(converted["llama", "safetensors-bf16", "q4_0"][1])
    cfg = dataclasses.replace(config_from_ggjt(gf, n_ctx=32), compute_dtype="float32")
    assert (cfg.n_embd, cfg.n_layer, cfg.n_ff) == (E, LAYERS, FF)
    ctx = Context(cfg, load_transformer(gf, cfg, device="cpu"), n_ctx=32, device="cpu")
    assert np.isfinite(ctx.eval(np.asarray([[1, 5, 9]]))).all()


@pytest.mark.parametrize("source", ["bin", "safetensors"])
@pytest.mark.parametrize("g_idx", [False, True], ids=["groups", "g_idx"])
def test_gptq_checkpoint_equals_jax(tmp_path, source, g_idx):
    """A llama checkpoint whose layer-0 projections are GPTQ groups (a zero
    bias among them): the synthesized dense weights convert to JAX's bytes."""
    sd = _state_dict("llama", seed=7)
    for j, nm in enumerate(("q_proj", "k_proj")):
        base = f"model.layers.0.self_attn.{nm}"
        del sd[base + ".weight"]
        for k, v in _gptq_group(j, E, E, g_idx=g_idx).items():
            sd[f"{base}.{k}"] = torch.from_numpy(v)
        sd[base + ".bias"] = torch.zeros(E)
    d = str(tmp_path / "gptq")
    _write(d, sd, source, _config("llama"))
    keys = set(hf.load_state_dict(d).keys())
    assert keys == set(jax_hf.load_state_dict(d).keys())
    assert "model.layers.0.self_attn.q_proj.weight" in keys
    assert not any(k.endswith((".qweight", ".qzeros", ".scales", ".g_idx", ".bias"))
                   for k in keys)
    for ot in ("f32", "q4_0"):
        want, got = str(tmp_path / f"{ot}.jax"), str(tmp_path / f"{ot}.port")
        _convert(jax_hf, "llama", d, want, ot)
        _convert(hf, "llama", d, got, ot)
        assert _read(want) == _read(got)


def test_gptq_dense_and_resolve_equal_jax():
    for g_idx in (False, True):
        grp = _gptq_group(3, 16, 128, g_idx=g_idx)
        kw = dict(qzeros=grp["qzeros"], g_idx=grp.get("g_idx"))
        np.testing.assert_array_equal(hf.gptq_dense(grp["qweight"], grp["scales"], **kw),
                                      jax_hf.gptq_dense(grp["qweight"], grp["scales"], **kw))
    zeros = np.random.default_rng(4).uniform(0, 0.5, (4, 16)).astype(np.float32)
    grp = _gptq_group(5, 16, 128)
    np.testing.assert_array_equal(hf.gptq_dense(grp["qweight"], grp["scales"], zeros=zeros),
                                  jax_hf.gptq_dense(grp["qweight"], grp["scales"], zeros=zeros))

    def sd():
        return {"a.qweight": grp["qweight"], "a.qzeros": grp["qzeros"],
                "a.scales": grp["scales"], "a.bias": np.zeros(16, np.float32),
                "b.weight": np.ones((2, 2), np.float32)}

    got, want = hf.resolve_gptq(sd()), jax_hf.resolve_gptq(sd())
    assert set(got) == set(want) == {"a.weight", "b.weight"}
    np.testing.assert_array_equal(got["a.weight"], want["a.weight"])


def test_lazy_state_dict_equals_jax(tmp_path):
    """Shards merged, floats (f16, bf16, f64) to f32, integers kept, lazily:
    the same keys and values as JAX's LazyStateDict."""
    from safetensors.torch import save_file

    d = tmp_path / "hf"
    d.mkdir()
    save_file({"a": torch.arange(12, dtype=torch.float16).reshape(3, 4),
               "b": torch.arange(6, dtype=torch.int32).reshape(2, 3)},
              str(d / "model-00001.safetensors"))
    save_file({"c": torch.randn(2, 2, dtype=torch.float64),
               "e": torch.randn(5, dtype=torch.bfloat16)}, str(d / "model-00002.safetensors"))
    got, want = hf.load_state_dict(str(d)), jax_hf.load_state_dict(str(d))
    assert list(got.keys()) == list(want.keys()) and len(got) == 4
    assert "a" in got and "nope" not in got
    for k, v in got.items():
        assert v.dtype == (np.int32 if k == "b" else np.float32), k
        # JAX's hands a bf16 tensor over as ml_dtypes bfloat16 (its dtype
        # kind is "V", not "f"), which _emit then widens: the same values
        np.testing.assert_array_equal(v, np.asarray(want[k], v.dtype))
    assert want["b"].dtype == np.int32 and want["a"].dtype == want["c"].dtype == np.float32
    with pytest.raises(FileNotFoundError):
        hf.load_state_dict(str(tmp_path))


@pytest.mark.parametrize("model_type,arch", [
    ("llama", "llama"), ("LlamaForCausalLM", "llama"), ("gpt_neox", "gptneox"),
    ("falcon", "falcon"), ("RefinedWeb", "falcon"), ("rwkv", "rwkv"), ("bonsai", "bonsai")])
def test_detect_hf_arch_equals_jax(tmp_path, model_type, arch):
    (tmp_path / "config.json").write_text(json.dumps({"model_type": model_type}))
    assert hf.detect_hf_arch(str(tmp_path)) == jax_hf.detect_hf_arch(str(tmp_path)) == arch


def test_detect_hf_arch_unknown_raises(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "weird"}))
    for mod in (hf, jax_hf):
        with pytest.raises(ValueError, match="cannot map"):
            mod.detect_hf_arch(str(tmp_path))


def test_permute_rope_and_n_mult_equal_jax(tmp_path):
    w = np.arange(64 * 32, dtype=np.float32).reshape(64, 32)
    np.testing.assert_array_equal(hf.permute_rope(w, 4), jax_hf.permute_rope(w, 4))
    d = str(tmp_path / "bad")
    sd = _state_dict("llama", seed=1)
    _write(d, sd, "bin", dict(_config("llama"), intermediate_size=100))  # < 2*4*64/3
    for mod in (hf, jax_hf):
        with pytest.raises(ValueError, match="n_mult"):
            mod.convert_llama(d, str(tmp_path / "x.bin"), vocab=_fake_vocab(VOCAB))


def test_vocab_only_equals_jax(tmp_path):
    a, b = str(tmp_path / "jax.bin"), str(tmp_path / "port.bin")
    jax_hf.write_vocab_only(a, _fake_vocab(VOCAB))
    hf.write_vocab_only(b, _fake_vocab(VOCAB))
    assert _read(a) == _read(b)
    from llama_cpp_q_4_0_tpu_torch.formats.ggjt import read_ggjt

    gf = read_ggjt(b, "llama")
    assert len(gf.vocab) == VOCAB and not gf.tensors
    assert gf.hparams["n_embd"] == 0 and gf.hparams["n_layer"] == 0


def _hf_tokenizer_dir(d) -> bool:
    """A word-level HF tokenizer (tokenizer.json) in d, or False when the
    ``tokenizers`` package is missing."""
    try:
        from tokenizers import Tokenizer, models
    except ImportError:
        return False
    words = ["<unk>", "<s>", "</s>"] + [f"w{i}" for i in range(40)]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tok.save(os.path.join(d, "tokenizer.json"))
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "unk_token": "<unk>"}, f)
    return True


def test_auto_vocab_equals_jax(tmp_path):
    """The vocabulary readers: with transformers installed, auto_vocab reads a
    local HF tokenizer (hf_tokenizer_vocab) to JAX's list; without
    sentencepiece and transformers, both raise ImportError (callers then pass
    vocab=).  A tokenizer.model with no sentencepiece falls through to the HF
    reader in both."""
    (tmp_path / "tokenizer.model").write_bytes(b"")
    try:
        import transformers  # noqa: F401
    except ImportError:
        for mod in (hf, jax_hf):
            with pytest.raises(ImportError):
                mod.auto_vocab(str(tmp_path), 10)
        return
    if not _hf_tokenizer_dir(str(tmp_path)):
        pytest.skip("transformers without tokenizers")
    got = hf.auto_vocab(str(tmp_path), 43)
    assert got == jax_hf.auto_vocab(str(tmp_path), 43)
    assert len(got) == 43 and got[5] == (b"w2", 0.0)


@pytest.mark.parametrize("argv", [["--outtype", "f32"], [], ["--outtype", "q4_0"],
                                  ["--vocab-only"], ["--arch", "gptneox", "--outtype", "q4_1"]],
                         ids=["f32", "f16", "q4_0", "vocab-only", "refused"])
def test_convert_cli_equals_jax(tmp_path, monkeypatch, capsys, argv):
    """The `convert` tool (registered in TOOLS) with the vocabulary readers
    standing in for a tokenizer package: the same rc, lines and bytes as
    JAX's tool; --outtype q4_* refuses a non-llama arch with rc 1."""
    for mod in (hf, jax_hf):
        monkeypatch.setattr(mod, "auto_vocab", lambda d, n: _fake_vocab(n))
    d = str(tmp_path / "hf")
    _write(d, _state_dict("llama", seed=2), "safetensors", _config("llama"))
    a, b = str(tmp_path / "jax.bin"), str(tmp_path / "port.bin")
    rc_jax = jax_convert_cli.main([d, a, *argv])
    out_jax = capsys.readouterr().out.replace(a, "OUT")
    rc = dispatch(["convert", d, b, *argv])
    out = capsys.readouterr().out.replace(b, "OUT")
    assert (rc, out) == (rc_jax, out_jax)
    if rc == 0:
        assert _read(a) == _read(b)
    else:
        assert not os.path.exists(b)
    assert convert_cli.build_parser().parse_args([d, b]).outtype == "f16"
