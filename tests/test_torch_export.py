"""The exported decode step (runtime/export.py, cli/export_graph.py) and the
kernels' custom ops (ops/library.py) on the CPU.

The model is the JAX aux fixture's llama (tests/test_aux.py) at widths on the
kernels' gate (N % 128, K % 256: n_embd 256, n_ff 768), so that the bf16
step routes its matmuls to K2 and, in the int8 configuration, to K7, whose
ops the exported graph then holds.  The port's params are JAX's, carried
across as numpy (``convert.params_from_numpy``).  Every exported step is
held to JAX's ``Context.eval`` on the same weights under the same compute
dtype, switches and cache dtype: the f32 step at JAX's own export gate (rtol
= atol = 2e-4, tests/test_aux.py::test_export_graph_roundtrip), the bf16
and int8-configuration steps at the port's bf16 gate against JAX (3e-2 of
the logits' scale, tests/test_torch_model.py: on the CPU the JAX package
takes its unfolded bf16 product where the port's decode calls take the
kfold form).  Each is also held to the port's own ``Context.eval``."""

import dataclasses
import io
import json
import zipfile
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
import torch.utils._pytree as pytree

from llama_cpp_q_4_0_tpu.formats.fixtures import make_llama_ggjt
from llama_cpp_q_4_0_tpu.formats.ggjt import read_ggjt as jax_read_ggjt
from llama_cpp_q_4_0_tpu.models.loading import (config_from_ggjt as jax_config,
                                                load_transformer as jax_load)
from llama_cpp_q_4_0_tpu.ops.qtensor import QTensor as JaxQTensor
from llama_cpp_q_4_0_tpu.runtime.context import Context as JaxContext
from llama_cpp_q_4_0_tpu_torch.cli import dispatch
from llama_cpp_q_4_0_tpu_torch.convert import params_from_numpy
from llama_cpp_q_4_0_tpu_torch.models.config import ModelConfig
from llama_cpp_q_4_0_tpu_torch.ops import library, qmm
from llama_cpp_q_4_0_tpu_torch.ops.qtensor import QTensor
from llama_cpp_q_4_0_tpu_torch.quant.types import GGMLType
from llama_cpp_q_4_0_tpu_torch.runtime.context import Context
from llama_cpp_q_4_0_tpu_torch.runtime.export import (EXPORT_MAGIC, export_decode,
                                                      load_exported, trace_step)

torch.set_num_threads(1)
TOKENS = [3, 9, 27]
GATE = 2e-4  # JAX's export gate
BF16_GATE = 3e-2  # of the logits' scale: the port's bf16 gate against JAX
N_CTX = 64


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("export") / "llama.ggjt")
    make_llama_ggjt(p, n_vocab=256, n_embd=256, n_mult=256, n_head=4, n_layer=2)
    return p


def _numpy_tree(params):
    def leaf(v):
        if v is None:
            return None
        if isinstance(v, JaxQTensor):
            return {"levels_t": np.asarray(v.levels_t), "gscale_t": np.asarray(v.gscale_t),
                    "gbias_t": None if v.gbias_t is None else np.asarray(v.gbias_t),
                    "gsize": v.gsize, "qtype": int(v.qtype), "shape": tuple(v.shape),
                    "pack_zero": v.pack_zero}
        return np.asarray(v)

    return {"tok_embeddings": leaf(params.tok_embeddings),
            "blocks": [{f.name: leaf(getattr(b, f.name)) for f in dataclasses.fields(b)}
                       for b in params.blocks],
            "out_norm_w": leaf(params.out_norm_w), "out_norm_b": leaf(params.out_norm_b),
            "output": leaf(params.output)}


def _models(path, mode):
    """(JAX cfg, JAX params, port cfg, port params: JAX's carried across)."""
    gf = jax_read_ggjt(path)
    jcfg = dataclasses.replace(jax_config(gf, n_ctx=N_CTX), compute_dtype=mode)
    jp = jax_load(gf, jcfg)
    cfg = ModelConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(ModelConfig)})
    return jcfg, jp, cfg, params_from_numpy(_numpy_tree(jp), device="cpu")


def _ops(ep):
    from collections import Counter

    return Counter(n.target.name() for n in ep.graph.nodes
                   if n.op == "call_function" and hasattr(n.target, "name"))


def test_exported_step_matches_jax_context(path, tmp_path):
    """f32 compute: the exported step's logits over 3 tokens within JAX's
    gate of JAX's Context.eval on the same weights, and of the port's."""
    jcfg, jp, cfg, tp = _models(path, "float32")
    out = str(tmp_path / "step.ggtx")
    export_decode(cfg, tp, out, n_ctx=N_CTX, device="cpu", cache_dtype=torch.float32)
    m = load_exported(out)
    jctx = JaxContext(jcfg, jp, n_ctx=N_CTX, cache_dtype=np.float32)
    ctx = Context(cfg, tp, n_ctx=N_CTX, cache_dtype=torch.float32, device="cpu")
    for t in TOKENS:
        want = np.asarray(jctx.eval(np.asarray([[t]], np.int32)))
        mine = ctx.eval(np.asarray([[t]]))
        got = m.step(np.asarray([[t]]))
        gap = float(np.abs(got - mine).max())
        np.testing.assert_allclose(got, want, rtol=GATE, atol=GATE,
                                   err_msg=f"gap from the port's Context.eval {gap:.3e}")
        np.testing.assert_allclose(got, mine, rtol=GATE, atol=GATE)
    assert m.n_past == len(TOKENS)


@pytest.mark.parametrize("config", ["bf16", "int8"])
def test_exported_graph_holds_the_kernel_ops(path, tmp_path, monkeypatch, config):
    """bf16 compute on the kernels' gate: the graph holds 9 K2 ops (wqkv,
    wo, w_gateup and w_down of 2 layers, the head's row); in the int8
    configuration (QMM_Q8X=1, q8 cache) 9 K7 ops.  Replayed on the CPU (the
    ops' plain versions), its logits and its caches equal the port's
    Context.eval, and they lie within the bf16 gate of JAX's Context.eval
    under the same switches and cache dtype."""
    import jax.numpy as jnp

    cache, jcache = torch.bfloat16, jnp.bfloat16
    if config == "int8":
        monkeypatch.setenv("QMM_Q8X", "1")
        cache, jcache = torch.int8, jnp.int8
    jcfg, jp, cfg, tp = _models(path, "bfloat16")
    ep, _ = trace_step(cfg, tp, n_ctx=N_CTX, device="cpu", cache_dtype=cache)
    ops = _ops(ep)
    kernel = "llama_cpp_q4::qmm_packed_q8x" if config == "int8" else \
        "llama_cpp_q4::qmm_packed_kfold"
    assert ops[kernel] == 9, ops
    assert not [k for k in ops if k.startswith("llama_cpp_q4::") and k != kernel]
    assert not [k for k in ops if k in ("aten::mm", "aten::matmul", "aten::addmm")], ops
    out = str(tmp_path / "step.ggtx")
    export_decode(cfg, tp, out, n_ctx=N_CTX, device="cpu", cache_dtype=cache)
    m = load_exported(out)
    assert m.meta["switches"].get("QMM_Q8X") == ("1" if config == "int8" else None)
    ctx = Context(cfg, tp, n_ctx=N_CTX, cache_dtype=cache, device="cpu")
    jctx = JaxContext(jcfg, jp, n_ctx=N_CTX, cache_dtype=jcache)
    for t in TOKENS:
        want = ctx.eval(np.asarray([[t]]))
        jwant = np.asarray(jctx.eval(np.asarray([[t]], np.int32)), np.float32)
        got = m.step(np.asarray([[t]]))
        gap = float(np.abs(got - want).max())
        np.testing.assert_allclose(got, want, rtol=GATE, atol=GATE, err_msg=f"gap {gap:.3e}")
        jgap = float(np.abs(got - jwant).max())
        assert np.isfinite(got).all()
        assert jgap <= BF16_GATE * np.abs(jwant).max(), (t, jgap, np.abs(jwant).max())
    flat = pytree.tree_leaves((ctx.cache_k, ctx.cache_v))
    for a, b in zip(flat, pytree.tree_leaves((m.cache_k, m.cache_v))):
        assert torch.equal(a, b)


def test_wrong_magic_raises(tmp_path):
    bad = str(tmp_path / "bad.ggtx")
    with zipfile.ZipFile(bad, "w") as z:
        z.writestr("meta.json", json.dumps({"magic": "nope"}))
    with pytest.raises(ValueError, match="not an exported graph"):
        load_exported(bad)


def test_export_file_layout(path, tmp_path):
    """The zip holds JAX's three parts; the step carries no copy of the
    weights (they travel once, pickled)."""
    _, _, cfg, tp = _models(path, "bfloat16")
    out = str(tmp_path / "step.ggtx")
    export_decode(cfg, tp, out, n_ctx=N_CTX, n_tokens=2, device="cpu")
    with zipfile.ZipFile(out) as z:
        names = z.namelist()
        meta = json.loads(z.read("meta.json"))
        step_bytes = z.getinfo("step.pt2").file_size
        params_bytes = z.getinfo("params.pkl").file_size
    assert names == ["meta.json", "step.pt2", "params.pkl"]
    assert meta["magic"] == EXPORT_MAGIC and meta["n_tokens"] == 2
    assert meta["device"] == "cpu" and meta["cache_dtype"] == "bfloat16"
    assert ModelConfig(**meta["config"]) == cfg
    assert step_bytes < params_bytes
    m = load_exported(out)
    assert m.step(np.asarray([[1, 2]])).shape == (1, 1, cfg.n_vocab)
    with pytest.raises(ValueError, match="exported for shape"):
        m.step(np.asarray([[1]]))


def test_export_graph_cli_roundtrip(tmp_path):
    """`export-graph save` then `run` (registered in TOOLS), held to JAX's
    own `export-graph` on the same file: each step's printed argmax equal,
    its printed max logit within JAX's bf16 gate (2e-2,
    tests/test_model_runtime.py).  The file is JAX's own export fixture
    (tests/test_aux.py, n_embd 64), below the kernels' gate, so both tools
    take the bf16 product the CLI's default compute dtype gives."""
    from llama_cpp_q_4_0_tpu.cli import dispatch as jax_dispatch

    model = str(tmp_path / "m.ggjt")
    make_llama_ggjt(model, n_vocab=256, n_embd=64, n_head=4, n_layer=2)

    def steps(run, out, *extra):
        with redirect_stdout(io.StringIO()) as buf:
            assert run(["export-graph", "save", "-m", model, "-o", out, "-c", str(N_CTX),
                        *extra]) == 0
            assert run(["export-graph", "run", out, "--tokens", "3,9,27"]) == 0
        lines = [ln.split() for ln in buf.getvalue().splitlines() if ln.startswith("token ")]
        return [(int(ln[4]), float(ln[6])) for ln in lines]

    want = steps(jax_dispatch, str(tmp_path / "jax.ggtx"))
    got = steps(dispatch, str(tmp_path / "cli.ggtx"), "--device", "cpu")
    assert len(got) == len(want) == len(TOKENS)
    assert [a for a, _ in got] == [a for a, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert abs(g - w) <= 2e-2 + 2e-2 * abs(w), (got, want)


def test_pytrees_round_trip(path):
    """QTensor, Block, TransformerParams and QuantKV flatten to their tensors
    and back, and their tree spec serializes."""
    from llama_cpp_q_4_0_tpu_torch.models.transformer import init_cache

    _, _, cfg, tp = _models(path, "bfloat16")
    caches = init_cache(cfg, 1, 16, torch.int8, "cpu")
    leaves, spec = pytree.tree_flatten((tp, caches))
    assert all(isinstance(x, torch.Tensor) for x in leaves)
    back = pytree.tree_unflatten(leaves, spec)
    assert isinstance(back[0].blocks[0].wqkv, QTensor)
    assert back[0].blocks[0].wqkv.qtype == GGMLType.Q4_0
    assert pytree.treespec_loads(pytree.treespec_dumps(spec)) == spec


def _qt(qtype, n=128, k=256, seed=0):
    w = np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32) * 0.1
    return QTensor.quantize(w, qtype, device="cpu")


def _op_cases():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 256)).astype(np.float32))
    q4, q41, q8, q51 = (_qt(GGMLType.Q4_0), _qt(GGMLType.Q4_1), _qt(GGMLType.Q8_0),
                        _qt(GGMLType.Q5_1))
    assert q4.packed and q41.packed and not q8.packed and q51.gbias_t is not None
    q = torch.from_numpy(rng.standard_normal((1, 8, 4, 64)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((1, 8, 2, 64)).astype(np.float32))
    kd = torch.from_numpy(rng.integers(-127, 128, (2, 16, 2, 64)).astype(np.int8))
    ks = torch.from_numpy(rng.uniform(0.01, 0.1, (2, 16, 2)).astype(np.float32))
    q1 = torch.from_numpy(rng.standard_normal((2, 1, 4, 64)).astype(np.float32))
    pos = torch.tensor([[9], [15]])
    mask = torch.arange(16)[None, :] < torch.tensor([[10], [16]])
    return {
        "qmm_packed": (x, q4.levels_t, q4.gscale_t, 8, 32),
        "qmm_packed_kfold": (x, q4.levels_t, q4.gscale_t, 8, 32),
        "qmm_packed_q8x": (x, q4.levels_t, q4.gscale_t, 8, 32),
        "qmm_packed_bias": (x, q41.levels_t, q41.gscale_t, q41.gbias_t, q41.pack_zero, 32),
        "qmm_int8": (x, q8.levels_t, q8.gscale_t, 32),
        "qmm_int8_bias": (x, q51.levels_t, q51.gscale_t, q51.gbias_t, 32),
        "quantize_q8x": (x, 32),
        "flash_prefill": (q, kv, kv * 0.5, 0.125),
        "mha_decode": (q1, kd, ks, kd, ks, pos, mask, 0.125),
        "mha_decode/bf16": (q1, kd.to(torch.bfloat16), None, kd.to(torch.bfloat16), None, pos,
                            mask, 0.125),
    }


OP_CASES = _op_cases()


@pytest.mark.parametrize("case", list(OP_CASES))
def test_opcheck(case):
    """torch.library.opcheck of each kernel op on CPU tensors (schema, fake
    tensor, autograd registration, AOT dispatch), and its CPU implementation
    equal to the wrapper's plain route bit for bit."""
    name = case.split("/")[0]
    args = OP_CASES[case]
    res = torch.library.opcheck(library.OPS[name], args)
    assert all(v == "SUCCESS" for v in res.values()), res
    got = library.OPS[name](*args)
    wrappers = {"qmm_packed": qmm.qmm_packed, "qmm_packed_kfold": qmm.qmm_packed_kfold,
                "qmm_packed_q8x": qmm.qmm_packed_q8x}
    if name in wrappers:
        x, p, s, zero, gsize = args
        assert torch.equal(got, wrappers[name](x, p, s, zero=zero, gsize=gsize))
    assert all(t.dtype in (torch.float32, torch.int8) for t in pytree.tree_leaves(got))


def test_every_kernel_has_an_op():
    """The op table covers K1-K7 and K7's quantizer (K8, the benchmark's read
    stream, is on no model path), each op in the port's namespace."""
    assert set(library.OPS) == {"qmm_packed", "qmm_packed_kfold", "qmm_packed_bias",
                                "qmm_int8", "qmm_int8_bias", "qmm_packed_q8x", "quantize_q8x",
                                "flash_prefill", "mha_decode"}
    for name in library.OPS:
        assert hasattr(getattr(torch.ops, library.NAMESPACE), name)
