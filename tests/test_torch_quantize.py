"""Host quantization and the file tools of the port against the JAX
package's (CPU): the quant-fn table (quantize, dequantize, their byte forms
and the vec_dot rows) at QK_K = 256 and 64, make_qx_quants, quantize_model
and the `quantize`, `quantize-stats`, `update` and `verify-checksums` tools.
Files are compared byte for byte, printed lines as text (timings aside),
floats as their bits."""

import hashlib

import numpy as np
import pytest
import torch

from llama_cpp_q_4_0_tpu.cli import quantize as jax_quantize_cli
from llama_cpp_q_4_0_tpu.cli import quantize_stats as jax_stats_cli
from llama_cpp_q_4_0_tpu.cli import update as jax_update_cli
from llama_cpp_q_4_0_tpu.cli import verify_checksums as jax_verify_cli
from llama_cpp_q_4_0_tpu.formats import quantize as jax_fq
from llama_cpp_q_4_0_tpu.formats.fixtures import make_llama_ggjt as jax_make_llama
from llama_cpp_q_4_0_tpu.quant import kquants as jax_kquants
from llama_cpp_q_4_0_tpu.quant import registry as jax_registry
from llama_cpp_q_4_0_tpu.quant import types as jax_types
from llama_cpp_q_4_0_tpu_torch.cli import quantize as quantize_cli
from llama_cpp_q_4_0_tpu_torch.cli import quantize_stats as stats_cli
from llama_cpp_q_4_0_tpu_torch.cli import update as update_cli
from llama_cpp_q_4_0_tpu_torch.cli import verify_checksums as verify_cli
from llama_cpp_q_4_0_tpu_torch.formats import quantize as fq
from llama_cpp_q_4_0_tpu_torch.formats.fixtures import write_legacy_ggml
from llama_cpp_q_4_0_tpu_torch.formats.ggjt import read_ggjt
from llama_cpp_q_4_0_tpu_torch.quant import kquants, registry, types
from llama_cpp_q_4_0_tpu_torch.quant.types import GGMLType

torch.set_num_threads(1)

K_TYPES = ["Q2_K", "Q3_K", "Q4_K", "Q5_K", "Q6_K", "Q8_K"]
# every type of the table at QK_K = 256, the k-quants and q8_K also at 64
CASES = [(t.name, 256) for t in registry.QUANT_FNS] + [(t, 64) for t in K_TYPES]


def _rows(n, k, seed):
    """Rows with the corner cases of the scalar loops: a row of zeros, a row
    of one repeated value, one repeated magnitude with both signs."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    w[1] = 0.0
    w[2] = 0.25
    w[3, ::2], w[3, 1::2] = 0.5, -0.5
    return w


def _same_bits(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("name,qk_k", CASES, ids=[f"{t}-{q}" for t, q in CASES])
def test_quant_fns_equal_jax(name, qk_k):
    """quantize, dequantize, quantize_bytes and dequantize_bytes: JAX's
    blocks and float32 bits, on rows with zeros and ties and on random block
    bytes."""
    t, jt = GGMLType[name], jax_types.GGMLType[name]
    tr = types.type_traits(t, qk_k)
    assert tr.type_size == jax_types.type_traits(jt, qk_k).type_size
    assert tr.block_dtype.descr == jax_types.type_traits(jt, qk_k).block_dtype.descr
    w = _rows(6, 3 * (qk_k if name in K_TYPES else 128), seed=int(t) + qk_k)
    with np.errstate(all="ignore"):
        want = jax_registry.quantize(w, jt, qk_k)
        got = registry.quantize(w, t, qk_k)
        assert got.shape == want.shape and got.tobytes() == want.tobytes()
        assert registry.quantize_bytes(w, t, qk_k) == jax_registry.quantize_bytes(w, jt, qk_k)
        _same_bits(registry.dequantize(got, t, qk_k), jax_registry.dequantize(want, jt, qk_k))
        raw = np.random.default_rng(qk_k).integers(0, 256, 5 * tr.type_size, dtype=np.uint8)
        shape = (5, tr.block_size)
        _same_bits(registry.dequantize_bytes(raw.tobytes(), t, shape, qk_k),
                   jax_registry.dequantize_bytes(raw.tobytes(), jt, shape, qk_k))


def test_quant_fns_table_equal_jax():
    """The same rows, the same activation type of each dot, the same types
    without a dot; the 64 build's types and byte sizes."""
    assert [int(t) for t in registry.QUANT_FNS] == [int(t) for t in jax_registry.QUANT_FNS]
    for t, row in registry.QUANT_FNS.items():
        jrow = jax_registry.QUANT_FNS[jax_types.GGMLType(int(t))]
        assert int(row.vec_dot_type) == int(jrow.vec_dot_type)
        assert (row.vec_dot is None) == (jrow.vec_dot is None)
    for t in GGMLType:
        jt = jax_types.GGMLType(int(t))
        assert types.is_quantized(t) == jax_types.is_quantized(jt)
        for qk_k in (256, 64):
            assert types.row_size_bytes(t, 3 * 256, qk_k) == \
                jax_types.row_size_bytes(jt, 3 * 256, qk_k)
    assert {f.name: int(b) for f, b in types.FTYPE_BASE_TYPE.items()} == \
        {f.name: int(b) for f, b in jax_types.FTYPE_BASE_TYPE.items()}
    with pytest.raises(ValueError, match="QK_K=64"):
        types.row_size_bytes(GGMLType.Q4_K, 96, 64)


DOTS = [t.name for t, row in registry.QUANT_FNS.items() if row.vec_dot is not None]


@pytest.mark.parametrize("name", DOTS)
def test_vec_dot_equal_jax(name):
    """Each row's vec_dot of weight blocks with the activation quantized by
    its quantize_row_dot: JAX's float, exactly."""
    t, jt = GGMLType[name], jax_types.GGMLType[name]
    rng = np.random.default_rng(int(t))
    w = (rng.standard_normal(1024) * 0.1).astype(np.float32)
    x = (rng.standard_normal(1024)).astype(np.float32)
    row, jrow = registry.QUANT_FNS[t], jax_registry.QUANT_FNS[jt]
    xb, yb = row.quantize_row(w), row.quantize_row_dot(x)
    assert yb.tobytes() == jrow.quantize_row_dot(x).tobytes()
    got = row.vec_dot(xb, yb)
    assert isinstance(got, float) and got == jrow.vec_dot(xb, yb)


@pytest.mark.parametrize("rmse_type", [1, 0])
def test_make_qx_quants_rmse_type(rmse_type):
    """rmse_type 1 gives JAX's scales and levels; JAX implements no other,
    and the port refuses it too."""
    x = _rows(8, 16, seed=5)
    if rmse_type != 1:
        with pytest.raises(AssertionError):
            jax_kquants.make_qx_quants(x, 16, rmse_type=rmse_type)
        with pytest.raises(NotImplementedError):
            kquants.make_qx_quants(x, 16, rmse_type=rmse_type)
        return
    with np.errstate(all="ignore"):
        for nmax in (16, 32):
            want = jax_kquants.make_qx_quants(x, nmax, rmse_type=rmse_type)
            got = kquants.make_qx_quants(x, nmax, rmse_type=rmse_type)
            for a, b in zip(got, want):
                _same_bits(a, b)
            for a, b in zip(kquants.make_qx_quants(x, nmax), got):
                _same_bits(a, b)


# ------------------------------------------------------------ quantize_model

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """f32 llama files: n_embd 256 (every row a multiple of 256) and n_embd
    128, n_ff 384 (multiples of 64 only, so k-quants need --qkk64); a q4_0
    file for the requantize rules."""
    d = tmp_path_factory.mktemp("q")
    out = {"dir": d, "f32_256": str(d / "f32_256.ggjt"), "f32_128": str(d / "f32_128.ggjt"),
           "q4_0": str(d / "q4_0.ggjt")}
    f32 = jax_types.GGMLType.F32
    jax_make_llama(out["f32_256"], n_vocab=256, n_embd=256, n_mult=256, n_head=2,
                   n_layer=2, qtype=f32, seed=1)
    jax_make_llama(out["f32_128"], n_vocab=256, n_embd=128, n_mult=64, n_head=2,
                   n_layer=2, qtype=f32, seed=2)
    jax_make_llama(out["q4_0"], n_vocab=256, n_embd=64, n_layer=1, seed=3)
    return out


def _run(mod, argv, capsys):
    """(rc, stdout, stderr) of a tool's run in this process."""
    rc = mod.run(mod.build_parser().parse_args(argv))
    out = capsys.readouterr()
    return rc, out.out, out.err


def _untimed(text):
    return [ln for ln in text.splitlines() if not ln.startswith("quantize time =")]


KQ_ENTRIES = [k for k in quantize_cli.FTYPE_MAP if "_k" in k]
QUANTIZE_CASES = [(k, False) for k in quantize_cli.FTYPE_MAP] + [(k, True) for k in KQ_ENTRIES]


@pytest.mark.parametrize("entry,qkk64", QUANTIZE_CASES,
                         ids=[f"{k}{'-qkk64' if q else ''}" for k, q in QUANTIZE_CASES])
def test_quantize_tool_writes_jax_bytes(files, entry, qkk64, capsys):
    """`quantize` for every FTYPE_MAP entry, the k-quants also with --qkk64
    (on the 128-wide file): JAX's file byte for byte and its printed lines,
    the quantize time aside."""
    assert int(quantize_cli.FTYPE_MAP[entry]) == int(jax_quantize_cli.FTYPE_MAP[entry])
    src = files["f32_128" if qkk64 else "f32_256"]
    tag = f"{entry}{'-64' if qkk64 else ''}"
    want, got = (str(files["dir"] / f"{tag}.{who}") for who in ("jax", "port"))
    flags = ["--qkk64"] if qkk64 else []
    jrc, jout, _ = _run(jax_quantize_cli, [src, want, entry, *flags], capsys)
    rc, out, _ = _run(quantize_cli, [src, got, entry, *flags], capsys)
    assert rc == jrc == 0
    assert _untimed(out.replace(got, want)) == _untimed(jout)
    with open(want, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()
    if qkk64:
        assert read_ggjt(got).qk_k == 64


def test_quantize_model_stats_equal_jax(files):
    """quantize_model's returned sizes and 16-bin histogram, and its
    progress lines, on a q5_0 file (the histogram's shifted q5 bits)."""
    src = files["f32_256"]
    jl, pl = [], []
    want = jax_fq.quantize_model(src, str(files["dir"] / "s.jax"),
                                 jax_fq.QuantizeParams(ftype=jax_types.LlamaFType.MOSTLY_Q5_0),
                                 progress=jl.append)
    got = fq.quantize_model(src, str(files["dir"] / "s.port"),
                            fq.QuantizeParams(ftype=types.LlamaFType.MOSTLY_Q5_0),
                            progress=pl.append)
    assert got == want and pl == jl and sum(got["hist"]) > 0


@pytest.mark.parametrize("name", ["Q4_0", "Q4_1", "Q5_0", "Q5_1", "Q8_0", "Q4_K"])
def test_histogram_equal_jax(name):
    """_histogram on random block bytes (every qh bit pattern of the q5
    formats): JAX's counts, its reproduced shift bug included."""
    tr = types.type_traits(GGMLType[name])
    raw = np.random.default_rng(len(name)).integers(0, 256, 64 * tr.type_size, dtype=np.uint8)
    blocks = raw.view(tr.block_dtype).reshape(8, 8)
    np.testing.assert_array_equal(fq._histogram(blocks, GGMLType[name]),
                                  jax_fq._histogram(blocks, jax_types.GGMLType[name]))


def test_quantize_refusals_equal_jax(files, capsys):
    """The 64/256 divisibility error and the refusal to requantize: JAX's
    exception and message; --allow-requantize and --leave-output-tensor
    then write JAX's bytes."""
    d = files["dir"]
    for src, argv in ((files["f32_128"], ["q4_k_s"]), (files["q4_0"], ["q8_0"])):
        errs = []
        for mod in (jax_quantize_cli, quantize_cli):
            with pytest.raises(ValueError) as e:
                _run(mod, [src, str(d / "refused"), *argv], capsys)
            errs.append(str(e.value))
        assert errs[0] == errs[1] and ("not divisible" in errs[0]
                                       or "requantizing" in errs[0]), errs
    flags = ["--allow-requantize", "--leave-output-tensor"]
    for who, mod in (("jax", jax_quantize_cli), ("port", quantize_cli)):
        assert _run(mod, [files["q4_0"], str(d / f"re.{who}"), "q8_0", *flags], capsys)[0] == 0
    assert (d / "re.jax").read_bytes() == (d / "re.port").read_bytes()
    assert read_ggjt(str(d / "re.port")).tensors["output.weight"].qtype == GGMLType.Q4_0
    assert _run(quantize_cli, [files["q4_0"], str(d / "x"), "q9_9"], capsys)[0] == 1


STATS_ARGS = [
    ("f32_256", ["-t", "q4_0", "-t", "q4_k", "-p", "--histogram"]),
    ("f32_256", ["-t", "q6_k", "-t", "q5_1", "-l", "layers\\.0", "-L", "w2", "-p"]),
    ("f32_128", ["--qkk64", "--histogram"]),
]


@pytest.mark.parametrize("src,args", STATS_ARGS, ids=["types-p-hist", "layers", "qkk64-all"])
def test_quantize_stats_prints_jax_lines(files, src, args, capsys):
    """`quantize-stats`: JAX's RMSE, max error, quantile and histogram lines
    and its stderr line, for -t, -l, -L, -p, --histogram and --qkk64 (every
    type of the table)."""
    argv = ["-m", files[src], *args]
    want = _run(jax_stats_cli, argv, capsys)
    got = _run(stats_cli, argv, capsys)
    assert got == want and want[0] == 0 and want[1].count("rmse") >= 2


@pytest.mark.parametrize("version", ["ggml", "ggmf", "ggjt64"])
def test_update_writes_jax_bytes(files, version, capsys):
    """`update` of an unversioned ggml file, a ggmf v1 file and a ggjt file
    of QK_K = 64 k-quants: JAX's ggjt bytes and printed line."""
    d = files["dir"]
    if version == "ggjt64":
        src = str(d / "q4k64.ggjt")
        _run(quantize_cli, [files["f32_128"], src, "q4_k_m", "--qkk64"], capsys)
    else:
        src = str(d / f"legacy.{version}")
        write_legacy_ggml(src, read_ggjt(files["q4_0"]), magic=version)
        assert read_ggjt(src).file_version == (0 if version == "ggml" else 1)
    want, got = str(d / f"up_{version}.jax"), str(d / f"up_{version}.port")
    jrc, jout, _ = _run(jax_update_cli, [src, want], capsys)
    rc, out, _ = _run(update_cli, [src, got], capsys)
    assert rc == jrc == 0 and out.replace(got, want) == jout
    with open(want, "rb") as a, open(got, "rb") as b:
        assert a.read() == b.read()
    gf = read_ggjt(got)
    assert gf.file_version == 4 and gf.qk_k == (64 if version == "ggjt64" else 256)


def test_verify_checksums_prints_jax_lines(tmp_path, capsys):
    """`verify-checksums`: JAX's OK / FAILED / MISSING lines, counts and rc,
    passing and failing, relative and absolute paths, --root."""
    (tmp_path / "a.bin").write_bytes(b"model a")
    (tmp_path / "b.bin").write_bytes(b"model b")
    good = hashlib.sha256(b"model a").hexdigest()
    bad = hashlib.sha256(b"something else").hexdigest()
    sums = tmp_path / "SHA256SUMS"
    other = tmp_path / "sub"
    other.mkdir()
    lines = {
        "pass": f"# comment\n\n{good.upper()}  a.bin\n"
                f"{hashlib.sha256(b'model b').hexdigest()}  {tmp_path / 'b.bin'}\n",
        "fail": f"{good}  a.bin\n{bad}  b.bin\n{good}  missing.bin\n",
    }
    for case, text in lines.items():
        sums.write_text(text)
        for root, rc in ((None, case == "fail"), (tmp_path, case == "fail"), (other, 1)):
            argv = [str(sums)] + (["--root", str(root)] if root else [])
            want = _run(jax_verify_cli, argv, capsys)
            assert _run(verify_cli, argv, capsys) == want
            assert want[0] == rc
