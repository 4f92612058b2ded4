"""The port's native host paths (native/ggjt_native.cpp) against the JAX
package's native code and the port's own numpy and Python versions: the
q4_0 repack, the q4_0 quantizer and the tokenizer, bit for bit; the call
sites that take them (the loader, ``quant.registry.quantize``,
``Tokenizer``); and a build raced by two processes.  The cases are those of
the JAX package's tests/test_native.py."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from llama_cpp_q_4_0_tpu import native as jax_native
from llama_cpp_q_4_0_tpu.quant.registry import quantize as jax_quantize
from llama_cpp_q_4_0_tpu.quant.types import GGMLType as JaxType
from llama_cpp_q_4_0_tpu_torch import native
from llama_cpp_q_4_0_tpu_torch.kernels import build as kernel_build
from llama_cpp_q_4_0_tpu_torch.quant import blockq
from llama_cpp_q_4_0_tpu_torch.quant.q4_0 import pack_q4_0 as numpy_pack
from llama_cpp_q_4_0_tpu_torch.quant.registry import quantize
from llama_cpp_q_4_0_tpu_torch.quant.types import GGMLType

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def built():
    """Both native libraries, or a skip where there is no g++.  The JAX
    package writes its library in place under a thread lock only, so a worker
    may have loaded another's half-written file when it collected the JAX
    tests: under the port's build lock, JAX's library is looked at again and,
    if it still does not load, built once more."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is missing: no native library to compare")
    with kernel_build.build_lock():
        if not jax_native.available():
            jax_native._tried = False
            if not jax_native.available():
                jax_native._build()
                jax_native._tried = False
        jax_ok = jax_native.available()
    assert native.available() and jax_ok, "g++ is present but a native library did not build"


@pytest.fixture
def no_native(monkeypatch):
    """The port with LLAMA_TPU_NO_NATIVE set: every entry point returns None."""
    monkeypatch.setenv("LLAMA_TPU_NO_NATIVE", "1")
    native.reset()
    assert not native.available()
    yield
    monkeypatch.delenv("LLAMA_TPU_NO_NATIVE")
    native.reset()
    assert native.available()


@pytest.mark.parametrize("n,k", [(8, 64), (128, 256), (96, 704)])
def test_pack_q4_0_matches_jax_and_numpy(n, k):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((n, k)) * 0.3).astype(np.float32)
    blocks = jax_quantize(w, JaxType.Q4_0)
    want_packed, want_scales = jax_native.pack_q4_0(blocks, n, k)
    calls = native.calls["pack_q4_0"]
    packed, scales = native.pack_q4_0(blocks, n, k)
    assert native.calls["pack_q4_0"] == calls + 1
    np.testing.assert_array_equal(packed, want_packed)
    np.testing.assert_array_equal(scales, want_scales)
    np_packed, np_scales = numpy_pack(blocks, n, k)
    np.testing.assert_array_equal(packed, np_packed)
    np.testing.assert_array_equal(scales, np_scales)


def test_pack_q4_0_multithreaded_deterministic():
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((256, 512)) * 0.3).astype(np.float32)
    blocks = jax_quantize(w, JaxType.Q4_0)
    a = native.pack_q4_0(blocks, 256, 512, n_threads=1)
    b = native.pack_q4_0(blocks, 256, 512, n_threads=8)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_native_tokenizer_matches_jax(tmp_path):
    from llama_cpp_q_4_0_tpu.runtime.tokenizer import Tokenizer as JaxTokenizer
    from llama_cpp_q_4_0_tpu.runtime.tokenizer import Vocab as JaxVocab
    from llama_cpp_q_4_0_tpu_torch.formats.fixtures import make_llama_ggjt
    from llama_cpp_q_4_0_tpu_torch.formats.ggjt import read_ggjt
    from llama_cpp_q_4_0_tpu_torch.runtime.tokenizer import Tokenizer, Vocab

    path = str(tmp_path / "m.bin")
    make_llama_ggjt(path, n_vocab=512, n_embd=64, n_head=4, n_layer=1)
    vocab = Vocab.from_ggjt(read_ggjt(path, "llama"))
    t_py = Tokenizer(vocab, use_native=False)
    t_nat = Tokenizer(vocab, use_native=True)
    t_default = Tokenizer(vocab)
    assert t_nat._native is not None and t_default._native is not None
    assert t_py._native is None
    t_jax = JaxTokenizer(JaxVocab(vocab.tokens, vocab.scores), use_native=True)
    assert t_jax._native is not None
    cases = [
        "hello world", "", " ", "a", "tok400 tok401", "émojis 🦙🦙 done",
        "tabs\tand\nnewlines", "x" * 500,
        bytes(range(256)).decode("latin-1"),
    ]
    for s in cases:
        calls = native.calls["tokenize"]
        nat = t_nat.tokenize(s, bos=True)
        assert native.calls["tokenize"] == calls + (1 if s else 0)
        py = t_py.tokenize(s, bos=True)
        assert py == nat == t_jax.tokenize(s, bos=True) == t_default.tokenize(s, bos=True), \
            (s[:40], py[:12], nat[:12])
        assert t_py.detokenize(py) == t_py.detokenize(nat)


def test_native_loader_fast_path(tmp_path, no_native):
    """load_tensor gives the same QTensor through the C++ repack as through
    numpy, and JAX's loader's bytes."""
    from llama_cpp_q_4_0_tpu.formats.ggjt import read_ggjt as jax_read_ggjt
    from llama_cpp_q_4_0_tpu.models.loading import load_tensor as jax_load_tensor
    from llama_cpp_q_4_0_tpu_torch.formats.fixtures import make_llama_ggjt
    from llama_cpp_q_4_0_tpu_torch.formats.ggjt import read_ggjt
    from llama_cpp_q_4_0_tpu_torch.models.loading import load_tensor

    path = str(tmp_path / "m.bin")
    make_llama_ggjt(path, n_vocab=256, n_embd=64, n_head=4, n_layer=1,
                    qtype=GGMLType.Q4_0)
    gf = read_ggjt(path, "llama")
    name = "layers.0.attention.wq.weight"
    slow = load_tensor(gf, name, "cpu")  # LLAMA_TPU_NO_NATIVE is set
    os.environ.pop("LLAMA_TPU_NO_NATIVE")
    native.reset()
    calls = native.calls["pack_q4_0"]
    fast = load_tensor(gf, name, "cpu")
    assert native.calls["pack_q4_0"] == calls + 1
    os.environ["LLAMA_TPU_NO_NATIVE"] = "1"
    want = jax_load_tensor(jax_read_ggjt(path, "llama"), name)
    assert fast.packed and slow.packed
    for t in (fast, slow):
        np.testing.assert_array_equal(t.levels_t.numpy(), np.asarray(want.levels_t))
        np.testing.assert_array_equal(t.gscale_t.numpy(), np.asarray(want.gscale_t))


@pytest.mark.parametrize("shape", [(4, 64), (33, 11008 // 86 * 32), (128, 4096)])
def test_native_quantize_q4_0_bit_exact(shape):
    """The C++ quantizer's bytes are the numpy quantizer's and JAX's native
    one's, on zero rows, subnormal scales and ties too, at any thread count;
    ``quantize`` takes it for a 2-D q4_0 input."""
    rng = np.random.default_rng(3)
    w = (rng.standard_normal(shape) * rng.uniform(0.001, 4.0)).astype(np.float32)
    w[0, :32] = 0.0
    w[1, :32] = 6e-8
    ref = blockq.quantize_q4_0(w).reshape(shape[0], -1).view(np.uint8).reshape(shape[0], -1)
    raw = native.quantize_q4_0(w)
    np.testing.assert_array_equal(raw.reshape(shape[0], -1), ref)
    np.testing.assert_array_equal(raw, jax_native.quantize_q4_0(w))
    np.testing.assert_array_equal(native.quantize_q4_0(w, n_threads=1),
                                  native.quantize_q4_0(w, n_threads=8))
    calls = native.calls["quantize_q4_0"]
    got = quantize(w, GGMLType.Q4_0)
    assert native.calls["quantize_q4_0"] == calls + 1
    assert got.dtype == blockq.quantize_q4_0(w[:1]).dtype and got.shape == (shape[0],
                                                                           shape[1] // 32)
    np.testing.assert_array_equal(got.reshape(shape[0], -1).view(np.uint8), ref)


def test_quantize_without_native_is_numpy(no_native):
    """With no library, ``quantize`` and the tokenizer take numpy and Python,
    and the entry points return None, as the JAX package's do."""
    from llama_cpp_q_4_0_tpu_torch.runtime.tokenizer import Tokenizer, Vocab

    w = np.random.default_rng(4).standard_normal((8, 128)).astype(np.float32)
    calls = dict(native.calls)
    np.testing.assert_array_equal(quantize(w, GGMLType.Q4_0), blockq.quantize_q4_0(w))
    assert native.quantize_q4_0(w) is None and native.pack_q4_0(b"", 0, 64) is None
    assert Tokenizer(Vocab([b"<unk>", b"<s>", b"</s>", b"a"], [0.0] * 4))._native is None
    assert native.calls == calls


def test_build_raced_by_two_processes(tmp_path):
    """Two processes that build at once into one directory both succeed; one
    compiles while the other waits on the build lock, no temporary file is
    left, and the library loads and quantizes as the built one does."""
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
            "from llama_cpp_q_4_0_tpu_torch.kernels import build; "
            f"build.BUILD_DIR = {str(tmp_path)!r}; "
            "build.build_all(['ggjt_native']); "
            "sys.exit(0 if not build.stale('ggjt_native') else 1)")
    procs = [subprocess.Popen([sys.executable, "-c", code]) for _ in range(2)]
    assert [p.wait(timeout=600) for p in procs] == [0, 0]
    assert sorted(os.listdir(tmp_path)) == [".build.lock", "libggjt_native.so"]
    import ctypes

    lib = ctypes.CDLL(str(tmp_path / "libggjt_native.so"))
    lib.gt_quantize_q4_0.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_void_p, ctypes.c_int]
    w = np.random.default_rng(5).standard_normal((16, 256)).astype(np.float32)
    out = np.empty((16, 8, 18), np.uint8)
    lib.gt_quantize_q4_0(w.ctypes.data, 16, 256, out.ctypes.data, 0)
    np.testing.assert_array_equal(out, native.quantize_q4_0(w))


def test_failed_build_leaves_no_temporary_file(tmp_path, monkeypatch):
    """A compiler that fails raises with its output, and its temporary
    library is removed."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    out = tmp_path / "out"
    monkeypatch.setattr(kernel_build, "BUILD_DIR", str(out))
    monkeypatch.setitem(kernel_build.SOURCES, "bad", str(bad))
    with pytest.raises(RuntimeError, match="failed"):
        kernel_build.build_all(["bad"])
    assert sorted(os.listdir(out)) == [".build.lock"]
