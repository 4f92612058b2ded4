"""utils/profiling.py and utils/compile_cache.py on the CPU, the cases of the
JAX package's tests/test_aux.py (the trace writes files, time_jit > 0) and
tests/test_batch_engine.py::test_profiling_dump (the decode step's op
histogram counts matrix ops): here the graph is the exported decode step,
where each kernel is its custom op by name."""

import glob
import os

import numpy as np
import pytest
import torch

from llama_cpp_q_4_0_tpu_torch.formats.fixtures import make_llama_ggjt
from llama_cpp_q_4_0_tpu_torch.formats.ggjt import read_ggjt
from llama_cpp_q_4_0_tpu_torch.kernels import build
from llama_cpp_q_4_0_tpu_torch.models.loading import config_from_ggjt, load_transformer
from llama_cpp_q_4_0_tpu_torch.runtime.context import Context
from llama_cpp_q_4_0_tpu_torch.utils import compile_cache, profiling

torch.set_num_threads(1)
KFOLD = "llama_cpp_q4::qmm_packed_kfold"


@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    """A 2-layer llama on the kernels' gate (n_embd 256, n_ff 768), bf16."""
    p = str(tmp_path_factory.mktemp("prof") / "llama.ggjt")
    make_llama_ggjt(p, n_vocab=256, n_embd=256, n_mult=256, n_head=4, n_layer=2)
    gf = read_ggjt(p)
    cfg = config_from_ggjt(gf, n_ctx=64)
    return Context(cfg, load_transformer(gf, cfg, device="cpu"), n_ctx=64, device="cpu")


def test_profiler_trace_cpu(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        (torch.ones((64, 64)) @ torch.ones((64, 64))).sum().item()
    files = glob.glob(str(tmp_path / "**" / "*"), recursive=True)
    assert files, "no trace artifacts written"
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def test_time_jit_hard_sync():
    ms = profiling.time_jit(lambda a, b: a @ b, (torch.ones((64, 64)), torch.ones((64, 64))),
                            iters=3)
    assert ms > 0


def test_profiling_dump(ctx):
    """The decode step's histogram: 9 K2 ops (the matrix ops of 2 fused
    layers and the head), no dense product of a weight; the text dump lists
    them with the step's bytes; the caches and n_past stay as they were."""
    hist = profiling.op_histogram(ctx)
    assert hist[KFOLD] == 9 and sum(hist.values()) > 9
    assert hist["aten::index_copy_"] == 4  # K and V of each layer, in place
    txt = profiling.dump_graph(ctx, compiled_stats=True)
    assert "nodes" in txt and KFOLD in txt and "argument_size_in_bytes" in txt
    assert "kernel ops: 9" in txt
    assert all(not c.any() for c in (*ctx.cache_k, *ctx.cache_v)) and ctx.n_past == 0
    ctx.eval(np.asarray([[1, 2, 3]]))
    assert profiling.op_histogram(ctx, n_tokens=2)[KFOLD] == 9
    assert ctx.n_past == 3


@pytest.mark.parametrize("optimized", [False, True])
def test_dump_hlo(ctx, optimized):
    code = profiling.dump_hlo(ctx, optimized=optimized)
    assert code.count("llama_cpp_q4.qmm_packed_kfold") == 9
    assert "def forward" in code


def test_compile_cache_names_the_build_dir(tmp_path, monkeypatch):
    """enable() names the directory of the kernels' and the native library's
    builds (default: the package's build/) and returns it."""
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    d = compile_cache.enable(str(tmp_path / "cache"))
    assert d == str(tmp_path / "cache") and os.path.isdir(d)
    assert build.BUILD_DIR == d and build._so_path("qmm_q4_0").startswith(d + os.sep)
    assert build._so_path("ggjt_native") == os.path.join(d, "libggjt_native.so")
    default = compile_cache.enable()
    assert default == build.DEFAULT_BUILD_DIR == build.BUILD_DIR
    assert os.path.basename(default) == "build"
    assert os.path.dirname(default) == os.path.dirname(os.path.dirname(build.__file__))
