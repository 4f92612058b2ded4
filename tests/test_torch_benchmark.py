"""`benchmark-matmult` of the port on the CPU (the kernels' plain versions):
the default run, --vdot against the JAX tool's error statistics, and the read
stream with its checksum; the stream kernel against its plain version on the
card."""

import re

import numpy as np
import pytest
import torch

from llama_cpp_q_4_0_tpu_torch.cli import benchmark as bm
from llama_cpp_q_4_0_tpu_torch.cli import dispatch
from llama_cpp_q_4_0_tpu_torch.ops import stream

torch.set_num_threads(1)


@pytest.mark.parametrize("q8x", [False, True], ids=["default", "q8x"])
def test_benchmark_matmult_cpu(capsys, monkeypatch, q8x):
    """The JAX tool's own check (tests/test_tools.py), through the port's
    dispatcher, with and without the int8-activation route."""
    if q8x:
        monkeypatch.setenv("QMM_Q8X", "1")
    rc = dispatch(["benchmark-matmult", "--device", "cpu", "-i", "2", "--sizex", "256",
                   "--sizey", "256", "--sizez", "8"])
    out = capsys.readouterr().out
    assert rc == 0 and "GFLOPS" in out and "speedup" in out and "(cpu)" in out


def _vdot_stats(text):
    return [float(v) for v in re.findall(r"avg ([0-9.]+)\s+max ([0-9.]+)", text)
            for v in v]


def test_vdot_matches_the_jax_tool(capsys):
    """The 16 trials draw the same vectors from the same seed and quantize
    them with byte-identical quantizers; the quantized dot is the JAX
    use_pallas=False product (bf16 operands, f32 sums) in another summation
    order, so the printed error statistics agree to 1e-4."""
    from llama_cpp_q_4_0_tpu.cli import benchmark as jax_bm

    assert jax_bm.main(["--vdot", "-i", "1", "--sizey", "1024"]) == 0
    want = _vdot_stats(capsys.readouterr().out)
    assert bm.main(["--vdot", "-i", "1", "--sizey", "1024", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    got = _vdot_stats(out)
    assert len(got) == len(want) == 4 and "GEMV latency" in out
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_stream_cpu(capsys):
    assert bm.main(["--stream", "--stream-gib", "0.01", "-i", "1", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "GB/s" in out and "checksum ok" in out


def test_stream_checksum_and_corner():
    """Every byte summed, and the JAX kernel's output: the sum of each tile's
    [8, 128] corner (0.01 GiB in 4 MiB tiles: 128 rows, 2 tiles)."""
    rows, tile_rows = stream.stream_shape(0.01, 4)
    assert (rows, tile_rows) == (128, 64)
    buf = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (rows, stream.LANES), dtype=np.uint8))
    checksum, corner = stream.hbm_stream(buf, tile_rows)
    a = buf.numpy()
    assert int(checksum) == int(a.sum(dtype=np.int64))
    np.testing.assert_array_equal(corner.numpy(),
                                  a[:8, :128].astype(np.float32) + a[64:72, :128])
    with pytest.raises(ValueError):
        stream.hbm_stream(buf[:100], tile_rows)
    with pytest.raises(ValueError):
        stream.stream_shape(0.001, 4)


@pytest.mark.gpu
def test_stream_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rows, tile_rows = stream.stream_shape(0.25, 8)
    buf = torch.randint(0, 256, (rows, stream.LANES), dtype=torch.uint8, device="cuda")
    got, want = stream.hbm_stream(buf, tile_rows), stream.hbm_stream_plain(buf, tile_rows)
    torch.cuda.synchronize()
    assert int(got[0]) == int(want[0]) and torch.equal(got[1], want[1])
