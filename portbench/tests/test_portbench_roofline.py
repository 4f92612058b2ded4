"""The yardstick's byte and operation counts against values worked out by
hand from each configuration's published shapes."""

import json
import os

import pytest

from portbench import families, roofline

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def conf(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def shapes(name):
    c = conf(name)
    return families.module(c["family"]).shapes(c)


def test_stablelm_weights_and_decode_bytes():
    s = shapes("stablelm-alpha-7b-q4_0")
    # 16 layers of 12 x 6144^2 (QKV 3E, dense E, up 4E, down 4E) and the
    # 50432 x 6144 head
    assert s.weights() == 16 * 12 * 6144 ** 2 + 50432 * 6144 == 7_557_611_520
    # at b = 1: 9/16 of a byte a weight (nibbles and an fp16 scale a 32-group),
    # x read and the f32 output written (4 bytes an element)
    per_layer_io = 4 * ((6144 + 18432) + (6144 + 6144) + (6144 + 24576) + (24576 + 6144))
    io = 16 * per_layer_io + 4 * (6144 + 50432)
    assert io == 6_517_760
    least = roofline.decode_bound_s(s, steps=1, rows=1, kv_positions=0, gate_only=True)
    assert least == pytest.approx((7_557_611_520 * 9 // 16 + io) / 3.35e12, rel=1e-12)
    assert least * 1e3 == pytest.approx(1.27095, abs=1e-5)


def test_stablelm_gate_bound_of_a_tick():
    """qmm.roofline's numerator over two 32-row steps: each product's own
    bound, bytes at b = 32 (x and the output 32 times, the weights once)."""
    s = shapes("stablelm-alpha-7b-q4_0")
    want = 2 * (7_557_611_520 * 9 // 16 + 32 * 6_517_760) / 3.35e12
    got = roofline.decode_bound_s(s, steps=2, rows=64, kv_positions=10_000, gate_only=True)
    assert got == pytest.approx(want, rel=1e-12)


def test_stablelm_decode_with_its_cache():
    s = shapes("stablelm-alpha-7b-q4_0")
    # K and V of one position: 2 x 16 layers x 6144 x 2 bytes (bf16)
    assert s.kv_bytes_per_position == 393_216
    # a row at position 1000 reads 1000 cached positions and writes its own
    want = (4_251_156_480 + 6_517_760 + 393_216 * 1001) / 3.35e12
    got = roofline.decode_bound_s(s, steps=1, rows=1, kv_positions=1000)
    assert got == pytest.approx(want, rel=1e-12)
    assert got * 1e3 == pytest.approx(1.38844, abs=1e-5)


def test_stablelm_prefill_operations():
    s = shapes("stablelm-alpha-7b-q4_0")
    per_token = 2 * 16 * 452_984_832  # the layer products of one token
    head = 2 * 50432 * 6144  # the head over the last token
    attn = 4 * 128 * 48 * 16 * (512 * 513 // 2)  # causal pairs, every head and layer
    want = (per_token * 512 + head + attn) / 989e12
    assert roofline.prefill_bound_s(s, [512]) == pytest.approx(want, rel=1e-12)
    assert want * 1e3 == pytest.approx(7.5571, abs=1e-4)


def test_chip_smoke_gptneox_decode_bound():
    """The copy of qmm_bound reproduces chip_smoke's GPT-NeoX bound (PERF.md:
    1.4122 ms), taken there over the program's f32 planes and the synthetic
    50688-row vocabulary, a sum of one qmm_bound a product at b = 1."""
    s = shapes("stablelm-alpha-7b-q4_0")
    mats = s.layer_matrices * 16 + [(50688, 6144, "Q4_0")]
    assert sum(roofline.qmm_bytes(1, n, k, f) for n, k, f in mats) == 4_731_009_024
    dec_ms = sum(roofline.qmm_bound(1, n, k, f)[0] for n, k, f in mats)
    assert dec_ms == pytest.approx(1.4122, abs=1e-4)
    assert {roofline.qmm_bound(1, n, k, f)[1] for n, k, f in mats} == {"bytes"}


def test_rwkv_decode_bound_and_state():
    s = shapes("rwkv-4-pile-7b-q4_0")
    # 32 layers of 13 x 4096^2 (key, value, receptance, output; the channel
    # mix's key 4E, receptance E, value 4E) and the 50277 x 4096 head
    assert s.weights() == 32 * 13 * 4096 ** 2 + 50277 * 4096 == 7_185_256_448
    mats = s.every_matrix()
    assert sum(roofline.qmm_bytes(1, n, k, f) for n, k, f in mats) == 4_501_488_532
    dec_ms = sum(roofline.qmm_bound(1, n, k, f)[0] for n, k, f in mats)
    assert dec_ms == pytest.approx(1.3437, abs=1e-4)  # PERF.md's RWKV bound, f32 planes
    # the recurrent state: 5 f32 vectors of 4096 a layer
    assert s.state_bytes_per_row == 5 * 4 * 4096 * 32
    # the head is off the kernels' gate (50277 % 128 != 0): not in qmm.roofline
    assert not roofline.on_gate(50277, 4096) and roofline.on_gate(50432, 6144)
    gate = roofline.decode_bound_s(s, 1, 1, 0, gate_only=True)
    io = 32 * 4 * ((4096 + 4096) * 4 + (4096 + 16384) + (4096 + 4096) + (16384 + 4096))
    assert gate == pytest.approx((32 * 13 * 4096 ** 2 * 9 // 16 + io) / 3.35e12, rel=1e-12)


def test_rwkv_prefill_has_no_attention():
    s = shapes("rwkv-4-pile-7b-q4_0")
    want = (2 * 32 * 13 * 4096 ** 2 * 300 + 2 * 50277 * 4096) / 989e12
    assert roofline.prefill_bound_s(s, [300]) == pytest.approx(want, rel=1e-12)


def test_busy_union_and_gaps():
    t = roofline.DeviceTrace(["a", "b", "c"], [0, 1, 2, 2], [30, 0, 5, 35], [40, 10, 20, 36])
    t = t.clip(2, 38)
    starts, ends = t.busy()
    assert list(zip(starts.tolist(), ends.tolist())) == [(2, 20), (30, 38)]
    gs, ge = t.gaps(2, 38)
    assert list(zip(gs.tolist(), ge.tolist())) == [(20, 30)]
    assert t.ns_by_name() == {"a": 8.0, "b": 8.0, "c": 16.0}


def test_breakdown_names_each_gap_by_its_samples():
    from portbench import harness

    t = roofline.DeviceTrace(["void k1<1>(int)", "k2"], [0, 1, 0], [0, 50, 100], [10, 60, 130])
    # host samples, on the host's clock (here the device's too: offset 0)
    samples = [(12, "x"), (15, "x"), (18, "y"), (70, "y"), (80, "y"), (90, "x")]
    ops, idle, busy = harness.breakdown(t.clip(0, 140), samples, 0, 0, 140)
    assert ops == [["k1<1>(int)", 40e-9], ["k2", 10e-9]]
    # gaps: 10-50 (x twice, y once: x), 60-100 (y twice, x once: y), 130-140 (none)
    assert idle == [["x", 40e-9], ["y", 40e-9], ["between host samples (< 1 ms)", 10e-9]]
    assert busy == pytest.approx(50e-9)


@pytest.mark.parametrize("name,base", [
    ("void qmm::gemv_kernel<(anonymous namespace)::PackedGemv<32, true>, 8>(qmm::GemvArgs)",
     "gemv_kernel"),
    ("void qmm::tile::tile_kernel<256, (anonymous namespace)::PackedDeq<32, true> >(CUtensorMap)",
     "tile_kernel"),
    ("void (anonymous namespace)::flash_prefill_kernel<128>(Args)", "flash_prefill_kernel"),
    ("void at::native::elementwise_kernel<128, 4>(int)", "elementwise_kernel"),
    ("Memcpy DtoH (Device -> Pinned)", "DtoH"),
])
def test_kernel_base_names_the_function(name, base):
    """The readers tell the port's kernels from plain torch's by the bare
    function name, whatever the namespace and template arguments."""
    assert roofline.kernel_base(name) == base
