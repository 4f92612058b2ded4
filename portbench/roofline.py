"""The yardstick's arithmetic: the chip's published peaks, the least bytes and
operations of the quantized products and of attention, the work a window's
steps need, and the reading of a profiler trace.

``qmm_bytes`` and ``qmm_bound`` are copies of ``chip_smoke.py``'s (with the
operations counted once, in ``qmm_ops``); the window's bounds below are sums of
them.  Nothing here imports the program.
"""

from __future__ import annotations

import re

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16 = 989e12  # dense tensor-core bf16

# format -> (packed nibbles, group size, affine: a bias plane beside the scales)
FORMATS = {"Q4_0": (True, 32, False), "Q3_K": (True, 16, False), "Q4_K": (True, 32, True),
           "Q2_K": (True, 16, True), "Q6_K": (False, 16, False),
           "Q8_0": (False, 32, False), "Q5_K": (False, 32, True), "Q4_1": (True, 32, True),
           "Q5_0": (False, 32, False), "Q5_1": (False, 32, True)}

# a GGJT file stores each group's scale (and bias) as one fp16 value: the
# least a product has to read of its planes
FILE_PLANE_BYTES = 2


def qmm_bytes(b, n, k, fmt="Q4_0", es=4, bias=None):
    """Bytes x [b, k] @ W [k, n] in format fmt must move: x read once; the
    weight's levels (K/2 packed rows or K int8 rows, not the padding up to
    K2P), its K/g scale rows of es bytes a value (4: f32, 2: f16 or bf16)
    and, for an affine format (or a folded one: bias True), as many bias
    rows; the f32 output written once."""
    packed, g, affine = FORMATS[fmt]
    levels = (k // 2) * n if packed else k * n
    planes = (k // g) * n * es * (2 if (affine if bias is None else bias) else 1)
    return 4 * b * k + levels + planes + 4 * b * n


def qmm_ops(b, n, k):
    """The operations of x [b, k] @ W [k, n]: a multiply and an add each."""
    return 2 * b * n * k


def qmm_bound(b, n, k, fmt="Q4_0", peak=PEAK_BF16, es=4, bias=None):
    """(least ms, what bounds it) for x [b, k] @ W: qmm_bytes at the memory
    rate against qmm_ops at the peak (bf16 unless named)."""
    t_bytes = qmm_bytes(b, n, k, fmt, es, bias) / HBM_BYTES_PER_S
    t_ops = qmm_ops(b, n, k) / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# ------------------------------------------------------------- the window's work

def on_gate(n, k):
    """Whether a product's shape lies on the kernels' gate (N % 128 and K %
    256 both 0): the products the port hands to its own quantized kernels."""
    return n % 128 == 0 and k % 256 == 0


def decode_bound_s(model, steps, rows, kv_positions, gate_only=False):
    """The least seconds of ``steps`` decode steps that produce ``rows``
    tokens in all; the rows of a step are taken at their mean, rows / steps.
    Each product reads its weight's bytes once a step, at the file's planes
    (FILE_PLANE_BYTES a value): ``qmm_bytes`` and ``qmm_ops``.

    gate_only (qmm.roofline's numerator): the products on the kernels' gate
    alone, each at its own ``qmm_bound``, since each is a launch of its own.
    Otherwise (step_mfu's): the whole step at the larger of all its bytes at
    the memory rate and all its operations at the bf16 peak, attention's too:
    the K and V of every position each row attends to (kv_positions: their sum
    over the rows), each row's own K and V written, and a recurrent model's
    state read and written a row."""
    if steps <= 0:
        return 0.0
    b = rows / steps
    if gate_only:
        return steps * sum(qmm_bound(b, n, k, f, es=FILE_PLANE_BYTES)[0]
                           for n, k, f in model.every_matrix() if on_gate(n, k)) / 1e3
    mats = model.every_matrix()
    nbytes = steps * sum(qmm_bytes(b, n, k, f, FILE_PLANE_BYTES) for n, k, f in mats)
    ops = steps * sum(qmm_ops(b, n, k) for n, k, _ in mats)
    nbytes += (model.kv_bytes_per_position * (kv_positions + rows)
               + 2 * model.state_bytes_per_row * rows)
    ops += model.attn_ops_per_position * kv_positions
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_BF16)


def prefill_bound_s(model, prompt_lengths, gate_only=False):
    """The least seconds of the admissions' prefills: the operations
    (``qmm_ops``) of the layer products over every prompt token, the head's
    over each prompt's last token and causal attention's 4*D a (query, key)
    pair and head, at the bf16 peak.  No weight bytes are counted: an
    admission's products can ride on a decode step's read of the weights.
    gate_only: the products on the kernels' gate alone."""
    layer = [m for m in model.layer_matrices if not gate_only or on_gate(m[0], m[1])]
    head = [m for m in model.head_matrices if not gate_only or on_gate(m[0], m[1])]
    ops = 0.0
    for t in prompt_lengths:
        ops += model.n_layer * sum(qmm_ops(t, n, k) for n, k, _ in layer)
        ops += sum(qmm_ops(1, n, k) for n, k, _ in head)
        if not gate_only:
            ops += model.attn_ops_per_position * t * (t + 1) / 2
    return ops / PEAK_BF16


# ------------------------------------------------------------- profiler traces

class DeviceTrace:
    """The device's activities of a traced window as arrays, sorted by start:
    ``names`` (each distinct name once), ``name_id``, ``start`` and ``end``
    (ns on the device's clock).  Memory copies and sets count as device work
    too."""

    def __init__(self, names, name_id, start, end):
        order = np.argsort(start, kind="stable")
        self.names = list(names)
        self.name_id = np.asarray(name_id, dtype=np.int64)[order]
        self.start = np.asarray(start, dtype=np.int64)[order]
        self.end = np.asarray(end, dtype=np.int64)[order]

    def __len__(self):
        return len(self.start)

    def clip(self, lo, hi) -> "DeviceTrace":
        """The activities that overlap [lo, hi], cut to it."""
        keep = (self.end > lo) & (self.start < hi)
        return DeviceTrace(self.names, self.name_id[keep], np.maximum(self.start[keep], lo),
                           np.minimum(self.end[keep], hi))

    def ns_by_name(self) -> dict:
        """{name: device ns} summed over the activities."""
        ns = np.bincount(self.name_id, weights=self.end - self.start, minlength=len(self.names))
        return {n: float(v) for n, v in zip(self.names, ns) if v > 0}

    def busy(self):
        """The union of the activities' intervals: (starts, ends), sorted and
        disjoint."""
        if not len(self):
            return self.start[:0], self.end[:0]
        run = np.maximum.accumulate(self.end)
        first = np.ones(len(self), dtype=bool)
        first[1:] = self.start[1:] > run[:-1]
        idx = np.flatnonzero(first)
        last = np.append(idx[1:] - 1, len(self) - 1)
        return self.start[idx], run[last]

    def gaps(self, lo, hi):
        """The stretches of [lo, hi] in which no activity runs: (starts, ends)."""
        bs, be = self.busy()
        gs = np.concatenate([[lo], be])
        ge = np.concatenate([bs, [hi]])
        keep = ge > gs
        return gs[keep], ge[keep]


def device_trace(result) -> DeviceTrace:
    """Every device activity of a finished profile (the ``_ProfilerResult`` of
    ``torch.autograd._disable_profiler``), read straight from its events: no
    per-event host objects of the profiler's own tables, which take minutes
    for a window of millions of kernels."""
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    ids, starts, durs, names = [], [], [], {}
    for ev in result.events():
        if ev.device_type() != cuda:
            continue
        i = names.setdefault(ev.name(), len(names))
        ids.append(i)
        starts.append(ev.start_ns())
        durs.append(ev.duration_ns())
    start = np.asarray(starts, dtype=np.int64)
    return DeviceTrace(names, ids, start, start + np.asarray(durs, dtype=np.int64))


def kernel_base(name: str) -> str:
    """A device activity's function name alone, without its return type,
    namespaces, template arguments and parameters: ``void qmm::gemv_kernel<
    (anonymous namespace)::PackedGemv<32, true>, 8>(qmm::GemvArgs)`` is
    ``gemv_kernel``."""
    head = re.split(r"[<(]", name.replace("(anonymous namespace)::", ""), maxsplit=1)[0]
    head = head.split()[-1] if head.split() else name
    return head.rsplit("::", 1)[-1]
