"""qmm.roofline: the quantized products' share of their roofline, in %: the
least time of the products on the kernels' gate that the traced window's
steps need (counted from the shapes and the rows served, not from
launches), over the device time of the kernels listed here, the port's
quantized-product kernels (``csrc/qmm_*.cu`` and the tile and GEMV they
share)."""

from portbench import roofline

KERNELS = {"gemv_kernel", "gemv_reduce_kernel", "tile_kernel", "prep_kernel",
           "q8x_quantize_kernel", "q8x_prep_kernel"}


def read(r):
    if r.device is None:
        return None
    ns = sum(v for name, v in r.device.ns_by_name().items()
             if roofline.kernel_base(name) in KERNELS)
    if ns <= 0:
        return None
    least = (roofline.decode_bound_s(r.shapes, r.decode_steps, r.decode_rows, r.kv_positions,
                                     gate_only=True)
             + roofline.prefill_bound_s(r.shapes, r.prefill_lengths, gate_only=True))
    return 100.0 * least / (ns / 1e9)
