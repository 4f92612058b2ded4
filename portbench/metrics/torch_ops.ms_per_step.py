"""torch_ops.ms_per_step: the device time of every kernel that is not one
of the port's own (``csrc/*.cu``), per decode step (a tick's step or a
speculative round) of the traced window, in milliseconds.  The admissions'
plain-torch kernels in the window count too."""

from portbench import roofline

PORT_KERNELS = {"gemv_kernel", "gemv_reduce_kernel", "tile_kernel", "prep_kernel",
                "q8x_quantize_kernel", "q8x_prep_kernel", "flash_prefill_kernel",
                "mha_decode_kernel", "stream_kernel", "stream_reduce_kernel"}


def read(r):
    if r.device is None or r.decode_steps <= 0:
        return None
    ns = sum(v for name, v in r.device.ns_by_name().items()
             if roofline.kernel_base(name) not in PORT_KERNELS)
    return ns / 1e6 / r.decode_steps
