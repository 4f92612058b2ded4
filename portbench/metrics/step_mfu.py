"""step_mfu: the whole step's share of the chip's peak, in %: the least time
of all the window's forward work over the window's seconds.  A decode step
(a tick's row step, or a speculative round) is bounded by the larger of its
bytes at 3.35 TB/s (every weight byte once, the KV of every position its
rows attend to) and its operations at 989 TFLOP/s; an admission's prefill by
its operations (``roofline.decode_bound_s`` and ``prefill_bound_s``)."""

from portbench import roofline


def read(r):
    if r.window_s <= 0 or not (r.decode_steps or r.prefill_lengths):
        return None
    least = (roofline.decode_bound_s(r.shapes, r.decode_steps, r.decode_rows, r.kv_positions)
             + roofline.prefill_bound_s(r.shapes, r.prefill_lengths))
    return 100.0 * least / r.window_s
