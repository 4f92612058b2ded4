"""device.idle_share: the share of the traced window, in %, in which no
device activity ran: one minus the union of the activities' intervals on
the profiler's timeline over the window."""


def read(r):
    if r.device is None or not len(r.device) or r.trace_hi <= r.trace_lo:
        return None
    starts, ends = r.device.busy()
    return 100.0 * (1.0 - float((ends - starts).sum()) / (r.trace_hi - r.trace_lo))
