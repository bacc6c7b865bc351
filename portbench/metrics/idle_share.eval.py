"""``idle_share.eval``: the share of the traced window in which no
kernel, copy or set ran on the card, in %: 1 - the union of the device's
intervals (overlapping kernels count once) over the window's length.
Both are read under the profiler, which lengthens the device's work and
the host's alike, so the share is never below 0."""


def read(record):
    if record is None or record.kind != "eval" or not record.trace.device:
        return None
    return 100.0 * (1.0 - record.trace.busy_s() / record.trace.window_s)
