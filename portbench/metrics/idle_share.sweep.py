"""idle_share.sweep: the share of the traced sweeps in which no
kernel, copy or set ran on the card (the profiler's device intervals, unioned
over the traced window), in percent."""


def read(rec):
    if rec.trace is None or rec.trace.window_s <= 0 or rec.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
