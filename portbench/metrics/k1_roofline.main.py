"""k1_roofline.main: the least time of the main path's rolling reductions
(``portbench.roofline.k1_rolling`` over the values each one needs) over the
device time of the port's rolling kernels in the traced calls, in percent."""

from portbench.roofline import bound_s, k1_rolling

KERNELS = r"rolling_reduce_kernel"


def read(rec):
    if rec.trace is None or not rec.work.get("k1_elements"):
        return None
    spent = rec.trace.kernel_seconds(KERNELS)
    if spent <= 0:
        return None
    least = sum(bound_s(*k1_rolling(e))[0] for e in rec.work["k1_elements"])
    return 100.0 * least * rec.traced_calls / spent
