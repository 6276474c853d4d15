"""k2_roofline.sweep: the least time of a sweep's Gram contractions
(``portbench.roofline``: each distinct (universe, column set) pair's rows of
nonzero weight, the inputs read once and the outputs written once) over the
device time of the port's ``gram_*`` kernels, the pre-pass with them, in the
traced calls, in percent."""

from portbench.roofline import bound_s, k2_bytes, k2_pair

KERNELS = r"\bgram_\w*kernel"


def read(rec):
    w = rec.work.get("k2")
    if rec.trace is None or not w:
        return None
    spent = rec.trace.kernel_seconds(KERNELS)
    if spent <= 0:
        return None
    ops = sum(k2_pair(rows, p) for rows, p in w["pairs"])
    least = bound_s(k2_bytes(w["inputs"], w["pairs"], w["months"]), ops)[0]
    return 100.0 * least * rec.traced_calls / spent
