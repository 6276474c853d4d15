"""sweep_s: the window's seconds over the sweeps (grid calls) completed in it;
host clock, the calls back to back."""


def read(rec):
    return rec.window_s / rec.calls if rec.calls else None
