"""main_path_s: the window's seconds over the main-path calls completed in it,
the wall of one warm replication; host clock, the calls back to back."""


def read(rec):
    return rec.window_s / rec.calls if rec.calls else None
