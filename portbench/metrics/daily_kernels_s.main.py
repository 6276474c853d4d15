"""daily_kernels_s.main: the program's ``factors/daily_kernels`` stage (its
StageTimer, synchronized at both ends), mean seconds a call over the window."""


def read(rec):
    return rec.stage_means.get("factors/daily_kernels")
