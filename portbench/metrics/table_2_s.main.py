"""table_2_s.main: the program's ``table_2`` stage (its StageTimer,
synchronized at both ends), mean seconds a call over the window."""


def read(rec):
    return rec.stage_means.get("table_2")
