"""setup_s: seconds from the process's start to the window's opening (CUDA
start, library load, the cell's inputs and its warm-up calls); host clock."""


def read(rec):
    return rec.setup_s
