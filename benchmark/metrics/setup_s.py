"""Seconds from the harness's first line to the window's start: imports, the
card, the kernels' load (their build in a fresh checkout), the recording
made from the seed, and the warm-up of the cell's own shapes."""


def read(rec):
    return rec["setup_s"]
