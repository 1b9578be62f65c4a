"""% of the card's roofline that `resample_arith_grid` reached in the traced sessions
(`roofline/resample_arith_grid.py` counts a launch's operations and bytes against the
published peaks in `harness/peaks.py`)."""

from harness import spec, trace


def read(rec):
    return trace.roofline_share(rec["sessions"],
                                spec.rooflines()["resample_arith_grid"])
