"""% of the card's roofline that `viterbi_re` reached in the traced sessions
(`roofline/viterbi_re.py` counts a launch's operations and bytes against the
published peaks in `harness/peaks.py`)."""

from harness import spec, trace


def read(rec):
    return trace.roofline_share(rec["sessions"],
                                spec.rooflines()["viterbi_re"])
