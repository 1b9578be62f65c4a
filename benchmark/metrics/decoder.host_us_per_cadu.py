"""Host-only us per CADU written in the traced sessions: the self time of
the program's `host` spans of the decoders (the .soft read, unpacking and
dedup, FengYun's differential decode, deframe, derandomize and RS, the
.cadu writes) over its `decoder.cadus` counter."""

from harness import spans


def read(rec):
    return spans.ratio("decoder.", "host", "self_ns", "decoder.cadus", 1e-3)
