"""us per CADU written in the traced sessions in which the decoders' host
waits for the card: the program's `wait` spans of the decoders (copies
either way, the lock search's, the scalar reads) over its `decoder.cadus`
counter."""

from harness import spans


def read(rec):
    return spans.ratio("decoder.", "wait", "ns", "decoder.cadus", 1e-3)
