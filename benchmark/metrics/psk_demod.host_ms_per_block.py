"""Host-only ms per `psk_demod` block in the traced sessions: the self time
of the program's `host` spans of `psk_demod` (the reader's read and cs16
conversion, the int8 quantizing, the .soft write) over the calls of
`psk_demod.block`."""

from harness import spans


def read(rec):
    return spans.ratio("psk_demod.", "host", "self_ns", "psk_demod.block",
                       1e-6)
