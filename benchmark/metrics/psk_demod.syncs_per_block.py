"""Host syncs with the card per `psk_demod` block in the traced sessions:
the calls of the program's `wait` spans of `psk_demod`, one sync each,
over the calls of `psk_demod.block`."""

from harness import spans


def read(rec):
    return spans.ratio("psk_demod.", "wait", "calls", "psk_demod.block",
                       1.0)
