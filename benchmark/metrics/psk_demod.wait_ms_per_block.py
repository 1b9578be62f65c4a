"""ms per `psk_demod` block in the traced sessions in which the host waits
for the card: the program's `wait` spans of `psk_demod` (copies either way,
the mask pick, the SNR read, each constant copied to the card) over the
calls of `psk_demod.block`."""

from harness import spans


def read(rec):
    return spans.ratio("psk_demod.", "wait", "ns", "psk_demod.block", 1e-6)
