"""CCSDS convolutional coding (MetOp AHRPT, METEOR LRPT, ...): the
randomized CADU bits through the k=7 r=1/2 code, the two coded bits of each
input bit one QPSK symbol (I first)."""

from harness import tx


def channel_bits(bits):
    """-> (channel bits, symbols ahead of the first CADU's first bit)."""
    return tx.conv_encode(bits), 0


def make_recording(cfg: dict, n_samples: int, seed: int, device
                   ) -> tx.Recording:
    """`n_samples` of the configuration's QPSK downlink from `seed`."""
    return tx.make_recording(cfg, channel_bits, n_samples, seed, device)
