"""CCSDS convolutional coding (MetOp AHRPT, METEOR LRPT, ...): the
randomized CADU bits through the k=7 r=1/2 code, the two coded bits of each
input bit one QPSK symbol (I first)."""

from harness import tx


def channel_bits(bits):
    """-> (channel bits, symbols ahead of the first CADU's first bit)."""
    return tx.conv_encode(bits), 0
