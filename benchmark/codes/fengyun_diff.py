"""FengYun-3 AHRPT's channel coding: the randomized CADU bits through the
FengYun differential encoder into two rails, each rail its own k=7 r=1/2
code; I carries the x rail's coded bits, Q the y rail's."""

import torch

from harness import tx


def channel_bits(bits):
    """-> (channel bits, symbols ahead of the first CADU's first bit: the
    rails' leading zero, two coded symbols)."""
    x, y = tx.fengyun_diff_encode(bits)
    chan = torch.empty(4 * x.shape[0], dtype=x.dtype, device=x.device)
    chan[0::2] = tx.conv_encode(x)
    chan[1::2] = tx.conv_encode(y)
    return chan, 2


def make_recording(cfg: dict, n_samples: int, seed: int, device
                   ) -> tx.Recording:
    """`n_samples` of the configuration's QPSK downlink from `seed`."""
    return tx.make_recording(cfg, channel_bits, n_samples, seed, device)
