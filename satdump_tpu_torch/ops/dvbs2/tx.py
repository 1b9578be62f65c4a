"""DVB-S2 transmit chain (test/simulation fixture): TS -> BBFrames ->
BCH -> LDPC -> interleave -> constellation map -> PLFRAME assembly
(header + pilots + PL scrambling).

This is the loopback counterpart of the receive chain; reference has no
single TX path (its dvbs2 plugin is RX-only), so this follows EN 302 307-1
5.1-5.5 directly.
"""

from __future__ import annotations

import numpy as np

from satdump_tpu_torch.ops.dvbs2 import bbframe as bb
from satdump_tpu_torch.ops.dvbs2 import defs
from satdump_tpu_torch.ops.dvbs2.bch import get_bch
from satdump_tpu_torch.ops.dvbs2.demap import interleave, modulate
from satdump_tpu_torch.ops.dvbs2.ldpc import IRAEncoder
from satdump_tpu_torch.ops.dvbs2.scrambling import bb_derandomize, pl_scramble

PILOT_SYMBOL = complex(1 / np.sqrt(2), 1 / np.sqrt(2))


def bbframes_to_symbols(frames: np.ndarray, modcod: int, shortframes: bool,
                        pilots: bool) -> np.ndarray:
    """(B, kbch/8) unscrambled BBFrames -> (B, plframe_len) symbols."""
    cfg = defs.get_modcod_cfg(modcod, shortframes, pilots)
    bch = get_bch(cfg.frame, cfg.rate)
    enc = IRAEncoder(cfg.frame, cfg.rate)
    frames = np.asarray(frames, np.uint8).reshape(-1, bch.kbch // 8)
    scrambled = bb_derandomize(frames)
    bits = np.unpackbits(scrambled, axis=-1)
    nbch_bits = bch.encode(bits)                       # (B, nbch)
    assert nbch_bits.shape[-1] == enc.K
    cw = enc.encode(nbch_bits)                         # (B, N)
    cw = interleave(cw, cfg.constellation, cfg.rate)
    syms = modulate(cw, cfg.constellation, cfg.g1, cfg.g2)  # (B, slots*90)
    assert syms.shape[-1] == cfg.slots * defs.SLOT

    # assemble payload with pilots, scramble, prepend header
    mask = defs.payload_data_mask(cfg)
    B = syms.shape[0]
    payload = np.full((B, mask.size), PILOT_SYMBOL, np.complex64)
    payload[:, mask] = syms
    payload = pl_scramble(payload)

    header = np.concatenate(
        [defs.sof_symbols(), defs.pls_symbols()[defs.pls_index(cfg)]])
    out = np.concatenate(
        [np.broadcast_to(header, (B, defs.HDR_LEN)), payload], axis=-1)
    return out.astype(np.complex64)


def ts_to_symbols(ts: np.ndarray, modcod: int, shortframes: bool,
                  pilots: bool) -> np.ndarray:
    """188-byte TS packets -> contiguous PLFRAME symbol stream (1 sps)."""
    cfg = defs.get_modcod_cfg(modcod, shortframes, pilots)
    kbch = get_bch(cfg.frame, cfg.rate).kbch
    frames = bb.ts_to_bbframes(ts, kbch)
    return bbframes_to_symbols(frames, modcod, shortframes, pilots).ravel()
