"""Convolutional k=7 r=1/2 codec: encoder + batched soft Viterbi decoder.

Port of satdump_tpu/ops/fec/convolutional.py. Conventions match the
reference (src-core/common/codings/viterbi/cc_decoder.cpp): polynomials
{79, 109}, state = last K-1 input bits with the newest in the LSB, soft
symbols as values in [0, 255] where 0/255 are confident and 128 is an
erasure.

The encoders are host numpy (copied). The block decoder (`viterbi_acs`,
`viterbi_traceback` and what is built on them: `viterbi_decode_block`,
`viterbi_decode_tiled`, `StreamViterbi`) launches the CUDA kernel K3
(ops/cuda/viterbi_block.py) for a CUDA tensor and runs its plain version
for a CPU tensor: the ACS update vectorized over states and a batch (or
lane) dimension, the time steps a Python loop (the reference's
`lax.scan`). Its decisions are one int64 word a step, (B, T), the decision
of state 2m + c in bit 32c + m (the reference keeps (T, B, 64) bools;
utils/state.py converts). `viterbi_decode_tiled_re` is the plain version
of the CUDA kernel K1 (ops/cuda/viterbi.py), which CaduChain calls on the
card.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from satdump_tpu_torch.ops.cuda.viterbi_block import (viterbi_block_acs,
                                                      viterbi_block_traceback)
from satdump_tpu_torch.utils.device import resolve_device, to_numpy

K = 7
NSTATES = 64
POLYA = 79    # 0b1001111
POLYB = 109   # 0b1101101
TRACEBACK = 96  # delayed-emission depth (>= 5*K is the usual rule)
RE_DELAY = 63  # register-exchange emission delay (>= 9K bits)


def _parity(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> 4)
    x = x ^ (x >> 2)
    x = x ^ (x >> 1)
    return x & 1


def _expected_table() -> np.ndarray:
    """E[state, bit, 2] = expected output bits for transition (state, input bit)."""
    s = np.arange(NSTATES)[:, None]          # (64,1)
    b = np.arange(2)[None, :]                # (1,2)
    reg = (s << 1) | b                       # 7-bit register
    e0 = _parity(reg & POLYA)
    e1 = _parity(reg & POLYB)
    return np.stack([e0, e1], axis=-1).astype(np.uint8)  # (64,2,2)


_E = _expected_table()
# expected outputs for transition (pred, bit_of_ns): (64, 2)
_E0_T = _E[:, :, 0].astype(np.float32)  # [state, bit]
_E1_T = _E[:, :, 1].astype(np.float32)


def conv_encode(bits: np.ndarray, start_state: int = 0) -> np.ndarray:
    """Encode bits -> 2*len(bits) output bits (ref cc_encoder.cpp)."""
    bits = np.asarray(bits, dtype=np.uint8)
    out = np.empty(2 * len(bits), dtype=np.uint8)
    s = start_state
    for i, b in enumerate(bits):
        reg = ((s << 1) | int(b)) & 0x7F
        out[2 * i] = _parity(np.uint8(reg & POLYA))
        out[2 * i + 1] = _parity(np.uint8(reg & POLYB))
        s = reg & 0x3F
    return out


def conv_encode_batch(bits: np.ndarray) -> np.ndarray:
    """Vectorized NumPy encoder over (..., N) bit arrays."""
    bits = np.asarray(bits, dtype=np.uint8)
    n = bits.shape[-1]
    # register value at step i = bits[i-6..i] as a 7-bit number (newest = LSB)
    reg = np.zeros(bits.shape, dtype=np.int32)
    for k in range(K):
        shifted = np.zeros_like(bits)
        if k == 0:
            shifted = bits
        else:
            shifted[..., k:] = bits[..., :-k]
        reg |= shifted.astype(np.int32) << k
    e0 = _parity(reg & POLYA)
    e1 = _parity(reg & POLYB)
    out = np.empty(bits.shape[:-1] + (2 * n,), dtype=np.uint8)
    out[..., 0::2] = e0
    out[..., 1::2] = e1
    return out


def _consts(device: torch.device):
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return (t(_E0_T[:32]), t(_E1_T[:32]), t(_E0_T[32:]), t(_E1_T[32:]))


def _on_device(fn: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU one (the plain
    version); any other device raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {t.device}")
    return t.device.type == "cuda"


# bit of state 2m + c in a decision word: 32c + m
_DEC_SHIFT = ((torch.arange(NSTATES) & 1) << 5) | (torch.arange(NSTATES) >> 1)


def pack_decisions(dec: torch.Tensor) -> torch.Tensor:
    """(T, B, 64) bool decisions (the reference's form) -> (B, T) int64
    words, the decision of state 2m + c in bit 32c + m."""
    T, B = dec.shape[0], dec.shape[1]
    by_bit = dec.reshape(T, B, 32, 2).transpose(2, 3).reshape(T, B, NSTATES)
    w = torch.ones(NSTATES, dtype=torch.int64, device=dec.device) \
        << torch.arange(NSTATES, device=dec.device)
    # the bits are disjoint, so their sum is their OR (bit 63 is the sign)
    return (by_bit.to(torch.int64) * w).sum(-1).T.contiguous()


def unpack_decisions(words: torch.Tensor) -> torch.Tensor:
    """(B, T) int64 decision words -> (T, B, 64) bool."""
    shift = _DEC_SHIFT.to(words.device)
    return ((words.T[..., None] >> shift) & 1).to(torch.bool)


# rows x steps of bool decisions `_acs_plain` packs at a time: its int64
# temporaries stay under 2 x 8 MiB whatever the batch
_PACK_ROW_STEPS = 1 << 14


def _acs_plain(pm: torch.Tensor, soft: torch.Tensor, renorm: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K3's ACS pass (any device): the same float
    operations, a torch op at a time."""
    e0a, e1a, e0b, e1b = _consts(soft.device)
    B, T = soft.shape[0], soft.shape[1]
    words = torch.empty((B, T), dtype=torch.int64, device=soft.device)
    chunk = max(1, _PACK_ROW_STEPS // max(B, 1))
    decisions = torch.empty((min(chunk, T), B, NSTATES), dtype=torch.bool,
                            device=soft.device)
    for t0 in range(0, T, chunk):
        n = min(chunk, T - t0)
        for k in range(n):
            s0 = soft[:, t0 + k, 0][:, None, None]  # (B,1,1)
            s1 = soft[:, t0 + k, 1][:, None, None]
            # bm[s,b] = |s0 - 255 e0| + |s1 - 255 e1|, split by predecessor
            bmA = (s0 - 255.0 * e0a[None]).abs() + \
                (s1 - 255.0 * e1a[None]).abs()
            bmB = (s0 - 255.0 * e0b[None]).abs() + \
                (s1 - 255.0 * e1b[None]).abs()
            cand_a = pm[:, :32, None] + bmA                # pred m
            cand_b = pm[:, 32:, None] + bmB                # pred m+32
            decisions[k] = (cand_b < cand_a).reshape(B, NSTATES)
            pm = torch.minimum(cand_a, cand_b).reshape(B, NSTATES)
            if renorm:
                pm = pm - pm.min(dim=-1, keepdim=True).values
        words[:, t0:t0 + n] = pack_decisions(decisions[:n])
    return pm, words


def viterbi_acs(pm: torch.Tensor, soft: torch.Tensor, renorm: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ACS over a block. pm: (B,64) f32. soft: (B,T,2) f32 in [0,255]
    (255 = confident 1). Returns (new_pm, decisions (B,T) int64 words).

    Butterfly form: state ns = 2m+b has predecessors m and m+32.
    renorm=False drops the per-step min-subtract (metrics are integer
    valued and grow <= 510/step, exact in f32 for bounded T). K3 on the
    card, `_acs_plain` on the CPU."""
    if _on_device("viterbi_acs", soft):
        return viterbi_block_acs(pm, soft, renorm)
    return _acs_plain(pm, soft, renorm)


def _traceback_plain(pm: torch.Tensor, decisions: torch.Tensor
                     ) -> torch.Tensor:
    """The plain version of K3's traceback (any device)."""
    B, T = decisions.shape
    state = torch.argmin(pm, dim=-1)                            # (B,)
    bits = torch.empty((T, B), dtype=torch.uint8, device=pm.device)
    for t in range(T - 1, -1, -1):
        shift = ((state & 1) << 5) | (state >> 1)
        d = (decisions[:, t] >> shift) & 1
        bits[t] = (state & 1).to(torch.uint8)
        state = (state >> 1) | (d << 5)
    return bits.T.contiguous()


def viterbi_traceback(pm: torch.Tensor, decisions: torch.Tensor
                      ) -> torch.Tensor:
    """Traceback from the best end state (lowest index on ties, as argmin).
    decisions: (B,T) int64 words. Returns bits (B,T) uint8.

    prev(2m+b) = m or m+32 by the decision bit: the survivor is carried as
    an integer state index (the reference carries a one-hot vector to avoid
    TPU gathers). K3 on the card, `_traceback_plain` on the CPU."""
    if _on_device("viterbi_traceback", decisions):
        return viterbi_block_traceback(pm, decisions)
    return _traceback_plain(pm, decisions)


def viterbi_decode_block(soft: torch.Tensor, pm: torch.Tensor | None = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-shot block decode. soft: (B,T,2) float in [0,255]. Returns
    (bits (B,T) uint8, final pm)."""
    if soft.ndim == 2:
        soft = soft[None]
    B = soft.shape[0]
    if pm is None:
        pm = torch.zeros((B, NSTATES), dtype=torch.float32, device=soft.device)
    pm, dec = viterbi_acs(pm, soft)
    bits = viterbi_traceback(pm, dec)
    return bits, pm


class ViterbiState(NamedTuple):
    pm: torch.Tensor         # (B, 64) float32 path metrics
    decisions: torch.Tensor  # (B, D) int64, the last D decision words


def viterbi_init(batch: int = 1, traceback: int = TRACEBACK,
                 device: str | torch.device | None = None) -> ViterbiState:
    dev = resolve_device(device)
    pm = torch.full((batch, NSTATES), 1e6, dtype=torch.float32, device=dev)
    pm[:, 0] = 0.0
    return ViterbiState(
        pm=pm,
        decisions=torch.zeros((batch, traceback), dtype=torch.int64,
                              device=dev))


class StreamViterbi:
    """Continuous r=1/2 k=7 Viterbi with delayed emission (ref Viterbi27,
    common/codings/viterbi/viterbi27.h:10-34).

    Holds the path metrics and the last `traceback` decision words on
    `device`; decode(soft_pairs) returns the decoded bits delayed by
    `traceback` trellis steps.
    """

    def __init__(self, batch: int = 1, traceback: int = TRACEBACK,
                 device: str | torch.device | None = None):
        dev = resolve_device(device)
        self.traceback = traceback
        self.batch = batch
        self.pm = torch.zeros((batch, NSTATES), dtype=torch.float32,
                              device=dev)
        self.dec_tail = torch.zeros((batch, traceback), dtype=torch.int64,
                                    device=dev)

    def decode(self, soft) -> np.ndarray:
        """soft: (B,T,2) float [0,255] (a tensor or an array). Returns (B, T) uint8 bits — the T bits
        ending `traceback` steps before the newest symbol (delayed emission);
        the first call's first `traceback` bits are left-padding zeros."""
        D = self.traceback
        soft = torch.as_tensor(soft, dtype=torch.float32,
                               device=self.pm.device)
        self.pm, dec = viterbi_acs(self.pm, soft)
        window = torch.cat([self.dec_tail, dec], dim=1)         # (B, D+T)
        bits = viterbi_traceback(self.pm, window)               # (B, D+T)
        T = soft.shape[1]
        self.dec_tail = window[:, -D:]
        return to_numpy(bits[:, :T]).astype(np.uint8)


def _lane_windows(soft: torch.Tensor, seg: int, ovl: int) -> torch.Tensor:
    """(T,2) -> (L, seg+2*ovl, 2) lane windows, 128 outside [0, T)."""
    T = soft.shape[0]
    L = T // seg
    idx = (torch.arange(L, device=soft.device)[:, None] * seg
           + torch.arange(-ovl, seg + ovl, device=soft.device)[None, :])
    outside = (idx < 0) | (idx >= T)
    win = soft[idx.clamp(0, T - 1)]
    return torch.where(outside[..., None], torch.full_like(win, 128.0), win)


def viterbi_decode_tiled_re(soft: torch.Tensor, seg: int = 1024,
                            ovl: int = 128) -> torch.Tensor:
    """Lane-parallel continuous Viterbi with REGISTER-EXCHANGE survivors —
    the plain version of the CUDA kernel K1.

    Each of the L = T/seg lanes scans its window [l*seg - ovl, (l+1)*seg +
    ovl) (erasures outside the stream) carrying an f32 path metric and a
    64-bit survivor register per state; the bit at delay RE_DELAY is read
    from state 0's register. Branch metrics in the linear form
    bm = (s0+s1) + e0(255-2 s0) + e1(255-2 s1); strict tie rule
    `cand_b < cand_a` (a tie keeps the s>>1 predecessor).

    Torch has no shifts on uint32 on the CPU, so the reference's hi/lo
    uint32 pair becomes one int64 register per state; the emitted bit is
    bit 63 (the hi word's bit 31), i.e. the sign of the register.

    soft: (T, 2) float32 in [0,255], T a multiple of seg. Returns (T,) uint8.
    """
    T = soft.shape[0]
    if T % seg or ovl < RE_DELAY:
        raise ValueError(f"need T % seg == 0 and ovl >= {RE_DELAY} "
                         f"(T={T}, seg={seg}, ovl={ovl})")
    L = T // seg
    dev = soft.device
    win = _lane_windows(soft, seg, ovl)                      # (L, S, 2)
    e0a, e1a, e0b, e1b = _consts(dev)
    bitconst = torch.arange(NSTATES, device=dev, dtype=torch.int64) & 1
    pm = torch.zeros((L, NSTATES), dtype=torch.float32, device=dev)
    reg = torch.zeros((L, NSTATES), dtype=torch.int64, device=dev)
    emit_from = ovl + RE_DELAY
    out = torch.empty((seg, L), dtype=torch.uint8, device=dev)
    # the steps after the last emitted bit change nothing that is emitted
    for t in range(emit_from + seg):
        s0 = win[:, t, 0][:, None, None]
        s1 = win[:, t, 1][:, None, None]
        base = s0 + s1
        u0 = 255.0 - 2.0 * s0
        u1 = 255.0 - 2.0 * s1
        bmA = base + e0a[None] * u0 + e1a[None] * u1
        bmB = base + e0b[None] * u0 + e1b[None] * u1
        cand_a = pm[:, :32, None] + bmA
        cand_b = pm[:, 32:, None] + bmB
        dec = cand_b < cand_a
        # no per-step renorm: metrics grow <= 510/step and stay exact in
        # f32 for the bounded seg+2*ovl lane length
        pm = torch.minimum(cand_a, cand_b).reshape(L, NSTATES)
        sel = torch.where(dec, reg[:, 32:, None], reg[:, :32, None]
                          ).reshape(L, NSTATES)
        reg = (sel << 1) | bitconst[None, :]
        if t >= emit_from:
            out[t - emit_from] = (reg[:, 0] < 0).to(torch.uint8)
    return out.T.reshape(-1)


def viterbi_decode_tiled(soft: torch.Tensor, seg: int = 1024, ovl: int = 128
                         ) -> torch.Tensor:
    """Lane-parallel continuous Viterbi with full traceback (the punctured
    rates' decoder): each lane decodes [l·seg − ovl, (l+1)·seg + ovl) from a
    zero-metric cold start and keeps the owned middle `seg` bits.

    soft: (T, 2) float32 in [0,255]. Returns (T,) uint8 (T multiple of seg).
    """
    win = _lane_windows(soft, seg, ovl)
    pm0 = torch.zeros((win.shape[0], NSTATES), dtype=torch.float32,
                      device=soft.device)
    pm, dec = viterbi_acs(pm0, win, renorm=False)
    bits = viterbi_traceback(pm, dec)                          # (L, S)
    return bits[:, ovl: ovl + seg].reshape(-1)


def soft_int8_to_u8(soft: np.ndarray) -> np.ndarray:
    """Signed int8 soft (-127..127, + = bit 1) -> uint8 (0..255, 128 erasure)
    (ref signed_soft_to_unsigned, codings/viterbi/utils.cpp)."""
    return (soft.astype(np.int16) + 128).clip(0, 255).astype(np.uint8)
