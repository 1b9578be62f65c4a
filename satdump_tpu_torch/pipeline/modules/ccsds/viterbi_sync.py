"""Self-synchronizing Viterbi with phase/shift/IQ-swap ambiguity search,
for rate 1/2 and punctured rates 2/3, 3/4, 5/6, 7/8.

Reference: src-core/common/codings/viterbi/viterbi_1_2.h (rate 1/2:
phase x pair-shift x optional IQ swap on a 2048-soft test window) and
viterbi_punc.h Viterbi_Depunc (punctured: phase x puncture-shift x swap;
shift range 2*period). Both pick the hypothesis whose re-encoded BER clears
the threshold, then decode the stream under it until BER degrades.

Port of satdump_tpu/pipeline/modules/ccsds/viterbi_sync.py: all hypotheses
are decoded in ONE batched Viterbi call (hypotheses ride the batch
dimension) on `device`, instead of the reference's serial loop. The lock
search's decoder (convolutional.viterbi_decode_block) is the CUDA kernel
K3 on the card, its plain torch loop over the ~1023 trellis steps of the
test window on the CPU.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from satdump_tpu_torch.core import trace
from satdump_tpu_torch.ops.fec import convolutional as cc
from satdump_tpu_torch.ops.fec.depuncture import BER_SCALE, Depuncturer
from satdump_tpu_torch.ops.fec.rotation import (PHASE_0, PHASE_90, PHASE_180,
                                          PHASE_270, rotate_soft)
from satdump_tpu_torch.ops.cuda.viterbi import viterbi_re
from satdump_tpu_torch.utils.device import resolve_device, to_numpy

TEST_BITS = 2048  # soft values in the BER test window (ref TEST_BITS_LENGTH)

ST_IDLE = 0
ST_SYNCED = 1

HALO = 128    # pairs of decode context carried across work() calls
SEG = 1024    # tiled-decoder lane segment (pairs)


def _ber(raw_u8: np.ndarray, reenc: np.ndarray, scale: float) -> float:
    """ref get_ber (viterbi_1_2.cpp:38-50 / viterbi_punc.cpp:38-50):
    fraction mismatching at non-erasure positions, x scale."""
    n = min(len(raw_u8), len(reenc))
    raw_u8, reenc = raw_u8[:n], reenc[:n]
    mask = raw_u8 != 128
    total = int(mask.sum())
    if total == 0:
        return 10.0
    errors = int((((raw_u8 > 127).astype(np.uint8) != reenc) & mask).sum())
    return errors / total * scale


class Viterbi12Sync:
    """Streaming decoder; rate "1/2" (default) or punctured "2/3".."7/8"."""

    def __init__(self, ber_threshold: float, max_outsync: int,
                 phases: List[int] | None = None, check_iq_swap: bool = False,
                 traceback: int = 96, rate: str = "1/2",
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.ber_threshold = ber_threshold
        self.max_outsync = max_outsync
        self.phases = phases if phases is not None else [PHASE_0, PHASE_90, PHASE_180, PHASE_270]
        self.check_swap = check_iq_swap
        self.rate = rate
        self.berscale = BER_SCALE[rate]
        self.depunc = Depuncturer(rate) if rate != "1/2" else None
        self.state = ST_IDLE
        self.phase = PHASE_0
        self.shift = 0
        self.iq_swap = False
        self.invalid = 0
        self.ber = 10.0
        self.traceback = traceback
        self._carry = np.zeros(0, np.uint8)
        self._emit_from = 0

    def _shift_range(self) -> range:
        if self.depunc is None:
            return range(2)
        return range(self.depunc.numstates * 2)

    # -- lock search ---------------------------------------------------------
    def _search(self, soft: np.ndarray) -> bool:
        test = soft[:TEST_BITS]
        if len(test) < TEST_BITS:
            return False
        hyps: List[Tuple[int, int, bool]] = []
        windows = []
        for swap in ([False, True] if self.check_swap else [False]):
            for ph in self.phases:
                rotated = rotate_soft(test, ph, swap)
                u8 = cc.soft_int8_to_u8(rotated)
                for shift in self._shift_range():
                    if self.depunc is None:
                        w = u8[shift: shift + TEST_BITS - 2]
                    else:
                        w = self.depunc.depunc_static(u8, shift)
                    hyps.append((ph, shift, swap))
                    windows.append(w)
        # trim to a common even length so hypotheses batch into lanes
        wlen = min(len(w) for w in windows) // 2 * 2
        W = np.stack([w[:wlen] for w in windows]).astype(np.float32)
        softs = W.reshape(len(hyps), -1, 2)
        bits, _ = cc.viterbi_decode_block(
            torch.from_numpy(softs).to(self.device))
        bits = to_numpy(bits).astype(np.uint8)          # (H, T)
        reenc = cc.conv_encode_batch(bits)               # (H, 2T)
        best_i, best_ber = -1, 10.0
        for i, (ph, shift, swap) in enumerate(hyps):
            b = _ber(windows[i][:wlen].astype(np.uint8), reenc[i], self.berscale)
            if b < self.ber_threshold and b < best_ber:
                best_i, best_ber = i, b
        if best_i < 0:
            self.ber = best_ber if best_ber < 10 else 10.0
            return False
        self.phase, self.shift, self.iq_swap = hyps[best_i]
        self.ber = best_ber
        self.state = ST_SYNCED
        self.invalid = 0
        self._carry = np.zeros(0, np.uint8)
        self._emit_from = 0
        if self.depunc is not None:
            self.depunc.set_shift(self.shift)
        return True

    def search_stream(self, soft: np.ndarray, stride: int = TEST_BITS,
                      max_lanes: int = 1024) -> int:
        """Slide the hypothesis search through the WHOLE chunk. The
        reference re-probes its small (8k-soft) buffer every work() call,
        so signal appearing mid-stream locks within one buffer; this
        framework feeds multi-Msoft chunks, so the probe must scan within
        a chunk — all (offset × phase × shift × swap) windows batch into
        lane-parallel decodes of ≤ max_lanes hypotheses each.

        Returns the soft index where lock was established (state/phase/
        shift/iq_swap updated), or -1 after scanning everything. The span
        `decoder.lock_search`, its copies the waits `decoder.lock_wait`,
        its re-encoding and BER on the host `decoder.lock_ber`."""
        with trace.span("decoder.lock_search"):
            return self._search_stream(np.asarray(soft, np.int8), stride,
                                       max_lanes)

    def _search_stream(self, soft: np.ndarray, stride: int, max_lanes: int
                       ) -> int:
        if len(soft) < TEST_BITS:
            return -1
        n_hyp = len(self.phases) * len(self._shift_range()) * \
            (2 if self.check_swap else 1)
        per_call = max(1, max_lanes // n_hyp)
        base = 0
        while base + TEST_BITS <= len(soft):
            n_off = min(per_call,
                        (len(soft) - base - TEST_BITS) // stride + 1)
            offs = base + np.arange(n_off) * stride
            hyps: List[Tuple[int, int, bool, int]] = []
            windows = []
            for swap in ([False, True] if self.check_swap else [False]):
                for ph in self.phases:
                    rotated = rotate_soft(
                        soft[base: base + n_off * stride + TEST_BITS],
                        ph, swap)
                    u8 = cc.soft_int8_to_u8(rotated)
                    for shift in self._shift_range():
                        for o in offs:
                            ob = o - base
                            if self.depunc is None:
                                w = u8[ob + shift: ob + shift + TEST_BITS - 2]
                            else:
                                w = self.depunc.depunc_static(
                                    u8[ob: ob + TEST_BITS], shift)
                            hyps.append((ph, shift, swap, int(o)))
                            windows.append(w)
            wlen = min(len(w) for w in windows) // 2 * 2
            W = np.stack([w[:wlen] for w in windows]).astype(np.float32)
            with trace.span("decoder.lock_wait", "wait"):
                W = torch.from_numpy(W.reshape(len(hyps), -1, 2)).to(
                    self.device)
            bits, _ = cc.viterbi_decode_block(W)
            with trace.span("decoder.lock_wait", "wait"):
                bits = to_numpy(bits)
            with trace.span("decoder.lock_ber", "host"):
                reenc = cc.conv_encode_batch(bits.astype(np.uint8))
                # (offset, ber, i): the EARLIEST offset wins, as the ref
                # locks at the first passing buffer
                best = None
                for i, (ph, shift, swap, o) in enumerate(hyps):
                    b = _ber(windows[i][:wlen].astype(np.uint8), reenc[i],
                             self.berscale)
                    if b < self.ber_threshold and \
                            (best is None or (o, b) < (best[0], best[1])):
                        best = (o, b, i)
            if best is not None:
                o, b, i = best
                self.phase, self.shift, self.iq_swap, _ = hyps[i]
                self.ber = b
                self.state = ST_SYNCED
                self.invalid = 0
                self._carry = np.zeros(0, np.uint8)
                self._emit_from = 0
                if self.depunc is not None:
                    self.depunc.set_shift(self.shift)
                return int(o)
            base += n_off * stride
        self.ber = 10.0
        return -1

    # -- streaming decode ----------------------------------------------------
    def work(self, soft: np.ndarray, last: bool = False) -> np.ndarray:
        """soft: signed int8 soft symbols (interleaved for QPSK). Returns
        decoded hard bits (uint8), possibly empty while unlocked.

        Decodes with the lane-parallel tiled Viterbi (one device call per
        work() chunk — frames in lanes, not a per-sample scan): each call
        re-decodes HALO carried pairs on each side of the seam so emitted
        bits always have full trellis context; the trailing HALO pairs are
        deferred to the next call (or emitted when `last`)."""
        soft = np.asarray(soft, np.int8)
        drop = 0
        if self.state == ST_IDLE:
            off = self.search_stream(soft)
            if off < 0:
                return np.zeros(0, np.uint8)
            soft = soft[off:]   # noise lead-in before the signal: skip it
            # rate 1/2: apply the pair shift once at lock by dropping values
            # AFTER rotation (the search rotates the raw window first, then
            # shifts — viterbi_1_2.cpp ordering); punctured rates realign
            # inside the depuncturer instead
            if self.depunc is None:
                drop = self.shift

        with trace.span("decoder.rotate", "host"):
            rotated = rotate_soft(soft, self.phase, self.iq_swap)
            u8 = cc.soft_int8_to_u8(rotated)
            if drop:
                u8 = u8[drop:]
            if self.depunc is not None:
                u8 = self.depunc.depunc_cont(u8)
            buf = np.concatenate([self._carry, u8]) if len(self._carry) \
                else u8
            n_pairs = len(buf) // 2
            tail_keep = 0 if last else HALO
            if n_pairs - self._emit_from - tail_keep <= 0:
                self._carry = buf
                return np.zeros(0, np.uint8)

            T = -(-n_pairs // SEG) * SEG
            pairs = np.full((T, 2), 128.0, np.float32)
            pairs[:n_pairs] = buf[: 2 * n_pairs].reshape(-1, 2)
        # register-exchange for rate 1/2 (the CUDA kernel K1 on the card;
        # truncation depth 63 is ample); punctured rates have a much longer
        # effective constraint, so they use the full-traceback tiled decoder
        decode = viterbi_re if self.depunc is None \
            else cc.viterbi_decode_tiled
        with trace.span("decoder.to_device", "wait"):
            pairs = torch.from_numpy(pairs).to(self.device)
        bits = decode(pairs, seg=SEG, ovl=HALO)
        with trace.span("decoder.to_host", "wait"):
            bits = to_numpy(bits)
        bits = bits.astype(np.uint8)[:n_pairs]
        out = bits[self._emit_from: n_pairs - tail_keep]

        # BER via re-encode over a mid-stream window (ref viterbi_1_2.cpp:
        # 105-122) — centered, away from the cold lane edges and from the
        # head of the stream (where the demod loops are still converging)
        w0 = max(self._emit_from + 256, (n_pairs - TEST_BITS) // 2)
        w1 = min(w0 + TEST_BITS, n_pairs)
        if w1 - w0 >= 512:
            # re-encode with K-1 bits of history so the encoder register is
            # correct at the window start (else the first taps mismatch)
            h = min(8, w0)
            reenc = cc.conv_encode_batch(bits[w0 - h: w1])[2 * h:]
            raw = buf[2 * w0: 2 * w0 + len(reenc)]
            self.ber = _ber(raw.astype(np.uint8), reenc, self.berscale)
            if self.ber > self.ber_threshold:
                self.invalid += 1
                if self.invalid > self.max_outsync:
                    self.state = ST_IDLE
            else:
                self.invalid = 0

        # carry 2·HALO pairs: the first HALO as decode context (already
        # emitted), the last HALO deferred (no right context yet)
        nc = min(2 * HALO, n_pairs)
        self._carry = buf[(n_pairs - nc) * 2:]
        self._emit_from = nc - tail_keep
        return out

    def getState(self) -> int:
        return self.state
