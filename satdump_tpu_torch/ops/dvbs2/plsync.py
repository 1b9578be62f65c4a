"""DVB-S2 PL header synchronization + frame phase recovery — a host NumPy
copy of satdump_tpu/ops/dvbs2/plsync.py.

Reference behavior: dvbs2/dvbs2_pl_sync.cpp (serial differential
correlation search against SOF + PLS-scrambler patterns, threshold 0.6) and
dvbs2/dvbs2_pll.cpp (sequential 2nd-order PLL using known header symbols +
soft-LUT decision errors). Restructured for batched arrays:
- the differential correlation runs over the whole block at once (two
  sparse-tap correlations evaluated at every offset), and frame alignment
  is found by folding the metric at the frame period — no serial search;
- the per-sample feedback PLL becomes feedforward estimation: phase/CFO
  from the 90 known header symbols, pilot-anchored linear phase
  interpolation when pilots are on, and per-slot Viterbi&Viterbi (M-th
  power) phase tracking otherwise — a per-slot scanline instead of a
  per-sample recurrence.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from satdump_tpu_torch.ops.dvbs2 import defs
from satdump_tpu_torch.ops.dvbs2.scrambling import pl_descramble


def pl_sync_metric(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Differential PLHeader correlation at every offset of x.

    Returns (metric, c_best, sof_corr) where metric[n] in [0, ~1] peaks at
    PLHEADER starts, c_best[n] is the complex correlation (its angle =
    CFO rad/sym) and sof_corr is csof alone."""
    x = np.asarray(x, np.complex64)
    d = np.conj(x[:-1]) * x[1:]
    e_sof, e_pls = defs.header_diff_refs()
    # sparse-tap correlations: csof uses taps 0..24, cpls taps 26+2k
    n_out = len(d) - (26 + 63) + 1
    if n_out <= 0:
        z = np.zeros(0)
        return z, z.astype(np.complex64), z.astype(np.complex64)
    csof = np.zeros(n_out, np.complex64)
    for i in range(25):
        csof += d[i: i + n_out] * np.conj(e_sof[i])
    cpls = np.zeros(n_out, np.complex64)
    for k in range(32):
        off = 26 + 2 * k
        cpls += d[off: off + n_out] * np.conj(e_pls[k])
    c0, c1 = csof + cpls, csof - cpls
    take0 = np.abs(c0) >= np.abs(c1)
    c = np.where(take0, c0, c1)
    return np.abs(c) / 57.0, c, csof


def find_frame_offset(x: np.ndarray, frame_len: int) -> Tuple[int, float]:
    """Fold the header metric at the frame period; returns (offset, score)."""
    metric, _, _ = pl_sync_metric(x)
    n_frames = len(metric) // frame_len
    if n_frames == 0:
        p = int(np.argmax(metric)) if len(metric) else 0
        return p, float(metric[p]) if len(metric) else 0.0
    folded = metric[: n_frames * frame_len].reshape(n_frames, frame_len).sum(0)
    p = int(np.argmax(folded))
    return p, float(folded[p] / n_frames)


def _block_slope(v: np.ndarray, cfo0: float, blk: int = 6) -> float:
    """Residual frequency of a de-referenced known-symbol sequence v via
    block-averaged phase regression (robust at low per-symbol SNR where
    naive per-symbol unwrapping fails)."""
    n = np.arange(len(v))
    v2 = v * np.exp(-1j * cfo0 * n)
    nb = len(v2) // blk
    zb = v2[: nb * blk].reshape(nb, blk).sum(-1)
    ang = np.unwrap(np.angle(zb))
    centers = (np.arange(nb) + 0.5) * blk
    slope = np.polyfit(centers, ang, 1)[0]
    return cfo0 + float(slope)


def decode_pls(header: np.ndarray) -> Tuple[int, float, float]:
    """ML PLS decode from the 90 aligned header symbols, CFO-immune.

    1. Differential ML: for every candidate codeword, de-reference the
       header and score the coherence of the one-lag differentials —
       insensitive to CFO (upgrades the bb_to_soft.cpp hard-slicing +
       hamming search). This leaves the pi-rotation pair ambiguous
       (flipping PLS index bit 1 flips every codeword bit = rotates all
       PLS symbols by pi, invisible to differentials).
    2. CFO: one-lag estimate then block-phase regression over the PLS
       region (no SOF/PLS boundary, so the pi ambiguity cannot bias it).
    3. Resolve the pair by comparing the SOF phase with the PLS phase
       (they differ by pi for the wrong member), then refine phase over
       the full header. Returns (pls_index, cfo_rad_per_sym, phase)."""
    h = np.asarray(header, np.complex64)
    sof_ref = defs.sof_symbols()
    refs = defs.pls_symbols()                            # (128, 64)
    v_sof = h[:26] * np.conj(sof_ref)
    v_pls_all = h[26:][None, :] * np.conj(refs)          # (128, 64)
    v_all = np.concatenate(
        [np.broadcast_to(v_sof, (128, 26)), v_pls_all], axis=1)
    diff = v_all[:, 1:] * np.conj(v_all[:, :-1])
    scores = np.abs(diff.sum(axis=1))
    pls = int(np.argmax(scores))

    v_pls = v_pls_all[pls]
    cfo0 = float(np.angle((v_pls[1:] * np.conj(v_pls[:-1])).sum()))
    cfo = _block_slope(v_pls, cfo0)
    n = np.arange(defs.HDR_LEN)
    rot = np.exp(-1j * cfo * n)
    ph_sof = np.angle(np.sum(v_sof * rot[:26]))
    ph_pls = np.angle(np.sum(v_pls * rot[26:]))
    if np.abs(np.angle(np.exp(1j * (ph_pls - ph_sof)))) > np.pi / 2:
        pls ^= 2                                         # other pair member
        v_pls = -v_pls
    v = np.concatenate([v_sof, v_pls])
    cfo = _block_slope(v, cfo)
    phase = float(np.angle(np.sum(v * np.exp(-1j * cfo * n))))
    return pls, float(cfo), phase


class FramePhase(NamedTuple):
    symbols: np.ndarray     # corrected + descrambled payload (data+pilots)
    phase: np.ndarray       # applied phase per payload symbol


def recover_payload(frame: np.ndarray, cfg: defs.ModcodCfg,
                    cfo: float, phase0: float) -> np.ndarray:
    """One aligned PLFRAME (plframe_len,) -> phase-corrected data symbols
    (slots*90,). Payload is descrambled first (the PL scrambler's j^Rn
    rotation commutes with the common channel phase), then the residual
    phase is tracked feedforward:
    - pilots on: anchors at the header + each 36-symbol pilot block,
      linear interpolation in between (dvbs2_pll.cpp replaced);
    - pilots off: per-slot V&V (M-th power) for QPSK/8PSK, branch-resolved
      from the header anchor; header-only correction for APSK."""
    frame = np.asarray(frame, np.complex64)
    n_pay = defs.plframe_len(cfg) - defs.HDR_LEN
    pay = frame[defs.HDR_LEN: defs.HDR_LEN + n_pay]
    # residual CFO correction across the whole frame (estimated on header)
    n = np.arange(defs.HDR_LEN + n_pay, dtype=np.float64)
    corr = np.exp(-1j * (cfo * n + phase0)).astype(np.complex64)
    pay = pay * corr[defs.HDR_LEN:]
    pay = pl_descramble(pay)

    mask = defs.payload_data_mask(cfg)
    pos = np.arange(n_pay)
    # Decision-directed per-slot phase tracking with frequency aiding (the
    # reference's per-sample soft-LUT PLL restructured into a 90-symbol-
    # granular recurrence — the per-slot inner work is fully vectorized;
    # only the slot walk is serial). When pilots are on, each pilot block
    # is an *absolute* re-anchor: its known-symbol phase is full-range
    # (no constellation ambiguity), so residual-CFO drift and any DD phase
    # slip are corrected every 16 slots (dvbs2_pll.cpp's pilot mode).
    pts = defs.constellation(cfg.constellation, cfg.g1, cfg.g2)
    data_pos = np.nonzero(mask)[0].reshape(cfg.slots, defs.SLOT)
    if cfg.pilots:
        pilot_pos = np.nonzero(~mask)[0].reshape(-1, defs.PILOT_LEN)
        # map each pilot block to the slot that follows it
        pilot_before = {}
        for blk in pilot_pos:
            nxt = np.searchsorted(data_pos[:, 0], blk[-1])
            pilot_before[int(nxt)] = blk
    else:
        pilot_before = {}
    ref = np.exp(1j * np.pi / 4)
    th = np.zeros(cfg.slots)
    prev, drift = 0.0, 0.0
    for i in range(cfg.slots):
        blk = pilot_before.get(i)
        if blk is not None:
            z = np.sum(pay[blk] * np.conj(ref))
            th_a = float(np.angle(z))
            prev = prev + drift + np.angle(
                np.exp(1j * (th_a - (prev + drift))))
        y = pay[data_pos[i]] * np.exp(-1j * (prev + drift))
        dec = pts[np.argmin(np.abs(y[:, None] - pts), axis=-1)]
        err = float(np.angle(np.sum(y * np.conj(dec))))
        th[i] = prev + drift + err
        if i > 0:
            drift = 0.7 * drift + 0.3 * (th[i] - prev)
        prev = th[i]
    centers = data_pos.mean(axis=1)
    theta = np.interp(pos, centers, th)
    # extrapolate the tracked slope past the last slot center
    if cfg.slots >= 2:
        slope = (th[-1] - th[-2]) / (centers[-1] - centers[-2])
        m = pos > centers[-1]
        theta[m] = th[-1] + slope * (pos[m] - centers[-1])
    return (pay * np.exp(-1j * theta)).astype(np.complex64)[mask]
