"""Feedforward carrier + timing synchronization — port of
satdump_tpu/ops/ffsync.py.

The reference recovers carrier and symbol timing with per-sample feedback
loops (Costas, M&M). This module uses the feedforward estimators instead,
which are parallel over the whole block:

* carrier: FFT of x^M for the coarse frequency (M-PSK modulation stripping),
  then per-sub-block Viterbi&Viterbi phase estimates, unwrapped and linearly
  interpolated per sample;
* timing: the Oerder&Meyr spectral-line estimator — the symbol-rate tone of
  |x|^2 gives the fractional timing per sub-block; a line fit over sub-blocks
  gives (offset, clock skew); symbols are then picked by polyphase
  interpolation (the M&M block's interpolator bank,
  firdes.mm_interpolator_bank).

Plain torch on the device of the input. Where `_strip_geometry(sps)` is
None (MetOp's sps ≈ 2.571, METEOR's ≈ 3.889) `ff_clock_recovery` picks the
symbols with `resample_arith_grid` (ops/cuda/resample.py), elsewhere (sps
near an integer: FY-3's 3, GRB's 2) with `resample_strip`
(ops/cuda/resample_strip.py): the CUDA kernels K2 and K4 on the card, their
plain versions on the CPU. Outputs use the reference's fixed-capacity +
valid-mask convention, and state stays on the device. A block reads
nothing back to the host and copies nothing to the card: its host
constants (`_cached`: the bank and its tap polynomials, `interp_tables`;
the timing tones, the V&V rotation, a long matched filter's taps) are
uploaded at their first use on a device and kept, the chain's in a `wait`
span `psk_demod.<what>` each (core/trace.py). So a block's work can be
captured as one CUDA graph: `FFBlockGraph`, which the psk_demod module
replays on the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from satdump_tpu_torch.core import trace
from satdump_tpu_torch.ops.cuda import resample_strip as k4
from satdump_tpu_torch.ops.cuda.graph import Graph
from satdump_tpu_torch.ops.cuda.resample import interp_at, resample_arith_grid
from satdump_tpu_torch.ops.firdes import mm_interpolator_bank
from satdump_tpu_torch.utils.device import resolve_device

F32 = torch.float32
C64 = torch.complex64
# block seams (ff_clock_recovery): how far before the carried history a
# block's first symbol may fall and still be picked, at the history's edge
# (samples); and the zeros resample_strip puts ahead of ext
FIRST_SNAP = 0.25
STRIP_FRONT = 32


def _ipow(x: torch.Tensor, y: int) -> torch.Tensor:
    """x**y for a static int y by repeated squaring (the order of
    jax.lax.integer_pow, so u**4 is (u*u)*(u*u))."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


# ---------------------------------------------------------------------------
# Carrier frequency: FFT of x^M (modulation stripping)
# ---------------------------------------------------------------------------
def cfo_estimate(x: torch.Tensor, order: int,
                 suppress_nyquist_image: bool = False) -> torch.Tensor:
    """Coarse+fine carrier frequency offset estimate, cycles/sample (0-dim
    f32 tensor on x's device).

    Raises the unit-normalized signal to the Mth power to strip M-PSK
    modulation, takes the FFT, and refines the peak bin by quadratic
    interpolation. `suppress_nyquist_image` averages adjacent samples (a
    null at fs/2) so that at 2 samples/symbol the argmax cannot lock the
    f±fs/2 image.
    """
    n = x.shape[-1]
    u = x / x.abs().clamp_min(1e-12)
    xm = _ipow(u, order)
    if suppress_nyquist_image:
        xm = 0.5 * (xm + torch.roll(xm, -1))
    p = torch.fft.fft(xm).abs()
    k = torch.argmax(p)
    # the peak and its neighbours by one gather on the device (indexing by
    # a 0-dim tensor would read the index on the host)
    pm1, p0, pp1 = p.index_select(0, torch.stack([(k - 1) % n, k,
                                                  (k + 1) % n]))
    denom = pm1 - 2.0 * p0 + pp1
    delta = torch.where(denom.abs() > 1e-9, 0.5 * (pm1 - pp1) / denom,
                        torch.zeros_like(denom))
    delta = delta.clamp(-0.5, 0.5)
    f = (k.to(F32) + delta) / n
    f = torch.remainder(f + 0.5, 1.0) - 0.5          # wrap to [-0.5, 0.5)
    return f / order


def cfo_correct(x: torch.Tensor, f: torch.Tensor, phase0=0.0) -> torch.Tensor:
    """Mix x by exp(-j(2π f n + phase0))."""
    n = torch.arange(x.shape[-1], dtype=F32, device=x.device)
    return x * torch.exp(-1j * (2 * math.pi * f * n + phase0)).to(x.dtype)


# ---------------------------------------------------------------------------
# Carrier phase: per-sub-block Viterbi&Viterbi, unwrapped + interpolated
# ---------------------------------------------------------------------------
def _wrap(a: torch.Tensor, period: float) -> torch.Tensor:
    return torch.remainder(a + period / 2, period) - period / 2


def vv_phase_track(x: torch.Tensor, order: int, sub: int,
                   last_phase: torch.Tensor | None = None,
                   const_rotation: float = 0.0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Viterbi&Viterbi feedforward phase over sub-blocks of length `sub`.

    Returns (per-sample phase estimate (N,), final phase scalar). Each
    sub-block phase is unwrapped against its neighbour (and `last_phase`
    from the previous block), leaving one global 2π/M ambiguity for the
    Viterbi phase search downstream. `const_rotation` is the constellation's
    first-point angle θ0 (π/4 for diagonal QPSK), divided out of u^M.
    """
    n = x.shape[-1]
    nsub = n // sub
    u = x[: nsub * sub].reshape(nsub, sub)
    un = u / u.abs().clamp_min(1e-12)
    s = _ipow(un, order).sum(dim=-1)                     # (nsub,)
    if const_rotation:
        s = s * _cached(("rotation", order, const_rotation), x.device,
                        lambda dev: torch.exp(_c64(np.asarray(
                            -1j * order * const_rotation), dev,
                            "psk_demod.rotation")))
    ph = torch.angle(s) / order                          # (-π/M, π/M]
    period = 2 * math.pi / order

    # unwrap: cumulative sum of wrapped diffs
    d = _wrap(torch.diff(ph), period)
    first = ph[0] if last_phase is None else (
        last_phase + _wrap(ph[0] - last_phase, period))
    ph_u = torch.cat([first[None], first + torch.cumsum(d, 0)])

    # per-sample linear interpolation between the uniform sub-block centers;
    # the head and tail half-blocks clamp to the end values
    if nsub > 1:
        slopes = ph_u[1:] - ph_u[:-1]                        # (nsub-1,)
        ramp = torch.arange(sub, dtype=F32, device=x.device) / sub
        core = (ph_u[:-1, None] + slopes[:, None] * ramp[None, :]).reshape(-1)
        head = ph_u[0].expand(sub // 2)
        tail_n = n - (nsub - 1) * sub - sub // 2
        tail = ph_u[-1].expand(tail_n)
        ph_t = torch.cat([head, core, tail])
    else:
        ph_t = ph_u[0].expand(n).clone()
    return ph_t, ph_u[-1]


# ---------------------------------------------------------------------------
# Timing: Oerder&Meyr spectral-line estimator + linear drift fit
# ---------------------------------------------------------------------------
def _half_sample_taps(ntaps: int = 15) -> np.ndarray:
    k = np.arange(ntaps) - ntaps // 2
    h = np.sinc(k - 0.5) * np.hamming(ntaps)
    return (h / h.sum()).astype(np.float32)


_HALF_SAMPLE_FIR = _half_sample_taps()


def _f32(a: np.ndarray, device, span: str) -> torch.Tensor:
    """A host array as float32 on `device`, in the wait span `span`."""
    with trace.span(span, "wait"):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _c64(a: np.ndarray, device, span: str) -> torch.Tensor:
    """A host array as complex64 on `device`, in the wait span `span`."""
    with trace.span(span, "wait"):
        return torch.as_tensor(a.astype(np.complex64), device=device)


_CONSTS: dict = {}


def _cached(key: tuple, device, make):
    """`make(device)`, the device constants of `key`, made at their first
    use on `device` and kept, so that the blocks of a stream neither upload
    them nor wait for that."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    got = _CONSTS.get((*key, dev))
    if got is None:
        got = _CONSTS[(*key, dev)] = make(dev)
    return got


def om_timing_fit(x: torch.Tensor, sps: float, sub: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Estimate (tau0, skew) such that symbol k sits at tau0 + k·sps·(1+skew).

    Per sub-block, correlate |x|² against the symbol-rate tone e^{-j2πn/sps};
    the argument gives the local fractional timing. A weighted line through
    the unwrapped per-sub-block estimates gives the block-wide timing offset
    and clock skew.

    Near 2 samples/symbol the symbol-rate line of |x|² sits at Nyquist, so
    x is first interpolated by 2 (15-tap half-sample FIR) and the estimator
    runs on the doubled-rate |x|², split into its even/odd combs.
    """
    dev = x.device
    if sps < 2.1:
        hs = _HALF_SAMPLE_FIR
        nt = len(hs)
        z = torch.zeros(nt // 2, dtype=x.dtype, device=dev)
        xe = torch.cat([z, x, z])
        xh = torch.zeros_like(x)
        for k in range(nt):
            xh = xh + float(hs[k]) * xe[k: k + x.shape[-1]]
        n = x.shape[-1]
        nsub2 = (2 * n) // (2 * sub)
        nps = nsub2 * sub                 # per-phase samples used
        ex = _pw(x)[:nps].reshape(nsub2, sub)
        eh = _pw(xh)[:nps].reshape(nsub2, sub)
        sps2 = 2.0 * sps

        def tones(dev):
            tke = np.exp(-2j * np.pi * ((2.0 * np.arange(sub)) % sps2)
                         / sps2)
            tko = np.exp(-2j * np.pi * ((2.0 * np.arange(sub) + 1) % sps2)
                         / sps2)
            tj = np.exp(-2j * np.pi * ((np.arange(nsub2) * float(2 * sub))
                                       % sps2) / sps2)
            return (*(_f32(t, dev, "psk_demod.tones") for t in (
                tke.real, tko.real, tke.imag, tko.imag)),
                _c64(tj, dev, "psk_demod.tones"))
        ter, tor, tei, toi, tj = _cached(("tones2", sps, sub, nsub2), dev,
                                         tones)
        cr = ex @ ter + eh @ tor
        ci = ex @ tei + eh @ toi
        c = tj * torch.complex(cr, ci)
        tau_e, skew = _om_fit(c, sps2, 2 * sub)
        return tau_e * 0.5, skew
    return _om_core(_pw(x), sps, sub)


def _pw(x: torch.Tensor) -> torch.Tensor:
    """|x|² without the sqrt of abs()."""
    return x.real ** 2 + x.imag ** 2


def _om_core(e_sig: torch.Tensor, sps: float, sub: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    n = e_sig.shape[-1]
    nsub = n // sub
    e = e_sig[: nsub * sub].reshape(nsub, sub)
    # the tone exp(-2πj n/sps) with n = j·sub + k is tone_j ⊗ tone_k, so the
    # per-sub-block correlation is one real×complex matvec. The tones are
    # host float64 constants cast to float32: the phase 2π·n/sps needs exact
    # modular reduction (a float32 phase at n ~ 4M is off by ~0.5 rad).
    def tones(dev):
        tk = np.exp(-2j * np.pi * (np.arange(sub) % sps) / sps)
        tj = np.exp(-2j * np.pi * ((np.arange(nsub) * float(sub)) % sps)
                    / sps)
        return (_f32(tk.real, dev, "psk_demod.tones"),
                _f32(tk.imag, dev, "psk_demod.tones"),
                _c64(tj, dev, "psk_demod.tones"))
    tkr, tki, tj = _cached(("tones", sps, sub, nsub), e_sig.device, tones)
    cr = e @ tkr
    ci = e @ tki
    c = tj * torch.complex(cr, ci)  # (nsub,)
    return _om_fit(c, sps, sub)


def _om_fit(c: torch.Tensor, sps: float, sub: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sub-block complex correlations -> (tau0, skew) line fit."""
    nsub = c.shape[0]
    tau = -torch.angle(c) / (2 * math.pi) * sps          # samples, mod sps

    # unwrap modulo sps across sub-blocks
    d = _wrap(torch.diff(tau), sps)
    tau_u = torch.cat([tau[:1], tau[0] + torch.cumsum(d, 0)])

    # weighted LSQ line over sub-block centers (weight = tone magnitude)
    tc = (torch.arange(nsub, dtype=F32, device=c.device) + 0.5) * sub
    w = c.abs() + 1e-12
    wm = w.sum()
    tm = (w * tc).sum() / wm
    ym = (w * tau_u).sum() / wm
    cov = (w * (tc - tm) * (tau_u - ym)).sum()
    var = (w * (tc - tm) ** 2).sum()
    slope = torch.where(var > 0, cov / var, torch.zeros_like(var))
    slope = slope.clamp(-0.01, 0.01)             # clock skew bound (1e4 ppm)
    tau0 = ym - slope * tm
    return tau0, slope


class FFClockState(NamedTuple):
    next_pos: torch.Tensor   # f32: position of the next symbol, in samples
                             # relative to the start of the *current* block
    history: torch.Tensor    # (ntaps-1,) input tail carried between blocks
    last_phase: torch.Tensor  # f32: last V&V carrier phase (continuity)
    last_f: torch.Tensor      # f32: last CFO estimate (cycles/sample)
    nco_phase: torch.Tensor   # f32: CFO-removal NCO phase, carried across
                              # blocks so the corrected signal stays
                              # phase-continuous
    rrc_history: torch.Tensor = None  # (rrc_ntaps-1,) matched-filter input
                              # tail; empty -> zero-history per block
    oq_imag: torch.Tensor = None      # f32: previous sample's imag for the
                              # OQPSK half-symbol delay (seam carry)
    sym_phase: torch.Tensor = None    # f32: symbol-domain V&V phase
                              # continuity (OQPSK second stage)


def ff_clock_init(ntaps: int = 8, dtype=C64, rrc_ntaps: int = 0,
                  device: str | torch.device | None = None) -> FFClockState:
    dev = resolve_device(device)
    zf = lambda: torch.zeros((), dtype=F32, device=dev)  # noqa: E731
    return FFClockState(
        next_pos=zf(),
        history=torch.zeros((ntaps - 1,), dtype=dtype, device=dev),
        last_phase=zf(),
        last_f=zf(),
        nco_phase=zf(),
        rrc_history=torch.zeros((max(rrc_ntaps - 1, 0),), dtype=dtype,
                                device=dev),
        oq_imag=zf(),
        sym_phase=zf(),
    )


def _valid_mask(positions: torch.Tensor, ntaps: int, n_in: int
                ) -> torch.Tensor:
    """Emission window: p ≥ −ntaps/2 reaches back into carried history; the
    last ntaps/2 samples need the next block, so they are deferred."""
    valid_in = (positions >= -(ntaps // 2)) & (positions < n_in - ntaps // 2)
    src = torch.floor(positions + ntaps / 2).to(torch.int64)
    return valid_in & (src < n_in)


def ff_resample_at(ext: torch.Tensor, positions: torch.Tensor,
                   bank: torch.Tensor, n_in: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Polyphase interpolation of `ext` (history+block) at fractional sample
    `positions` (relative to block start). Returns (samples, valid mask).

    The bank evaluated on window ext[floor(p)..floor(p)+ntaps-1] gives x at
    p − ntaps/2 (the windowed-sinc prototype's group delay); a feedforward
    sampler compensates by shifting the positions by +ntaps/2. The
    unmasked core, `interp_at`, is the plain version of the CUDA kernel K2
    (ops/cuda/resample.py)."""
    bank = torch.as_tensor(bank, dtype=F32, device=ext.device)
    valid = _valid_mask(positions, bank.shape[1], n_in)
    y = interp_at(ext, positions, bank, n_in)
    return torch.where(valid, y, torch.zeros_like(y)), valid


def _strip_geometry(sps: float, ntaps: int, skew_max: float = 0.003
                    ) -> Tuple[int, int] | None:
    """(segment length G, strip width D) for the strided-strip resampler,
    or None when sps is too far from an integer for the strip to pay off."""
    s0 = round(sps)
    if s0 < 1:
        return None
    drift_rate = abs(sps - s0) + s0 * skew_max    # samples/symbol of drift
    D = 24
    budget = D - ntaps - 2
    if drift_rate <= 0:
        return 2048, D
    G = int(budget / drift_rate)
    if G < 128:
        return None
    return min(2048, 1 << (G.bit_length() - 1)), D


def _bank_poly_coefs(bank: np.ndarray, deg: int = 10) -> np.ndarray:
    """Fit each interpolator tap as a polynomial in the fractional delay.
    bank[branch, tap] with branch = round(frac * nfilt). Returns
    Horner-ordered coefficients (deg+1, ntaps) float32, highest power first."""
    nfilt, ntaps = bank.shape
    fr = np.arange(nfilt) / nfilt
    co = np.stack([np.polyfit(fr, np.asarray(bank[:, t], np.float64), deg)
                   for t in range(ntaps)], axis=1).astype(np.float32)
    err = 0.0
    for t in range(ntaps):
        err = max(err, float(np.abs(
            np.polyval(co[:, t].astype(np.float64), fr)
            - bank[:, t]).max()))
    if err >= 5e-4:
        raise ValueError(f"bank poly fit error {err}")
    return co


def interp_tables(bank: np.ndarray, sps: float, device
                  ) -> Tuple[torch.Tensor, torch.Tensor | None]:
    """(the bank, and where sps has a strip geometry its tap polynomials
    `_bank_poly_coefs`) as float32 tensors on `device`, from the host bank,
    made and uploaded at their first use on a device and kept (`_cached`),
    so that the blocks of a stream neither upload them nor read the bank
    back: the demod modules call this when they build, so that the upload,
    a wait, happens there and not in a block."""
    bank = np.asarray(bank, np.float32)
    key = (bank.shape, bank.tobytes())
    bank_t = _cached(("bank", *key), device,
                     lambda dev: torch.tensor(bank, device=dev))
    if _strip_geometry(sps, bank.shape[1]) is None:
        return bank_t, None
    return bank_t, _cached(("bank_coefs", *key), device, lambda dev: (
        torch.tensor(_bank_poly_coefs(bank), device=dev)))


def strip_window(out_cap: int, n_ext: int, G: int, D: int, s0: int,
                 ntaps: int = 8) -> Tuple[int, int]:
    """(Lw, n_extp): resample_strip's segment window length, and the length
    of its padded ext (STRIP_FRONT zeros, ext, then enough zeros that every
    segment's window lies inside)."""
    nseg = -(-out_cap // G)
    Lw = s0 * G + D + ntaps + 8
    return Lw, STRIP_FRONT + n_ext + max(nseg * G * s0 + Lw + 64 - n_ext, 0)


def resample_strip(ext: torch.Tensor, start: torch.Tensor,
                   omega: torch.Tensor, coefs: torch.Tensor, *, out_cap: int,
                   sps: float, n_in: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Arithmetic-grid polyphase interpolation as strided strips (the path
    for sps near an integer). Positions p_k = start + k·omega are split per
    G-symbol segment into a segment window, a stride-s0 slice per strip lane
    m, and a banded weight from 8 compare-selects; the taps are per-tap
    polynomials in frac, `coefs` ((deg+1, ntaps) on ext's device,
    `interp_tables`). Semantics mirror ff_resample_at. The plain version of
    the CUDA kernel K4 (ops/cuda/resample_strip.py), which equals it bit
    for bit."""
    ntaps = coefs.shape[1]
    geo = _strip_geometry(sps, ntaps)
    if geo is None:
        raise ValueError(f"resample_strip called with unsuitable sps {sps}")
    G, D = geo
    s0 = round(sps)
    dev = ext.device
    nseg = -(-out_cap // G)
    cap = nseg * G
    Lw, n_extp = strip_window(out_cap, ext.shape[0], G, D, s0, ntaps)
    # `front` zeros ahead of ext keep a segment window that starts before
    # the carried history (a block whose first symbols lie before it)
    # aligned with its symbols; the windows' contents are the same
    front = STRIP_FRONT
    pad = n_extp - front - ext.shape[0]
    extp = torch.cat([torch.zeros(front, dtype=ext.dtype, device=dev), ext,
                      torch.zeros(pad, dtype=ext.dtype, device=dev)])

    s_idx = torch.arange(nseg, dtype=F32, device=dev) * G
    c_s = torch.floor(start + s_idx * omega).to(torch.int64) + front
    c_s = c_s.clamp(0, extp.shape[0] - Lw)
    seg = extp[c_s[:, None] + torch.arange(Lw, device=dev)[None, :]]

    k = torch.arange(cap, dtype=F32, device=dev)
    p = start + k * omega + ntaps / 2
    ip = torch.floor(p)
    frac = p - ip
    src = ip.to(torch.int64)
    k_rel = torch.arange(G, device=dev)
    d = src.reshape(nseg, G) + front - c_s[:, None] - s0 * k_rel[None, :]
    d = d.clamp(0, D - 1)

    tp = coefs[0].expand(cap, ntaps)
    for row in coefs[1:]:
        tp = tp * frac[:, None] + row
    taps = tp.reshape(nseg, G, ntaps)

    M = D + ntaps
    # de-interleave once into s0 planes so each strip is a contiguous slice:
    # seg[:, m : m + s0·G : s0] == planes[m % s0][:, m//s0 : m//s0 + G]
    planes = [seg[:, r::s0] for r in range(s0)]
    y = torch.zeros((nseg, G), dtype=ext.dtype, device=dev)
    zero = torch.zeros((), dtype=F32, device=dev)
    for m in range(M):
        Xm = planes[m % s0][:, m // s0: m // s0 + G]
        md = m - d
        w = torch.zeros((nseg, G), dtype=F32, device=dev)
        for t in range(ntaps):
            w = w + torch.where(md == t, taps[..., t], zero)
        y = y + Xm * w
    pos = p - ntaps / 2
    valid = (pos >= -(ntaps // 2)) & (src < n_in) & \
            (pos < n_in - ntaps // 2)
    y = torch.where(valid[:cap].reshape(nseg, G), y, torch.zeros_like(y))
    return y.reshape(-1)[:out_cap].to(ext.dtype), valid[:out_cap]


def ff_clock_recovery(state: FFClockState, x: torch.Tensor, *, sps: float,
                      sub: int = 2048, bank=None, out_cap: int | None = None
                      ) -> Tuple[FFClockState, torch.Tensor, torch.Tensor]:
    """Feedforward symbol-timing recovery over one block.

    Returns (state', symbols[out_cap], valid[out_cap]). The symbol grid is
    anchored to the carried `next_pos`; only the fractional part snaps to
    this block's O&M estimate, so the symbol count stays continuous across
    block seams. `bank` is a host numpy (128, 8) array (default:
    firdes.mm_interpolator_bank()), on the device through `interp_tables`.

    Where `_strip_geometry(sps)` is None the symbols come from
    `resample_arith_grid`: the CUDA kernel K2 on the card, its plain
    version (the core of ff_resample_at) on the CPU; elsewhere from
    `resample_strip`: K4 on the card, its plain version on the CPU. The
    reference's `use_kernel` switch has no counterpart: the tensor's device
    decides.
    """
    dev = x.device
    if bank is None:
        bank = mm_interpolator_bank()
    bank_t, coefs = interp_tables(bank, sps, dev)
    nfilt, ntaps = bank_t.shape
    n = x.shape[-1]
    if out_cap is None:
        out_cap = int(np.ceil(n / sps * 1.01)) + 2

    tau0, skew = om_timing_fit(x, sps, sub)
    omega = sps * (1.0 + skew)

    # snap carried next_pos to the nearest point on the estimated timing grid
    k0 = torch.round((state.next_pos - tau0) / omega)
    start = tau0 + k0 * omega

    ext = torch.cat([state.history[: ntaps - 1], x])
    if coefs is not None:
        syms, valid = k4.resample_strip(ext, start, omega, coefs,
                                        out_cap=out_cap, sps=sps, n_in=n)
    else:
        k = torch.arange(out_cap, dtype=F32, device=dev)
        positions = start + k * omega
        # positions in float32, as the reference: at k·omega ≈ 2^21 the ulp
        # is 0.25 sample, which quantizes frac to 32 of the 128 branches
        y = resample_arith_grid(ext, start, omega, bank_t, out_cap=out_cap)
        valid = _valid_mask(positions, ntaps, n)
        syms = torch.where(valid, y, torch.zeros_like(y))

    # The first symbol is the one the previous block deferred (its window
    # reached past that block's end). This block's own timing estimate can
    # put it up to FIRST_SNAP samples before -ntaps/2, the earliest position
    # the carried history covers, where the grid marks it invalid and the
    # stream would lose a symbol: pick it at -ntaps/2 instead.
    lo = -(ntaps // 2)
    snap = (start < lo) & (start >= lo - FIRST_SNAP)
    y0 = interp_at(ext, torch.full((1,), lo, dtype=F32, device=dev), bank_t,
                   n)
    syms = torch.cat([torch.where(snap, y0, syms[:1]), syms[1:]])
    valid = torch.cat([valid[:1] | snap, valid[1:]])

    # next symbol position after the last valid one, rebased to the next
    # block (the grid's leading invalid symbols, before the history, count)
    n_valid = valid.sum()
    first = torch.argmax(valid.to(torch.uint8))
    next_pos = start + (first + n_valid).to(F32) * omega - n
    new_state = state._replace(next_pos=next_pos, history=ext[n:])
    return new_state, syms, valid


def _direct_mf(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Matched filter as ntaps shifted multiply-adds (direct form):
    y[k] = sum_t taps[t]*x[k-t+ntaps-1], causal on x."""
    ntaps = taps.shape[0]
    n = x.shape[-1]
    xp = torch.cat([torch.zeros(ntaps - 1, dtype=x.dtype, device=x.device), x])
    y = torch.zeros(n, dtype=x.dtype, device=x.device)
    for t in range(ntaps):
        c = float(taps[t])
        if c == 0.0:
            continue
        y = y + c * xp[ntaps - 1 - t: ntaps - 1 - t + n]
    return y


def _segmented_mf(x: torch.Tensor, taps: np.ndarray,
                  seg: int = 1 << 14) -> torch.Tensor:
    """Matched filter: direct form for short filters (<= 64 taps, the RRC
    case), else segmented overlap-save FFTs. Same causal alignment as
    _direct_mf."""
    ntaps = taps.shape[0]
    n = x.shape[-1]
    if ntaps <= 64:
        return _direct_mf(x, taps)
    taps32 = np.asarray(taps, np.float32)
    H_taps = _cached(("mf_taps", taps32.tobytes()), x.device,
                     lambda dev: _f32(taps32, dev, "psk_demod.mf_taps"))
    if n <= seg:
        nfft = max(256, 1 << int(np.ceil(np.log2(n + ntaps - 1))))
        X = torch.fft.fft(x, nfft)
        H = torch.fft.fft(H_taps, nfft)
        return torch.fft.ifft(X * H)[:n].to(C64)
    nseg = -(-n // seg)
    pad = nseg * seg - n
    z = lambda m: torch.zeros(m, dtype=x.dtype, device=x.device)  # noqa: E731
    xp = torch.cat([z(ntaps - 1), x, z(pad)])
    # overlapping windows: segment i covers [i*seg, i*seg + seg + ntaps - 1)
    body = xp[ntaps - 1:].reshape(nseg, seg)
    head = torch.cat([xp[: ntaps - 1][None],
                      body[:-1, seg - (ntaps - 1):]], dim=0)
    wins = torch.cat([head, body], dim=1)                # (nseg, seg+ntaps-1)
    nfft = 1 << int(np.ceil(np.log2(seg + ntaps - 1)))
    H = torch.fft.fft(H_taps, nfft)
    Y = torch.fft.ifft(torch.fft.fft(wins, nfft, dim=-1) * H[None], dim=-1)
    y = Y[:, ntaps - 1: ntaps - 1 + seg].reshape(-1)
    return y[:n].to(C64)


# ---------------------------------------------------------------------------
# Composite feedforward PSK demod block
# ---------------------------------------------------------------------------
def ff_psk_demod_block(state: FFClockState, x: torch.Tensor, *, order: int,
                       sps: float, rrc_taps: np.ndarray, bank=None,
                       sub_phase: int = 1024, sub_timing: int = 2048,
                       out_cap: int | None = None, oqpsk: bool = False
                       ) -> Tuple[FFClockState, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """Full feedforward PSK demod for one IQ block: AGC → RRC → CFO removal
    (FFT of x^M) → V&V phase → O&M timing + polyphase symbol pick. Mirrors
    PSKDemodModule's chain (module_psk_demod.cpp:88-137) with every feedback
    loop replaced by its feedforward dual.

    `oqpsk=True` adds the half-symbol Q realignment: a coarse V&V with a
    large sub-block, the imag rail delayed one sample (seam-carried), and a
    second, symbol-domain V&V on the picked symbols.

    x is a complex64 tensor; everything runs on its device. `rrc_taps` is a
    host numpy array. Returns (state', symbols[out_cap] complex64,
    valid[out_cap], snr_db).
    """
    if bank is None:
        bank = mm_interpolator_bank()
    n = x.shape[-1]

    # block AGC: normalize to unit mean magnitude
    g = 1.0 / x.abs().mean().clamp_min(1e-12)
    x = x * g

    # matched filter; seam-exact across blocks when the state carries the
    # RRC history tail
    ntaps_rrc = rrc_taps.shape[0]
    rh = state.rrc_history
    carry_rrc = rh is not None and rh.shape[0] == ntaps_rrc - 1
    xmf_in = torch.cat([rh * g, x]) if carry_rrc else x
    skip = ntaps_rrc - 1 if carry_rrc else 0
    xf = _segmented_mf(xmf_in, rrc_taps)[skip: skip + n]
    if carry_rrc:
        # store the pre-AGC tail so the next block's gain applies
        tail = x[n - (ntaps_rrc - 1):]
        state = state._replace(rrc_history=tail / g)

    # carrier: coarse CFO + fine V&V phase (continuity-carried). Diagonal
    # QPSK puts u^4 at e^{jπ}: pass θ0 = π/4.
    f = cfo_estimate(xf, order, suppress_nyquist_image=(sps < 2.1))
    xc = cfo_correct(xf, f, state.nco_phase)
    nco = torch.remainder(state.nco_phase + 2 * math.pi * f * n, 2 * math.pi)
    theta0 = float(np.pi / 4) if order == 4 else 0.0
    if oqpsk:
        sub_phase = max(sub_phase, 4096)
    ph_t, last_ph = vv_phase_track(xc, order, sub_phase, state.last_phase,
                                   const_rotation=theta0)
    xp = xc * torch.exp(-1j * ph_t).to(xc.dtype)

    if oqpsk:
        # realign the Q rail: Im[t] <- Im[t-1], previous block's trailing
        # imag carried across the seam
        oq = state.oq_imag if state.oq_imag is not None \
            else torch.zeros((), dtype=F32, device=x.device)
        prev_im = torch.cat([oq[None].to(F32), xp[:-1].imag])
        state = state._replace(oq_imag=xp[-1].imag.to(F32))
        xp = torch.complex(xp.real, prev_im).to(xp.dtype)

    # timing + symbol pick
    state2, syms, valid = ff_clock_recovery(
        state._replace(last_phase=last_ph, last_f=f, nco_phase=nco), xp,
        sps=sps, sub=sub_timing, bank=bank, out_cap=out_cap)

    if oqpsk:
        # second-stage V&V on the picked symbols, continuity in sym_phase
        sp = state2.sym_phase if state2.sym_phase is not None \
            else torch.zeros((), dtype=F32, device=x.device)
        ph_s, last_sp = vv_phase_track(
            torch.where(valid, syms, torch.zeros_like(syms)), order,
            min(1024, max(64, syms.shape[0] // 8)), sp,
            const_rotation=theta0)
        syms = syms * torch.exp(-1j * ph_s).to(syms.dtype)
        state2 = state2._replace(sym_phase=last_sp)

    # SNR on the picked symbols (M2M4, as the reference's estimator)
    p = torch.where(valid, syms, torch.zeros_like(syms)).abs() ** 2
    cnt = valid.sum().clamp_min(1)
    m2 = p.sum() / cnt
    m4 = (p ** 2).sum() / cnt
    es = torch.sqrt((2 * m2 * m2 - m4).clamp_min(0.0))
    noise = (m2 - es).clamp_min(1e-20)
    snr = 10.0 * torch.log10((es / noise).clamp_min(1e-20))
    return state2, syms, valid, snr


class FFBlockGraph:
    """`ff_psk_demod_block` of one fixed block on the card as one CUDA graph
    (ops/cuda/graph.py), captured once. The graph reads the static input
    `x` and the tensors of `state`, and at its end writes the new state
    into those tensors in place. A call copies a block into `x`, replays
    the graph and returns its (symbols, valid, snr): the graph's own
    tensors, which its next call overwrites. The warm-up runs on copies of
    the state, and the state is set back after the graph's first run at
    construction, so the stream's first block starts from `state` as
    given. Each stream has its own: two demodulators with equal parameters
    share no state.

    `state` is on the card (`ff_clock_init`), `n` the block's length; `kw`
    as `ff_psk_demod_block`'s."""

    def __init__(self, state: FFClockState, n: int, **kw):
        dev = state.next_pos.device
        self.x = torch.zeros(n, dtype=C64, device=dev)
        start = [t.clone() for t in state]

        def block():
            new, syms, valid, snr = ff_psk_demod_block(state, self.x, **kw)
            for dst, src in zip(state, new):
                dst.copy_(src)
            return syms, valid, snr

        def warm_up():
            return ff_psk_demod_block(
                FFClockState(*(t.clone() for t in state)), self.x, **kw)[1:]

        self._graph = Graph(block, dev, warm_up)
        for dst, src in zip(state, start):
            dst.copy_(src)

    def __call__(self, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        self.x.copy_(x)
        self._graph.replay()
        trace.count("psk_demod.graph_replays")
        return self._graph.out
