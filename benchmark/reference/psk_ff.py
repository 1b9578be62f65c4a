"""The plain reference of `psk_demod`'s feedforward chain: baseband blocks ->
int8 soft symbols, in plain torch, on any device.

A frozen copy of the plain versions in the port (`ops/ffsync.py`'s
`ff_psk_demod_block` for QPSK at sps >= 2.1, `ops/cuda/resample.py`'s
`interp_at` for K2's symbol pick, `ops/firdes.py`'s bank,
`pipeline/modules/demod/{psk,base}.py`'s blocking, `keep_valid` and
quantization), with the same operations in the same order, so that on one
device it gives the program's softs where the program runs these plain
operations. It imports nothing of the program and takes nothing that the
program made: taps, bank and states are worked out here again.

`precision="bfloat16"` is the control: each stage's output, the taps and the
bank rounded to bfloat16 (float32 arithmetic in between).

`check(run, driver)` decides a run's `correct`: the program's softs against
`demod` of the same samples, and its CADUs against those sent. `READS` says
which of its numbers reads each level that the program writes, and
`control(x, cfg)` gives the control's reading of the number it moves.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from harness.check import soft_mismatch, softs_and_cadus
from harness.tx import root_raised_cosine

F32, C64 = torch.float32, torch.complex64
FIRST_SNAP = 0.25
STRIP_FRONT = 32
NFILT, NTAPS = 128, 8
# the number of `check` that reads each level of the configuration's
# `levels` that the program writes
READS = {"soft": "soft_mismatch", "cadu": "cadus_failed"}
# the precision of the control: the one below the configurations' float32
CONTROL = "bfloat16"


def _rounder(precision: str):
    if precision == "float32":
        return lambda x: x
    if precision != "bfloat16":
        raise ValueError(f"no control for precision {precision}")

    def q(x):
        if torch.is_complex(x):
            return torch.complex(x.real.to(torch.bfloat16).to(F32),
                                 x.imag.to(torch.bfloat16).to(F32))
        return x.to(torch.bfloat16).to(x.dtype)
    return q


def mm_interpolator_bank() -> np.ndarray:
    """(128, 8) float32: a Nuttall-windowed sinc of 1024 taps at pi / 128,
    norm 128, in the reversed-branch polyphase layout."""
    count, omega, norm = NFILT * NTAPS, np.pi / NFILT, float(NFILT)
    half = count / 2.0
    t = np.arange(count, dtype=np.float64) - half + 0.5
    x = t * omega
    s = np.where(x == 0.0, 1.0, np.sin(x) / np.where(x == 0.0, 1.0, x))
    n, win, sign = t - half, np.zeros(count), 1.0
    for i, c in enumerate((0.355768, 0.487396, 0.144232, 0.012604)):
        win += sign * c * np.cos(i * 2.0 * np.pi * n / count)
        sign = -sign
    proto = (s * win * (norm * omega / np.pi)).astype(np.float32)
    bank = np.zeros((NFILT, NTAPS), np.float32)
    for i in range(count):
        bank[(NFILT - 1) - (i % NFILT), i // NFILT] = proto[i]
    return bank


def _ipow(x, y: int):
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def _wrap(a, period: float):
    return torch.remainder(a + period / 2, period) - period / 2


def _f32(a, device):
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def cfo_estimate(x, order: int):
    n = x.shape[-1]
    u = x / x.abs().clamp_min(1e-12)
    p = torch.fft.fft(_ipow(u, order)).abs()
    k = torch.argmax(p)
    pm1, p0, pp1 = p[(k - 1) % n], p[k], p[(k + 1) % n]
    denom = pm1 - 2.0 * p0 + pp1
    delta = torch.where(denom.abs() > 1e-9, 0.5 * (pm1 - pp1) / denom,
                        torch.zeros_like(denom)).clamp(-0.5, 0.5)
    f = (k.to(F32) + delta) / n
    return (torch.remainder(f + 0.5, 1.0) - 0.5) / order


def vv_phase_track(x, order: int, sub: int, last_phase, const_rotation):
    n = x.shape[-1]
    nsub = n // sub
    u = x[: nsub * sub].reshape(nsub, sub)
    s = _ipow(u / u.abs().clamp_min(1e-12), order).sum(dim=-1)
    if const_rotation:
        s = s * torch.exp(torch.tensor(-1j * order * const_rotation,
                                       dtype=C64, device=x.device))
    ph = torch.angle(s) / order
    period = 2 * math.pi / order
    d = _wrap(torch.diff(ph), period)
    first = last_phase + _wrap(ph[0] - last_phase, period)
    ph_u = torch.cat([first[None], first + torch.cumsum(d, 0)])
    slopes = ph_u[1:] - ph_u[:-1]
    ramp = torch.arange(sub, dtype=F32, device=x.device) / sub
    core = (ph_u[:-1, None] + slopes[:, None] * ramp[None, :]).reshape(-1)
    head = ph_u[0].expand(sub // 2)
    tail = ph_u[-1].expand(n - (nsub - 1) * sub - sub // 2)
    return torch.cat([head, core, tail]), ph_u[-1]


def om_timing_fit(x, sps: float, sub: int):
    e_sig = x.real ** 2 + x.imag ** 2
    n = e_sig.shape[-1]
    nsub = n // sub
    e = e_sig[: nsub * sub].reshape(nsub, sub)
    dev = x.device
    tk = np.exp(-2j * np.pi * (np.arange(sub) % sps) / sps)
    tj = np.exp(-2j * np.pi * ((np.arange(nsub) * float(sub)) % sps) / sps)
    cr = e @ _f32(tk.real, dev)
    ci = e @ _f32(tk.imag, dev)
    c = torch.as_tensor(tj.astype(np.complex64), device=dev) \
        * torch.complex(cr, ci)
    tau = -torch.angle(c) / (2 * math.pi) * sps
    d = _wrap(torch.diff(tau), sps)
    tau_u = torch.cat([tau[:1], tau[0] + torch.cumsum(d, 0)])
    tc = (torch.arange(nsub, dtype=F32, device=dev) + 0.5) * sub
    w = c.abs() + 1e-12
    wm = w.sum()
    tm = (w * tc).sum() / wm
    ym = (w * tau_u).sum() / wm
    cov = (w * (tc - tm) * (tau_u - ym)).sum()
    var = (w * (tc - tm) ** 2).sum()
    slope = torch.where(var > 0, cov / var,
                        torch.zeros_like(var)).clamp(-0.01, 0.01)
    return ym - slope * tm, slope


def interp_at(ext, positions, bank, n_in: int):
    """K2's plain version: the bank's 8 taps on ext[src .. src + 8) at each
    position (+4, the bank's group delay)."""
    nfilt, ntaps = bank.shape
    p = positions + ntaps / 2
    ip = torch.floor(p)
    frac = p - ip
    srcc = ip.to(torch.int64).clamp(0, n_in - 1)
    branch = torch.round(frac * nfilt).to(torch.int64).clamp(0, nfilt - 1)
    idx = srcc[:, None] + torch.arange(ntaps, device=ext.device)[None, :]
    return (ext[idx] * bank[branch]).sum(dim=-1)


def _valid_mask(positions, ntaps: int, n_in: int):
    valid_in = (positions >= -(ntaps // 2)) & (positions < n_in - ntaps // 2)
    src = torch.floor(positions + ntaps / 2).to(torch.int64)
    return valid_in & (src < n_in)


def strip_geometry(sps: float, ntaps: int, skew_max: float = 0.003):
    """(segment G, strip width D) where sps is near enough an integer for
    the strided-strip pick, else None."""
    s0 = round(sps)
    if s0 < 1:
        return None
    drift_rate = abs(sps - s0) + s0 * skew_max
    D = 24
    if drift_rate <= 0:
        return 2048, D
    G = int((D - ntaps - 2) / drift_rate)
    if G < 128:
        return None
    return min(2048, 1 << (G.bit_length() - 1)), D


def bank_poly_coefs(bank: np.ndarray, deg: int = 10) -> np.ndarray:
    nfilt, ntaps = bank.shape
    fr = np.arange(nfilt) / nfilt
    return np.stack([np.polyfit(fr, np.asarray(bank[:, t], np.float64), deg)
                     for t in range(ntaps)], axis=1).astype(np.float32)


def resample_strip(ext, start, omega, coefs, *, out_cap: int, sps: float,
                   n_in: int, q):
    """The strided-strip pick for sps near an integer: per G-symbol segment
    a window, a stride-s0 slice per strip lane, the taps as polynomials in
    the fractional delay."""
    ntaps = coefs.shape[1]
    G, D = strip_geometry(sps, ntaps)
    s0 = round(sps)
    dev = ext.device
    nseg = -(-out_cap // G)
    cap = nseg * G
    Lw = s0 * G + D + ntaps + 8
    pad = max(cap * s0 + Lw + 64 - ext.shape[0], 0)
    front = STRIP_FRONT
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
    d = (src.reshape(nseg, G) + front - c_s[:, None]
         - s0 * k_rel[None, :]).clamp(0, D - 1)
    tp = _f32(coefs[0], dev)[None, :].expand(cap, ntaps)
    for row in coefs[1:]:
        tp = tp * frac[:, None] + _f32(row, dev)[None, :]
    taps = q(tp).reshape(nseg, G, ntaps)
    planes = [seg[:, r::s0] for r in range(s0)]
    y = torch.zeros((nseg, G), dtype=ext.dtype, device=dev)
    zero = torch.zeros((), dtype=F32, device=dev)
    for m in range(D + ntaps):
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


class PSKReference:
    """The feedforward chain of one psk_demod stream: `block(x, valid,
    last)` takes one zero-padded complex64 block and returns its int8
    softs, carrying the state from block to block as the program does."""

    def __init__(self, samplerate: float, symbolrate: float, alpha: float,
                 order: int, block: int, rrc_taps: int, device,
                 precision: str = "float32"):
        self.sps = samplerate / symbolrate
        if self.sps < 2.1 or order != 4:
            raise NotImplementedError("the reference covers QPSK at "
                                      "sps >= 2.1")
        self.q = _rounder(precision)
        self.order, self.n, self.dev = order, block, torch.device(device)
        self.rrc = root_raised_cosine(self.sps, alpha, rrc_taps).astype(
            np.float32)
        bank = mm_interpolator_bank()
        self.bank = self.q(torch.as_tensor(bank, device=self.dev))
        self.strip = strip_geometry(self.sps, NTAPS) is not None
        self.coefs = bank_poly_coefs(bank) if self.strip else None
        self.out_cap = int(np.ceil(block / (self.sps * 0.99))) + 2
        z = lambda: torch.zeros((), dtype=F32, device=self.dev)  # noqa: E731
        self.next_pos, self.last_phase, self.nco = z(), z(), z()
        self.history = torch.zeros(NTAPS - 1, dtype=C64, device=self.dev)
        self.rrc_history = torch.zeros(len(self.rrc) - 1, dtype=C64,
                                       device=self.dev)

    def _mf(self, x):
        taps, n = self.rrc, x.shape[-1]
        nt = taps.shape[0]
        xp = torch.cat([torch.zeros(nt - 1, dtype=x.dtype, device=x.device),
                        x])
        y = torch.zeros(n, dtype=x.dtype, device=x.device)
        for t in range(nt):
            c = float(self.q(torch.tensor(float(taps[t]))))
            if c != 0.0:
                y = y + c * xp[nt - 1 - t: nt - 1 - t + n]
        return y

    def _clock(self, x):
        sps, dev, n = self.sps, self.dev, self.n
        tau0, skew = om_timing_fit(x, sps, 2048)
        omega = sps * (1.0 + skew)
        start = tau0 + torch.round((self.next_pos - tau0) / omega) * omega
        k = torch.arange(self.out_cap, dtype=F32, device=dev)
        positions = start + k * omega
        ext = torch.cat([self.history[: NTAPS - 1], x])
        if self.strip:
            syms, valid = resample_strip(ext, start, omega, self.coefs,
                                         out_cap=self.out_cap, sps=sps,
                                         n_in=n, q=self.q)
        else:
            kk = torch.arange(self.out_cap, dtype=F32, device=dev)
            y = interp_at(ext, start + kk * omega, self.bank,
                          ext.shape[0] - (NTAPS - 1))
            valid = _valid_mask(positions, NTAPS, n)
            syms = torch.where(valid, y, torch.zeros_like(y))
        lo = -(NTAPS // 2)
        snap = (start < lo) & (start >= lo - FIRST_SNAP)
        y0 = interp_at(ext, torch.full((1,), lo, dtype=F32, device=dev),
                       self.bank, n)
        syms = torch.cat([torch.where(snap, y0, syms[:1]), syms[1:]])
        valid = torch.cat([valid[:1] | snap, valid[1:]])
        first = torch.argmax(valid.to(torch.uint8))
        self.next_pos = start + (first + valid.sum()).to(F32) * omega - n
        self.history = ext[n:]
        return self.q(syms), valid

    def block(self, x, valid_n: int, last: bool) -> np.ndarray:
        q, n = self.q, self.n
        x = q(x)
        g = 1.0 / x.abs().mean().clamp_min(1e-12)
        x = q(x * g)
        nt = len(self.rrc)
        xf = q(self._mf(torch.cat([self.rrc_history * g, x]))[nt - 1:
                                                            nt - 1 + n])
        self.rrc_history = x[n - (nt - 1):] / g
        f = cfo_estimate(xf, self.order)
        nn = torch.arange(n, dtype=F32, device=self.dev)
        xc = q(xf * torch.exp(-1j * (2 * math.pi * f * nn + self.nco)
                              ).to(xf.dtype))
        self.nco = torch.remainder(self.nco + 2 * math.pi * f * n,
                                   2 * math.pi)
        ph_t, self.last_phase = vv_phase_track(xc, self.order, 1024,
                                               self.last_phase,
                                               float(np.pi / 4))
        xp = q(xc * torch.exp(-1j * ph_t).to(xc.dtype))
        syms, vmask = self._clock(xp)
        s = syms[vmask]
        if last and valid_n < n:
            s = s[:min(int(len(s) * valid_n / n) + 2, len(s))]
        s = s.cpu().numpy()
        out = np.empty(2 * len(s), np.int8)
        out[0::2] = np.clip(s.real * 100.0, -127, 127).astype(np.int8)
        out[1::2] = np.clip(s.imag * 100.0, -127, 127).astype(np.int8)
        return out


def demod(x: torch.Tensor, cfg: dict, precision: str | None = None):
    """A whole complex64 stream (on the device to run on) through the
    configuration's demod in its blocks, the last zero-padded as the
    program pads it, in the configuration's `precision` unless another is
    given (the control). Returns (softs int8, soft values of each block).
    Raises where the symbol timing it picks is not the configuration's
    `demod.timing`."""
    s, d = cfg["signal"], cfg["demod"]
    p = cfg["pipeline_parameters"]["soft"]
    ref = PSKReference(float(s["samplerate"]), float(p["symbolrate"]),
                       float(p["rrc_alpha"]), d["order"], d["block"],
                       d["rrc_taps"], x.device,
                       precision or cfg["precision"])
    picked = "strip" if ref.strip else "arith_grid"
    if d["timing"] != picked:
        raise ValueError(f"the reference picks {picked} timing, the "
                         f"configuration states {d['timing']}")
    n, B = x.shape[0], d["block"]
    outs = []
    for a in range(0, n, B):
        blk = x[a: a + B]
        valid = blk.shape[0]
        if valid < B:
            blk = torch.cat([blk, torch.zeros(B - valid, dtype=C64,
                                              device=x.device)])
        outs.append(ref.block(blk, valid, a + B >= n))
    return np.concatenate(outs), np.array([len(o) for o in outs])


def check(run, driver) -> dict:
    """`soft_mismatch` and `cadus_failed` of the run's outputs, with
    `attempted` and `failed` CADUs (`harness/check.py`)."""
    return softs_and_cadus(run, driver, demod)


def control(x: torch.Tensor, cfg: dict) -> dict:
    """The control's reading, {check: value}: `demod` of the complex64
    stream `x` in `CONTROL` against `demod` in the configuration's
    precision, by `soft_mismatch` (the upper reading of its limit)."""
    ref = demod(x, cfg)[0]
    bad, total = soft_mismatch(demod(x, cfg, CONTROL)[0], ref)
    return {"soft_mismatch": bad / total}
