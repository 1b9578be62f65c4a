"""K4, the strip symbol pick (csrc/resample_strip.cu, wrapper
ops/cuda/resample_strip.py), against its plain version
ops/ffsync.py::resample_strip.

On the CPU: a numpy mirror of the kernel's arithmetic (each thread's
window start, offset, Horner taps and 8-term sum, each operation rounded to
float32 on its own) equals the plain version bit for bit at the shapes and
edges the card test takes; the wrapper raises on what the kernel does not
take, and on a CUDA tensor it never runs the plain version instead.

On the card (marker `card`, skipped without one), the kernel equals the
plain version bit for bit (`torch.equal` on symbols and valid flags) at
FY-3D's block (2^18 samples at sps 3, out_cap 88,266) and at GRB's sps 2,
with the edges below. This file imports no JAX: on the card, run
`python3 -m pytest --noconftest -p no:cacheprovider -q
tests/test_torch_resample_strip.py`.
"""

import numpy as np
import pytest
import torch

from satdump_tpu_torch.ops import ffsync
from satdump_tpu_torch.ops.cuda import resample_strip as k4
from satdump_tpu_torch.ops.firdes import mm_interpolator_bank

F32 = np.float32
N = 1 << 18
# (sps, skew, start): FY-3D's sps 3 and GRB's 2, skews at the strip
# geometry's bound +-0.003; a start a hair before the carried history (the
# FIRST_SNAP case, -4.1), well before it so that the first windows' c_s
# clamps at 0 (-40.3), and so far into the block that the last windows'
# c_s clamps at the padded end (5000.7); every grid runs past n_in
CASES = {
    "fy3d_sps3": (3.0, 0.0, 0.37),
    "fy3d_skew+0.003": (3.0, 0.003, 1.61),
    "fy3d_skew-0.003": (3.0, -0.003, -2.2),
    "fy3d_first_snap": (3.0, 0.0015, -4.1),
    "fy3d_cs_clamp_low": (3.0, -0.003, -40.3),
    "fy3d_cs_clamp_high": (3.0, 0.003, 5000.7),
    "grb_sps2": (2.0, 0.0, 0.61),
    "grb_skew+0.003": (2.0, 0.003, -4.05),
    "grb_skew-0.003": (2.0, -0.003, 0.93),
    "grb_cs_clamp_low": (2.0, 0.0, -37.9),
}


def _cap(sps: float, n: int = N) -> int:
    """psk_demod's out_cap for a block of n samples."""
    return int(np.ceil(n / (sps * 0.99))) + 2


def _inputs(seed: int, sps: float, skew: float, start: float, n: int = N):
    """Unit-variance samples behind a 7-sample history, start and omega as
    float32 scalars, the tap polynomials, out_cap."""
    rng = np.random.default_rng(seed)
    ext = (rng.standard_normal(n + 7) + 1j * rng.standard_normal(n + 7)
           ).astype(np.complex64)
    omega = F32(sps) * (F32(1.0) + F32(skew))
    _, coefs = ffsync.interp_tables(mm_interpolator_bank(), sps, "cpu")
    return ext, F32(start), F32(omega), coefs, _cap(sps, n)


def _plain(ext, start, omega, coefs, cap, sps, n):
    return ffsync.resample_strip(torch.from_numpy(ext), torch.tensor(start),
                                 torch.tensor(omega), coefs, out_cap=cap,
                                 sps=sps, n_in=n)


def _k4_mirror(ext, start, omega, coefs, out_cap, sps, n_in):
    """What each thread of csrc/resample_strip.cu computes, in numpy
    float32, one rounded operation at a time."""
    co = coefs.numpy()
    ntaps = co.shape[1]
    G, D = ffsync._strip_geometry(sps, ntaps)
    s0 = round(sps)
    front = ffsync.STRIP_FRONT
    n_ext = ext.shape[0]
    lw, n_extp = ffsync.strip_window(out_cap, n_ext, G, D, s0, ntaps)
    k = np.arange(out_cap, dtype=np.int64)
    j = k // G
    g = k - j * G
    pj = F32(start) + (j * G).astype(F32) * F32(omega)
    cs = np.clip(np.floor(pj).astype(np.int64) + front, 0, n_extp - lw)
    p = (F32(start) + k.astype(F32) * F32(omega)) + F32(ntaps / 2)
    ip = np.floor(p)
    frac = p - ip
    src = ip.astype(np.int64)
    d = np.clip(src + front - cs - s0 * g, 0, D - 1)
    tap = np.broadcast_to(co[0], (out_cap, ntaps)).astype(F32)
    for r in range(1, co.shape[0]):
        tap = tap * frac[:, None] + co[r][None, :]
    e0 = cs + s0 * g + d - front
    re = np.zeros(out_cap, F32)
    im = np.zeros(out_cap, F32)
    for t in range(ntaps):
        e = e0 + t
        inside = (e >= 0) & (e < n_ext)
        v = np.where(inside, ext[np.clip(e, 0, n_ext - 1)], 0)
        if t == 0:
            re, im = v.real * tap[:, 0], v.imag * tap[:, 0]
        else:
            re = re + v.real * tap[:, t]
            im = im + v.imag * tap[:, t]
    pos = p - F32(ntaps / 2)
    valid = (pos >= -(ntaps // 2)) & (src < n_in) & \
        (pos < F32(n_in - ntaps // 2))
    y = np.where(valid, re + 1j * im, 0).astype(np.complex64)
    return y, valid, cs


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_mirror_equals_plain_bit_for_bit(case):
    sps, skew, start = CASES[case]
    n = 1 << 15        # the whole 2^18 block runs on the card
    ext, start, omega, coefs, cap = _inputs(7, sps, skew, start, n)
    got, valid, cs = _k4_mirror(ext, start, omega, coefs, cap, sps, n)
    ys, vs = _plain(ext, start, omega, coefs, cap, sps, n)
    np.testing.assert_array_equal(valid, vs.numpy())
    np.testing.assert_array_equal(got, ys.numpy())
    assert valid.sum() > 0.95 * n / sps * (0.5 if start > 1000 else 1.0)
    assert not valid[-1]                # the grid runs past n_in
    G, D = ffsync._strip_geometry(sps, 8)
    lw, n_extp = ffsync.strip_window(cap, n + 7, G, D, round(sps))
    top = n_extp - lw
    if "clamp_low" in case:
        assert cs[0] == 0
    if "clamp_high" in case:
        assert cs[-1] == top
    else:
        assert cs.max() < top


def test_wrapper_runs_the_plain_version_on_the_cpu():
    ext, start, omega, coefs, cap = _inputs(3, 3.0, 0.001, 0.4, 1 << 14)
    before = k4.resample_strip.launches
    ys, vs = k4.resample_strip(torch.from_numpy(ext), torch.tensor(start),
                               torch.tensor(omega), coefs, out_cap=cap,
                               sps=3.0, n_in=1 << 14)
    ps, pv = _plain(ext, start, omega, coefs, cap, 3.0, 1 << 14)
    assert torch.equal(ys, ps) and torch.equal(vs, pv)
    assert k4.resample_strip.launches == before


def _bad_inputs(what: str):
    """Wrapper arguments, each with one thing the kernel does not take."""
    ext, start, omega, coefs, cap = _inputs(3, 3.0, 0.0, 0.4, 4096)
    e, s, o = torch.from_numpy(ext), torch.tensor(start), torch.tensor(omega)
    kw = dict(out_cap=cap, sps=3.0, n_in=4096)
    meta = {k: v.to("meta") for k, v in (("e", e), ("s", s), ("o", o),
                                         ("c", coefs))}
    return {
        "complex128 ext": (e.to(torch.complex128), s, o, coefs, kw),
        "2-D ext": (e[:4095].reshape(-1, 5), s, o, coefs, kw),
        "strided ext": (e[::2], s, o, coefs, dict(kw, n_in=2040)),
        "float64 start": (e, s.double(), o, coefs, kw),
        "two omegas": (e, s, o.repeat(2), coefs, kw),
        "coefs (10, 8)": (e, s, o, coefs[1:], kw),
        "float64 coefs": (e, s, o, coefs.double(), kw),
        "out_cap 2^24": (e, s, o, coefs, dict(kw, out_cap=1 << 24)),
        "n_in past ext": (e, s, o, coefs, dict(kw, n_in=4097)),
        "sps with no strip": (e, s, o, coefs, dict(kw, sps=18 / 7)),
        "meta device": (meta["e"], meta["s"], meta["o"], meta["c"], kw),
        "coefs on another device": (e, s, o, meta["c"], kw),
    }[what]


@pytest.mark.parametrize("what", [
    "complex128 ext", "2-D ext", "strided ext", "float64 start",
    "two omegas", "coefs (10, 8)", "float64 coefs", "out_cap 2^24",
    "n_in past ext", "sps with no strip", "meta device",
    "coefs on another device"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(what):
    a, b, c, d, kw = _bad_inputs(what)
    before = k4.resample_strip.launches
    with pytest.raises(ValueError, match="resample_strip"):
        k4.resample_strip(a, b, c, d, **kw)
    assert k4.resample_strip.launches == before


def test_wrapper_raises_on_cuda_without_fallback(monkeypatch):
    """No card here: given CUDA tensors the wrapper tries its kernel and
    raises; it never runs the plain version instead."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernel runs")
    from tests.test_torch_scaffold import _CudaLike

    class FellBack(Exception):
        pass

    def no_fallback(*a, **k):
        raise FellBack("wrapper fell back to the plain version")

    monkeypatch.setattr(ffsync, "resample_strip", no_fallback)
    before = k4.resample_strip.launches
    with pytest.raises(Exception) as e:
        k4.resample_strip(_CudaLike((N + 7,), torch.complex64),
                          _CudaLike((), torch.float32),
                          _CudaLike((), torch.float32),
                          _CudaLike((11, 8), torch.float32),
                          out_cap=_cap(3.0), sps=3.0, n_in=N)
    assert not isinstance(e.value, FellBack), e.value
    assert k4.resample_strip.launches == before


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: runs on the card")
    return "cuda"


@pytest.mark.card
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_equals_plain_on_the_card(case, card):
    sps, skew, start = CASES[case]
    ext, start, omega, _, cap = _inputs(11, sps, skew, start)
    _, coefs = ffsync.interp_tables(mm_interpolator_bank(), sps, card)
    ps, pv = _plain(ext, start, omega, coefs.cpu(), cap, sps, N)
    e = torch.from_numpy(ext).to(card)
    s, o = torch.tensor(start, device=card), torch.tensor(omega, device=card)
    before = k4.resample_strip.launches
    ys, vs = k4.resample_strip(e, s, o, coefs, out_cap=cap, sps=sps, n_in=N)
    torch.cuda.synchronize()
    assert k4.resample_strip.launches == before + 1
    assert ys.device.type == "cuda" and ys.shape == (cap,)
    assert torch.equal(vs.cpu(), pv)
    assert torch.equal(ys.cpu(), ps)
    # the plain version on the card computes the same
    cs, cv = ffsync.resample_strip(e, s, o, coefs, out_cap=cap, sps=sps,
                                   n_in=N)
    assert torch.equal(cv, vs) and torch.equal(cs, ys)
