"""The transmitter and channel that make a cell's recording from its seed.

A frozen copy of the conventions of the port's test generator
(`satdump_tpu_torch/sim.py`: `make_cadus`, `encode_cadu_stream`,
`fengyun_diff_encode`, `qpsk_modulate_rational`, `ChannelModel`), written in
torch so that it runs on the card in a few large calls: random CADU payloads,
RS(255,223) in the CCSDS dual basis at interleave depth 4, the CCSDS
pseudo-noise, the k=7 r=1/2 code {79, 109}, QPSK (I = first bit,
(2b - 1) / sqrt 2), an RRC pulse at exactly sps = up / down, AWGN, a carrier
offset and phase, then int16 IQ. Nothing here imports the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

ASM = (0x1A, 0xCF, 0xFC, 0x1D)
POLYA, POLYB = 79, 109
PRIM_POLY = 0x187
RS_K, RS_N, RS_FCR, RS_PRIM = 223, 255, 112, 11
_TAL = (0x8D, 0xEF, 0xEC, 0x86, 0xFA, 0x99, 0xAF, 0x7B)


@dataclass
class Recording:
    """A generated downlink: `iq` (n, 2) int16 on the generating device,
    the CADUs sent (N, bytes) uint8 on the host, and for each CADU the
    sample index just past its last symbol."""
    iq: torch.Tensor
    cadus: np.ndarray
    cadu_end: np.ndarray
    samplerate: float


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


# -- Reed-Solomon (255, 223), CCSDS dual basis -------------------------------
def _gf_tables():
    exp = np.zeros(512, np.int64)
    log = np.zeros(256, np.int64)
    x = 1
    for i in range(255):
        exp[i], log[x] = x, i
        x <<= 1
        if x & 0x100:
            x ^= PRIM_POLY
    exp[255:510] = exp[:255]
    a = np.arange(256)
    s = log[a][:, None] + log[a][None, :]
    mul = exp[s % 255]
    mul[0, :] = 0
    mul[:, 0] = 0
    return exp, mul


def _rs_generator(exp, mul) -> np.ndarray:
    g = np.zeros(RS_N - RS_K + 1, np.int64)
    g[0] = 1
    for j in range(RS_N - RS_K):
        root = exp[(RS_PRIM * (RS_FCR + j)) % 255]
        ng = np.zeros_like(g)
        ng[1:] = g[:-1]
        ng ^= mul[g, root]
        g = ng
    return g                     # g[i] = coefficient of x^i, g[-1] = 1


def _dual_tables():
    to_dual = np.zeros(256, np.int64)
    for i in range(256):
        for k in range(8):
            if i & (1 << k):
                to_dual[i] ^= _TAL[7 - k]
    from_dual = np.zeros(256, np.int64)
    from_dual[to_dual] = np.arange(256)
    return to_dual, from_dual


def rs_encode(data: torch.Tensor, depth: int) -> torch.Tensor:
    """(B, 223 * depth) uint8 -> (B, 255 * depth) interleaved codewords in
    the dual basis (byte i of a codeword: coefficient of x^(254 - i))."""
    exp, mul = _gf_tables()
    g = _rs_generator(exp, mul)[:-1][::-1]          # g_31 .. g_0
    to_dual, from_dual = _dual_tables()
    dev = data.device
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)  # noqa
    gmul, td, fd = t(mul[:, g]), t(to_dual), t(from_dual)
    B = data.shape[0]
    msg = data.reshape(B, RS_K, depth).transpose(1, 2).reshape(B * depth,
                                                               RS_K)
    msg = fd[msg.long()]
    par = torch.zeros(B * depth, RS_N - RS_K, dtype=torch.int64, device=dev)
    for i in range(RS_K):
        fb = msg[:, i] ^ par[:, 0]
        par = torch.cat([par[:, 1:], torch.zeros_like(par[:, :1])], 1)
        par ^= gmul[fb]
    cw = td[torch.cat([msg, par], 1)]
    return cw.reshape(B, depth, RS_N).transpose(1, 2).reshape(
        B, RS_N * depth).to(torch.uint8)


def make_cadus(n: int, gen: torch.Generator, depth: int = 4
               ) -> torch.Tensor:
    """n random CADUs: ASM, then `depth` interleaved RS codewords of random
    data. (n, 4 + 255 * depth) uint8 on the generator's device."""
    dev = gen.device
    data = torch.randint(0, 256, (n, RS_K * depth), generator=gen,
                         device=dev, dtype=torch.int64).to(torch.uint8)
    asm = torch.tensor(ASM, dtype=torch.uint8, device=dev).expand(n, 4)
    return torch.cat([asm, rs_encode(data, depth)], 1)


# -- CCSDS pseudo-noise ------------------------------------------------------
def pn_bytes(n: int = 255) -> np.ndarray:
    """The CCSDS PN (x^8 + x^7 + x^5 + x^3 + 1, all-ones seed), n bytes."""
    reg, out = 0xFF, np.zeros(n, np.uint8)
    for i in range(n * 8):
        out[i // 8] = (out[i // 8] << 1) | ((reg >> 7) & 1)
        fb = ((reg >> 7) ^ (reg >> 4) ^ (reg >> 2) ^ reg) & 1
        reg = ((reg << 1) | fb) & 0xFF
    return out


def randomize(cadus: torch.Tensor) -> torch.Tensor:
    """XOR every byte after the ASM with the PN, restarting each CADU."""
    n = cadus.shape[1] - 4
    pn = np.tile(pn_bytes(), -(-n // 255))[:n]
    out = cadus.clone()
    out[:, 4:] ^= torch.as_tensor(pn, device=cadus.device)
    return out


def unpack_bits(b: torch.Tensor) -> torch.Tensor:
    """uint8 bytes -> their bits, most significant first, flattened."""
    sh = torch.arange(7, -1, -1, device=b.device, dtype=torch.uint8)
    return ((b.reshape(-1, 1) >> sh) & 1).reshape(-1)


# -- the convolutional code and FengYun's differential code ------------------
def conv_encode(bits: torch.Tensor) -> torch.Tensor:
    """k=7 r=1/2 {79, 109} from the zero state: bit i's register holds
    bits i-6..i, the newest in the least significant bit. Returns the
    coded bits (2n,), interleaved (polynomial A first)."""
    n = bits.shape[0]
    pad = torch.cat([torch.zeros(6, dtype=bits.dtype, device=bits.device),
                     bits])
    out = torch.empty(2 * n, dtype=bits.dtype, device=bits.device)
    for j, poly in enumerate((POLYA, POLYB)):
        acc = torch.zeros_like(bits)
        for k in range(7):
            if poly >> k & 1:
                acc ^= pad[6 - k: 6 - k + n]
        out[j::2] = acc
    return out


def fengyun_diff_encode(bits: torch.Tensor):
    """Bit pairs (b1, b0) -> the rails x and y, one symbol longer than the
    pairs and starting at x = y = 0: s_k = s_(k-1) ^ b1 ^ b0 and
    x_k = x_(k-1) ^ (b0 if s_k else b1)."""
    b1, b0 = bits[0::2].long(), bits[1::2].long()
    s = torch.cumsum(b1 ^ b0, 0) & 1
    x = torch.cumsum(torch.where(s == 1, b0, b1), 0) & 1
    zero = torch.zeros(1, dtype=torch.long, device=bits.device)
    return (torch.cat([zero, x]).to(torch.uint8),
            torch.cat([zero, x ^ s]).to(torch.uint8))


def qpsk_symbols(chan: torch.Tensor) -> torch.Tensor:
    """Pairs of channel bits -> QPSK: I = first bit, Q = second,
    (2b - 1) / sqrt 2."""
    b = chan.reshape(-1, 2).to(torch.float32) * 2 - 1
    return torch.complex(b[:, 0], b[:, 1]) / math.sqrt(2)


# -- pulse shaping and channel -----------------------------------------------
def root_raised_cosine(spb: float, alpha: float, ntaps: int) -> np.ndarray:
    """Unit-gain RRC taps at `spb` samples a symbol, float64, in GNU Radio's
    firdes order of operations (the sum of the taps accumulated in order),
    so that a cast to float32 gives the demodulator's taps exactly."""
    ntaps |= 1
    taps = np.zeros(ntaps, np.float64)
    scale = 0.0
    for i in range(ntaps):
        xi = i - ntaps // 2
        x1 = np.pi * xi / spb
        x2 = 4 * alpha * xi / spb
        x3 = x2 * x2 - 1
        if abs(x3) >= 1e-6:
            if i != ntaps // 2:
                num = np.cos((1 + alpha) * x1) + \
                    np.sin((1 - alpha) * x1) / (4 * alpha * xi / spb)
            else:
                num = np.cos((1 + alpha) * x1) + \
                    (1 - alpha) * np.pi / (4 * alpha)
            den = x3 * np.pi
        else:
            x3 = (1 - alpha) * x1
            x2 = (1 + alpha) * x1
            num = (np.sin(x2) * (1 + alpha) * np.pi
                   - np.cos(x3) * ((1 - alpha) * np.pi * spb) / (4 * alpha * xi)
                   + np.sin(x3) * spb * spb / (4 * alpha * xi * xi))
            den = -32 * np.pi * alpha * alpha * xi / spb
        taps[i] = 4 * alpha * num / den
        scale += taps[i]
    return taps * 1.0 / scale


def pulse_shape(sym: torch.Tensor, up: int, down: int, alpha: float,
                chunk: int = 1 << 23) -> torch.Tensor:
    """Symbols at exactly up / down samples a symbol: scipy's
    upfirdn(h, sym, up, down) with an RRC h of 31 * (up // 2) taps designed
    at `up` samples a symbol and scaled by up, trimmed by its group delay
    (len(sym) * up // down samples). Polyphase, in chunks of outputs."""
    h = root_raised_cosine(up, alpha, (31 * (up // 2)) | 1) * up
    L = len(h)
    T = -(-L // up)
    hp = np.zeros(T * up)
    hp[:L] = h
    dev = sym.device
    H = torch.as_tensor(hp.reshape(T, up).T.astype(np.float32), device=dev)
    delay = (L - 1) // 2 // down
    n_out = sym.shape[0] * up // down
    out = torch.empty(n_out, dtype=torch.complex64, device=dev)
    for a in range(0, n_out, chunk):
        m = torch.arange(a, min(a + chunk, n_out), device=dev) + delay
        j = m * down
        i0, r = j // up, j % up
        acc = torch.zeros(m.shape[0], dtype=torch.complex64, device=dev)
        for t in range(T):
            i = i0 - t
            ok = (i >= 0) & (i < sym.shape[0])
            acc += torch.where(ok, sym[i.clamp(0, sym.shape[0] - 1)], 0) \
                * H[r, t]
        out[a: a + m.shape[0]] = acc
    return out


def channel(y: torch.Tensor, gen: torch.Generator, snr_db: float,
            freq_offset: float, phase: float, chunk: int = 1 << 24
            ) -> torch.Tensor:
    """AWGN at `snr_db` against the mean signal power, and a rotation by
    phase + 2 pi freq_offset n (cycles a sample), formed in float64; in
    chunks, the noise drawn from `gen` in order."""
    p = float((y.abs() ** 2).mean())
    sigma = math.sqrt(p / 10 ** (snr_db / 10) / 2)
    out = torch.empty_like(y)
    for a in range(0, y.shape[0], chunk):
        m = min(chunk, y.shape[0] - a)
        n = torch.arange(a, a + m, dtype=torch.float64, device=y.device)
        ang = torch.remainder(phase + 2 * math.pi * freq_offset * n,
                              2 * math.pi)
        rot = torch.polar(torch.ones_like(ang), ang).to(torch.complex64)
        noise = torch.randn(m, 2, generator=gen, device=y.device) * sigma
        out[a: a + m] = y[a: a + m] * rot + torch.complex(noise[:, 0],
                                                          noise[:, 1])
    return out


def to_cs16(y: torch.Tensor, scale: float) -> torch.Tensor:
    """complex64 -> (n, 2) int16 IQ at `scale` counts per unit, rounded and
    clipped to +-32767."""
    iq = torch.stack([y.real, y.imag], 1) * scale
    return iq.round().clamp(-32767, 32767).to(torch.int16)


def cs16_to_complex(iq: torch.Tensor) -> torch.Tensor:
    """int16 IQ -> complex64 as an SDR reader scales it (/ 32767). The
    divisor is a tensor: torch divides by a host scalar on the card as a
    product with its reciprocal, which rounds differently."""
    f = iq.to(torch.float32) / torch.full((), 32767.0, device=iq.device)
    return torch.complex(f[:, 0], f[:, 1])


def make_recording(cfg: dict, channel_bits, n_samples: int, seed: int,
                   device) -> Recording:
    """`n_samples` of a QPSK downlink from `seed`: consecutive random CADUs,
    randomized, through `channel_bits` (the link's channel coding, two
    channel bits a CADU bit: bits -> (channel bits, symbols ahead of the
    first CADU's first bit)), QPSK, the RRC pulse and the channel, as int16
    IQ. The QPSK links' code modules make their recordings with it."""
    s, ch = cfg["signal"], cfg["channel"]
    up, down = s["sps"]
    gen = generator(seed, device)
    spc = s["cadu_bytes"] * 8                 # symbols a CADU, both codes
    n_cadus = -(-n_samples * down // (up * spc)) + 1
    cadus = make_cadus(n_cadus, gen, s["rs_depth"])
    chan, lead = channel_bits(unpack_bits(randomize(cadus)))
    y = pulse_shape(qpsk_symbols(chan), up, down, s["rrc_alpha"])
    if y.shape[0] < n_samples:
        raise ValueError(f"{y.shape[0]} samples made, {n_samples} asked")
    y = channel(y[:n_samples], gen, ch["snr_db"], ch["freq_offset"],
                ch["phase"])
    end_sym = (np.arange(1, n_cadus + 1) * spc + lead).astype(np.int64)
    return Recording(iq=to_cs16(y, cfg["cs16_scale"]),
                     cadus=cadus.cpu().numpy(),
                     cadu_end=-(-end_sym * up // down),
                     samplerate=float(s["samplerate"]))
