"""The port's CCSDS decoders from soft symbols against the JAX package's, on
the CPU: `ccsds_simple_psk_decoder` in each of its modes, the
`ccsds_conv_concat_decoder` settings of the pipelines that the port runs
(iq_invert, RS interleave 5 and 0, rs_usecheck, derandomize false), and the
reference-side behaviour that both packages share at the pipeline files'
defaults.

The softs are made from the CADUs sent, with numpy noise from a seed (and
one frame corrupted past RS where rs_usecheck is tested), so no demod runs.
Tolerance: none. The `.cadu` is byte-identical to the JAX package's and
holds the CADUs sent (as the decoder writes them: derandomized after RS
where derand_after_rs).
"""

from pathlib import Path

import numpy as np
import pytest

from satdump_tpu_torch import sim
from satdump_tpu_torch.ops.fec.randomization import derand_ccsds
from satdump_tpu_torch.ops.fec.rotation import PHASE_270, rotate_soft

ROOT = Path(__file__).resolve().parents[1]
PIPELINES = ROOT / "resources" / "pipelines"
ASM = np.array([0x1A, 0xCF, 0xFC, 0x1D], np.uint8)


def _frames(rng, n, cadu_bytes, rs_i):
    """n CADUs: RS(255,223)-interleaved when rs_i, else random bytes."""
    if rs_i:
        return sim.make_cadus(n, rng, cadu_bytes=cadu_bytes, rs_i=rs_i)
    body = rng.integers(0, 256, (n, cadu_bytes - 4)).astype(np.uint8)
    return np.concatenate([np.tile(ASM, (n, 1)), body], 1)


def _noisy(rng, bits, sigma=30.0):
    """Channel bits -> int8 softs (+-100, AWGN of `sigma`)."""
    s = (bits.astype(np.float32) * 200 - 100) + rng.normal(0, sigma,
                                                            len(bits))
    return np.clip(np.round(s), -127, 127).astype(np.int8)


def _qpsk_diff_encode(rng, bits):
    """Bit pairs -> QPSK symbols whose QPSKDiff decode (swap on) gives the
    pairs back, after the two symbols the decoder drops and primes on."""
    from satdump_tpu_torch.ops.fec.differential import QPSKDiff
    enc = np.zeros((4, 4), np.uint8)
    for p in range(4):
        for c in range(4):
            d = QPSKDiff(swap=True)
            ou = d.work(np.array([0, p, c], np.uint8))
            enc[p, ou[0] + 2 * ou[1]] = c
    syms = [int(rng.integers(4)), int(rng.integers(4))]
    for want in bits[0::2] + 2 * bits[1::2]:
        syms.append(int(enc[syms[-1], want]))
    return np.array(syms, np.uint8)


def _qpsk_softs(rng, bits, mode: str):
    """QPSK softs [I, Q, ...] that the decoder's bit order (Q bit, then I
    bit, constellation.cpp) turns back into `bits`, in the form that
    `mode` undoes: "0" as they are, "90" rotated so that only the 90-degree
    deframer locks, "swap" with I and Q swapped, "oqpsk" with the I rail one
    symbol early (the decoder's OQPSK delay realigns it), "diff" as QPSK
    differential symbols."""
    if mode == "diff":
        syms = _qpsk_diff_encode(rng, bits)
        i_bit, q_bit = syms & 1, syms >> 1
    else:
        q_bit, i_bit = bits[0::2], bits[1::2]
    inter = np.empty(2 * len(i_bit), np.uint8)
    inter[0::2], inter[1::2] = i_bit, q_bit
    soft = _noisy(rng, inter)
    if mode == "90":
        soft = rotate_soft(soft, PHASE_270)
    elif mode == "swap":
        soft = rotate_soft(soft, 0, iq_swap=True)
    elif mode == "oqpsk":
        soft[0:-2:2] = soft[2::2]
    return soft


def _run_both(tmp_path, module_id, soft, params):
    """The same soft file through the port's and the JAX package's module
    (each registry's own); returns (port .cadu bytes, JAX's)."""
    from satdump_tpu.pipeline.module import module_registry as jreg
    from satdump_tpu.pipeline.module import register_all_modules as jall
    from satdump_tpu_torch.pipeline.module import module_registry as treg
    from satdump_tpu_torch.pipeline.module import register_all_modules as tall
    src = tmp_path / "in.soft"
    soft.tofile(src)
    out = []
    for reg, register, extra, name in ((treg, tall, {"torch_device": "cpu"},
                                        "torch"), (jreg, jall, {}, "jax")):
        register()
        m = reg.get(module_id)(str(src), str(tmp_path / name),
                               dict(params, **extra))
        m.process()
        out.append(Path(m.d_output_file).read_bytes())
    return out


# (id, constellation, soft mode, cadu bytes, rs_i, decoder params, frames)
SIMPLE_CASES = [
    ("bpsk_rs0_no_derand", "bpsk", None, 224, 0,
     {"derandomize": False}, 5),                       # elektro_ggak
    ("bpsk_nrzm_rs1", "bpsk", None, 259, 1, {"nrzm": True}, 5),
    ("qpsk_diff_rs4", "qpsk", "diff", 1024, 4, {"nrzm": True}, 4),  # cfosat1
    ("qpsk_dual_0deg_rs5", "qpsk", "0", 1279, 5, {}, 4),
    ("qpsk_dual_90deg_rs5", "qpsk", "90", 1279, 5, {}, 4),
    ("qpsk_swap_iq_rs8", "qpsk", "swap", 2044, 8, {"qpsk_swap_iq": True}, 3),
    ("qpsk_oqpsk_delay_rs4", "qpsk", "oqpsk", 1024, 4,
     {"oqpsk_delay": True}, 4),
    ("bpsk_rs_usecheck", "bpsk", None, 1279, 5, {"rs_usecheck": True}, 5),
    ("bpsk_derand_after_rs", "bpsk", None, 1024, 4,
     {"derand_after_rs": True}, 4),
]


@pytest.mark.parametrize("const,mode,cadu_bytes,rs_i,params,n",
                         [c[1:] for c in SIMPLE_CASES],
                         ids=[c[0] for c in SIMPLE_CASES])
def test_simple_psk_cadu_matches_jax(tmp_path, rng, const, mode, cadu_bytes,
                                     rs_i, params, n):
    cadus = _frames(rng, n, cadu_bytes, rs_i)
    after_rs = params.get("derand_after_rs", False)
    randomize = params.get("derandomize", True) and not after_rs
    bits = sim.encode_cadu_stream_uncoded(cadus, randomize=randomize,
                                          nrzm=params.get("nrzm", False)
                                          and const == "bpsk")
    lead = rng.integers(0, 2, 512 if const == "bpsk" else 1024
                        ).astype(np.uint8)
    bits = np.concatenate([lead, bits])
    # no RS to correct them (rs_i 0): a noise that leaves no bit error
    sigma = 30.0 if rs_i else 10.0
    soft = _noisy(rng, bits, sigma) if const == "bpsk" \
        else _qpsk_softs(rng, bits, mode)
    want = cadus.copy()
    if params.get("rs_usecheck"):
        k = 2                           # past RS: 40 bytes of codeword 0
        start = len(lead) + k * cadu_bytes * 8 + 64
        soft[start: start + 40 * 8 * rs_i] *= -1
        want = np.delete(want, k, axis=0)
    if after_rs:
        want[:, 4:] = derand_ccsds(want[:, 4:])
    t, j = _run_both(tmp_path, "ccsds_simple_psk_decoder", soft, dict(
        {"constellation": const, "cadu_size": cadu_bytes * 8, "rs_i": rs_i,
         "buffer_size": 16384}, **params))
    assert t == j
    got = np.frombuffer(t, np.uint8).reshape(-1, cadu_bytes)
    np.testing.assert_array_equal(got, want)


def _decoder_params(fname, pipe_id, level="cadu"):
    from satdump_tpu_torch.pipeline.pipeline import parse_pipeline_file
    pipe = parse_pipeline_file(PIPELINES / fname)[pipe_id]
    step = pipe.steps[pipe.level_index(level)]
    return pipe.prepare_parameters(step, {})


@pytest.mark.parametrize("fname,pipe_id,overrides", [
    ("JPSS.json", "jpss_tlm", {}),                              # rs_i 5
    ("Tropics.json", "tropics_link", {}),      # rs_i 0, nrzm, no derand
    ("Others.json", "pretty_s_500k_dump", {}),     # iq_invert, rs_i 8
], ids=["jpss_tlm_rs5_usecheck", "tropics_link_rs0_no_derand",
        "pretty_iq_invert_rs8"])
def test_conv_concat_settings_match_jax(tmp_path, rng, fname, pipe_id,
                                        overrides):
    """ccsds_conv_concat_decoder at the pipeline files' own parameters, on
    r=1/2-coded softs (QPSK, I then Q; I and Q swapped where iq_invert):
    byte-identical to the JAX package's, holding the CADUs sent (with
    rs_usecheck, a frame corrupted past RS is dropped by both)."""
    p = dict(_decoder_params(fname, pipe_id), **overrides)
    cadu_bytes, rs_i = p["cadu_size"] // 8, int(p.get("rs_i", 0))
    cadus = _frames(rng, 4, cadu_bytes, rs_i)
    frames = cadus.copy()
    if p.get("derandomize", True):
        frames[:, 4:] = derand_ccsds(frames[:, 4:])
    # 64 random bytes coded on after the last frame: the Viterbi decides
    # its last bits on the code that follows them
    msg = np.concatenate([frames.reshape(-1), rng.integers(0, 256, 64)])
    bits = sim.encode_cadu_stream(msg.astype(np.uint8)[None], randomize=False,
                                  nrzm=p.get("nrzm", False))
    soft = _noisy(rng, bits, sigma=40.0 if rs_i else 20.0)
    want = cadus
    if p.get("rs_usecheck"):
        # 8000 coded softs inverted in frame 1: ~500 bytes in error, 100 a
        # codeword, past what RS corrects
        start = 1 * cadu_bytes * 16 + 800
        soft[start: start + 8000] *= -1
        want = np.delete(cadus, 1, axis=0)
    if p.get("iq_invert"):
        soft = rotate_soft(soft, 0, iq_swap=True)
    t, j = _run_both(tmp_path, "ccsds_conv_concat_decoder", soft,
                     dict(p, buffer_size=131072))
    assert t == j
    got = np.frombuffer(t, np.uint8).reshape(-1, cadu_bytes)
    np.testing.assert_array_equal(got, want)


# -- reference-side behaviour both packages share (ROADMAP §3) -------------

def _both_raise_or_equal(build_and_run):
    """build_and_run(package) for "torch" and "jax": the same exception
    type, or the same result."""
    out = []
    for pkg in ("torch", "jax"):
        try:
            out.append(("ok", build_and_run(pkg)))
        except Exception as e:     # the packages must fail alike
            out.append(("raised", type(e).__name__))
    assert out[0] == out[1], out
    return out[0]


def _simple_psk_cls(pkg):
    if pkg == "torch":
        from satdump_tpu_torch.pipeline.modules.ccsds.simple_psk import \
            CCSDSSimplePSKDecoderModule
    else:
        from satdump_tpu.pipeline.modules.ccsds.simple_psk import \
            CCSDSSimplePSKDecoderModule
    return CCSDSSimplePSKDecoderModule


def test_simple_psk_rejects_oqpsk_in_both():
    """sentinel6_tlm and gcom_s_band pass `constellation: oqpsk`, which the
    reference's simple PSK decoder refuses (simple_psk.py:50-51)."""
    for fname, pipe_id in (("Sentinel-6.json", "sentinel6_tlm"),
                           ("Work-In-Progress.json", "gcom_s_band")):
        p = _decoder_params(fname, pipe_id)
        res = _both_raise_or_equal(lambda pkg: _simple_psk_cls(pkg)(
            "x.soft", "out", dict(p, torch_device="cpu")
            if pkg == "torch" else p))
        assert res == ("raised", "PipelineError")


def test_rs_fill_bytes_is_read_by_neither(tmp_path, rng):
    """gk2a_cdas and crew_dragon_tlm set rs_fill_bytes (RS codewords
    shortened by that many bytes); no module reads it, so their frames do
    not hold rs_i whole codewords and both decoders fail alike on them."""
    for fname, pipe_id in (("GK2A.json", "gk2a_cdas"),
                           ("SpaceX.json", "crew_dragon_tlm")):
        p = _decoder_params(fname, pipe_id)
        assert "rs_fill_bytes" in p
        cadus = _frames(rng, 3, p["cadu_size"] // 8, 0)
        bits = sim.encode_cadu_stream_uncoded(cadus)
        soft = _noisy(rng, bits) if p["constellation"] == "bpsk" \
            else _qpsk_softs(rng, bits, "0")
        src = tmp_path / f"{pipe_id}.soft"
        soft.tofile(src)

        def run(pkg):
            m = _simple_psk_cls(pkg)(str(src), str(tmp_path / pkg), dict(
                p, torch_device="cpu") if pkg == "torch" else p)
            m.process()
            return Path(m.d_output_file).read_bytes()
        assert _both_raise_or_equal(run)[0] == "raised"


def test_pm_demod_max_sps_resamples_below_the_subcarrier():
    """pm_demod's MAX_SPS = 10 resamples chandrayaan3_link_1k (1 ksym/s on
    a 32 kHz subcarrier) to 10 ksps, below the subcarrier, in both
    packages; max_sps lifts it."""
    from satdump_tpu.pipeline.modules.demod.pm import PMDemodModule as J
    from satdump_tpu_torch.pipeline.modules.demod.pm import PMDemodModule
    p = _decoder_params("Chandrayaan.json", "chandrayaan3_link_1k", "soft")
    rates = []
    for extra in ({}, {"max_sps": 100}):
        for cls, dev in ((PMDemodModule, {"torch_device": "cpu"}), (J, {})):
            m = cls("x.cf32", "out", dict(p, samplerate=1e6, **extra, **dev))
            m.compute_rates()
            rates.append((m.final_samplerate, m.resample))
    assert rates[0] == rates[1] and rates[2] == rates[3]
    assert rates[0] == (10e3, True)
    assert rates[2][0] > 2 * p["subcarrier_offset"]
