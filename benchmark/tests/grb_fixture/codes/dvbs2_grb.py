"""GOES-R GRB's DVB-S2 downlink, made with the program's own DVB-S2
transmitter and channel model as `chip_smoke.py`'s phase 13 makes it:
random 2,048-byte CADUs as one byte stream in the data fields of BBFrames
(`sim.grb_bbframes`), PLFRAMEs of the configuration's MODCOD, normal and
without pilots (`ops/dvbs2/tx.py::bbframes_to_symbols`), random lead
symbols, the RRC pulse and the channel (`sim.dvbs2_baseband`), as int16 IQ.

A fixture of the benchmark's own tests, which copy it into a copy of the
benchmark: a configuration that the benchmark runs brings a transmitter that
imports nothing of the program. The program is imported when a recording is
made, so that the module loads where the program is not.
"""

import numpy as np
import torch

from harness import tx

LEAD = 1000          # symbols ahead of the first PLFRAME
# PLFRAMEs after the one that holds a CADU's last byte before the CADU is
# due: the demodulator's last block, trimmed at the recording's end, and
# the CADU extractor's look-ahead of one CADU
TAIL_FRAMES = 2


def make_recording(cfg: dict, n_samples: int, seed: int, device
                   ) -> tx.Recording:
    """`n_samples` of the configuration's GRB downlink from `seed`."""
    from satdump_tpu_torch import sim
    from satdump_tpu_torch.ops.dvbs2.tx import bbframes_to_symbols
    s = cfg["signal"]
    up, down = s["sps"]
    frame_s = s["plframe_symbols"] * up // down
    data = s["bbframe_bytes"] - s["bbheader_bytes"]
    nb = s["cadu_bytes"]
    rng = np.random.default_rng(seed)
    frames = -(-(n_samples - LEAD * up // down) // frame_s) + 1
    n_cadus = frames * data // nb
    cadus = rng.integers(0, 256, (n_cadus, nb), dtype=np.uint8)
    cadus[:, :4] = tx.ASM
    syms = bbframes_to_symbols(sim.grb_bbframes(cadus), s["modcod"], False,
                               False).ravel()
    x = sim.dvbs2_baseband(syms, rng, (up, down), s["rrc_alpha"], lead=LEAD)
    if len(x) < n_samples:
        raise ValueError(f"{len(x)} samples made, {n_samples} asked")
    last_frame = (np.arange(1, n_cadus + 1) * nb - 1) // data
    return tx.Recording(
        iq=tx.to_cs16(torch.from_numpy(x[:n_samples]),
                      cfg["cs16_scale"]).to(device),
        cadus=cadus,
        cadu_end=(LEAD * up // down
                  + (last_frame + 1 + TAIL_FRAMES) * frame_s).astype(np.int64),
        samplerate=float(s["samplerate"]))
