"""The multi-device dryrun — counterpart of the reference's
`__graft_entry__.dryrun_multichip`.

`dryrun_multichip(n)` makes an n-rank (ch × t) mesh and runs ONE sharded
step of the chain (halo exchange, seam phase stitching, demod and the
shard's Viterbi) at small shapes on `step_signal`, then the runner path:
psk_demod with `multichip: true` sharded over n ranks, then
metop_ahrpt_decoder, on 12 CADUs that must all come out bit-exact across
the shard seams. The n ranks
share `device` (`set_virtual_devices(n)` for the run, as the reference
forces n host devices).

    python -c "from satdump_tpu_torch.parallel.dryrun import \\
        dryrun_multichip as d; d(8, device='cpu')"
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import torch

from satdump_tpu_torch import sim
from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.io import write_baseband
from satdump_tpu_torch.parallel import timeshard
from satdump_tpu_torch.pipeline.pipeline import Pipeline, PipelineStep
from satdump_tpu_torch.pipeline.runner import run_pipeline
from satdump_tpu_torch.utils.device import resolve_device

STEP_KW = dict(sps=2.0, block=8192, halo=2048, sub_phase=256, sub_timing=512)


def step_signal(mesh: timeshard.Mesh, seed: int = 7) -> np.ndarray:
    """The dryrun step's input, (ch, n_t · block): each channel QPSK at sps
    2 carrying CADUs, through the channel model (a signal rather than the
    reference's noise, so that two devices' steps can be compared: on
    noise the carrier and timing estimates are arbitrary)."""
    rng = np.random.default_rng(seed)
    n = mesh.n_t * STEP_KW["block"]
    out = []
    for ch in range(mesh.n_ch):
        cadus = sim.make_cadus(n // 16384 + 1, rng)
        syms = sim.bits_to_qpsk_symbols(sim.encode_cadu_stream(cadus))
        bb = sim.ChannelModel(snr_db=20.0, freq_offset=2e-4, phase=0.3 * ch,
                              seed=10 + ch).apply(
            sim.qpsk_modulate(syms, sps=STEP_KW["sps"]))
        out.append(bb[:n])
    return np.stack(out).astype(np.complex64)


def runner_signal() -> tuple:
    """12 CADUs (rng 3) as QPSK at sps 2 through the channel model, as the
    reference's dryrun makes them: (cadus, baseband)."""
    rng = np.random.default_rng(3)
    cadus = sim.make_cadus(12, rng)
    syms = sim.bits_to_qpsk_symbols(sim.encode_cadu_stream(cadus))
    tx = sim.qpsk_modulate(syms, sps=2.0)
    bb = sim.ChannelModel(snr_db=20.0, freq_offset=1e-4, phase=0.4,
                          seed=5).apply(tx)
    return cadus, bb


def multichip_pipeline() -> Pipeline:
    return Pipeline(id="dryrun_mc", name="d", steps=[
        PipelineStep("baseband", ""),
        PipelineStep("soft", "psk_demod", {
            "constellation": "qpsk", "symbolrate": 100_000.0,
            "rrc_alpha": 0.5, "pll_bw": 0.005, "fast": True,
            "multichip": True}),
        PipelineStep("cadu", "metop_ahrpt_decoder", {}),
    ], parameters={})


def dryrun_multichip(n_devices: int, device: str | torch.device | None = None
                     ) -> dict:
    """The sharded step, then the runner path, on n_devices ranks sharing
    `device` (default cuda). Returns {"step": the step's ShardedResult,
    "mesh": (ch, t), "soft": the runner's .soft (int8), "cadus": the
    CADUs out, "matched": how many equal one sent}; raises unless the
    runner gives 12 of 12."""
    dev = resolve_device(device)
    mesh = timeshard.make_mesh(n_devices)
    step = timeshard.run_sharded(step_signal(mesh), mesh, dev, **STEP_KW)
    if step.soft.shape[:2] != (mesh.n_t, mesh.n_ch):
        raise AssertionError(f"dryrun: soft {step.soft.shape} for mesh "
                             f"{mesh.shape}")
    logger.info(f"dryrun ok: mesh(ch={mesh.n_ch}, t={mesh.n_t}), soft "
                f"{step.soft.shape}, bits {step.bits.shape}")

    cadus, bb = runner_signal()
    with tempfile.TemporaryDirectory(prefix="dryrun-") as td:
        tmp = Path(td)
        write_baseband(tmp / "t.cf32", "cf32", bb)
        timeshard.set_virtual_devices(n_devices)
        try:
            out = run_pipeline(multichip_pipeline(), str(tmp / "t.cf32"),
                               str(tmp / "out"),
                               user_params={"samplerate": 200_000.0,
                                            "torch_device": dev.type})
        finally:
            timeshard.set_virtual_devices(None)
        got = np.fromfile(out, np.uint8).reshape(-1, 1024)
        soft = np.fromfile(next((tmp / "out").glob("*.soft")), np.int8)
    matched = sum(bool((cadus == g).all(axis=1).any()) for g in got)
    # every frame must survive: seam symbol ownership is single-sourced
    if not matched == len(got) == 12:
        raise AssertionError(f"multichip runner CADUs: {matched}/{len(got)} "
                             "of 12")
    logger.info(f"dryrun runner path ok: mesh t={n_devices}, {matched}/12 "
                "CADUs bit-exact through the sharded demod")
    return {"step": step, "mesh": (mesh.n_ch, mesh.n_t), "soft": soft,
            "cadus": got, "matched": matched}
