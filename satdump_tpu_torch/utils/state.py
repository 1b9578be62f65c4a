"""Carried stream state between numpy and the port's tensors.

The reference (satdump_tpu) and the port carry the same mid-stream state:
the feedforward demod's `FFClockState`, the input stages' states
(`FreqShiftState`, `DCBlockState`, `RationalResamplerState`), the CADU
chain's seam carries, the Gardner clock recovery's `GardnerState` and the
streaming Viterbi's `ViterbiState` (whose decisions the port packs into
one int64 word a step).
These helpers turn numpy arrays (for example `np.asarray` of the
reference's JAX arrays) into the port's state and back, so both packages
can be started from the same point of a stream.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from satdump_tpu_torch.ops.clock_recovery import GardnerState
from satdump_tpu_torch.ops.fec.convolutional import (ViterbiState,
                                                     pack_decisions,
                                                     unpack_decisions)
from satdump_tpu_torch.ops.ffsync import FFClockState
from satdump_tpu_torch.ops.resamp import RationalResamplerState
from satdump_tpu_torch.ops.stages import DCBlockState, FreqShiftState
from satdump_tpu_torch.utils.device import resolve_device

_FF_F32_FIELDS = ("next_pos", "last_phase", "last_f", "nco_phase", "oq_imag",
                  "sym_phase")
_FF_C64_FIELDS = ("history", "rrc_history")


def ff_clock_state_from_numpy(fields: Mapping[str, np.ndarray],
                              device: str | torch.device | None = None
                              ) -> FFClockState:
    """{FFClockState field: numpy array} -> FFClockState on `device`.
    Scalars become float32, the tails complex64; missing optional fields
    stay None."""
    dev = resolve_device(device)
    out = {}
    for name in FFClockState._fields:
        v = fields.get(name)
        if v is None:
            out[name] = None
            continue
        dt = np.float32 if name in _FF_F32_FIELDS else np.complex64
        out[name] = torch.as_tensor(np.array(v, dtype=dt), device=dev)
    return FFClockState(**out)


def ff_clock_state_to_numpy(state: FFClockState) -> dict:
    """FFClockState -> {field: numpy array} (None stays None)."""
    return {k: (None if v is None else v.detach().cpu().numpy())
            for k, v in state._asdict().items()}


def cadu_chain_state_from_numpy(bit_carry: np.ndarray, soft_ctx: np.ndarray,
                                nrzm_carry, abs_base: int,
                                last_emitted: int,
                                device: str | torch.device | None = None
                                ) -> dict:
    """The CADU chain's carries (as CaduChain.init_state lays them out) from
    numpy: bit_carry (carry_bits,) int32, soft_ctx (HALO, 2) f32,
    nrzm_carry int32 scalar, plus the host-side dedup positions."""
    dev = resolve_device(device)
    return dict(
        bit_carry=torch.as_tensor(np.array(bit_carry, np.int32), device=dev),
        soft_ctx=torch.as_tensor(np.array(soft_ctx, np.float32), device=dev),
        nrzm_carry=torch.as_tensor(np.array(nrzm_carry, np.int32),
                                   device=dev),
        abs_base=int(abs_base),
        last_emitted=int(last_emitted),
    )


def cadu_chain_state_to_numpy(state: dict) -> dict:
    """Inverse of cadu_chain_state_from_numpy."""
    return dict(
        bit_carry=state["bit_carry"].detach().cpu().numpy(),
        soft_ctx=state["soft_ctx"].detach().cpu().numpy(),
        nrzm_carry=state["nrzm_carry"].detach().cpu().numpy(),
        abs_base=int(state["abs_base"]),
        last_emitted=int(state["last_emitted"]),
    )


def freq_shift_state_from_numpy(phase, device: str | torch.device | None
                                = None) -> FreqShiftState:
    """The NCO phase (radians; freq_shift and doppler_correct) as a
    float32 scalar on `device`."""
    return FreqShiftState(torch.as_tensor(np.array(phase, np.float32),
                                          device=resolve_device(device)))


def dc_block_state_from_numpy(acc, device: str | torch.device | None = None
                              ) -> DCBlockState:
    """The DC blocker's accumulator as a complex64 scalar on `device`."""
    return DCBlockState(torch.as_tensor(np.array(acc, np.complex64),
                                        device=resolve_device(device)))


def rational_resampler_state_from_numpy(history, pos_num,
                                        device: str | torch.device | None
                                        = None) -> RationalResamplerState:
    """The resampler's (ntaps-1,) complex64 history and its position
    numerator (the reference's int32, held as int64) on `device`."""
    dev = resolve_device(device)
    return RationalResamplerState(
        history=torch.as_tensor(np.array(history, np.complex64), device=dev),
        pos_num=torch.as_tensor(np.array(pos_num, np.int64), device=dev))


def stage_state_to_numpy(state) -> dict:
    """A FreqShiftState, DCBlockState or RationalResamplerState ->
    {field: numpy array}."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def gardner_state_from_numpy(fields: Mapping[str, np.ndarray],
                             device: str | torch.device | None = None
                             ) -> GardnerState:
    """{GardnerState field: numpy array} -> GardnerState on `device`: mu
    and omega float32, inc int32, history and last_sample complex64."""
    dev = resolve_device(device)
    dt = dict(mu=np.float32, omega=np.float32, inc=np.int32,
              history=np.complex64, last_sample=np.complex64)
    return GardnerState(**{k: torch.as_tensor(np.array(fields[k], dt[k]),
                                              device=dev)
                           for k in GardnerState._fields})


def gardner_state_to_numpy(state: GardnerState) -> dict:
    """GardnerState -> {field: numpy array}."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def viterbi_state_from_numpy(pm, decisions,
                             device: str | torch.device | None = None
                             ) -> ViterbiState:
    """The reference's ViterbiState arrays — pm (B, 64) float32 and
    decisions (D, B, 64) bool — as the port's: decisions packed into (B, D)
    int64 words, on `device`."""
    dev = resolve_device(device)
    dec = torch.as_tensor(np.array(decisions, np.bool_))
    return ViterbiState(
        pm=torch.as_tensor(np.array(pm, np.float32), device=dev),
        decisions=pack_decisions(dec).to(dev))


def viterbi_state_to_numpy(state: ViterbiState) -> dict:
    """Inverse of viterbi_state_from_numpy: {"pm": (B, 64) float32,
    "decisions": (D, B, 64) bool}."""
    return {"pm": state.pm.detach().cpu().numpy(),
            "decisions": unpack_decisions(state.decisions.cpu()).numpy()}
