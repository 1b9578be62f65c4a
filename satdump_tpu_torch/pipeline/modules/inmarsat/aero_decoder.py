"""Inmarsat Aero decoder module: .soft -> .frm.

Reference: plugins/inmarsat_support/aero/module_aero_decoder.cpp — generic
soft correlator on the channel's sync pattern, phase-ambiguity correction
(+ OQPSK Q-delay swap), per-block (i*27 % 64) row deinterleave, Viterbi k=7
{109,79} (C channel: depunctured 3-of-4 first), LFSR derandomization, and
either the raw info bytes (P/R/T channels) or the voice/data demux
(C channel: 36 block bytes + 300 voice bytes per frame).

The correlator is one batched FFT cross-correlation per window and the
Viterbi the shared batched trellis decoder, both on `torch_device` ("cuda"
by default, or "cpu"). Counterpart of
satdump_tpu/pipeline/modules/inmarsat/aero_decoder.py; torch.fft and the
JAX package's FFT differ in the last bits, so the correlation value
agrees within rounding and the offset, phase and swap are the same.
"""

from __future__ import annotations

import numpy as np
import torch

from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.ops import inmarsat_aero as aero
from satdump_tpu_torch.ops.fec.convolutional import (conv_encode_batch,
                                                     viterbi_decode_block)
from satdump_tpu_torch.ops.fec.correlator import CorrelatorGeneric
from satdump_tpu_torch.ops.fec.rotation import rotate_soft
from satdump_tpu_torch.pipeline.module import ProcessingModule, register_module
from satdump_tpu_torch.utils.device import resolve_device, to_numpy


@register_module
class AeroDecoderModule(ProcessingModule):
    id = "inmarsat_aero_decoder"

    def __init__(self, input_file, output_file_hint, parameters):
        super().__init__(input_file, output_file_hint, parameters)
        self.is_c = bool(self.param("is_c", False))
        self.oqpsk = bool(self.param("oqpsk", required=True))
        self.dummy_bits = int(self.param("dummy_bits", required=True))
        self.cols = int(self.param("inter_cols", required=True))
        self.blocks = int(self.param("inter_blocks", required=True))
        self.ber_thr = float(self.param("ber_thresold", 1.0))
        self.geo = aero.frame_geometry(self.oqpsk, self.dummy_bits,
                                       self.cols, self.blocks, self.is_c)
        if self.is_c:
            sync_bits = aero.SYNC_C
        elif self.oqpsk:
            sync_bits = aero.SYNC_OQPSK
        else:
            sync_bits = aero.SYNC_BPSK
        self.torch_device = resolve_device(self.param("torch_device", "cuda"))
        self.correlator = CorrelatorGeneric(
            "oqpsk" if self.oqpsk else "bpsk", sync_bits, self.torch_device)
        # info size the Viterbi sees (C: after depuncture, decoder.cpp:60-61)
        self.info = 5460 if self.is_c else self.geo["info"]
        self.rand_seq = aero.randomization_seq(self.info)

    def _decode_frame(self, frame: np.ndarray):
        """One aligned+rotated frame -> (payload bytes | None, ber)."""
        g = self.geo
        info = frame[g["sync"] + g["hdr"]:]
        deint = np.concatenate(
            [aero.deinterleave(info[i * g["block"]: (i + 1) * g["block"]],
                               self.cols) for i in range(self.blocks)])
        if self.is_c:
            u8 = aero.depuncture(deint[: g["info"] - 1], shift=2)
        else:
            u8 = (deint.astype(np.int16) + 127).clip(0, 255).astype(np.uint8)
        pairs = u8.reshape(-1, 2)[:, ::-1].astype(np.float32)  # {109,79}
        bits, _ = viterbi_decode_block(
            torch.from_numpy(np.ascontiguousarray(pairs)).to(
                self.torch_device)[None])
        bits = to_numpy(bits[0]).astype(np.uint8)
        # BER: re-encode vs received hard decisions, skipping erasures;
        # scaled x4 like viterbi27.cpp:58-66
        re_enc = conv_encode_batch(bits[None])[0] \
            .reshape(-1, 2)[:, ::-1].reshape(-1)
        flat = u8.reshape(-1)
        test = min(len(flat), self.info // 5)
        mask = flat[:test] != 128
        errs = np.sum((flat[:test] > 127) != (re_enc[:test] > 0), where=mask)
        ber = 4.0 * float(errs) / max(test, 1)
        if ber >= self.ber_thr:
            return None, ber
        vbytes = np.packbits(bits)
        if self.is_c:
            dr = aero.derand_bytes(vbytes[: self.info // 16], self.rand_seq,
                                   reverse=False)
            voice, blocks = aero.unpack_c84(dr)
            return np.concatenate([blocks, voice]), ber       # 336 bytes
        return aero.derand_bytes(vbytes[: self.info // 16], self.rand_seq,
                                 reverse=True), ber

    def process(self):
        out_path = self.d_output_file_hint + ".frm"
        self.d_output_file = out_path
        soft = np.fromfile(self.d_input_file, dtype=np.int8)
        total = self.geo["total"]
        nframes = 0
        bers = []
        pos = 0
        locked = False
        with open(out_path, "wb") as f:
            while pos + total <= len(soft):
                window = soft[pos: pos + 2 * total]
                off, phase, swap, cor = self.correlator.correlate(window)
                if cor < 0.5 or pos + off + total > len(soft):
                    pos += total
                    locked = False
                    continue
                frame = soft[pos + off: pos + off + total].copy()
                frame = rotate_soft(frame, phase, False)
                if self.oqpsk and swap:
                    # advance the Q stream one symbol (decoder.cpp:141-152:
                    # new Q[i] = old Q[i+1], zero at the end)
                    q = frame[1::2]
                    frame[1::2] = np.concatenate([q[1:], [0]])
                payload, ber = self._decode_frame(frame)
                bers.append(ber)
                if payload is not None:
                    f.write(payload.tobytes())
                    nframes += 1
                    locked = True
                pos += off + total
        self.stats = {
            "frames": nframes,
            "viterbi_ber": float(np.mean(bers)) if bers else 1.0,
            "lock_state": "SYNCED" if locked else "NOSYNC",
        }
        logger.info(f"Aero: {nframes} frames "
                    f"(ber {self.stats['viterbi_ber']:.3f})")
