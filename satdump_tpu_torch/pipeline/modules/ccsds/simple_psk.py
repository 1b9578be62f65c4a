"""Generic CCSDS simple PSK decoder: .soft -> .cadu (no convolutional code)
— port of satdump_tpu/pipeline/modules/ccsds/simple_psk.py (host NumPy, as
there).

Reference: src-core/pipeline/modules/ccsds/module_ccsds_simple_psk_decoder.cpp
— the no-conv-code half of the generic CCSDS decoder pair. Per block:
BPSK: hard bits (+ optional NRZ-M);
QPSK: optional OQPSK delay / IQ swap, then either QPSK differential decode or
the dual-deframer trick (run one deframer on the 0-degree demod and another
on the 90-degree rotation, whichever locks wins);
then deframer -> [derand] -> RS interleaved -> [derand after RS] -> CADU.

All bit-level conversions are vectorized over the block; the deframers'
correlate-everywhere formulation is already batched (ops/fec/deframer.py).
"""

from __future__ import annotations

import numpy as np

from satdump_tpu_torch.core.exceptions import PipelineError
from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.ops.fec.deframer import CCSDSDeframer
from satdump_tpu_torch.ops.fec.differential import QPSKDiff, nrzm_decode
from satdump_tpu_torch.ops.fec.randomization import derand_ccsds
from satdump_tpu_torch.ops.fec.reed_solomon import ReedSolomon
from satdump_tpu_torch.ops.fec.rotation import PHASE_0, PHASE_90, rotate_soft
from satdump_tpu_torch.pipeline.module import ProcessingModule, register_module


def qpsk_soft_demod_bits(soft: np.ndarray) -> np.ndarray:
    """Interleaved int8 QPSK softs -> hard bits, reference bit order
    (constellation.cpp:207-224: sym = 2*(Q>0)+(I>0); out = [sym>>1, sym&1])."""
    soft = np.asarray(soft)
    n = len(soft) // 2
    i_bit = (soft[0: n * 2: 2] > 0).astype(np.uint8)
    q_bit = (soft[1: n * 2: 2] > 0).astype(np.uint8)
    out = np.empty(n * 2, np.uint8)
    out[0::2] = q_bit
    out[1::2] = i_bit
    return out


@register_module
class CCSDSSimplePSKDecoderModule(ProcessingModule):
    id = "ccsds_simple_psk_decoder"

    def __init__(self, input_file, output_file_hint, parameters):
        super().__init__(input_file, output_file_hint, parameters)
        self.is_ccsds = bool(self.param("ccsds", True))
        self.const = str(self.param("constellation", required=True))
        if self.const not in ("bpsk", "qpsk"):
            raise PipelineError(f"simple PSK: invalid constellation {self.const}")
        self.cadu_size = int(self.param("cadu_size", required=True))
        self.cadu_bytes = -(-self.cadu_size // 8)
        self.qpsk_swapiq = bool(self.param("qpsk_swap_iq", False))
        self.qpsk_swapdiff = bool(self.param("qpsk_swap_diff", True))
        self.oqpsk_delay = bool(self.param("oqpsk_delay", False))
        self.diff_decode = bool(self.param("nrzm", False))
        self.derand = bool(self.param("derandomize", True))
        self.derand_after_rs = bool(self.param("derand_after_rs", False))
        self.derand_from = int(self.param("derand_start", 4))
        self.rs_i = int(self.param("rs_i", required=True))
        self.rs_dualbasis = bool(self.param("rs_dualbasis", True))
        self.rs_type = str(self.param("rs_type", "rs223"))
        self.rs_usecheck = bool(self.param("rs_usecheck", False))
        asm_hex = self.param("asm", "1acffc1d")
        self.asm = int(str(asm_hex), 16)

        self.deframer = CCSDSDeframer(self.cadu_size, self.asm)
        # QPSK without diff splits into two BPSK deframers (0 and 90 deg)
        self.deframer_qpsk = CCSDSDeframer(self.cadu_size, self.asm)
        self.rs = ReedSolomon(k=223 if self.rs_type == "rs223" else 239) \
            if self.rs_i else None
        self.qpsk_diff = QPSKDiff(swap=self.qpsk_swapdiff)
        self.nrzm_last = 0
        self.oqpsk_last_q = np.int8(0)
        self.block = int(self.param("buffer_size", 0) or (1 << 20))

    # -- block bit conversion --------------------------------------------------
    def _to_bits(self, chunk: np.ndarray) -> list:
        """Returns a list of (deframer, bits) passes for this block."""
        if self.const == "bpsk":
            bits = (chunk > 0).astype(np.uint8)
            if self.diff_decode:
                bits, self.nrzm_last = nrzm_decode(bits, self.nrzm_last)
            return [(self.deframer, bits)]

        # QPSK
        if self.oqpsk_delay:
            chunk = chunk.copy()
            i_vals = chunk[0::2].copy()
            chunk[0::2] = np.concatenate([[self.oqpsk_last_q], i_vals[:-1]])
            self.oqpsk_last_q = i_vals[-1]
        if self.qpsk_swapiq:
            chunk = rotate_soft(chunk, PHASE_0, iq_swap=True)

        if self.diff_decode:
            n = len(chunk) // 2
            syms = (2 * (chunk[1: n * 2: 2] > 0)
                    + (chunk[0: n * 2: 2] > 0)).astype(np.uint8)
            bits = self.qpsk_diff.work(syms)
            return [(self.deframer, bits)]

        # normal QPSK: deframe the 0-degree demod AND the 90-degree rotation
        bits0 = qpsk_soft_demod_bits(chunk)
        rot = rotate_soft(chunk, PHASE_90, False)
        bits90 = qpsk_soft_demod_bits(rot)
        return [(self.deframer_qpsk, bits0), (self.deframer, bits90)]

    def process(self):
        ext = ".cadu" if self.is_ccsds else ".frm"
        out_path = self.d_output_file_hint + ext
        self.d_output_file = out_path
        nframes = 0
        rs_avg = []
        soft = np.fromfile(self.d_input_file, dtype=np.int8)
        with open(out_path, "wb") as fout:
            for off in range(0, len(soft), self.block):
                chunk = soft[off: off + self.block]
                frames = []
                for deframer, bits in self._to_bits(chunk):
                    frames += deframer.work(bits)
                for cadu in frames:
                    cadu = np.array(cadu, np.uint8)
                    if self.derand and not self.derand_after_rs:
                        cadu[self.derand_from:] = derand_ccsds(cadu[self.derand_from:])
                    valid = True
                    if self.rs is not None:
                        payload = cadu[4: 4 + 255 * self.rs_i]
                        corrected, errs = self.rs.decode_interleaved(
                            payload, self.rs_dualbasis, self.rs_i)
                        cadu[4: 4 + 255 * self.rs_i] = corrected
                        valid = (errs >= 0).all()
                        rs_avg.append(errs)
                    if self.derand and self.derand_after_rs:
                        cadu[self.derand_from:] = derand_ccsds(cadu[self.derand_from:])
                    if not self.rs_usecheck or valid:
                        fout.write(cadu[: self.cadu_bytes].tobytes())
                        nframes += 1
        self.stats = {
            "frames": nframes,
            "deframer_lock": max(self.deframer.state, self.deframer_qpsk.state),
            "rs_avg": float(np.mean(rs_avg)) if rs_avg else 0.0,
        }
        logger.info(f"simple PSK: {nframes} CADUs "
                    f"(rs avg {self.stats['rs_avg']:.2f})")
