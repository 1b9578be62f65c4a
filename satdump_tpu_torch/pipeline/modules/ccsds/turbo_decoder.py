"""Generic CCSDS turbo decoder module: .soft -> .frm.

Reference: src-core/pipeline/modules/ccsds/module_ccsds_turbo_decoder.cpp —
correlate the rate-specific attached sync marker (CCSDS 131.0-B ASMs) over
the soft stream, soft-derandomize the codeword, run the turbo decoder, and
write [0x1ACFFC1D | base bytes] frames with a CRC-16 validity stat.

Counterpart of satdump_tpu/pipeline/modules/ccsds/turbo_decoder.py, with the
same parameters, chunking and output, but for three repairs. The JAX
module cannot be built at rates 1/3, 1/4 and 1/6 (its marker bits overflow,
`_asm_bits`); here every rate runs. A `buffer_size` below two codewords
stalls its loop; here the block holds two at least. And the JAX module
decodes a chunk's frames from its best correlation on and so drops those
ahead of it; here the chunk's run of frames starts at the first frame from
which every marker up to the best one correlates above the threshold, so
the frames of a chunk come out as the reference's frame-by-frame loop gives
them.

The correlator evaluates every offset and rotation in one batched FFT on
`torch_device` ("cuda" by default, or "cpu"); all codewords of a chunk are
decoded in one batched turbo decode on the same device (the max-log BCJR
kernel on the card). Rotation, derandomization and the CRC are host NumPy.
"""

from __future__ import annotations

import numpy as np

from satdump_tpu_torch.core.exceptions import PipelineError
from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.ops.fec.correlator import CorrelatorGeneric
from satdump_tpu_torch.ops.fec.crc import crc_ccitt
from satdump_tpu_torch.ops.fec.randomization import derand_ccsds_soft
from satdump_tpu_torch.ops.fec.rotation import rotate_soft
from satdump_tpu_torch.ops.fec.turbo import CCSDSTurbo
from satdump_tpu_torch.pipeline.module import (ProcessingModule,
                                               register_module)
from satdump_tpu_torch.utils.device import resolve_device

# CCSDS 131.0-B attached sync markers per nominal code rate
TURBO_ASM = {
    "1/2": (0x034776C7272895B0, 64),
    "1/3": (0x25D5C0CE8990F6C9461BF79C, 96),
    "1/4": (0x034776C7272895B0FCB88938D8D76A4F, 128),
    "1/6": (0x25D5C0CE8990F6C9461BF79CDA2A3F31766F0936B9E40863, 192),
}


def _asm_bits(val: int, nbits: int) -> np.ndarray:
    """The marker's bits, first bit first. (Python ints throughout: the
    JAX module shifts by a numpy int64 array, which overflows for the
    96-, 128- and 192-bit markers of rates 1/3, 1/4 and 1/6.)"""
    return np.array([(val >> i) & 1 for i in range(nbits - 1, -1, -1)],
                    np.uint8)


@register_module
class CCSDSTurboDecoderModule(ProcessingModule):
    id = "ccsds_turbo_decoder"

    def __init__(self, input_file, output_file_hint, parameters):
        super().__init__(input_file, output_file_hint, parameters)
        self.const = str(self.param("constellation", "bpsk"))
        if self.const not in ("bpsk", "qpsk"):
            raise PipelineError(f"turbo decoder: constellation {self.const}")
        self.base = int(self.param("turbo_base", required=True))
        self.rate = str(self.param("turbo_rate", required=True))
        self.iters = int(self.param("turbo_iters", 10))
        self.derand = bool(self.param("derandomize", True))
        self.corr_thr = float(self.param("correlator_threshold", 0.5))
        if self.rate not in TURBO_ASM:
            raise PipelineError(f"turbo rate {self.rate}")
        self.torch_device = resolve_device(self.param("torch_device", "cuda"))
        self.turbo = CCSDSTurbo(self.base, self.rate)
        asm_val, asm_len = TURBO_ASM[self.rate]
        self.asm_len = asm_len
        self.correlator = CorrelatorGeneric(
            self.const, _asm_bits(asm_val, asm_len), device=self.torch_device)
        # soft values per codeword+asm unit in the stream
        self.unit = asm_len + self.turbo.encoded_length
        # a block holds two units at least: a pipeline's buffer_size below
        # that (the demods' CPU runs take 16384) would stall the JAX
        # module's loop, which steps by block - unit
        self.block = max(int(self.param("buffer_size", 0)
                             or max(1 << 20, 8 * self.unit)), 2 * self.unit)

    def process(self):
        out_path = self.d_output_file_hint + ".frm"
        self.d_output_file = out_path
        soft = np.fromfile(self.d_input_file, dtype=np.int8)
        nframes = 0
        crc_ok = 0
        pos = 0
        with open(out_path, "wb") as fout:
            while pos + 2 * self.unit <= len(soft):
                chunk = soft[pos: pos + self.block]
                p, phase, swap, corr = self.correlator.correlate(chunk)
                if corr < self.corr_thr:
                    pos += self.block - self.unit
                    continue
                # the frames ahead of the best match too (the JAX module
                # starts at the best match and drops them)
                p = self.correlator.earliest(chunk, p, self.unit, phase, swap,
                                             self.corr_thr)
                aligned = rotate_soft(chunk[p:], phase, swap)
                n_cw = (len(aligned)) // self.unit
                if n_cw == 0:
                    pos += max(p, 1)
                    continue
                units = aligned[: n_cw * self.unit].reshape(n_cw, self.unit)
                cw_soft = units[:, self.asm_len:]
                if self.derand:
                    cw_soft = derand_ccsds_soft(cw_soft)
                llr = cw_soft.astype(np.float32) / 32.0
                bits, _ = self.turbo.decode(llr, iterations=self.iters,
                                            device=self.torch_device)
                frames = np.packbits(bits, axis=-1)       # (n_cw, base)
                for fr in frames:
                    comp = crc_ccitt.compute(fr[: self.base - 2])
                    want = (int(fr[self.base - 2]) << 8) | int(fr[self.base - 1])
                    crc_ok += int(comp == want)
                    out = np.concatenate(
                        [np.array([0x1A, 0xCF, 0xFC, 0x1D], np.uint8), fr])
                    fout.write(out.tobytes())
                    nframes += 1
                pos += p + n_cw * self.unit
        self.stats = {"frames": nframes, "crc_ok": crc_ok}
        logger.info(f"Turbo decoded {nframes} frames ({crc_ok} CRC ok)")
