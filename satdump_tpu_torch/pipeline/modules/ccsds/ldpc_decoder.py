"""Generic CCSDS LDPC decoder module: .soft -> .cadu / .frm.

Reference: src-core/pipeline/modules/ccsds/module_ccsds_ldpc_decoder.cpp —
frame = ASM (32-bit 0x1ACFFC1D for the C2 7/8 code, 64-bit
0x034776C7272895B0 for AR4JA) + punctured/shortened codeword softs;
per frame: correlate + realign + derotate -> soft derand -> LDPC decode ->
emit ASM + packed decoded bits (optionally an inner CADU deframer for
internal_stream payloads).

Counterpart of satdump_tpu/pipeline/modules/ccsds/ldpc_decoder.py, with the
same parameters, aligned-run extraction, OQPSK Q shift and output, but for
one repair: the JAX module starts each run at the window's best
correlation, which drops the frames ahead of it (up to three a run); here a
run starts at the first frame from which every marker up to the best one
correlates above the threshold.

Instead of the reference's one-frame-at-a-time correlate/decode loop,
frames are gathered in aligned runs (one FFT correlation per resync) and
decoded `batch_frames` at once. The correlation and the min-sum run on
`torch_device` ("cuda" by default, or "cpu"); the extraction, rotation,
derandomization and the inner deframer are host NumPy.
"""

from __future__ import annotations

import numpy as np

from satdump_tpu_torch.core.exceptions import PipelineError
from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.ops.fec.correlator import CorrelatorGeneric
from satdump_tpu_torch.ops.fec.deframer import CCSDSDeframer, asm_bits
from satdump_tpu_torch.ops.fec.ldpc_ccsds import CCSDSLDPC
from satdump_tpu_torch.ops.fec.randomization import derand_ccsds_soft
from satdump_tpu_torch.ops.fec.rotation import rotate_soft
from satdump_tpu_torch.pipeline.module import (ProcessingModule,
                                               register_module)
from satdump_tpu_torch.utils.device import resolve_device

ASM_AR4JA = 0x034776C7272895B0
ASM_C2 = 0x1ACFFC1D


@register_module
class CCSDSLDPCDecoderModule(ProcessingModule):
    id = "ccsds_ldpc_decoder"

    def __init__(self, input_file, output_file_hint, parameters):
        super().__init__(input_file, output_file_hint, parameters)
        self.is_ccsds = bool(self.param("ccsds", True))
        self.const = str(self.param("constellation", required=True))
        if self.const not in ("bpsk", "qpsk", "oqpsk"):
            raise PipelineError(f"LDPC decoder: invalid constellation {self.const}")
        self.derand = bool(self.param("derandomize", True))
        self.rate = str(self.param("ldpc_rate", required=True))
        self.block = int(self.param("ldpc_block_size", 0))
        self.iters = int(self.param("ldpc_iterations", 10))
        self.internal_stream = bool(self.param("internal_stream", False))
        self.internal_cadu_size = int(self.param("internal_cadu_size", 0))

        self.torch_device = resolve_device(self.param("torch_device", "cuda"))
        self.ldpc = CCSDSLDPC(self.rate, self.block, iters=self.iters)
        if self.rate == "7/8":
            self.asm_val, self.asm_size = ASM_C2, 32
        else:
            self.asm_val, self.asm_size = ASM_AR4JA, 64
        self.frame_total = self.ldpc.frame_bits + self.asm_size
        sync = asm_bits(self.asm_val, self.asm_size)
        self.correlator = CorrelatorGeneric(self.const, sync,
                                            device=self.torch_device)
        self.deframer = CCSDSDeframer(self.internal_cadu_size,
                                      int(str(self.param("internal_asm",
                                                         "1acffc1d")), 16)) \
            if self.internal_stream else None
        self.corr_threshold = float(self.param("corr_threshold", 0.5))
        self.batch_frames = int(self.param("batch_frames", 32))

    # -- aligned-run extraction ----------------------------------------------
    def _frames_from_block(self, soft: np.ndarray):
        """Yield (B, frame_bits) derotated codeword-soft batches from a block
        of raw int8 softs. One correlator call per resync."""
        F = self.frame_total
        pos = 0
        n = len(soft)
        while pos + F <= n:
            win = soft[pos: pos + min(n - pos, F * self.batch_frames)]
            p, phase, swap, cor = self.correlator.correlate(win[: 4 * F]
                                                            if len(win) > 4 * F
                                                            else win)
            if cor < self.corr_threshold:
                pos += F  # nothing recognizable; skip ahead
                self._lock = False
                continue
            self._lock = True
            self._cor = cor
            # the frames ahead of the best match too (the JAX module starts
            # at the best match and drops them)
            start = pos + self.correlator.earliest(
                win, p, F, phase, swap, self.corr_threshold)
            nfr = (n - start) // F
            nfr = min(nfr, self.batch_frames)
            if nfr == 0:
                break
            frames = soft[start: start + nfr * F].reshape(nfr, F)
            frames = rotate_soft(frames.reshape(-1), phase,
                                 swap and self.const != "oqpsk").reshape(nfr, F)
            if self.const == "oqpsk" and swap:
                # advance Q one symbol (ref module loop walks from the end:
                # Q[i] <- Q[i+1], last Q <- 0)
                fl = frames.reshape(-1).copy()
                q = fl[1::2].copy()
                fl[1::2][:-1] = q[1:]
                fl[1::2][-1] = 0
                frames = fl.reshape(nfr, F)
            # verify each frame's own ASM; stop the run at the first bad one
            asm_soft = frames[:, : self.asm_size]
            pat = np.where(asm_bits(self.asm_val, self.asm_size) > 0, 1, -1)
            per = (asm_soft.astype(np.float32) @ pat) / (self.asm_size * 127.0)
            good = per > 0.3
            run = int(np.argmin(good)) if not good.all() else nfr
            if run == 0:
                pos = start + F
                continue
            yield frames[:run, self.asm_size:]
            pos = start + run * F

    def process(self):
        ext = ".cadu" if self.is_ccsds else ".frm"
        out_path = self.d_output_file_hint + ext
        self.d_output_file = out_path
        soft = np.fromfile(self.d_input_file, dtype=np.int8)
        self._lock = False
        self._cor = 0.0
        nframes = 0
        nbad = 0
        asm_bytes = np.frombuffer(
            int(self.asm_val).to_bytes(self.asm_size // 8, "big"), np.uint8)
        with open(out_path, "wb") as fout:
            for batch in self._frames_from_block(soft):
                if self.derand:
                    batch = derand_ccsds_soft(batch)
                bits, ok = self.ldpc.decode_frames(batch,
                                                   device=self.torch_device)
                nbad += int((~ok).sum())
                for i in range(bits.shape[0]):
                    if self.internal_stream:
                        payload = bits[i, : self.ldpc.data_bits]
                        for cadu in self.deframer.work(payload):
                            fout.write(np.asarray(cadu, np.uint8).tobytes())
                            nframes += 1
                    else:
                        packed = np.packbits(bits[i])
                        fout.write(asm_bytes.tobytes())
                        fout.write(packed.tobytes())
                        nframes += 1
        self.stats = {
            "frames": nframes,
            "ldpc_bad": nbad,
            "correlator_lock": self._lock,
            "correlator_corr": self._cor,
        }
        logger.info(f"LDPC {self.rate}: {nframes} frames ({nbad} failed)")
