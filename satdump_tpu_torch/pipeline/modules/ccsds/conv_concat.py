"""Generic CCSDS concatenated decoder: .soft -> .cadu.

Reference: src-core/pipeline/modules/ccsds/module_ccsds_conv_concat_decoder.cpp
(the workhorse of ~half the reference pipelines, SURVEY.md A.1). Chain per
block: [iq invert/bpsk_90 rotate] -> Viterbi (phase/shift search) -> [NRZ-M]
-> deframer -> per frame: [derand] -> RS(223/239) interleaved -> [derand
after RS] -> write cadu. Parameter surface matches the reference JSON.

Port of satdump_tpu/pipeline/modules/ccsds/conv_concat.py. Two execution
paths share the parameter surface (`device` keeps the reference's meaning):
* device (default at rate 1/2): the fused soft->CADU chain
  (ops/fec/cadu_chain.py) — Viterbi (CUDA kernel K1 on the card), NRZ-M,
  deframing, derand and RS all run on `torch_device` per chunk; the host
  only does the lock search (a small batched-hypothesis probe) and
  absolute-position frame bookkeeping.
* host: stage-at-a-time with host NumPy RS — the only path for punctured
  conv rates; its Viterbi runs on `torch_device` too.
`torch_device` ("cuda" by default, or "cpu") names where tensors live.
"""

from __future__ import annotations

import numpy as np

from satdump_tpu_torch.core import trace
from satdump_tpu_torch.core.exceptions import PipelineError
from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.ops.fec import differential
from satdump_tpu_torch.ops.fec.deframer import CCSDSDeframer
from satdump_tpu_torch.ops.fec.randomization import derand_ccsds
from satdump_tpu_torch.ops.fec.reed_solomon import ReedSolomon
from satdump_tpu_torch.ops.fec.rotation import PHASE_0, PHASE_90, rotate_soft
from satdump_tpu_torch.pipeline.module import ProcessingModule, register_module
from satdump_tpu_torch.pipeline.modules.ccsds.viterbi_sync import (
    ST_IDLE, ST_SYNCED, Viterbi12Sync)
from satdump_tpu_torch.utils.device import resolve_device


@register_module
class CCSDSConvConcatDecoderModule(ProcessingModule):
    id = "ccsds_conv_concat_decoder"

    def __init__(self, input_file, output_file_hint, parameters):
        super().__init__(input_file, output_file_hint, parameters)
        self.is_ccsds = bool(self.param("ccsds", True))
        const = str(self.param("constellation", required=True))
        self.cadu_size = int(self.param("cadu_size", required=True))
        self.cadu_bytes = -(-self.cadu_size // 8)
        self.viterbi_outsync = int(self.param("viterbi_outsync_after", 5))
        self.viterbi_ber_thr = float(self.param("viterbi_ber_thresold", 0.3))
        self.diff_decode = bool(self.param("nrzm", False))
        self.derand = bool(self.param("derandomize", True))
        self.derand_after_rs = bool(self.param("derand_after_rs", False))
        self.derand_from = int(self.param("derand_start", 4))
        self.conv_rate = str(self.param("conv_rate", "1/2"))
        self.rs_i = int(self.param("rs_i", 0))
        self.rs_dualbasis = bool(self.param("rs_dualbasis", True))
        self.rs_type = str(self.param("rs_type", "rs223"))
        self.rs_usecheck = bool(self.param("rs_usecheck", False))
        self.iq_invert = bool(self.param("iq_invert", False))
        asm_hex = self.param("asm", "1acffc1d")
        self.asm = int(str(asm_hex), 16)

        self.bpsk_90 = const == "bpsk_90"
        self.oqpsk = const == "oqpsk"
        if const in ("bpsk", "bpsk_90"):
            phases = [PHASE_0] if not self.bpsk_90 else [PHASE_90]
        elif const in ("qpsk", "oqpsk"):
            phases = [PHASE_0, PHASE_90]
        else:
            raise PipelineError(f"invalid constellation {const}")
        if self.conv_rate not in ("1/2", "2/3", "3/4", "5/6", "7/8"):
            raise PipelineError(f"invalid conv_rate {self.conv_rate} "
                                "(ref module_ccsds_conv_concat_decoder.cpp:95-119)")

        self.torch_device = resolve_device(self.param("torch_device", "cuda"))
        self.viterbi = Viterbi12Sync(self.viterbi_ber_thr, self.viterbi_outsync,
                                     phases, check_iq_swap=self.oqpsk,
                                     rate=self.conv_rate,
                                     device=self.torch_device)
        self.deframer = CCSDSDeframer(self.cadu_size, self.asm)
        self.rs = ReedSolomon(k=223 if self.rs_type == "rs223" else 239) if self.rs_i else None
        self.nrzm_last = 0
        self.block = int(self.param("buffer_size", 0) or (8 << 20))
        dev = self.param("device", None)
        self.use_device = (self.conv_rate == "1/2") if dev is None else bool(dev)
        if self.use_device:
            from satdump_tpu_torch.ops.fec.cadu_chain import CaduChain
            self._chain = CaduChain(
                cadu_bits=self.cadu_bytes * 8,
                chunk_pairs=min(self.block // 2, 1 << 20),
                asm=self.asm, nrzm=self.diff_decode, derand=self.derand,
                derand_after_rs=self.derand_after_rs,
                derand_from=self.derand_from, rs_i=self.rs_i,
                rs_k=223 if self.rs_type == "rs223" else 239,
                rs_dual=self.rs_dualbasis, device=self.torch_device)
            self._dev_state = None
            self._dev_lead = np.zeros(0, np.int8)

    # -- device path ---------------------------------------------------------
    def _stream_work_device(self, chunk: np.ndarray, fout, last: bool) -> int:
        """Fused device chain + host lock search. The Viterbi12Sync instance
        is used ONLY as the hypothesis prober (its batched TEST-window
        search); the streaming decode runs in the fused chain."""
        vit = self.viterbi
        buf = np.concatenate([self._dev_lead, np.asarray(chunk, np.int8)])
        if vit.state == ST_IDLE:
            # scan the WHOLE chunk for lock (signal may start mid-stream
            # after a noise lead-in; the head-only probe would discard it)
            off = vit.search_stream(buf) if len(buf) >= 2048 else -1
            if off >= 0:
                logger.info(f"Viterbi lock: offset {off} phase {vit.phase} "
                            f"shift {vit.shift} swap {vit.iq_swap} "
                            f"ber {vit.ber:.3f}")
                buf = buf[off + vit.shift:]      # one-time pair realignment
                self._dev_state = self._chain.init_state()
                self.nrzm_last = 0
            else:
                # keep a window of tail context so a signal start spanning
                # the chunk boundary is still found next call
                self._dev_lead = buf[-(2048 + 2):].copy() \
                    if len(buf) > 2048 else buf
                self._update_stats()
                return 0
        keep = len(buf) // 2 * 2                  # chain consumes whole pairs
        self._dev_lead = buf[keep:]
        n = 0
        ber = vit.ber
        for off in range(0, keep, self._chain.chunk_pairs * 2):
            cadus, rs_errs, st = self._chain.work(
                self._dev_state, buf[off: off + self._chain.chunk_pairs * 2],
                vit.phase, vit.iq_swap)
            n += self._emit_device(cadus, rs_errs, fout)
            ber = st["ber"]
        if last and vit.state == ST_SYNCED:
            cadus, rs_errs, st = self._chain.flush(
                self._dev_state, vit.phase, vit.iq_swap)
            n += self._emit_device(cadus, rs_errs, fout)
        vit.ber = ber
        if ber > self.viterbi_ber_thr:
            vit.invalid += 1
            if vit.invalid > self.viterbi_outsync:
                vit.state = ST_IDLE
        else:
            vit.invalid = 0
        self._nframes += n
        self._update_stats()
        return n

    def _emit_device(self, cadus: np.ndarray, rs_errs: np.ndarray, fout) -> int:
        if len(cadus) == 0:
            return 0
        if self.rs is not None:
            self._rs_avg.append(rs_errs.reshape(-1))
            if self.rs_usecheck:
                cadus = cadus[(rs_errs >= 0).all(axis=1)]
        with trace.span("decoder.write", "host"):
            fout.write(np.ascontiguousarray(
                cadus[:, : self.cadu_bytes]).tobytes())
        trace.count("decoder.cadus", len(cadus))
        return len(cadus)

    def _process_frames(self, frames, fout, rs_avg):
        """Batched frame pipeline: derand + RS + write, vectorized over all
        frames of a chunk at once (one BM/Chien/Forney pass over
        frames×interleave codeword lanes instead of a per-frame loop)."""
        if not frames:
            return 0
        cadus = np.stack(frames).astype(np.uint8)        # (F, bytes)
        if self.derand and not self.derand_after_rs:
            cadus[:, self.derand_from:] = derand_ccsds(cadus[:, self.derand_from:])
        valid = np.ones(len(cadus), bool)
        if self.rs is not None:
            payload = cadus[:, 4: 4 + 255 * self.rs_i]
            corrected, errs = self.rs.decode_interleaved(
                payload, self.rs_dualbasis, self.rs_i)
            cadus[:, 4: 4 + 255 * self.rs_i] = corrected
            valid = (errs >= 0).all(axis=1)
            rs_avg.append(errs.reshape(-1))
        if self.derand and self.derand_after_rs:
            cadus[:, self.derand_from:] = derand_ccsds(cadus[:, self.derand_from:])
        if self.rs_usecheck:
            cadus = cadus[valid]
        fout.write(cadus[:, : self.cadu_bytes].tobytes())
        trace.count("decoder.cadus", len(cadus))
        return len(cadus)

    # -- streaming interface (shared by the offline and live runners) -------
    def stream_start(self) -> None:
        self._nframes = 0
        self._rs_avg = []

    def stream_work(self, chunk: np.ndarray, fout, last: bool = False
                    ) -> int:
        """One soft chunk -> CADUs written to `fout`. Returns frames added."""
        if self.bpsk_90 or self.iq_invert:
            chunk = rotate_soft(chunk, PHASE_0, iq_swap=True)
        if self.use_device:
            with trace.span("decoder.chunk"):
                return self._stream_work_device(chunk, fout, last)
        bits = self.viterbi.work(chunk, last=last)
        if len(bits) == 0:
            return 0
        if self.diff_decode:
            bits, self.nrzm_last = differential.nrzm_decode(bits, self.nrzm_last)
        frames = self.deframer.work(bits)
        n = self._process_frames(frames, fout, self._rs_avg)
        self._nframes += n
        self._update_stats()
        return n

    def _update_stats(self) -> None:
        rs_avg = self._rs_avg
        defra = self.viterbi.getState() if self.use_device \
            else self.deframer.state
        self.stats = {
            "frames": self._nframes,
            "viterbi_ber": self.viterbi.ber,
            "viterbi_lock": self.viterbi.getState(),
            "deframer_lock": defra,
            "rs_avg": float(np.mean(np.concatenate(rs_avg))) if rs_avg else 0.0,
        }

    def process(self):
        ext = ".cadu" if self.is_ccsds else ".frm"
        out_path = self.d_output_file_hint + ext
        self.d_output_file = out_path
        self.stream_start()
        with trace.span("decoder.read", "host"):
            soft = np.fromfile(self.d_input_file, dtype=np.int8)
        with open(out_path, "wb") as fout:
            for off in range(0, len(soft), self.block):
                chunk = soft[off: off + self.block]
                last = off + self.block >= len(soft)
                self.stream_work(chunk, fout, last=last)
        nframes = self._nframes
        self._update_stats()
        logger.info(f"Decoded {nframes} CADUs (viterbi ber {self.viterbi.ber:.3f}, "
                    f"rs avg {self.stats['rs_avg']:.2f})")


@register_module
class MetopAHRPTDecoderModule(CCSDSConvConcatDecoderModule):
    """MetOp AHRPT decoder (ref plugins/noaa_metop_support/metop/module_metop_ahrpt_decoder.cpp):
    QPSK, CADU 1024 bytes, RS223 interleave 4, derandomized."""

    id = "metop_ahrpt_decoder"

    def __init__(self, input_file, output_file_hint, parameters):
        p = dict(parameters or {})
        p.setdefault("constellation", "qpsk")
        p.setdefault("cadu_size", 8192)
        p.setdefault("rs_i", 4)
        p.setdefault("derandomize", True)
        p.setdefault("viterbi_outsync_after", 10)
        p.setdefault("viterbi_ber_thresold", 0.28)
        super().__init__(input_file, output_file_hint, p)


@register_module
class MeteorLRPTDecoderModule(CCSDSConvConcatDecoderModule):
    """METEOR-M LRPT decoder (ref plugins/meteor_support/meteor/module_meteor_lrpt_decoder.cpp):
    QPSK 72k, CADU 1024 bytes, RS223 i=4, optional NRZ-M (diff_decode)."""

    id = "meteor_lrpt_decoder"

    def __init__(self, input_file, output_file_hint, parameters):
        p = dict(parameters or {})
        p.setdefault("constellation", "qpsk")
        p.setdefault("cadu_size", 8192)
        p.setdefault("rs_i", 4)
        p.setdefault("derandomize", True)
        p["nrzm"] = bool(p.get("diff_decode", p.get("nrzm", False)))
        p.setdefault("viterbi_outsync_after", 10)
        p.setdefault("viterbi_ber_thresold", 0.30)
        super().__init__(input_file, output_file_hint, p)
