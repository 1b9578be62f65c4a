"""DVB-S legacy demodulator module: baseband -> .ts — port of
satdump_tpu/pipeline/modules/dvbs2/dvbs.py.

Reference: plugins/dvb_support/dvbs/module_dvbs_demod.cpp — QPSK demod ->
punctured Viterbi with rate autodetection (viterbi_all) -> bit-level TS
deframer on the 0x47/0xB8 comb (dvbs_defra) -> Forney deinterleave ->
RS(204,188) -> energy-dispersal descramble -> 188-byte TS packets.

The demod front end is psk_demod's stream API and the Viterbi the port's
Viterbi12Sync (punctured rates through its tiled decoder, rate 1/2 through
the kernel K1 on the card), both on `torch_device` (default ``cuda``);
byte alignment is a vectorized comb search over the 8 bit offsets; RS
decodes all packets of a chunk in one batched call (host).
"""

from __future__ import annotations

import numpy as np

from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.ops import dvbs
from satdump_tpu_torch.ops.fec.rotation import PHASE_0, PHASE_90
from satdump_tpu_torch.pipeline.module import register_module
from satdump_tpu_torch.pipeline.modules.ccsds.viterbi_sync import Viterbi12Sync
from satdump_tpu_torch.pipeline.modules.demod.psk import PSKDemodModule

RATES = ["1/2", "2/3", "3/4", "5/6", "7/8"]


@register_module
class DVBSDemodModule(PSKDemodModule):
    id = "dvbs_demod"

    def __init__(self, input_file, output_file_hint, parameters):
        p = dict(parameters or {})
        p.setdefault("constellation", "qpsk")
        p.setdefault("rrc_alpha", 0.35)
        p.setdefault("pll_bw", p.pop("pll_bw", 0.003) or 0.003)
        super().__init__(input_file, output_file_hint, p)
        self.conv_rate = str(self.param("conv_rate", "auto"))
        self.vit_thr = float(self.param("viterbi_ber_thresold", 0.19))
        self.vit_outsync = int(self.param("viterbi_outsync_after", 50))

    def _make_viterbi(self, rate: str) -> Viterbi12Sync:
        return Viterbi12Sync(self.vit_thr, self.vit_outsync,
                             [PHASE_0, PHASE_90], rate=rate,
                             device=self.torch_device)

    def process(self):
        self.stream_start()
        out_path = self.d_output_file_hint + ".ts"
        self.d_output_file = out_path
        reader = self.open_input(self.block_size)

        vit = None if self.conv_rate == "auto" \
            else self._make_viterbi(self.conv_rate)
        deint = dvbs.ConvDeinterleaver()
        rs = dvbs.DVBSReedSolomon()
        bitbuf = np.zeros(0, np.uint8)
        bytebuf = np.zeros(0, np.uint8)
        bit_off = None
        npkts = 0
        rs_errs = []
        with open(out_path, "wb") as f:
            for blk in reader.blocks():
                soft = self.stream_work(blk.samples, valid=blk.valid,
                                        last=blk.last)
                if vit is None:
                    # rate autodetect (viterbi_all): try every rate, keep
                    # the lock with the lowest scaled BER (a punctured
                    # stream can spuriously clear a wrong rate's threshold)
                    best = None
                    for rate in RATES:
                        cand = self._make_viterbi(rate)
                        if cand._search(soft) and \
                                (best is None or cand.ber < best.ber):
                            best = cand
                    if best is None:
                        continue
                    vit = best
                    logger.info(f"DVB-S Viterbi locked at rate {vit.rate} "
                                f"(ber {vit.ber:.3f})")
                bits = vit.work(soft, last=blk.last)
                if not len(bits):
                    continue
                bitbuf = np.concatenate([bitbuf, bits])
                if bit_off is None:
                    bit_off = self._find_bit_alignment(bitbuf)
                    if bit_off is None:
                        bitbuf = bitbuf[-dvbs.RS_SIZE * 8 * 10:]
                        continue
                    bitbuf = bitbuf[bit_off:]
                    bit_off = 0
                nbytes = len(bitbuf) // 8
                bytebuf = np.concatenate(
                    [bytebuf, np.packbits(bitbuf[: nbytes * 8])])
                bitbuf = bitbuf[nbytes * 8:]
                npkts_new, errs = self._drain(bytebuf, deint, rs, f)
                consumed = (len(bytebuf) // dvbs.RS_SIZE) * dvbs.RS_SIZE
                bytebuf = bytebuf[consumed:]
                npkts += npkts_new
                rs_errs += errs
        self.stats.update({
            "ts_packets": npkts,
            "viterbi_rate": vit.rate if vit else "none",
            "viterbi_ber": vit.ber if vit else 1.0,
            "rs_avg": float(np.mean(rs_errs)) if rs_errs else 0.0,
        })
        logger.info(f"DVB-S: {npkts} TS packets "
                    f"(rate {self.stats['viterbi_rate']})")

    def _find_bit_alignment(self, bits: np.ndarray):
        """Try the 8 bit offsets; pick the one whose byte stream shows the
        0x47/0xB8 comb (dvbs_defra's shifter search, vectorized)."""
        if len(bits) < dvbs.RS_SIZE * 8 * 10:
            return None
        for off in range(8):
            nbytes = (len(bits) - off) // 8
            data = np.packbits(bits[off: off + nbytes * 8])
            pos = dvbs.find_ts_sync(data)
            if pos is not None:
                return off + pos * 8
        return None

    def _drain(self, bytebuf: np.ndarray, deint, rs, f):
        nframes = len(bytebuf) // dvbs.RS_SIZE
        if nframes == 0:
            return 0, []
        stream = deint.work(bytebuf[: nframes * dvbs.RS_SIZE])
        cws = stream.reshape(nframes, dvbs.RS_SIZE)
        pkts, nerr = rs.decode(cws)
        good = nerr >= 0
        errs = [int(e) for e in nerr[good]]
        # energy-dispersal descramble per 8-packet group, phase from the
        # inverted sync byte (EN 300 421 §4.1.1)
        out = 0
        syncs = pkts[:, 0]
        inv = np.flatnonzero(syncs == dvbs.SYNC_INV)
        if len(inv) == 0:
            return 0, errs
        start = int(inv[0])
        for g in range(start, nframes - 7, 8):
            grp = pkts[g: g + 8]
            if not good[g: g + 8].all():
                continue
            de = dvbs.energy_dispersal(grp)
            de[:, 0] = dvbs.SYNC
            f.write(de.tobytes())
            out += 8
        return out, errs
