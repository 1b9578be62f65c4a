"""GOES-N MDL + Sensor Data (SD) decoders.

Reference behavior:
* MDL (Multi-use Data Link, 1681.5 MHz QPSK 200 ksym/s):
  plugins/goes_support/goes/mdl/module_goes_mdl_decoder.cpp — correlate a
  32-bit QPSK syncword over the soft stream, slice 464-byte frames, hard
  decide, invert, write .frm.
* SD (GOES-N raw imager sensor data, 1676 MHz BPSK 2.621 Msym/s):
  goes/sd/{module_goesn_sd_decoder.cpp,sd_deframer.cpp} — NRZ-M decode,
  14-bit ASM 0x2B50 (0b10101101010000) deframer with 480-bit frames,
  60-byte PN derandomization, then sd_imager_reader.cpp unpacks 48
  10-bit words/frame into VIS (8 lines/scan) + 4 IR channels.

The bit-serial reference loops become batched NumPy passes over whole
chunks; the imager reader keys scanline boundaries off the most-common
frame type in a 10-frame window exactly like the reference.

Counterpart of satdump_tpu/models/goes_sd.py (host NumPy, copied). The MDL
decoder's sync correlation runs on `torch_device` ("cuda" by default, or
"cpu"), the port's FFT correlator; the rest takes no device.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.ops.fec.codings_misc import SimpleDeframer
from satdump_tpu_torch.ops.fec.correlator import CorrelatorGeneric
from satdump_tpu_torch.ops.fec.differential import nrzm_decode
from satdump_tpu_torch.pipeline.module import ProcessingModule, register_module
from satdump_tpu_torch.utils.device import resolve_device

MDL_SYNC = 0b00010111110101111001100100000 << 3   # module_goes_mdl_decoder
MDL_FRAME_BYTES = 464

SD_ASM = 0b10101101010000                         # sd_deframer.h
SD_ASM_BITS = 14
SD_FRAME_BITS = 480
SD_FRAME_BYTES = 60
SD_PN = np.array([
    0xad, 0x43, 0xc4, 0x7e, 0x31, 0x6c, 0x28, 0xae,
    0xde, 0x63, 0xd0, 0x93, 0x2f, 0x10, 0xf0, 0x07,
    0xc2, 0x0e, 0x8c, 0xdf, 0x6b, 0x12, 0xe1, 0x83,
    0x27, 0x56, 0xe3, 0x92, 0xa3, 0xb3, 0xbb, 0xfd,
    0x6e, 0x7b, 0x1a, 0xa7, 0x90, 0xb2, 0x37, 0x5e,
    0xa5, 0x81, 0x36, 0xd2, 0x06, 0xca, 0xcc, 0x7e,
    0x73, 0x5c, 0xb4, 0x05, 0xd3, 0x8a, 0x69, 0x87,
    0x04, 0x5f, 0x29, 0x22], np.uint8)            # module_goesn_sd_decoder

SD_IMG_WIDTH = 40000                              # sd_imager_reader.cpp:11
SD_VIS_CROP = 21072


@register_module
class GOESMDLDecoderModule(ProcessingModule):
    """Soft QPSK -> 464-byte MDL frames (.frm)."""

    id = "goes_mdl_decoder"

    def __init__(self, input_file, output_file_hint, parameters):
        super().__init__(input_file, output_file_hint, parameters)
        self.torch_device = resolve_device(self.param("torch_device", "cuda"))

    def process(self):
        out_path = self.d_output_file_hint + ".frm"
        self.d_output_file = out_path
        from satdump_tpu_torch.ops.fec.rotation import rotate_soft
        soft = np.fromfile(self.d_input_file, np.int8)
        enc_bits = MDL_FRAME_BYTES * 8
        sync_bits = ((MDL_SYNC >> np.arange(31, -1, -1)) & 1).astype(np.uint8)
        corr = CorrelatorGeneric("qpsk", sync_bits, device=self.torch_device)
        n = 0
        locked = False
        with open(out_path, "wb") as f:
            pos = 0
            while pos + enc_bits <= len(soft):
                chunk = soft[pos: pos + enc_bits]
                off, phase, swap, conf = corr.correlate(chunk)
                locked = off == 0
                if off != 0:
                    # resync: consume up to the detected sync position
                    pos += off if off > 0 else enc_bits
                    continue
                bits = (rotate_soft(chunk, phase, swap) > 0).astype(np.uint8)
                by = np.packbits(bits) ^ 0xFF     # invert (mdl_decoder:63)
                f.write(by.tobytes())
                n += 1
                pos += enc_bits
        self.stats = {"frame_count": n,
                      "lock_state": "SYNCED" if locked else "NOSYNC"}
        logger.info(f"MDL: {n} frames")


@register_module
class GOESNSDDecoderModule(ProcessingModule):
    """Soft BPSK -> NRZ-M -> SD deframe -> derand -> 60-byte frames."""

    id = "goesn_sd_decoder"

    def process(self):
        out_path = self.d_output_file_hint + ".frm"
        self.d_output_file = out_path
        soft = np.fromfile(self.d_input_file, np.int8)
        bits = (soft > 0).astype(np.uint8)
        bits, _ = nrzm_decode(bits)
        deframer = SimpleDeframer(SD_ASM, SD_ASM_BITS, SD_FRAME_BITS,
                                  threshold=0)
        n = 0
        with open(out_path, "wb") as f:
            for frm in deframer.work(bits):
                by = np.asarray(frm, np.uint8)[:SD_FRAME_BYTES]
                f.write((by ^ SD_PN).tobytes())
                n += 1
        self.stats = {"frame_count": n,
                      "deframer_state": "SYNCED" if n else "NOSYNC"}
        logger.info(f"SD: {n} frames")


class SDImagerReader:
    """GOES-N imager raw-SD scan assembler (sd_imager_reader.cpp).

    Frames carry a type word (words[1] & 31): type 26 = imagery block
    (48 words appended to the current scanline), type 21 after types-0
    fill = end of scanline, type 16 majority = end of frame (save)."""

    def __init__(self):
        self.last_status = np.zeros(10, np.uint16)
        self.wip: list = []
        self.scanlines: list = []
        self.images_lines = 0
        self.should_save = False
        self.saved = 0

    def work(self, words: np.ndarray) -> None:
        wtype = int(words[1]) & 31
        self.last_status = np.roll(self.last_status, -1)
        self.last_status[-1] = wtype
        vals, counts = np.unique(self.last_status, return_counts=True)
        last_types = int(vals[np.argmax(counts)])

        if last_types == 16:
            if self.images_lines > 10:
                self.should_save = True
            self.images_lines = 0

        if wtype == 21 and last_types == 0 and self.wip:
            self.scanlines.append(
                (np.asarray(self.wip, np.uint16),
                 bool((int(self.wip[3]) >> 6) & 1) if len(self.wip) > 3
                 else False))
            self.images_lines += 1
            self.wip = []
        if last_types == 26:
            self.wip.extend(int(w) for w in words[:48])

    def render(self):
        """-> dict of channel name -> uint16 image (vectorized block
        unpack of sd_imager_reader.cpp:40-118)."""
        lines = len(self.scanlines)
        vis = np.zeros((lines * 8, SD_IMG_WIDTH), np.uint16)
        irs = [np.zeros((lines * 2, SD_IMG_WIDTH), np.uint16)
               for _ in range(4)]
        for li, (scan, shifted) in enumerate(self.scanlines):
            nb = len(scan) // 48
            if nb == 0:
                continue
            blocks = scan[: nb * 48].reshape(nb, 4, 12)
            if not shifted:
                xs = np.arange(nb)
            else:
                x0 = (20917 - 70 + 12 - 3 - 8 - 7 * 4) // 4
                xs = np.maximum(x0 - np.arange(nb), 0)
            keep = xs * 4 + 3 < SD_IMG_WIDTH
            xs = xs[keep]
            blocks = blocks[keep]
            # VIS: rows 0..7 come from word indices 9..2; 4 detectors/block
            for row in range(8):
                v = (blocks[:, :, 9 - row] << 6).astype(np.uint16)
                cols = (xs[:, None] * 4
                        + (np.arange(4)[None, ::-1] if shifted
                           else np.arange(4)[None, :]))
                vis[li * 8 + row, cols.ravel()] = v.ravel()
            # IR: two detector rows from words 10/11 of each band block
            # (IR4 repeats word 10 on both rows — reference quirk,
            # sd_imager_reader.cpp:84-85)
            for b in range(4):
                irs[b][li * 2 + 1, xs] = 65535 - (blocks[:, b, 10] << 6)
                w_row0 = blocks[:, b, 11] if b < 3 else blocks[:, b, 10]
                irs[b][li * 2 + 0, xs] = 65535 - (w_row0 << 6)
        out = {"VIS": vis[:, :SD_VIS_CROP]}
        for b in range(4):
            out[f"IR{b + 1}"] = irs[b][:, : SD_VIS_CROP // 4]
        return out


@register_module
class SDImageDecoderModule(ProcessingModule):
    """60-byte SD frames -> VIS/IR1..4 PNGs (goes_sd_image_decoder)."""

    id = "goes_sd_image_decoder"

    def process(self):
        from satdump_tpu_torch.image.io import save_img
        from satdump_tpu_torch.models.goes_gvar import unpack_words10
        data = np.fromfile(self.d_input_file, np.uint8)
        out_dir = Path(self.d_output_file_hint).parent
        rd = SDImagerReader()
        nsets = 0
        for off in range(0, len(data) // SD_FRAME_BYTES * SD_FRAME_BYTES,
                         SD_FRAME_BYTES):
            words = unpack_words10(data[off: off + SD_FRAME_BYTES], 48)
            rd.work(words)
            if rd.should_save:
                nsets += 1
                d = out_dir / str(nsets)
                d.mkdir(parents=True, exist_ok=True)
                for name, img in rd.render().items():
                    save_img(img, d / f"{name}.png")
                rd.scanlines = []
                rd.should_save = False
        if rd.scanlines:
            nsets += 1
            d = out_dir / str(nsets)
            d.mkdir(parents=True, exist_ok=True)
            for name, img in rd.render().items():
                save_img(img, d / f"{name}.png")
        self.d_output_file = str(out_dir)
        self.stats = {"image_sets": nsets,
                      "lines": len(rd.scanlines)}
        logger.info(f"SD imager: {nsets} image sets")
