"""DVB-S2 TS extractor module: .bbframe -> .ts.

Reference: plugins/dvb_support/dvbs2/module_s2_ts_extractor.{h,cpp} (reads
fixed-size BBFrames, runs the BBFrame-to-TS parser, writes 188-byte TS
packets). Here the stream-level defragmentation (SYNCD/DFL walk, CRC-8
check of each user packet) is
satdump_tpu_torch.ops.dvbs2.bbframe.BBFrameTSParser. A host NumPy copy of
satdump_tpu/pipeline/modules/dvbs2/ts_extractor.py.
"""

from __future__ import annotations

import numpy as np

from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.ops.dvbs2 import defs
from satdump_tpu_torch.ops.dvbs2.bbframe import BBFrameTSParser
from satdump_tpu_torch.ops.dvbs2.bch import get_bch
from satdump_tpu_torch.pipeline.module import register_module
from satdump_tpu_torch.pipeline.module import ProcessingModule


@register_module
class S2TSExtractorModule(ProcessingModule):
    id = "dvbs2_ts_extractor"

    def __init__(self, input_file, output_file_hint, parameters):
        super().__init__(input_file, output_file_hint, parameters)
        bb_size = self.param("bb_size")
        if bb_size is not None:
            self.kbch = int(bb_size)
        else:
            modcod = int(self.param("modcod", required=True))
            short = bool(self.param("shortframes", False))
            cfg = defs.get_modcod_cfg(modcod, short, bool(self.param("pilots", False)))
            self.kbch = get_bch(cfg.frame, cfg.rate).kbch

    def process(self):
        out_path = self.d_output_file_hint + ".ts"
        self.d_output_file = out_path
        nbytes = self.kbch // 8
        raw = np.fromfile(self.d_input_file, dtype=np.uint8)
        nframes = len(raw) // nbytes
        frames = raw[: nframes * nbytes].reshape(nframes, nbytes)
        parser = BBFrameTSParser(self.kbch)
        ts = parser.work(frames)
        with open(out_path, "wb") as f:
            f.write(ts.tobytes())
        npkts = len(ts) // 188
        self.stats = {"bbframes": nframes, "ts_packets": npkts}
        logger.info(f"Extracted {npkts} TS packets from {nframes} BBFrames")
