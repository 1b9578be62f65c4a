"""xRIT network modules: CADU publisher for live GEO feeds + DVB-S2/UDP
CADU extractor.

Behavioral equivalents of src-core/pipeline/modules/xrit/:
* xrit_goesrecv_publisher (module_goesrecv_publisher.cpp): publish each
  1024-byte CADU's 892-byte payload (bytes 4..896) to subscribers over the
  framework's framed-TCP pub socket (goesrecv/xrit-rx interop role; the
  reference uses nng pub — our framing is the satdump_tpu_torch frame protocol).
* s2udp_xrit_cadu_extractor (module_s2udp_xrit_cadu_extractor.cpp):
  BBFrames (or raw TS with ts_input) -> TS demux on one PID -> IP/UDP
  payloads whose bytes [40:44] carry the CADU ASM -> 1024-byte CADUs.
"""

from __future__ import annotations

from typing import List

import numpy as np

from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.pipeline.module import ProcessingModule, register_module


@register_module
class GOESRecvPublisherModule(ProcessingModule):
    id = "xrit_goesrecv_publisher"

    def __init__(self, input_file, output_file_hint, parameters):
        super().__init__(input_file, output_file_hint, parameters)
        self.address = str(self.param("address", "127.0.0.1"))
        self.port = int(self.param("nanomsg_port", 5004))
        self.client_wait = float(self.param("client_wait", 5.0))

    def process(self):
        from satdump_tpu_torch.io.net import FramedTCPServer
        srv = FramedTCPServer(self.port, host=self.address)
        self.port = srv.port
        logger.info(f"xRIT publisher on tcp://{self.address}:{srv.port}")
        try:
            srv.wait_client(timeout=self.client_wait)
        except Exception:
            logger.warning("xRIT publisher: no subscriber connected")
        data = np.fromfile(self.d_input_file, np.uint8)
        n = len(data) // 1024
        sent = 0
        for i in range(n):
            cadu = data[i * 1024: (i + 1) * 1024]
            try:
                srv.send(bytes(cadu[4: 4 + 892]))
                sent += 1
            except Exception:
                break
        srv.close()
        self.stats = {"frames": sent}
        logger.info(f"xRIT publisher: {sent} frames published")


@register_module
class S2UDPxRITCADUExtractorModule(ProcessingModule):
    id = "s2udp_xrit_cadu_extractor"

    def __init__(self, input_file, output_file_hint, parameters):
        super().__init__(input_file, output_file_hint, parameters)
        self.pid = int(self.param("pid", required=True))
        self.bb_size = int(self.param("bb_size", 58192))
        self.ts_input = bool(self.param("ts_input", False))

    def process(self):
        from satdump_tpu_torch.ops.dvbs2.bbframe import BBFrameTSParser
        from satdump_tpu_torch.utils.mpeg_ts import TSDemux

        out_path = self.d_output_file_hint + ".cadu"
        self.d_output_file = out_path
        data = np.fromfile(self.d_input_file, np.uint8)
        if self.ts_input:
            ts = data[: len(data) // 188 * 188]
        else:
            parser = BBFrameTSParser(self.bb_size)
            nbb = len(data) // (self.bb_size // 8)
            ts = parser.work(data[: nbb * (self.bb_size // 8)])
            ts = np.asarray(ts, np.uint8).reshape(-1)
        demux = TSDemux(self.pid)
        n_cadus = 0
        with open(out_path, "wb") as f:
            payloads: List[bytes] = demux.work(ts) + demux.flush()
            for p in payloads:
                if len(p) >= 40 + 1024 and p[40:44] == b"\x1a\xcf\xfc\x1d":
                    f.write(p[40: 40 + 1024])
                    n_cadus += 1
        self.stats = {"cadus": n_cadus}
        logger.info(f"S2 UDP xRIT extractor: {n_cadus} CADUs")
