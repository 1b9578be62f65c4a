"""GOES-R GRB (GOES Rebroadcast): the BBFrame -> CADU extractor — port of
the first part of satdump_tpu/models/goes_grb.py.

Behavioral equivalent of plugins/goes_support/goes/grb/
module_goes_grb_cadu_extractor.cpp: DVB-S2 BBFrames (7274 bytes, 10-byte
BBHeader) carry a byte-aligned stream of 2048-byte CADUs; re-sync by
correlating the 4-byte ASM inside each window. Host NumPy, as in the JAX
package. The data decoder (`goes_grb_data_decoder`: ABI, SUVI and GLM
products) is not ported yet: its ABI blocks need a JPEG 2000 decoder that
does not use Pillow.
"""

from __future__ import annotations

import numpy as np

from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.pipeline.module import ProcessingModule, register_module

BBFRAME_SIZE = 58192 // 8   # bytes (module_goes_grb_cadu_extractor.cpp:8)
CADU_SIZE = 2048
ASM = bytes([0x1A, 0xCF, 0xFC, 0x1D])


# ---------------------------------------------------------------------------
# CADU extractor (bbframe -> cadu)
# ---------------------------------------------------------------------------
@register_module
class GRBCaduExtractorModule(ProcessingModule):
    """BBFrame stream -> byte-aligned 2048-byte CADUs
    (module_goes_grb_cadu_extractor.cpp:34-90). Vectorized correlation: the
    ASM match count at every window offset via 4 shifted compares."""

    id = "goes_grb_cadu_extractor"

    def __init__(self, input_file, output_file_hint, parameters):
        super().__init__(input_file, output_file_hint, parameters)
        self.synced = False
        self.cor = 0

    def _best_asm(self, win: np.ndarray) -> tuple[int, int]:
        """First offset with a full ASM match, else argmax of match count."""
        n = len(win) - 4
        cor = np.zeros(n, np.int32)
        for k, b in enumerate(ASM):
            cor += win[k: k + n] == b
        full = np.flatnonzero(cor == 4)
        if len(full):
            return int(full[0]), 4
        best = int(np.argmax(cor))
        return best, int(cor[best])

    def process(self):
        out_path = self.d_output_file_hint + ".cadu"
        self.d_output_file = out_path
        data = np.fromfile(self.d_input_file, dtype=np.uint8)
        nbb = len(data) // BBFRAME_SIZE
        # strip the 10-byte BBHeader of every frame, concatenate payloads
        payload = data[: nbb * BBFRAME_SIZE].reshape(nbb, BBFRAME_SIZE)[:, 10:]
        stream = payload.reshape(-1)
        n_cadus = 0
        pos = 0
        with open(out_path, "wb") as f:
            while pos + 2 * CADU_SIZE <= len(stream):
                win = stream[pos: pos + CADU_SIZE]
                best, cor = self._best_asm(
                    np.concatenate([win, stream[pos + CADU_SIZE:
                                                pos + CADU_SIZE + 4]]))
                self.cor, self.synced = cor, best == 0
                pos += best           # realign to the ASM
                f.write(stream[pos: pos + CADU_SIZE].tobytes())
                pos += CADU_SIZE
                n_cadus += 1
        self.stats = {"cadus": n_cadus, "synced": self.synced,
                      "correlation": self.cor}
        logger.info(f"GRB CADU extractor: {n_cadus} CADUs")
