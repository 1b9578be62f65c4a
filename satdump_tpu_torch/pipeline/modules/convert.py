"""Stream conversion modules + soft-symbol reading helpers.

Reference: src-core/pipeline/modules/module_soft2hard.cpp (int8 softs ->
packed hard bits), common/codings/soft_reader.h (reading .soft inputs that
are actually packed hard bits via `soft_symbols: false`)."""

from __future__ import annotations

import numpy as np

from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.pipeline.module import ProcessingModule, register_module


def read_soft_symbols(path: str, soft_symbols: bool = True) -> np.ndarray:
    """Load a .soft input as signed int8 softs; when the file is packed
    hard bits (soft_symbols=false), expand bits to +-100 softs
    (soft_reader.h convert_from_hard)."""
    if soft_symbols:
        return np.fromfile(path, np.int8)
    raw = np.fromfile(path, np.uint8)
    bits = np.unpackbits(raw)
    return (bits.astype(np.int16) * 200 - 100).astype(np.int8)


@register_module
class Soft2HardModule(ProcessingModule):
    """.soft int8 -> packed hard bits (.hard)."""

    id = "soft2hard"

    def process(self):
        out_path = self.d_output_file_hint + ".hard"
        self.d_output_file = out_path
        soft = np.fromfile(self.d_input_file, np.int8)
        bits = (soft > 0).astype(np.uint8)
        np.packbits(bits).tofile(out_path)
        self.stats = {"bits": int(len(bits))}
        logger.info(f"soft2hard: {len(bits)} bits")


@register_module
class Hard2SoftModule(ProcessingModule):
    """packed hard bits -> .soft int8 (+-100), the inverse convenience."""

    id = "hard2soft"

    def process(self):
        out_path = self.d_output_file_hint + ".soft"
        self.d_output_file = out_path
        read_soft_symbols(self.d_input_file, soft_symbols=False
                          ).tofile(out_path)
        self.stats = {}
