"""Inmarsat STD-C decoder module: .soft -> .frm (640-byte frames).

Reference: plugins/inmarsat_support/stdc/module_stdc_decoder.cpp — a
one-symbol-at-a-time shifter correlates the 64-row sync pattern; on a match
>120/128 the 10368-symbol frame is (optionally inversion-corrected,)
depermuted, deinterleaved, Viterbi k=7 {109,79} decoded and descrambled
into a 640-byte frame.

The per-symbol shifter becomes one vectorized correlation over every offset
of a chunk (ops.inmarsat_stdc.find_frames), and the frames found in a chunk
(up to 16) are the rows of one batched trellis decode on `torch_device`
("cuda" by default, or "cpu"). Counterpart of
satdump_tpu/pipeline/modules/inmarsat/stdc_decoder.py, which decodes them
one at a time: the rows are independent, so the bytes are the same.
"""

from __future__ import annotations

import numpy as np

from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.ops import inmarsat_stdc as stdc
from satdump_tpu_torch.pipeline.module import ProcessingModule, register_module
from satdump_tpu_torch.utils.device import resolve_device


@register_module
class STDCDecoderModule(ProcessingModule):
    id = "inmarsat_stdc_decoder"

    def __init__(self, input_file, output_file_hint, parameters):
        super().__init__(input_file, output_file_hint, parameters)
        self.threshold = int(self.param("correlation_threshold", 120))
        self.torch_device = resolve_device(self.param("torch_device", "cuda"))

    def process(self):
        out_path = self.d_output_file_hint + ".frm"
        self.d_output_file = out_path
        soft = np.fromfile(self.d_input_file, dtype=np.int8)
        nframes = 0
        bers = []
        chunk = 16 * stdc.ENCODED_FRAME_SIZE
        with open(out_path, "wb") as f:
            pos = 0
            while pos < len(soft):
                block = soft[pos: pos + chunk + stdc.ENCODED_FRAME_SIZE - 1]
                if len(block) < stdc.ENCODED_FRAME_SIZE:
                    break
                frames = []
                for off, inverted in stdc.find_frames(block, self.threshold):
                    frame = block[off: off + stdc.ENCODED_FRAME_SIZE]
                    if inverted:
                        frame = -frame.astype(np.int16)
                        frame = frame.clip(-127, 127).astype(np.int8)
                    frames.append(frame)
                if frames:
                    data, ber = stdc.decode_frames(np.stack(frames),
                                                   self.torch_device)
                    f.write(data.tobytes())
                    nframes += len(frames)
                    bers.extend(ber.tolist())
                pos += chunk
        self.stats = {
            "frames": nframes,
            "viterbi_ber": float(np.mean(bers)) if bers else 1.0,
            "lock_state": "SYNCED" if nframes else "NOSYNC",
        }
        logger.info(f"STD-C: {nframes} frames "
                    f"(ber {self.stats['viterbi_ber']:.3f})")
