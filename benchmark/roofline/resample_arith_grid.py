"""K2, the arithmetic-grid polyphase symbol pick (`csrc/resample_arith.cu`,
wrapper `ops/cuda/resample.py::resample_arith_grid`), launched with (ext,
n_ext, start, omega, bank, out, out_cap): its operations and bytes for one
launch, and the least time the card could take for them.

Flops: per output symbol 8 complex-by-real FMAs (2 FMAs, 4 flops each) and
6 for its position. Bytes: the n_ext complex64 inputs once, the (128, 8)
float32 bank, start and omega, and out_cap complex64 outputs.
"""

from harness import peaks

DEVICE_NAME = "resample_arith_kernel"
ENTRY = "resample_arith"


def count(args) -> tuple:
    """(flops, bytes) of one launch."""
    n_ext, cap = args[1], args[6]
    return cap * (8 * 4 + 6), n_ext * 8 + 128 * 8 * 4 + 8 + cap * 8


def bound_s(args) -> float:
    flops, nbytes = count(args)
    return max(nbytes / peaks.HBM_BYTES_PER_S, flops / peaks.F32_FLOPS)
