"""K1, the register-exchange Viterbi decoder (`csrc/viterbi_re.cu`, wrapper
`ops/cuda/viterbi.py::viterbi_re`), launched with (soft, T, lanes, seg, ovl,
out): its operations and bytes for one launch, and the least time the card
could take for them.

Operations count the trellis steps the T soft pairs need, once each: per
step 4 branch metrics (2 operations each) and, for each of the 64 states,
2 candidate adds and 1 compare-select, none of them an FMA. The steps that
the kernel recomputes in each lane's overlap (ovl + RE_DELAY) are its own
cost and are not counted. Bytes: the float32 pairs in and one byte a decoded
bit out, once each.
"""

from harness import peaks

DEVICE_NAME = "viterbi_re_kernel"
ENTRY = "viterbi_re"


def count(args) -> tuple:
    """(operations, bytes) of one launch."""
    T = args[1]
    return T * (4 * 2 + 64 * 3), T * 2 * 4 + T


def bound_s(args) -> float:
    ops, nbytes = count(args)
    return max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.F32_OPS)
