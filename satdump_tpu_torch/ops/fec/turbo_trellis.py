"""The trellis of the CCSDS 131.0-B turbo codes' constituent encoders:
16-state recursive systematic registers with feedback taps 0b0011 and the
forward taps of each output component. Host NumPy copies of the tables of
satdump_tpu/ops/fec/turbo.py, shared by the encoder (ops/fec/turbo.py) and
the max-log BCJR's wrapper (ops/cuda/turbo_bcjr.py).
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

import numpy as np

MEMORY = 4
NSTATES = 16
_BACKWARD = [0, 0, 1, 1]

_FWD = {
    "sys": [1, 0, 0, 1, 1],
    "p1": [1, 1, 0, 1, 1],
    "p2": [1, 0, 1, 0, 1],
    "p3": [1, 1, 1, 1, 1],
}


def _feedback(state: int) -> int:
    # feedback = sum backward[i] * bit(state, memory-1-i)
    return (sum(_BACKWARD[i] * ((state >> (MEMORY - 1 - i)) & 1)
                for i in range(MEMORY))) % 2


def _state_update(state: int, inp: int) -> int:
    first = (_feedback(state) + inp) % 2
    return (state >> 1) | (first << (MEMORY - 1))


def _outputs(state: int, inp: int, comps: List[str]) -> List[int]:
    ns = _state_update(state, inp)
    first = (ns >> (MEMORY - 1)) & 1
    outs = []
    for name in comps:
        fwd = _FWD[name]
        o = fwd[0] * first
        for i in range(MEMORY):
            o = (o + fwd[i + 1] * ((state >> (MEMORY - 1 - i)) & 1)) % 2
        outs.append(o)
    return outs


@lru_cache(maxsize=None)
def _trellis(comps: Tuple[str, ...]):
    """next_state (16,2), out_bits (16,2,C), termination input (16,)."""
    ns = np.zeros((NSTATES, 2), np.int32)
    out = np.zeros((NSTATES, 2, len(comps)), np.int8)
    term = np.zeros(NSTATES, np.int32)
    for s in range(NSTATES):
        for b in range(2):
            ns[s, b] = _state_update(s, b)
            out[s, b] = _outputs(s, b, list(comps))
        term[s] = _feedback(s)  # input that zeroes the first register
    return ns, out, term


def _bcjr_tables(comps: Tuple[str, ...]):
    ns_t, out_t, _ = _trellis(comps)
    # signed outputs: +1 for bit 1, -1 for bit 0
    sgn = (2.0 * out_t.astype(np.float32) - 1.0)      # (16, 2, C)
    inp_sgn = np.stack([np.full(NSTATES, -1.0, np.float32),
                        np.full(NSTATES, 1.0, np.float32)], axis=1)
    return ns_t, sgn, inp_sgn
