"""The numbers that decide `correct`.

- `soft_mismatch`: the share of the reference's soft values that the
  program's `.soft` does not give at the same position (a length that differs
  counts every missing or extra value). The reference is `reference/` run on
  the same samples in the same blocks; `psk_demod` writes its softs before any
  FEC, which would correct most demodulator errors downstream.
- `cadus_failed`: of the CADUs sent whose last sample the program was handed
  (`due`), those not written bit for bit, plus every written CADU that was
  never sent or is written twice.
"""

from __future__ import annotations

import numpy as np


def soft_mismatch(prog: np.ndarray, ref: np.ndarray) -> tuple:
    """(mismatched values, reference values)."""
    m = min(len(prog), len(ref))
    bad = int(np.count_nonzero(prog[:m] != ref[:m])) + abs(len(prog)
                                                          - len(ref))
    return bad, len(ref)


def cadus_failed(raw: np.ndarray, sent: np.ndarray, due: np.ndarray
                 ) -> tuple:
    """(attempted, failed) for one `.cadu` file's bytes `raw`: `sent`
    (N, bytes) CADUs, `due` a boolean mask over them. A trailing partial
    CADU counts as one written wrong."""
    nb = sent.shape[1]
    rows = raw[: len(raw) // nb * nb].reshape(-1, nb)
    index = {row.tobytes(): i for i, row in enumerate(sent)}
    hits = [index.get(row.tobytes(), -1) for row in rows]
    found = {h for h in hits if h >= 0}
    wrong = (sum(h < 0 for h in hits) + sum(h >= 0 for h in hits)
             - len(found) + (len(raw) % nb != 0))
    attempted = int(np.count_nonzero(due))
    missing = attempted - len(found.intersection(np.flatnonzero(due)))
    return attempted, missing + wrong
