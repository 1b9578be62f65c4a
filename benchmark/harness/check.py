"""The numbers that decide `correct`, as the references' `check` functions
compare them. A configuration's reference (`reference/<name>.py`) defines
`check(run, driver)`, which returns `attempted`, `failed` and `checks`,
{name: {"value", "limit"}}, with each limit from the configuration's
`limits`. The soft-symbol references compare with `softs_and_cadus`:

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


def softs_and_cadus(run, driver, demod) -> dict:
    """`soft_mismatch` of every soft file the driver's `outputs()` yields
    against `demod(stream[:n], cfg)[0]` (one reference for each distinct
    `n`, made from the driver's stream once the program's state is freed),
    and `cadus_failed` of every `.cadu` output against the CADUs sent."""
    cfg = run.cell.cfg
    limits = cfg["limits"]
    ref_by_n, bad, total, attempted, failed = {}, 0, 0, 0, 0
    stream = None
    for soft_path, n, cadu_raw, due in driver.outputs():
        a, f = cadus_failed(cadu_raw, driver.sent, due)
        attempted, failed = attempted + a, failed + f
        if n not in ref_by_n:
            if stream is None:
                stream = driver.stream(run.device)
            ref_by_n[n] = demod(stream[:n], cfg)[0]
        b, t = soft_mismatch(np.fromfile(soft_path, np.int8), ref_by_n[n])
        bad, total = bad + b, total + t
    return {"attempted": attempted, "failed": failed, "checks": {
        "soft_mismatch": {"value": bad / max(total, 1),
                          "limit": limits["soft_mismatch"]},
        "cadus_failed": {"value": failed, "limit": limits["cadus_failed"]}}}
