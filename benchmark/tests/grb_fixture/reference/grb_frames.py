"""GOES-R GRB's frames against those sent: the BBFrames that `dvbs2_demod`
writes and the CADUs that the extractor writes, each bit for bit
(`harness/check.py::cadus_failed` on rows of either width).

- `bbframes_failed`: of the BBFrames sent that hold a due CADU's last byte,
  those not written bit for bit, plus every written BBFrame that was never
  sent or is written twice. The BBFrames sent are worked out again from the
  CADUs sent, as the configuration's code module builds them.
- `cadus_failed`: as for every configuration.

A fixture of the benchmark's own tests, which copy it into a copy of the
benchmark. It defines no `control`.
"""

import numpy as np

from harness.check import cadus_failed

READS = {"bbframe": "bbframes_failed", "cadu": "cadus_failed"}


def check(run, driver) -> dict:
    from satdump_tpu_torch import sim
    limits = run.cell.cfg["limits"]
    frames = sim.grb_bbframes(driver.sent)
    data = run.cell.cfg["signal"]["bbframe_bytes"] \
        - run.cell.cfg["signal"]["bbheader_bytes"]
    nb = driver.sent.shape[1]
    last_frame = (np.arange(1, len(driver.sent) + 1) * nb - 1) // data
    bb_failed, attempted, failed = 0, 0, 0
    for bb_path, _, cadu_raw, due in driver.outputs():
        bb_due = np.zeros(len(frames), bool)
        bb_due[last_frame[due]] = True
        bb_failed += cadus_failed(np.fromfile(bb_path, np.uint8), frames,
                                  bb_due)[1]
        a, f = cadus_failed(cadu_raw, driver.sent, due)
        attempted, failed = attempted + a, failed + f
    return {"attempted": attempted, "failed": failed, "checks": {
        "bbframes_failed": {"value": bb_failed,
                            "limit": limits["bbframes_failed"]},
        "cadus_failed": {"value": failed, "limit": limits["cadus_failed"]}}}
