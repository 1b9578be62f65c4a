"""Tracking & automation (ref src-core/common/tracking + src-cli autotrack).

Host-side: SGP4-driven az/el tracking, pass prediction, multi-satellite
scheduling, rotctld rotator protocol, Doppler computation.

A copy of satdump_tpu/tracking/__init__.py, its imports rewritten to the port.
"""

from satdump_tpu_torch.tracking.tracker import (ObjectTracker, SatellitePass,
                                          predict_passes)  # noqa: F401
from satdump_tpu_torch.tracking.scheduler import AutoTrackScheduler, TrackedObject  # noqa: F401
