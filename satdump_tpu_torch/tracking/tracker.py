"""Object tracking: az/el, Doppler, pass prediction.

Reference: src-core/common/tracking/obj_tracker/object_tracker.h (libpredict
SGP4 az/el at a Hz + next-pass search) — here pass search is a vectorized
elevation scan over the whole window plus bisection refinement, not a
per-second loop.

A copy of satdump_tpu/tracking/tracker.py, its imports rewritten to the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from satdump_tpu_torch.geo import SGP4, TLE, look_angles

C_LIGHT = 299792458.0


@dataclass
class SatellitePass:
    norad: int
    aos: float                 # unix
    los: float
    max_elevation: float


class ObjectTracker:
    """Az/el/range/Doppler of one satellite from a ground station."""

    def __init__(self, tle: TLE, qth_lat: float, qth_lon: float,
                 qth_alt_km: float = 0.0):
        self.tle = tle
        self.prop = SGP4(tle)
        self.qth = (qth_lat, qth_lon, qth_alt_km)

    def az_el(self, t_unix) -> np.ndarray:
        """(az_deg, el_deg, range_km), vectorized over t."""
        ecef = self.prop.position_ecef(t_unix)
        return look_angles(*self.qth, ecef)

    def doppler_shift(self, t_unix, freq_hz: float) -> np.ndarray:
        """Doppler-shifted downlink offset (Hz) at time(s) t."""
        t = np.asarray(t_unix, np.float64)
        r0 = self.az_el(t)[..., 2]
        r1 = self.az_el(t + 0.5)[..., 2]
        range_rate = (r1 - r0) / 0.5 * 1000.0        # m/s, + = receding
        return -range_rate / C_LIGHT * freq_hz


def predict_passes(tle: TLE, qth_lat: float, qth_lon: float,
                   t_start: float, t_end: float, *, qth_alt_km: float = 0.0,
                   min_elevation: float = 0.0, step_s: float = 30.0
                   ) -> List[SatellitePass]:
    """All passes in [t_start, t_end] (ref AutoTrackScheduler's upcoming
    pass computation). Coarse vectorized elevation scan + bisection on the
    horizon crossings."""
    trk = ObjectTracker(tle, qth_lat, qth_lon, qth_alt_km)
    ts = np.arange(t_start, t_end + step_s, step_s)
    el = trk.az_el(ts)[..., 1]
    up = el > min_elevation

    def refine(lo: float, hi: float, rising: bool) -> float:
        for _ in range(24):
            mid = 0.5 * (lo + hi)
            e = float(trk.az_el(mid)[1])
            if (e > min_elevation) == rising:
                hi = mid
            else:
                lo = mid
        return 0.5 * (lo + hi)

    passes: List[SatellitePass] = []
    i = 0
    n = len(ts)
    while i < n:
        if not up[i]:
            i += 1
            continue
        j = i
        while j < n and up[j]:
            j += 1
        aos = t_start if i == 0 and up[0] else refine(ts[i - 1], ts[i], True)
        los = t_end if j >= n else refine(ts[j - 1], ts[j], False)
        seg = el[i:j]
        max_el = float(seg.max()) if seg.size else min_elevation
        passes.append(SatellitePass(tle.norad, aos, los, max_el))
        i = j
    return passes
