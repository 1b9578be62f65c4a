"""AutoTrack scheduler: multi-satellite pass planning + AOS/LOS dispatch.

Reference: src-core/common/tracking/scheduler/{scheduler,passes}.cpp —
upcoming passes per enabled satellite, elevation-window filtering, overlap
resolution by max elevation (selectPassesForAutotrack), and a 10 Hz
processAutotrack loop firing aos/los callbacks. Here the loop is an
explicit `tick(t)` (testable without threads; `run()` wraps it).

A copy of satdump_tpu/tracking/scheduler.py, its imports rewritten to the port.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.geo import TLE
from satdump_tpu_torch.tracking.tracker import SatellitePass, predict_passes


@dataclass
class TrackedObject:
    """One enabled satellite (ref scheduler.h TrackedObject: norad +
    downlink config handed to the AOS callback)."""
    norad: int
    tle: TLE
    frequency_hz: float = 0.0
    pipeline_id: str = ""
    min_elevation: float = 0.0
    max_elevation: float = 90.0
    priority: float = 0.0


def filter_passes_by_elevation(passes: List[SatellitePass],
                               min_el: float, max_el: float
                               ) -> List[SatellitePass]:
    return [p for p in passes if min_el <= p.max_elevation <= max_el]


def select_passes_for_autotrack(passes: List[SatellitePass]
                                ) -> List[SatellitePass]:
    """Resolve overlaps: at any instant the ongoing pass with the highest
    max elevation wins; a winning pass is kept only while it holds the
    maximum (passes.cpp selectPassesForAutotrack). Returns non-overlapping
    (possibly trimmed) passes sorted by AOS."""
    if not passes:
        return []
    passes = sorted(passes, key=lambda p: p.aos)
    events = sorted({p.aos for p in passes} | {p.los for p in passes})
    out: List[SatellitePass] = []
    current: Optional[SatellitePass] = None
    seg_start = 0.0
    for t in events:
        ongoing = [p for p in passes if p.aos <= t < p.los]
        best = max(ongoing, key=lambda p: p.max_elevation, default=None)
        if best is not current:
            if current is not None:
                out.append(SatellitePass(current.norad, seg_start, t,
                                         current.max_elevation))
            current = best
            seg_start = t
    if current is not None:
        out.append(SatellitePass(current.norad, seg_start,
                                 current.los, current.max_elevation))
    return [p for p in out if p.los - p.aos > 1.0]


class AutoTrackScheduler:
    def __init__(self, qth_lat: float, qth_lon: float,
                 qth_alt_km: float = 0.0, multi_mode: bool = False):
        self.qth = (qth_lat, qth_lon, qth_alt_km)
        self.multi_mode = multi_mode
        self.enabled: List[TrackedObject] = []
        self.upcoming_all: List[SatellitePass] = []
        self.upcoming_sel: List[SatellitePass] = []
        self.aos_callback: Callable[[SatellitePass, TrackedObject], None] = \
            lambda p, o: None
        self.los_callback: Callable[[SatellitePass, TrackedObject], None] = \
            lambda p, o: None
        self._visible: Dict[int, SatellitePass] = {}
        self._thread: Optional[threading.Thread] = None
        self._run = False

    def track(self, obj: TrackedObject) -> None:
        self.enabled.append(obj)

    def compute_passes(self, t_start: float, horizon_s: float = 12 * 3600,
                       step_s: float = 30.0) -> None:
        """Upcoming passes over the horizon for every enabled satellite
        (ref backend pass recompute)."""
        allp: List[SatellitePass] = []
        for obj in self.enabled:
            ps = predict_passes(obj.tle, self.qth[0], self.qth[1],
                                t_start, t_start + horizon_s,
                                qth_alt_km=self.qth[2], step_s=step_s)
            allp += filter_passes_by_elevation(
                ps, obj.min_elevation, obj.max_elevation)
        self.upcoming_all = sorted(allp, key=lambda p: p.aos)
        self.upcoming_sel = self.upcoming_all if self.multi_mode \
            else select_passes_for_autotrack(self.upcoming_all)

    def _obj(self, norad: int) -> TrackedObject:
        for o in self.enabled:
            if o.norad == norad:
                return o
        raise KeyError(norad)

    def tick(self, t: float) -> None:
        """AOS/LOS edge detection at time t (ref processAutotrack)."""
        for p in self.upcoming_sel:
            if p.aos <= t < p.los and p.norad not in self._visible:
                self._visible[p.norad] = p
                logger.info(f"AOS {p.norad} (max el "
                            f"{p.max_elevation:.1f} deg)")
                self.aos_callback(p, self._obj(p.norad))
        for norad in list(self._visible):
            p = self._visible[norad]
            if t >= p.los:
                del self._visible[norad]
                logger.info(f"LOS {norad}")
                self.los_callback(p, self._obj(norad))

    def start(self, period_s: float = 0.1) -> None:
        self._run = True

        def loop():
            while self._run:
                self.tick(time.time())
                time.sleep(period_s)

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._run = False
        if self._thread:
            self._thread.join(timeout=2)
