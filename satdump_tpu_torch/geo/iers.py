"""IERS Earth-orientation store: polar motion, UT1-UTC, leap seconds.

The reference keeps an IERS database alongside its TLE store (ref
src-core/db/iers/iers_handler.cpp: Bulletin A pole x/y + UT1-UTC per day,
Bulletin C leap seconds, auto-updated on a schedule) and feeds it to
SuperNOVAS for earth-orientation-grade ephemeris work. This module is the
framework's equivalent:

* `IERSStore` — a file-backed per-day table of (pole_x", pole_y",
  UT1-UTC s) + the leap-second list, with parsers for BOTH distribution
  formats: the IERS `finals2000A.all` fixed-width text and the
  datacenter JSON the reference fetches, plus the NTP
  `leap-seconds.list`; `update_from_url()` wires auto-update through the
  task scheduler exactly like the TLE DB.
* `polar_motion_matrix` / `gmst_ut1` — apply the EOP data: the ECEF frame
  correction W(x_p, y_p) and sidereal time computed from true UT1.

Typical use: `eci_to_ecef(..., iers=store.get(t))` tightens geolocation
from the ~10 m scale (GMST-on-UTC + no polar motion) to the sub-meter
scale the EOP data supports.
"""

from __future__ import annotations

import bisect
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from satdump_tpu_torch.core.log import logger

ARCSEC = np.pi / (180.0 * 3600.0)
_NTP_TO_UNIX = 2208988800  # 1900-01-01 -> 1970-01-01, seconds


@dataclass
class IERSInfo:
    """ref iers_handler.h IERSInfo"""
    time: float
    pole_x: float        # arcsec
    pole_y: float        # arcsec
    ut1_utc: float       # seconds
    leap_seconds: int    # TAI-UTC


def parse_finals2000a(text: str) -> List[IERSInfo]:
    """IERS finals2000A.all fixed-width lines -> EOP entries (Bulletin A
    columns: MJD 7-15, x 18-27, y 37-46, UT1-UTC 58-68)."""
    out = []
    for line in text.splitlines():
        if len(line) < 68:
            continue
        try:
            mjd = float(line[7:15])
            x = float(line[18:27])
            y = float(line[37:46])
            dut1 = float(line[58:68])
        except ValueError:
            continue
        out.append(IERSInfo((mjd - 40587.0) * 86400.0, x, y, dut1, 0))
    return out


def parse_iers_json(text: str) -> List[IERSInfo]:
    """IERS datacenter finals2000A JSON (the reference's source,
    iers_handler.cpp:58-100): EOP.data.timeSeries[].dataEOP with
    BulletinA pole/UT entries."""
    j = json.loads(text)
    out = []
    for v in j.get("EOP", {}).get("data", {}).get("timeSeries", []):
        try:
            pole = v["dataEOP"]["pole"][0]
            if pole.get("source") != "BulletinA":
                continue
            mjd = float(v["time"]["MJD"])
            out.append(IERSInfo(
                (mjd - 40587.0) * 86400.0, float(pole["X"]),
                float(pole["Y"]),
                float(v["dataEOP"]["UT"][0]["UT1-UTC"]), 0))
        except (KeyError, IndexError, TypeError, ValueError):
            continue
    return out


def parse_leap_seconds(text: str) -> Dict[float, int]:
    """NTP leap-seconds.list (hpiers bulletin C mirror): '<ntp_time>
    <TAI-UTC>' per line -> {unix_time: leap_seconds}."""
    out: Dict[float, int] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) < 2:
            continue
        try:
            out[float(int(parts[0]) - _NTP_TO_UNIX)] = int(parts[1])
        except ValueError:
            continue
    return out


class IERSStore:
    """File-backed EOP + leap-second store (ref IersDBHandler, minus
    sqlite: a sorted JSON table is plenty for per-day data)."""

    def __init__(self, path: Optional[str] = None):
        self.path = Path(path) if path else None
        self._times: List[float] = []
        self._eop: List[IERSInfo] = []
        self._leaps: Dict[float, int] = {}
        if self.path and self.path.exists():
            self._load()

    # -- persistence --------------------------------------------------------
    def _load(self) -> None:
        j = json.loads(self.path.read_text())
        self._eop = [IERSInfo(*e) for e in j.get("eop", [])]
        self._eop.sort(key=lambda e: e.time)
        self._times = [e.time for e in self._eop]
        self._leaps = {float(k): int(v)
                       for k, v in j.get("leap_seconds", {}).items()}

    def save(self) -> None:
        if not self.path:
            return
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps({
            "eop": [[e.time, e.pole_x, e.pole_y, e.ut1_utc, 0]
                    for e in self._eop],
            "leap_seconds": {str(k): v for k, v in self._leaps.items()},
        }))

    # -- ingestion ----------------------------------------------------------
    def add_eop(self, entries: List[IERSInfo]) -> int:
        by_t = {e.time: e for e in self._eop}
        for e in entries:
            by_t[e.time] = e
        self._eop = sorted(by_t.values(), key=lambda e: e.time)
        self._times = [e.time for e in self._eop]
        return len(entries)

    def add_leap_seconds(self, table: Dict[float, int]) -> None:
        self._leaps.update(table)

    def update_from_text(self, text: str) -> int:
        """Auto-detect the payload format (JSON vs fixed-width finals vs
        leap-seconds list) and ingest it."""
        t = text.lstrip()
        if t.startswith("{"):
            n = self.add_eop(parse_iers_json(text))
        else:
            eop = parse_finals2000a(text)
            if eop:
                n = self.add_eop(eop)
            else:
                ls = parse_leap_seconds(text)
                self.add_leap_seconds(ls)
                n = len(ls)
        self.save()
        return n

    def update_from_url(self, url: str) -> int:
        """Fetch + ingest (the reference's updateIERS); schedule through
        core.tasks like the TLE auto-update."""
        import urllib.request
        with urllib.request.urlopen(url, timeout=30) as r:
            return self.update_from_text(r.read().decode())

    # -- queries ------------------------------------------------------------
    def get(self, t_unix: float) -> Optional[IERSInfo]:
        """Best EOP entry for a time (nearest preceding day; ref
        getBestIERSInfo), with the applicable leap-second count."""
        if not self._eop:
            return None
        i = bisect.bisect_right(self._times, float(t_unix)) - 1
        i = max(min(i, len(self._eop) - 1), 0)
        e = self._eop[i]
        leaps = 0
        for lt in sorted(self._leaps):
            if lt <= t_unix:
                leaps = self._leaps[lt]
        return IERSInfo(e.time, e.pole_x, e.pole_y, e.ut1_utc, leaps)


IERS_EOP_URL = ("https://datacenter.iers.org/products/eop/rapid/standard/"
                "json/finals2000A.all.json")
LEAP_SECONDS_URL = "https://hpiers.obspm.fr/iers/bul/bulc/ntp/leap-seconds.list"


class AutoUpdateIersEvent:
    """Fired by the task scheduler to refresh the store (ref
    iers_handler.cpp AutoUpdateIersEvent, interval 60 h)."""


def schedule_auto_update(store: IERSStore, interval_s: float = 3600 * 60,
                         urls=(IERS_EOP_URL, LEAP_SECONDS_URL)) -> None:
    """Wire the store into the framework scheduler the way the reference
    wires IersDBHandler (iers_handler.cpp:45-53)."""
    from satdump_tpu_torch.core.events import event_bus
    from satdump_tpu_torch.core.tasks import task_scheduler

    def on_update(_ev) -> None:
        for u in urls:
            try:
                n = store.update_from_url(u)
                logger.info(f"IERS update from {u}: {n} entries")
            except Exception as e:
                logger.error(f"IERS update failed ({u}): {e}")

    event_bus.register_handler(AutoUpdateIersEvent, on_update)
    task_scheduler.add_task("auto_iers_update", AutoUpdateIersEvent,
                            interval_s, run_at_startup=False)


def polar_motion_matrix(info: IERSInfo) -> np.ndarray:
    """W(x_p, y_p): rotation from the IERS terrestrial frame to the frame
    of the instantaneous pole (small-angle form, sub-µas accurate for the
    <1" polar motion range)."""
    xp = info.pole_x * ARCSEC
    yp = info.pole_y * ARCSEC
    return np.array([[1.0, 0.0, xp],
                     [0.0, 1.0, -yp],
                     [-xp, yp, 1.0]])


def gmst_ut1(t_unix: float, info: Optional[IERSInfo]) -> np.ndarray:
    """GMST evaluated on true UT1 = UTC + (UT1-UTC) when EOP data is
    available (the dUT1 term is worth up to ±0.9 s of earth rotation =
    ±420 m at the equator)."""
    from satdump_tpu_torch.geo.geodetic import gmst, unix_to_jd
    dut1 = info.ut1_utc if info else 0.0
    return gmst(unix_to_jd(np.asarray(t_unix, np.float64) + dut1))


# Truncated IAU 2000B nutation: the 13 largest luni-solar terms (of 77),
# good to ~1 mas in dPsi/dEps — ample for imaging geolocation (the
# reference reaches full precision through SuperNOVAS' iau2000b tables).
# Columns: multipliers of (l, l', F, D, Om) then dPsi sin/cos and
# dEps cos/sin coefficients in 0.1 µas (IAU SOFA nut00b convention).
_NUT_TERMS = np.array([
    #  l   l'  F   D   Om      ps        pst       pc      ec       ect      es
    [0,  0,  0,  0,  1, -172064161.0, -174666.0, 33386.0, 92052331.0, 9086.0, 15377.0],
    [0,  0,  2, -2,  2,  -13170906.0,   -1675.0, -13696.0, 5730336.0, -3015.0, -4587.0],
    [0,  0,  2,  0,  2,   -2276413.0,    -234.0,  2796.0,  978459.0,  -485.0,  1374.0],
    [0,  0,  0,  0,  2,    2074554.0,     207.0,  -698.0, -897492.0,   470.0,  -291.0],
    [0,  1,  0,  0,  0,    1475877.0,   -3633.0, 11817.0,   73871.0,  -184.0, -1924.0],
    [0,  1,  2, -2,  2,    -516821.0,    1226.0,  -524.0,  224386.0,  -677.0,  -174.0],
    [1,  0,  0,  0,  0,     711159.0,      73.0,  -872.0,   -6750.0,     0.0,   358.0],
    [0,  0,  2,  0,  1,    -387298.0,    -367.0,   380.0,  200728.0,    18.0,   318.0],
    [1,  0,  2,  0,  2,    -301461.0,     -36.0,   816.0,  129025.0,   -63.0,   367.0],
    [0, -1,  2, -2,  2,     215829.0,    -494.0,   111.0,  -95929.0,   299.0,   132.0],
    [0,  0,  2, -2,  1,     128227.0,     137.0,   181.0,  -68982.0,    -9.0,    39.0],
    [-1, 0,  2,  0,  2,     123457.0,      11.0,    19.0,  -53311.0,    32.0,    -4.0],
    [-1, 0,  0,  2,  0,     156994.0,      10.0,  -168.0,   -1235.0,     0.0,    82.0],
], np.float64)


def nutation_iau2000b(t_unix) -> tuple:
    """(dPsi, dEps) in radians — truncated IAU 2000B series (see
    _NUT_TERMS). Vectorized over time."""
    t = (np.asarray(t_unix, np.float64) / 86400.0 + 2440587.5
         - 2451545.0) / 36525.0
    # Delaunay arguments, arcsec (IAU 2000B / SOFA nut00b)
    l = 485868.249036 + 1717915923.2178 * t
    lp = 1287104.79305 + 129596581.0481 * t
    F = 335779.526232 + 1739527262.8478 * t
    D = 1072260.70369 + 1602961601.2090 * t
    Om = 450160.398036 - 6962890.5431 * t
    args = np.stack([l, lp, F, D, Om], axis=-1) * ARCSEC  # (..., 5)
    m = _NUT_TERMS[:, :5]                                # (T, 5)
    ph = np.tensordot(args, m.T, axes=1)                 # (..., T)
    ps, pst, pc = _NUT_TERMS[:, 5], _NUT_TERMS[:, 6], _NUT_TERMS[:, 7]
    ec, ect, es = _NUT_TERMS[:, 8], _NUT_TERMS[:, 9], _NUT_TERMS[:, 10]
    t_ = np.asarray(t)[..., None]
    dpsi = np.sum((ps + pst * t_) * np.sin(ph) + pc * np.cos(ph), axis=-1)
    deps = np.sum((ec + ect * t_) * np.cos(ph) + es * np.sin(ph), axis=-1)
    u = 1e-7 * ARCSEC   # table unit: 0.1 µas
    return dpsi * u, deps * u


def mean_obliquity(t_unix) -> np.ndarray:
    t = (np.asarray(t_unix, np.float64) / 86400.0 + 2440587.5
         - 2451545.0) / 36525.0
    eps = 84381.406 - 46.836769 * t - 0.0001831 * t * t
    return eps * ARCSEC


def gast(t_unix: float, info: Optional[IERSInfo] = None) -> np.ndarray:
    """Greenwich APPARENT sidereal time: GMST(UT1) + the equation of the
    equinoxes dPsi·cos(eps) — the rotation SuperNOVAS applies via its full
    nutation model (here the truncated 2000B series, ~1 mas)."""
    dpsi, _ = nutation_iau2000b(t_unix)
    return gmst_ut1(t_unix, info) + dpsi * np.cos(mean_obliquity(t_unix))


def eci_to_ecef_iers(r_eci: np.ndarray, t_unix,
                     info: Optional[IERSInfo]) -> np.ndarray:
    """eci_to_ecef upgraded with UT1 sidereal time + polar motion."""
    th = gmst_ut1(t_unix, info)
    c, s = np.cos(th), np.sin(th)
    x = c * r_eci[..., 0] + s * r_eci[..., 1]
    y = -s * r_eci[..., 0] + c * r_eci[..., 1]
    r = np.stack([x, y, np.broadcast_to(r_eci[..., 2], np.shape(x))],
                 axis=-1)
    if info is not None:
        r = r @ polar_motion_matrix(info).T
    return r
