"""TLE parsing + registry (ref src-core/common/tracking/tle.{h,cpp} and the
Kepler DB, src-core/db/kepler/kepler_handler.h — here a JSON/file-backed
store; network auto-update is host-side and optional).

A copy of satdump_tpu/geo/tle.py, its imports rewritten to the port.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional


def _tle_float(field: str) -> float:
    """Parse TLE exponent notation: ' 12345-4' -> 0.12345e-4."""
    field = field.strip()
    if not field:
        return 0.0
    sign = -1.0 if field[0] == "-" else 1.0
    if field[0] in "+-":
        field = field[1:]
    if "-" in field[1:] or "+" in field[1:]:
        for i in range(len(field) - 1, 0, -1):
            if field[i] in "+-":
                mant, exp = field[:i], field[i:]
                return sign * float("0." + mant.strip()) * 10.0 ** int(exp)
    return sign * float(field)


@dataclass
class TLE:
    name: str
    norad: int
    line1: str
    line2: str
    # parsed elements
    epoch_year: int = 0
    epoch_day: float = 0.0
    epoch_unix: float = 0.0
    bstar: float = 0.0
    inclination: float = 0.0      # deg
    raan: float = 0.0             # deg
    eccentricity: float = 0.0
    arg_perigee: float = 0.0      # deg
    mean_anomaly: float = 0.0     # deg
    mean_motion: float = 0.0      # rev/day
    ndot: float = 0.0

    @classmethod
    def parse(cls, name: str, line1: str, line2: str) -> "TLE":
        t = cls(name=name.strip(), norad=int(line1[2:7]), line1=line1,
                line2=line2)
        yy = int(line1[18:20])
        t.epoch_year = yy + (2000 if yy < 57 else 1900)
        t.epoch_day = float(line1[20:32])
        # unix epoch of TLE
        import calendar
        import time as _t
        ystart = calendar.timegm((t.epoch_year, 1, 1, 0, 0, 0))
        t.epoch_unix = ystart + (t.epoch_day - 1.0) * 86400.0
        t.ndot = float(line1[33:43])
        t.bstar = _tle_float(line1[53:61])
        t.inclination = float(line2[8:16])
        t.raan = float(line2[17:25])
        t.eccentricity = float("0." + line2[26:33].strip())
        t.arg_perigee = float(line2[34:42])
        t.mean_anomaly = float(line2[43:51])
        t.mean_motion = float(line2[52:63])
        return t

    def to_json(self) -> dict:
        return {"name": self.name, "norad": self.norad,
                "line1": self.line1, "line2": self.line2}

    @classmethod
    def from_json(cls, j: dict) -> "TLE":
        return cls.parse(j["name"], j["line1"], j["line2"])


def parse_tle_file(path: str | Path) -> List[TLE]:
    """3-line-element file -> TLEs."""
    lines = [l.rstrip("\n") for l in Path(path).read_text().splitlines()
             if l.strip()]
    out: List[TLE] = []
    i = 0
    while i + 1 < len(lines):
        if lines[i].startswith("1 ") and i + 1 < len(lines) \
                and lines[i + 1].startswith("2 "):
            out.append(TLE.parse(f"NORAD {lines[i][2:7]}", lines[i], lines[i + 1]))
            i += 2
        elif i + 2 < len(lines) and lines[i + 1].startswith("1 ") \
                and lines[i + 2].startswith("2 "):
            out.append(TLE.parse(lines[i], lines[i + 1], lines[i + 2]))
            i += 3
        else:
            i += 1
    return out


def update_tles_from_source(registry: "TLERegistry", source: str) -> int:
    """Refresh the registry from a TLE source (ref kepler_handler.h's
    network auto-update). `source` is a local path, a file:// URL, or an
    http(s) URL (fetched with urllib when egress exists; callers on
    air-gapped hosts point at a mirrored file). Returns TLEs updated."""
    text: str
    if source.startswith(("http://", "https://", "file://")):
        import urllib.request
        with urllib.request.urlopen(source, timeout=30) as r:
            text = r.read().decode()
    else:
        from pathlib import Path as _P
        text = _P(source).read_text()
    lines = [ln.rstrip() for ln in text.splitlines() if ln.strip()]
    n = 0
    i = 0
    while i + 2 < len(lines) + 1:
        if i + 2 < len(lines) and lines[i + 1].startswith("1 ") \
                and lines[i + 2].startswith("2 "):
            registry.add(TLE.parse(lines[i].strip(), lines[i + 1],
                                   lines[i + 2]))
            n += 1
            i += 3
        elif lines[i].startswith("1 ") and i + 1 < len(lines) \
                and lines[i + 1].startswith("2 "):
            registry.add(TLE.parse("", lines[i], lines[i + 1]))
            n += 1
            i += 2
        else:
            i += 1
    if registry.path:
        registry.save()
    return n


class TLERegistry:
    """NORAD -> TLE store, JSON-file persisted (the Kepler DB analogue)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._by_norad: Dict[int, TLE] = {}
        if path and Path(path).exists():
            for j in json.loads(Path(path).read_text()):
                t = TLE.from_json(j)
                self._by_norad[t.norad] = t

    def add(self, tle: TLE) -> None:
        self._by_norad[tle.norad] = tle

    def get(self, norad: int) -> Optional[TLE]:
        return self._by_norad.get(norad)

    def save(self) -> None:
        if self.path:
            Path(self.path).write_text(json.dumps(
                [t.to_json() for t in self._by_norad.values()], indent=1))
