"""Physical-unit notation: parse "1.7 GHz" / "137.1M"-style strings and
format values back with SI prefixes.

Behavioral equivalent of src-core/utils/unit_parser.{h,cpp} (longest-
suffix-first matching, value scaled to the SI base) and
common/dsp_source_sink/format_notated.cpp (prefix selection by decade,
with the no-units variant switching prefixes a decade later so plain
sample counts read naturally).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

UNIT_HERTZ: List[Tuple[str, float]] = [
    ("THz", 1e12), ("GHz", 1e9), ("MHz", 1e6), ("kHz", 1e3), ("hHz", 1e2),
    ("daHz", 1e1), ("Hz", 1.0), ("dHz", 1e-1), ("cHz", 1e-2), ("mHz", 1e-3),
    ("uHz", 1e-6), ("nHz", 1e-9), ("pHz", 1e-12),
]

UNIT_METER: List[Tuple[str, float]] = [
    ("Tm", 1e12), ("Gm", 1e9), ("Mm", 1e6), ("km", 1e3), ("hm", 1e2),
    ("dam", 1e1), ("m", 1.0), ("dm", 1e-1), ("cm", 1e-2), ("mm", 1e-3),
    ("um", 1e-6), ("nm", 1e-9), ("pm", 1e-12),
]

# bare-prefix shorthand ("1.7G", "137M", "401k") common on CLI flags
_BARE = [("T", 1e12), ("G", 1e9), ("M", 1e6), ("k", 1e3), ("K", 1e3)]


def parse_unit(s: str, unit: List[Tuple[str, float]] = UNIT_HERTZ
               ) -> Optional[float]:
    """Parse a notated value down to its SI base; None if unparseable
    (unit_parser.cpp:7-23 matches the longest unit name found anywhere
    in the string and scales the remaining number)."""
    s = s.strip()
    for name, scale in sorted(unit, key=lambda u: -len(u[0])):
        if name in s:
            try:
                return float(s.replace(name, "").strip()) * scale
            except ValueError:
                return None
    for name, scale in _BARE:
        if s.endswith(name):
            try:
                return float(s[: -len(name)].strip()) * scale
            except ValueError:
                return None
    try:
        return float(s)
    except ValueError:
        return None


def parse_frequency(s: str) -> Optional[float]:
    """Frequency in Hz from "1701.3 MHz", "1.7G", "137912500", ..."""
    return parse_unit(s, UNIT_HERTZ)


def format_notated(val: float, units: str = "", num_decimals: int = -1,
                   can_go_below_one: bool = True) -> str:
    """Human display with SI prefix (format_notated.cpp:9-77). With no
    units the k/M/G switch points move up a decade (1e7/1e10) so e.g.
    sample counts show as "9000000" -> "9000k"-style only later."""
    no_units = units == ""
    sp = "" if no_units else " "
    a = abs(val)
    if a < 1e-6 and can_go_below_one:
        d, suf = val / 1e-9, sp + "n" + units
    elif a < 1e-3 and can_go_below_one:
        d, suf = val / 1e-6, sp + "u" + units
    elif a < 1.0 and can_go_below_one:
        d, suf = val / 1e-3, sp + "m" + units
    elif a < 1e3:
        d, suf = float(val), " " + units
    elif a < (1e7 if no_units else 1e6):
        d, suf = val / 1e3, sp + "k" + units
    elif a < (1e10 if no_units else 1e9):
        d, suf = val / 1e6, sp + "M" + units
    elif a < 1e12:
        d, suf = val / 1e9, sp + "G" + units
    else:
        d, suf = val / 1e12, sp + "T" + units
    if num_decimals < 0:
        txt = f"{d:g}"
    else:
        txt = f"{d:.{num_decimals}f}"
    return (txt + suf).rstrip()
