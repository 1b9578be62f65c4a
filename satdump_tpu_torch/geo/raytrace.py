"""Projection settings of the scanline raytracers.

Only `load_proj_settings` is carried here: the instrument modules attach
these settings to their products. The raytracing itself (SGP4, the
ellipsoid intersection, GCPs) comes with the geo slice.
"""

from __future__ import annotations

import json
from pathlib import Path

RESOURCES = Path(__file__).resolve().parent.parent.parent / "resources"


def load_proj_settings(name: str, **overrides) -> dict:
    """Load a projection-settings resource
    (resources/projections_settings/<name>.json — the reference's
    satellite-raytracer cfg files, src-core resources::getResourcePath
    usage across the instrument modules). Overrides merge on top (norad,
    timestamps, tle get attached by the caller)."""
    p = RESOURCES / "projections_settings" / f"{name}.json"
    cfg = json.loads(p.read_text())
    cfg.update(overrides)
    return cfg
