"""The median of the CADU latencies that `cadu_p95_ms` reads: a steadier
view of the same wait."""

import numpy as np


def read(rec):
    lat = rec.get("latencies_ms")
    return float(np.median(lat)) if lat else None
