"""95th percentile over the due CADUs of the window of each one's latency:
from the start of the `push` that handed over its last sample to the return
of the `push` after which the decoder had written it."""

import numpy as np


def read(rec):
    lat = rec.get("latencies_ms")
    return float(np.percentile(lat, 95)) if lat else None
