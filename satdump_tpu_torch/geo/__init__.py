"""Geodetic / orbital and projection layer of the port (ref
src-core/common/geodetic, libs/predict, src-core/projection): TLE parsing,
SGP4 propagation, coordinate transforms and look angles, the scanline
raytracers and GCPs, map projections and reprojection (host NumPy), and
the thin-plate-spline warps, whose large evaluations run on the device
(geo/warp.py)."""

from satdump_tpu_torch.geo.geodetic import (ecef_to_lla, eci_to_ecef, gmst,
                                            lla_to_ecef,
                                            look_angles)  # noqa: F401
from satdump_tpu_torch.geo.tle import TLE  # noqa: F401
from satdump_tpu_torch.geo.sgp4 import SGP4  # noqa: F401
