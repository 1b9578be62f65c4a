"""Geodetic / orbital layer of the port (ref src-core/common/geodetic +
libs/predict): TLE parsing, SGP4 propagation, coordinate transforms and
look angles on the host (NumPy), and the projection settings
(geo/raytrace.py::load_proj_settings)."""

from satdump_tpu_torch.geo.geodetic import (ecef_to_lla, eci_to_ecef, gmst,
                                            lla_to_ecef,
                                            look_angles)  # noqa: F401
from satdump_tpu_torch.geo.tle import TLE  # noqa: F401
from satdump_tpu_torch.geo.sgp4 import SGP4  # noqa: F401
