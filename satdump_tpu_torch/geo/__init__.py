"""Geodetic layer of the port: only the projection settings so far
(geo/raytrace.py::load_proj_settings)."""
