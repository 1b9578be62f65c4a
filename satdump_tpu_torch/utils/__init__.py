"""Helpers: device selection, state conversion."""
