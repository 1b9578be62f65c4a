"""Measurement scripts for the card, run as modules (``python3 -m``)."""
