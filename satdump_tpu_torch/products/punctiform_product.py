"""Punctiform (point-sample) products: sounder/text/telemetry data tied to
timestamps and geodetic positions rather than a raster.

Reference: src-core/products/punctiform_product.h — per-channel DataHolder
{channel_name, timestamps, positions, data}, TLE storage, position lookup.
Used by the non-imagery missions (Inmarsat STD-C/Aero, sounders, A.5).

Counterpart of satdump_tpu/products/punctiform_product.py (copied)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from satdump_tpu_torch.core.exceptions import SatdumpError
from satdump_tpu_torch.products.product import Product, register_product


@dataclass
class DataHolder:
    channel_name: str = ""
    timestamps: List[float] = field(default_factory=list)
    positions: List[List[float]] = field(default_factory=list)  # lat,lon,alt
    data: List[float] = field(default_factory=list)


@register_product
class PunctiformProduct(Product):
    type = "punctiform"

    def __init__(self):
        super().__init__()
        self.data: List[DataHolder] = []

    def add_channel(self, name: str, timestamps, positions, data) -> None:
        self.data.append(DataHolder(
            channel_name=name,
            timestamps=list(np.asarray(timestamps, np.float64)),
            positions=[list(map(float, p)) for p in positions],
            data=list(np.asarray(data, np.float64))))

    def get_channel_index(self, name: str) -> int:
        for i, d in enumerate(self.data):
            if d.channel_name == name:
                return i
        raise SatdumpError(f"invalid punctiform channel '{name}'")

    def get_sample_position(self, ch: int, i: int) -> List[float]:
        return self.data[ch].positions[i]

    def set_tle(self, tle_json: dict) -> None:
        self.contents["tle"] = tle_json

    def has_tle(self) -> bool:
        return "tle" in self.contents

    # -- persistence ----------------------------------------------------------
    def _meta(self) -> dict:
        m = super()._meta()
        m["data"] = [{
            "channel_name": d.channel_name,
            "timestamps": d.timestamps,
            "positions": d.positions,
            "data": d.data,
        } for d in self.data]
        return m

    def _load_extra(self, directory, meta: dict) -> None:
        self.data = [DataHolder(
            channel_name=d.get("channel_name", ""),
            timestamps=d.get("timestamps", []),
            positions=d.get("positions", []),
            data=d.get("data", [])) for d in meta.get("data", [])]
