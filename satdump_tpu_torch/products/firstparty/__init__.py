"""Firstparty data ingest: official-agency L1 archive files -> products.

The reference ships a `firstparty_support` plugin that turns officially
distributed level-1 files (EUMETSAT .nat, Himawari HSD, netCDF-4, HDF5)
into the same ImageProduct the live decode chains emit, so composites /
projection / calibration all apply uniformly (ref plugins/
firstparty_support/main_loader.cpp:20-93 extension dispatch). This package
is the port's counterpart: pure-NumPy/h5py parsers feeding the same
product pipeline (NetCDF and HDF5 need h5py; without it they raise).

    from satdump_tpu_torch.products.firstparty import ingest_file
    prod = ingest_file("MSG4-SEVI-MSG15-....nat")
    prod.save("out/seviri")

Multi-segment inputs (Himawari HSD) can be ingested as a group via
`ingest_files([...])`.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence

from satdump_tpu_torch.products.product import Product

from . import hdf_nc, hsd_ahi, nat_seviri  # noqa: F401 (calibrator reg.)


def _sniff(path: Path) -> str:
    head = path.read_bytes()[:8192] if path.stat().st_size <= 8192 else None
    if head is None:
        with open(path, "rb") as f:
            head = f.read(8192)
    if head[:8] == hdf_nc.HDF5_MAGIC:
        return "hdf5"
    if head[:3] == b"BZh" or ".DAT" in path.name.upper() \
            and "HS_" in path.name.upper():
        return "hsd"
    if path.suffix.lower() == ".nat" or nat_seviri.is_seviri_nat(head):
        return "nat"
    if path.suffix.lower() in (".nc", ".h5", ".hdf", ".hdf5"):
        return "hdf5"
    raise ValueError(f"unrecognized firstparty format: {path.name}")


def ingest_files(paths: Sequence[str]) -> List[Product]:
    """Ingest a group of files; same-instrument segments merge."""
    products: List[Product] = []
    hsd_acc: Optional[hsd_ahi.AhiHsdAccumulator] = None
    for sp in paths:
        path = Path(sp)
        kind = _sniff(path)
        if kind == "hsd":
            if hsd_acc is None:
                hsd_acc = hsd_ahi.AhiHsdAccumulator()
            hsd_acc.add_file(path.read_bytes())
        elif kind == "nat":
            p = nat_seviri.parse_seviri_nat(path.read_bytes())
            if p is not None:
                products.append(p)
        else:
            p = hdf_nc.parse_hdf5_file(path)
            if p is not None:
                products.append(p)
    if hsd_acc is not None and hsd_acc.channels:
        products.append(hsd_acc.to_product())
    return hdf_nc.merge_abi_products(products)


def ingest_file(path: str) -> Optional[Product]:
    prods = ingest_files([path])
    return prods[0] if prods else None
