"""Product base + registry (ref src-core/products/product.h:33-100).

A Product is a JSON `contents` blob (saved as product.json — the reference
uses CBOR via nlohmann; JSON keeps the same schema and stays dependency-free;
a CBOR reader can be added for interop later) plus typed accessors. Products
are saved one-per-directory with sibling data files (images etc.), grouped by
a DataSet (ref products/dataset.h).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

from satdump_tpu_torch.core.exceptions import SatdumpError


class Product:
    type: str = "product"

    def __init__(self):
        self.contents: dict = {}
        self.instrument_name: str = ""

    # -- optional metadata (product.h:50-100) --------------------------------
    def set_product_timestamp(self, ts: float) -> None:
        self.contents["product_timestamp"] = float(ts)

    def has_product_timestamp(self) -> bool:
        return "product_timestamp" in self.contents

    def get_product_timestamp(self) -> float:
        return float(self.contents["product_timestamp"])

    def set_product_source(self, source: str) -> None:
        self.contents["product_source"] = source

    def has_product_source(self) -> bool:
        return "product_source" in self.contents

    def get_product_source(self) -> str:
        return self.contents["product_source"]

    def set_product_id(self, pid: str) -> None:
        self.contents["product_id"] = pid

    # -- persistence ----------------------------------------------------------
    def _meta(self) -> dict:
        return {
            "instrument": self.instrument_name,
            "type": self.type,
            "contents": self.contents,
        }

    def save(self, directory: str, cbor: bool = True) -> str:
        """Save the product. CBOR is the reference byte format (nlohmann
        to_cbor, products/product.cpp saveProduct) and is written by DEFAULT
        on the main path; a product.json twin is always written too for
        inspectability (load_product prefers the CBOR)."""
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        jpath = d / "product.json"
        with open(jpath, "w") as f:
            json.dump(self._meta(), f, indent=2)
        if cbor:
            from satdump_tpu_torch.utils import cbor as _cbor
            path = d / "product.cbor"
            path.write_bytes(_cbor.encode(self._meta()))
            return str(path)
        return str(jpath)

    def load(self, file: str) -> None:
        meta = _read_meta(file)
        self.instrument_name = meta.get("instrument", "")
        self.contents = meta.get("contents", {})
        self._load_extra(Path(file).parent, meta)

    def _load_extra(self, directory: Path, meta: dict) -> None:
        pass


# registry: type string -> loader (ref PRODUCT_LOADER_FUN product.h:10)
product_loaders: Dict[str, Callable[[str], Product]] = {}


def register_product(cls):
    def _loader(file: str) -> Product:
        p = cls()
        p.load(file)
        return p
    product_loaders[cls.type] = _loader
    return cls


def _read_meta(file: str) -> dict:
    if str(file).endswith(".cbor"):
        from satdump_tpu_torch.utils import cbor as _cbor
        return _cbor.decode(Path(file).read_bytes())
    with open(file) as f:
        return json.load(f)


def load_product(file: str) -> Product:
    """Load any product by its saved type id (ref products::loadProduct);
    accepts product.json or the reference's product.cbor."""
    p = Path(file)
    if p.is_dir():
        file = str(p / ("product.cbor" if (p / "product.cbor").exists()
                        else "product.json"))
    meta = _read_meta(file)
    t = meta.get("type", "product")
    if t not in product_loaders:
        raise SatdumpError(f"no loader for product type '{t}'")
    return product_loaders[t](file)


register_product(Product)


class DataSet:
    """dataset.json — satellite name, timestamp, product dirs
    (ref products/dataset.h; written by instrument modules)."""

    def __init__(self, satellite_name: str = "", timestamp: float = -1.0):
        self.satellite_name = satellite_name
        self.timestamp = timestamp
        self.products_list: List[str] = []

    def save(self, directory: str) -> str:
        d = Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        path = d / "dataset.json"
        with open(path, "w") as f:
            json.dump({
                "satellite": self.satellite_name,
                "timestamp": self.timestamp,
                "products": self.products_list,
            }, f, indent=4)
        return str(path)

    @classmethod
    def load(cls, file: str) -> "DataSet":
        with open(file) as f:
            j = json.load(f)
        ds = cls(j.get("satellite", ""), j.get("timestamp", -1.0))
        ds.products_list = list(j.get("products", []))
        return ds
