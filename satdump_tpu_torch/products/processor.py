"""Product (auto)processing: saved products -> composites.

Behavioral equivalent of products/product_process.cpp:13-59 + the headless
half of handlers/product/image_product_handler.h: for each preset in the
instrument's config (resources/instrument_cfgs/<instrument>.json) with
``"autogen": true``, evaluate the composite expression over the channels,
apply the post ops (equalize / white balance / invert / despeckle), and save
the PNG. A ``preset_cache`` marker skips presets already rendered (ref
product_process.cpp:33-51 — re-processing is incremental).

Composites and post ops run on `device` (default ``cuda``). As in the
reference, a preset that fails is logged and skipped; a fault of the device
itself (utils/device.py::is_device_fault) is raised instead.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional

import torch

from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.image import processing
from satdump_tpu_torch.image.expression import generate_composite
from satdump_tpu_torch.image.io import save_img
from satdump_tpu_torch.products.image_product import ImageProduct
from satdump_tpu_torch.products.product import DataSet, load_product
from satdump_tpu_torch.utils.device import is_device_fault, resolve_device


def _instrument_cfg_path(instrument: str) -> Optional[Path]:
    root = Path(__file__).resolve().parent.parent.parent / "resources" / "instrument_cfgs"
    p = root / f"{instrument}.json"
    return p if p.exists() else None


def load_instrument_cfg(instrument: str) -> dict:
    p = _instrument_cfg_path(instrument)
    if p is None:
        return {}
    with open(p) as f:
        return json.load(f)


def process_image_product(product: ImageProduct, out_dir: str,
                          presets: Optional[List[str]] = None,
                          device: str | torch.device | None = None
                          ) -> List[str]:
    """Render instrument-cfg presets for one ImageProduct on `device`.
    Returns the list of files written."""
    dev = resolve_device(device)
    channels: dict = {}      # normalized channels, kept on the device
    cfg = load_instrument_cfg(product.instrument_name)
    all_presets = cfg.get("presets", {})
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    cache_file = out / ".preset_cache.json"
    cache = {}
    if cache_file.exists():
        with open(cache_file) as f:
            cache = json.load(f)

    written: List[str] = []
    for name, preset in all_presets.items():
        if presets is not None and name not in presets:
            continue
        if presets is None and not preset.get("autogen", False):
            continue
        if cache.get(name):
            logger.debug(f"preset '{name}' cached, skipping")
            continue
        expr = preset.get("expression")
        if not expr:
            continue
        try:
            img = generate_composite(product, expr, bit_depth=8,
                                     device=dev, cache=channels)
        except Exception as e:
            if is_device_fault(e):
                raise
            logger.warning(f"preset '{name}' failed: {e}")
            continue
        if preset.get("equalize"):
            img = processing.equalize(img, device=dev)
        if preset.get("individual_equalize"):
            img = processing.equalize(img, per_channel=True, device=dev)
        if preset.get("white_balance"):
            img = processing.white_balance(img, device=dev)
        if preset.get("invert"):
            img = processing.linear_invert(img, device=dev)
        if preset.get("normalize"):
            img = processing.normalize(img, device=dev)
        if preset.get("despeckle"):
            img = processing.despeckle(img, device=dev)
        fname = out / f"{product.instrument_name}_{name}.png"
        save_img(img, fname)
        written.append(str(fname))
        cache[name] = True
        logger.info(f"composite '{name}' -> {fname}")

    with open(cache_file, "w") as f:
        json.dump(cache, f)
    return written


def process_path(input_path: str, output_dir: Optional[str] = None,
                 device: str | torch.device | None = None) -> List[str]:
    """Process a product.json, a product directory, or a dataset.json on
    `device` (default ``cuda``). Returns files written."""
    dev = resolve_device(device)
    p = Path(input_path)
    if p.is_dir():
        if (p / "dataset.json").exists():
            p = p / "dataset.json"
        elif (p / "product.json").exists():
            p = p / "product.json"
        else:
            raise FileNotFoundError(f"no dataset.json/product.json in {p}")

    written: List[str] = []
    if p.name == "dataset.json":
        ds = DataSet.load(str(p))
        for rel in ds.products_list:
            pdir = p.parent / rel
            pj = pdir / "product.json"
            if not pj.exists():
                logger.warning(f"dataset entry missing: {pj}")
                continue
            prod = load_product(str(pj))
            if isinstance(prod, ImageProduct):
                written += process_image_product(
                    prod, output_dir or str(pdir), device=dev)
    else:
        prod = load_product(str(p))
        if isinstance(prod, ImageProduct):
            written += process_image_product(
                prod, output_dir or str(p.parent), device=dev)
    return written
