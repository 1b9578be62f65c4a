"""Input-file header autodetect.

Reference: src-core/common/detect_header.cpp — inspect WAV/ZIQ magic to
recover samplerate and sample format, and infer the format from the
extension otherwise (used by the CLI before running a pipeline)."""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path
from typing import Optional


@dataclass
class HeaderInfo:
    valid: bool = False
    samplerate: float = 0.0
    fmt: str = ""


def try_parse_header(path: str) -> HeaderInfo:
    p = Path(path)
    try:
        head = p.open("rb").read(64)
    except OSError:
        return HeaderInfo()
    # WAV (common/wav.h): RIFF....WAVE, fmt chunk -> rate + bits + format
    if head[:4] == b"RIFF" and head[8:12] == b"WAVE":
        audio_fmt, channels, rate = struct.unpack_from("<HHI", head, 20)
        bits = struct.unpack_from("<H", head, 34)[0]
        fmt = ""
        if audio_fmt == 1 and bits == 8:
            fmt = "cu8"
        elif audio_fmt == 1 and bits == 16:
            fmt = "cs16"
        elif audio_fmt in (1, 3) and bits == 32:
            fmt = "cf32"
        return HeaderInfo(True, float(rate), fmt)
    # ZIQ2 (common/ziq2.cpp magic: signature + synced INFO packet)
    if head[:4] == b"ZIQ2":
        try:
            rate = struct.unpack_from("<Q", head, 13)[0]
            return HeaderInfo(True, float(rate), "ziq2")
        except Exception:
            return HeaderInfo(True, 0.0, "ziq2")
    # ZIQ (common/ziq.cpp magic)
    if head[:4] == b"ZIQ_":
        try:
            rate = struct.unpack_from("<Q", head, 6)[0]
            return HeaderInfo(True, float(rate), "ziq")
        except Exception:
            return HeaderInfo(True, 0.0, "ziq")
    # extension fallback (detect_header.cpp tail)
    ext = p.suffix.lower().lstrip(".")
    if ext in ("cf32", "f32", "cs16", "s16", "cs8", "s8", "cu8", "u8",
               "wav", "ziq"):
        m = {"f32": "cf32", "s16": "cs16", "s8": "cs8", "u8": "cu8"}
        return HeaderInfo(True, 0.0, m.get(ext, ext))
    return HeaderInfo()


def apply_header_params(parameters: dict, input_file: str) -> dict:
    """Fill samplerate/baseband_format from the file header when absent
    (ref try_get_params_from_input_file)."""
    info = try_parse_header(input_file)
    if info.valid:
        if info.samplerate and not parameters.get("samplerate"):
            parameters["samplerate"] = info.samplerate
        if info.fmt and not parameters.get("baseband_format"):
            parameters["baseband_format"] = info.fmt
    return parameters
