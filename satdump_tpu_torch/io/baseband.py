"""Baseband (raw IQ) file IO for all reference formats.

Formats and normalization conventions match the reference exactly
(src-core/common/dsp/io/baseband_interface.h:170-199, baseband_type.h):

  cf32   complex float32 interleaved, as-is
  cs32   int32  IQ, scaled by 1/2147483647
  cs16   int16  IQ, scaled by 1/32767    (also wav16 payload)
  cs8    int8   IQ, scaled by 1/127
  cu8    uint8  IQ, (x - 127) / 127
  wav16  RIFF WAV header + cs16 payload (SDR recordings)

Unlike the reference's streaming per-8192-sample reads, the TPU design reads
large fixed-size blocks (default 2**20 samples) ready to be shipped to the
device; the last block is zero-padded and carries a valid-sample count.
"""

from __future__ import annotations

import os
import struct
import wave
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

from satdump_tpu_torch.core.exceptions import FormatError

_FORMATS = {
    "cf32": (np.complex64, 8, None),
    "cs32": (np.int32, 8, 2147483647.0),
    "cs16": (np.int16, 4, 32767.0),
    "cs8": (np.int8, 2, 127.0),
    "cu8": (np.uint8, 2, 127.0),
    "wav16": (np.int16, 4, 32767.0),
    "f32": (np.float32, 4, None),      # real-only (audio-level files)
    "s16": (np.int16, 2, 32767.0),     # real-only
}


def _norm_format(fmt: str) -> str:
    f = fmt.lower().lstrip(".")
    aliases = {"cf_32": "cf32", "cs_32": "cs32", "cs_16": "cs16", "cs_8": "cs8",
               "cu_8": "cu8", "wav_16": "wav16", "w16": "wav16", "wav": "wav16"}
    f = aliases.get(f, f)
    if f not in _FORMATS:
        raise FormatError(f"unknown baseband format '{fmt}'")
    return f


def is_complex_format(fmt: str) -> bool:
    return _norm_format(fmt) not in ("f32", "s16")


@dataclass
class BasebandBlock:
    samples: np.ndarray   # complex64[block_size] (or float32 for real formats), zero-padded
    valid: int            # number of valid samples in this block
    index: int            # block index from 0
    last: bool


class BasebandReader:
    """Block reader over a baseband file.

    Yields fixed-size zero-padded blocks of complex64 (or float32 for real
    formats) with valid counts — the shape contract the jitted DSP chain needs.
    """

    def __init__(self, path: str | Path, fmt: str, block_size: int = 1 << 20,
                 iq_swap: bool = False):
        self.path = str(path)
        self._mem: Optional[np.ndarray] = None
        if str(fmt).lower().lstrip(".") in ("ziq", "ziq2"):
            # compressed/packetized stream: decode once, serve blocks from
            # memory (ref common/ziq.cpp, ziq2.cpp; fine at recording sizes)
            fmt = str(fmt).lower().lstrip(".")
            if fmt == "ziq2":
                from satdump_tpu_torch.io.ziq import read_ziq2
                self._mem, sr = read_ziq2(self.path)
                self.annotation = {}
            else:
                from satdump_tpu_torch.io.ziq import read_ziq
                self._mem, sr, self.annotation = read_ziq(self.path)
            self.fmt = fmt
            self.block_size = int(block_size)
            self.iq_swap = iq_swap
            self.samplerate = sr or None
            self.header_bytes = 0
            self.num_samples = len(self._mem)
            return
        self.fmt = _norm_format(fmt)
        self.block_size = int(block_size)
        self.iq_swap = iq_swap
        self.dtype, self.bytes_per_sample, self.scale = _FORMATS[self.fmt]
        self.header_bytes = 0
        self.samplerate: Optional[float] = None
        if self.fmt == "wav16":
            with wave.open(self.path, "rb") as w:
                self.samplerate = float(w.getframerate())
                if w.getsampwidth() != 2:
                    raise FormatError("wav16 requires 16-bit WAV")
            # data offset: find the 'data' chunk
            self.header_bytes = _wav_data_offset(self.path)
        self.filesize = os.path.getsize(self.path)
        self.num_samples = (self.filesize - self.header_bytes) // self.bytes_per_sample

    @property
    def num_blocks(self) -> int:
        return max(1, -(-self.num_samples // self.block_size))

    def _convert(self, raw: np.ndarray) -> np.ndarray:
        if self.fmt in ("cf32", "f32"):
            out = raw.astype(np.complex64) if self.fmt == "cf32" else raw.astype(np.float32)
            if self.fmt == "cf32":
                return raw.view(np.complex64) if raw.dtype == np.complex64 else out
            return out
        if self.fmt in ("s16",):
            return raw.astype(np.float32) / self.scale
        flt = raw.astype(np.float32)
        if self.fmt == "cu8":
            flt = (flt - 127.0) / 127.0
        else:
            flt = flt / self.scale
        return flt[0::2] + 1j * flt[1::2]

    def read_block(self, index: int) -> BasebandBlock:
        start = index * self.block_size
        count = min(self.block_size, self.num_samples - start)
        if count <= 0:
            raise EOFError
        if self._mem is not None:
            data = self._mem[start: start + count]
            out = np.zeros(self.block_size, np.complex64)
            out[:count] = data
            if self.iq_swap:
                out = out.imag + 1j * out.real
            return BasebandBlock(out.astype(np.complex64), count, index,
                                 start + count >= self.num_samples)
        per = 2 if is_complex_format(self.fmt) and self.fmt != "cf32" else 1
        if self.fmt == "cf32":
            raw = np.fromfile(self.path, dtype=np.complex64, count=count,
                              offset=self.header_bytes + start * 8)
            out = raw.astype(np.complex64)
        else:
            raw = np.fromfile(self.path, dtype=self.dtype, count=count * per,
                              offset=self.header_bytes + start * self.bytes_per_sample)
            out = self._convert(raw)
        if self.iq_swap and np.iscomplexobj(out):
            out = (out.imag + 1j * out.real).astype(np.complex64)
        if out.dtype == np.complex128:
            out = out.astype(np.complex64)
        valid = len(out)
        if valid < self.block_size:
            pad = np.zeros(self.block_size, dtype=out.dtype)
            pad[:valid] = out
            out = pad
        last = start + count >= self.num_samples
        return BasebandBlock(out, valid, index, last)

    def blocks(self) -> Iterator[BasebandBlock]:
        for i in range(self.num_blocks):
            yield self.read_block(i)

    def read_all(self) -> np.ndarray:
        """Whole file as one array (no padding) — for small files/tests."""
        saved = self.block_size
        self.block_size = self.num_samples
        try:
            b = self.read_block(0)
        finally:
            self.block_size = saved
        return b.samples[: b.valid]


def _wav_data_offset(path: str) -> int:
    with open(path, "rb") as f:
        riff = f.read(12)
        if riff[:4] not in (b"RIFF", b"RF64"):
            raise FormatError("not a WAV file")
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                raise FormatError("WAV: no data chunk")
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if cid == b"data":
                return f.tell()
            f.seek(size + (size & 1), 1)


class BasebandWriter:
    """Write complex64 (or float32) sample arrays to a baseband file."""

    def __init__(self, path: str | Path, fmt: str, samplerate: float = 0):
        self.path = str(path)
        self.fmt = _norm_format(fmt)
        self.samplerate = samplerate
        if self.fmt == "wav16":
            self._wav = wave.open(self.path, "wb")
            self._wav.setnchannels(2)
            self._wav.setsampwidth(2)
            self._wav.setframerate(int(samplerate) or 48000)
            self._f = None
        else:
            self._wav = None
            self._f = open(self.path, "wb")

    def write(self, samples: np.ndarray) -> None:
        fmt = self.fmt
        if fmt in ("cf32",):
            samples.astype(np.complex64).tofile(self._f)
            return
        if fmt == "f32":
            np.asarray(samples, dtype=np.float32).tofile(self._f)
            return
        if np.iscomplexobj(samples):
            inter = np.empty(2 * len(samples), dtype=np.float32)
            inter[0::2] = samples.real
            inter[1::2] = samples.imag
        else:
            inter = np.asarray(samples, dtype=np.float32)
        if fmt in ("cs16", "wav16", "s16"):
            data = np.clip(np.round(inter * 32767.0), -32767, 32767).astype(np.int16)
        elif fmt == "cs32":
            data = np.clip(np.round(inter * 2147483647.0), -2147483647, 2147483647).astype(np.int32)
        elif fmt == "cs8":
            data = np.clip(np.round(inter * 127.0), -127, 127).astype(np.int8)
        elif fmt == "cu8":
            data = np.clip(np.round(inter * 127.0 + 127.0), 0, 255).astype(np.uint8)
        else:
            raise FormatError(fmt)
        if self._wav is not None:
            self._wav.writeframes(data.tobytes())
        else:
            data.tofile(self._f)

    def close(self) -> None:
        if self._wav is not None:
            self._wav.close()
        if self._f is not None:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_baseband(path: str | Path, fmt: str) -> Tuple[np.ndarray, Optional[float]]:
    r = BasebandReader(path, fmt)
    return r.read_all(), r.samplerate


def write_baseband(path: str | Path, fmt: str, samples: np.ndarray, samplerate: float = 0) -> None:
    with BasebandWriter(path, fmt, samplerate) as w:
        w.write(samples)


def detect_baseband_format(path: str | Path) -> Optional[str]:
    """Guess the baseband format from magic/extension
    (ref common/detect_header.h)."""
    p = str(path)
    try:
        with open(p, "rb") as f:
            magic = f.read(4)
            if magic == b"ZIQ_":
                return "ziq"
            if magic == b"ZIQ2":
                return "ziq2"
        with open(p, "rb") as f:
            if f.read(4) == b"RIFF":
                return "wav16"
    except OSError:
        return None
    ext = p.rsplit(".", 1)[-1].lower() if "." in p else ""
    known = {"cf32": "cf32", "f32": "cf32", "cs16": "cs16", "s16": "cs16",
             "cs8": "cs8", "s8": "cs8", "cu8": "cu8", "u8": "cu8",
             "wav": "wav16", "ziq": "ziq", "raw": "cs16"}
    return known.get(ext)
