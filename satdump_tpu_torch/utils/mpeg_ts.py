"""MPEG transport stream tooling: TS header parse, per-PID payload demux,
DVB-MPE (IP over MPEG) section parsing.

Reference: src-core/common/mpeg_ts/{ts_header,ts_demux,dvb_mpe}.{h,cpp} —
used by the GEONETCast / DVB data paths downstream of the DVB-S2 TS
extractor. Header field extraction is vectorized over all 188-byte packets
of a block at once; only the PUSI reassembly walk is per-packet."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

TS_SIZE = 188
SYNC = 0x47


@dataclass
class TSHeader:
    sync: int
    tei: bool
    pusi: bool
    tp: bool
    pid: int
    tsc: int
    afc: int
    cont: int


def parse_ts_headers(ts: np.ndarray) -> Dict[str, np.ndarray]:
    """(N, 188) packets -> vectorized header fields (ts_header.cpp)."""
    ts = np.asarray(ts, np.uint8).reshape(-1, TS_SIZE)
    b1, b2, b3 = ts[:, 1].astype(int), ts[:, 2].astype(int), ts[:, 3].astype(int)
    return {
        "sync": ts[:, 0].astype(int),
        "tei": (b1 >> 7) & 1,
        "pusi": (b1 >> 6) & 1,
        "tp": (b1 >> 5) & 1,
        "pid": ((b1 & 0x1F) << 8) | b2,
        "tsc": (b3 >> 6) & 3,
        "afc": (b3 >> 4) & 3,
        "cont": b3 & 0xF,
    }


class TSDemux:
    """Reassemble PUSI-delimited payload units for one PID
    (ts_demux.cpp demux)."""

    def __init__(self, pid: int = -1):
        self.pid = pid
        self._cur: Optional[bytearray] = None

    def work(self, ts: np.ndarray) -> List[bytes]:
        ts = np.asarray(ts, np.uint8).reshape(-1, TS_SIZE)
        hdr = parse_ts_headers(ts)
        out: List[bytes] = []
        for i in range(len(ts)):
            if hdr["sync"][i] != SYNC or hdr["tei"][i]:
                continue
            if self.pid >= 0 and hdr["pid"][i] != self.pid:
                continue
            off = 4
            if hdr["afc"][i] & 2:          # adaptation field present
                off += 1 + int(ts[i, 4])
            if off >= TS_SIZE:
                continue
            payload = ts[i, off:]
            if hdr["pusi"][i]:
                if self._cur is not None:
                    out.append(bytes(self._cur))
                self._cur = bytearray(payload.tobytes())
            elif self._cur is not None:
                self._cur += payload.tobytes()
        return out

    def flush(self) -> List[bytes]:
        out = [bytes(self._cur)] if self._cur else []
        self._cur = None
        return out


@dataclass
class MPEHeader:
    table_id: int
    section_length: int
    mac: Tuple[int, int, int, int, int, int]
    llc_snap: bool
    section_number: int
    last_section_number: int

    @classmethod
    def parse(cls, d: bytes) -> "MPEHeader":
        return cls(
            table_id=d[0],
            section_length=((d[1] & 0x0F) << 8) | d[2],
            mac=(d[11], d[10], d[9], d[8], d[4], d[3]),
            llc_snap=bool((d[5] >> 3) & 1),
            section_number=d[6],
            last_section_number=d[7])


@dataclass
class IPv4Header:
    version: int
    ihl: int
    total_length: int
    protocol: int
    source_ip: Tuple[int, int, int, int]
    target_ip: Tuple[int, int, int, int]

    @classmethod
    def parse(cls, d: bytes) -> "IPv4Header":
        return cls(
            version=d[0] >> 4,
            ihl=d[0] & 0xF,
            total_length=(d[2] << 8) | d[3],
            protocol=d[9],
            source_ip=(d[12], d[13], d[14], d[15]),
            target_ip=(d[16], d[17], d[18], d[19]))


def mpe_extract_ip(section: bytes) -> Optional[Tuple[MPEHeader, IPv4Header,
                                                     bytes]]:
    """One MPE section (table_id 0x3E) -> (mpe_hdr, ip_hdr, ip_payload)
    (dvb_mpe.cpp layout: 12-byte MPE header, IP datagram, 4-byte CRC)."""
    if len(section) < 12 + 20 or section[0] != 0x3E:
        return None
    mpe = MPEHeader.parse(section)
    ip_raw = section[12: 12 + mpe.section_length - 9 - 4]
    if len(ip_raw) < 20:
        return None
    ip = IPv4Header.parse(ip_raw)
    payload = ip_raw[ip.ihl * 4: ip.total_length]
    return mpe, ip, payload


# ---------------------------------------------------------------------------
# Fazzt file broadcast (GEONETCast), ref common/mpeg_ts/fazzt_processor.cpp
# ---------------------------------------------------------------------------
@dataclass
class FazztFile:
    name: str
    size: int
    parts: int
    has_parts: List[bool]
    data: bytearray
    last_pkt_time: float


class FazztProcessor:
    """Reassemble files from Fazzt broadcast frames
    (fazzt_processor.cpp:8-99). Frame layout: type at byte 1, LE16 length
    at 2, LE32 file id at 4. Head (0x03) announces name/parts/size, body
    (0x01) carries LE16 part index at 8 + payload from byte 16, tail
    (0xFF) flushes. Stale transfers are pruned after ``max_time``
    seconds."""

    MAX_SIZE = int(1e9)

    def __init__(self, payload_size: int, max_time: float = 120.0,
                 clock=None):
        import time as _time
        self.payload_size = payload_size
        self.max_time = max_time
        self._clock = clock or _time.time
        self._files: Dict[int, FazztFile] = {}
        self._frame_cnt = 0

    def work(self, frame: bytes) -> List[FazztFile]:
        out: List[FazztFile] = []
        frame = bytes(frame)
        if len(frame) < 8:
            return out
        ptype = frame[1]
        plen = frame[3] << 8 | frame[2]
        fid = int.from_bytes(frame[4:8], "little")
        if plen <= len(frame):
            if ptype == 0x03 and len(frame) >= 85:
                f = frame.ljust(1431, b"\x00")
                name = f[84: f.index(b"\x00", 84)].decode(
                    "latin-1", "replace")
                parts = f[73] << 8 | f[72]
                sz_at = 84 + len(name) + 56
                length = int.from_bytes(f[sz_at: sz_at + 4], "little")
                if (length <= self.MAX_SIZE and len(name) > 4
                        and parts * self.payload_size >= length):
                    if fid in self._files:
                        self._files[fid].size = length
                        self._files[fid].parts = parts
                        self._files[fid].name = name
                    else:
                        self._files[fid] = FazztFile(
                            name, length, parts, [False] * parts,
                            bytearray(parts * self.payload_size),
                            self._clock())
            elif ptype == 0x01 and fid in self._files:
                part = frame[9] << 8 | frame[8]
                fil = self._files[fid]
                if part < fil.parts:
                    chunk = frame[16: 16 + self.payload_size]
                    fil.data[part * self.payload_size:
                             part * self.payload_size + len(chunk)] = chunk
                    fil.has_parts[part] = True
                    fil.last_pkt_time = self._clock()
            elif ptype == 0xFF and fid in self._files:
                fil = self._files.pop(fid)
                if fil.size > 0 and len(fil.data) > 0:
                    fil.data = fil.data[: fil.size]
                    out.append(fil)
        self._frame_cnt += 1
        if self._frame_cnt % 1000 == 0:
            now = self._clock()
            self._files = {k: v for k, v in self._files.items()
                           if now - v.last_pkt_time <= self.max_time}
        return out
