"""xRIT (LRIT/HRIT) transport layer: CADUs -> reassembled xRIT files.

Reference behavior: plugins/xrit_support/xrit/{transport/xrit_demux.*,
xrit_file.*} — per-VCID CCSDS demuxers feed per-APID file assemblers driven
by the packet sequence flags (1=first, 0=continuation, 2=last, 3=standalone);
each data packet carries a CRC-16/CCITT-FALSE over its payload; header
records are parsed from the accumulated stream once total_header_length
bytes have arrived. Mission-specific hooks (on_parse_header /
on_process_data / on_finalize_data) mirror the reference's injectable
callbacks (GOES Rice, GK-2A AES, ...).

Counterpart of satdump_tpu/xrit/__init__.py (host NumPy, copied; the CRC is
the port's `ops/fec/crc.crc_ccitt`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from satdump_tpu_torch.ccsds import CCSDSPacket, Demuxer, parse_vcdu
from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.ops.fec.crc import crc_ccitt


# ---------------------------------------------------------------------------
# Header records (xrit_file.h; values big-endian per the LRIT/HRIT spec)
# ---------------------------------------------------------------------------
def _u(b: bytes) -> int:
    return int.from_bytes(b, "big")


@dataclasses.dataclass
class PrimaryHeader:
    TYPE = 0
    file_type_code: int
    total_header_length: int
    data_field_length: int

    @classmethod
    def parse(cls, d: bytes) -> "PrimaryHeader":
        return cls(file_type_code=d[3], total_header_length=_u(d[4:8]),
                   data_field_length=_u(d[8:16]))

    def encode(self) -> bytes:
        return (bytes([0]) + (16).to_bytes(2, "big")
                + bytes([self.file_type_code])
                + self.total_header_length.to_bytes(4, "big")
                + self.data_field_length.to_bytes(8, "big"))


@dataclasses.dataclass
class ImageStructureRecord:
    TYPE = 1
    bit_per_pixel: int
    columns_count: int
    lines_count: int
    compression_flag: int

    @classmethod
    def parse(cls, d: bytes) -> "ImageStructureRecord":
        return cls(bit_per_pixel=d[3], columns_count=_u(d[4:6]),
                   lines_count=_u(d[6:8]), compression_flag=d[8])

    def encode(self) -> bytes:
        return (bytes([1]) + (9).to_bytes(2, "big")
                + bytes([self.bit_per_pixel])
                + self.columns_count.to_bytes(2, "big")
                + self.lines_count.to_bytes(2, "big")
                + bytes([self.compression_flag]))


@dataclasses.dataclass
class ImageNavigationRecord:
    TYPE = 2
    projection_name: str
    column_scaling_factor: int
    line_scaling_factor: int
    column_offset: int
    line_offset: int

    @classmethod
    def parse(cls, d: bytes) -> "ImageNavigationRecord":
        return cls(projection_name=d[3:35].decode("ascii", "replace").rstrip("\x00 "),
                   column_scaling_factor=int.from_bytes(d[35:39], "big", signed=True),
                   line_scaling_factor=int.from_bytes(d[39:43], "big", signed=True),
                   column_offset=int.from_bytes(d[43:47], "big", signed=True),
                   line_offset=int.from_bytes(d[47:51], "big", signed=True))

    def encode(self) -> bytes:
        return (bytes([2]) + (51).to_bytes(2, "big")
                + self.projection_name.encode().ljust(32, b"\x00")
                + self.column_scaling_factor.to_bytes(4, "big", signed=True)
                + self.line_scaling_factor.to_bytes(4, "big", signed=True)
                + self.column_offset.to_bytes(4, "big", signed=True)
                + self.line_offset.to_bytes(4, "big", signed=True))


@dataclasses.dataclass
class ImageDataFunctionRecord:
    TYPE = 3
    datas: str

    @classmethod
    def parse(cls, d: bytes) -> "ImageDataFunctionRecord":
        rl = _u(d[1:3])
        return cls(datas=d[3:rl].decode("ascii", "replace"))

    def encode(self) -> bytes:
        b = self.datas.encode()
        return bytes([3]) + (3 + len(b)).to_bytes(2, "big") + b


@dataclasses.dataclass
class AnnotationRecord:
    TYPE = 4
    annotation_text: str

    @classmethod
    def parse(cls, d: bytes) -> "AnnotationRecord":
        rl = _u(d[1:3])
        return cls(annotation_text=d[3:rl].split(b"\x00")[0]
                   .decode("ascii", "replace"))

    def encode(self) -> bytes:
        b = self.annotation_text.encode()
        return bytes([4]) + (3 + len(b)).to_bytes(2, "big") + b


@dataclasses.dataclass
class TimeStampRecord:
    TYPE = 5
    days: int
    milliseconds_of_day: int

    @property
    def timestamp(self) -> int:
        # CDS epoch 1958 -> unix (4383 days), ms treated as seconds-of-day
        # scale per the reference (xrit_file.h TimeStampRecord)
        return (self.days - 4383) * 86400 + self.milliseconds_of_day

    @classmethod
    def parse(cls, d: bytes) -> "TimeStampRecord":
        return cls(days=_u(d[3:5]), milliseconds_of_day=_u(d[5:9]))

    def encode(self) -> bytes:
        return (bytes([5]) + (10).to_bytes(2, "big")
                + self.days.to_bytes(2, "big")
                + self.milliseconds_of_day.to_bytes(4, "big") + b"\x00")


@dataclasses.dataclass
class AncillaryTextRecord:
    """NOAA ancillary 'key=value; key=value' text (goes_headers.h)."""
    TYPE = 6
    ancillary_text: str

    @property
    def meta(self) -> Dict[str, str]:
        out = {}
        for part in self.ancillary_text.split(";"):
            if "=" in part:
                k, v = part.split("=", 1)
                out[k.strip()] = v.strip()
        return out

    @classmethod
    def parse(cls, d: bytes) -> "AncillaryTextRecord":
        rl = _u(d[1:3])
        return cls(ancillary_text=d[3:rl].decode("ascii", "replace"))

    def encode(self) -> bytes:
        b = self.ancillary_text.encode()
        return bytes([6]) + (3 + len(b)).to_bytes(2, "big") + b


@dataclasses.dataclass
class SegmentIdentificationHeader:
    """GOES segmented-image header (goes_headers.h TYPE 128)."""
    TYPE = 128
    image_identifier: int = 0
    segment_sequence_number: int = 0
    start_column: int = 0
    start_line: int = 0
    max_segment: int = 0
    max_column: int = 0
    max_row: int = 0

    @classmethod
    def parse(cls, d: bytes) -> "SegmentIdentificationHeader":
        return cls(image_identifier=_u(d[3:5]),
                   segment_sequence_number=_u(d[5:7]),
                   start_column=_u(d[7:9]), start_line=_u(d[9:11]),
                   max_segment=_u(d[11:13]), max_column=_u(d[13:15]),
                   max_row=_u(d[15:17]))

    def encode(self) -> bytes:
        return (bytes([128]) + (17).to_bytes(2, "big")
                + self.image_identifier.to_bytes(2, "big")
                + self.segment_sequence_number.to_bytes(2, "big")
                + self.start_column.to_bytes(2, "big")
                + self.start_line.to_bytes(2, "big")
                + self.max_segment.to_bytes(2, "big")
                + self.max_column.to_bytes(2, "big")
                + self.max_row.to_bytes(2, "big"))


@dataclasses.dataclass
class NOAALRITHeader:
    TYPE = 129
    agency_signature: str = "NOAA"
    product_id: int = 0
    product_subid: int = 0
    parameter: int = 0
    noaa_specific_compression: int = 0

    @classmethod
    def parse(cls, d: bytes) -> "NOAALRITHeader":
        return cls(agency_signature=d[3:7].decode("ascii", "replace"),
                   product_id=_u(d[7:9]), product_subid=_u(d[9:11]),
                   parameter=_u(d[11:13]), noaa_specific_compression=d[13])

    def encode(self) -> bytes:
        return (bytes([129]) + (14).to_bytes(2, "big")
                + self.agency_signature.encode()[:4].ljust(4, b"\x00")
                + self.product_id.to_bytes(2, "big")
                + self.product_subid.to_bytes(2, "big")
                + self.parameter.to_bytes(2, "big")
                + bytes([self.noaa_specific_compression]))


@dataclasses.dataclass
class RiceCompressionHeader:
    TYPE = 131
    flags: int = 0
    pixels_per_block: int = 0
    scanlines_per_packet: int = 0

    @classmethod
    def parse(cls, d: bytes) -> "RiceCompressionHeader":
        return cls(flags=_u(d[3:5]), pixels_per_block=d[5],
                   scanlines_per_packet=d[6])

    def encode(self) -> bytes:
        return (bytes([131]) + (7).to_bytes(2, "big")
                + self.flags.to_bytes(2, "big")
                + bytes([self.pixels_per_block, self.scanlines_per_packet]))


_RECORD_TYPES = {c.TYPE: c for c in
                 (PrimaryHeader, ImageStructureRecord, ImageNavigationRecord,
                  ImageDataFunctionRecord, AnnotationRecord, TimeStampRecord,
                  AncillaryTextRecord, SegmentIdentificationHeader,
                  NOAALRITHeader, RiceCompressionHeader)}


# ---------------------------------------------------------------------------
# XRITFile
# ---------------------------------------------------------------------------
class XRITFile:
    """One LRIT/HRIT file being (re)assembled: header records + data."""

    def __init__(self) -> None:
        self.vcid = -1
        self.last_tracked_counter = -1
        self.file_in_progress = False
        self.header_parsed = False
        self.filename = ""
        self.total_header_length = 0
        self.all_headers: Dict[int, int] = {}
        self.lrit_data = bytearray()
        self.custom_flags: Dict[int, int] = {}

    def has_header(self, cls) -> bool:
        return cls.TYPE in self.all_headers

    def get_header(self, cls):
        if cls is PrimaryHeader:
            return PrimaryHeader.parse(bytes(self.lrit_data[:16]))
        off = self.all_headers[cls.TYPE]
        return cls.parse(bytes(self.lrit_data[off:]))

    def parse_headers(self) -> None:
        """Walk the header records (xrit_file.cpp parseHeaders)."""
        ph = PrimaryHeader.parse(bytes(self.lrit_data[:16]))
        self.all_headers.clear()
        i = 0
        while i < ph.total_header_length and i + 3 <= len(self.lrit_data):
            rtype = self.lrit_data[i]
            rlen = _u(bytes(self.lrit_data[i + 1: i + 3]))
            if rlen == 0:
                break
            self.all_headers[rtype] = i
            i += rlen
        self.total_header_length = ph.total_header_length
        if AnnotationRecord.TYPE in self.all_headers:
            name = self.get_header(AnnotationRecord).annotation_text
            name = name.replace("/", "_").replace("\\", "_")
            self.filename = "".join("_" if ord(c) < 33 else c for c in name)

    @property
    def data(self) -> bytes:
        """The data field (after all header records)."""
        return bytes(self.lrit_data[self.total_header_length:])


def compute_crc(data: bytes) -> int:
    """LRIT packet CRC (CRC-16/CCITT-FALSE, LRIT Mission Specific Doc)."""
    return crc_ccitt.compute(data)


# ---------------------------------------------------------------------------
# Transport demux
# ---------------------------------------------------------------------------
class XRITDemux:
    """CADUs -> finished XRITFiles (behavioral match of XRITDemux::work)."""

    def __init__(self, mpdu_size: int = 884, check_crc: bool = True):
        self.mpdu_size = mpdu_size
        self.check_crc = check_crc
        self.demuxers: Dict[int, Demuxer] = {}
        self.wip: Dict[int, Dict[int, XRITFile]] = {}
        self.on_parse_header: Callable[[XRITFile], None] = lambda f: None
        self.on_process_data: Callable[[XRITFile, CCSDSPacket, bool], bool] = \
            lambda f, p, bad: True
        self.on_finalize_data: Callable[[XRITFile], None] = lambda f: None

    def work(self, cadu: np.ndarray) -> List[XRITFile]:
        files: List[XRITFile] = []
        vcdu = parse_vcdu(cadu)
        if vcdu.vcid == 63:  # filler
            return files
        if vcdu.vcid not in self.demuxers:
            self.demuxers[vcdu.vcid] = Demuxer(self.mpdu_size)
            self.wip[vcdu.vcid] = {}

        for pkt in self.demuxers[vcdu.vcid].work(cadu):
            apid = pkt.header.apid
            if apid == 2047 or len(pkt.payload) < 2:
                continue
            if apid not in self.wip[vcdu.vcid]:
                self.wip[vcdu.vcid][apid] = XRITFile()
            f = self.wip[vcdu.vcid][apid]

            payload = bytes(pkt.payload)
            crc = payload[-2] << 8 | payload[-1]
            if self.check_crc and crc != compute_crc(payload[:-2]):
                can_continue = False
                if f.file_in_progress and pkt.header.sequence_flag == 0 \
                        and f.header_parsed:
                    ph = f.get_header(PrimaryHeader)
                    can_continue = (ph.file_type_code == 0
                                    and f.has_header(ImageStructureRecord))
                if can_continue:
                    logger.warning("LRIT CRC invalid, file recoverable")
                    self._data(f, pkt, bad_crc=True)
                else:
                    logger.error("LRIT CRC invalid, skipping")
                    f.file_in_progress = False
                    f.lrit_data = bytearray()
                continue

            flag = pkt.header.sequence_flag
            if flag in (1, 3):                      # first / standalone
                if f.file_in_progress:
                    self._finalize(f, files)
                f.lrit_data = bytearray()
                f.lrit_data += payload[10:-2]       # skip 10-byte TP header
                f.vcid = vcdu.vcid
                f.header_parsed = False
                f.file_in_progress = True
                f.last_tracked_counter = pkt.header.packet_sequence_count
            elif flag == 0 and f.file_in_progress:  # continuation
                self._data(f, pkt)
            elif flag == 2 and f.file_in_progress:  # last
                self._data(f, pkt)
                self._finalize(f, files)
                f.file_in_progress = False
                f.lrit_data = bytearray()

            if f.file_in_progress and not f.header_parsed:
                ph = PrimaryHeader.parse(bytes(f.lrit_data[:16])) \
                    if len(f.lrit_data) >= 16 else None
                if ph and len(f.lrit_data) >= ph.total_header_length:
                    f.parse_headers()
                    f.header_parsed = True
                    logger.info(f"New LRIT file: {f.filename}")
                    self.on_parse_header(f)
                    if flag == 3:
                        self._finalize(f, files)
                        f.file_in_progress = False
                        f.lrit_data = bytearray()

        return files

    def flush(self) -> List[XRITFile]:
        """EOF: finalize any in-progress file whose last packet (sequence
        flag 2) never arrived — the stream-tail case; downstream assemblers
        fill missing data (the reference saves WIP files at process end)."""
        files: List[XRITFile] = []
        for per_vcid in self.wip.values():
            for f in per_vcid.values():
                if f.file_in_progress and f.header_parsed:
                    self._finalize(f, files)
                    f.file_in_progress = False
                    f.lrit_data = bytearray()
        return files

    def _data(self, f: XRITFile, pkt: CCSDSPacket, bad_crc: bool = False):
        if self.on_process_data(f, pkt, bad_crc):
            f.lrit_data += bytes(pkt.payload)[:-2]

    def _finalize(self, f: XRITFile, out: List[XRITFile]):
        self.on_finalize_data(f)
        done = XRITFile()
        done.__dict__.update({k: (bytearray(v) if isinstance(v, bytearray)
                                  else dict(v) if isinstance(v, dict) else v)
                              for k, v in f.__dict__.items()})
        out.append(done)


# ---------------------------------------------------------------------------
# TX fixture: build an xRIT file + packetize (tests; ref has no TX path)
# ---------------------------------------------------------------------------
def build_xrit_file(filename: str, data: bytes, records: list,
                    file_type_code: int = 0) -> bytes:
    """Assemble raw LRIT file bytes: primary header + records + data."""
    recs = [AnnotationRecord(annotation_text=filename)] + list(records)
    body = b"".join(r.encode() for r in recs)
    total = 16 + len(body)
    ph = PrimaryHeader(file_type_code=file_type_code,
                       total_header_length=total,
                       data_field_length=len(data) * 8)
    return ph.encode() + body + bytes(data)


def packetize_xrit_file(raw: bytes, apid: int, seq_start: int = 0,
                        chunk: int = 870) -> List[CCSDSPacket]:
    """Split raw file bytes into transport packets: the first carries a
    10-byte TP header (file counter + length) and sequence_flag 1 (or 3 if
    it fits whole), continuations 0, last 2; each ends with the CRC."""
    from satdump_tpu_torch.ccsds import CCSDSHeader
    pkts = []
    tp = (0).to_bytes(2, "big") + (len(raw) * 8).to_bytes(8, "big")
    first_payload = tp + raw[:chunk - 10]
    rest = raw[chunk - 10:]
    chunks = [first_payload] + [rest[i:i + chunk]
                                for i in range(0, len(rest), chunk)]
    n = len(chunks)
    for i, c in enumerate(chunks):
        if n == 1:
            flag = 3
        elif i == 0:
            flag = 1
        elif i == n - 1:
            flag = 2
        else:
            flag = 0
        pl = bytearray(c + compute_crc(c).to_bytes(2, "big"))
        hdr = CCSDSHeader(apid=apid, sequence_flag=flag,
                          packet_sequence_count=(seq_start + i) & 0x3FFF)
        pkts.append(CCSDSPacket(header=hdr, payload=pl))
    return pkts
