"""GK-2A (GEO-KOMPSAT-2A) LRIT/HRIT processing: DES decryption + AMI
segmented image assembly.

Behavioral equivalent of plugins/gk2a_support/gk2a/ and
plugins/xrit_support/xrit/gk2a/:
* Key file: 8-byte time header + 30 (index, 16-byte encrypted key) records
  + CRC-16/CCITT; keys decrypted with single-DES using the ground station
  MAC address as the key (key_decryptor.cpp). Decrypted key files (the
  xrit-rx format: 0x001E + 30x(index LE + 8-byte key)) load directly.
* Per-file decryption: KeyHeader (type 7) carries the key index; payload
  decrypted block-wise with DES-ECB (module_gk2a_lrit_data_decoder_proc.cpp
  :29-68).
* AMI images: JPEG (compression_flag 2) or J2K/wavelet (1) decompression,
  segment assembly per channel/timestamp
  (xrit/gk2a/{decomp.cpp,segment_decoder.h}).

Counterpart of satdump_tpu/xrit/gk2a.py (host code, copied) on the port's
own codecs, since the card's machine has no Pillow: 12-bit and 8-bit JPEG
segments go through the port's build of `native/jpeg12.c` first, as in the
JAX module, then `image/jpeg.py::decode_jpeg_gray` (its IDCT on the
module's `torch_device`); J2K segments through the port's own JPEG 2000
decoder (`image/j2k.py`, `native/j2k.c`), with the 85-byte UHRIT preamble
retry.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np

from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.image.io import save_img
from satdump_tpu_torch.image.j2k import decompress_j2k
from satdump_tpu_torch.image.jpeg import decode_jpeg_gray
from satdump_tpu_torch.image.jpeg12 import decompress_jpeg12
from satdump_tpu_torch.pipeline.module import ProcessingModule, register_module
from satdump_tpu_torch.utils.des import DES
from satdump_tpu_torch.utils.device import is_device_fault, resolve_device
from satdump_tpu_torch.xrit import (ImageStructureRecord, PrimaryHeader,
                                    XRITDemux, XRITFile)

KEY_HEADER_TYPE = 7
SEG_ID_TYPE = 128


class GK2AKeyHeader:
    def __init__(self, d: bytes):
        self.type = d[0]
        self.record_length = d[1] << 8 | d[2]
        self.key = d[3] << 24 | d[4] << 16 | d[5] << 8 | d[6]


class GK2ASegId:
    """gk2a_headers.h ImageSegmentationIdentification (type 128)."""

    def __init__(self, d: bytes):
        self.image_seq_nb = d[3]
        self.total_segments_nb = d[4]
        self.line_nb = d[5] << 8 | d[6]


def _crc16_ccitt(data: bytes) -> int:
    crc = 0xFFFF
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x1021 if crc & 0x8000 else crc << 1) & 0xFFFF
    return crc


def decrypt_key_file(encrypted: bytes, mac_address: str) -> Dict[int, bytes]:
    """Encrypted key-management file -> {index: 8-byte DES key}
    (key_decryptor.cpp:30-120). mac_address: 12 hex chars."""
    if len(encrypted) < 550:
        raise ValueError("key file too short")
    data = encrypted[8: 8 + 540]
    sent_crc = encrypted[548] << 8 | encrypted[549]
    if _crc16_ccitt(encrypted[:548]) != sent_crc:
        raise ValueError("key file CRC invalid")
    # DES key = the 6 MAC bytes + 2 zero bytes (key_decryptor.cpp:84-96:
    # the byteswap of the little-endian uint64 leaves (mac << 16) in
    # big-endian byte order in memory)
    key_bytes = (int(mac_address, 16) << 16).to_bytes(8, "big")
    des = DES(key_bytes)
    keys: Dict[int, bytes] = {}
    for i in range(30):
        off = i * 18
        idx = data[off] << 8 | data[off + 1]
        enc = data[off + 2: off + 10]      # first 8 of the 16 bytes
        keys[idx] = des.decrypt_block(enc)
    return keys


def load_key_file(path: str, mac_address: str = "") -> Dict[int, bytes]:
    """Load a decrypted xrit-rx-format key file (2-byte count + records of
    2-byte LE index + 8-byte key, module_gk2a_lrit_data_decoder.cpp:103-121)
    or, with `mac_address`, decrypt an encrypted one."""
    raw = Path(path).read_bytes()
    if mac_address:
        return decrypt_key_file(raw, mac_address)
    keys: Dict[int, bytes] = {}
    n = raw[0] << 8 | raw[1]
    off = 2
    for _ in range(n):
        if off + 10 > len(raw):
            break
        idx = raw[off] | raw[off + 1] << 8
        keys[idx] = raw[off + 2: off + 10]
        off += 10
    return keys


class GK2ASegmentAssembler:
    def __init__(self, total_segments: int, width: int, seg_height: int,
                 depth16: bool):
        self.total = max(total_segments, 1)
        self.width = width
        self.seg_height = seg_height
        self.image = np.zeros((seg_height * self.total, width),
                              np.uint16 if depth16 else np.uint8)
        self.done = np.zeros(self.total, bool)

    def push(self, seg_idx: int, img: np.ndarray) -> None:
        if not (0 <= seg_idx < self.total):
            return
        y0 = seg_idx * self.seg_height
        h = min(img.shape[0], self.image.shape[0] - y0)
        w = min(img.shape[1], self.width)
        self.image[y0: y0 + h, :w] = img[:h, :w]
        self.done[seg_idx] = True

    @property
    def complete(self) -> bool:
        return bool(self.done.all())


@register_module
class GK2ALRITDataDecoderModule(ProcessingModule):
    """cadu -> GK-2A files/images. Parameters: `gk2a_keys` (path to a key
    file), `mac_address` (to decrypt an encrypted key file)."""

    id = "gk2a_lrit_data_decoder"

    def __init__(self, input_file, output_file_hint, parameters):
        super().__init__(input_file, output_file_hint, parameters)
        self.keys: Dict[int, bytes] = {}
        kp = self.param("gk2a_keys", "")
        if kp and Path(kp).exists():
            try:
                self.keys = load_key_file(kp, str(self.param("mac_address",
                                                             "")))
                logger.info(f"GK-2A: loaded {len(self.keys)} keys")
            except Exception as e:
                logger.error(f"GK-2A key file load failed: {e}")
        self._assemblers: Dict[str, GK2ASegmentAssembler] = {}
        self.images = 0
        self.files = 0
        self.torch_device = resolve_device(self.param("torch_device", "cuda"))

    # -- decryption (module_gk2a_lrit_data_decoder_proc.cpp:29-68) ----------
    def _decrypt(self, f: XRITFile) -> bool:
        if KEY_HEADER_TYPE not in f.all_headers:
            return True
        off = f.all_headers[KEY_HEADER_TYPE]
        kh = GK2AKeyHeader(bytes(f.lrit_data[off: off + 7]))
        if kh.key == 0:
            return True
        if not self.keys:
            return False
        key = self.keys.get(kh.key)
        if key is None:
            key = self.keys.get(kh.key & 0xFFFF)
        if key is None:
            return False
        ph = f.get_header(PrimaryHeader)
        payload = bytes(f.lrit_data[ph.total_header_length:])
        dec = DES(key).decrypt_ecb(payload)
        f.lrit_data = f.lrit_data[: ph.total_header_length] + bytearray(dec)
        return True

    def _decompress(self, f: XRITFile) -> Optional[np.ndarray]:
        """JPEG/J2K payload -> image array (xrit/gk2a/decomp.cpp)."""
        ph = f.get_header(PrimaryHeader)
        isr = f.get_header(ImageStructureRecord)
        payload = bytes(f.lrit_data[ph.total_header_length:])
        if isr.compression_flag == 0:
            need = isr.columns_count * isr.lines_count
            if isr.bit_per_pixel > 8:
                arr = np.frombuffer(payload[: need * 2].ljust(need * 2,
                                                              b"\0"), ">u2")
            else:
                arr = np.frombuffer(payload[:need].ljust(need, b"\0"),
                                    np.uint8)
            return arr.reshape(isr.lines_count, isr.columns_count).copy()
        try:
            if isr.compression_flag == 2:      # JPEG
                # GK-2A ships 12-bit JPEGs that 8-bit libraries refuse
                # (ref jpeg12_utils.cpp); try the native 12-bit decoder
                # first, then decode_jpeg_gray for plain 8-bit streams
                img = decompress_jpeg12(payload)
                if img is not None:
                    return img
                return decode_jpeg_gray(payload, self.torch_device)
            # wavelet/J2K; UHRIT streams carry an 85-byte preamble
            try:
                img = decompress_j2k(payload)
            except Exception:
                img = decompress_j2k(payload[85:])
            if isr.bit_per_pixel > 8:
                img = (img.astype(np.uint16)
                       << (16 - isr.bit_per_pixel))
            return img
        except Exception as e:
            if is_device_fault(e):
                raise
            logger.warning(f"GK-2A decompress failed for {f.filename}: {e}")
            return None

    def _process_file(self, f: XRITFile, out_dir: Path) -> None:
        self.files += 1
        ph = f.get_header(PrimaryHeader)
        if not self._decrypt(f):
            d = out_dir / "LRIT_ENCRYPTED"
            d.mkdir(parents=True, exist_ok=True)
            (d / f.filename).write_bytes(bytes(f.lrit_data))
            return
        parts = f.filename.split("_")
        is_ami = (ph.file_type_code == 0
                  and ImageStructureRecord.TYPE in f.all_headers
                  and len(parts) >= 7 and parts[0] == "IMG")
        if not is_ami:
            d = out_dir / "ADD"
            d.mkdir(parents=True, exist_ok=True)
            (d / f.filename).write_bytes(
                bytes(f.lrit_data[ph.total_header_length:]))
            return
        img = self._decompress(f)
        if img is None:
            return
        isr = f.get_header(ImageStructureRecord)
        channel, date, tm = parts[3], parts[4], parts[5]
        key = f"{channel}_{date}{tm}"
        seg_idx, total = 0, 1
        if SEG_ID_TYPE in f.all_headers:
            soff = f.all_headers[SEG_ID_TYPE]
            sid = GK2ASegId(bytes(f.lrit_data[soff: soff + 7]))
            total = sid.total_segments_nb
            seg_idx = sid.image_seq_nb
        a = self._assemblers.get(key)
        if a is None:
            a = GK2ASegmentAssembler(total, isr.columns_count,
                                     isr.lines_count,
                                     isr.bit_per_pixel > 8)
            self._assemblers[key] = a
        a.push(seg_idx, img)
        if a.complete:
            self._flush(key, out_dir)

    def _flush(self, key: str, out_dir: Path) -> None:
        a = self._assemblers.pop(key, None)
        if a is None:
            return
        d = out_dir / "IMAGES" / "AMI"
        d.mkdir(parents=True, exist_ok=True)
        save_img(a.image, d / f"AMI_{key}.png")
        self.images += 1

    def process(self):
        out_dir = Path(self.d_output_file_hint).parent
        out_dir.mkdir(parents=True, exist_ok=True)
        self.d_output_file = str(out_dir)
        demux = XRITDemux()
        data = np.fromfile(self.d_input_file, np.uint8)
        n = len(data) // 1024
        for i in range(n):
            for f in demux.work(bytes(data[i * 1024: (i + 1) * 1024])):
                self._process_file(f, out_dir)
        for f in demux.flush():
            self._process_file(f, out_dir)
        for key in list(self._assemblers):
            self._flush(key, out_dir)
        self.stats = {"files": self.files, "images": self.images}
        logger.info(f"GK-2A: {self.files} files, {self.images} images")
