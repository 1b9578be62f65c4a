"""Sample-source abstraction + registry.

Reference: src-core/common/dsp_source_sink/dsp_sample_source.h:26-83 — the
open/start/stop/close + set_frequency/set_samplerate surface every SDR
backend implements, with a registry + event hook so plugins can add
sources. The built-ins are the file player and the network clients
(remote IQ, rtl_tcp, SpyServer, SDR++ server); SDR hardware support
arrives by registering more sources.

A copy of satdump_tpu/io/sources.py, its imports rewritten to the port.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from satdump_tpu_torch.core.events import event_bus
from satdump_tpu_torch.core.log import logger


class SampleSource:
    """Abstract source (dsp_sample_source.h API shape)."""

    source_type = "base"

    def __init__(self, params: Optional[dict] = None):
        self.d_params = dict(params or {})
        self.samplerate = float(self.d_params.get("samplerate", 0))
        self.frequency = float(self.d_params.get("frequency", 0))
        self.started = False

    # lifecycle (open/start/stop/close)
    def open(self) -> None: ...

    def start(self) -> None:
        self.started = True

    def stop(self) -> None:
        self.started = False

    def close(self) -> None: ...

    # tuning
    def set_frequency(self, hz: float) -> None:
        self.frequency = hz

    def set_samplerate(self, sps: float) -> None:
        self.samplerate = sps

    def get_samplerate(self) -> float:
        return self.samplerate

    # streaming
    def blocks(self) -> Iterator[np.ndarray]:
        raise NotImplementedError


class FileSource(SampleSource):
    """Baseband file playback (dsp_source_sink/file_source.h), optionally
    throttled to real time."""

    source_type = "file"

    def __init__(self, params=None):
        super().__init__(params)
        self.path = self.d_params["path"]
        self.fmt = str(self.d_params.get("baseband_format", "cf32"))
        self.block_size = int(self.d_params.get("block_size", 1 << 18))
        self.throttle = bool(self.d_params.get("throttle", False))

    def blocks(self) -> Iterator[np.ndarray]:
        from satdump_tpu_torch.io.baseband import BasebandReader
        reader = BasebandReader(self.path, self.fmt,
                                block_size=self.block_size)
        for blk in reader.blocks():
            if self.throttle and self.samplerate > 0:
                time.sleep(blk.valid / self.samplerate)
            yield blk.samples[: blk.valid]


class RtlTcpSource(SampleSource):
    """rtl_tcp network client (plugins/sdr_sources/rtltcp_support/
    rtltcp_client.h): 12-byte "RTL0" banner, then a raw uint8 IQ stream;
    control commands are 1-byte opcode + uint32 BE parameter (1 freq,
    2 samplerate, 3 gain mode, 4 gain, 8 AGC)."""

    source_type = "rtltcp"

    def __init__(self, params=None):
        super().__init__(params)
        self.host = str(self.d_params.get("host", "127.0.0.1"))
        self.port = int(self.d_params.get("port", 1234))
        self.block_size = int(self.d_params.get("block_size", 1 << 16))
        self.gain = self.d_params.get("gain")
        self._sock = None

    def _cmd(self, opcode: int, param: int) -> None:
        import struct
        if self._sock is not None:
            self._sock.sendall(struct.pack(">BI", opcode, int(param)))

    def open(self) -> None:
        import socket
        self._sock = socket.create_connection((self.host, self.port),
                                              timeout=10)
        hdr = b""
        while len(hdr) < 12:
            chunk = self._sock.recv(12 - len(hdr))
            if not chunk:
                raise ConnectionError("rtl_tcp: connection closed in banner")
            hdr += chunk
        if hdr[:4] != b"RTL0":
            raise ConnectionError(f"rtl_tcp: bad banner {hdr[:4]!r}")
        self.tuner_type = int.from_bytes(hdr[4:8], "big")
        self.tuner_gain_count = int.from_bytes(hdr[8:12], "big")
        if self.samplerate:
            self._cmd(2, self.samplerate)
        if self.frequency:
            self._cmd(1, self.frequency)
        if self.gain is None:
            self._cmd(8, 1)                  # AGC on
        else:
            self._cmd(3, 1)
            self._cmd(4, int(float(self.gain) * 10))

    def set_frequency(self, hz: float) -> None:
        self.frequency = hz
        self._cmd(1, hz)

    def set_samplerate(self, sps: float) -> None:
        self.samplerate = sps
        self._cmd(2, sps)

    def blocks(self) -> Iterator[np.ndarray]:
        if self._sock is None:
            self.open()
        nbytes = self.block_size * 2
        while True:
            buf = b""
            while len(buf) < nbytes:
                chunk = self._sock.recv(nbytes - len(buf))
                if not chunk:
                    return
                buf += chunk
            u8 = np.frombuffer(buf, np.uint8).astype(np.float32)
            iq = (u8 - 127.4) / 128.0
            yield (iq[0::2] + 1j * iq[1::2]).astype(np.complex64)

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None


class SpyServerSource(SampleSource):
    """SpyServer network client (plugins/sdr_sources/spyserver_support/
    spyserver/spyserver_protocol.h): HELLO handshake, SET_SETTING commands
    (streaming mode/format/frequency/decimation), 20-byte LE message
    headers, uint8/int16/float IQ stream bodies."""

    source_type = "spyserver"

    PROTOCOL_VERSION = (2 << 24) | 1700

    def __init__(self, params=None):
        super().__init__(params)
        self.host = str(self.d_params.get("host", "127.0.0.1"))
        self.port = int(self.d_params.get("port", 5555))
        self.bit16 = bool(self.d_params.get("bit16", True))
        self.gain = int(self.d_params.get("gain", 20))
        self._sock = None
        self.device_info: dict = {}

    def _send_cmd(self, ctype: int, body: bytes) -> None:
        import struct
        self._sock.sendall(struct.pack("<II", ctype, len(body)) + body)

    def _setting(self, setting: int, value: int) -> None:
        import struct
        self._send_cmd(2, struct.pack("<II", setting, int(value)))

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("spyserver: connection closed")
            buf += chunk
        return buf

    def _recv_msg(self):
        import struct
        hdr = self._recv_exact(20)
        pid, mtype, stype, seq, size = struct.unpack("<5I", hdr)
        body = self._recv_exact(size) if size else b""
        return mtype, body

    def open(self) -> None:
        import socket
        import struct
        self._sock = socket.create_connection((self.host, self.port),
                                              timeout=10)
        name = b"satdump_tpu"
        self._send_cmd(0, struct.pack("<I", self.PROTOCOL_VERSION) + name)
        # wait for device info to size the decimation
        while not self.device_info:
            mtype, body = self._recv_msg()
            if mtype == 0 and len(body) >= 48:
                vals = struct.unpack("<12I", body[:48])
                keys = ["DeviceType", "DeviceSerial", "MaximumSampleRate",
                        "MaximumBandwidth", "DecimationStageCount",
                        "GainStageCount", "MaximumGainIndex",
                        "MinimumFrequency", "MaximumFrequency", "Resolution",
                        "MinimumIQDecimation", "ForcedIQFormat"]
                self.device_info = dict(zip(keys, vals))
        decim = 0
        if self.samplerate and self.device_info["MaximumSampleRate"]:
            import math
            decim = max(0, round(math.log2(
                self.device_info["MaximumSampleRate"] / self.samplerate)))
        self._setting(0, 1)                       # STREAMING_MODE = IQ only
        self._setting(100, 2 if self.bit16 else 1)  # IQ_FORMAT
        self._setting(102, decim)                 # IQ_DECIMATION
        if self.frequency:
            self._setting(101, int(self.frequency))
        self._setting(2, self.gain)
        self._setting(1, 1)                       # STREAMING_ENABLED

    def set_frequency(self, hz: float) -> None:
        self.frequency = hz
        if self._sock is not None:
            self._setting(101, int(hz))

    def blocks(self) -> Iterator[np.ndarray]:
        if self._sock is None:
            self.open()
        while True:
            try:
                mtype, body = self._recv_msg()
            except ConnectionError:
                return
            if mtype == 100:      # uint8 IQ
                u8 = np.frombuffer(body, np.uint8).astype(np.float32)
                iq = (u8 - 128.0) / 128.0
                yield (iq[0::2] + 1j * iq[1::2]).astype(np.complex64)
            elif mtype == 101:    # int16 IQ
                s16 = np.frombuffer(body, "<i2").astype(np.float32) / 32768.0
                yield (s16[0::2] + 1j * s16[1::2]).astype(np.complex64)
            elif mtype == 103:    # float IQ
                f = np.frombuffer(body, "<f4")
                yield (f[0::2] + 1j * f[1::2]).astype(np.complex64)

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None


class RemoteSource(SampleSource):
    """Remote-IQ network client (plugins/sdr_sources/remote_sdr_support)."""

    source_type = "remote"

    def __init__(self, params=None):
        super().__init__(params)
        self.host = str(self.d_params.get("host", "127.0.0.1"))
        self.port = int(self.d_params["port"])
        self._client = None

    def open(self) -> None:
        from satdump_tpu_torch.io.net import RemoteIQClient
        self._client = RemoteIQClient(self.host, self.port)

    def blocks(self) -> Iterator[np.ndarray]:
        if self._client is None:
            self.open()
        yield from self._client.blocks()

    def close(self) -> None:
        if self._client is not None:
            self._client.close()
            self._client = None


# -- registry (dsp_sample_source.h:68-83) ------------------------------------
class SdrppServerSource(SampleSource):
    """SDR++ server network client (plugins/sdr_sources/
    sdrpp_server_support/sdrpp_server/{server_protocol.h,
    sdrpp_server_client.cpp}).

    Wire format (all little-endian, packed):
      PacketHeader  { u32 type; u32 size /* incl. header */ }
      CommandHeader { u32 cmd }
    Client->server commands: SET_FREQUENCY(4)+f64, SET_SAMPLE_TYPE(6)+u8
    (0=i8 1=i16 2=f32), SET_COMPRESSION(7)+u8, START(2), STOP(3).
    Server->client: COMMAND packets carrying SET_SAMPLERATE(0x80)+f64,
    BASEBAND(2) packets with raw interleaved IQ in the negotiated PCM
    type, BASEBAND_COMPRESSED(3) = zstd (decoded when the zstd module is
    available, else skipped with a warning)."""

    source_type = "sdrpp"

    PKT_COMMAND, PKT_COMMAND_ACK, PKT_BASEBAND, PKT_BASEBAND_COMPRESSED, \
        PKT_VFO, PKT_FFT, PKT_ERROR = range(7)
    CMD_GET_UI, CMD_UI_ACTION, CMD_START, CMD_STOP, CMD_SET_FREQUENCY, \
        CMD_GET_SAMPLERATE, CMD_SET_SAMPLE_TYPE, CMD_SET_COMPRESSION = \
        range(8)
    CMD_SET_SAMPLERATE = 0x80
    CMD_DISCONNECT = 0x81

    def __init__(self, params=None):
        super().__init__(params)
        self.host = str(self.d_params.get("host", "127.0.0.1"))
        self.port = int(self.d_params.get("port", 5259))
        self.bit_depth = int(self.d_params.get("bit_depth", 16))
        self.compression = bool(self.d_params.get("compression", False))
        self._sock = None
        self._zstd_warned = False

    def _send_packet(self, ptype: int, payload: bytes) -> None:
        import struct
        hdr = struct.pack("<II", ptype, 8 + len(payload))
        self._sock.sendall(hdr + payload)

    def _send_command(self, cmd: int, data: bytes = b"") -> None:
        import struct
        self._send_packet(self.PKT_COMMAND, struct.pack("<I", cmd) + data)

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("sdrpp: connection closed")
            buf += chunk
        return buf

    def _recv_packet(self):
        import struct
        ptype, size = struct.unpack("<II", self._recv_exact(8))
        return ptype, self._recv_exact(size - 8)

    def open(self) -> None:
        import socket
        import struct
        self._sock = socket.create_connection((self.host, self.port),
                                              timeout=10)
        depth_to_pcm = {8: 0, 16: 1, 32: 2}
        self._send_command(self.CMD_SET_SAMPLE_TYPE,
                           bytes([depth_to_pcm[self.bit_depth]]))
        self._send_command(self.CMD_SET_COMPRESSION,
                           bytes([1 if self.compression else 0]))
        if self.frequency:
            self._send_command(self.CMD_SET_FREQUENCY,
                               struct.pack("<d", float(self.frequency)))

    def set_frequency(self, hz: float) -> None:
        import struct
        self.frequency = hz
        if self._sock is not None:
            self._send_command(self.CMD_SET_FREQUENCY,
                               struct.pack("<d", float(hz)))

    def start(self) -> None:
        self._send_command(self.CMD_START)
        super().start()

    def stop(self) -> None:
        if self._sock is not None:
            try:
                self._send_command(self.CMD_STOP)
            except OSError:
                pass
        super().stop()

    def _decode_baseband(self, data: bytes) -> np.ndarray:
        if self.bit_depth == 8:
            f = np.frombuffer(data, np.int8).astype(np.float32) / 128.0
        elif self.bit_depth == 16:
            f = np.frombuffer(data, np.int16).astype(np.float32) / 32768.0
        else:
            f = np.frombuffer(data, np.float32).copy()
        return (f[0::2] + 1j * f[1::2]).astype(np.complex64)

    def blocks(self) -> Iterator[np.ndarray]:
        import struct
        if self._sock is None:
            self.open()
        if not self.started:
            self.start()
        while True:
            try:
                ptype, payload = self._recv_packet()
            except (ConnectionError, OSError):
                return
            if ptype == self.PKT_BASEBAND:
                yield self._decode_baseband(payload)
            elif ptype == self.PKT_BASEBAND_COMPRESSED:
                try:
                    import zstandard
                    data = zstandard.ZstdDecompressor().decompress(
                        payload, max_output_size=1 << 24)
                    yield self._decode_baseband(data)
                except ImportError:
                    if not self._zstd_warned:
                        logger.warning("sdrpp: zstd unavailable, dropping "
                                       "compressed baseband")
                        self._zstd_warned = True
            elif ptype == self.PKT_COMMAND and len(payload) >= 4:
                cmd, = struct.unpack("<I", payload[:4])
                if cmd == self.CMD_SET_SAMPLERATE and len(payload) >= 12:
                    self.samplerate, = struct.unpack("<d", payload[4:12])
                    logger.info(f"sdrpp: server samplerate "
                                f"{self.samplerate:.0f}")
                elif cmd == self.CMD_DISCONNECT:
                    logger.warning("sdrpp: server asked to disconnect")
                    return

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None


source_registry: Dict[str, Callable[[dict], SampleSource]] = {}


class RegisterSampleSourcesEvent:
    def __init__(self, registry: dict):
        self.registry = registry


def register_source(cls) -> type:
    source_registry[cls.source_type] = cls
    return cls


register_source(FileSource)
register_source(RemoteSource)
register_source(RtlTcpSource)
register_source(SpyServerSource)
register_source(SdrppServerSource)


def get_source(descriptor: str | dict) -> SampleSource:
    """Build a source from a descriptor: a dict {type, ...}, or a spec
    string (file://path, tcp://host:port, plain path)."""
    if isinstance(descriptor, dict):
        t = descriptor.get("type", "file")
    else:
        s = str(descriptor)
        if s.startswith("tcp://"):
            host, port = s[6:].rsplit(":", 1)
            descriptor = {"type": "remote", "host": host, "port": int(port)}
            t = "remote"
        elif s.startswith("rtltcp://"):
            host, port = s[9:].rsplit(":", 1)
            descriptor = {"type": "rtltcp", "host": host, "port": int(port)}
            t = "rtltcp"
        elif s.startswith("spyserver://"):
            host, port = s[12:].rsplit(":", 1)
            descriptor = {"type": "spyserver", "host": host,
                          "port": int(port)}
            t = "spyserver"
        elif s.startswith("sdrpp://"):
            host, port = s[8:].rsplit(":", 1)
            descriptor = {"type": "sdrpp", "host": host, "port": int(port)}
            t = "sdrpp"
        else:
            descriptor = {"type": "file",
                          "path": s[7:] if s.startswith("file://") else s}
            t = "file"
    if t not in source_registry:
        ev = RegisterSampleSourcesEvent(source_registry)
        event_bus.fire_event(ev)
    if t not in source_registry:
        raise KeyError(f"no sample source '{t}'")
    return source_registry[t](descriptor)


def list_sources() -> List[str]:
    ev = RegisterSampleSourcesEvent(source_registry)
    event_bus.fire_event(ev)
    return sorted(source_registry)
