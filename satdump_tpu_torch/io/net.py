"""Network IQ / frame transport (host side): the reference's remote-SDR
wire protocol, so a stock SatDump remote server or client interoperates,
and the frame transport of the network_server and network_client modules.

* stream framing: 1-byte accept (0xFF) / refuse (0x00) on connect, then
  [u32 BE length][payload] packets
  (plugins/sdr_sources/remote_sdr_support/tcp_proto.h:118-139, 220-233);
* IQ packets: [u8 bit_depth][f32 LE scale][i32 LE nsamples][interleaved
  int8/int16 scaled IQ, or raw complex64]
  (remote_sdr_support/iq_pkt.h:11-68, the ZIQ2-style block), sent after a
  [u8 PKTType] byte (remote.h:76-83);
* frame pub: fixed pkt_size datagrams over UDP or the framed TCP stream
  (pipeline/modules/network/module_network_server.cpp:58-100; we use our
  TCP framing where the reference uses nng pub/sub).

A copy of satdump_tpu/io/net.py with one divergence: RemoteIQClient
accepts a bare (untyped) IQ payload only from a peer that has not sent a
typed packet, so a modern peer's PKT_TYPE_SOURCESTOP (type 8, also a bit
depth) is dropped instead of decoded as samples.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Iterator, Optional

import numpy as np

ACCEPT = b"\xff"
REFUSE = b"\x00"

# packet type ids (remote_sdr_support/remote.h:58-73 PKTType)
PKT_TYPE_PING = 0
PKT_TYPE_SOURCELIST = 1
PKT_TYPE_SOURCEOPEN = 2
PKT_TYPE_SOURCECLOSE = 3
PKT_TYPE_GUI = 4
PKT_TYPE_IQ = 5
PKT_TYPE_SAMPLERATEFBK = 6
PKT_TYPE_SOURCESTART = 7
PKT_TYPE_SOURCESTOP = 8
PKT_TYPE_SETFREQ = 9
PKT_TYPE_SETSETTINGS = 10
PKT_TYPE_GETSETTINGS = 11
PKT_TYPE_SAMPLERATESET = 12
PKT_TYPE_BITDEPTHSET = 13
_BIT_DEPTHS = (8, 16, 32)


# ---------------------------------------------------------------------------
# IQ packet codec (iq_pkt.h)
# ---------------------------------------------------------------------------
def encode_iq_pkt(samples: np.ndarray, bit_depth: int = 8) -> bytes:
    """complex64 samples -> IQ packet payload."""
    samples = np.asarray(samples, np.complex64)
    n = len(samples)
    flat = samples.view(np.float32)
    if bit_depth == 32:
        scale = 0.0
        body = flat.tobytes()
    else:
        peak = float(np.max(np.abs(samples))) if n else 1.0
        peak = max(peak, 1e-12)
        scale = (127.0 if bit_depth == 8 else 32767.0) / peak
        # round-to-nearest like volk_32f_s32f_convert_* (a plain astype
        # truncates toward zero — a systematic half-LSB bias off the wire)
        q = np.round(np.clip(flat * scale, -scale * peak, scale * peak))
        body = q.astype(np.int8 if bit_depth == 8 else np.int16).tobytes()
    hdr = struct.pack("<Bfi", bit_depth, scale, n)
    return hdr + body


def decode_iq_pkt(payload: bytes) -> np.ndarray:
    """IQ packet payload -> complex64 samples."""
    bit_depth, scale, n = struct.unpack("<Bfi", payload[:9])
    body = payload[9:]
    if bit_depth == 32:
        return np.frombuffer(body, np.complex64, count=n)
    dt = np.int8 if bit_depth == 8 else np.int16
    flat = (np.frombuffer(body, dt, count=2 * n).astype(np.float32)
            / scale)
    return flat.view(np.complex64)


class FramedTCPServer:
    """Single-client framed TCP server with the 0xFF/0x00 handshake."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(2)
        self.port = self._srv.getsockname()[1]
        self._client: Optional[socket.socket] = None
        self._lock = threading.Lock()

    def wait_client(self, timeout: Optional[float] = None) -> None:
        self._srv.settimeout(timeout)
        sock, _ = self._srv.accept()
        with self._lock:
            if self._client is not None:
                sock.sendall(REFUSE)
                sock.close()
                return
            sock.sendall(ACCEPT)
            self._client = sock

    def send(self, payload: bytes) -> None:
        with self._lock:
            if self._client is None:
                return
            hdr = struct.pack(">I", len(payload))
            try:
                self._client.sendall(hdr + payload)
            except OSError:
                self._client.close()
                self._client = None

    def recv(self) -> Optional[bytes]:
        if self._client is None:
            return None
        return _recv_frame(self._client)

    def close(self) -> None:
        with self._lock:
            if self._client is not None:
                self._client.close()
                self._client = None
        self._srv.close()


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> Optional[bytes]:
    hdr = _recv_exact(sock, 4)
    if hdr is None:
        return None
    (length,) = struct.unpack(">I", hdr)
    return _recv_exact(sock, length)


class FramedTCPClient:
    def __init__(self, host: str, port: int, timeout: float = 10.0):
        # retry while the server's listener comes up (live startup race)
        import time
        deadline = time.monotonic() + timeout
        while True:
            try:
                self._sock = socket.create_connection(
                    (host, port), timeout=timeout)
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.05)
        status = _recv_exact(self._sock, 1)
        if status != ACCEPT:
            self._sock.close()
            raise ConnectionRefusedError(
                "remote server refused (already has a client)")

    def send(self, payload: bytes) -> None:
        self._sock.sendall(struct.pack(">I", len(payload)) + payload)

    def recv(self) -> Optional[bytes]:
        return _recv_frame(self._sock)

    def close(self) -> None:
        self._sock.close()


# ---------------------------------------------------------------------------
# IQ sources/sinks for the live pipeline
# ---------------------------------------------------------------------------
class RemoteIQClient:
    """Connects to a remote IQ server and yields complex64 blocks."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self._c = FramedTCPClient(host, port, timeout)
        self.packets = 0
        self.decode_s = 0.0       # host time in decode_iq_pkt

    @property
    def stats(self) -> dict:
        return {"packets": self.packets, "decode_s": self.decode_s}

    def _decode(self, payload: bytes) -> np.ndarray:
        t = time.perf_counter()
        out = decode_iq_pkt(payload)
        self.decode_s += time.perf_counter() - t
        self.packets += 1
        return out

    def blocks(self) -> Iterator[np.ndarray]:
        # reference wire: [u8 PKTType][packet body] (remote.h:76-83
        # sendPacketWithVector); non-IQ control packets are ignored. Bare IQ
        # payloads (no type byte) from older peers parse while the peer has
        # sent no typed packet: their first byte is a bit depth (8, 16,
        # 32), never PKT_TYPE_IQ = 5, but 8 is PKT_TYPE_SOURCESTOP too.
        typed = False
        while True:
            payload = self._c.recv()
            if payload is None or len(payload) == 0:
                return
            kind = payload[0]
            if kind == PKT_TYPE_IQ:
                typed = True
                yield self._decode(payload[1:])
            elif kind in _BIT_DEPTHS and not typed:
                yield self._decode(payload)
            elif kind <= PKT_TYPE_BITDEPTHSET:
                typed = True

    def close(self) -> None:
        self._c.close()


class RemoteIQServer:
    """Serves complex64 blocks to one client (the headless `remote server`
    role: any local source -> network, remote_sdr_support/server/)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 bit_depth: int = 8):
        self._s = FramedTCPServer(port, host)
        self.port = self._s.port
        self.bit_depth = bit_depth

    def wait_client(self, timeout: Optional[float] = None) -> None:
        self._s.wait_client(timeout)

    def send_samples(self, samples: np.ndarray) -> None:
        self.send_pkt(encode_iq_pkt(samples, self.bit_depth))

    def send_pkt(self, pkt: bytes) -> None:
        """Send one IQ packet already made by encode_iq_pkt."""
        self._s.send(bytes([PKT_TYPE_IQ]) + pkt)

    def end(self) -> None:
        self._s.send(b"")

    def close(self) -> None:
        self._s.close()


# ---------------------------------------------------------------------------
# Frame pub/sub (network_server / network_client module transport)
# ---------------------------------------------------------------------------
class UDPFrameSender:
    def __init__(self, host: str, port: int):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._addr = (host, port)

    def send(self, pkt: bytes) -> None:
        self._sock.sendto(pkt, self._addr)

    def close(self) -> None:
        self._sock.close()


class UDPFrameReceiver:
    def __init__(self, port: int, host: str = "127.0.0.1",
                 timeout: float = 5.0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((host, port))
        self._sock.settimeout(timeout)
        self.port = self._sock.getsockname()[1]

    def recv(self, pkt_size: int) -> Optional[bytes]:
        try:
            data, _ = self._sock.recvfrom(max(pkt_size, 65536))
            return data
        except socket.timeout:
            return None

    def close(self) -> None:
        self._sock.close()
