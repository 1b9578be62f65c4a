"""Network frame transport (host side) for the network_server and
network_client modules.

* stream framing: 1-byte accept (0xFF) / refuse (0x00) on connect, then
  [u32 BE length][payload] packets
  (plugins/sdr_sources/remote_sdr_support/tcp_proto.h:118-139, 220-233);
* frame pub: fixed pkt_size datagrams over UDP or the framed TCP stream
  (pipeline/modules/network/module_network_server.cpp:58-100; we use our
  TCP framing where the reference uses nng pub/sub).

The part of satdump_tpu/io/net.py that those modules use, copied. The
remote-SDR IQ packets and IQ client/server come with the live slice.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Optional

ACCEPT = b"\xff"
REFUSE = b"\x00"


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
