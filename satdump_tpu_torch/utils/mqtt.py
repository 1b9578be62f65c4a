"""Minimal MQTT 3.1.1 client (QoS 0 publish + subscribe).

Reference: src-core/utils/mqtt_client.h (vendored mqttc used to publish
module stats). From-scratch packet encoding of CONNECT/CONNACK/PUBLISH/
SUBSCRIBE/SUBACK/PINGREQ/DISCONNECT — enough for the stats-sink role."""

from __future__ import annotations

import socket
import struct
from typing import Callable, Optional, Tuple


def _encode_len(n: int) -> bytes:
    out = bytearray()
    while True:
        d = n % 128
        n //= 128
        out.append(d | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _decode_len(sock) -> int:
    mult, val = 1, 0
    while True:
        (b,) = sock.recv(1)
        val += (b & 0x7F) * mult
        if not b & 0x80:
            return val
        mult *= 128


def _str(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">H", len(b)) + b


class MQTTClient:
    def __init__(self, host: str, port: int = 1883,
                 client_id: str = "satdump_tpu", timeout: float = 10.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        var = _str("MQTT") + bytes([4, 0x02]) + struct.pack(">H", 60)
        payload = _str(client_id)
        pkt = bytes([0x10]) + _encode_len(len(var) + len(payload)) \
            + var + payload
        self._sock.sendall(pkt)
        typ, body = self._read_packet()
        if typ != 0x20 or body[1] != 0:
            raise ConnectionError(f"MQTT CONNACK refused: {body!r}")
        self._pid = 0

    def _read_packet(self) -> Tuple[int, bytes]:
        (h,) = self._sock.recv(1)
        n = _decode_len(self._sock)
        body = b""
        while len(body) < n:
            chunk = self._sock.recv(n - len(body))
            if not chunk:
                break
            body += chunk
        return h & 0xF0, body

    def publish(self, topic: str, payload: bytes | str) -> None:
        if isinstance(payload, str):
            payload = payload.encode()
        var = _str(topic)
        pkt = bytes([0x30]) + _encode_len(len(var) + len(payload)) \
            + var + payload
        self._sock.sendall(pkt)

    def subscribe(self, topic: str) -> None:
        self._pid += 1
        var = struct.pack(">H", self._pid) + _str(topic) + bytes([0])
        pkt = bytes([0x82]) + _encode_len(len(var)) + var
        self._sock.sendall(pkt)
        typ, _ = self._read_packet()
        if typ != 0x90:
            raise ConnectionError("MQTT SUBACK missing")

    def recv_publish(self) -> Optional[Tuple[str, bytes]]:
        typ, body = self._read_packet()
        if typ != 0x30:
            return None
        (tl,) = struct.unpack(">H", body[:2])
        topic = body[2: 2 + tl].decode()
        return topic, body[2 + tl:]

    def ping(self) -> None:
        self._sock.sendall(bytes([0xC0, 0]))

    def disconnect(self) -> None:
        try:
            self._sock.sendall(bytes([0xE0, 0]))
        finally:
            self._sock.close()
