"""UDP service discovery for remote SDR servers.

Wire-compatible with the reference's scheme (plugins/sdr_sources/
remote_sdr_support/udp_discovery.cpp:92-250): the server listens on
`req_port`; clients broadcast `req_pkt`; on an exact match the server
replies to the sender on `rep_port` with `rep_pkt` + the service's TCP
port as a big-endian u32. `discover_udp_servers` collects (ip, port)
pairs for `wait_ms`.

A copy of satdump_tpu/io/discovery.py, its imports rewritten to the port.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import List, Tuple

from satdump_tpu_torch.core.log import logger


@dataclass
class UDPDiscoveryConfig:
    req_port: int
    rep_port: int
    req_pkt: bytes
    rep_pkt: bytes
    discover_port: int = 0


class UDPDiscoveryServer:
    """Replies to matching discovery broadcasts with rep_pkt + service
    port (ref UDPDiscoveryServerRunner). Use as a context manager or call
    stop()."""

    def __init__(self, cfg: UDPDiscoveryConfig):
        self.cfg = cfg
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("", cfg.req_port))
        self._sock.settimeout(0.2)
        self._run = True
        self._th = threading.Thread(target=self._loop, daemon=True)
        self._th.start()

    def _loop(self):
        rep = self.cfg.rep_pkt + struct.pack(">I", self.cfg.discover_port)
        while self._run:
            try:
                data, addr = self._sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            if data == self.cfg.req_pkt:
                out = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                out.sendto(rep, (addr[0], self.cfg.rep_port))
                out.close()
                logger.debug(f"discovery: replied to {addr[0]}")

    def stop(self):
        self._run = False
        self._th.join(timeout=1.0)
        self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def discover_udp_servers(cfg: UDPDiscoveryConfig, wait_ms: int = 500,
                         address: str = "<broadcast>"
                         ) -> List[Tuple[str, int]]:
    """Broadcast req_pkt, collect (server_ip, service_port) replies
    (ref discoverUDPServers). `address` overrides the broadcast target
    (e.g. a unicast host, or 127.0.0.1 under test)."""
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    rx.bind(("", cfg.rep_port))
    rx.settimeout(wait_ms / 1000.0)

    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    if address == "<broadcast>":
        tx.setsockopt(socket.SOL_SOCKET, socket.SO_BROADCAST, 1)
    tx.sendto(cfg.req_pkt, (address, cfg.req_port))
    tx.close()

    servers: List[Tuple[str, int]] = []
    deadline = time.monotonic() + wait_ms / 1000.0
    want = len(cfg.rep_pkt) + 4
    while time.monotonic() < deadline:
        try:
            data, addr = rx.recvfrom(65536)
        except socket.timeout:
            break
        if len(data) == want and data[:len(cfg.rep_pkt)] == cfg.rep_pkt:
            port = struct.unpack(">I", data[len(cfg.rep_pkt):])[0]
            if (addr[0], port) not in servers:
                servers.append((addr[0], port))
    rx.close()
    return servers
