"""Rotator control over the rotctld TCP protocol.

Reference: src-core/common/tracking/rotator/rotcl_handler.{h,cpp} — a
hamlib NET rotctl client speaking the line protocol: `p\\n` reads
(azimuth, elevation), `P az el\\n` slews, `S\\n` stops; replies are value
lines or `RPRT n` status codes.

A copy of satdump_tpu/tracking/rotator.py, its imports rewritten to the port.
"""

from __future__ import annotations

import socket
import threading
from typing import Optional, Tuple


class RotctlClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 4533,
                 timeout: float = 5.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._f = self._sock.makefile("rwb")

    def _cmd(self, line: str, reply_lines: int) -> list:
        self._f.write((line + "\n").encode())
        self._f.flush()
        return [self._f.readline().decode().strip()
                for _ in range(reply_lines)]

    def get_pos(self) -> Tuple[float, float]:
        az, el = self._cmd("p", 2)
        return float(az), float(el)

    def set_pos(self, az: float, el: float) -> bool:
        (r,) = self._cmd(f"P {az:.2f} {el:.2f}", 1)
        return r.startswith("RPRT 0")

    def stop(self) -> bool:
        (r,) = self._cmd("S", 1)
        return r.startswith("RPRT 0")

    def close(self) -> None:
        self._f.close()
        self._sock.close()


class MockRotctld:
    """In-process rotctld server (tests + dry runs): tracks the commanded
    position, answers the hamlib line protocol."""

    def __init__(self, port: int = 0):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", port))
        self._srv.listen(1)
        self.port = self._srv.getsockname()[1]
        self.az = 0.0
        self.el = 0.0
        self.stopped = False
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        try:
            conn, _ = self._srv.accept()
        except OSError:
            return
        f = conn.makefile("rwb")
        while True:
            line = f.readline()
            if not line:
                break
            parts = line.decode().strip().split()
            if not parts:
                continue
            if parts[0] == "p":
                f.write(f"{self.az:.6f}\n{self.el:.6f}\n".encode())
            elif parts[0] == "P" and len(parts) == 3:
                self.az, self.el = float(parts[1]), float(parts[2])
                f.write(b"RPRT 0\n")
            elif parts[0] == "S":
                self.stopped = True
                f.write(b"RPRT 0\n")
            else:
                f.write(b"RPRT -1\n")
            f.flush()
        conn.close()

    def close(self) -> None:
        self._srv.close()
