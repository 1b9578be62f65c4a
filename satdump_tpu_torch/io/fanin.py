"""Multi-host frame fan-in: merge CADU streams from N receive sites.

SURVEY §5 long-context territory with no reference counterpart: a
production deployment points several geographically-separate receivers at
the same downlink and wants ONE best stream. Each site publishes its
decoded CADUs over the framed-TCP transport (io/net.py, the
network_server module); this server accepts all of them and emits a
single merged stream, deduplicated and ordered by the (VCID,
VCDU-counter) sequence every CCSDS AOS frame already carries — frames
one site dropped in a fade are filled from another.

Merging policy (per VCID): a frame is emitted the first time any site
delivers its counter; counters are tracked modulo 2^24 with a reordering
window, so late duplicates from slow sites are discarded and a bounded
amount of out-of-order arrival is tolerated.

    srv = FrameFanInServer(port=0, cadu_size=1024)
    srv.start(n_publishers=3)
    for cadu in srv.frames():  # merged, deduplicated
        ...

A copy of satdump_tpu/io/fanin.py, its imports rewritten to the port.
"""

from __future__ import annotations

import queue
import socket
import threading
from typing import Dict, Iterator, Optional, Set

import numpy as np

from satdump_tpu_torch.core.log import logger
from satdump_tpu_torch.io.net import _recv_frame

_CTR_MOD = 1 << 24
_WINDOW = 1 << 16          # dedup window (counters), per VCID


class _VcidState:
    def __init__(self):
        self.seen: Set[int] = set()
        self.max_ctr: Optional[int] = None


class FrameFanInServer:
    """Accept framed-TCP CADU publishers on one port; yield the merged
    deduplicated stream."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 cadu_size: int = 1024):
        self.cadu_size = cadu_size
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self._q: "queue.Queue[Optional[bytes]]" = queue.Queue(maxsize=4096)
        self._vcids: Dict[int, _VcidState] = {}
        self._threads = []
        self._live_publishers = 0
        self._lock = threading.Lock()
        self._accepting = True
        self.stats = {"received": 0, "emitted": 0, "duplicates": 0,
                      "publishers": 0}

    # -- publisher side ------------------------------------------------------
    def start(self, n_publishers: int) -> None:
        """Accept exactly n publishers (each a framed-TCP client sending
        one CADU per frame), then merge until all disconnect."""
        def acceptor():
            for _ in range(n_publishers):
                try:
                    c, addr = self._sock.accept()
                except OSError:
                    return
                from satdump_tpu_torch.io.net import ACCEPT
                try:
                    c.sendall(ACCEPT)   # framed-transport handshake
                except OSError:
                    c.close()
                    continue
                with self._lock:
                    self._live_publishers += 1
                    self.stats["publishers"] += 1
                t = threading.Thread(target=self._pump, args=(c,),
                                     daemon=True)
                t.start()
                self._threads.append(t)

        t = threading.Thread(target=acceptor, daemon=True)
        t.start()
        self._threads.append(t)
        self._expected = n_publishers

    def _pump(self, conn: socket.socket) -> None:
        try:
            while True:
                pkt = _recv_frame(conn)
                if pkt is None:
                    break
                if len(pkt) != self.cadu_size:
                    continue
                self._offer(pkt)
        finally:
            conn.close()
            done = False
            with self._lock:
                self._live_publishers -= 1
                done = (self._live_publishers == 0
                        and self.stats["publishers"] >= self._expected)
            if done:
                self._q.put(None)

    # -- merge core ----------------------------------------------------------
    def _offer(self, cadu: bytes) -> None:
        with self._lock:
            self.stats["received"] += 1
            vcid = cadu[5] & 0x3F
            ctr = (cadu[6] << 16) | (cadu[7] << 8) | cadu[8]
            st = self._vcids.setdefault(vcid, _VcidState())
            if ctr in st.seen:
                self.stats["duplicates"] += 1
                return
            st.seen.add(ctr)
            if len(st.seen) > _WINDOW:     # bound memory: forget old ctrs
                if st.max_ctr is not None:
                    lo = (st.max_ctr - _WINDOW) % _CTR_MOD
                    st.seen = {c for c in st.seen
                               if (st.max_ctr - c) % _CTR_MOD < _WINDOW}
            if st.max_ctr is None or \
                    (ctr - st.max_ctr) % _CTR_MOD < _CTR_MOD // 2:
                st.max_ctr = ctr
            self.stats["emitted"] += 1
        self._q.put(cadu)

    # -- consumer side -------------------------------------------------------
    def frames(self, timeout: float = 30.0) -> Iterator[np.ndarray]:
        while True:
            try:
                pkt = self._q.get(timeout=timeout)
            except queue.Empty:
                logger.warning("fan-in: timed out waiting for frames")
                return
            if pkt is None:
                return
            yield np.frombuffer(pkt, np.uint8)

    def close(self) -> None:
        self._accepting = False
        try:
            self._sock.close()
        except OSError:
            pass


def publish_frames(host: str, port: int, cadus: np.ndarray,
                   cadu_size: int = 1024) -> int:
    """Site-side helper: push a CADU array to a fan-in server over the
    framed transport. Returns frames sent."""
    from satdump_tpu_torch.io.net import FramedTCPClient
    c = FramedTCPClient(host, port)
    data = np.asarray(cadus, np.uint8).reshape(-1, cadu_size)
    for fr in data:
        c.send(fr.tobytes())
    c.close()
    return len(data)
