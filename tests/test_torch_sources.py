"""The port's sample sources, frame fan-in and UDP discovery against the
JAX package's, on localhost: each source reads a fake server's stream to
the samples the JAX source reads (equal arrays), rtl_tcp's command bytes
equal the reference client's (tests/test_live.py's fixture), the fan-in
emits every frame once, and discovery finds a server and ignores a wrong
request.
"""

import contextlib
import io
import json
import socket
import struct
import threading

import numpy as np
import pytest

from satdump_tpu.io import sources as jsrc
from satdump_tpu.io.discovery import UDPDiscoveryServer as JDiscServer
from satdump_tpu.io.fanin import publish_frames as jpublish
from satdump_tpu_torch import cli
from satdump_tpu_torch.io import net as tnet
from satdump_tpu_torch.io import sources as tsrc
from satdump_tpu_torch.io import write_baseband
from satdump_tpu_torch.io.discovery import (UDPDiscoveryConfig,
                                            UDPDiscoveryServer,
                                            discover_udp_servers)
from satdump_tpu_torch.io.fanin import FrameFanInServer, publish_frames


def _free_port(kind=socket.SOCK_STREAM) -> int:
    s = socket.socket(socket.AF_INET, kind)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _FakeServer:
    """One-client TCP server: `script(conn, server)` runs on the accepted
    socket, then the server ends its side and keeps everything the client
    sent, to its close, in `received`."""

    def __init__(self, script):
        self._srv = socket.socket()
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(1)
        self.port = self._srv.getsockname()[1]
        self.received = b""

        def run():
            c, _ = self._srv.accept()
            script(c, self)
            c.shutdown(socket.SHUT_WR)
            self.recv_exact(c, 1 << 30)
            c.close()

        self._t = threading.Thread(target=run)
        self._t.start()

    def recv_exact(self, c, n):
        while len(self.received) < n:
            chunk = c.recv(4096)
            if not chunk:
                break
            self.received += chunk

    def close(self):
        self._t.join(timeout=10)
        assert not self._t.is_alive()
        self._srv.close()


def _read_all(pkg, params, script):
    srv = _FakeServer(script)
    src = pkg.get_source(dict(params, port=srv.port))
    got = np.concatenate(list(src.blocks()))
    src.close()
    srv.close()
    return got, srv.received, src


def test_rtl_tcp_wire_fixture_and_stream(rng):
    """rtl_tcp (rtltcp_client.h:127-190): the 12-byte banner, then [u8
    cmd][u32 BE param] commands (1 freq, 2 samplerate, 3 gain mode, 4 gain)
    and a uint8 IQ stream read in blocks."""
    payload = rng.integers(0, 256, 2 * 3000, dtype=np.uint8).tobytes()

    def script(c, s):
        c.sendall(b"RTL0" + (1).to_bytes(4, "big") + (29).to_bytes(4, "big"))
        c.sendall(payload)

    params = {"type": "rtltcp", "host": "127.0.0.1", "samplerate": 2_048_000,
              "frequency": 137_100_000, "gain": 49.6, "block_size": 1000}
    got, cmds, src = _read_all(tsrc, params, script)
    assert cmds[0:5] == bytes([2]) + (2_048_000).to_bytes(4, "big")
    assert cmds[5:10] == bytes([1]) + (137_100_000).to_bytes(4, "big")
    assert cmds[10:15] == bytes([3]) + (1).to_bytes(4, "big")
    assert cmds[15:20] == bytes([4]) + (496).to_bytes(4, "big")
    assert (src.tuner_type, src.tuner_gain_count) == (1, 29)
    jgot, jcmds, _ = _read_all(jsrc, params, script)
    assert cmds == jcmds
    np.testing.assert_array_equal(got, jgot)
    assert len(got) == 3000


def test_spyserver_stream_matches_jax(rng):
    """SpyServer: HELLO, the device-info message, SET_SETTING commands and
    int16 / uint8 / float IQ messages."""
    iq16 = rng.integers(-30000, 30000, 400, dtype=np.int16).tobytes()
    iq8 = rng.integers(0, 256, 400, dtype=np.uint8).tobytes()
    iqf = rng.standard_normal(400).astype("<f4").tobytes()

    def msg(mtype, body):
        return struct.pack("<5I", 0, mtype, 0, 0, len(body)) + body

    def script(c, s):
        info = struct.pack("<12I", 1, 7, 10_000_000, 8_000_000, 8, 1, 20,
                           0, 2_000_000_000, 16, 0, 0)
        c.sendall(msg(0, info) + msg(101, iq16) + msg(100, iq8)
                  + msg(103, iqf) + msg(7, b"xx"))

    params = {"type": "spyserver", "host": "127.0.0.1",
              "samplerate": 2_500_000, "frequency": 137_100_000}
    got, sent, src = _read_all(tsrc, params, script)
    jgot, jsent, _ = _read_all(jsrc, params, script)
    assert sent == jsent and len(got) == 600
    np.testing.assert_array_equal(got, jgot)
    assert src.device_info["MaximumSampleRate"] == 10_000_000


def test_sdrpp_stream_matches_jax(rng):
    """SDR++ server: commands SET_SAMPLE_TYPE, SET_COMPRESSION,
    SET_FREQUENCY and START; a SET_SAMPLERATE command packet, then int16
    baseband packets, then DISCONNECT."""
    bodies = [rng.integers(-30000, 30000, 256, dtype=np.int16).tobytes()
              for _ in range(2)]

    def pkt(ptype, payload):
        return struct.pack("<II", ptype, 8 + len(payload)) + payload

    def script(c, s):
        c.sendall(pkt(0, struct.pack("<Id", 0x80, 2.4e6))
                  + b"".join(pkt(2, b) for b in bodies)
                  + pkt(0, struct.pack("<I", 0x81)))

    params = {"type": "sdrpp", "host": "127.0.0.1", "frequency": 137.1e6}
    got, sent, src = _read_all(tsrc, params, script)
    jgot, jsent, _ = _read_all(jsrc, params, script)
    assert sent == jsent and len(got) == 256
    np.testing.assert_array_equal(got, jgot)
    assert src.samplerate == 2.4e6


def test_remote_and_file_sources(tmp_path, rng):
    """`tcp://` gives the remote-IQ source, a path or `file://` the file
    player; both read what was sent, as the JAX sources do."""
    x = ((rng.standard_normal(5000) + 1j * rng.standard_normal(5000)) * 0.2
         ).astype(np.complex64)
    write_baseband(tmp_path / "x.cf32", "cf32", x)
    for spec in (str(tmp_path / "x.cf32"), f"file://{tmp_path / 'x.cf32'}"):
        src = tsrc.get_source(spec)
        src.block_size = 2048
        assert isinstance(src, tsrc.FileSource)
        np.testing.assert_array_equal(np.concatenate(list(src.blocks())), x)
    srv = tnet.RemoteIQServer(port=0, bit_depth=32)

    def serve():
        srv.wait_client(timeout=10)
        for off in range(0, len(x), 1000):
            srv.send_samples(x[off: off + 1000])
        srv.end()

    t = threading.Thread(target=serve)
    t.start()
    src = tsrc.get_source(f"tcp://127.0.0.1:{srv.port}")
    assert isinstance(src, tsrc.RemoteSource)
    got = np.concatenate(list(src.blocks()))
    src.close()
    t.join(timeout=10)
    srv.close()
    np.testing.assert_array_equal(got, x)
    for spec, kind in (("rtltcp://h:1", "rtltcp"), ("spyserver://h:2",
                       "spyserver"), ("sdrpp://h:3", "sdrpp")):
        assert tsrc.get_source(spec).source_type == kind
    assert tsrc.list_sources() == jsrc.list_sources()
    with pytest.raises(KeyError, match="no sample source"):
        tsrc.get_source({"type": "airspy"})


def test_registered_source_and_event():
    """A source registered by a plugin, or added by a handler of the
    registry event, is built by get_source."""
    from satdump_tpu_torch.core.events import event_bus

    class Fake(tsrc.SampleSource):
        source_type = "fake_test"

        def blocks(self):
            yield np.ones(4, np.complex64)

    def on_event(ev):
        ev.registry["fake_test"] = Fake

    event_bus.register_handler(tsrc.RegisterSampleSourcesEvent, on_event)
    try:
        src = tsrc.get_source({"type": "fake_test", "samplerate": 1e6})
        assert isinstance(src, Fake) and src.get_samplerate() == 1e6
        assert next(src.blocks()).shape == (4,)
        assert "fake_test" in tsrc.list_sources()
    finally:
        event_bus._handlers[tsrc.RegisterSampleSourcesEvent].remove(on_event)
        tsrc.source_registry.pop("fake_test")
    tsrc.register_source(Fake)
    assert tsrc.get_source({"type": "fake_test"}).source_type == "fake_test"
    tsrc.source_registry.pop("fake_test")


def _cadus(rng, n, vcid):
    cadus = np.zeros((n, 1024), np.uint8)
    cadus[:, 0:4] = [0x1A, 0xCF, 0xFC, 0x1D]
    cadus[:, 5] = vcid
    for i in range(n):
        cadus[i, 6:9] = [(i >> 16) & 0xFF, (i >> 8) & 0xFF, i & 0xFF]
        cadus[i, 10:] = rng.integers(0, 256, 1014)
    return cadus


def test_frame_fanin_dedup(rng):
    """Three sites publish overlapping, gappy CADU streams (one through
    the JAX package's publisher: the same wire); the fan-in emits every
    frame exactly once and counts the duplicates."""
    n = 60
    cadus = _cadus(rng, n, 1)
    keep = rng.random(n) < 0.5
    sites = ((publish_frames, cadus[: 2 * n // 3]),
             (jpublish, cadus[n // 3:]), (publish_frames, cadus[keep]))
    srv = FrameFanInServer(port=0)
    srv.start(n_publishers=3)
    threads = [threading.Thread(target=fn, args=("127.0.0.1", srv.port, c))
               for fn, c in sites]
    for t in threads:
        t.start()
    got = list(srv.frames(timeout=10))
    for t in threads:
        t.join(timeout=10)
    srv.close()
    assert len(got) == n
    assert sorted(int.from_bytes(g[6:9].tobytes(), "big") for g in got) == \
        list(range(n))
    sent = sum(len(c) for _, c in sites)
    assert srv.stats == {"received": sent, "emitted": n,
                         "duplicates": sent - n, "publishers": 3}


def test_cli_fanin(tmp_path, rng):
    """`fanin` merges two site streams: its JSON lines and the merged
    file."""
    n = 20
    cadus = _cadus(rng, n, 2)
    out = tmp_path / "merged.cadu"
    port = _free_port()
    buf = io.StringIO()

    def run():
        with contextlib.redirect_stdout(buf):
            rc.append(cli.main(["fanin", str(out), "--publishers", "2",
                                "--host", "127.0.0.1", "--port", str(port)]))

    rc = []
    t = threading.Thread(target=run)
    t.start()
    for part in (cadus[:15], cadus[5:]):
        publish_frames("127.0.0.1", port, part)
    t.join(timeout=30)
    assert rc == [0]
    lines = [json.loads(s) for s in buf.getvalue().strip().splitlines()]
    assert lines[0] == {"port": port}
    assert lines[1]["frames"] == n and lines[1]["stats"]["duplicates"] == 10
    got = np.fromfile(out, np.uint8).reshape(-1, 1024)
    assert sorted(int(g[8]) for g in got) == list(range(n))


@pytest.mark.parametrize("server_cls", [UDPDiscoveryServer, JDiscServer])
def test_udp_discovery(server_cls):
    """The port's client finds a server (its own or the JAX package's) and
    ignores replies to another request."""
    req = rep = _free_port(socket.SOCK_DGRAM)
    while rep == req:
        rep = _free_port(socket.SOCK_DGRAM)
    cfg = UDPDiscoveryConfig(req_port=req, rep_port=rep,
                             req_pkt=b"SATDUMP_REMOTE?",
                             rep_pkt=b"SATDUMP_REMOTE!", discover_port=5656)
    bad = UDPDiscoveryConfig(req_port=req, rep_port=rep, req_pkt=b"EVIL",
                             rep_pkt=b"SATDUMP_REMOTE!", discover_port=5656)
    with server_cls(cfg):
        assert discover_udp_servers(bad, wait_ms=300,
                                    address="127.0.0.1") == []
        found = discover_udp_servers(cfg, wait_ms=800, address="127.0.0.1")
    assert found == [("127.0.0.1", 5656)]
