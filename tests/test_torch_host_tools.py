"""The port's host tools against satdump_tpu's, on the CPU, bit for bit:
BitView (its transforms, raster, period and CLI), the MPEG-TS tools
(TSDemux, MPE, Fazzt), the soft2hard / hard2soft and xRIT network modules,
the constellations and TX modulators, and the MQTT client, webhook sink
and framework boot."""

import json
import socket
import threading
import time

import numpy as np
import pytest

from satdump_tpu.utils import bitview as jbv
from satdump_tpu.utils import mpeg_ts as jts
from satdump_tpu_torch.utils import bitview as tbv
from satdump_tpu_torch.utils import mpeg_ts as tts


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a, b)


def _cadu_stream(rng, n_frames=48, frame_bytes=128):
    frames = rng.integers(0, 256, (n_frames, frame_bytes), dtype=np.uint8)
    frames[:, 0:4] = [0x1A, 0xCF, 0xFC, 0x1D]
    frames[:, 5] = (np.arange(n_frames) % 3) + 1
    return frames.reshape(-1)


def test_bitview_transforms_and_period(rng):
    raw = _cadu_stream(rng)
    bits = np.unpackbits(raw)
    for fn, args in ((tbv.diff_decode, ()), (tbv.reverse_bits, ()),
                     (tbv.deinterleave, (4,)), (tbv.take_skip, (3, 2, 1)),
                     (tbv.soft_to_hard, ())):
        src = raw if fn is tbv.soft_to_hard else bits
        _same(getattr(jbv, fn.__name__)(src, *args), fn(src, *args))
    assert tbv.estimate_period(bits) == jbv.estimate_period(bits)
    assert tbv.estimate_period(bits)[0] == 128 * 8
    _same(jbv.render_raster(bits, 1024), tbv.render_raster(bits, 1024))
    jv, tv = jbv.vcid_split(raw, 128), tbv.vcid_split(raw, 128)
    assert sorted(jv) == sorted(tv) == [1, 2, 3]
    for k in tv:
        _same(jv[k], tv[k])
    pkts = [bytes([0x08, 0x01, 0, 0, 0, 1, 9]), b"\x00",
            bytes([0x0B, 0xFF, 0, 0, 0, 1, 9])]
    assert tbv.apid_demux(pkts) == jbv.apid_demux(pkts)


def test_bitview_on_instrument_cadus():
    """CADUs carrying AVHRR/3 packets, as a MetOp .cadu holds them: both
    packages find the same period (the pixels' own 50-bit structure
    outweighs the frame's ASM: ROADMAP §3 S8), and at the frame length
    every raster row starts with the ASM."""
    from satdump_tpu_torch import sim
    cadus, _ = sim.metop_instrument_cadus(np.random.default_rng(5), 64, 4)
    bits = np.unpackbits(cadus.reshape(-1))
    assert tbv.estimate_period(bits) == jbv.estimate_period(bits)
    raster = tbv.render_raster(bits, 8192)
    _same(raster, jbv.render_raster(bits, 8192))
    asm = np.unpackbits(np.array([0x1A, 0xCF, 0xFC, 0x1D], np.uint8))
    assert (raster[:, :32] == asm * 255).all()


@pytest.mark.parametrize("opts", [[], ["--soft"], ["--diff", "--reverse"],
                                  ["--period", "640"]])
def test_bitview_cli(tmp_path, rng, opts):
    from satdump_tpu.cli import main as jmain
    from satdump_tpu_torch.cli import main as tmain
    from satdump_tpu_torch.image.io import load_img
    raw = _cadu_stream(rng, 64, 64)
    if "--soft" in opts:     # one signed soft byte a bit
        raw = (np.unpackbits(raw).astype(np.int16) * 200 - 100).astype(
            np.int8).view(np.uint8)
    p = tmp_path / "stream.bin"
    raw.tofile(p)
    for main, name in ((jmain, "j.png"), (tmain, "t.png")):
        assert main(["bitview", str(p), "-o", str(tmp_path / name),
                     *opts]) == 0
    a, b = load_img(tmp_path / "j.png"), load_img(tmp_path / "t.png")
    _same(a, b)
    if not opts or opts == ["--soft"]:
        assert b.shape[1] == 512                    # the 64-byte frames


def _ts_pkt(pid, pusi, cont, data, afc=1):
    p = np.full(188, 0xFF, np.uint8)
    p[0] = 0x47
    p[1] = (pusi << 6) | (pid >> 8)
    p[2] = pid & 0xFF
    p[3] = (afc << 4) | (cont & 0xF)
    off = 4
    if afc & 2:
        p[4] = 3
        off = 8
    p[off: off + len(data)] = data
    return p


def test_ts_demux_mpe_and_fazzt(rng):
    payload = rng.integers(0, 256, 500, dtype=np.uint8)
    ts = np.stack([
        _ts_pkt(0x155, 1, 0, payload[:184]),
        _ts_pkt(0x300, 0, 0, rng.integers(0, 256, 184, dtype=np.uint8)),
        _ts_pkt(0x155, 0, 1, payload[184:364], afc=3),
        _ts_pkt(0x155, 0, 2, payload[364:]),
        _ts_pkt(0x155, 1, 3, payload[:100])])
    ts[1, 1] |= 0x80                                   # TEI: dropped
    jh, th = jts.parse_ts_headers(ts), tts.parse_ts_headers(ts)
    assert sorted(jh) == sorted(th)
    for k in th:
        _same(jh[k], th[k])
    for pid in (0x155, -1):
        jd, td = jts.TSDemux(pid), tts.TSDemux(pid)
        assert jd.work(ts) + jd.flush() == td.work(ts) + td.flush()
    ip = bytearray(20)
    ip[0] = 0x45
    ip[2:4] = (20 + 16).to_bytes(2, "big")
    ip[9] = 17
    ip[12:20] = bytes([10, 0, 0, 1, 239, 1, 2, 3])
    dgram = bytes(ip) + b"hello-geonetcast"
    sec_len = 9 + len(dgram) + 4
    sec = bytes([0x3E, 0xB0 | (sec_len >> 8), sec_len & 0xFF]) + bytes(
        range(1, 10)) + dgram + b"\x00" * 4
    a, b = jts.mpe_extract_ip(sec), tts.mpe_extract_ip(sec)
    assert b[2] == b"hello-geonetcast" and b[1].target_ip == (239, 1, 2, 3)
    assert (vars(a[0]), vars(a[1]), a[2]) == (vars(b[0]), vars(b[1]), b[2])
    assert tts.mpe_extract_ip(sec[:20]) is None
    # Fazzt: head, parts out of order, tail
    P = 64
    data = bytes(rng.integers(0, 256, 3 * P - 17, dtype=np.uint8))
    head = bytearray(1431)
    head[1], head[2:4], head[4:8] = 0x03, (8).to_bytes(2, "little"), \
        (7).to_bytes(4, "little")
    head[72:74] = (3).to_bytes(2, "little")
    head[84:84 + 9] = b"test1.bin"
    head[84 + 9 + 56: 84 + 9 + 60] = len(data).to_bytes(4, "little")
    frames = [bytes(head)]
    for part in (2, 0, 1):
        f = bytearray(16)
        f[1], f[2:4], f[4:8] = 0x01, (8).to_bytes(2, "little"), \
            (7).to_bytes(4, "little")
        f[8:10] = part.to_bytes(2, "little")
        frames.append(bytes(f) + data[part * P: (part + 1) * P])
    tail = bytearray(16)
    tail[1], tail[2:4], tail[4:8] = 0xFF, (8).to_bytes(2, "little"), \
        (7).to_bytes(4, "little")
    frames.append(bytes(tail))
    jp, tp = jts.FazztProcessor(P, clock=lambda: 0.0), \
        tts.FazztProcessor(P, clock=lambda: 0.0)
    jo = [f for fr in frames for f in jp.work(fr)]
    to = [f for fr in frames for f in tp.work(fr)]
    assert [vars(f) for f in jo] == [vars(f) for f in to]
    assert to[0].name == "test1.bin" and bytes(to[0].data) == data


def test_soft2hard_hard2soft(tmp_path, rng):
    from satdump_tpu.pipeline.modules import convert as jconv
    from satdump_tpu_torch.pipeline.modules import convert as tconv
    soft = rng.integers(-100, 100, 8000).astype(np.int8)
    p = tmp_path / "x.soft"
    soft.tofile(p)
    outs = {}
    for name, m in (("j", jconv), ("t", tconv)):
        s2h = m.Soft2HardModule(str(p), str(tmp_path / f"{name}1"), {})
        s2h.process()
        h2s = m.Hard2SoftModule(s2h.d_output_file, str(tmp_path / f"{name}2"),
                                {})
        h2s.process()
        outs[name] = (s2h, h2s)
    for k in (0, 1):
        assert outs["j"][k].stats == outs["t"][k].stats
        assert open(outs["j"][k].d_output_file, "rb").read() == \
            open(outs["t"][k].d_output_file, "rb").read()
    _same(np.fromfile(outs["t"][1].d_output_file, np.int8) > 0, soft > 0)
    _same(tconv.read_soft_symbols(str(p)), jconv.read_soft_symbols(str(p)))
    h = outs["t"][0].d_output_file
    _same(tconv.read_soft_symbols(h, False), jconv.read_soft_symbols(h, False))


def _s2udp_ts(rng, pid, n=3):
    cadus = rng.integers(0, 256, (n, 1024), dtype=np.uint8)
    cadus[:, :4] = [0x1A, 0xCF, 0xFC, 0x1D]
    pkts, cc = [], 0
    for cadu in cadus:
        payload = bytes(40) + bytes(cadu)      # MPE + IP + UDP headers
        for k, off in enumerate(range(0, len(payload), 184)):
            pkts.append(_ts_pkt(pid, int(k == 0), cc,
                                np.frombuffer(payload[off: off + 184],
                                              np.uint8)))
            cc += 1
        pkts.append(_ts_pkt(0x100, 1, 0, np.zeros(10, np.uint8)))
    return cadus, np.stack(pkts)


@pytest.mark.parametrize("ts_input", [True, False], ids=["ts", "bbframes"])
def test_s2udp_xrit_cadu_extractor(tmp_path, rng, ts_input):
    from satdump_tpu.pipeline.modules import xrit_net as jx
    from satdump_tpu_torch.ops.dvbs2.bbframe import ts_to_bbframes
    from satdump_tpu_torch.pipeline.modules import xrit_net as tx
    cadus, ts = _s2udp_ts(rng, 0x3F5)
    p = tmp_path / "in.bin"
    kbch = 58192
    (ts if ts_input else ts_to_bbframes(ts, kbch)).tofile(p)
    params = {"pid": 0x3F5, "ts_input": ts_input, "bb_size": kbch}
    out = {}
    for name, m in (("j", jx), ("t", tx)):
        mod = m.S2UDPxRITCADUExtractorModule(str(p), str(tmp_path / name),
                                             params)
        mod.process()
        out[name] = (mod.stats, open(mod.d_output_file, "rb").read())
    assert out["j"] == out["t"]
    _same(np.frombuffer(out["t"][1], np.uint8).reshape(-1, 1024), cadus)


def test_goesrecv_publisher(tmp_path, rng):
    from satdump_tpu_torch.io.net import FramedTCPClient
    from satdump_tpu_torch.pipeline.modules.xrit_net import \
        GOESRecvPublisherModule
    cadus = rng.integers(0, 256, (5, 1024), dtype=np.uint8)
    p = tmp_path / "x.cadu"
    cadus.tofile(p)
    mod = GOESRecvPublisherModule(str(p), str(tmp_path / "o"),
                                  {"nanomsg_port": 0, "client_wait": 5.0})
    th = threading.Thread(target=mod.process)
    th.start()
    cl = None
    for _ in range(200):
        if mod.port:
            try:
                cl = FramedTCPClient("127.0.0.1", mod.port)
                break
            except OSError:
                pass
        time.sleep(0.02)
    got = []
    while cl is not None and len(got) < 5:
        f = cl.recv()
        if f is None:
            break
        got.append(np.frombuffer(f, np.uint8))
    th.join(timeout=10)
    assert mod.stats == {"frames": 5}
    for i in range(5):
        _same(got[i], cadus[i, 4: 4 + 892])


@pytest.mark.parametrize("kind", ["bpsk", "qpsk", "oqpsk", "8psk", "16apsk",
                                  "32apsk"])
def test_constellations(kind, rng):
    from satdump_tpu.ops import constellation as jc
    from satdump_tpu_torch.ops import constellation as tc
    g = {"16apsk": (3.15, 0.0), "32apsk": (2.84, 5.27)}.get(kind, (0.0, 0.0))
    s = (rng.normal(0, 0.6, 300) + 1j * rng.normal(0, 0.6, 300)).astype(
        np.complex64)
    _same(jc.get_points(kind, *g), tc.get_points(kind, *g))
    assert jc.bits_per_symbol(kind) == tc.bits_per_symbol(kind)
    _same(jc.hard_demod(s, kind, *g), tc.hard_demod(s, kind, *g))
    _same(jc.soft_demod(s, kind, *g), tc.soft_demod(s, kind, *g))
    _same(jc.phase_error(s, kind, *g), tc.phase_error(s, kind, *g))
    for a, b in zip(jc.make_soft_lut(kind, 32, *g),
                    tc.make_soft_lut(kind, 32, *g)):
        _same(a, b)


def test_tx_modulators(rng):
    from satdump_tpu.ops import txmod as jt
    from satdump_tpu_torch.ops import txmod as tt
    bits = rng.integers(0, 2, 500).astype(np.uint8)
    _same(jt.gaussian_taps(2.0, 0.5, 31), tt.gaussian_taps(2.0, 0.5, 31))
    _same(jt.gfsk_modulate(bits, 1.0), tt.gfsk_modulate(bits, 1.0))
    _same(jt.fsk_modulate(bits, 4, 0.05), tt.fsk_modulate(bits, 4, 0.05))


def test_mqtt_client_against_a_local_broker():
    from satdump_tpu_torch.utils import mqtt
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    seen = []

    def broker():
        c, _ = srv.accept()
        c.settimeout(5)
        while True:
            h = c.recv(1)
            if not h:
                break
            n = mqtt._decode_len(c)
            body = b""
            while len(body) < n:
                body += c.recv(n - len(body))
            seen.append((h[0], body))
            if h[0] == 0x10:
                c.sendall(bytes([0x20, 2, 0, 0]))
            elif h[0] == 0x82:
                c.sendall(bytes([0x90, 3]) + body[:2] + b"\x00")
                msg = mqtt._str("t/x") + b"payload"
                c.sendall(bytes([0x30]) + mqtt._encode_len(len(msg)) + msg)
            elif h[0] == 0xE0:
                break
        c.close()

    th = threading.Thread(target=broker, daemon=True)
    th.start()
    cl = mqtt.MQTTClient("127.0.0.1", srv.getsockname()[1], client_id="c1")
    cl.publish("satdump/stats", "x" * 200)
    cl.subscribe("t/#")
    assert cl.recv_publish() == ("t/x", b"payload")
    cl.ping()
    cl.disconnect()
    th.join(timeout=5)
    srv.close()
    from satdump_tpu.utils import mqtt as jmqtt
    assert [h for h, _ in seen] == [0x10, 0x30, 0x82, 0xC0, 0xE0]
    pub = seen[1][1]
    assert pub == mqtt._str("satdump/stats") + b"x" * 200
    for n in (0, 127, 128, 16383, 16384, 2 ** 21):
        assert mqtt._encode_len(n) == jmqtt._encode_len(n)


def test_webhook_sink_and_init(monkeypatch):
    from collections import defaultdict
    from http.server import BaseHTTPRequestHandler, HTTPServer

    from satdump_tpu_torch.core import init
    from satdump_tpu_torch.core.events import (PipelineDoneProcessingEvent,
                                               SatdumpStartedEvent,
                                               event_bus)
    from satdump_tpu_torch.core.webhook import WebhookSink
    # handlers registered here leave with the test
    monkeypatch.setattr(event_bus, "_handlers", defaultdict(list))
    got = []

    class H(BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers["Content-Length"])
            got.append(json.loads(self.rfile.read(n)))
            self.send_response(200)
            self.end_headers()

        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", 0), H)
    th = threading.Thread(target=srv.handle_request)
    th.start()
    WebhookSink(f"http://127.0.0.1:{srv.server_address[1]}/hook",
                run_async=False)
    event_bus.fire_event(PipelineDoneProcessingEvent("noaa_apt", "/x"))
    th.join(timeout=5)
    srv.server_close()
    assert got == [{"event": "pipeline_done", "pipeline": "noaa_apt",
                    "output_dir": "/x"}]
    started = []
    event_bus.register_handler(SatdumpStartedEvent,
                               lambda e: started.append(1))
    init.init_satdump()
    init.init_satdump()                              # once only
    assert len(started) <= 1 and init._initialized
    from satdump_tpu_torch.pipeline.module import module_registry
    from satdump_tpu_torch.pipeline.pipeline import pipeline_registry
    assert len(list(pipeline_registry.items())) >= 123
    assert "soft2hard" in module_registry
