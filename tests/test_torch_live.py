"""The port's live path against the JAX package's on the CPU: the
remote-IQ codec and client (with the port's repair for a typed
PKT_TYPE_SOURCESTOP), LivePipeline fed over TCP (tests/test_live.py:78's
setup: QPSK at 100 ksym/s, 220 ksps, 15 dB, psk_demod block 2^17 into
metop_ahrpt_decoder), live against offline, a stream that ends on a block
boundary, and the CLI's `live`, `record` and `probe`.

Tolerances: the .cadu byte for byte; the .soft within 2 LSB (jnp.fft and
torch.fft differ in the last bits, ROADMAP §3).
"""

import contextlib
import io
import json
import socket
import struct
import threading
import urllib.request

import numpy as np
import pytest
import torch

from satdump_tpu import sim as jsim
from satdump_tpu.io import net as jnet
from satdump_tpu.pipeline.live import LivePipeline as JLive
from satdump_tpu.pipeline.pipeline import Pipeline as JPipeline
from satdump_tpu.pipeline.pipeline import PipelineStep as JStep
from satdump_tpu_torch import cli
from satdump_tpu_torch.io import net as tnet
from satdump_tpu_torch.io import write_baseband
from satdump_tpu_torch.pipeline.live import LivePipeline
from satdump_tpu_torch.pipeline.pipeline import Pipeline, PipelineStep

SAMPLERATE, SYMBOLRATE, BLOCK = 220_000.0, 100_000.0, 1 << 17
N_CADUS = 24
DEMOD = {"constellation": "qpsk", "symbolrate": SYMBOLRATE,
         "rrc_alpha": 0.5, "pll_bw": 0.005}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def signal():
    """tests/test_live.py:78's impaired QPSK: 24 CADUs at sps 2.2."""
    rng = np.random.default_rng(0xC0FFEE)
    cadus = jsim.make_cadus(N_CADUS, rng)
    syms = jsim.bits_to_qpsk_symbols(jsim.encode_cadu_stream(cadus))
    tx = jsim.qpsk_modulate(syms, sps=SAMPLERATE / SYMBOLRATE)
    bb = jsim.ChannelModel(snr_db=15.0, freq_offset=2e-4, phase=0.5,
                           seed=4).apply(tx)
    return cadus, bb


def _pipe(pkg_pipeline, pkg_step):
    return pkg_pipeline(id="live_t", name="Live test", steps=[
        pkg_step("baseband", ""), pkg_step("soft", "psk_demod", dict(DEMOD)),
        pkg_step("cadu", "metop_ahrpt_decoder", {})], parameters={})


def _serve(net, bb, chunk=65536, bit_depth=16):
    srv = net.RemoteIQServer(port=0, bit_depth=bit_depth)

    def serve():
        srv.wait_client(timeout=10)
        for off in range(0, len(bb), chunk):
            srv.send_samples(bb[off: off + chunk])
        srv.end()

    t = threading.Thread(target=serve)
    t.start()
    return srv, t


def _live_tcp(pkg, bb, out, poll_at=None):
    """bb over the remote-IQ protocol (16 bits) into `pkg`'s LivePipeline;
    returns (output files, the /status JSON polled after block `poll_at`)."""
    net, live, params = (
        (jnet, JLive, {}) if pkg == "jax" else
        (tnet, LivePipeline, {"torch_device": "cpu"}))
    pipe = _pipe(JPipeline, JStep) if pkg == "jax" else \
        _pipe(Pipeline, PipelineStep)
    srv, t = _serve(net, bb)
    lp = live(pipe, str(out), user_params=dict(
        params, samplerate=SAMPLERATE, buffer_size=BLOCK))
    status = polled = None
    if poll_at is not None:
        from satdump_tpu_torch.core.http_status import StatusServer
        status = StatusServer(lambda: lp.stats, port=0)
        status.start()
    client = net.RemoteIQClient("127.0.0.1", srv.port)
    lp.start()
    for i, blk in enumerate(client.blocks()):
        lp.push(blk)
        if i == poll_at:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{status.port}/status", timeout=5) as r:
                polled = json.loads(r.read())
    outs = lp.stop()
    client.close()
    t.join(timeout=10)
    assert not t.is_alive()
    srv.close()
    if status is not None:
        status.stop()
    return outs, polled


def _cadus(outs):
    return open([o for o in outs if o.endswith(".cadu")][0], "rb").read()


def _matched(data: bytes, cadus: np.ndarray) -> int:
    got = np.frombuffer(data, np.uint8).reshape(-1, 1024)
    return sum(bool((cadus == g).all(axis=1).any()) for g in got)


def test_iq_pkt_matches_jax(rng):
    x = ((rng.standard_normal(1000) + 1j * rng.standard_normal(1000)) * 0.3
         ).astype(np.complex64)
    for depth, tol in [(8, 3e-2), (16, 1e-4), (32, 0.0)]:
        pkt = tnet.encode_iq_pkt(x, depth)
        assert pkt == jnet.encode_iq_pkt(x, depth)
        y = tnet.decode_iq_pkt(pkt)
        np.testing.assert_array_equal(y, jnet.decode_iq_pkt(pkt))
        np.testing.assert_allclose(y, x, atol=tol)
    assert [getattr(tnet, k) for k in dir(jnet) if k.startswith("PKT_")] == \
        [getattr(jnet, k) for k in dir(jnet) if k.startswith("PKT_")]


def _client_samples(net, payloads):
    """Every payload framed to `net`'s RemoteIQClient; the samples it
    yields."""
    srv = tnet.FramedTCPServer(0)

    def serve():
        srv.wait_client(timeout=10)
        for p in payloads:
            srv.send(p)
        srv.send(b"")

    t = threading.Thread(target=serve)
    t.start()
    c = net.RemoteIQClient("127.0.0.1", srv.port)
    got = list(c.blocks())
    c.close()
    t.join(timeout=10)
    srv.close()
    return np.concatenate(got) if got else np.zeros(0, np.complex64)


def test_remote_iq_client_drops_sourcestop(rng):
    """Typed IQ packets, then a PKT_TYPE_SOURCESTOP (first byte 8, a bit
    depth too) with a body: the port yields exactly the samples sent; the
    JAX client decodes the control packet as samples (ADVICE.md's
    io/net.py:200). On legacy-only and typed-only streams they agree."""
    parts = [((rng.standard_normal(300) + 1j * rng.standard_normal(300))
              * 0.2).astype(np.complex64) for _ in range(3)]
    typed = [bytes([tnet.PKT_TYPE_IQ]) + tnet.encode_iq_pkt(p, 16)
             for p in parts]
    bare = [tnet.encode_iq_pkt(p, d) for p, d in zip(parts, (8, 16, 32))]
    stop = bytes([tnet.PKT_TYPE_SOURCESTOP]) + struct.pack("<fi", 1.0, 4) \
        + bytes(range(8))
    sent = {"typed": np.concatenate(
        [tnet.decode_iq_pkt(p[1:]) for p in typed]),
        "bare": np.concatenate([tnet.decode_iq_pkt(p) for p in bare])}
    got = _client_samples(tnet, typed[:2] + [stop] + typed[2:])
    np.testing.assert_array_equal(got, sent["typed"])
    jgot = _client_samples(jnet, typed[:2] + [stop] + typed[2:])
    assert len(jgot) == len(sent["typed"]) + 4
    # a control packet of another type marks the peer typed as well
    ping = bytes([tnet.PKT_TYPE_PING])
    np.testing.assert_array_equal(
        _client_samples(tnet, [ping, stop] + typed), sent["typed"])
    for name, stream in (("typed", typed), ("bare", bare)):
        t = _client_samples(tnet, stream)
        np.testing.assert_array_equal(t, _client_samples(jnet, stream))
        np.testing.assert_array_equal(t, sent[name])


def test_live_over_tcp_matches_jax(tmp_path, signal):
    """The port's LivePipeline over TCP: its .cadu equals the JAX class's
    byte for byte, its .soft within 2 LSB, /status answers mid-stream."""
    cadus, bb = signal
    outs, polled = _live_tcp("torch", bb, tmp_path / "torch", poll_at=3)
    jouts, _ = _live_tcp("jax", bb, tmp_path / "jax")
    got = _cadus(outs)
    assert got == _cadus(jouts)
    assert _matched(got, cadus) == len(got) // 1024 >= N_CADUS - 2
    t, j = (np.fromfile(o[0], np.int8) for o in (outs, jouts))
    assert t.shape == j.shape and len(t) > 300_000
    assert np.abs(t.astype(np.int16) - j).max() <= 2
    assert polled["samples"] > 0 and "fft_db" in polled
    assert set(polled["modules"]) == {"psk_demod", "metop_ahrpt_decoder"}


def test_live_equals_offline(tmp_path, signal):
    """Pushed in 50,000-sample chunks, the live pipeline writes the .soft
    and .cadu that run_pipeline writes from the same samples' file."""
    from satdump_tpu_torch.pipeline.runner import run_pipeline
    cadus, bb = signal
    params = {"torch_device": "cpu", "samplerate": SAMPLERATE,
              "buffer_size": BLOCK}
    write_baseband(tmp_path / "x.cf32", "cf32", bb)
    cadu = run_pipeline(_pipe(Pipeline, PipelineStep), str(tmp_path /
                        "x.cf32"), str(tmp_path / "off"), user_params=params)
    lp = LivePipeline(_pipe(Pipeline, PipelineStep), str(tmp_path / "live"),
                      user_params=params)
    lp.start()
    for off in range(0, len(bb), 50_000):
        lp.push(bb[off: off + 50_000])
    outs = lp.stop()
    assert open(outs[0], "rb").read() == \
        open(tmp_path / "off" / "live_t.soft", "rb").read()
    assert open(outs[1], "rb").read() == open(cadu, "rb").read()
    assert lp.stats["blocks"] == -(-len(bb) // lp.block_size)
    assert set(lp.stats["host_s"]) == {"rebuffer", "fft_tap", "demod",
                                       "decoder", "soft_write"}
    # no kernel launches on the CPU; every wrapper of the data paths listed
    assert lp.stats["launches"] == {
        k: 0 for k in ("viterbi_re", "resample_arith_grid", "agc_walk",
                       "pll_walk", "costas_walk", "mm_walk", "turbo_bcjr",
                       "viterbi_block_acs", "viterbi_block_traceback",
                       "gardner_walk")}


def test_stream_ending_on_a_block_boundary(tmp_path, signal):
    """A stream of exactly 4 blocks: no block goes through with last=True,
    in either package. The decoder holds back only incomplete frames, so
    the port's live .cadu equals its offline one (which passes last) and
    the JAX class's, with every CADU sent."""
    from satdump_tpu_torch.pipeline.runner import run_pipeline
    cadus, bb = signal
    rng = np.random.default_rng(3)
    n = 4 * BLOCK - len(bb)
    bb = np.concatenate([bb, (0.01 * (rng.standard_normal(n) + 1j *
                         rng.standard_normal(n))).astype(np.complex64)])
    outs, _ = _live_tcp("torch", bb, tmp_path / "torch")
    jouts, _ = _live_tcp("jax", bb, tmp_path / "jax")
    write_baseband(tmp_path / "x.cf32", "cf32", bb)
    off = run_pipeline(_pipe(Pipeline, PipelineStep), str(tmp_path /
                       "x.cf32"), str(tmp_path / "off"), user_params={
        "torch_device": "cpu", "samplerate": SAMPLERATE,
        "buffer_size": BLOCK})
    got = _cadus(outs)
    assert got == _cadus(jouts) == open(off, "rb").read()
    assert _matched(got, cadus) == N_CADUS == len(got) // 1024


@pytest.mark.parametrize("chunk", [1 << 15, 1 << 16])
def test_decoder_tail_without_last(chunk):
    """The decoder fed a whole number of chunks never sees last=True on
    the live path. 12 CADUs of clean softs ending on a chunk boundary:
    the port's decoder writes all 12 with or without last on the final
    chunk (a frame is held back at a seam only while it is incomplete),
    and the JAX module's, without last, the same bytes."""
    from satdump_tpu.pipeline.modules.ccsds.conv_concat import \
        MetopAHRPTDecoderModule as JDecoder
    from satdump_tpu_torch.pipeline.modules.ccsds.conv_concat import \
        MetopAHRPTDecoderModule as Decoder
    rng = np.random.default_rng(1)
    cadus = jsim.make_cadus(12, rng)
    soft = jsim.symbols_to_soft_int8(jsim.encode_cadu_stream(cadus))
    assert len(soft) % chunk == 0
    got = {}
    for name, cls, params, last in (
            ("torch", Decoder, {"torch_device": "cpu"}, False),
            ("torch", Decoder, {"torch_device": "cpu"}, True),
            ("jax", JDecoder, {}, False)):
        m = cls("", "unused", dict(params, buffer_size=BLOCK))
        m.stream_start()
        f = io.BytesIO()
        for off in range(0, len(soft), chunk):
            m.stream_work(soft[off: off + chunk], f,
                          last=last and off + chunk == len(soft))
        got[name, last] = f.getvalue()
    assert len(set(got.values())) == 1
    assert _matched(got["torch", False], cadus) == 12 == \
        len(got["torch", False]) // 1024


def _run_cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def _pipelines_dir(tmp_path):
    d = tmp_path / "pipelines"
    d.mkdir()
    (d / "live_t.json").write_text(json.dumps({"live_t": {
        "name": "Live test", "live": [1, 2],
        "parameters": {"samplerate": {"value": SAMPLERATE}},
        "work": {"baseband": {},
                 "soft": {"module": "psk_demod", "parameters": DEMOD},
                 "cadu": {"module": "metop_ahrpt_decoder",
                          "parameters": {}}}}}))
    return d


def test_cli_live_tcp_and_file(tmp_path, signal):
    """`live` from tcp:// and from file://, on the CPU when asked: exit
    code 0, the JAX command's JSON shape, the same .cadu from both
    sources; on cuda without a card it raises."""
    from satdump_tpu_torch.core.exceptions import SatdumpError
    cadus, bb = signal
    d = _pipelines_dir(tmp_path)
    write_baseband(tmp_path / "x.cf32", "cf32", bb)
    srv, t = _serve(tnet, bb)
    common = ["--buffer_size", str(BLOCK), "--torch_device", "cpu"]
    rc, out = _run_cli(["--pipelines-dir", str(d), "live", "live_t",
                        f"tcp://127.0.0.1:{srv.port}", str(tmp_path / "tcp"),
                        "--http-port", "0"] + common)
    t.join(timeout=10)
    srv.close()
    assert rc == 0
    res = json.loads(out.strip().splitlines()[-1])
    assert set(res) == {"outputs", "stats"}
    assert res["stats"]["blocks"] == -(-len(bb) // BLOCK)
    # the client's packets and its decode time
    assert res["stats"]["source"]["packets"] == -(-len(bb) // 65536)
    assert res["stats"]["source"]["decode_s"] > 0
    rc, out = _run_cli(["--pipelines-dir", str(d), "live", "live_t",
                        f"file://{tmp_path / 'x.cf32'}",
                        str(tmp_path / "file")] + common)
    assert rc == 0
    fres = json.loads(out.strip().splitlines()[-1])
    assert _cadus(res["outputs"]) == _cadus(fres["outputs"])
    assert _matched(_cadus(res["outputs"]), cadus) >= N_CADUS - 2
    assert _run_cli(["live", "no_such_pipeline", "file://x", "o"])[0] == 2
    assert _run_cli(["--pipelines-dir", str(d), "live", "live_t",
                     "udp://x:1", "o", "--torch_device", "cpu"])[0] == 2
    if not torch.cuda.is_available():
        with pytest.raises(SatdumpError, match="cuda"):
            cli.main(["--pipelines-dir", str(d), "live", "live_t",
                      f"file://{tmp_path / 'x.cf32'}", str(tmp_path / "c")])


def test_cli_record(tmp_path, rng):
    """`record` writes what a remote-IQ server sends, in the JAX command's
    JSON shape, and stops at --max-samples."""
    from satdump_tpu_torch.io import read_baseband
    x = ((rng.standard_normal(5000) + 1j * rng.standard_normal(5000)) * 0.2
         ).astype(np.complex64)
    sent = np.concatenate([tnet.decode_iq_pkt(tnet.encode_iq_pkt(
        x[o: o + 1000], 16)) for o in range(0, len(x), 1000)])
    for fmt, limit in (("cf32", 0), ("cs16", 2500)):
        srv, t = _serve(tnet, x, chunk=1000)
        out = tmp_path / f"rec.{fmt}"
        argv = ["record", f"tcp://127.0.0.1:{srv.port}", str(out),
                "--samplerate", "48000"]
        rc, text = _run_cli(argv + (["--max-samples", str(limit)]
                                    if limit else []))
        t.join(timeout=10)
        srv.close()
        assert rc == 0
        n = limit or len(x)
        assert json.loads(text) == {"samples": n, "file": str(out)}
        got, _ = read_baseband(out, fmt)
        np.testing.assert_allclose(got, sent[:n], atol=1e-4)


def test_cli_probe():
    """`probe` in the JAX command's JSON shape; the CPU only when asked."""
    from satdump_tpu_torch.core.exceptions import SatdumpError
    rc, out = _run_cli(["probe", "--torch_device", "cpu"])
    assert rc == 0
    assert json.loads(out) == {"device_count": 1, "devices": [
        {"id": 0, "platform": "cpu", "kind": "cpu"}]}
    if not torch.cuda.is_available():
        with pytest.raises(SatdumpError, match="cuda"):
            cli.main(["probe"])


def test_status_server_paths():
    """The /status server answers its four paths with the stats JSON, 404
    elsewhere, and 500 when the stats callback raises."""
    from satdump_tpu_torch.core.http_status import StatusServer
    calls = []

    def stats():
        calls.append(1)
        if len(calls) > 4:
            raise RuntimeError("boom")
        return {"n": len(calls)}

    srv = StatusServer(stats, port=0)
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        for i, path in enumerate(("/status", "/api", "/api/status", "/")):
            with urllib.request.urlopen(base + path, timeout=5) as r:
                assert json.loads(r.read()) == {"n": i + 1}
        for path, code in (("/nope", 404), ("/status", 500)):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(base + path, timeout=5)
            assert e.value.code == code
    finally:
        srv.stop()


def test_remote_sdr_wire_fixture():
    """The reference's wire bytes (tests/test_live.py's fixture):
    tcp_proto.h framing, remote.h's type byte, iq_pkt.h's IQ body."""
    samples = np.array([1.0 + 0.0j, 0.0 - 0.5j], np.complex64)
    pkt = bytes([tnet.PKT_TYPE_IQ]) + tnet.encode_iq_pkt(samples, 8)
    framed = struct.pack(">I", len(pkt)) + pkt
    exp_body = struct.pack("<Bfi", 8, 127.0, 2) + bytes([127, 0, 0, 256 - 64])
    exp = struct.pack(">I", 1 + len(exp_body)) + bytes([5]) + exp_body
    assert framed == exp, (framed.hex(), exp.hex())
    # and the server puts exactly those bytes on the socket
    srv = tnet.RemoteIQServer(port=0, bit_depth=8)
    c = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
    srv.wait_client(timeout=5)
    srv.send_samples(samples)
    data = b""
    while len(data) < 1 + len(exp):
        data += c.recv(64)
    c.close()
    srv.close()
    assert data == tnet.ACCEPT + exp
