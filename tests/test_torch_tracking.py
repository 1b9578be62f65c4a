"""The port's tracking layer against the JAX package's on the CPU: TLE
parsing, SGP4, look angles and Doppler (within 1e-9 relative: the same
NumPy code), pass prediction and the AutoTrack scheduler's AOS / LOS
(equal), the rotctld client, the task scheduler, the TLE store,
`autotrack --dry-run` (equal JSON), and LivePipeline.set_doppler: the
provider's values equal JAX's, and a live pass carrying the tracker's
Doppler decodes to the CADUs of the same pass without it.
"""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from satdump_tpu import cli as jcli
from satdump_tpu.geo import SGP4 as JSGP4
from satdump_tpu.geo import TLE as JTLE
from satdump_tpu.tracking.scheduler import AutoTrackScheduler as JSched
from satdump_tpu.tracking.scheduler import TrackedObject as JObj
from satdump_tpu.tracking.tracker import ObjectTracker as JTracker
from satdump_tpu.tracking.tracker import predict_passes as jpredict
from satdump_tpu_torch import cli, sim
from satdump_tpu_torch.geo import SGP4, TLE, look_angles
from satdump_tpu_torch.tracking import (AutoTrackScheduler, ObjectTracker,
                                        TrackedObject, predict_passes)

# NOAA 19 (tests/test_tracking.py's element set)
N19_L1 = "1 33591U 09005A   21100.47420639  .00000090  00000-0  74103-4 0  9998"
N19_L2 = "2 33591  99.1922 114.0067 0013577 245.5357 114.4418 14.12500029627277"
T0 = 1618232411.0  # 2021-04-12T12:20:11Z, near the TLE epoch
QTH = (48.0, 2.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def n19():
    return TLE.parse("NOAA 19", N19_L1, N19_L2)


def test_tle_and_sgp4_match_jax(n19):
    j = JTLE.parse("NOAA 19", N19_L1, N19_L2)
    assert vars(n19) == vars(j)
    ts = T0 + np.arange(0, 6000, 7.0)
    p, jp = SGP4(n19), JSGP4(j)
    np.testing.assert_array_equal(p.position_ecef(ts), jp.position_ecef(ts))
    ecef = p.position_ecef(ts)
    azel = look_angles(*QTH, 0.0, ecef)
    from satdump_tpu.geo import look_angles as jlook
    np.testing.assert_array_equal(azel, jlook(*QTH, 0.0, ecef))
    r = np.linalg.norm(ecef, axis=-1)
    assert (r > 6700).all() and (r < 7300).all()      # an 850 km LEO


def test_doppler_and_look_angles_match_jax(n19):
    trk = ObjectTracker(n19, *QTH)
    jtrk = JTracker(JTLE.parse("NOAA 19", N19_L1, N19_L2), *QTH)
    ts = T0 + np.arange(0, 86400, 30.0)
    np.testing.assert_array_equal(trk.az_el(ts), jtrk.az_el(ts))
    d, jd = trk.doppler_shift(ts, 137.1e6), jtrk.doppler_shift(ts, 137.1e6)
    np.testing.assert_allclose(d, jd, rtol=1e-9, atol=0)
    el = trk.az_el(ts)[..., 1]
    t_pass = float(ts[np.argmax(el)])
    d_aos = float(trk.doppler_shift(t_pass - 300, 137.1e6))
    d_los = float(trk.doppler_shift(t_pass + 300, 137.1e6))
    assert 500 < d_aos < 4000 and -4000 < d_los < -500


def test_passes_and_scheduler_match_jax(n19):
    j = JTLE.parse("NOAA 19", N19_L1, N19_L2)
    passes = predict_passes(n19, *QTH, T0, T0 + 86400)
    assert [vars(p) for p in passes] == \
        [vars(p) for p in jpredict(j, *QTH, T0, T0 + 86400)]
    assert 3 <= len(passes) <= 10
    scheds = []
    for sched_cls, obj_cls, tle in ((AutoTrackScheduler, TrackedObject, n19),
                                    (JSched, JObj, j)):
        s = sched_cls(*QTH)
        s.track(obj_cls(norad=33591, tle=tle, frequency_hz=137.1e6,
                        pipeline_id="meteor_m2_lrpt", min_elevation=5))
        s.compute_passes(T0, horizon_s=86400)
        events = []
        s.aos_callback = lambda p, o: events.append(("aos", p.aos))
        s.los_callback = lambda p, o: events.append(("los", p.los))
        for p in s.upcoming_sel:
            for t in (p.aos - 1, p.aos + 1, (p.aos + p.los) / 2, p.los + 1):
                s.tick(t)
        scheds.append(([vars(p) for p in s.upcoming_sel], events))
    assert scheds[0] == scheds[1]
    sel, events = scheds[0]
    assert len(events) == 2 * len(sel) and events[0] == ("aos", sel[0]["aos"])


def test_scheduler_overlap_resolution():
    from satdump_tpu_torch.tracking.scheduler import (
        SatellitePass, select_passes_for_autotrack)
    a = SatellitePass(1, 100.0, 700.0, 30.0)
    b = SatellitePass(2, 400.0, 1000.0, 60.0)
    c = SatellitePass(3, 1200.0, 1500.0, 10.0)
    sel = select_passes_for_autotrack([a, b, c])
    assert [(p.norad, p.aos, p.los) for p in sel] == \
        [(1, 100.0, 400.0), (2, 400.0, 1000.0), (3, 1200.0, 1500.0)]


def test_rotctl_protocol():
    from satdump_tpu_torch.tracking.rotator import MockRotctld, RotctlClient
    srv = MockRotctld()
    c = RotctlClient("127.0.0.1", srv.port)
    assert c.set_pos(123.45, 67.8)
    az, el = c.get_pos()
    assert abs(az - 123.45) < 1e-6 and abs(el - 67.8) < 1e-6
    assert c.stop() and srv.stopped
    c.close()
    srv.close()


def test_task_scheduler_and_tle_store(tmp_path, n19):
    from satdump_tpu_torch.core.events import event_bus
    from satdump_tpu_torch.core.tasks import TaskScheduler
    from satdump_tpu_torch.geo.tle import TLERegistry, update_tles_from_source

    class Ping:
        pass

    got = []
    event_bus.register_handler(Ping, lambda e: got.append(1))
    ts = TaskScheduler()
    ts.add_task("ping", Ping, interval_s=100.0)
    assert ts.tick(now=1000.0) == ["ping"]
    assert ts.tick(now=1050.0) == []
    assert ts.tick(now=1100.0) == ["ping"]
    assert len(got) == 2
    src = tmp_path / "tles.txt"
    src.write_text(f"NOAA 19\n{N19_L1}\n{N19_L2}\n")
    reg = TLERegistry(str(tmp_path / "store.json"))
    assert update_tles_from_source(reg, str(src)) == 1
    assert update_tles_from_source(reg, f"file://{src}") == 1
    assert TLERegistry(str(tmp_path / "store.json")).get(33591).line2 == \
        N19_L2


def test_autotrack_dry_run_matches_jax(tmp_path):
    tle_f = tmp_path / "tles.txt"
    tle_f.write_text(f"NOAA 19\n{N19_L1}\n{N19_L2}\n")
    cfg = {"qth": {"lat": QTH[0], "lon": QTH[1]}, "tle_file": str(tle_f),
           "satellites": [{"norad": 33591, "frequency": 137.1e6,
                           "pipeline": "meteor_m2_lrpt", "min_elevation": 5}],
           "start_time": T0, "horizon_s": 86400,
           "source": "tcp://127.0.0.1:1", "output": str(tmp_path)}
    cfg_f = tmp_path / "at.json"
    cfg_f.write_text(json.dumps(cfg))
    outs = []
    for main in (cli.main, jcli.main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["autotrack", str(cfg_f), "--dry-run"]) == 0
        outs.append(json.loads(buf.getvalue().strip().splitlines()[-1]))
    assert outs[0] == outs[1]
    assert len(outs[0]["passes"]) >= 3


def _pass_pipeline():
    from satdump_tpu_torch.pipeline.pipeline import Pipeline, PipelineStep
    return Pipeline(id="dop_t", name="Doppler test", steps=[
        PipelineStep("baseband", ""),
        PipelineStep("soft", "psk_demod", {
            "constellation": "qpsk", "symbolrate": 100e3, "rrc_alpha": 0.5,
            "pll_bw": 0.005}),
        PipelineStep("cadu", "metop_ahrpt_decoder", {})], parameters={})


def test_set_doppler_provider_matches_jax(tmp_path, n19):
    from satdump_tpu.pipeline.live import LivePipeline as JLive
    from satdump_tpu.pipeline.pipeline import Pipeline as JPipeline
    from satdump_tpu.pipeline.pipeline import PipelineStep as JStep
    from satdump_tpu_torch.pipeline.live import LivePipeline
    lp = LivePipeline(_pass_pipeline(), str(tmp_path / "t"), user_params={
        "samplerate": 220e3, "torch_device": "cpu"})
    jp = JPipeline(id="dop_t", name="d", steps=[
        JStep("baseband", ""), JStep("soft", "psk_demod", {
            "constellation": "qpsk", "symbolrate": 100e3, "rrc_alpha": 0.5,
            "pll_bw": 0.005})], parameters={})
    jlp = JLive(jp, str(tmp_path / "j"), user_params={"samplerate": 220e3})
    lp.set_doppler(ObjectTracker(n19, *QTH), 137.1e6, 220e3, t0=T0)
    jlp.set_doppler(JTracker(JTLE.parse("NOAA 19", N19_L1, N19_L2), *QTH),
                    137.1e6, 220e3, t0=T0)
    for pos, n in ((0, 1 << 17), (5 * (1 << 17), 1 << 17), (12345, 1000)):
        d = lp.modules[0].doppler_provider(pos, n)
        jd = jlp.modules[0].doppler_provider(pos, n)
        assert d.dtype == np.float32 and d.shape == (n,)
        np.testing.assert_array_equal(d, jd)


def test_live_pass_with_tracker_doppler(tmp_path, n19):
    """QPSK at 100 ksym/s, 220 ksps, carrying NOAA 19's predicted Doppler
    at 137.1 MHz five minutes before its highest point over the QTH (a
    shift near 2.8 kHz): with set_doppler on the tracker the live pass's
    softs are within 1 LSB of the pass without Doppler (4 LSB apart when
    the shift is left to the carrier loop), and its .cadu is the same."""
    from satdump_tpu_torch.pipeline.live import LivePipeline
    rng = np.random.default_rng(17)
    fs = 220e3
    cadus = sim.make_cadus(12, rng)
    clean = sim.ChannelModel(snr_db=18.0, phase=0.5, seed=3).apply(
        sim.qpsk_modulate(sim.bits_to_qpsk_symbols(
            sim.encode_cadu_stream(cadus)), sps=fs / 100e3))
    trk = ObjectTracker(n19, *QTH)
    ts = T0 + np.arange(0, 86400, 30.0)
    t0 = float(ts[np.argmax(trk.az_el(ts)[..., 1])]) - 300
    tk = t0 + np.arange(0, len(clean) + 4096, 4096) / fs
    dop = np.interp(np.arange(len(clean)), np.arange(0, len(clean) + 4096,
                                                     4096),
                    trk.doppler_shift(tk, 137.1e6))
    assert 1000 < abs(dop).min() < 4000
    shifted = (clean * np.exp(2j * np.pi * np.cumsum(dop) / fs)
               ).astype(np.complex64)
    out = {}
    for name, x, track in (("clean", clean, False), ("doppler", shifted,
                                                      True)):
        lp = LivePipeline(_pass_pipeline(), str(tmp_path / name), {
            "samplerate": fs, "buffer_size": 1 << 17, "torch_device": "cpu"})
        if track:
            lp.set_doppler(trk, 137.1e6, fs, t0=t0)
        out[name] = lp.run_source(x[o: o + 30000]
                                  for o in range(0, len(x), 30000))
    got = {k: open(v[1], "rb").read() for k, v in out.items()}
    assert got["doppler"] == got["clean"]
    soft = {k: np.fromfile(v[0], np.int8).astype(np.int16)
            for k, v in out.items()}
    assert soft["doppler"].shape == soft["clean"].shape
    assert np.abs(soft["doppler"] - soft["clean"]).max() <= 1
    rows = np.frombuffer(got["doppler"], np.uint8).reshape(-1, 1024)
    sent = {c.tobytes() for c in cadus}
    assert len(rows) >= 10 and all(r.tobytes() in sent for r in rows)
