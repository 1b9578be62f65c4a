"""The port's projection level against satdump_tpu's, on the CPU: the
raytracers and GCPs, the map projections, reprojection, the thin-plate-
spline warps, the IERS store and the SPK reader.

Host code is a copy of the JAX package's and is held bit for bit. The
spline's device evaluation is float64 in the port (the JAX package's is
float32, which places pixels whole pixels off; ROADMAP §3): it is held to
the JAX package's own float64 evaluation within WARP_COORD_TOL pixels, and
the warped images to at most WARP_PIXEL_SHARE of their pixels differing,
each by at most 1 LSB.
"""

from dataclasses import astuple

import numpy as np
import pytest

from satdump_tpu.geo import projs as jprojs
from satdump_tpu.geo import raytrace as jrt
from satdump_tpu.geo import reproject as jrep
from satdump_tpu.geo import warp as jwarp
from satdump_tpu.geo.tle import TLE as JTLE
from satdump_tpu_torch.geo import projs as tprojs
from satdump_tpu_torch.geo import raytrace as trt
from satdump_tpu_torch.geo import reproject as trep
from satdump_tpu_torch.geo import warp as twarp
from satdump_tpu_torch.geo.tle import TLE as TTLE

N19_L1 = "1 33591U 09005A   21100.47420639  .00000090  00000-0  74103-4 0  9998"
N19_L2 = "2 33591  99.1922 114.0067 0013577 245.5357 114.4418 14.12500029627277"

WARP_COORD_TOL = 1e-6      # pixels, the device evaluation against float64
WARP_PIXEL_SHARE = 1e-4    # share of warped pixels that may differ by 1


def _tles():
    return (JTLE.parse("NOAA 19", N19_L1, N19_L2),
            TTLE.parse("NOAA 19", N19_L1, N19_L2))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a, b, equal_nan=True)


def _pixels_close(a, b):
    """At most WARP_PIXEL_SHARE of the pixels differ, each by <= 1 LSB
    (a pixel whose source point sits on the image's edge may switch
    between inside and outside: those count in the share too)."""
    assert a.shape == b.shape and a.dtype == b.dtype
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    n = int((d > 0).sum())
    assert n <= max(1, WARP_PIXEL_SHARE * d.size), (n, d.size)
    return n


PASS_START = 3000.0        # s after the TLE's epoch: over Australia
WRAP_START = 26760.0       # a pass crossing the antimeridian at ~40 N


def _pass_cfg(lines, start=PASS_START, **extra):
    jt, _ = _tles()
    ts = jt.epoch_unix + start + np.arange(lines) / 6.0
    return dict({"timestamps": ts.tolist(), "image_width": 2048,
                 "scan_angle": 110.6}, **extra)


@pytest.mark.parametrize("extra", [
    {},
    {"invert_scan": True, "roll_offset": -0.03, "timestamp_offset": 0.3},
    {"rotate_yaw": True, "yaw_offset_asc": 1.5, "yaw_offset_des": -2.0},
    {"rotate_yaw": True, "pitch_offset": 0.4, "yaw_offset": 0.7},
])
def test_normal_line_raytracer_bit_exact(extra, rng):
    jt, tt = _tles()
    cfg = _pass_cfg(40, **extra)
    cfg["timestamps"][3] = -1.0                     # a bad line
    x = rng.uniform(0, 2048, 500)
    y = rng.uniform(0, 40, 500)
    for a, b in zip(jrt.NormalLineRaytracer(cfg, jt).get_latlon(x, y),
                    trt.NormalLineRaytracer(cfg, tt).get_latlon(x, y)):
        _same(a, b)


def test_per_ifov_and_manual_raytracers_bit_exact(rng):
    jt, tt = _tles()
    cfg = {"timestamps": (jt.epoch_unix + np.arange(30 * 4) * 0.2).tolist(),
           "image_width": 30 * 3, "ifov_count": 30, "ifov_x_size": 3,
           "ifov_y_size": 3, "ifov_x_scan_angle": 3.3,
           "ifov_y_scan_angle": 3.3, "yaw_offset": 0.5}
    x = rng.uniform(0, 90, 300)
    y = rng.uniform(0, 13, 300)
    for a, b in zip(jrt.NormalPerIFOVRaytracer(cfg, jt).get_latlon(x, y),
                    trt.NormalPerIFOVRaytracer(cfg, tt).get_latlon(x, y)):
        _same(a, b)
    pts = {str(k): [r, p, 0.0] for k, r, p in
           ((0, -50.0, 0.2), (300, -20.0, 0.1), (512, 0.0, 0.0),
            (800, 25.0, -0.1), (1023, 52.0, -0.3))}
    cfg = {"timestamps": (jt.epoch_unix + np.arange(8) * 0.5).tolist(),
           "image_width": 1024, "points": pts, "yaw_offset": 0.2}
    x = rng.uniform(0, 1100, 300)
    y = rng.uniform(0, 8, 300)
    for a, b in zip(jrt.ManualLineRaytracer(cfg, jt).get_latlon(x, y),
                    trt.ManualLineRaytracer(cfg, tt).get_latlon(x, y)):
        _same(a, b)


def test_timestamp_filters_and_proj_settings(rng):
    ts = 1.7e9 + np.arange(200) * 0.2
    ts[[5, 50]] = -1
    ts[70] += 1e4
    ts[90] = ts[89]
    tf = {"type": "simple", "scan_time": 0.2, "max_diff": 1.0}
    _same(jrt.filter_timestamps_cfg(ts, tf), trt.filter_timestamps_cfg(ts, tf))
    _same(jrt.interpolate_timestamps(ts[:20], 8, 0.15),
          trt.interpolate_timestamps(ts[:20], 8, 0.15))
    for name in ("metop_abc_avhrr", "meteor_msumr", "jpss_atms"):
        jcfg = jrt.load_proj_settings(name, norad=1, timestamps=ts.tolist())
        tcfg = trt.load_proj_settings(name, norad=1, timestamps=ts.tolist())
        assert jcfg == tcfg
        a = jrt.prepare_proj_timestamps(jcfg)
        b = trt.prepare_proj_timestamps(tcfg)
        _same(a["timestamps"], b["timestamps"])


def test_compute_gcps_bit_exact():
    jt, tt = _tles()
    # the TLE carried in the cfg, and passed by the caller
    cfg = _pass_cfg(120, type="normal_single_line", tle=jt.to_json(),
                    timefilter={"type": "simple", "scan_time": 0.2,
                                "max_diff": 1.0})
    _same(jrt.compute_gcps(cfg, 2048, 120), trt.compute_gcps(cfg, 2048, 120))
    cfg.pop("tle")
    g = trt.compute_gcps(cfg, 2048, 120, tle=tt, nx=9, ny=12)
    _same(jrt.compute_gcps(cfg, 2048, 120, tle=jt, nx=9, ny=12), g)
    assert g.shape[1] == 4 and 90 <= len(g) <= 108
    with pytest.raises(ValueError, match="lacks a TLE"):
        trt.compute_gcps(cfg, 2048, 120)
    with pytest.raises(ValueError, match="unknown raytracer"):
        trt.make_raytracer(dict(cfg, type="nope"), tt)


PROJ_CFGS = [
    {"type": "equirect", "lon0": 10.0, "lat_ts": 20.0},
    {"type": "webmerc", "lon0": -5.0},
    {"type": "stereo", "lon0": 0.0, "lat0": 90.0},
    {"type": "stereo", "lon0": 30.0, "lat0": -90.0},
    {"type": "geos", "lon0": 0.0},
    {"type": "geos", "lon0": -75.0, "sweep_x": True},
    {"type": "tmerc", "lon0": 9.0, "lat0": 3.0},
    {"type": "tpers", "lon0": 10.0, "lat0": 20.0, "altitude": 3.6e7},
    {"type": "tpers", "lon0": 10.0, "lat0": 20.0, "altitude": 8e5,
     "tilt": 20.0, "azi": 30.0},
]


@pytest.mark.parametrize("cfg", PROJ_CFGS, ids=lambda c: c["type"])
def test_projections_bit_exact(cfg, rng):
    lon = rng.uniform(-180, 180, 400)
    lat = rng.uniform(-89, 89, 400)
    jx, jy = jprojs.forward(cfg, lon, lat)
    tx, ty = tprojs.forward(cfg, lon, lat)
    _same(jx, tx)
    _same(jy, ty)
    ok = np.isfinite(jx)
    for a, b in zip(jprojs.inverse(cfg, jx[ok], jy[ok]),
                    tprojs.inverse(cfg, tx[ok], ty[ok])):
        _same(a, b)
    with pytest.raises(ValueError, match="unknown projection"):
        tprojs.forward({"type": "nope"}, lon, lat)


@pytest.mark.parametrize("target", [
    {"type": "stereo", "lon0": 10.0, "lat0": 90.0},
    {"type": "geos", "lon0": 0.0},
    {"type": "webmerc"},
])
def test_reproject_equirect_bit_exact(target, rng):
    img = rng.integers(0, 65535, (90, 160, 3)).astype(np.uint16)
    georef = {"lon_min": -20.0, "lon_max": 40.0, "lat_min": 30.0,
              "lat_max": 62.0}
    a, ga = jrep.reproject(img, georef, target, out_width=200)
    b, gb = trep.reproject(img, georef, target, out_width=200)
    _same(a, b)
    assert ga == gb


def test_reproject_any_pair_bit_exact(rng):
    src = {"type": "geos", "lon0": 0.0, "scalar_x": 3000.403165817 * 16,
           "scalar_y": -3000.403165817 * 16,
           "offset_x": -5568748.275756353, "offset_y": 5568748.275756353}
    img = rng.integers(0, 255, (232, 232)).astype(np.uint8)
    for tgt in ({"type": "equirect"}, {"type": "stereo", "lat0": 90.0}):
        a, ga = jrep.reproject(img, src, tgt, out_width=180)
        b, gb = trep.reproject(img, src, tgt, out_width=180)
        _same(a, b)
        assert ga == gb
    x, y = jrep.src_pixel_coords(src, np.array([1.0, 20.0]),
                                 np.array([3.0, 40.0]))
    _same(np.stack([x, y]), np.stack(trep.src_pixel_coords(
        src, np.array([1.0, 20.0]), np.array([3.0, 40.0]))))


def _pass_gcps(lines=240, start=PASS_START):
    jt, tt = _tles()
    cfg = _pass_cfg(lines, start)
    g = trt.compute_gcps(cfg, 2048, lines, tle=tt)
    _same(jrt.compute_gcps(cfg, 2048, lines, tle=jt), g)
    return g


def test_tps_small_evaluation_bit_exact(rng):
    """Below 2^20 entries both packages evaluate in float64 NumPy."""
    g = _pass_gcps(60)
    src = g[:, 2:]
    js = jwarp.ThinPlateSpline(src, g[:, :2], reg=1e-6)
    ts = twarp.ThinPlateSpline(src, g[:, :2], reg=1e-6, device="cpu")
    _same(js.w, ts.w)
    _same(js.a, ts.a)
    q = np.stack([rng.uniform(src[:, 0].min(), src[:, 0].max(), 900),
                  rng.uniform(src[:, 1].min(), src[:, 1].max(), 900)], -1)
    assert len(q) * len(src) < twarp.DEVICE_ENTRIES
    _same(js(q), ts(q))


def test_tps_device_evaluation_against_float64(rng):
    """At or above 2^20 entries: the port's float64 torch evaluation
    against the JAX package's float64 evaluation, banded against one
    shot; and the JAX package's float32 device form, which is whole pixels
    off (the divergence of ROADMAP §3)."""
    g = _pass_gcps()
    src = g[:, 2:]
    js = jwarp.ThinPlateSpline(src, g[:, :2], reg=1e-6)
    ts = twarp.ThinPlateSpline(src, g[:, :2], reg=1e-6, device="cpu")
    q = np.stack(np.meshgrid(
        np.linspace(src[:, 0].min(), src[:, 0].max(), 160),
        np.linspace(src[:, 1].max(), src[:, 1].min(), 90)), -1)
    assert q.size // 2 * len(src) >= twarp.DEVICE_ENTRIES
    ref = js._eval_np(q.reshape(-1, 2))
    got = ts(q).reshape(-1, 2)
    assert np.abs(got - ref).max() <= WARP_COORD_TOL
    banded = ts._eval_torch(q.reshape(-1, 2), band=1000)
    _same(banded, ts._eval_torch(q.reshape(-1, 2)))
    assert np.abs(js._eval_jax(q.reshape(-1, 2)) - ref).max() > 1.0


@pytest.fixture
def jax_warp_float64(monkeypatch):
    """The JAX package's warp with its spline evaluated in its own float64
    form at every size."""
    monkeypatch.setattr(jwarp.ThinPlateSpline, "_eval_jax",
                        jwarp.ThinPlateSpline._eval_np)


@pytest.mark.parametrize("start", [PASS_START, WRAP_START],
                         ids=["pass", "antimeridian"])
def test_warp_pass_against_jax(rng, jax_warp_float64, start):
    g = _pass_gcps(start=start)
    if start == WRAP_START:
        assert np.ptp(g[:, 2]) > 180.0
    img = rng.integers(0, 65535, (240, 2048)).astype(np.uint16)
    a, ga = jwarp.warp_to_equirect(img, g, out_width=300)
    b, gb = twarp.warp_to_equirect(img, g, out_width=300, device="cpu")
    assert ga == gb and a.shape == (ga["height"], 300)
    assert 300 * ga["height"] * len(g) >= twarp.DEVICE_ENTRIES
    _pixels_close(a, b)
    assert (b > 0).mean() > 0.15
    rgb = rng.integers(0, 255, (240, 2048, 3)).astype(np.uint8)
    a, _ = jwarp.warp_to_equirect(rgb, g, out_width=200)
    b, _ = twarp.warp_to_equirect(rgb, g, out_width=200, device="cpu")
    _pixels_close(a, b)


def _wrap_gcps(lon0=172.0):
    """GCPs of a smooth image -> lon/lat mapping whose longitudes cross
    the antimeridian (wrapped to [-180, 180))."""
    h, w = 64, 96
    xs, ys = np.meshgrid(np.linspace(0, w - 1, 10), np.linspace(0, h - 1, 9))
    lon = lon0 + xs * 0.15 + ys * 0.01
    lon = (lon + 180.0) % 360.0 - 180.0
    lat = 50.0 - ys * 0.1 + xs * 0.01
    return np.stack([xs.ravel(), ys.ravel(), lon.ravel(), lat.ravel()], -1)


def test_warps_across_the_antimeridian(rng, jax_warp_float64):
    g = _wrap_gcps()
    assert g[:, 2].max() - g[:, 2].min() > 180.0
    img = rng.integers(1, 255, (64, 96)).astype(np.uint8)
    a, ga = jwarp.warp_to_equirect(img, g, out_width=512)
    b, gb = twarp.warp_to_equirect(img, g, out_width=512, device="cpu")
    assert ga == gb and gb["lon_min"] > 170.0 and gb["lon_max"] > 180.0
    assert 512 * ga["height"] * len(g) >= twarp.DEVICE_ENTRIES
    _pixels_close(a, b)
    assert (b > 0).mean() > 0.5
    a, ga = jwarp.smart_warp_to_equirect(img, g, out_width=512, tile=128,
                                         gcps_per_tile=40)
    b, gb = twarp.smart_warp_to_equirect(img, g, out_width=512, tile=128,
                                         gcps_per_tile=40, device="cpu")
    assert ga == gb
    _pixels_close(a, b)


def test_smart_warp_pass_against_jax(rng, jax_warp_float64):
    g = _pass_gcps()
    img = rng.integers(0, 255, (240, 2048)).astype(np.uint8)
    a, ga = jwarp.smart_warp_to_equirect(img, g, out_width=1024, tile=256)
    b, gb = twarp.smart_warp_to_equirect(img, g, out_width=1024, tile=256,
                                         device="cpu")
    assert ga == gb
    _pixels_close(a, b)
    assert (b > 0).mean() > 0.15


def test_warp_on_cuda_without_a_card_raises():
    import torch

    from satdump_tpu_torch.core.exceptions import SatdumpError
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    g = _wrap_gcps()
    with pytest.raises(SatdumpError, match="cuda"):
        twarp.warp_to_equirect(np.zeros((64, 96), np.uint8), g,
                               out_width=512)


def test_iers_store_bit_exact(tmp_path):
    from satdump_tpu.geo import iers as jiers
    from satdump_tpu_torch.geo import iers as tiers
    fin = ("24 1 1 60310.00 I  0.012345 0.000020  0.345678 0.000020  I"
           "-0.0123456 0.0000050  0.1234 0.0100  P")
    fin2 = fin.replace("60310.00", "60311.00").replace("0.012345", "0.013345")
    leaps = "# list\n3692217600 37 # 1 Jan 2017\n3644697600 36\n"
    j = jiers.IERSStore(str(tmp_path / "j.json"))
    t = tiers.IERSStore(str(tmp_path / "t.json"))
    for s in (j, t):
        s.update_from_text(fin + "\n" + fin2)
        s.update_from_text(leaps)
    assert (tmp_path / "j.json").read_text() == \
        (tmp_path / "t.json").read_text()
    tu = (60310.5 - 40587.0) * 86400.0
    ji, ti = j.get(tu), t.get(tu)
    assert astuple(ji) == astuple(ti) and ti.leap_seconds == 37
    _same(jiers.polar_motion_matrix(ji), tiers.polar_motion_matrix(ti))
    tt = tu + np.arange(5) * 3600.0
    _same(jiers.gast(tt, ji), tiers.gast(tt, ti))
    _same(np.stack(jiers.nutation_iau2000b(tt)),
          np.stack(tiers.nutation_iau2000b(tt)))
    r = np.array([[7000.0, 100.0, 50.0]])
    _same(jiers.eci_to_ecef_iers(r, tu, ji), tiers.eci_to_ecef_iers(r, tu, ti))


def test_spk_writer_and_reader_bit_exact(tmp_path, rng):
    from satdump_tpu.geo import spk as jspk
    from satdump_tpu_torch.geo import spk as tspk
    segs = [{"target": 3, "center": 0, "init": 0.0, "intlen": 86400.0,
             "coeffs": rng.normal(0, 1e6, (4, 3, 7))},
            {"target": 301, "center": 3, "init": 0.0, "intlen": 43200.0,
             "coeffs": rng.normal(0, 1e4, (8, 3, 5))}]
    jspk.write_spk_type2(str(tmp_path / "j.bsp"), segs)
    tspk.write_spk_type2(str(tmp_path / "t.bsp"), segs)
    assert (tmp_path / "j.bsp").read_bytes() == \
        (tmp_path / "t.bsp").read_bytes()
    js = jspk.SPK.load(str(tmp_path / "j.bsp"))
    ts = tspk.SPK.load(str(tmp_path / "j.bsp"))
    for et in (1000.0, 200000.0):
        _same(js.position(301, 0, et), ts.position(301, 0, et))
        _same(js.position(3, 301, et), ts.position(3, 301, et))
