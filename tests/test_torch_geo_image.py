"""The port's map overlays, shapefile and GeoJSON readers, GeoTIFF writer
and text against satdump_tpu's, on the CPU: bit for bit, on a shapefile
written here with struct. Text is the port's own bitmap font (the JAX
package draws with Pillow), so it is checked by its geometry and colour,
and the font's glyphs against the Pillow font they were taken from."""

import json
import struct

import numpy as np
import pytest

from satdump_tpu.geo import shapefile as jshp
from satdump_tpu.image import geotiff as jtif
from satdump_tpu.image import overlay as jov
from satdump_tpu_torch.geo import shapefile as tshp
from satdump_tpu_torch.image import geotiff as ttif
from satdump_tpu_torch.image import overlay as tov
from satdump_tpu_torch.image import text as ttext


def write_shapefile(path, shape_type, records):
    """An ESRI .shp: the 100-byte header (big-endian file code 9994 and
    length in 16-bit words, little-endian version 1000, shape type and
    bounding box), then one record a geometry (big-endian number and
    content length, little-endian content). A Point record is (x, y); a
    PolyLine / Polygon one is a list of parts, each an (N, 2) array; None
    writes a Null record."""
    body = bytearray()
    allpts = []
    for i, rec in enumerate(records, 1):
        if rec is None:
            content = struct.pack("<i", 0)
        elif shape_type == 1:
            content = struct.pack("<idd", 1, *rec)
            allpts.append(rec)
        else:
            pts = np.concatenate(rec)
            allpts.extend(map(tuple, pts))
            starts = np.cumsum([0] + [len(p) for p in rec[:-1]])
            content = (struct.pack("<i4d", shape_type, *pts.min(0),
                                   *pts.max(0))
                       + struct.pack("<ii", len(rec), len(pts))
                       + struct.pack(f"<{len(rec)}i", *starts)
                       + pts.astype("<f8").tobytes())
        body += struct.pack(">ii", i, len(content) // 2) + content
    a = np.asarray(allpts, np.float64)
    hdr = (struct.pack(">7i", 9994, 0, 0, 0, 0, 0, (100 + len(body)) // 2)
           + struct.pack("<2i", 1000, shape_type)
           + struct.pack("<8d", *a.min(0), *a.max(0), 0, 0, 0, 0))
    path.write_bytes(hdr + bytes(body))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a, b)


def _cities(rng, n=40):
    return np.stack([rng.uniform(-170, 170, n), rng.uniform(-70, 70, n)], 1)


def test_shapefile_points_and_polylines(tmp_path, rng):
    pts = _cities(rng)
    write_shapefile(tmp_path / "p.shp", 1,
                    [tuple(p) for p in pts[:20]] + [None]
                    + [tuple(p) for p in pts[20:]])
    jt, jg = jshp.read_shapefile(tmp_path / "p.shp")
    tt, tg = tshp.read_shapefile(tmp_path / "p.shp")
    assert jt == tt == 1 and len(tg) == 1
    _same(jg[0], tg[0])
    _same(tg[0], pts)
    lines = [[np.cumsum(rng.normal(0, 1, (k, 2)), 0) for k in (5, 1, 9)],
             [np.array([[0.0, 0.0], [3.0, 4.0]])]]
    for stype in (3, 5):
        write_shapefile(tmp_path / "l.shp", stype, [lines[0], None,
                                                    lines[1]])
        jt, jg = jshp.read_shapefile(tmp_path / "l.shp")
        tt, tg = tshp.read_shapefile(tmp_path / "l.shp")
        assert jt == tt == stype
        assert len(tg) == len(jg) == 3     # the 1-point part is dropped
        for a, b in zip(jg, tg):
            _same(a, b)
        _same(tg[1], lines[0][2])


def _geojson(tmp_path):
    gj = {"type": "FeatureCollection", "features": [
        {"type": "Feature", "geometry": {
            "type": "LineString",
            "coordinates": [[-10.0, 0.0], [10.0, 0.0], [10.0, 20.0]]}},
        {"type": "Feature", "geometry": {
            "type": "Polygon",
            "coordinates": [[[0, 0], [5, 0], [5, 5], [0, 0]]]}},
        {"type": "Feature", "geometry": {
            "type": "MultiPolygon",
            "coordinates": [[[[20, 20], [25, 20], [25, 26], [20, 20]]],
                            [[[-60, -30], [-50, -35], [-60, -30]]]]}},
        {"type": "Feature", "geometry": {
            "type": "MultiLineString",
            "coordinates": [[[100, 10, 5], [120, 15, 5]], [[0, 80]]]}},
        {"type": "Other"},
    ]}
    p = tmp_path / "m.geojson"
    p.write_text(json.dumps(gj))
    return p


def _to_xy(lon, lat):
    return (np.asarray(lon) + 180.0, 90.0 - np.asarray(lat))


def test_geojson_and_overlays_bit_exact(tmp_path, rng):
    p = _geojson(tmp_path)
    jl, tl = jshp.read_geojson(p), tshp.read_geojson(p)
    assert len(jl) == len(tl) == 5
    for a, b in zip(jl, tl):
        _same(a, b)
    lines = [np.cumsum(rng.normal(0, 2, (30, 2)), 0) for _ in range(4)]
    write_shapefile(tmp_path / "c.shp", 3, [lines[:2], lines[2:]])
    for dtype, shape, color in ((np.uint8, (180, 360, 3), (0, 255, 0)),
                                (np.uint16, (180, 360), (4000,))):
        a = np.zeros(shape, dtype)
        b = np.zeros(shape, dtype)
        for img, ov in ((a, jov), (b, tov)):
            ov.draw_map_overlay(img, _to_xy, str(p), color, thickness=3)
            ov.draw_map_overlay(img, _to_xy, str(tmp_path / "c.shp"), color)
            ov.draw_latlon_grid(img, _to_xy, color, spacing_deg=15)
            ov.draw_polylines(img, _to_xy, lines, color, max_length=20.0)
        _same(a, b)
        assert b[90, 175].max() > 0          # on the equator segment


def test_geotiff_bytes_and_tags(tmp_path, rng):
    for img in (rng.integers(0, 255, (40, 60)).astype(np.uint8),
                rng.integers(0, 65535, (30, 50, 3)).astype(np.uint16),
                rng.integers(0, 255, (20, 10, 2)).astype(np.uint8)):
        jtif.save_geotiff(img, tmp_path / "j.tif", -30.0, 60.0, 0.25, 0.5)
        ttif.save_geotiff(img, tmp_path / "t.tif", -30.0, 60.0, 0.25, 0.5)
        data = (tmp_path / "t.tif").read_bytes()
        assert (tmp_path / "j.tif").read_bytes() == data
        tags = ttif.read_geotiff_tags(tmp_path / "t.tif")
        assert tags == jtif.read_geotiff_tags(tmp_path / "t.tif")
        assert tags["width"] == img.shape[1] and tags["height"] == img.shape[0]
        assert (tags["lon_min"], tags["lat_max"]) == (-30.0, 60.0)
        assert (tags["lon_res"], tags["lat_res"]) == (0.25, 0.5)
        assert tags["geo_keys"] == {1024: 2, 1025: 1, 2048: 4326}
        # the single strip is the last thing in the file
        assert data[-img.nbytes:] == np.ascontiguousarray(img).astype(
            img.dtype.newbyteorder("<")).tobytes()


def test_font_is_pillows_bitmap_default():
    from PIL import ImageFont
    f = ImageFont.load_default_imagefont()
    for c in range(32, 127):
        m = f.getmask(chr(c))
        ref = np.array(m, np.uint8).reshape(m.size[1], m.size[0]) > 0
        _same(ttext.text_mask(chr(c)), ref)


def test_text_geometry_and_colour(rng):
    img = rng.integers(0, 50, (40, 120, 3)).astype(np.uint8)
    before = img.copy()
    out = ttext.draw_text(img, "NOAA 19", (4, 5), (0, 255, 0))
    assert np.array_equal(img, before)           # drawn on a copy
    changed = np.any(out != img, axis=2)
    ys, xs = np.nonzero(changed)
    # inside the 7 x (6 x 11) cells from (4, 5), in the colour given
    assert xs.min() >= 4 and xs.max() < 4 + 7 * 6
    assert ys.min() >= 5 and ys.max() < 5 + 11
    assert (out[changed] == [0, 255, 0]).all()
    mask = ttext.text_mask("NOAA 19")
    assert mask.shape == (11, 42)
    assert np.array_equal(changed[5:16, 4:46], mask)
    assert not mask[:, 24:30].any()                   # the space
    for c in "NOA19":                                 # each glyph inks
        assert ttext.text_mask(c).sum() > 4
    # uint16 and 2-D: the colour shifted up 8 bits; clipped at the edges
    g = np.zeros((20, 30), np.uint16)
    out = ttext.draw_text(g, "WW", (25, 15), (200,))
    assert set(np.unique(out)) == {0, 200 << 8}
    assert np.array_equal(out[15:20, 25:30] > 0, ttext.text_mask("W")[:5, :5])
    assert ttext.draw_text(g, "x", (-20, 0), (1,)).sum() == 0
    # outside printable ASCII draws '?'
    assert np.array_equal(ttext.text_mask("é"), ttext.text_mask("?"))


def test_text_font_path_raises():
    from satdump_tpu_torch.core.exceptions import SatdumpError
    with pytest.raises(SatdumpError, match="TrueType"):
        ttext.draw_text(np.zeros((8, 8), np.uint8), "a", (0, 0), (1,),
                        font_path="DejaVuSans.ttf")


def test_city_labels(rng):
    pts = np.array([[10.0, 20.0], [400.0, 0.0], [-170.0, 80.0],
                    [np.nan, 0.0], [0.0, -85.0]])
    names = ["Aa", "offscreen", "Bb", "nan", "Cc"]
    img = np.zeros((180, 360, 3), np.uint8)
    out = ttext.draw_city_labels(img, _to_xy, pts, names, (255, 0, 0),
                                 max_labels=2)
    assert img.sum() == 0
    exp = ttext.draw_text(img, "Aa", (190, 70), (255, 0, 0))
    exp = ttext.draw_text(exp, "Bb", (10, 10), (255, 0, 0))
    _same(out, exp)
