"""The port's GeoTIFF and JSON I/O against the JAX package's.

* `write_geotiff` writes the same bytes as the JAX writer, for float32 with a
  transform, an EPSG code and NaN nodata, uint8 RGB, int32 (and int64, which
  both write as int32), multi-band float32 and float64, and extra tags.
* Each package reads the other's files back equal (arrays exactly, profiles
  equal), and the port reads its own files without PIL.
* A compressed TIFF (LZW, written by PIL) reads equal through both packages.
* `jsonio` round trip and `get_file_id`.
"""

import builtins
import os

import numpy as np
import pytest

from spnerf_tpu.io import jsonio as jjson
from spnerf_tpu.io import tiff as jtiff
from spnerf_torch.io import jsonio, tiff


def _cases():
    g = np.random.default_rng(0)
    f32 = g.normal(size=(17, 23)).astype(np.float32) * 10 + 30
    f32[3, 4] = np.nan
    return {
        "float32_geo_nan": (f32, dict(transform=(435520.0, 0.5, 3354480.0,
                                                 -0.5),
                                      epsg=32617, nodata=float("nan"))),
        "uint8_rgb": (g.integers(0, 256, (19, 21, 3)).astype(np.uint8), {}),
        "int32": (g.integers(-5, 70, (9, 11)).astype(np.int32),
                  dict(transform=(1.0, 2.0, 3.0, -2.0), epsg=32615)),
        "int64_as_int32": (g.integers(0, 65, (8, 7)), dict(nodata=-9999.0)),
        "float32_bands": (g.uniform(size=(6, 5, 4)).astype(np.float32), {}),
        "float64": (g.normal(size=(7, 9)), dict(epsg=32617, nodata=1.5)),
        "extra_tags": (g.uniform(size=(4, 4)).astype(np.float32),
                       dict(extra_double_tags={50844: [1.0, 2.5, -3.0]},
                            extra_ascii_tags={42112: "<GDALMetadata/>"})),
    }


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_write_geotiff_bytes_equal_jax(tmp_path, case):
    arr, kw = CASES[case]
    ours, ref = tmp_path / "ours.tif", tmp_path / "ref.tif"
    tiff.write_geotiff(str(ours), arr, **kw)
    jtiff.write_geotiff(str(ref), arr, **kw)
    assert ours.read_bytes() == ref.read_bytes()


def _same_profile(a, b):
    assert set(a) == set(b)
    for k in a:
        if k == "nodata" and a[k] is not None and np.isnan(a[k]):
            assert np.isnan(b[k])
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_package_reads_the_others_files(tmp_path, case):
    arr, kw = CASES[case]
    ours, ref = str(tmp_path / "ours.tif"), str(tmp_path / "ref.tif")
    tiff.write_geotiff(ours, arr, **kw)
    jtiff.write_geotiff(ref, arr, **kw)
    a_ours, p_ours = tiff.read_geotiff(ref)
    a_ref, p_ref = jtiff.read_geotiff(ours)
    np.testing.assert_array_equal(a_ours, a_ref)
    assert a_ours.dtype == a_ref.dtype
    _same_profile(p_ours, p_ref)
    np.testing.assert_array_equal(tiff.read_tiff(ref), jtiff.read_tiff(ours))


def test_port_reads_its_files_without_pil(tmp_path, monkeypatch):
    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real_import(name, *args, **kwargs)

    paths = {}
    for case, (arr, kw) in CASES.items():
        paths[case] = str(tmp_path / f"{case}.tif")
        tiff.write_geotiff(paths[case], arr, **kw)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    for case, (arr, kw) in CASES.items():
        out, prof = tiff.read_geotiff(paths[case])
        want = arr.astype(np.int32) if arr.dtype == np.int64 else arr
        np.testing.assert_array_equal(out, want)
        if "epsg" in kw:
            assert prof["epsg"] == kw["epsg"]


def test_compressed_tiff_reads_through_pil_as_jax(tmp_path):
    from PIL import Image

    g = np.random.default_rng(1)
    rgb = g.integers(0, 256, (31, 29, 3)).astype(np.uint8)
    cls = g.choice(np.array([2, 5, 6, 9, 65], np.uint8), (31, 29))
    for name, arr in (("rgb", rgb), ("cls", cls)):
        path = str(tmp_path / f"{name}.tif")
        Image.fromarray(arr).save(path, compression="tiff_lzw")
        np.testing.assert_array_equal(tiff.read_tiff(path), arr)
        np.testing.assert_array_equal(tiff.read_tiff(path),
                                      jtiff.read_tiff(path))
        _same_profile(tiff.read_geotiff(path)[1], jtiff.read_geotiff(path)[1])


def test_jsonio_round_trip(tmp_path):
    d = {"img": "JAX_269_006_RGB.tif", "height": 793, "rpc": {"a": [1.5, 2]},
         "center": [-81.66, 30.31]}
    ours, ref = str(tmp_path / "ours.json"), str(tmp_path / "ref.json")
    assert jsonio.write_dict_to_json(d, ours) is d
    jjson.write_dict_to_json(d, ref)
    assert open(ours).read() == open(ref).read()
    assert jsonio.read_dict_from_json(ours) == d == jjson.read_dict_from_json(
        ours)
    for name in ("/a/b/JAX_269_006_RGB.tif", "x.json", "noext",
                 os.path.join("d", "f.tar.gz")):
        assert jsonio.get_file_id(name) == jjson.get_file_id(name)
