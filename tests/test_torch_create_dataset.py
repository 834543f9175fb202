"""The port's dataset preparation (`spnerf_torch.data.create_dataset`)
against the JAX package's, on a raw DFC2019 AOI written by
`spnerf_torch.utils.synth_scene.write_raw_aoi` (numpy seed; 4 images whose
crop is about 60 px over a 40-cell ROI).

Tolerances: the RPC tag round trip exact; the ROI's lon/lat corners within
1e-9 degrees; cropped GeoTIFFs byte for byte; every JSON equal, floats
within 1e-9 (relative and absolute); the splits and `<aoi>_sunangles.txt`
identical; the three sun-angle sources equal; `run_ba` (a stub
`bundle_adjust` in `sys.modules`) and an existing `ba_files/` give equal
outputs. Being copies of the same numpy code, all are expected equal.

One deliberate difference: the port's crop keeps the image's GDAL-metadata
tag (42112), so a cropped image keeps its NITF sun angles; the JAX
package's crop drops the tag and its JSONs of a cropped AOI get 0. On a
raw AOI without that tag both agree byte for byte; with it, the port's
cropped file is the JAX package's writer's output with the tag added, and
the port's angles and date are those the JAX package reads from the
uncropped images.

Last, the prepared dataset with depth from `synthesize_depth_from_lidar`
loads through both packages' scene loaders to the same rays (1e-6), as
`tests/test_torch_data.py` holds the loaders.
"""

import json
import os
import shutil
import sys
import types

import numpy as np
import pytest

from spnerf_tpu.data import create_dataset as jcd
from spnerf_tpu.data import dataset as jdataset
from spnerf_tpu.data import synth_depth as jsd
from spnerf_tpu.io import read_geotiff as jax_read_geotiff
from spnerf_tpu.io import write_geotiff as jax_write_geotiff
from spnerf_torch.data import create_dataset as tcd
from spnerf_torch.data import dataset as tdataset
from spnerf_torch.data import synth_depth as tsd
from spnerf_torch.utils.synth_scene import raw_image_xml, write_raw_aoi

AOI = "JAX_269"
RAW = dict(crop_px=60, roi_size=40, seed=3)


def assert_json_equal(a, b, path=""):
    """Equal structure and strings, floats within 1e-9."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_json_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_json_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9, err_msg=path)
    else:
        assert a == b, (path, a, b)


def read_json(path):
    with open(path) as f:
        return json.load(f)


def file_bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """{True: a raw AOI with tag 42112, False: one without}."""
    root = tmp_path_factory.mktemp("raw")
    return {meta: (str(root / str(meta)),
                   write_raw_aoi(str(root / str(meta)), sun_metadata=meta,
                                 **RAW))
            for meta in (True, False)}


@pytest.fixture(scope="module")
def prepared(raw, tmp_path_factory):
    """Both packages' create_satellite_dataset outputs per raw AOI, the
    port's through its command line."""
    root = tmp_path_factory.mktemp("prepared")
    out = {}
    for meta, (src, _) in raw.items():
        ours = tcd.main(["--aoi_id", AOI, "--dataset_dir", src,
                         "--output_dir", str(root / f"port{meta}"),
                         "--seed", "5"])
        ref = jcd.create_satellite_dataset(AOI, src, str(root / f"jax{meta}"),
                                           seed=5)
        out[meta] = (ours, ref)
    return out


def test_rpc_tag_round_trip_is_exact(raw, tmp_path):
    src = os.path.join(raw[True][0], "RGB", AOI, f"{AOI}_001_RGB.tif")
    rpc = tcd.rpc_from_geotiff(src)
    jrpc = jcd.rpc_from_geotiff(src)
    block = tcd.rpc_to_geotiff_tag(rpc)
    np.testing.assert_array_equal(block, jcd.rpc_to_geotiff_tag(jrpc))
    assert block.shape == (92,)
    img = np.zeros((5, 6, 3), np.uint8)
    path = str(tmp_path / "img.tif")
    jax_write_geotiff(path, img, extra_double_tags={tcd._T_RPC: block})
    back = tcd.rpc_from_geotiff(path)
    assert back.to_dict() == rpc.to_dict() == jrpc.to_dict()
    with pytest.raises(ValueError, match="50844"):
        tcd.rpc_from_geotiff(os.path.join(raw[True][0], "Truth",
                                          f"{AOI}_DSM.tif"))


def test_read_roi_lonlat_matches_jax(raw):
    ours = tcd.read_roi_lonlat(AOI, raw[True][0])
    ref = jcd.read_roi_lonlat(AOI, raw[True][0])
    assert ours.shape == (4, 2)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-9)
    with pytest.raises(ValueError, match="zone table"):
        tcd.read_roi_lonlat("XYZ_1", raw[True][0])


def test_prepared_dataset_matches_jax_without_tag_42112(prepared):
    (out, img_dir, json_dir), (jout, jimg_dir, jjson_dir) = prepared[False]
    names = sorted(os.listdir(jimg_dir))
    assert names == sorted(os.listdir(img_dir)) and len(names) == 4
    for name in names:
        assert file_bytes(os.path.join(img_dir, name)) == file_bytes(
            os.path.join(jimg_dir, name)), name
    files = sorted(os.listdir(jjson_dir))
    assert files == sorted(os.listdir(json_dir))
    for name in files:
        if name.endswith(".json"):
            ours = read_json(os.path.join(json_dir, name))
            assert_json_equal(ours, read_json(os.path.join(jjson_dir, name)))
            assert ours["sun_elevation"] == 0.0
        else:
            assert file_bytes(os.path.join(json_dir, name)) == file_bytes(
                os.path.join(jjson_dir, name)), name
    train = open(os.path.join(json_dir, "train.txt")).read().split()
    test = open(os.path.join(json_dir, "test.txt")).read().split()
    assert len(train) == len(test) == 2
    sun = f"{AOI}_sunangles.txt"
    assert file_bytes(os.path.join(out, sun)) == file_bytes(
        os.path.join(jout, sun))
    for sub in ("Truth",):
        for name in os.listdir(os.path.join(jout, sub)):
            assert file_bytes(os.path.join(out, sub, name)) == file_bytes(
                os.path.join(jout, sub, name))


def test_crop_keeps_tag_42112_and_the_sun_angles(raw, prepared, tmp_path):
    src, written = raw[True]
    (out, img_dir, json_dir), (jout, jimg_dir, jjson_dir) = prepared[True]
    for name in sorted(os.listdir(jimg_dir)):
        # the JAX package's crop, written again with the raw image's tag
        arr, profile = jax_read_geotiff(os.path.join(jimg_dir, name))
        rpc = jcd.rpc_from_geotiff(os.path.join(jimg_dir, name))
        xml = jcd._gdal_metadata_items(os.path.join(src, "RGB", AOI, name))
        assert xml and not jcd._gdal_metadata_items(
            os.path.join(jimg_dir, name))
        expect = str(tmp_path / name)
        jax_write_geotiff(expect, arr, profile=profile,
                          extra_double_tags={jcd._T_RPC:
                                             jcd.rpc_to_geotiff_tag(rpc)},
                          extra_ascii_tags={jcd._T_GDAL_METADATA:
                                            tcd._gdal_metadata_xml(os.path.join(
                                                src, "RGB", AOI, name))})
        assert file_bytes(os.path.join(img_dir, name)) == file_bytes(expect)
    # the JAX package's angles from the uncropped images
    uncropped = jcd.create_satellite_dataset(
        AOI, src, str(tmp_path / "uncropped"), crop_aoi=False, seed=5)[2]
    for name in sorted(f for f in os.listdir(jjson_dir)
                       if f.endswith(".json")):
        ours = read_json(os.path.join(json_dir, name))
        ref = read_json(os.path.join(jjson_dir, name))
        full = read_json(os.path.join(uncropped, name))
        keys = ("sun_elevation", "sun_azimuth", "acquisition_date")
        assert_json_equal({k: v for k, v in ours.items() if k not in keys},
                          {k: v for k, v in ref.items() if k not in keys})
        assert ref["sun_elevation"] == ref["sun_azimuth"] == 0.0
        assert [ours[k] for k in keys] == [full[k] for k in keys]
        assert (ours["sun_elevation"], ours["sun_azimuth"]) == written[
            "sun"][ours["img"]]
    lines = open(os.path.join(out, f"{AOI}_sunangles.txt")).read().split("\n")
    assert lines[0] == (f"{AOI}_000_RGB.tif "
                        f"{written['sun'][f'{AOI}_000_RGB.tif'][0]} "
                        f"{written['sun'][f'{AOI}_000_RGB.tif'][1]}")


@pytest.mark.parametrize("seed", [None, 0, 5, 11])
def test_splits_match_jax(seed):
    ids = [f"im{i}.json" for i in range(4 if seed is None else 3 + seed)]
    if seed is None:
        # unseeded draws differ run to run; only the sizes are fixed
        train, test = tcd.create_train_test_splits(ids)
        assert len(test) == 2 and sorted(train + test) == ids
        return
    assert tcd.create_train_test_splits(ids, seed=seed) == \
        jcd.create_train_test_splits(ids, seed=seed)


@pytest.mark.parametrize("source", ["sidecar_file", "tag_42112",
                                    "use00a_tre"])
def test_sun_angle_sources_match_jax(source, tmp_path):
    img = np.zeros((4, 5, 3), np.uint8)
    rgb = str(tmp_path / f"{AOI}_007_RGB.tif")
    if source == "sidecar_file":
        with open(tmp_path / f"{AOI}_sunangles.txt", "w") as f:
            f.write(f"{AOI}_007_RGB.tif 41.5 133.25\nshort line\n")
        ours = tcd.load_sun_angles(str(tmp_path), AOI)
        assert ours == jcd.load_sun_angles(str(tmp_path), AOI) == {
            f"{AOI}_007_RGB.tif": (41.5, 133.25)}
        assert tcd.load_sun_angles(str(tmp_path), "JAX_1") == {}
        return
    if source == "tag_42112":
        jax_write_geotiff(rgb, img, extra_ascii_tags={
            jcd._T_GDAL_METADATA: raw_image_xml(32.44, 158.26, "20151218")})
        assert tcd._gdal_metadata_items(rgb) == jcd._gdal_metadata_items(rgb)
        ours = tcd.sun_angles_from_image_metadata(rgb)
        assert ours == jcd.sun_angles_from_image_metadata(rgb) == (
            32.4, 158.3, "20151218")
        not_tiff = str(tmp_path / "x.tif")
        with open(not_tiff, "wb") as f:
            f.write(b"not a tiff at all")
        assert tcd._gdal_metadata_items(not_tiff) == {} == \
            jcd._gdal_metadata_items(not_tiff)
        return
    jax_write_geotiff(rgb, img)
    tre = b"0" * 97 + b"+41.2" + b"137.9"
    (tmp_path / f"{AOI}_007_RGB.NTF").write_bytes(
        b"NITF02.10" + b"\x00" * 32 + b"USE00A" + b"00107" + tre)
    (tmp_path / "short.ntf").write_bytes(b"USE00A00107" + tre[:50])
    for p in (tmp_path / f"{AOI}_007_RGB.NTF", tmp_path / "short.ntf"):
        assert tcd._sun_angles_from_use00a(str(p)) == \
            jcd._sun_angles_from_use00a(str(p))
    ours = tcd.sun_angles_from_image_metadata(rgb, msi_dir=str(tmp_path))
    assert ours == jcd.sun_angles_from_image_metadata(
        rgb, msi_dir=str(tmp_path)) == (41.2, 137.9, "")
    assert tcd.sun_angles_from_image_metadata(rgb) == (0.0, 0.0, "")


def stub_bundle_adjust(monkeypatch, calls):
    """A stub sat-bundleadjust package in sys.modules (the API surface
    run_ba uses), as `tests/test_create_dataset.py` builds it."""
    class FakeParams:
        pts_ind = np.array([0, 1])
        cam_ind = np.array([0, 1])
        pts2d = np.array([[9.0, 9.0], [4.5, 2.0]])
        pts3d_ba = np.ones((2, 3))
        cam_prev_indices = [0, 1]

    class FakePipeline:
        def __init__(self, ba_input, tracks_config=None, extra_ba_config=None):
            calls.append((ba_input["in_dir"], tracks_config, extra_ba_config))
            self.out_dir = ba_input["out_dir"]
            self.ba_params = FakeParams()
            self.global_transform = 0.5
            self.images = ba_input["images"]

        def run(self):
            print("stub bundle adjustment ran")

    ba_mod = types.ModuleType("bundle_adjust")
    ba_mod.loader = types.SimpleNamespace(
        save_list_of_paths=lambda path, lst: open(path, "w").write(
            "\n".join(lst) + "\n"))
    pipe_mod = types.ModuleType("bundle_adjust.ba_pipeline")
    pipe_mod.BundleAdjustmentPipeline = FakePipeline
    cam_mod = types.ModuleType("bundle_adjust.cam_utils")
    cam_mod.SatelliteImage = lambda fn, rpc: types.SimpleNamespace(
        geotiff_path=fn, rpc=rpc)
    rpcm_mod = types.ModuleType("rpcm")
    rpcm_mod.rpc_from_geotiff = lambda p: {"path": p}
    for name, mod in (("bundle_adjust", ba_mod),
                      ("bundle_adjust.ba_pipeline", pipe_mod),
                      ("bundle_adjust.cam_utils", cam_mod),
                      ("rpcm", rpcm_mod)):
        monkeypatch.setitem(sys.modules, name, mod)


def compare_trees(ours, ref):
    """Every file under ref equal under ours: JSONs within 1e-9, .npy
    arrays exact, the rest byte for byte (paths made relative)."""
    for dirpath, _, files in os.walk(ref):
        rel = os.path.relpath(dirpath, ref)
        for name in files:
            a, b = os.path.join(ours, rel, name), os.path.join(dirpath, name)
            if name.endswith(".json"):
                assert_json_equal(read_json(a), read_json(b), name)
            elif name.endswith(".npy"):
                np.testing.assert_array_equal(np.load(a), np.load(b))
            elif name.endswith((".txt", ".log")):
                fix = lambda p, root: open(p).read().replace(root, "<out>")
                assert fix(a, ours) == fix(b, ref), name
            else:
                assert file_bytes(a) == file_bytes(b), name


@pytest.mark.parametrize("ba", ["run_ba", "existing_ba_files"])
def test_bundle_adjustment_matches_jax(ba, raw, monkeypatch, tmp_path,
                                       capsys):
    src = raw[False][0]
    outs = {}
    for pkg, mod in (("port", tcd), ("jax", jcd)):
        root = tmp_path / pkg
        if ba == "existing_ba_files":
            params = root / AOI / "ba_files" / "ba_params"
            params.mkdir(parents=True)
            np.save(params / "pts_ind.npy", np.array([0, 1, 2, 0]))
            np.save(params / "cam_ind.npy", np.array([0, 0, 1, 2]))
            np.save(params / "pts2d.npy", np.arange(8.0).reshape(4, 2))
            np.save(params / "pts3d.npy", np.zeros((3, 3)))
            with open(params / "geotiff_paths.txt", "w") as f:
                f.write("\n".join(f"/x/{AOI}_{i:03d}_RGB.tif"
                                  for i in range(4)) + "\n")
            adj = root / AOI / "ba_files" / "rpcs_adj"
            adj.mkdir()
            rpc = tcd.rpc_from_geotiff(os.path.join(
                src, "RGB", AOI, f"{AOI}_002_RGB.tif"))
            d = rpc.to_dict()
            keys = {"LINE_OFF": "row_offset", "SAMP_OFF": "col_offset",
                    "LAT_OFF": "lat_offset", "LONG_OFF": "lon_offset",
                    "HEIGHT_OFF": "alt_offset", "LINE_SCALE": "row_scale",
                    "SAMP_SCALE": "col_scale", "LAT_SCALE": "lat_scale",
                    "LONG_SCALE": "lon_scale", "HEIGHT_SCALE": "alt_scale"}
            lines = [f"{k}: {float(d[v]) + 0.25!r} px" for k, v in keys.items()]
            for pre, v in (("LINE_NUM", "row_num"), ("LINE_DEN", "row_den"),
                           ("SAMP_NUM", "col_num"), ("SAMP_DEN", "col_den")):
                lines += [f"{pre}_COEFF_{i + 1}: {float(c)!r}"
                          for i, c in enumerate(d[v])]
            (adj / f"{AOI}_002_RGB.rpc_adj").write_text("\n".join(lines))
        else:
            calls = []
            stub_bundle_adjust(monkeypatch, calls)
        outs[pkg] = mod.create_satellite_dataset(
            AOI, src, str(root), crop_aoi=False, ba=True, splits=False,
            seed=0)[0]
        if ba == "run_ba":
            assert calls[0][1]["FT_sift_matching"] == "epipolar_based"
            assert calls[0][2] == {"cam_model": "rpc"}
    compare_trees(outs["port"], outs["jax"])
    d = read_json(os.path.join(outs["port"], "JSON", f"{AOI}_000_RGB.json"))
    assert d["keypoints"]["2d_coordinates"] == (
        [[9.0, 9.0]] if ba == "run_ba" else [[0.0, 1.0], [2.0, 3.0]])
    if ba == "existing_ba_files":
        d2 = read_json(os.path.join(outs["port"], "JSON",
                                    f"{AOI}_002_RGB.json"))
        assert d2["rpc"]["row_offset"] == rpc.row_offset + 0.25


def test_run_ba_absent_keeps_the_original_rpcs(raw, tmp_path, capsys):
    for name in ("bundle_adjust", "rpcm"):
        assert name not in sys.modules
    out = tcd.create_satellite_dataset(AOI, raw[False][0], str(tmp_path),
                                       crop_aoi=False, ba=True, splits=False)
    assert "not installed" in capsys.readouterr().out
    d = read_json(os.path.join(out[2], f"{AOI}_000_RGB.json"))
    assert "keypoints" not in d
    assert d["rpc"] == tcd.rpc_from_geotiff(os.path.join(
        raw[False][0], "RGB", AOI, f"{AOI}_000_RGB.tif")).to_dict()


def test_prepared_dataset_loads_like_jax(prepared, tmp_path):
    """The prepared AOI (tag 42112 kept) with depth from the lidar, loaded
    by both scene loaders: the same rays, ids, depths and sun directions."""
    out = prepared[True][0][0]
    copies = {}
    for pkg in ("port", "jax"):
        copies[pkg] = str(tmp_path / pkg)
        shutil.copytree(out, copies[pkg])
    tsd.synthesize_depth_from_lidar(
        os.path.join(copies["port"], "JSON"),
        os.path.join(copies["port"], "Truth"), AOI,
        os.path.join(copies["port"], "Depth"), verbose=False)
    jsd.synthesize_depth_from_lidar(
        os.path.join(copies["jax"], "JSON"),
        os.path.join(copies["jax"], "Truth"), AOI,
        os.path.join(copies["jax"], "Depth"), verbose=False)
    scenes = []
    for pkg, mod in (("port", tdataset), ("jax", jdataset)):
        d = copies[pkg]
        scenes.append(mod.load_scene(
            os.path.join(d, "JSON"), os.path.join(d, "RGB", AOI),
            os.path.join(d, "Depth"), os.path.join(d, "Semantic"), AOI,
            load_depth=True, verbose=False))
    ours, ref = scenes
    assert len(ours) == len(ref) > 0
    assert ours.valid_depth.sum() == ref.valid_depth.sum() > 0
    np.testing.assert_allclose(ours.rays, ref.rays, rtol=0, atol=1e-6)
    for name in ("ids", "valid_depth", "rgbs"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name))
    np.testing.assert_allclose(ours.depths, ref.depths, rtol=1e-6, atol=0)
    # the sun angles of tag 42112 reached the rays: elevations of 40-70
    # degrees, not the horizon that 0 would give
    assert np.abs(ours.rays[:, 10]).min() > 0.6
