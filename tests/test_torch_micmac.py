"""The port's MicMac helpers and depth synthesis (`spnerf_torch.data.micmac`,
`spnerf_torch.data.synth_depth`) against the JAX package's, on an AOI made
by `spnerf_torch.utils.synth_scene.write_raw_aoi` (numpy seed) and prepared
by the port's `create_satellite_dataset`.

Tolerances: `utm_to_geocentric` within 1e-6 m; `convert_3dpts_file` text
equal; `cal_rmse_depth` MAE and RMSE within 1e-5 m, coverage exact (the
port's splat on the CPU, float32 `index_add_` against the JAX package's
`segment_sum`); `convert_tiff` byte for byte;
`synthesize_depth_for_image` pts2d equal, pts3d within 1e-6 m, correl
within 1e-6; the files of `synthesize_depth_from_lidar` text equal. The
splat raises without CUDA unless asked for the CPU.
"""

import os

import numpy as np
import pytest
import torch

from spnerf_tpu.data import micmac as jmm
from spnerf_tpu.data import synth_depth as jsd
from spnerf_torch.data import micmac as tmm
from spnerf_torch.data import synth_depth as tsd
from spnerf_torch.data.create_dataset import create_satellite_dataset
from spnerf_torch.io import read_dict_from_json, read_geotiff
from spnerf_torch.utils.synth_scene import write_raw_aoi

AOI = "JAX_269"


@pytest.fixture(scope="module")
def aoi(tmp_path_factory):
    """The prepared AOI's directory (JSON, RGB, Truth) and a Depth dir made
    by the port."""
    root = tmp_path_factory.mktemp("micmac")
    write_raw_aoi(str(root / "raw"), crop_px=60, roi_size=40, seed=4)
    out = create_satellite_dataset(AOI, str(root / "raw"),
                                   str(root / "prepared"), seed=0)[0]
    tsd.synthesize_depth_from_lidar(
        os.path.join(out, "JSON"), os.path.join(out, "Truth"), AOI,
        os.path.join(out, "Depth"), stride=2, verbose=False)
    return out


def text(path):
    with open(path) as f:
        return f.read()


def test_utm_to_geocentric_matches_jax():
    g = np.random.default_rng(0)
    pts = np.stack([g.uniform(4.3e5, 4.5e5, 200), g.uniform(3.34e6, 3.36e6,
                                                             200),
                    g.uniform(-20.0, 100.0, 200)], -1)
    for zone, northern in ((17, True), (15, True), (33, False)):
        ours = tmm.utm_to_geocentric(pts, zone, northern)
        np.testing.assert_allclose(
            ours, jmm.utm_to_geocentric(pts, zone, northern), rtol=0,
            atol=1e-6)
    assert tmm.utm_zone_for_aoi("OMA_42") == jmm.utm_zone_for_aoi("OMA_42")
    with pytest.raises(KeyError, match="AOI_UTM_ZONES"):
        tmm.utm_zone_for_aoi("XYZ_1")


@pytest.mark.parametrize("how", ["aoi_id", "zone", "out_path"])
def test_convert_3dpts_file_text_equal(how, tmp_path):
    g = np.random.default_rng(1)
    pts = np.stack([g.uniform(4.38e5, 4.39e5, 50),
                    g.uniform(3.353e6, 3.354e6, 50), g.uniform(0, 30, 50)], -1)
    files = {}
    for pkg in ("port", "jax"):
        d = tmp_path / pkg
        d.mkdir()
        np.savetxt(d / "X_3DPts.txt", pts)
        files[pkg] = str(d / "X_3DPts.txt")
    kw = {"aoi_id": dict(aoi_id=AOI), "zone": dict(zone=17),
          "out_path": dict(aoi_id="OMA_1")}[how]
    outs = {}
    for pkg, mod in (("port", tmm), ("jax", jmm)):
        out = (os.path.join(os.path.dirname(files[pkg]), "o.txt")
               if how == "out_path" else None)
        outs[pkg] = mod.convert_3dpts_file(files[pkg], out_path=out, **kw)
    assert outs["port"].endswith("o.txt" if how == "out_path"
                                 else "X_3DPts_ecef.txt")
    assert text(outs["port"]) == text(outs["jax"])


def test_cal_rmse_depth_matches_jax(aoi, tmp_path):
    gt = os.path.join(aoi, "Truth")
    name = sorted(f for f in os.listdir(os.path.join(aoi, "Depth"))
                  if f.endswith("_3DPts_ecef.txt"))[0]
    pts = os.path.join(aoi, "Depth", name)
    ours = tmm.cal_rmse_depth(pts, gt, AOI, out_dir=str(tmp_path),
                              device="cpu")
    ref = jmm.cal_rmse_depth(pts, gt, AOI)
    assert set(ours) == set(ref) == {"mae", "rmse", "coverage"}
    for k in ("mae", "rmse"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=0, atol=1e-5)
    assert ours["coverage"] == ref["coverage"] > 0.3
    # depth from the lidar itself: on a 40-cell ROI the splat's blur at
    # the box buildings' edges dominates (0.23 m here); the card's phase
    # holds a 512-cell ROI to 0.05 m
    assert ours["mae"] < 0.5
    dsm, profile = read_geotiff(os.path.join(tmp_path, f"{AOI}_depth_dsm.tif"))
    assert dsm.shape == (40, 40) and profile["epsg"] == 32617


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the CPU-only "
                    "refusal")
def test_dense_depth_to_dsm_needs_the_card_or_cpu(aoi):
    pts = np.loadtxt(os.path.join(aoi, "Depth", sorted(
        f for f in os.listdir(os.path.join(aoi, "Depth"))
        if f.endswith("_3DPts_ecef.txt"))[0]))
    roi = os.path.join(aoi, "Truth", f"{AOI}_DSM.txt")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmm.dense_depth_to_dsm(pts, roi)
    dsm, grid = tmm.dense_depth_to_dsm(pts, roi, device="cpu")
    jdsm, jgrid = jmm.dense_depth_to_dsm(pts, roi)
    assert grid == tuple(jgrid)
    np.testing.assert_array_equal(np.isnan(dsm), np.isnan(jdsm))
    np.testing.assert_allclose(dsm, jdsm, rtol=0, atol=1e-5)


def test_convert_tiff_byte_for_byte(aoi, tmp_path):
    for sub in (os.path.join("RGB", AOI, f"{AOI}_001_RGB.tif"),
                os.path.join("Truth", f"{AOI}_DSM.tif")):
        src = os.path.join(aoi, sub)
        a = tmm.convert_tiff(src, str(tmp_path / "port.tif"))
        b = jmm.convert_tiff(src, str(tmp_path / "jax.tif"))
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), sub


@pytest.mark.parametrize("stride", [1, 3])
def test_synthesize_depth_for_image_matches_jax(aoi, stride):
    dsm, _ = read_geotiff(os.path.join(aoi, "Truth", f"{AOI}_DSM.tif"))
    roi = np.loadtxt(os.path.join(aoi, "Truth", f"{AOI}_DSM.txt"))
    meta = read_dict_from_json(os.path.join(aoi, "JSON",
                                            f"{AOI}_002_RGB.json"))
    ours = tsd.synthesize_depth_for_image(meta, dsm, roi, 17, True,
                                          stride=stride)
    ref = jsd.synthesize_depth_for_image(meta, dsm, roi, 17, True,
                                         stride=stride)
    assert len(ours[0]) > 0.3 * (meta["width"] // stride) * (
        meta["height"] // stride)
    np.testing.assert_array_equal(ours[0], ref[0])
    np.testing.assert_allclose(ours[1], ref[1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(ours[2], ref[2], rtol=0, atol=1e-6)
    lookup = np.array([0.2, 5.0, -3.0])
    np.testing.assert_array_equal(
        tsd._dsm_lookup(np.arange(6.0).reshape(2, 3), 0.0, 1.0, 0.5, lookup,
                        lookup),
        jsd._dsm_lookup(np.arange(6.0).reshape(2, 3), 0.0, 1.0, 0.5, lookup,
                        lookup))


def test_synthesize_depth_from_lidar_files_equal(aoi, tmp_path):
    ids = jsd.synthesize_depth_from_lidar(
        os.path.join(aoi, "JSON"), os.path.join(aoi, "Truth"), AOI,
        str(tmp_path), stride=2, verbose=False)
    train = open(os.path.join(aoi, "JSON", "train.txt")).read().split()
    assert ids == [t[:-len(".json")] for t in train]
    for img_id in ids:
        for kind in ("2DPts", "3DPts_ecef", "Correl"):
            name = f"{img_id}_{kind}.txt"
            assert text(os.path.join(aoi, "Depth", name)) == text(
                os.path.join(tmp_path, name)), name
