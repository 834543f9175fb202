"""The port's DSM chain against the JAX package's, on the CPU: the splat
(`rasterize_dsm`, `dsm_from_latlonalt`), the ROI crop, the NCC registration
(the numpy path against the JAX package's; the C++ path, `native/dsmr.cpp`,
against the numpy path and the JAX package's C++ path) and the MAE.

Tolerances: which DSM cells are empty (NaN) must match exactly; cell values
within 1e-5 m (float32 sums); registration shifts exactly and the offset
within 1e-9 m (the C++ path sums in another order); MAE within 1e-6 m; written GeoTIFFs have equal profiles and
values within 1e-5 m (1e-6 m for the MAE chain's own outputs).

The known-surface check: the synthetic AOI's ray-surface points of its test
view (`surface_points`) become depths along the loaded view's rays, then
`latlonalt_from_depth` -> `dsm_from_latlonalt` -> MAE against the AOI's own
lidar DSM. The MAE stays below 0.05 m; what remains is the radius-1 splat
averaging roof and ground points at the box buildings' edges (0.0294 m on
this AOI).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from spnerf_tpu.evaluation import dsm as jdsm
from spnerf_tpu.evaluation import mae as jmae
from spnerf_tpu.evaluation import registration as jreg
from spnerf_torch.data import load_scene
from spnerf_torch.evaluation import dsm, mae, registration
from spnerf_torch.io import read_geotiff, write_geotiff
from spnerf_torch.utils.synth_scene import surface_points, write_synthetic_aoi


def cloud(n, seed, xoff=435520.0, yoff=3354480.0, size=(40, 30), res=0.5):
    """UTM-magnitude points, some outside the (xsize, ysize) grid."""
    g = np.random.default_rng(seed)
    easts = xoff + g.uniform(-2, size[0] * res + 2, n)
    norths = yoff - g.uniform(-2, size[1] * res + 2, n)
    return easts, norths, g.uniform(-20, 30, n)


@pytest.mark.parametrize("radius", [0, 1, 2])
@pytest.mark.parametrize("sigma", [np.inf, 0.8])
def test_rasterize_matches_jax(radius, sigma):
    e, n, a = cloud(3000, radius)
    kw = dict(xoff=435520.0, yoff=3354480.0, resolution=0.5, xsize=40,
              ysize=30, radius=radius, sigma=sigma)
    ours = dsm.rasterize_dsm(e, n, a, device="cpu", **kw)
    assert isinstance(ours, torch.Tensor) and ours.dtype == torch.float32
    ours = ours.numpy()
    ref = np.asarray(jdsm.rasterize_dsm(e, n, a, **kw))
    assert np.isnan(ours).any() or radius > 0
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_rasterize_float64_origin_matches_float64_oracle():
    """At northings of ~3.4e6 m float32 spacing is close to the 0.5 m cell:
    the origin is subtracted in float64 before the cast, so every point keeps
    the cell of a float64 oracle (the JAX package's test_eval case)."""
    g = np.random.default_rng(0)
    n, xoff, yoff, res, size = 4000, 435520.0, 3354480.0, 0.5, 64
    easts = xoff + g.uniform(0, size * res, n)
    norths = yoff - g.uniform(0, size * res, n)
    alts = g.uniform(-20, 30, n)
    ours = dsm.rasterize_dsm(easts, norths, alts, xoff=xoff, yoff=yoff,
                             resolution=res, xsize=size, ysize=size,
                             radius=0, device="cpu").numpy()
    cols = np.floor((easts - xoff) / res).astype(int)
    rows = np.floor((yoff - norths) / res).astype(int)
    ssum, cnt = np.zeros((size, size)), np.zeros((size, size))
    np.add.at(ssum, (rows, cols), alts)
    np.add.at(cnt, (rows, cols), 1.0)
    mask = cnt > 0
    assert np.array_equal(~np.isnan(ours), mask)
    np.testing.assert_allclose(ours[mask], ssum[mask] / cnt[mask], rtol=2e-6,
                               atol=1e-4)
    ref = np.asarray(jdsm.rasterize_dsm(easts, norths, alts, xoff=xoff,
                                        yoff=yoff, resolution=res, xsize=size,
                                        ysize=size, radius=0))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def assert_same_tif(a, b, atol):
    x, px = read_geotiff(a)
    y, py = read_geotiff(b)
    assert x.shape == y.shape and x.dtype == y.dtype
    np.testing.assert_array_equal(np.isnan(x), np.isnan(y))
    np.testing.assert_allclose(x, y, rtol=0, atol=atol)
    for k in ("transform", "epsg", "width", "height", "count"):
        assert px[k] == py[k], k
    assert np.isnan(px["nodata"]) == np.isnan(py["nodata"])


@pytest.mark.parametrize("with_roi", [False, True])
def test_dsm_from_latlonalt_matches_jax(tmp_path, with_roi):
    from spnerf_torch.geo import utm_to_latlon

    e, n, a = cloud(5000, 7, size=(48, 48))
    lat, lon = utm_to_latlon(e, n, 17, True)
    roi = None
    if with_roi:
        roi = str(tmp_path / "roi.txt")
        np.savetxt(roi, [435521.0, 3354480.0 - 20.0, 40, 0.5])
    ours, ref = str(tmp_path / "ours.tif"), str(tmp_path / "ref.tif")
    d, grid = dsm.dsm_from_latlonalt(lat, lon, a, roi_txt=roi, dsm_path=ours,
                                     device="cpu")
    jd, jgrid = jdsm.dsm_from_latlonalt(lat, lon, a, roi_txt=roi,
                                        dsm_path=ref)
    assert grid == jgrid
    assert isinstance(d, np.ndarray)
    np.testing.assert_array_equal(np.isnan(d), np.isnan(jd))
    np.testing.assert_allclose(d, jd, rtol=0, atol=1e-5)
    assert_same_tif(ours, ref, 1e-5)


def test_crop_to_roi_matches_jax():
    arr = np.arange(20.0 * 30).reshape(20, 30)
    transform = (100.0, 0.5, 200.0, -0.5)
    for xoff, ytop, xs, ys in ((101.0, 199.0, 10, 8), (95.0, 203.0, 40, 30),
                               (114.5, 191.0, 5, 5), (300.0, 100.0, 4, 4)):
        np.testing.assert_array_equal(
            mae.crop_to_roi(arr, transform, xoff, ytop, xs, ys, 0.5),
            jmae.crop_to_roi(arr, transform, xoff, ytop, xs, ys, 0.5))


@pytest.mark.parametrize("shape,shift", [((140, 150), (3, -2)),
                                         ((230, 210), (-4, 5)),
                                         ((60, 70), (1, 1))])
def test_registration_matches_jax_numpy_path(shape, shift):
    g = np.random.default_rng(shape[0])
    base = g.normal(size=shape) * 4 + 20
    base = base + 10 * np.sin(np.arange(shape[1]) / 9)[None, :]
    dx0, dy0 = shift
    moved = registration._shifted_view(base, -dx0, -dy0) + 1.25
    moved[::13, ::7] = np.nan
    ours = registration.compute_shift(base, moved, use_native=False)
    ref = jreg.compute_shift(base, moved, use_native=False)
    assert ours[:3] == ref[:3] == (dx0, dy0, 1.0)
    np.testing.assert_allclose(ours[3], ref[3], rtol=0, atol=1e-9)
    np.testing.assert_allclose(ours[3], -1.25, atol=0.05)
    np.testing.assert_array_equal(
        registration.apply_shift(moved, *ours, use_native=False),
        jreg.apply_shift(moved, *ref, use_native=False))
    scaled = registration.compute_shift(base, moved, scaling=True,
                                        use_native=False)
    jscaled = jreg.compute_shift(base, moved, scaling=True, use_native=False)
    np.testing.assert_allclose(scaled, jscaled, rtol=1e-12)
    np.testing.assert_array_equal(registration.downsample2x(moved),
                                  jreg.downsample2x(moved))
    assert registration.ncc(base, moved, 1, 2) == jreg.ncc(base, moved, 1, 2)


@pytest.mark.parametrize("shape,shift", [((140, 150), (3, -2)),
                                         ((230, 210), (-4, 5)),
                                         ((60, 70), (1, 1))])
def test_native_registration_matches_numpy_and_jax_native(shape, shift):
    assert registration.load_native() is not None
    assert jreg._load_native()
    g = np.random.default_rng(shape[1])
    base = g.normal(size=shape) * 4 + 20
    base = base + 10 * np.cos(np.arange(shape[0]) / 7)[:, None]
    dx0, dy0 = shift
    moved = registration._shifted_view(base, -dx0, -dy0) - 0.75
    moved[::11, ::5] = np.nan
    for scaling in (False, True):
        ours = registration.compute_shift(base, moved, scaling=scaling)
        numpy_path = registration.compute_shift(base, moved, scaling=scaling,
                                                use_native=False)
        jax_native = jreg.compute_shift(base, moved, scaling=scaling)
        assert ours[:2] == numpy_path[:2] == jax_native[:2] == (dx0, dy0)
        np.testing.assert_allclose(ours[2:], numpy_path[2:], rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(ours[2:], jax_native[2:], rtol=0,
                                   atol=1e-9)
    out = registration.apply_shift(moved, *ours)
    np.testing.assert_array_equal(np.isnan(out), np.isnan(
        registration.apply_shift(moved, *ours, use_native=False)))
    np.testing.assert_allclose(
        out, registration.apply_shift(moved, *ours, use_native=False),
        rtol=0, atol=1e-9)
    np.testing.assert_allclose(out, jreg.apply_shift(moved, *ours), rtol=0,
                               atol=1e-9)
    with pytest.raises(ValueError, match="shapes"):
        registration.compute_shift(base, moved[:-1])


def make_mae_case(root, g, size=96, res=0.5, xoff=435500.0, yoff=3354400.0):
    """A lidar DSM and a prediction of it that is shifted, offset, noisy,
    with holes, on a larger grid with its own transform."""
    gt = (g.normal(size=(size, size)) * 0.3 + 5
          + 8 * np.sin(np.arange(size) / 7)[None, :]
          + 4 * np.cos(np.arange(size) / 11)[:, None]).astype(np.float32)
    gt_dir = os.path.join(root, "Truth")
    os.makedirs(gt_dir, exist_ok=True)
    write_geotiff(os.path.join(gt_dir, "JAX_269_DSM.tif"), gt,
                  transform=(xoff, res, yoff + size * res, -res), epsg=32617)
    np.savetxt(os.path.join(gt_dir, "JAX_269_DSM.txt"),
               [xoff, yoff, size, res])
    pad = 6
    big = np.full((size + 2 * pad, size + 2 * pad), np.nan, np.float32)
    big[pad:-pad, pad:-pad] = gt
    big = np.roll(big, (2, -1), axis=(0, 1)) + 0.7
    big += g.normal(size=big.shape).astype(np.float32) * 0.05
    big[::17, ::5] = np.nan
    pred = os.path.join(root, "pred.tif")
    write_geotiff(pred, big, transform=(xoff - pad * res, res,
                                        yoff + (size + pad) * res, -res),
                  epsg=32617, nodata=float("nan"))
    return gt_dir, pred


def test_mae_chain_matches_jax(tmp_path):
    gt_dir, pred = make_mae_case(str(tmp_path), np.random.default_rng(0))
    roi = np.loadtxt(os.path.join(gt_dir, "JAX_269_DSM.txt"))
    gt_path = os.path.join(gt_dir, "JAX_269_DSM.tif")
    err = mae.dsm_pointwise_diff(pred, gt_path, roi)
    jerr = jmae.dsm_pointwise_diff(pred, gt_path, roi)
    np.testing.assert_array_equal(np.isnan(err), np.isnan(jerr))
    np.testing.assert_allclose(err, jerr, rtol=0, atol=1e-6)
    filled = mae.dsm_pointwise_diff(pred, gt_path, roi, nan_fill_min=True)
    np.testing.assert_allclose(
        filled, jmae.dsm_pointwise_diff(pred, gt_path, roi,
                                        nan_fill_min=True), rtol=0, atol=1e-6)
    assert np.isfinite(filled).all()

    out, jout = str(tmp_path / "ours"), str(tmp_path / "ref")
    m = mae.compute_mae_and_save_dsm_diff(pred, "v", "JAX_269", gt_dir, out,
                                          4)
    jm = jmae.compute_mae_and_save_dsm_diff(pred, "v", "JAX_269", gt_dir,
                                            jout, 4)
    assert abs(m - jm) <= 1e-6
    assert m < 0.1  # shift and offset registered away; noise 0.05 m
    assert sorted(os.listdir(out)) == sorted(os.listdir(jout)) == [
        "v_rdsm_diff_epoch4.tif", "v_rdsm_epoch4.tif"]
    for name in os.listdir(out):
        assert_same_tif(os.path.join(out, name), os.path.join(jout, name),
                        1e-6)
    shutil.rmtree(out)
    assert m == mae.compute_mae_and_save_dsm_diff(pred, "v", "JAX_269",
                                                  gt_dir, out, 4, save=False)
    assert os.listdir(out) == []
    with pytest.raises(FileNotFoundError):
        mae.compute_mae_and_save_dsm_diff(pred, "v", "JAX_270", gt_dir, out,
                                          4)


def test_known_surface_dsm_mae(tmp_path):
    aoi = write_synthetic_aoi(str(tmp_path), width=420, height=400,
                              roi_size=256, n_train=1, seed=0)
    scene = load_scene(aoi["json_dir"], aoi["img_dir"], aoi["depth_dir"],
                       aoi["sem_dir"], "JAX_269", load_depth=False,
                       verbose=False)
    rec = scene.val_images[-1]
    assert rec.img_id == aoi["test"][0]
    sample = scene.load_val_image(rec)
    lidar, _ = read_geotiff(os.path.join(aoi["gt_dir"], "JAX_269_DSM.tif"))
    pts2d, pts3d, _ = surface_points(rec.meta, lidar, aoi["roi"])
    assert len(pts2d) > 0.7 * 420 * 400
    view = sample["rays"][pts2d[:, 1] * rec.w + pts2d[:, 0]]
    depth = np.linalg.norm(scene.norm.normalize_points(pts3d) - view[:, :3],
                           axis=1)
    lats, lons, alts = scene.latlonalt_from_depth(view, depth)
    pred = str(tmp_path / "pred.tif")
    dsm.dsm_from_latlonalt(lats, lons, alts, dsm_path=pred, device="cpu")
    m = mae.compute_mae_and_save_dsm_diff(pred, rec.img_id, "JAX_269",
                                          aoi["gt_dir"], str(tmp_path), 0,
                                          save=False)
    assert m < 0.05
