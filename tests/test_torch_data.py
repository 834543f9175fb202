"""The port's data path (`spnerf_torch.data`, `utils/resize.py`) against the
JAX package's, on a synthetic DFC2019 AOI written to disk
(`spnerf_torch.utils.synth_scene`), float64 geodesy on the host in both.

Tolerances: rays within 1e-6 (normalized units); ids, semantic labels and
valid masks exact; depths and their std within 1e-6 relative; lat/lon within
1e-9 degrees and altitudes within 1e-6 m. Being copies of the same numpy code,
the arrays are expected bitwise equal.

Each package loads its own copy of the AOI, since the first load writes
scene.loc beside the JSONs.

A loaded scene goes through `scene_to_device_arrays` and `Trainer.to_device`
into the port's train step: on a batch of its rows (sparse semantics, so most
labels are IGNORE_LABEL, and a few depth-supervised rows) the port's loss
equals the JAX trainer's first-step loss within 1e-5 relative (shared
weights, the deterministic render), and 2 steps run with finite losses.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnerf_tpu import config as jconfig
from spnerf_tpu.data import dataset as jdataset
from spnerf_tpu.data import rays as jrays
from spnerf_tpu.io import read_dict_from_json
from spnerf_tpu.train.loop import Trainer as JaxTrainer
from spnerf_tpu.train.loop import \
    scene_to_device_arrays as jax_scene_to_device_arrays
from spnerf_tpu.utils import resize as jresize
from spnerf_torch.config import LossConfig, ModelConfig, RenderConfig
from spnerf_torch.convert import field_state_dict
from spnerf_torch.data import dataset, rays
from spnerf_torch.geo import RPCModel
from spnerf_torch.train.loop import Trainer, scene_to_device_arrays
from spnerf_torch.utils import resize
from spnerf_torch.utils.synth_scene import write_synthetic_aoi

AOI = "JAX_269"
ARRAYS = ("rays", "rgbs", "ids", "depths", "valid_depth", "depth_std",
          "sems", "valid_sem")


@pytest.fixture(scope="module")
def aoi_pair(tmp_path_factory):
    """(port's copy, JAX's copy) of one synthetic AOI."""
    root = tmp_path_factory.mktemp("aoi")
    write_synthetic_aoi(str(root / "port"), width=40, height=36, roi_size=24,
                        seed=1)
    shutil.copytree(root / "port", root / "jax")
    return tuple({"json_dir": str(root / k / "JSON"),
                  "img_dir": str(root / k / "RGB" / AOI),
                  "depth_dir": str(root / k / "Depth"),
                  "sem_dir": str(root / k / "Semantic"),
                  "cache_dir": str(root / k / "cache")}
                 for k in ("port", "jax"))


def load_pair(aoi_pair, **kw):
    ours, ref = aoi_pair
    args = lambda d: (d["json_dir"], d["img_dir"], d["depth_dir"],
                      d["sem_dir"], AOI)
    return (dataset.load_scene(*args(ours), cache_dir=ours["cache_dir"],
                               verbose=False, **kw),
            jdataset.load_scene(*args(ref), cache_dir=ref["cache_dir"],
                                verbose=False, **kw))


def assert_arrays_match(a, b, name):
    assert a.shape == b.shape and a.dtype == b.dtype, name
    if name in ("ids", "sems", "valid_depth", "valid_sem"):
        np.testing.assert_array_equal(a, b, err_msg=name)
    elif name in ("depths", "depth_std"):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0, err_msg=name)
    else:
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=name)


def test_resize_matches_jax():
    g = np.random.default_rng(0)
    img = g.random((37, 53, 3))
    for h, w in ((11, 17), (74, 106), (37, 53)):
        np.testing.assert_array_equal(resize.resize_bilinear(img, h, w),
                                      jresize.resize_bilinear(img, h, w))
        np.testing.assert_array_equal(resize.resize_nearest(img, h, w),
                                      jresize.resize_nearest(img, h, w))
    np.testing.assert_array_equal(resize.resize_bilinear(img[..., 0], 9, 8),
                                  jresize.resize_bilinear(img[..., 0], 9, 8))


def test_cast_rays_and_sun_match_jax(aoi_pair):
    meta = read_dict_from_json(f"{aoi_pair[0]['json_dir']}/{AOI}_001_RGB.json")
    rpc = RPCModel.from_dict(meta["rpc"])
    cols, rows = rays.image_grid(meta["width"], meta["height"])
    ours = rays.cast_rays(cols, rows, rpc, meta["min_alt"], meta["max_alt"])
    ref = jrays.cast_rays(cols, rows, rpc, meta["min_alt"], meta["max_alt"])
    assert ours.shape == (40 * 36, 8) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np.stack(rays.image_grid(5, 3)),
                                  np.stack(jrays.image_grid(5, 3)))
    for el, az in ((37.0, 123.0), (90.0, 0.0)):
        np.testing.assert_array_equal(rays.sun_direction(el, az),
                                      jrays.sun_direction(el, az))


def test_scene_norm_matches_jax():
    g = np.random.default_rng(2)
    pts = g.normal(size=(1000, 3)) * [100.0, 50.0, 10.0] + [8e5, -5.6e6, 3.2e6]
    norm, d = rays.SceneNorm.fit(pts)
    jnorm, jd = jrays.SceneNorm.fit(pts)
    assert d == jd
    n = norm.normalize_points(pts)
    np.testing.assert_array_equal(n, jnorm.normalize_points(pts))
    assert np.abs(n).max() <= 1.0 + 1e-5
    np.testing.assert_allclose(norm.denormalize_points(n), pts, rtol=1e-6)
    r = np.concatenate([pts, g.normal(size=(1000, 3)), g.uniform(
        0, 300, (1000, 2))], -1)
    np.testing.assert_array_equal(norm.normalize_rays(r),
                                  jnorm.normalize_rays(r))
    loc = rays.SceneNorm.from_scene_loc(d)
    assert loc.range == norm.range
    np.testing.assert_array_equal(loc.center, norm.center)


@pytest.mark.parametrize("downscale", [1, 2])
@pytest.mark.parametrize("dense_ss", [False, True])
@pytest.mark.parametrize("depth", [True, False])
def test_load_scene_matches_jax(aoi_pair, depth, dense_ss, downscale):
    ours, ref = load_pair(aoi_pair, sem=True, num_sem_classes=3,
                          dense_ss=dense_ss, load_depth=depth,
                          img_downscale=downscale)
    h, w = 36 // downscale, 40 // downscale
    assert len(ours) == 3 * h * w
    for name in ARRAYS:
        assert_arrays_match(getattr(ours, name), getattr(ref, name), name)
    assert ours.norm.range == ref.norm.range
    np.testing.assert_array_equal(ours.norm.center, ref.norm.center)
    assert ([(r.img_id, r.t, r.h, r.w) for r in ours.val_images]
            == [(r.img_id, r.t, r.h, r.w) for r in ref.val_images])
    assert [r.img_id for r in ours.train_images] == [
        r.img_id for r in ref.train_images]
    assert (ours.valid_depth.sum() > 0) == depth
    assert (ours.sems == -100).any() and (ours.sems >= 0).any()


def test_load_scene_frame_offset_matches_jax(aoi_pair):
    ours, ref = load_pair(aoi_pair, load_depth=False,
                          frame_offset=(2.5, 0.0, -2.5))
    np.testing.assert_allclose(ours.rays, ref.rays, rtol=0, atol=1e-6)


def test_val_image_and_latlonalt_match_jax(aoi_pair):
    ours, ref = load_pair(aoi_pair, sem=True, num_sem_classes=3)
    for rec, jrec in zip(ours.val_images, ref.val_images):
        a = ours.load_val_image(rec, with_sem=True)
        b = ref.load_val_image(jrec, with_sem=True)
        assert set(a) == set(b) and "sems" in a
        for k in ("src_id", "h", "w", "t"):
            assert a[k] == b[k]
        np.testing.assert_allclose(a["rays"], b["rays"], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(a["rgbs"], b["rgbs"])
        np.testing.assert_array_equal(a["sems"], b["sems"])
        depth = np.random.default_rng(rec.t).uniform(
            0.0, 1.0, a["rays"].shape[0]) * a["rays"][:, 7]
        got = ours.latlonalt_from_depth(a["rays"], depth)
        want = ref.latlonalt_from_depth(a["rays"], depth)
        for x, y, tol in zip(got, want, (1e-9, 1e-9, 1e-6)):
            np.testing.assert_allclose(x, y, rtol=0, atol=tol)


MC = dict(mapping=True, sem=True, num_sem_classes=3, fc_units=32,
          fc_layers=8, skips=(4,))
RC = dict(n_samples=8, guidedsample=True, solar_correction=True, sem=True)
LC = dict(sc_lambda=0.1, depth=True, ds_lambda=1.0, stdscale=1.0, sem=True,
          ss_lambda=1.0)


def test_loaded_scene_trains_and_matches_jax_loss(aoi_pair):
    ours, ref = load_pair(aoi_pair, sem=True, num_sem_classes=3)
    jtr = JaxTrainer(jconfig.ModelConfig(**MC), jconfig.RenderConfig(**RC),
                     jconfig.LossConfig(**LC), lr=5e-4, steps_per_epoch=3)
    params = {"coarse": jtr.init_state(jax.random.PRNGKey(0)).params["coarse"]}
    ttr = Trainer(ModelConfig(**MC), RenderConfig(**RC), LossConfig(**LC),
                  lr=5e-4, steps_per_epoch=3, device="cpu")
    state = ttr.init_state(torch.Generator().manual_seed(0))
    state.model.load_state_dict(field_state_dict(params["coarse"]))

    data = ttr.to_device(scene_to_device_arrays(ours))
    jdata = jax_scene_to_device_arrays(ref)
    assert set(data) == set(jdata)
    # a batch with every depth-supervised row and some IGNORE_LABEL rows
    g = np.random.default_rng(0)
    idx = np.concatenate([np.flatnonzero(ours.valid_depth)[:48],
                          g.choice(len(ours), 80, replace=False)])
    batch = {k: v[torch.from_numpy(idx)] for k, v in data.items()}
    jbatch = {k: jnp.asarray(v[idx]) for k, v in jdata.items()}
    assert (batch["sems"] == -100).sum() > 40
    assert batch["valid_depth"].sum() > 0
    for k in batch:
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(jbatch[k]))

    jloss, jd = jtr._loss_fn(params, jbatch, None, jnp.int32(0))
    loss, td = ttr.loss_fn(state, batch, 0)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert set(td) == set(jd)

    first = ttr.train_step(state, data, batch_size=64)
    last = ttr.train_step(state, data, batch_size=64)
    assert state.step == 2
    for d in (first, last):
        assert all(np.isfinite(float(v)) for v in d.values())
    assert float(first["loss"]) != float(last["loss"])
