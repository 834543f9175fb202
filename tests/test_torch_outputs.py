"""The port's validation outputs against the JAX package's, on the CPU:
`save_nerf_output_to_images` writes the same file tree, every GeoTIFF equal
within 1e-6 (the DSM is splatted on the CPU in both) with equal profiles, and
the semantic PNGs equal pixel for pixel; the functions it calls
(`visualize_depth`, `convert_semantic_to_color`, `remap_semantics_to_original`,
`save_sem_image`) and `MetricLogger` give what the JAX package's give.
Where matplotlib does not import, `save_nerf_output_to_images` writes every
GeoTIFF all the same and names the two semantic PNGs it skipped (the JAX
package raises).
"""

import json
import os

import numpy as np
import pytest

from spnerf_tpu.data import load_scene as jax_load_scene
from spnerf_tpu.evaluation import outputs as joutputs
from spnerf_tpu.utils.logging import MetricLogger as JaxMetricLogger
from spnerf_torch.data import load_scene
from spnerf_torch.evaluation import outputs
from spnerf_torch.io import read_geotiff
from spnerf_torch.utils.logging import MetricLogger
from spnerf_torch.utils.synth_scene import write_synthetic_aoi

AOI = "JAX_269"


@pytest.fixture(scope="module")
def view(tmp_path_factory):
    """(port scene, JAX scene, the test view's sample) on a 40 x 36 AOI."""
    root = str(tmp_path_factory.mktemp("aoi"))
    aoi = write_synthetic_aoi(root, width=40, height=36, roi_size=24, seed=2)
    args = (aoi["json_dir"], aoi["img_dir"], aoi["depth_dir"], aoi["sem_dir"],
            AOI)
    kw = dict(sem=True, num_sem_classes=3, load_depth=False, verbose=False)
    scene = load_scene(*args, **kw)  # writes scene.loc; JAX then reads it
    jscene = jax_load_scene(*args, **kw)
    return scene, jscene, scene.load_val_image(scene.val_images[-1],
                                               with_sem=True)


def results_for(sample, kind, seed=0):
    """A renderer output dict for the view: per-ray ("lean"), per-sample
    arrays with weights ("samples"), or per-ray fine outputs ("fine")."""
    g = np.random.default_rng(seed)
    r, s = sample["rays"].shape[0], 6
    typ = "fine" if kind == "fine" else "coarse"
    out = {f"rgb_{typ}": g.uniform(size=(r, 3)).astype(np.float32),
           f"depth_{typ}": (g.uniform(0.2, 0.8, r)
                            * sample["rays"][:, 7]).astype(np.float32),
           f"sem_logits_{typ}": g.normal(size=(r, 3)).astype(np.float32)}
    if kind == "samples":
        w = g.uniform(size=(r, s)).astype(np.float32)
        out[f"weights_{typ}"] = w / w.sum(-1, keepdims=True)
        for key, c in (("sun", 1), ("albedo", 3), ("sky", 3), ("beta", 1)):
            out[f"{key}_{typ}"] = g.uniform(size=(r, s, c)).astype(np.float32)
    else:
        for key, c in (("sun", 1), ("albedo", 3), ("sky", 3)):
            out[f"{key}_{typ}"] = g.uniform(size=(r, c)).astype(np.float32)
    if kind == "fine":
        out["rgb_coarse"] = out["rgb_fine"]
    return out


def tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("kind", ["lean", "samples", "fine"])
def test_save_nerf_output_to_images_matches_jax(tmp_path, view, kind):
    from PIL import Image

    scene, jscene, sample = view
    res = results_for(sample, kind)
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    got = outputs.save_nerf_output_to_images(scene, sample, res, ours, 3, 3,
                                             device="cpu")
    want = joutputs.save_nerf_output_to_images(jscene, sample, res, ref, 3, 3)
    assert os.path.relpath(got, ours) == os.path.relpath(want, ref)
    files = tree(ours)
    assert files == tree(ref)
    assert sum(f.endswith(".tif") for f in files) >= 7
    for f in files:
        a, b = os.path.join(ours, f), os.path.join(ref, f)
        if f.endswith(".png"):
            np.testing.assert_array_equal(np.asarray(Image.open(a)),
                                          np.asarray(Image.open(b)))
            continue
        x, px = read_geotiff(a)
        y, py = read_geotiff(b)
        assert x.shape == y.shape and x.dtype == y.dtype, f
        np.testing.assert_array_equal(np.isnan(x), np.isnan(y), err_msg=f)
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-6, err_msg=f)
        assert px["transform"] == py["transform"] and px["epsg"] == py["epsg"]


def test_outputs_without_matplotlib(tmp_path, view, monkeypatch, capsys):
    import sys

    scene, _, sample = view
    res = results_for(sample, "lean")
    ours = str(tmp_path / "with")
    outputs.save_nerf_output_to_images(scene, sample, res, ours, 3, 3,
                                       device="cpu")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    bare = str(tmp_path / "without")
    outputs.save_nerf_output_to_images(scene, sample, res, bare, 3, 3,
                                       device="cpu")
    assert "matplotlib is not installed" in capsys.readouterr().out
    tifs = [f for f in tree(ours) if f.endswith(".tif")]
    assert tifs == tree(bare)
    for f in tifs:
        np.testing.assert_array_equal(read_geotiff(os.path.join(ours, f))[0],
                                      read_geotiff(os.path.join(bare, f))[0])


def test_image_helpers_match_jax(tmp_path):
    from PIL import Image

    g = np.random.default_rng(4)
    depth = g.uniform(0, 50, size=(20, 30))
    depth[2, 3] = np.nan
    np.testing.assert_array_equal(outputs.visualize_depth(depth),
                                  joutputs.visualize_depth(depth))
    for n_cls in (3, 4, 5):
        sem = g.integers(-1, n_cls + 1, size=(9, 11))
        np.testing.assert_array_equal(
            outputs.convert_semantic_to_color(sem, n_cls),
            joutputs.convert_semantic_to_color(sem, n_cls))
        np.testing.assert_array_equal(
            outputs.remap_semantics_to_original(sem, n_cls),
            joutputs.remap_semantics_to_original(sem, n_cls))
    sem = g.integers(0, 3, size=(12, 10))
    ours, ref = str(tmp_path / "a" / "s.png"), str(tmp_path / "b" / "s.png")
    outputs.save_sem_image(sem, ours, 3)
    joutputs.save_sem_image(sem, ref, 3)
    for a, b in ((ours, ref), (ours.replace(".png", "_no_legend.png"),
                               ref.replace(".png", "_no_legend.png"))):
        np.testing.assert_array_equal(np.asarray(Image.open(a)),
                                      np.asarray(Image.open(b)))


def test_metric_logger_matches_jax(tmp_path):
    rows = [(3, {"psnr": 21.5, "ssim": np.float32(0.7)}, "val_x"),
            (4, {"loss": 0.25}, "train")]
    for cls, d in ((MetricLogger, "ours"), (JaxMetricLogger, "ref")):
        log = cls(str(tmp_path / d), tensorboard=False)
        for step, scalars, split in rows:
            log.log(step, scalars, split=split)
        log.log_images(3, "grid", np.zeros((2, 3, 4, 4)))
        log.close()

    def read(d):
        with open(tmp_path / d / "metrics.jsonl") as f:
            return [{k: v for k, v in json.loads(ln).items() if k != "time"}
                    for ln in f]

    assert read("ours") == read("ref")
    assert read("ours")[0] == {"step": 3, "split": "val_x", "psnr": 21.5,
                               "ssim": pytest.approx(0.7)}
