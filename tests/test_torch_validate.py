"""The slice as a whole: the port's `run_validation` against the JAX
package's, on a synthetic DFC2019 AOI (40 x 36 px, 3 train and 1 test
images, a 24-cell ROI) written to disk, with a small float32 field of the
flagship's shape (Siren 8 x 32, mapping, 3 semantic classes, 8 samples,
guided sampling, solar correction) on the JAX trainer's initial weights
(carried across by `convert.py`). Sparse semantics: most rays carry
IGNORE_LABEL into the render. Both save their images (matplotlib is
installed here), into the same file tree.

Tolerances:
* PSNR within 1e-3 dB and SSIM within 1e-4, for every view; mIoU and
  overall accuracy within 1e-6 (float32 means of the same counts);
* the rendered depth within 1e-4 (the render's tolerance,
  tests/test_torch_render.py);
* MAE within 0.05 m: the depths agree to 1e-4, but a point near a cell edge
  can still change cells;
* the JAX render's depth passed through both DSM chains
  (`latlonalt_from_depth` -> `dsm_from_latlonalt` -> MAE): MAE within 1e-6 m.
"""

import argparse
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from spnerf_tpu import config as jconfig
from spnerf_tpu.cli.train import run_validation as jax_run_validation
from spnerf_tpu.data import load_scene as jax_load_scene
from spnerf_tpu.evaluation.dsm import dsm_from_latlonalt as jax_dsm
from spnerf_tpu.evaluation.mae import compute_mae_and_save_dsm_diff as jax_mae
from spnerf_tpu.train.loop import Trainer as JaxTrainer
from spnerf_tpu.utils.logging import MetricLogger as JaxMetricLogger
from spnerf_torch.cli.train import (_aoi_dirs, _val_labels, _val_metrics,
                                    predefined_val_ts, run_validation)
from spnerf_torch.config import LossConfig, ModelConfig, RenderConfig
from spnerf_torch.convert import field_state_dict
from spnerf_torch.data import load_scene
from spnerf_torch.evaluation.dsm import dsm_from_latlonalt
from spnerf_torch.evaluation.mae import compute_mae_and_save_dsm_diff
from spnerf_torch.render import build_render_fn
from spnerf_torch.train.loop import Trainer
from spnerf_torch.utils.logging import MetricLogger
from spnerf_torch.utils.synth_scene import write_synthetic_aoi

AOI = "JAX_269"
MC = dict(mapping=True, sem=True, num_sem_classes=3, fc_units=32,
          fc_layers=8, skips=(4,))
RC = dict(n_samples=8, guidedsample=True, solar_correction=True, sem=True,
          compute_dtype="float32")
LC = dict(sc_lambda=0.1, depth=True, ds_lambda=1.0, stdscale=1.0, sem=True,
          ss_lambda=1.0)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both packages' validation on one AOI and one set of weights."""
    root = tmp_path_factory.mktemp("val")
    write_synthetic_aoi(str(root / "port"), width=40, height=36, roi_size=24,
                        seed=5)
    shutil.copytree(root / "port", root / "jax")
    out = {}
    for pkg in ("port", "jax"):
        base = root / pkg
        out[pkg] = dict(args=argparse.Namespace(
            aoi_id=AOI, gt_dir=str(base / "Truth"), chunk=1024, sem=True,
            num_sem_classes=3, logs_dir=str(base / "logs")))
        kw = dict(sem=True, num_sem_classes=3, verbose=False)
        dirs = (str(base / "JSON"), str(base / "RGB" / AOI),
                str(base / "Depth"), str(base / "Semantic"), AOI)
        out[pkg]["scene"] = (load_scene if pkg == "port"
                             else jax_load_scene)(*dirs, **kw)

    jtr = JaxTrainer(jconfig.ModelConfig(**MC), jconfig.RenderConfig(**RC),
                     jconfig.LossConfig(**LC), lr=5e-4, steps_per_epoch=3)
    jstate = jtr.init_state(jax.random.PRNGKey(0))
    ttr = Trainer(ModelConfig(**MC), RenderConfig(**RC), LossConfig(**LC),
                  lr=5e-4, steps_per_epoch=3, device="cpu")
    state = ttr.init_state(torch.Generator().manual_seed(0))
    state.model.load_state_dict(field_state_dict(jstate.params["coarse"]))

    jlog = JaxMetricLogger(out["jax"]["args"].logs_dir, tensorboard=False)
    out["jax"]["mean"] = jax_run_validation(jtr, out["jax"]["scene"], jstate,
                                            out["jax"]["args"], 1, jlog,
                                            True)
    jlog.close()
    log = MetricLogger(out["port"]["args"].logs_dir, tensorboard=False)
    out["port"]["mean"] = run_validation(ttr, out["port"]["scene"], state,
                                         out["port"]["args"], 1, log, True)
    log.close()
    out.update(jtr=jtr, jstate=jstate, ttr=ttr, state=state)
    return out


def rows(args):
    with open(os.path.join(args.logs_dir, "metrics.jsonl")) as f:
        return [json.loads(ln) for ln in f]


def test_validation_metrics_match_jax(run):
    mean, jmean = run["port"]["mean"], run["jax"]["mean"]
    assert set(mean) == set(jmean) == {"psnr", "ssim", "mae", "miou", "oa"}
    ours, ref = rows(run["port"]["args"]), rows(run["jax"]["args"])
    assert [r["split"] for r in ours] == [r["split"] for r in ref] == [
        f"train_{AOI}_000_RGB", f"val_{AOI}_003_RGB", "val"]
    for a, b in zip(ours, ref):
        assert a["step"] == b["step"] == 0
        assert abs(a["psnr"] - b["psnr"]) <= 1e-3
        assert abs(a["ssim"] - b["ssim"]) <= 1e-4
        assert np.isfinite(a["mae"]) and np.isfinite(b["mae"])
        assert abs(a["mae"] - b["mae"]) <= 0.05
        assert abs(a["miou"] - b["miou"]) <= 1e-6
        assert abs(a["oa"] - b["oa"]) <= 1e-6


def test_saved_images_match_jax_file_tree(run):
    def tree(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    ours = tree(run["port"]["args"].logs_dir)
    assert ours == tree(run["jax"]["args"].logs_dir)
    for split, img in (("train", f"{AOI}_000_RGB"), ("val", f"{AOI}_003_RGB")):
        for sub in ("depth", "dsm", "rgb", "gt_rgb", "semantic", "sun",
                    "albedo", "sky"):
            assert f"{split}/{sub}/{img}_epoch1.tif" in ours


def test_render_depth_and_dsm_chain_match_jax(run, tmp_path):
    scene, jscene = run["port"]["scene"], run["jax"]["scene"]
    rec = scene.val_images[-1]
    sample = scene.load_val_image(rec, with_sem=True)
    t = predefined_val_ts(rec.img_id)
    jrender = run["jtr"].build_render_fn(chunk=1024)
    jout = jrender(jax.device_get(run["jstate"].params), sample["rays"], t,
                   sample["sems"])
    out = build_render_fn(run["state"].model, run["ttr"].rc, chunk=1024)(
        sample["rays"], t, sample["sems"])
    np.testing.assert_allclose(out["depth_coarse"].numpy(),
                               jout["depth_coarse"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(out["rgb_coarse"].numpy(), jout["rgb_coarse"],
                               rtol=0, atol=1e-4)

    depth = np.asarray(jout["depth_coarse"])
    maes = []
    for sc, to_dsm, mae, name in (
            (scene, lambda *a, **k: dsm_from_latlonalt(*a, device="cpu", **k),
             compute_mae_and_save_dsm_diff, "port"),
            (jscene, jax_dsm, jax_mae, "jax")):
        lats, lons, alts = sc.latlonalt_from_depth(sample["rays"], depth)
        path = str(tmp_path / f"{name}.tif")
        to_dsm(lats, lons, alts, dsm_path=path)
        maes.append(mae(path, rec.img_id, AOI, run[name]["args"].gt_dir,
                        str(tmp_path / name), 1, save=False))
    assert np.isfinite(maes[0])
    assert abs(maes[0] - maes[1]) <= 1e-6


def test_val_helpers():
    assert predefined_val_ts("JAX_269_003_RGB") == 0
    assert _val_metrics({"psnr": 21.5}) == {"val_psnr": 21.5}
    assert _val_metrics({"psnr": float("nan")}) == {"val_psnr": float("-inf")}
    assert _val_metrics({}) == {"val_psnr": float("-inf")}

    class Rec:
        def __init__(self, img_id):
            self.img_id = img_id

    a, b = object(), object()
    items = [("x", a, Rec("i0")), ("x", a, Rec("i1")), ("y", b, Rec("i0"))]
    assert _val_labels(items) == ["i0.f0", "i1", "i0.f1"]


def test_multi_aoi_validation_refuses(run, tmp_path):
    """Multi-AOI validation is ported: the AOI twice side by side (the JAX
    package's `--aoi_id JAX_269,JAX_269` recipe), each view logged under
    its frame's label and scored against the AOI's own truth; frame 0's
    rays are the single-AOI scene's, so its views give that run's metrics.
    (The two packages' multi-AOI validation: tests/test_torch_multi.py.)"""
    from spnerf_torch.data import load_scenes

    os.symlink(os.path.dirname(run["port"]["args"].gt_dir),
               tmp_path / AOI)
    args = argparse.Namespace(**{
        **vars(run["port"]["args"]), "aoi_id": f"{AOI},{AOI}",
        "project_dir": str(tmp_path), "dataset_dir": str(tmp_path / "{aoi}"),
        "logs_dir": str(tmp_path / "logs")})
    scene = load_scenes([AOI, AOI], lambda a: _aoi_dirs(args, a), sem=True,
                        num_sem_classes=3, verbose=False)
    log = MetricLogger(args.logs_dir, tensorboard=False)
    mean = run_validation(run["ttr"], scene, run["state"], args, 1, log,
                          False)
    log.close()
    got = rows(args)
    assert [r["split"] for r in got] == [
        f"train_{AOI}_000_RGB.f0", f"val_{AOI}_003_RGB.f0",
        f"val_{AOI}_000_RGB.f1", f"val_{AOI}_003_RGB.f1", "val"]
    single = rows(run["port"]["args"])
    for a, b in zip(got[:2], single[:2]):
        for k in ("psnr", "ssim", "mae"):
            assert abs(a[k] - b[k]) <= 1e-6, (a["split"], k)
    assert all(np.isfinite(r["mae"]) for r in got)
    assert set(mean) == {"psnr", "ssim", "mae", "miou", "oa"}
