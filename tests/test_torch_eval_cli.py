"""The port's offline evaluation (`spnerf_torch/cli/evaluate.py`) against
the JAX package's, on the validation outputs that the port's training CLI
saved for a synthetic DFC2019 AOI (40 x 36 px, a 24-cell ROI; 4 steps of a
small flagship-shaped field, float32, on the CPU).

* The same means (PSNR, SSIM, MAE, mIoU, OA, and LPIPS on random weights of
  the .npz spec) within 1e-6, with --skip_lpips and with LPIPS weights.
* Views saved under a frame-suffixed label (".f1") are evaluated against
  the bare image id's truth and keep the suffix in their output names.
* Without LPIPS weights and without --skip_lpips, the evaluation stops
  with the message that names SPNERF_LPIPS_WEIGHTS.
* With matplotlib hidden, the metrics are unchanged, the residual-map PNGs
  are not written and one line says so.
* `eval_torch.py`'s `main` raises without CUDA unless given --device cpu.
"""

import argparse
import shutil
import sys

import numpy as np
import pytest
import torch

from spnerf_tpu.cli.evaluate import eval_aoi as jax_eval_aoi
from spnerf_torch.cli.evaluate import eval_aoi, main
from spnerf_torch.cli.train import main as train_main
from spnerf_torch.evaluation.lpips import weight_spec
from spnerf_torch.utils.synth_scene import write_synthetic_aoi

KEYS = ("psnr", "ssim", "mae", "miou", "oa")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tier-1 command runs six test processes on
    the machine's cores, and more threads each only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    dataset = root / "dataset" / "DFC2019_269"
    write_synthetic_aoi(str(dataset), width=40, height=36, roi_size=24,
                        seed=5)
    train_main([
        "--aoi_id", "JAX_269", "--model", "sp-nerf", "--exp_name", "ev",
        "--no_timestamp_exp_name", "--project_dir", str(root),
        "--n_samples", "8", "--fc_units", "32", "--fc_layers", "4",
        "--mapping", "--guidedsample", "--sem", "--num_sem_classes", "3",
        "--sc_lambda", "0.1", "--depth", "--ds_lambda", "1.0",
        "--ss_lambda", "1.0", "--precision", "fp32", "--chunk", "1024",
        "--batch_size", "64", "--log_every", "4", "--max_train_steps", "4",
        "--device", "cpu"])
    weights = root / "lpips.npz"
    rng = np.random.default_rng(0)
    np.savez(weights, **{
        k: (np.abs(rng.normal(size=s)) if k.startswith("lin")
            else rng.normal(size=s) * 0.05).astype(np.float32)
        for k, s in weight_spec().items()})
    return {"root": root, "dataset": dataset, "weights": str(weights),
            "logs": root / "output" / "ev" / "logs"}


def args_for(run, logs, out, skip_lpips=True):
    return argparse.Namespace(logs_dir=str(logs), output_dir=str(out),
                              dataset_dir=str(run["dataset"]),
                              epoch_number=0, skip_lpips=skip_lpips,
                              device="cpu")


@pytest.mark.parametrize("with_lpips", [False, True],
                         ids=["skip_lpips", "lpips"])
def test_means_match_jax(run, tmp_path, monkeypatch, with_lpips):
    monkeypatch.setenv("SPNERF_LPIPS_WEIGHTS", run["weights"])
    ours = eval_aoi(args_for(run, run["logs"], tmp_path / "port",
                             not with_lpips))
    ref = jax_eval_aoi(args_for(run, run["logs"], tmp_path / "jax",
                                not with_lpips))
    for k in KEYS + (("lpips",) if with_lpips else ()):
        assert np.isfinite(ours[k]), k
        assert abs(ours[k] - ref[k]) <= 1e-6, (k, ours[k], ref[k])
    if not with_lpips:
        assert np.isnan(ours["lpips"]) and np.isnan(ref["lpips"])
    assert (tmp_path / "port" / "dsm_diff"
            / "JAX_269_003_RGB_rdsm_diff_epoch0.tif").exists()


def test_frame_suffixed_views(run, tmp_path):
    logs = tmp_path / "logs"
    for kind in ("dsm", "rgb", "semantic"):
        src = run["logs"] / "val" / kind
        dst = logs / "val" / kind
        dst.mkdir(parents=True)
        for f in src.iterdir():
            shutil.copy(f, dst / f.name.replace("_RGB_epoch", "_RGB.f1_epoch"))
    plain = eval_aoi(args_for(run, run["logs"], tmp_path / "plain"))
    ours = eval_aoi(args_for(run, logs, tmp_path / "port"))
    ref = jax_eval_aoi(args_for(run, logs, tmp_path / "jax"))
    for k in KEYS:
        assert abs(ours[k] - ref[k]) <= 1e-6, k
        assert abs(ours[k] - plain[k]) <= 1e-6, k
    assert (tmp_path / "port" / "dsm_diff"
            / "JAX_269_003_RGB.f1_rdsm_diff_epoch0.tif").exists()


def test_fails_loudly_without_lpips_weights(run, tmp_path, monkeypatch):
    monkeypatch.delenv("SPNERF_LPIPS_WEIGHTS", raising=False)
    with pytest.raises(SystemExit, match="SPNERF_LPIPS_WEIGHTS"):
        eval_aoi(args_for(run, run["logs"], tmp_path, skip_lpips=False))


def test_without_matplotlib(run, tmp_path, monkeypatch, capsys):
    with_mpl = eval_aoi(args_for(run, run["logs"], tmp_path / "mpl"))
    assert (tmp_path / "mpl" / "dsm_diff"
            / "JAX_269_003_RGB_residual_map_original.png").exists()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    capsys.readouterr()
    without = eval_aoi(args_for(run, run["logs"], tmp_path / "nompl"))
    out = capsys.readouterr().out
    assert "matplotlib is not installed" in out
    assert "JAX_269_003_RGB_residual_map_enhanced.png not written" in out
    diff = tmp_path / "nompl" / "dsm_diff"
    assert not list(diff.glob("*.png"))
    assert (diff / "JAX_269_003_RGB_rdsm_epoch0.tif").exists()
    assert (diff / "JAX_269_003_RGB_rdsm_diff_epoch0.tif").exists()
    for k in KEYS:
        assert without[k] == with_mpl[k], k


def test_main_raises_without_cuda(run, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--project_dir", str(run["root"]), "--exp_name", "ev",
            "--dataset_dir", str(run["dataset"]), "--epoch_number", "0",
            "--skip_lpips"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)
    assert np.isfinite(main(argv + ["--device", "cpu"])["psnr"])
