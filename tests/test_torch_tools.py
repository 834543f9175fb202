"""`python -m spnerf_torch.tools` (`render`, `summarize-runs`) on a run dir
made by the port's training CLI: a synthetic DFC2019 AOI (40 x 36 px, a
24-cell ROI), a small flagship-shaped field in float32 on the CPU, 12 steps
of 8 an epoch, so checkpoints at 8 and 12 with validation metrics.

* `render --step best|latest|8` restores that checkpoint and re-renders the
  validation views: PSNR, SSIM, MAE, mIoU and OA equal the values logged at
  that step within 1e-6 (the render is deterministic), and its outputs go
  to --out_dir.
* `summarize-runs` prints the same table as the JAX package's on that run
  dir, and its JSON rows.
* `render` raises without CUDA unless given --device cpu.
"""

import json

import pytest
import torch

from spnerf_tpu.tools import main as jax_tools_main
from spnerf_torch.cli.train import main as train_main
from spnerf_torch.tools import main
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
    root = tmp_path_factory.mktemp("tools")
    write_synthetic_aoi(str(root / "dataset" / "DFC2019_269"), width=40,
                        height=36, roi_size=24, seed=5)
    train_main([
        "--aoi_id", "JAX_269", "--model", "sp-nerf", "--exp_name", "tl",
        "--no_timestamp_exp_name", "--project_dir", str(root),
        "--n_samples", "8", "--fc_units", "32", "--fc_layers", "4",
        "--mapping", "--guidedsample", "--sem", "--num_sem_classes", "3",
        "--sc_lambda", "0.1", "--depth", "--ds_lambda", "1.0",
        "--ss_lambda", "1.0", "--precision", "fp32", "--chunk", "1024",
        "--batch_size", "512", "--log_every", "4", "--max_train_steps", "12",
        "--check_val_every_n_epoch", "1", "--save_every_n_epochs", "1",
        "--device", "cpu"])
    run_dir = root / "output" / "tl"
    logged = {}
    for line in (run_dir / "logs" / "metrics.jsonl").read_text().splitlines():
        rec = json.loads(line)
        if rec["split"] == "val":
            logged[rec["step"]] = rec
    assert sorted(logged) == [8, 12]
    return run_dir, logged


@pytest.mark.parametrize("step", ["best", "latest", "8"])
def test_render_gives_the_logged_validation(run, tmp_path, step):
    run_dir, logged = run
    want = {"latest": 12, "8": 8,
            "best": max(logged, key=lambda s: (logged[s]["psnr"], s))}[step]
    out = main(["render", "--run_dir", str(run_dir), "--step", step,
                "--device", "cpu", "--out_dir", str(tmp_path / "out")])
    assert out["step"] == want and out["epoch_number"] == 1
    for k in KEYS:
        assert abs(out[k] - logged[want][k]) <= 1e-6, (k, out[k])
    assert (tmp_path / "out" / "val" / "dsm"
            / "JAX_269_003_RGB_epoch1.tif").exists()


def test_summarize_runs_matches_jax(run, capsys):
    run_dir, logged = run
    for target in (run_dir, run_dir.parent):
        capsys.readouterr()
        rows = main(["summarize-runs", str(target)])
        ours = capsys.readouterr().out
        jax_tools_main(["summarize-runs", str(target)])
        assert ours == capsys.readouterr().out
        assert [r["steps"] for r in rows] == [12]
        assert rows[0]["views"]["JAX_269_003_RGB"]["psnr"] == round(
            logged[12]["psnr"], 3)
    main(["summarize-runs", "--json", str(run_dir)])
    ours = capsys.readouterr().out
    jax_tools_main(["summarize-runs", "--json", str(run_dir)])
    assert json.loads(ours) == json.loads(capsys.readouterr().out)


def test_render_raises_without_cuda(run, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["render", "--run_dir", str(run[0]), "--step", "best"])
