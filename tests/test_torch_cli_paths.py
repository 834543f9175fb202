"""The training CLI on the other render paths, on the CPU: `main` with
--occgrid, --n_importance, --proposal and a comma-separated --aoi_id on a
synthetic DFC2019 AOI (40 x 36 px, the flagship-shaped Siren 4 x 32 of
tests/test_torch_cli.py).

* Each trains, validates and saves; 4 steps followed by `--auto_resume`
  to 8 end with the state of an uninterrupted 8-step run bit for bit: every
  module's parameters (the field, the fine field, the proposal field), the
  optimizer's state and the occupancy grid. `tools render --step best`
  re-renders the best checkpoint (with its grid) to the logged PSNR, SSIM
  and MAE within 1e-6.
* The hash family's windows with the fine pass and the grid: both packages
  log and save at the same steps (the JAX package's sparse-op cap counts
  the fine pass's two encodings and the grid's lookup and refresh:
  2400 // (5 x 18 + 8 + 9) = 22 steps a window).
"""

import json
import shutil

import pytest
import torch

from spnerf_tpu.cli.train import main as jax_main
from spnerf_torch.cli.train import main
from spnerf_torch.tools import main as tools_main
from spnerf_torch.utils.synth_scene import write_synthetic_aoi

AOI = "JAX_269"
FLAGS = ["--model", "sp-nerf", "--no_timestamp_exp_name",
         "--n_samples", "8", "--fc_units", "32", "--fc_layers", "4",
         "--mapping", "--sem", "--num_sem_classes", "3",
         "--sc_lambda", "0.1", "--ss_lambda", "1.0", "--precision", "fp32",
         "--chunk", "1024", "--check_val_every_n_epoch", "1",
         "--save_every_n_epochs", "1", "--batch_size", "64",
         "--log_every", "4", "--ds_drop", "1", "--data_axis", "1",
         "--device", "cpu"]
PATHS = {
    "occgrid": ["--aoi_id", AOI, "--occgrid", "--occ_res", "8",
                "--occ_rows", "100", "--guidedsample"],
    "fine": ["--aoi_id", AOI, "--n_importance", "8", "--guidedsample",
             "--depth", "--ds_lambda", "1.0"],
    "proposal": ["--aoi_id", AOI, "--proposal", "--n_proposal", "16"],
    "multi": ["--aoi_id", f"{AOI},{AOI}", "--guidedsample", "--depth",
              "--ds_lambda", "1.0"],
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread, as tests/test_torch_cli.py runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_paths")
    write_synthetic_aoi(str(root / "dataset" / "DFC2019_269"), width=40,
                        height=36, roi_size=24, seed=5)
    return root


def argv(proj, exp, path, *extra):
    return (FLAGS + PATHS[path]
            + ["--project_dir", str(proj), "--exp_name", exp, *extra])


def full_state(state):
    sd = {f"param.{k}": v for k, v in state.named_parameters()}
    for i, st in state.optimizer.state_dict()["state"].items():
        sd.update({f"opt.{i}.{k}": v for k, v in st.items()})
    if state.occ is not None:
        sd["occ"] = state.occ
    return sd, state.step


def metrics(proj, exp):
    path = proj / "output" / exp / "logs" / "metrics.jsonl"
    return [json.loads(ln) for ln in path.read_text().splitlines()]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_path_trains_validates_saves_and_resumes(project, path, capsys):
    whole = main(argv(project, f"{path}_whole", path,
                      "--max_train_steps", "8"))
    first = main(argv(project, f"{path}_parts", path,
                      "--max_train_steps", "4"))
    assert first.step == 4
    part = {"occgrid": first.occ, "fine": first.fine,
            "proposal": first.proposal, "multi": True}[path]
    assert part is not None
    capsys.readouterr()
    resumed = main(argv(project, f"{path}_parts", path,
                        "--max_train_steps", "8", "--auto_resume"))
    assert f"auto-resumed {path}_parts at step 4" in capsys.readouterr().out
    (a, sa), (b, sb) = full_state(whole), full_state(resumed)
    assert sa == sb == 8 and set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k

    rows = metrics(project, f"{path}_whole")
    val = [r for r in rows if r["split"] == "val"]
    views = [r for r in rows if r["split"].startswith(("train_", "val_"))]
    assert len(val) == 1 and len(views) == (4 if path == "multi" else 2)
    out = tools_main(["render", "--run_dir",
                      str(project / "output" / f"{path}_whole"),
                      "--step", "best", "--device", "cpu", "--out_dir",
                      str(project / f"render_{path}")])
    logged = [r for r in val if r["step"] == out["step"]][-1]
    for k in ("psnr", "ssim", "mae"):
        assert abs(out[k] - logged[k]) <= 1e-6, k


def test_hash_window_with_fine_and_grid_matches_jax(project, tmp_path):
    run = ["--aoi_id", AOI, "--encoding", "hash", "--hash_log2T", "10",
           "--hash_hidden", "16", "--guidedsample", "--n_importance", "4",
           "--occgrid", "--occ_res", "8", "--log_every", "100",
           "--max_train_steps", "24", "--check_val_every_n_epoch", "100"]
    base = [a for a in FLAGS if a not in ("--device", "cpu")]

    def rows(proj):
        return [(r["step"], r["split"]) for r in metrics(proj, "w")
                if r["split"] == "train"]

    jproj = tmp_path / "jax"
    shutil.copytree(project / "dataset", jproj / "dataset")
    main(base + run + ["--project_dir", str(project), "--exp_name", "w",
                       "--device", "cpu"])
    jax_main(base + run + ["--project_dir", str(jproj), "--exp_name", "w"])
    assert rows(project) == rows(jproj) == [(22, "train"), (24, "train")]
