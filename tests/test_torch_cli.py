"""The port's training CLI (`spnerf_torch.cli.train.main`) against the JAX
package's, on a synthetic DFC2019 AOI (40 x 36 px, 3 train and 1 test
images, a 24-cell ROI) with a small float32 flagship-shaped field (Siren
4 x 32, mapping, 3 semantic classes, 8 samples, guided sampling, solar
correction, depth and semantic losses) on the CPU.

* The schedule: on the same argv, both packages log the same (step, split)
  rows in metrics.jsonl (train windows, per-view and mean validation rows)
  and save the same checkpoint steps. Batch 512 makes an epoch 8 steps, so
  a 12-step run with windows of 4 validates and saves at 8 (epoch 1) and
  at 12 (the final validation). The hash family's windows are capped at
  the JAX package's sparse-op budget: 38 steps, then a tail of 2.
* Resume: 8 steps in one run, and 4 steps followed by `--auto_resume` to
  8, end with bit-equal parameters and optimizer state (the step's draws
  are seeded by (seed, step)). The depth and semantic losses drop at a
  fraction of `--max_train_steps` in both packages, so runs of different
  lengths differ once one of them drops; `--ds_drop 1` keeps the drop at
  the end of each run.
* A finished run re-invoked does nothing.
* `--watchdog` with SPNERF_TEST_HANG_ONCE: the first child hangs after its
  first window, is killed after 5 s of silence and relaunched, and the
  relaunch completes the run (the whole run within 120 s).
* Without CUDA and without `--device cpu`, `main` raises before it writes
  anything.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from spnerf_tpu.cli.train import main as jax_main
from spnerf_torch.cli.train import main
from spnerf_torch.train.checkpoints import CheckpointManager
from spnerf_torch.utils.synth_scene import write_synthetic_aoi

ROOT = Path(__file__).resolve().parent.parent
AOI = "JAX_269"
FLAGS = ["--aoi_id", AOI, "--model", "sp-nerf", "--no_timestamp_exp_name",
         "--n_samples", "8", "--fc_units", "32", "--fc_layers", "4",
         "--mapping", "--guidedsample", "--sem", "--num_sem_classes", "3",
         "--sc_lambda", "0.1", "--depth", "--ds_lambda", "1.0",
         "--ss_lambda", "1.0", "--precision", "fp32", "--chunk", "1024",
         "--check_val_every_n_epoch", "1", "--save_every_n_epochs", "1",
         "--data_axis", "1"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tier-1 command runs six test processes on
    the machine's cores, and more threads each only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    write_synthetic_aoi(str(root / "port" / "dataset" / "DFC2019_269"),
                        width=40, height=36, roi_size=24, seed=5)
    return root


def copy_project(src, dst):
    """A project of its own (the first load writes scene.loc)."""
    shutil.copytree(src / "port" / "dataset", dst / "dataset")
    return dst


def argv(proj, exp, *extra):
    return FLAGS + ["--project_dir", str(proj), "--exp_name", exp, *extra]


def rows(proj, exp):
    path = proj / "output" / exp / "logs" / "metrics.jsonl"
    return [(r["step"], r["split"])
            for r in map(json.loads, path.read_text().splitlines())]


def ckpt_steps(proj, exp):
    return sorted(int(p.name) for p in (proj / "output" / exp / "ckpts")
                  .iterdir() if p.name.isdigit())


VAL_ROWS = [f"train_{AOI}_000_RGB", f"val_{AOI}_003_RGB", "val"]
SCHEDULES = {
    # windows of 4, an epoch of 8 steps: validation and saves at 8 and 12
    "siren": (["--batch_size", "512", "--log_every", "4",
               "--max_train_steps", "12"],
              [(4, "train"), (8, "train"), *[(8, v) for v in VAL_ROWS],
               (12, "train"), *[(12, v) for v in VAL_ROWS]], [8, 12]),
    # the hash family's window cap: 2400 // (3 passes x (2 x 8 levels + 2)
    # + 8) = 38 steps, then a tail window of 2
    "hash": (["--encoding", "hash", "--hash_log2T", "10", "--hash_hidden",
              "16", "--batch_size", "64", "--log_every", "100",
              "--max_train_steps", "40"],
             [(38, "train"), (40, "train"), *[(40, v) for v in VAL_ROWS]],
             [40]),
}


@pytest.mark.parametrize("family", sorted(SCHEDULES))
def test_schedule_matches_jax(project, tmp_path, family):
    jproj = copy_project(project, tmp_path / "jax")
    run, want_rows, want_ckpts = SCHEDULES[family]
    main(argv(project / "port", family, *run, "--device", "cpu"))
    jax_main(argv(jproj, family, *run))
    ours = rows(project / "port", family)
    assert ours == rows(jproj, family) == want_rows
    assert ckpt_steps(project / "port", family) == ckpt_steps(
        jproj, family) == want_ckpts


def full_state(state):
    sd = {f"model.{k}": v for k, v in state.model.state_dict().items()}
    opt = state.optimizer.state_dict()
    for i, st in opt["state"].items():
        for k, v in st.items():
            sd[f"opt.{i}.{k}"] = v
    return sd, state.step


def test_auto_resume_equals_uninterrupted_run(project, capsys):
    proj = project / "port"
    run = ["--batch_size", "64", "--log_every", "4", "--ds_drop", "1",
           "--device", "cpu"]
    whole = main(argv(proj, "whole", *run, "--max_train_steps", "8"))
    first = main(argv(proj, "parts", *run, "--max_train_steps", "4"))
    assert first.step == 4
    capsys.readouterr()
    resumed = main(argv(proj, "parts", *run, "--max_train_steps", "8",
                        "--auto_resume"))
    assert "auto-resumed parts at step 4" in capsys.readouterr().out
    (a, sa), (b, sb) = full_state(whole), full_state(resumed)
    assert sa == sb == 8 and set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert ckpt_steps(proj, "parts") == [4, 8]

    again = main(argv(proj, "parts", *run, "--max_train_steps", "8",
                      "--auto_resume"))
    assert "nothing to do" in capsys.readouterr().out
    assert again.step == 8 and ckpt_steps(proj, "parts") == [4, 8]
    # the finished run's checkpoint holds the final state
    restored = CheckpointManager(proj / "output" / "parts" / "ckpts")
    assert restored.latest_step() == 8


def test_watchdog_relaunches_a_hung_run(project, tmp_path):
    proj = copy_project(project, tmp_path / "wd")
    marker = tmp_path / "hang_marker"
    # TensorFlow, where installed, costs each child ~15 s of imports through
    # TensorBoard; without it TensorBoard takes its own stub, as on a
    # machine that lacks TensorFlow
    stub = tmp_path / "no_tensorflow" / "tensorflow"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("raise ImportError('hidden')\n")
    env = dict(os.environ, SPNERF_TEST_HANG_ONCE=str(marker),
               OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), str(stub.parent)]))
    # --watchdog 20, as the JAX twin (tests/test_train.py): start-up (the
    # imports, the scene and the first window) gets 3 x 20 s, so a machine
    # loaded by other test workers is not taken for a hang
    cmd = [sys.executable, str(ROOT / "main_torch.py"),
           *argv(proj, "wd", "--batch_size", "64", "--log_every", "2",
                 "--max_train_steps", "4", "--device", "cpu",
                 "--watchdog", "20")]
    # from outside the repo: the child must import the package by the
    # PYTHONPATH the watchdog gives it
    proc = subprocess.Popen(cmd, cwd=tmp_path, env=env,
                            start_new_session=True, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        # two start-ups of up to 60 s each and the 20 s the hang takes to
        # be noticed
        out, _ = proc.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"the watchdog run did not finish in 240 s:\n{out}")
    assert proc.returncode == 0, out
    assert marker.exists() and "[test-hook] simulating hang" in out
    assert "[watchdog] relaunch 1/" in out and "training complete" in out
    steps = [s for s, split in rows(proj, "wd") if split == "train"]
    assert max(steps) == 4


def test_main_raises_without_cuda(project, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    proj = tmp_path / "nocuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv(proj, "x", "--max_train_steps", "1"))
    assert not proj.exists()
