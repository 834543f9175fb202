"""The training CLI over two ranks on the CPU (`main_torch.py --device cpu
--data_axis 2`), the counterpart of `tests/test_multichip.py`'s
`--data_axis 8` run, on a synthetic DFC2019 AOI (40 x 36 px, 3 train and 1
test images, a 24-cell ROI) with a small float32 flagship-shaped field.

The run starts its two Gloo ranks itself and trains 20 steps in windows of
10 with a final validation. Checked: each log line, each metrics.jsonl row
and the checkpoint are written once (rank 0 alone writes); the checkpoint
restores into a trainer of one rank; and that trainer's `run_validation`
of the restored state gives the MAE the two ranks logged within 1e-6 m.
The run is a subprocess in a session of its own, killed with its ranks if
it outlasts 150 s.

Under a launcher (WORLD_SIZE set), --data_axis is 0 or the launcher's
world size, and --watchdog is refused.
"""

import json
import os
import signal
import subprocess
import sys
from argparse import Namespace
from collections import Counter
from pathlib import Path

import pytest
import torch

from spnerf_torch.cli.train import (build_trainer_and_scene, main,
                                    run_validation, run_world)
from spnerf_torch.config import build_train_parser
from spnerf_torch.train.checkpoints import CheckpointManager
from spnerf_torch.utils.logging import MetricLogger
from spnerf_torch.utils.synth_scene import write_synthetic_aoi

ROOT = Path(__file__).resolve().parent.parent
FLAGS = ["--aoi_id", "JAX_269", "--model", "sp-nerf", "--no_timestamp_exp_name",
         "--n_samples", "8", "--fc_units", "32", "--fc_layers", "4",
         "--mapping", "--guidedsample", "--sem", "--num_sem_classes", "3",
         "--sc_lambda", "0.1", "--depth", "--ds_lambda", "1.0",
         "--ss_lambda", "1.0", "--precision", "fp32", "--chunk", "1024",
         "--check_val_every_n_epoch", "1", "--save_every_n_epochs", "1",
         "--batch_size", "64", "--log_every", "10", "--max_train_steps", "20",
         "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_two_rank_cli_run(tmp_path):
    proj = tmp_path / "proj"
    write_synthetic_aoi(str(proj / "dataset" / "DFC2019_269"), width=40,
                        height=36, roi_size=24, seed=5)
    argv = FLAGS + ["--project_dir", str(proj), "--exp_name", "dp",
                    "--data_axis", "2"]
    # TensorFlow, where installed, costs each process ~15 s of imports
    # through TensorBoard; without it TensorBoard takes its own stub
    stub = tmp_path / "no_tensorflow" / "tensorflow"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("raise ImportError('hidden')\n")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT), str(stub.parent)]))
    proc = subprocess.Popen([sys.executable, str(ROOT / "main_torch.py"),
                             *argv], cwd=tmp_path, env=env,
                            start_new_session=True, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        out, _ = proc.communicate(timeout=150)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        pytest.fail(f"the 2-rank run did not finish in 150 s:\n{out}")
    assert proc.returncode == 0, out
    # the ranks share the pipe: count what they print, not whole lines
    for text in ("devices: 1 visible, 2 ranks on cpu",
                 "rank 0/2 device: cpu, gloo", "rank 1/2 device: cpu, gloo",
                 "step 10: loss", "step 20: loss", "training complete"):
        assert out.count(text) == 1, (text, out)
    assert out.count(": loss ") == 2, out

    run = proj / "output" / "dp"
    rows = [json.loads(r) for r in
            (run / "logs" / "metrics.jsonl").read_text().splitlines()]
    keys = Counter((r["step"], r["split"]) for r in rows)
    assert set(keys.values()) == {1}, keys
    assert (10, "train") in keys and (20, "train") in keys
    assert (20, "val") in keys
    assert sorted(p.name for p in (run / "ckpts").iterdir()) == ["20"]

    # the checkpoint into a trainer of one rank, and its validation
    args = Namespace(**json.loads((run / "logs" / "opts.json").read_text()))
    assert args.data_axis == 2
    trainer, scene, _ = build_trainer_and_scene(args, torch.device("cpu"))
    state = trainer.init_state(torch.Generator().manual_seed(123))
    assert CheckpointManager(run / "ckpts").restore(state) is not None
    assert state.step == 20
    args.logs_dir = str(tmp_path / "again")
    logger = MetricLogger(args.logs_dir, tensorboard=False)
    try:
        mean = run_validation(trainer, scene, state, args, 0, logger, False)
    finally:
        logger.close()
    logged = next(r for r in rows if (r["step"], r["split"]) == (20, "val"))
    assert abs(mean["mae"] - logged["mae"]) <= 1e-6, (mean, logged)
    assert abs(mean["psnr"] - logged["psnr"]) <= 1e-4, (mean, logged)


def test_data_axis_under_a_launcher(monkeypatch, tmp_path):
    parse = build_train_parser().parse_args
    base = ["--aoi_id", "JAX_269", "--project_dir", str(tmp_path)]
    cpu = torch.device("cpu")
    assert run_world(parse(base), cpu) == 1
    assert run_world(parse(base + ["--data_axis", "3"]), cpu) == 3
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert run_world(parse(base), cpu) == 2
    assert run_world(parse(base + ["--data_axis", "2"]), cpu) == 2
    with pytest.raises(SystemExit, match="launcher of 2 ranks"):
        run_world(parse(base + ["--data_axis", "3"]), cpu)
    with pytest.raises(SystemExit, match="watchdog"):
        main(base + ["--device", "cpu", "--watchdog", "5"])
    assert not (tmp_path / "output").exists()
