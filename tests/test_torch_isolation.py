"""The port stands alone: no JAX and nothing of the JAX package in
`spnerf_torch/`, `chip_smoke.py` or the port's root scripts, and no quiet
fallback to the CPU."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "flax", "optax", "spnerf_tpu")


def port_sources():
    files = sorted((ROOT / "spnerf_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "main_torch.py",
              ROOT / "eval_torch.py", ROOT / "dryrun_torch.py",
              ROOT / "bench_torch.py"]
    return files


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_port_imports_no_jax():
    files = port_sources()
    assert len(files) > 10 and all(f.exists() for f in files)
    for module in ("data/micmac.py", "data/synth_depth.py",
                   "data/create_dataset.py", "visualization/depth.py",
                   "switches.py"):
        assert ROOT / "spnerf_torch" / module in files, module
    bad = [(f.relative_to(ROOT), m) for f in files
           for m in imported_modules(f)
           if m and m.split(".")[0] in BANNED]
    assert not bad, bad


def test_device_helper_refuses_to_pick_cpu(monkeypatch):
    from spnerf_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    assert resolve_device("cpu") == torch.device("cpu")


def test_entry_points_raise_without_cuda(monkeypatch):
    import bench_torch
    from spnerf_torch.config import ModelConfig
    from spnerf_torch.models import init_spnerf, load_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(fc_units=32)
    with pytest.raises(RuntimeError):
        load_model(cfg)
    with pytest.raises(RuntimeError):
        init_spnerf(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_torch.main([])
    assert next(load_model(cfg, device="cpu").parameters()).device.type == "cpu"


def test_train_entry_points_raise_without_cuda(monkeypatch):
    from spnerf_torch.config import LossConfig, ModelConfig, RenderConfig
    from spnerf_torch.models import load_model
    from spnerf_torch.train.loop import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hash_cfg = ModelConfig(encoding="hash", hash_levels=2, hash_log2T=10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_model(hash_cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(hash_cfg, RenderConfig(), LossConfig())
    tr = Trainer(hash_cfg, RenderConfig(), LossConfig(), device="cpu")
    state = tr.init_state(torch.Generator().manual_seed(0))
    assert next(state.model.parameters()).device.type == "cpu"


def test_cli_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """The training and evaluation CLIs, `tools render`, `tools
    cal-rmse-depth` (its DSM splat) and LPIPS run on the card unless asked
    for the CPU: without CUDA they raise before they write anything."""
    from spnerf_torch.cli import evaluate, train
    from spnerf_torch.evaluation.lpips import lpips
    from spnerf_torch.tools import main as tools_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    proj = tmp_path / "proj"
    calls = [
        lambda: train.main(["--aoi_id", "JAX_269", "--project_dir",
                            str(proj)]),
        lambda: train.main(["--aoi_id", "JAX_269", "--project_dir",
                            str(proj), "--device", "cuda:0"]),
        lambda: evaluate.main(["--project_dir", str(proj), "--exp_name",
                               "e", "--dataset_dir", str(proj)]),
        lambda: tools_main(["render", "--run_dir", str(proj)]),
        lambda: tools_main(["cal-rmse-depth", "--pts3d_ecef", str(proj),
                            "--gt_dir", str(proj), "--aoi_id", "JAX_269"]),
        lambda: lpips(None, None, weights_path=str(proj)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert not proj.exists()


def test_dataset_preparation_needs_no_device(monkeypatch, tmp_path):
    """`python -m spnerf_torch.data.create_dataset` and the depth synthesis
    are host numpy: they run without CUDA and without a device flag."""
    from spnerf_torch.data.create_dataset import main
    from spnerf_torch.data.synth_depth import synthesize_depth_from_lidar
    from spnerf_torch.utils.synth_scene import write_raw_aoi

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    write_raw_aoi(str(tmp_path / "raw"), crop_px=24, roi_size=16)
    out, _, json_dir = main(["--aoi_id", "JAX_269", "--dataset_dir",
                             str(tmp_path / "raw"), "--output_dir",
                             str(tmp_path / "out")])
    assert synthesize_depth_from_lidar(json_dir, f"{out}/Truth", "JAX_269",
                                       f"{out}/Depth", verbose=False)
