"""The port stands alone: no JAX and nothing of the JAX package in
`spnerf_torch/` or `chip_smoke.py`, and no quiet fallback to the CPU."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "flax", "optax", "spnerf_tpu")


def port_sources():
    files = sorted((ROOT / "spnerf_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
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
    from spnerf_torch.config import ModelConfig
    from spnerf_torch.models import init_spnerf, load_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(fc_units=32)
    with pytest.raises(RuntimeError):
        load_model(cfg)
    with pytest.raises(RuntimeError):
        init_spnerf(torch.Generator(), cfg)
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
