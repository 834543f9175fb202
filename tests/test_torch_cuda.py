"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance: bf16, 2e-2 absolute (the kernel and the plain version sum in
different orders, which can move an activation by one bf16 ulp).
"""

import itertools

import numpy as np
import pytest
import torch

from spnerf_torch.config import ModelConfig, RenderConfig
from spnerf_torch.models import load_model
from spnerf_torch.ops import field_eval as fe
from spnerf_torch.render import build_render_fn, chunk_size
from spnerf_torch.utils.synth import fake_batch

ATOL = 2e-2


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def field_inputs(n, cfg, device, seed=0):
    g = np.random.default_rng(seed)
    xyz = g.normal(size=(n, 3)).astype(np.float32) * 0.3
    sun = g.normal(size=(n, 3)).astype(np.float32)
    sun /= np.linalg.norm(sun, axis=-1, keepdims=True)
    sems = g.integers(-1, cfg.num_sem_classes, size=n)
    t_emb = g.normal(size=(n, cfg.t_embedding_dims)).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(device)
    return (to(xyz), to(sun), to(t_emb) if cfg.beta else None,
            to(np.where(sems < 0, -100, sems)) if cfg.sem else None)


def packed_field(cfg, device):
    model = load_model(cfg, "bfloat16", device=device,
                       generator=torch.Generator().manual_seed(0))
    return model, fe.pack_params(model)


@pytest.mark.cuda
@pytest.mark.parametrize("kw,n", [
    (dict(sem=True, num_sem_classes=3), 1000),
    (dict(beta=True), 777),
    (dict(sem=True, num_sem_classes=5, fc_units=256), 64),
])
def test_kernel_matches_plain_every_head_subset(device, kw, n):
    cfg = ModelConfig(mapping=True, fc_units=kw.pop("fc_units", 128), **kw)
    _, p = packed_field(cfg, device)
    args = field_inputs(n, cfg, device)
    for r in range(len(fe.ALL_HEADS) + 1):
        for heads in itertools.combinations(fe.ALL_HEADS, r):
            before = fe.FusedField.launches
            out = fe.FusedField(p)(*args, heads=heads)
            torch.cuda.synchronize()
            assert fe.FusedField.launches == before + 1
            ref = fe.PlainField(p)(*args, heads=heads)
            assert set(out) == set(ref), heads
            for k in ref:
                assert out[k].shape == ref[k].shape
                err = (out[k] - ref[k]).abs().max().item()
                assert err <= ATOL, (heads, k, err)


@pytest.mark.cuda
def test_kernel_refuses_float32_compute(device):
    cfg = ModelConfig(mapping=True, sem=True, num_sem_classes=3, fc_units=64)
    _, p = packed_field(cfg, device)
    with pytest.raises(NotImplementedError):
        fe.FusedField(p, "float32")(*field_inputs(16, cfg, device))


@pytest.mark.cuda
def test_render_image_uses_kernel(device):
    """The eval renderer on CUDA launches the kernel three times per chunk
    and agrees with the same render through the plain field."""
    cfg = ModelConfig(mapping=True, sem=True, num_sem_classes=3, fc_units=128)
    rc = RenderConfig(n_samples=16, guidedsample=True, solar_correction=True,
                      sem=True, compute_dtype="bfloat16")
    model, _ = packed_field(cfg, device)
    batch = fake_batch(np.random.default_rng(0), 3000)
    fe.FusedField.launches = 0
    out = build_render_fn(model, rc, chunk=1024)(batch["rays"], 0,
                                                 batch["sems"])
    torch.cuda.synchronize()
    assert fe.FusedField.launches == 3 * -(-3000 // chunk_size(rc, 1024))
    ref = build_render_fn(model, rc, chunk=1024, field="plain")(
        batch["rays"], 0, batch["sems"])
    for k in ref:
        err = (out[k] - ref[k]).abs()
        assert torch.isfinite(out[k]).all(), k
        assert torch.quantile(err.flatten().float(), 0.99) <= 2e-2, k
