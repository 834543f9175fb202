"""The port's LPIPS(alex) module (`spnerf_torch/evaluation/lpips.py`)
against the JAX package's graph on random weights of the .npz spec (the
pretrained constants are not in the repository), on the CPU.

* The same value within 1e-5 absolute (float32 convolutions summed in
  another order), on square and non-square images, near and far pairs.
* An image against itself gives 0 (within 1e-6).
* Without weights: NaN and a warning; a file that breaks the spec raises.
* Without CUDA and without device="cpu", `lpips` raises.
"""

import numpy as np
import pytest
import torch

from spnerf_tpu.evaluation import lpips as jlp
from spnerf_torch.evaluation import lpips as lp


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    rng = np.random.default_rng(0)
    d = {}
    for k, shape in lp.weight_spec().items():
        if k.startswith("lin"):
            d[k] = np.abs(rng.normal(size=shape)).astype(np.float32)
        elif k.endswith("_b"):
            d[k] = rng.normal(size=shape).astype(np.float32) * 0.01
        else:
            d[k] = rng.normal(size=shape).astype(np.float32) * 0.05
    path = tmp_path_factory.mktemp("lpips") / "w.npz"
    np.savez(path, **d)
    return str(path)


def test_spec_matches_jax():
    assert lp.weight_spec() == jlp.weight_spec()


@pytest.mark.parametrize("shape,noise", [((64, 64), 0.02), ((64, 64), 0.3),
                                         ((72, 90), 0.1)])
def test_matches_jax(weights, shape, noise):
    rng = np.random.default_rng(shape[1])
    a = rng.uniform(size=shape + (3,)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape) * noise, 0, 1).astype(np.float32)
    ours = lp.lpips(a, b, weights_path=weights, device="cpu")
    ref = jlp.lpips(a, b, weights_path=weights)
    assert ours > 0
    assert abs(ours - ref) <= 1e-5, (ours, ref)


def test_identity_is_zero(weights):
    img = np.random.default_rng(1).uniform(size=(48, 48, 3)).astype(
        np.float32)
    assert abs(lp.lpips(img, img, weights_path=weights, device="cpu")) <= 1e-6


def test_nan_without_weights(monkeypatch):
    monkeypatch.delenv("SPNERF_LPIPS_WEIGHTS", raising=False)
    img = np.zeros((32, 32, 3), np.float32)
    with pytest.warns(UserWarning, match="SPNERF_LPIPS_WEIGHTS"):
        assert np.isnan(lp.lpips(img, img, device="cpu"))


def test_bad_weights_file_raises(tmp_path, weights):
    with np.load(weights) as z:
        d = {k: z[k] for k in z.files}
    d["conv0_w"] = d["conv0_w"][:, :, :5]
    path = tmp_path / "bad.npz"
    np.savez(path, **d)
    with pytest.raises(ValueError, match="conv0_w"):
        lp.load_weights(str(path))


def test_raises_without_cuda(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = np.zeros((32, 32, 3), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lp.lpips(img, img, weights_path=weights)
