"""The port's image metrics against the JAX package's (float32, 1e-6)."""

import numpy as np
import pytest
import torch

from spnerf_tpu.evaluation import metrics as jm
from spnerf_torch.evaluation import metrics as tm


@pytest.mark.parametrize("layout", ["chw", "hwc"])
def test_psnr_ssim(layout, rng):
    shape = (3, 17, 23) if layout == "chw" else (17, 23, 3)
    gt = rng.uniform(size=shape).astype(np.float32)
    pred = np.clip(gt + rng.normal(scale=0.05, size=shape), 0, 1).astype(
        np.float32)
    for name in ("psnr", "ssim"):
        ref = float(getattr(jm, name)(pred, gt))
        got = float(getattr(tm, name)(torch.from_numpy(pred),
                                      torch.from_numpy(gt)))
        assert got == pytest.approx(ref, abs=1e-5 if name == "psnr" else 1e-6)


def test_masked_mse(rng):
    pred = rng.uniform(size=(50, 3)).astype(np.float32)
    gt = rng.uniform(size=(50, 3)).astype(np.float32)
    mask = rng.uniform(size=(50, 1)) > 0.3
    ref = float(jm.mse(pred, gt, mask))
    got = float(tm.mse(torch.from_numpy(pred), torch.from_numpy(gt),
                       torch.from_numpy(mask)))
    assert got == pytest.approx(ref, abs=1e-7)


def test_miou_and_accuracy(rng):
    gt = rng.integers(0, 4, size=(20, 20))
    pred = np.where(rng.uniform(size=gt.shape) < 0.7, gt,
                    rng.integers(0, 4, size=gt.shape))
    # 5 classes: class 4 has an empty union and counts IoU 0
    ref = float(jm.miou(pred, gt, 5))
    assert float(tm.miou(torch.from_numpy(pred), torch.from_numpy(gt),
                         5)) == pytest.approx(ref, abs=1e-6)
    ref = float(jm.overall_accuracy(pred, gt))
    assert float(tm.overall_accuracy(torch.from_numpy(pred),
                                     torch.from_numpy(gt))) == pytest.approx(
                                         ref, abs=1e-7)
