"""LPIPS perceptual distance (AlexNet backbone) as a torch module.

The graph of the JAX package's `evaluation/lpips.py`, with
`torch.nn.functional.conv2d` in place of XLA's convolution: the input scaled
by (x - shift) / scale with shift = (-.030, -.088, -.188) and scale = (.458,
.448, .450), the AlexNet conv stack with taps after each of its five ReLUs
and a 3x3 stride-2 max pool after the first two, each tap unit-normalised
over channels, the squared difference weighted by the learned 1x1 linear
heads, the spatial mean, summed over taps.

Weights load from the JAX package's .npz (`weight_spec`), from
`weights_path` or the SPNERF_LPIPS_WEIGHTS variable. Without weights,
`lpips()` returns NaN with a warning: the metric is defined, its constants
are absent. The module runs on the device it is given; float32 products
(TF32 off), so that the card and the CPU agree.
"""

import os
import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# AlexNet conv stack: (out_ch, kernel, stride, pad), tap after each relu
_ALEX = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
_POOL_AFTER = {0, 1}

_weights_cache = {}
_module_cache = {}


def weight_spec():
    """The .npz contract for LPIPS v0.1 'alex' weights: key -> shape.
    conv{i}_{w,b}: torchvision AlexNet `features` conv weights, OIHW / (O,);
    lin{i}_w: the lpips package's 1x1 linear heads, (1, C_i, 1, 1)."""
    spec = {}
    in_ch = 3
    for i, (out_ch, k, _, _) in enumerate(_ALEX):
        spec[f"conv{i}_w"] = (out_ch, in_ch, k, k)
        spec[f"conv{i}_b"] = (out_ch,)
        spec[f"lin{i}_w"] = (1, out_ch, 1, 1)
        in_ch = out_ch
    return spec


def load_weights(weights_path=None):
    """{key: float32 array} from the .npz, checked against `weight_spec`;
    None when no file is given or found."""
    path = weights_path or os.environ.get("SPNERF_LPIPS_WEIGHTS")
    if not path or not os.path.exists(path):
        return None
    if path not in _weights_cache:
        with np.load(path) as z:
            w = {k: np.asarray(z[k], np.float32) for k in z.files}
        spec = weight_spec()
        missing = sorted(set(spec) - set(w))
        if missing:
            raise ValueError(f"LPIPS weights {path} missing keys {missing}; "
                             f"expected contract: {spec}")
        for k, shape in spec.items():
            if tuple(w[k].shape) != shape:
                raise ValueError(
                    f"LPIPS weight {k} in {path} has shape "
                    f"{tuple(w[k].shape)}, expected {shape}")
        _weights_cache[path] = w
    return _weights_cache[path]


class LPIPS(nn.Module):
    """LPIPS(alex) between two (H, W, 3) images in [0, 1] on `device`."""

    def __init__(self, weights, device):
        super().__init__()
        for k in weight_spec():
            self.register_buffer(k, torch.from_numpy(weights[k]))
        self.register_buffer("shift", torch.from_numpy(_SHIFT))
        self.register_buffer("scale", torch.from_numpy(_SCALE))
        self.to(device)

    def _prep(self, img):
        img = torch.as_tensor(img, dtype=torch.float32,
                              device=self.shift.device) * 2.0 - 1.0
        img = (img - self.shift) / self.scale
        return torch.movedim(img, -1, 0)[None]  # (1, 3, H, W)

    def _features(self, x):
        feats = []
        for i, (_, _, stride, pad) in enumerate(_ALEX):
            x = F.relu(F.conv2d(x, getattr(self, f"conv{i}_w"),
                                getattr(self, f"conv{i}_b"), stride=stride,
                                padding=pad))
            feats.append(x)
            if i in _POOL_AFTER:
                x = F.max_pool2d(x, kernel_size=3, stride=2)
        return feats

    @staticmethod
    def _unit_normalize(x, eps=1e-10):
        return x / (torch.sqrt(torch.sum(x ** 2, dim=1, keepdim=True)) + eps)

    @torch.no_grad()
    def forward(self, pred, gt):
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            f0 = self._features(self._prep(pred))
            f1 = self._features(self._prep(gt))
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        total = torch.zeros((), device=self.shift.device)
        for i, (a, b) in enumerate(zip(f0, f1)):
            d = (self._unit_normalize(a) - self._unit_normalize(b)) ** 2
            lin = getattr(self, f"lin{i}_w")
            total = total + torch.mean(torch.sum(d * lin, dim=1))
        return total


def lpips(pred, gt, weights_path=None, device=None):
    """LPIPS(alex) between two (H, W, 3) images in [0, 1], on `device` (the
    card by default; raises without CUDA unless given "cpu"). NaN if no
    weights."""
    device = resolve_device(device)
    weights = load_weights(weights_path)
    if weights is None:
        warnings.warn(
            "LPIPS weights unavailable (set SPNERF_LPIPS_WEIGHTS to an .npz "
            "of the spec in weight_spec); returning NaN", stacklevel=2)
        return float("nan")
    key = (weights_path or os.environ.get("SPNERF_LPIPS_WEIGHTS"), device)
    if key not in _module_cache:
        _module_cache[key] = LPIPS(weights, device)
    return float(_module_cache[key](pred, gt))
