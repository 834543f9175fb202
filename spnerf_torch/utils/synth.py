"""The flagship configuration and synthetic ray batches, in numpy."""

import numpy as np

from ..config import ModelConfig, RenderConfig


def flagship_configs(n_samples=64, fc_units=512):
    """The flagship sp-nerf field and renderer: Siren 8 x fc_units with a
    skip at layer 4, 10-frequency mapping plus a 3-class semantic embedding,
    64 stratified samples, depth-guided resampling, solar correction,
    bf16 compute."""
    mc = ModelConfig(mapping=True, sem=True, num_sem_classes=3,
                     fc_units=fc_units, fc_layers=8, skips=(4,))
    rc = RenderConfig(n_samples=n_samples, guidedsample=True,
                      solar_correction=True, sem=True,
                      compute_dtype="bfloat16")
    return mc, rc


def fake_batch(rng, n):
    """Synthetic scene rows (11-column rays plus supervision) from a numpy
    Generator."""
    o = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    sun = rng.normal(size=(n, 3)).astype(np.float32)
    sun /= np.linalg.norm(sun, axis=-1, keepdims=True)
    rays = np.concatenate(
        [o, d, np.zeros((n, 1), np.float32), np.full((n, 1), 1.5, np.float32),
         sun], axis=-1)
    return {
        "rays": rays,
        "rgbs": rng.uniform(size=(n, 3)).astype(np.float32),
        "ids": np.zeros(n, np.int32),
        "depths": np.stack([np.full(n, 0.7, np.float32),
                            rng.uniform(size=n).astype(np.float32)], axis=-1),
        "valid_depth": (rng.uniform(size=n) > 0.5).astype(np.float32),
        "depth_std": np.full(n, 0.05, np.float32),
        "sems": rng.integers(0, 3, size=n).astype(np.int32),
    }
