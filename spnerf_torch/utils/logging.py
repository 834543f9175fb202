"""Metric logging: JSONL stream + optional TensorBoard.

`spnerf_tpu/utils/logging.py`, in place of the reference SP-NeRF's
TensorBoardLogger. The primary sink is a machine-readable `metrics.jsonl`
(one {"step": ..., "split": ..., **scalars} object per line); TensorBoard event
files are written too when torch.utils.tensorboard imports (it needs the
tensorboard package, which is optional).
"""

import json
import os
import time

import numpy as np


class MetricLogger:
    def __init__(self, logs_dir, tensorboard=True):
        os.makedirs(logs_dir, exist_ok=True)
        self.path = os.path.join(logs_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=logs_dir)
            except ImportError:  # no tensorboard package
                self._tb = None

    def log_images(self, step, tag, stack):
        """stack: (N, 3, H, W) float [0,1] image grid (reference main.py:250
        logs GT/pred/depth/sem grids per validation image)."""
        if self._tb is not None:
            self._tb.add_images(tag, np.asarray(stack, dtype=np.float32),
                                int(step))

    def log(self, step, scalars, split="train"):
        rec = {"step": int(step), "split": split, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(f"{split}/{k}", float(v), int(step))

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
