"""Checkpoints and resume: the counterpart of the JAX package's orbax
`CheckpointManager` (`spnerf_tpu/train/checkpoints.py`), with orbax's
storage replaced by `torch.save` and `torch.load(weights_only=True)`.

One directory per step, `<ckpts>/<step>/`, as orbax lays them out, holding
`state.pt` (the step, the state dicts of the field, the transient
embedding, the fine field and the proposal field, the occupancy grid, the
optimizer's `state_dict` and its class) and, when metrics were given,
`metrics.json`. A checkpoint written without the fine field, the proposal
field and the grid (before they were ported) restores into a run without
them. A step is written into a temporary directory and
renamed into place, so a directory named by a step is always whole.
Retention is keep-all; the best step is the one with the highest
`val_psnr` (the latest of equals, as orbax sorts), among those that carry
metrics. The step's random draws come from a generator seeded by (seed,
step) (`Trainer.step_generator`), so a resumed run draws what an
uninterrupted one does and no generator state is saved.

Under a mesh (`parallel.data_mesh`) the state is replicated: rank 0 writes
the checkpoint and the ranks then meet at a barrier; every rank restores.
So a checkpoint of a mesh run restores into a run of one rank, and back.
"""

import json
import os
import shutil
import tempfile
from typing import Optional

import torch

STATE = "state.pt"
METRICS = "metrics.json"
# the TrainState's modules and the flag that makes each
MODULES = {"model": "the field", "t_embed": "--beta",
           "fine": "--n_importance", "proposal": "--proposal"}


class StepAlreadyExistsError(ValueError):
    """A checkpoint of this step exists (orbax raises its namesake)."""


class CheckpointManager:
    def __init__(self, ckpts_dir, mesh=None):
        self.dir = os.path.abspath(ckpts_dir)
        self.mesh = mesh
        os.makedirs(self.dir, exist_ok=True)

    def step_path(self, step):
        return os.path.join(self.dir, str(int(step)))

    def all_steps(self):
        return sorted(int(name) for name in os.listdir(self.dir)
                      if name.isdigit()
                      and os.path.isfile(os.path.join(self.dir, name, STATE)))

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def metrics(self, step):
        """The metrics saved with `step`, or None."""
        path = os.path.join(self.step_path(step), METRICS)
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return json.load(f)

    def best_step(self):
        """The step with the highest recorded val_psnr (a checkpoint without
        it ranks at -inf); None when no checkpoint carries metrics."""
        best, best_v = None, None
        for step in self.all_steps():
            m = self.metrics(step)
            if m is None:
                continue
            v = m.get("val_psnr", float("-inf"))
            if best is None or v >= best_v:
                best, best_v = step, v
        return best

    def save(self, step, state, metrics=None):
        """Write `state` (a `TrainState`) as checkpoint `step`: on rank 0,
        the other ranks waiting at a barrier until it is written."""
        if self.mesh is None:
            return self._write(step, state, metrics)
        if self.mesh.is_main:
            self._write(step, state, metrics)
        self.mesh.barrier()

    def _write(self, step, state, metrics):
        path = self.step_path(step)
        if os.path.exists(path):
            raise StepAlreadyExistsError(f"checkpoint {path} already exists")
        blob = {
            "step": int(state.step),
            "optimizer": state.optimizer.state_dict(),
            "optimizer_class": type(state.optimizer).__name__,
            "occ": state.occ,
        }
        for key in MODULES:
            module = getattr(state, key)
            blob[key] = None if module is None else module.state_dict()
        tmp = tempfile.mkdtemp(prefix=f".{int(step)}.", dir=self.dir)
        try:
            torch.save(blob, os.path.join(tmp, STATE))
            if metrics is not None:
                with open(os.path.join(tmp, METRICS), "w") as f:
                    json.dump({k: float(v) for k, v in metrics.items()}, f)
            os.rename(tmp, path)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    def restore(self, target_state, step: Optional[int] = None):
        """Load checkpoint `step` (None: the latest) into `target_state`, a
        `TrainState` built from the run's flags, in place, on its device.
        Returns it, or None when there is no such checkpoint."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        path = os.path.join(self.step_path(step), STATE)
        if not os.path.exists(path):
            return None
        blob = torch.load(path, map_location="cpu", weights_only=True)
        try:
            saved_cls = blob["optimizer_class"]
            cls = type(target_state.optimizer).__name__
            if saved_cls != cls:
                raise RuntimeError(f"the checkpoint's optimizer is {saved_cls}"
                                   f", the run's {cls}")
            for key, flag in MODULES.items():
                module = getattr(target_state, key)
                if (blob.get(key) is None) != (module is None):
                    raise RuntimeError(f"the checkpoint and the run disagree "
                                       f"on the {key} module ({flag})")
            if (blob.get("occ") is None) != (target_state.occ is None):
                raise RuntimeError("the checkpoint and the run disagree on "
                                   "the occupancy grid (--occgrid)")
            for key in MODULES:
                module = getattr(target_state, key)
                if module is not None:
                    module.load_state_dict(blob[key])
            if target_state.occ is not None:
                target_state.occ.copy_(blob["occ"])
            target_state.optimizer.load_state_dict(blob["optimizer"])
        except (RuntimeError, KeyError, ValueError) as exc:
            raise RuntimeError(
                f"checkpoint restore from {self.dir} (step {step}) failed — "
                "the model built from the CURRENT flags must match the "
                "architecture that was trained (e.g. pass the original "
                "--fc_units/--hash_levels/--hash_features and optimizer "
                "flags; the run's opts.json records them). Underlying "
                f"error: {exc}") from exc
        target_state.step = int(blob["step"])
        return target_state
