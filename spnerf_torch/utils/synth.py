"""The flagship and hash configurations, the flagship's command line,
synthetic scenes in numpy, the train-step setup the chip smoke test drives
and the program `bench_torch.py` times (`bench_setup`)."""

from dataclasses import replace

import numpy as np

from ..config import LossConfig, ModelConfig, RenderConfig

HASH_LR = 1e-2  # the hash family's table learning rate (NGP practice)
FLAGSHIP_LR = 5e-4
# the flagship's training command line on the synthetic AOI JAX_269
# (8x512 Siren, 64 samples, bf16 and batch 1024 are the parser's
# defaults); --chunk 40960 lets the renderer take its largest chunk
# (5,859 rays: 111 chunks a full-size view)
FLAGSHIP_CLI_FLAGS = [
    "--aoi_id", "JAX_269", "--model", "sp-nerf", "--mapping",
    "--guidedsample", "--sem", "--num_sem_classes", "3", "--sc_lambda",
    "0.1", "--depth", "--ds_lambda", "1.0", "--ss_lambda", "1.0", "--chunk",
    "40960", "--log_every", "5", "--no_timestamp_exp_name"]


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


def flagship_loss_config():
    """The flagship losses: solar terms (0.1), depth supervision (1.0),
    semantics (1.0)."""
    return LossConfig(sc_lambda=0.1, depth=True, ds_lambda=1.0, stdscale=1.0,
                      sem=True, ss_lambda=1.0)


def hash_configs(n_samples=64, flat_table=True):
    """The flagship configuration with the hash-grid trunk (8 levels x 4
    features, T = 2^19, hidden 64): (model, render, loss) configs. It
    trains at lr HASH_LR. flat_table=False keeps the table as (L, T, F)."""
    mc, rc = flagship_configs(n_samples)
    mc = replace(mc, encoding="hash", hash_flat_table=flat_table)
    return mc, rc, flagship_loss_config()


def train_setup(encoding="siren", n_rays=65536, device=None, seed=0,
                flat_table=True, mesh=None):
    """(trainer, data) of the flagship train step (encoding="siren", lr
    5e-4) or its hash family (encoding="hash", lr 1e-2; flat_table=False
    for the (L, T, F) table): a Trainer at 1000 steps per epoch and 30,000
    steps, and a device-resident synthetic scene of n_rays rows from `seed`
    (this rank's block of it over `mesh`, a `parallel.DataMesh`).
    The state comes from `trainer.init_state(generator)`."""
    from ..train.loop import Trainer

    if encoding == "hash":
        (mc, rc, lc), lr = hash_configs(flat_table=flat_table), HASH_LR
    else:
        mc, rc = flagship_configs()
        lc, lr = flagship_loss_config(), FLAGSHIP_LR
    trainer = Trainer(mc, rc, lc, lr=lr, steps_per_epoch=1000,
                      max_steps=30000, mesh=mesh, device=device)
    data = trainer.shard_data(fake_batch(np.random.default_rng(seed), n_rays))
    return trainer, data


def bench_setup(batch_size=1024, n_inner=100, n_rays=65536, device=None):
    """(trainer, state, data, run): the program `bench_torch.py` times, the
    JAX package's `bench_setup`. The flagship train step of
    `train_setup("siren")` (lr 5e-4, 1000 steps an epoch, 30,000 steps) on
    its n_rays-row synthetic scene of seed 0 on the device and the state
    from `trainer.init_state` with a generator of seed 0. run(state, data,
    seed) -> (state, the last step's loss terms) is one window: n_inner
    steps of `train_steps` on batch_size rays, in a plain loop where the
    JAX package scans them in one program; each step draws from (seed,
    step) with the step count advancing inside the window. Any change
    here, or in the configs and the scene it takes from `train_setup`,
    changes the benchmark."""
    import torch

    trainer, data = train_setup("siren", n_rays=n_rays, device=device)
    state = trainer.init_state(torch.Generator().manual_seed(0))

    def run(state, data, seed):
        return state, trainer.train_steps(state, data, n_inner, batch_size,
                                          seed)

    return trainer, state, data, run


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
