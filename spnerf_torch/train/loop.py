"""The train step: the PyTorch version of the JAX package's `Trainer`
(`train/loop.py`) for one device.

The scene lives on the device; each step draws its batch of rays with
replacement from a generator seeded by (seed, step) and takes the render's
random draws from the same generator, so a run is a function of its seed.
The optimizer is Adam (β = 0.9, 0.999, eps 1e-8; `torch.optim.Adam` computes
optax's `adam` update) with the per-epoch staircase learning rate
lr * γ^(step // steps_per_epoch), evaluated at the update count before it
increments, as optax does. Beta warm-up (the SNeRF colour loss for the
first `first_beta_epoch` epochs) and the ds/ss drop schedules switch on the
step count.

The options `grad_clip`, `table_level_lr_decay`, `table_wd` and
`weight_decay` replace Adam by the JAX package's optax chain, in its order
(`AdamChain`); at their defaults the optimizer stays `torch.optim.Adam`.

The step runs eagerly and updates the state in place: the model's
parameters, the optimizer's moments and the step count. `train_steps(n)`
takes n steps in a plain loop where the JAX package scans them in one
program.

Not ported (they raise NotImplementedError): a device mesh, the occupancy
grid, the proposal sampler and the fine pass (`n_importance > 0`).
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..config import LossConfig, ModelConfig, RenderConfig
from ..device import resolve_device
from ..models import TransientEmbedding, load_model
from ..ops.render import check_supported, render_rays
from . import losses


def make_lr_schedule(lr, steps_per_epoch, gamma=0.9):
    """StepLR(step_size=1 epoch, gamma) as a function of the update count."""
    spe = max(int(steps_per_epoch), 1)
    lr, gamma = float(lr), float(gamma)
    return lambda step: lr * gamma ** (int(step) // spe)


class AdamChain(torch.optim.Optimizer):
    """The JAX package's optimizer with its regularisers
    (`spnerf_tpu/train/loop.py` `make_optimizer`), the optax chain in its
    order:

      1. clip_by_global_norm(grad_clip) when grad_clip > 0: g if the global
         norm is below grad_clip, else g / norm * grad_clip;
      2. scale_by_adam (b1 0.9, b2 0.999, eps 1e-8 outside the square root,
         bias correction at the incremented count);
      3. the table's update times gamma^l per level, a (L, 1) multiplier
         broadcast against the table as numpy broadcasts it, when
         table_level_lr_decay != 1;
      4. + table_wd * param on the table;
      5. + weight_decay * param on every parameter;
      6. times -lr, the group's "lr" at the step.

    `named_params` is a list of (name, parameter); the table is the one
    named `table` (a leaf name, as the JAX package's mask reads it). A
    parameter without a gradient takes a zero gradient, as optax does."""

    def __init__(self, named_params, lr, n_levels=8, table_wd=0.0,
                 table_level_lr_decay=1.0, weight_decay=0.0, grad_clip=0.0,
                 betas=(0.9, 0.999), eps=1e-8):
        named_params = list(named_params)
        super().__init__([p for _, p in named_params], dict(lr=lr))
        tables = [p for name, p in named_params
                  if name.split(".")[-1] == "table"]
        self.table_ids = {id(p) for p in tables}
        self.grad_clip = float(grad_clip)
        self.table_wd = float(table_wd)
        self.weight_decay = float(weight_decay)
        self.betas, self.eps = betas, eps
        self.count = 0
        self.mult = None
        if table_level_lr_decay != 1.0:
            # gamma^l as the JAX package's `_scale_table_levels` builds it:
            # float64 powers cast to float32, shape (L, 1)
            powers = np.arange(n_levels, dtype=np.float64)
            self.mult = torch.from_numpy(
                (float(table_level_lr_decay) ** powers).astype(np.float32)
                [:, None])
            for p in tables:
                try:
                    shape = np.broadcast_shapes(tuple(p.shape),
                                                tuple(self.mult.shape))
                except ValueError:
                    shape = None
                if shape != tuple(p.shape):
                    raise ValueError(
                        f"table_level_lr_decay: the ({n_levels}, 1) level "
                        f"multiplier does not broadcast against the table "
                        f"{tuple(p.shape)} (the JAX package fails the same "
                        f"way on the (L, T, F) table)")

    @torch.no_grad()
    def step(self):
        params = [p for g in self.param_groups for p in g["params"]]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        if self.grad_clip > 0.0:
            norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
            grads = [torch.where(norm < self.grad_clip, g,
                                 g / norm * self.grad_clip) for g in grads]
        b1, b2 = self.betas
        self.count += 1
        bc1, bc2 = 1.0 - b1 ** self.count, 1.0 - b2 ** self.count
        grads = iter(grads)
        for group in self.param_groups:
            lr = group["lr"]
            for p, g in zip(group["params"], grads):
                st = self.state[p]
                if not st:
                    st["mu"] = torch.zeros_like(p)
                    st["nu"] = torch.zeros_like(p)
                mu, nu = st["mu"], st["nu"]
                mu.copy_((1.0 - b1) * g + b1 * mu)
                nu.copy_((1.0 - b2) * g * g + b2 * nu)
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
                if id(p) in self.table_ids:
                    if self.mult is not None:
                        u = u * self.mult.to(u.device)
                    if self.table_wd:
                        u = u + self.table_wd * p
                if self.weight_decay:
                    u = u + self.weight_decay * p
                p.add_(u, alpha=-lr)


def make_optimizer(named_params, lr_schedule, n_levels=8, table_wd=0.0,
                   table_level_lr_decay=1.0, weight_decay=0.0, grad_clip=0.0):
    """Adam with the JAX package's hyperparameters; with any of its
    regularisers set, the optax chain `AdamChain`. named_params: a list of
    (name, parameter)."""
    named_params = list(named_params)
    if (table_wd == 0.0 and table_level_lr_decay == 1.0
            and weight_decay == 0.0 and grad_clip == 0.0):
        return torch.optim.Adam([p for _, p in named_params],
                                lr=lr_schedule(0), betas=(0.9, 0.999),
                                eps=1e-8)
    return AdamChain(named_params, lr_schedule(0), n_levels=n_levels,
                     table_wd=table_wd,
                     table_level_lr_decay=table_level_lr_decay,
                     weight_decay=weight_decay, grad_clip=grad_clip)


@dataclass
class TrainState:
    """What a step updates: the step count, the field, the transient
    embedding (beta path) and the optimizer over both."""

    step: int
    model: nn.Module
    t_embed: Optional[nn.Module]
    optimizer: torch.optim.Optimizer


class Trainer:
    """Configs, learning-rate schedule and the train step of one field."""

    def __init__(self, mc: ModelConfig, rc: RenderConfig, lc: LossConfig,
                 lr=5e-4, lr_gamma=0.9, steps_per_epoch=1000,
                 max_steps=30000, ds_drop=0.25, ss_drop=1.0, noise_std=0.0,
                 t_vocab=30, mesh=None, table_wd=0.0,
                 table_level_lr_decay=1.0, weight_decay=0.0, grad_clip=0.0,
                 device=None):
        if mesh is not None:
            raise NotImplementedError("a device mesh is not ported (ROADMAP A12)")
        check_supported(rc)
        self.device = resolve_device(device)
        self.mc, self.rc, self.lc = mc, rc, lc
        self.steps_per_epoch = int(steps_per_epoch)
        self.max_steps = int(max_steps)
        self.ds_drop_step = float(round(ds_drop * max_steps))
        self.ss_drop_step = float(round(ss_drop * max_steps))
        self.noise_std0 = float(noise_std)
        self.beta_warmup_step = (int(getattr(lc, "first_beta_epoch", 2))
                                 * self.steps_per_epoch)
        self.t_vocab = t_vocab
        self.lr_schedule = make_lr_schedule(lr, steps_per_epoch, lr_gamma)
        self.opt_options = dict(table_wd=table_wd,
                                table_level_lr_decay=table_level_lr_decay,
                                weight_decay=weight_decay, grad_clip=grad_clip)

    # ------------------------------------------------------------------ init
    def init_state(self, generator=None) -> TrainState:
        """A fresh state: the field and transient embedding drawn from
        `generator` (a CPU torch.Generator), on the trainer's device."""
        model = load_model(self.mc, self.rc.compute_dtype, device=self.device,
                           generator=generator)
        t_embed = None
        if self.mc.beta:
            t_embed = TransientEmbedding(self.t_vocab, self.mc.t_embedding_dims,
                                         generator).to(self.device)
        params = list(model.named_parameters())
        if t_embed is not None:
            params += [(f"t_embed.{name}", p)
                       for name, p in t_embed.named_parameters()]
        return TrainState(step=0, model=model, t_embed=t_embed,
                          optimizer=make_optimizer(
                              params, self.lr_schedule,
                              n_levels=self.mc.hash_levels,
                              **self.opt_options))

    def to_device(self, data):
        """Scene arrays (numpy or tensors) as tensors on the device."""
        return {k: torch.as_tensor(v).to(self.device) for k, v in data.items()}

    # ------------------------------------------------------------ train step
    def anneal(self, step):
        """Per-level hash feature weights at `step` (coarse-to-fine over
        hash_anneal_steps, the two coarsest levels always on), or None."""
        if self.mc.encoding != "hash" or self.mc.hash_anneal_steps <= 0:
            return None
        L = self.mc.hash_levels
        keep = min(2, L)
        frac = torch.clamp_max(
            torch.tensor(float(step), device=self.device)
            / self.mc.hash_anneal_steps, 1.0)
        active = keep + (L - keep) * frac
        return torch.clamp(active - torch.arange(L, dtype=torch.float32,
                                                 device=self.device), 0.0, 1.0)

    def field_apply(self, model, anneal=None):
        """The renderer's field callable over `model`."""
        def apply(xyz, sun_d, t_emb, sem_labels, heads=None):
            if anneal is None:
                return model(xyz, sun_d, t_emb, sem_labels, heads=heads)
            return model(xyz, sun_d, t_emb, sem_labels, heads=heads,
                         anneal=anneal)
        return apply

    def loss_fn(self, state, batch, step, generator=None, draws=None):
        """The training objective on one batch: (total, dict of terms).
        generator or draws feed the renderer's random numbers (see
        `render_rays`); with neither the render is deterministic."""
        noise_std = self.noise_std0 * 0.9 ** step if self.noise_std0 else 0.0
        t_emb = None
        if state.t_embed is not None:
            t_emb = state.t_embed(batch["ids"])
        results = render_rays(
            self.field_apply(state.model, self.anneal(step)), self.rc,
            batch["rays"], t_emb=t_emb,
            sems=batch["sems"] if self.mc.sem else None, train=True,
            valid_depth=batch["valid_depth"], target_depths=batch["depths"],
            target_std=batch["depth_std"], noise_std=noise_std,
            generator=generator, draws=draws)
        total, loss_dict = losses.total_loss(
            results, batch, self.lc, step, self.ds_drop_step,
            self.ss_drop_step, use_beta_loss=step >= self.beta_warmup_step)
        mse = torch.mean((results["rgb_coarse"] - batch["rgbs"]) ** 2)
        loss_dict["psnr"] = -10.0 * torch.log10(mse)
        return total, loss_dict

    def step_generator(self, step, seed=0):
        """The generator of step `step` of a run seeded `seed`: its seed is
        a 32-bit hash of the pair (the CPU generator keeps 32 bits)."""
        g = torch.Generator(device=self.device)
        g.manual_seed(int(np.random.SeedSequence(
            [int(seed), int(step)]).generate_state(1)[0]))
        return g

    def sample_batch(self, data, batch_size, generator):
        """batch_size rays drawn with replacement from the scene `data`."""
        n = data["rays"].shape[0]
        idx = torch.randint(0, n, (batch_size,), generator=generator,
                            device=self.device)
        return {k: v[idx] for k, v in data.items()}

    def apply_gradients(self, state, loss):
        """Backward, then one optimizer update at the step's learning
        rate."""
        for group in state.optimizer.param_groups:
            group["lr"] = self.lr_schedule(state.step)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.step += 1

    def train_step(self, state, data, batch_size=1024, seed=0):
        """One step on a batch drawn from the device-resident scene `data`.
        Updates `state` in place; returns the step's loss terms, "loss" and
        "lr" (tensors on the device, except lr)."""
        step = state.step
        g = self.step_generator(step, seed)
        batch = self.sample_batch(data, batch_size, g)
        loss, loss_dict = self.loss_fn(state, batch, step, generator=g)
        self.apply_gradients(state, loss)
        loss_dict = {k: v.detach() for k, v in loss_dict.items()}
        loss_dict["loss"] = loss.detach()
        loss_dict["lr"] = self.lr_schedule(step)
        return loss_dict

    def train_steps(self, state, data, n, batch_size=1024, seed=0):
        """n steps in a loop; returns the last step's loss terms."""
        loss_dict = None
        for _ in range(int(n)):
            loss_dict = self.train_step(state, data, batch_size, seed)
        return loss_dict
