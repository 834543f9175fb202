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

With `n_importance > 0` a second field of the same configuration renders
the fine pass; with `proposal` a `ProposalField` places the main samples
and the loss adds `prop_lambda` times the interlevel loss; with `occ_grid`
the occupancy grid places the coarse samples and, after each optimizer
step, one slab of it is refreshed from the new coarse parameters.

With a mesh (`parallel.data_mesh`), as the JAX package's step under
`shard_map`: each rank holds a replica of the state (`replicate_state`)
and a contiguous block of the rays (`shard_data`), draws its
`batch_size // world` rays and its render draws from a generator of its
own (rank 0 keeps the no-mesh generator, so a mesh of one rank is a run
without one, bit for bit), and the gradients and the loss terms are
averaged over the ranks with one all-reduce before the optimizer (and so
before its clipping and decays). The grid refresh takes rank 0's jitter on
every rank, as the JAX package does not fold the device into its key: the
replicas stay equal, bit for bit.
"""

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..config import LossConfig, ModelConfig, RenderConfig
from ..device import resolve_device
from ..models import TransientEmbedding, load_model
from ..models.proposal import ProposalField
from ..ops.occgrid import init_grid, slab_rows, update_grid
from ..ops.proposal import interlevel_loss
from ..ops.render import render_rays
from ..parallel import local_batch
from ..spans import span
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

    def state_dict(self):
        """The moments by parameter, the groups, and the update count."""
        return {**super().state_dict(), "count": self.count}

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        count = int(state_dict.pop("count"))
        super().load_state_dict(state_dict)
        self.count = count

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


def scene_to_device_arrays(scene):
    """The dict of host arrays a step reads, from a loaded scene
    (`data.dataset.SatelliteScene`); `Trainer.to_device` places it."""
    return {
        "rays": scene.rays,
        "rgbs": scene.rgbs,
        "ids": scene.ids.astype(np.int32),
        "depths": scene.depths,
        "valid_depth": scene.valid_depth,
        "depth_std": scene.depth_std,
        "sems": scene.sems.astype(np.int32),
    }


@dataclass
class TrainState:
    """What a step updates: the step count, the field, the transient
    embedding (beta path), the optimizer over every module, and the fine
    field, the proposal field and the occupancy grid where configured."""

    step: int
    model: nn.Module
    t_embed: Optional[nn.Module]
    optimizer: torch.optim.Optimizer
    fine: Optional[nn.Module] = None
    proposal: Optional[nn.Module] = None
    occ: Optional[torch.Tensor] = None

    def modules(self):
        """(prefix, module) of every trained module, in the optimizer's
        order: the field, the fine field, the transient embedding, the
        proposal field."""
        return [(p, m) for p, m in (("", self.model), ("fine.", self.fine),
                                    ("t_embed.", self.t_embed),
                                    ("proposal.", self.proposal))
                if m is not None]

    def named_parameters(self):
        """(name, parameter) of every trained module, in the optimizer's
        order, the field's without a prefix."""
        return [(p + name, param) for p, m in self.modules()
                for name, param in m.named_parameters()]


class Trainer:
    """Configs, learning-rate schedule and the train step of one field."""

    def __init__(self, mc: ModelConfig, rc: RenderConfig, lc: LossConfig,
                 lr=5e-4, lr_gamma=0.9, steps_per_epoch=1000,
                 max_steps=30000, ds_drop=0.25, ss_drop=1.0, noise_std=0.0,
                 t_vocab=30, mesh=None, table_wd=0.0,
                 table_level_lr_decay=1.0, weight_decay=0.0, grad_clip=0.0,
                 occ_rows=4096, occ_decay=0.8, device=None):
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"Trainer: device {device} is not the "
                                 f"mesh's {mesh.device}")
            device = mesh.device
        self.mesh = mesh
        self.device = resolve_device(device)
        self._flat_grads = None  # (parameter ids, buffer, views)
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
        # the grid refreshes `occ_rows` cells a step, snapped down to a
        # divisor of the cell count so that the slabs tile the grid
        self.occ_rows = self.occ_decay = None
        if rc.occ_grid:
            self.occ_rows = slab_rows(rc.occ_res, occ_rows, rc.occ_frames)
            self.occ_decay = float(occ_decay)

    # ------------------------------------------------------------------ init
    def init_state(self, generator=None) -> TrainState:
        """A fresh state on the trainer's device: the field, the fine
        field, the transient embedding and the proposal field drawn from
        `generator` (a CPU torch.Generator) in that order, the JAX
        package's, and an all-ones occupancy grid."""
        new_field = lambda: load_model(self.mc, self.rc.compute_dtype,
                                       device=self.device,
                                       generator=generator)
        model = new_field()
        fine = new_field() if self.rc.n_importance > 0 else None
        t_embed = None
        if self.mc.beta:
            t_embed = TransientEmbedding(self.t_vocab, self.mc.t_embedding_dims,
                                         generator).to(self.device)
        proposal = None
        if self.rc.proposal:
            proposal = ProposalField(generator=generator).to(self.device)
        occ = None
        if self.rc.occ_grid:
            occ = init_grid(self.rc.occ_res, self.rc.occ_frames, self.device)
        state = TrainState(step=0, model=model, t_embed=t_embed,
                           optimizer=None, fine=fine, proposal=proposal,
                           occ=occ)
        state.optimizer = make_optimizer(state.named_parameters(),
                                         self.lr_schedule,
                                         n_levels=self.mc.hash_levels,
                                         **self.opt_options)
        return state

    def to_device(self, data):
        """Scene arrays (numpy or tensors) as tensors on the device."""
        return {k: torch.as_tensor(v).to(self.device) for k, v in data.items()}

    def shard_data(self, data):
        """This rank's block of the scene arrays on its device: N padded
        to a multiple of the world size by wrapping, then cut into
        contiguous blocks, rank r the r-th, as the JAX package shards its
        rays over the mesh. Without a mesh, `to_device`."""
        if self.mesh is None:
            return self.to_device(data)
        world, rank = self.mesh.world, self.mesh.rank
        n = len(data["rays"])
        per = -(-n // world)
        idx = np.arange(rank * per, (rank + 1) * per) % n
        return self.to_device({k: np.asarray(v)[idx] for k, v in data.items()})

    @torch.no_grad()
    def replicate_state(self, state):
        """Rank 0's state on every rank (parameters, optimizer state, grid
        and step count), in place; the state itself without a mesh."""
        mesh = self.mesh
        if mesh is None:
            return state
        for _, module in state.modules():
            for t in list(module.parameters()) + list(module.buffers()):
                mesh.broadcast_(t.data)
        for st in state.optimizer.state.values():
            for v in st.values():
                if torch.is_tensor(v):
                    mesh.broadcast_(v)
        if state.occ is not None:
            mesh.broadcast_(state.occ)
        counts = torch.tensor([state.step,
                               getattr(state.optimizer, "count", 0)],
                              dtype=torch.int64, device=mesh.device)
        mesh.broadcast_(counts)
        state.step = int(counts[0])
        if hasattr(state.optimizer, "count"):
            state.optimizer.count = int(counts[1])
        return state

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
        """The renderer's field callable over `model`; it takes the
        solar-pass rows as a `solar_tail` (SPNERF_BATCH_SOLAR)."""
        kw = {} if anneal is None else {"anneal": anneal}

        def apply(xyz, sun_d, t_emb, sem_labels, heads=None, solar_tail=0):
            return model(xyz, sun_d, t_emb, sem_labels, heads=heads,
                         solar_tail=solar_tail, **kw)

        apply.supports_solar_tail = True
        return apply

    def loss_fn(self, state, batch, step, generator=None, draws=None):
        """The training objective on one batch: (total, dict of terms).
        generator or draws feed the renderer's random numbers (see
        `render_rays`); with neither the render is deterministic."""
        noise_std = self.noise_std0 * 0.9 ** step if self.noise_std0 else 0.0
        t_emb = None
        if state.t_embed is not None:
            t_emb = state.t_embed(batch["ids"])
        anneal = self.anneal(step)
        results = render_rays(
            self.field_apply(state.model, anneal), self.rc,
            batch["rays"], t_emb=t_emb,
            sems=batch["sems"] if self.mc.sem else None, train=True,
            valid_depth=batch["valid_depth"], target_depths=batch["depths"],
            target_std=batch["depth_std"], noise_std=noise_std,
            generator=generator, draws=draws,
            fine_field_apply=(None if state.fine is None
                              else self.field_apply(state.fine, anneal)),
            proposal_apply=state.proposal, occ=state.occ)
        total, loss_dict = losses.total_loss(
            results, batch, self.lc, step, self.ds_drop_step,
            self.ss_drop_step, use_beta_loss=step >= self.beta_warmup_step)
        if "w_prop_coarse" in results:
            prop = self.lc.prop_lambda * interlevel_loss(
                results["z_prop_coarse"], results["w_prop_coarse"],
                results["z_vals_coarse"], results["weights_coarse"])
            total = total + prop
            loss_dict["coarse_prop"] = prop
        typ = "fine" if "rgb_fine" in results else "coarse"
        mse = torch.mean((results[f"rgb_{typ}"] - batch["rgbs"]) ** 2)
        loss_dict["psnr"] = -10.0 * torch.log10(mse)
        return total, loss_dict

    def sigma_fn(self, model, anneal=None):
        """The field's density at (M, 3) points, as the grid refresh reads
        it: no sun, no transient embedding, IGNORE labels, `anneal`."""
        def fn(xyz):
            m = xyz.shape[0]
            sem = (torch.full((m,), -100, dtype=torch.long,
                              device=xyz.device) if self.mc.sem else None)
            kw = {} if anneal is None else {"anneal": anneal}
            return model(xyz, torch.zeros_like(xyz), None, sem,
                         sigma_only=True, **kw)["sigma"]
        return fn

    def refresh_grid(self, state, step, u):
        """One slab of the occupancy grid refreshed in place from the
        current coarse field, under step `step`'s anneal; u: (rows, 3)
        uniform jitter."""
        update_grid(state.occ, self.sigma_fn(state.model, self.anneal(step)),
                    u, step, self.rc.occ_res, self.occ_rows, self.occ_decay,
                    frames=self.rc.occ_frames)

    def step_generator(self, step, seed=0, rank=0):
        """The generator of step `step` of a run seeded `seed` on rank
        `rank`: its seed is a 32-bit hash of (seed, step), and of (seed,
        step, rank) on a rank r > 0 (the CPU generator keeps 32 bits)."""
        entropy = [int(seed), int(step)] + ([int(rank)] if rank else [])
        g = torch.Generator(device=self.device)
        g.manual_seed(int(np.random.SeedSequence(entropy).generate_state(1)[0]))
        return g

    def sample_batch(self, data, batch_size, generator):
        """batch_size rays drawn with replacement from the scene `data`."""
        n = data["rays"].shape[0]
        idx = torch.randint(0, n, (batch_size,), generator=generator,
                            device=self.device)
        return {k: v[idx] for k, v in data.items()}

    def apply_gradients(self, state, loss):
        """Backward, the gradients averaged over the mesh's ranks, then one
        optimizer update at the step's learning rate."""
        with span("train.backward"):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
        if self.mesh is not None:
            self.average_gradients(state)
        with span("train.optimizer"):
            for group in state.optimizer.param_groups:
                group["lr"] = self.lr_schedule(state.step)
            state.optimizer.step()
        state.step += 1

    def average_gradients(self, state):
        """Every gradient averaged over the ranks by one all-reduce of a
        flat buffer, made once and kept; each gradient is then a view of
        it. A parameter without a gradient keeps none (its place in the
        buffer is zero)."""
        params = [p for _, p in state.named_parameters()]
        ids = [id(p) for p in params]
        if self._flat_grads is None or self._flat_grads[0] != ids:
            flat = torch.empty(sum(p.numel() for p in params),
                               dtype=torch.float32, device=self.device)
            views = list(torch.split(flat, [p.numel() for p in params]))
            self._flat_grads = (ids, flat, views)
        _, flat, views = self._flat_grads
        for p, v in zip(params, views):
            if p.grad is None:
                v.zero_()
            else:
                v.copy_(p.grad.reshape(-1))
        self.mesh.all_reduce_(flat, mean=True)
        for p, v in zip(params, views):
            if p.grad is not None:
                p.grad = v.view_as(p)

    def train_step(self, state, data, batch_size=1024, seed=0, draws=None):
        """One step on `batch_size` rays (over all ranks) drawn from the
        device-resident scene `data` (this rank's block under a mesh), then
        the grid refresh with the new parameters, its jitter from the same
        generator (rank 0's on every rank). Updates `state` in place;
        returns the step's loss terms, "loss" and "lr" (tensors on the
        device, except lr), averaged over the ranks.

        draws: the step's random numbers by name instead of the generator
        (a test hands in another package's): "idx" the batch's rows of
        `data`, "occ_u" (occ_rows, 3) the grid's jitter, the rest the
        renderer's (see `render_rays`)."""
        step, mesh = state.step, self.mesh
        if mesh is not None:
            batch_size = local_batch(batch_size, mesh)
        if draws is None:
            g = self.step_generator(step, seed,
                                    0 if mesh is None else mesh.rank)
            batch = self.sample_batch(data, batch_size, g)
        else:
            g = None
            idx = torch.as_tensor(draws["idx"], device=self.device).long()
            batch = {k: v[idx] for k, v in data.items()}
        with span("train.forward"):
            loss, loss_dict = self.loss_fn(state, batch, step, generator=g,
                                           draws=draws)
        self.apply_gradients(state, loss)
        loss_dict = {k: v.detach() for k, v in dict(loss_dict,
                                                     loss=loss).items()}
        if mesh is not None:
            names = sorted(loss_dict)
            terms = torch.stack([loss_dict[k].float() for k in names])
            loss_dict = dict(zip(names, mesh.all_reduce_(terms, mean=True)))
        if state.occ is not None:
            if draws is None:
                u = torch.rand((self.occ_rows, 3), generator=g,
                               device=self.device)
            else:
                u = torch.as_tensor(draws["occ_u"], device=self.device)
            if mesh is not None:
                mesh.broadcast_(u)
            self.refresh_grid(state, step, u)
        loss_dict["lr"] = self.lr_schedule(step)
        return loss_dict

    def train_steps(self, state, data, n, batch_size=1024, seed=0):
        """n steps in a loop; returns the last step's loss terms."""
        loss_dict = None
        for _ in range(int(n)):
            loss_dict = self.train_step(state, data, batch_size, seed)
        return loss_dict
