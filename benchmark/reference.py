"""The plain reference: the SP-NeRF field, its ray renderer, the flagship
losses and Adam in plain PyTorch float32 (TF32 off), written from the
configuration and independent of the program under test.

Precision follows the configuration's compute dtype as the SP-NeRF field
defines it: every matrix product takes operands rounded to the compute
dtype and sums in float32, the bias is added in float32, a layer's output
is carried rounded to the compute dtype, activations are evaluated in
float32 and rounded once. `Quant` does the rounding and passes gradients
through unchanged, so the backward pass is float32. The control computes
the same with the rounding one step lower (float8 e4m3 for bfloat16).

The training reference replays the port's per-step draws: a generator on
the run's device seeded by a 32-bit hash of (seed, step) (numpy's
SeedSequence), from which the batch's rows (randint) and the renderer's
stratified, predicted-depth and target-depth uniforms are drawn in turn.
"""

import math
from contextlib import contextmanager

import numpy as np
import torch

from . import flops

LOWER = {"bfloat16": "float8"}  # the step below the stated precision
INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


class Quant(torch.autograd.Function):
    """x rounded to a lower precision and back to float32; the gradient
    passes through."""

    @staticmethod
    def forward(ctx, x, precision):
        if precision == "bfloat16":
            return x.to(torch.bfloat16).float()
        # float8 e4m3: saturate at its largest finite value, 448
        return x.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).float()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def quantizer(precision):
    if precision == "float32":
        return lambda x: x
    return lambda x: Quant.apply(x, precision)


@contextmanager
def strict_float32():
    """Matrix products in full float32 (no TF32) for the block's duration."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class Field:
    """The SP-NeRF field over a dict of float32 weights by name."""

    def __init__(self, model, weights, precision):
        if model["beta"] or not model["siren"]:
            raise NotImplementedError("the reference covers the Siren field "
                                      "without the beta path")
        self.m = model
        self.w = weights
        self.q = quantizer(precision)

    def dense(self, name, x, x2=None):
        q = self.q
        if x2 is not None:
            x = torch.cat([x, q(x2)], dim=-1)
        y = q(x) @ q(self.w[f"{name}.kernel"]) + self.w[f"{name}.bias"]
        return q(y)

    def sin(self, x, w0=1.0):
        return self.q(torch.sin(self.q(w0 * x) if w0 != 1.0 else x))

    def trunk_input(self, xyz, sems):
        m = self.m
        parts = [xyz]
        if m["mapping"]:
            parts = []
            for k in range(m["mapping_sizes"][0]):
                parts += [torch.sin(2.0 ** k * xyz), torch.cos(2.0 ** k * xyz)]
        if m["sem"]:
            c = m["num_sem_classes"]
            labels = torch.where(sems < 0, c, sems).long()
            parts.append(self.w["sem_table"][labels])
        return torch.cat(parts, dim=-1)

    def __call__(self, xyz, sun, sems, heads=flops.ALL_HEADS):
        """Per-point outputs: sigma (N,), and by head rgb (N,3), sun_v (N,1),
        sky (N,3), sem_logits (N,C)."""
        m, q, sin = self.m, self.q, self.sin
        x_in = self.trunk_input(xyz, sems)
        h = sin(self.dense("trunk0", x_in), 30.0)
        for i in range(1, m["fc_layers"]):
            h = sin(self.dense(f"trunk{i}", h,
                               x_in if i in m["skips"] else None))
        out = {"sigma": q(torch.nn.functional.softplus(
            self.dense("sigma", h)))[:, 0]}
        feats = self.dense("feats", h) if {"rgb", "sun"} & set(heads) else None
        if "rgb" in heads:
            r = sin(self.dense("rgb0", feats))
            rgb = torch.sigmoid(self.dense("rgb1", r)) * 1.002 - 0.001
            out["rgb"] = q(rgb)
        if "sun" in heads:
            s = sin(self.dense("sun0", feats, sun))
            s = sin(self.dense("sun1", s))
            s = sin(self.dense("sun2", s))
            out["sun_v"] = q(torch.sigmoid(self.dense("sun3", s)))
        if "sky" in heads:
            k = torch.relu(self.dense("sky0", sun))
            out["sky"] = q(torch.sigmoid(self.dense("sky1", k)))
        if m["sem"] and "sem" in heads:
            g = sin(self.dense("sem0", h))
            out["sem_logits"] = self.dense("sem1", g)
        return out


# ------------------------------------------------------------------ sampling
def stratified(near, far, n, u=None):
    t = torch.linspace(0.0, 1.0, n, device=near.device)
    z = near * (1.0 - t) + far * t
    if u is not None:
        mid = 0.5 * (z[:, :-1] + z[:, 1:])
        upper = torch.cat([mid, z[:, -1:]], dim=-1)
        lower = torch.cat([z[:, :1], mid], dim=-1)
        z = lower + (upper - lower) * u
    return z


def sample_pdf(bins, weights, n, u=None, eps=1e-5):
    """Inverse-CDF samples of the histogram (bins (R, M+1), weights (R, M));
    evenly spaced quantiles where u is None."""
    r, m = weights.shape
    weights = weights + eps
    cdf = torch.cumsum(weights / weights.sum(-1, keepdim=True), dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
    if u is None:
        u = torch.linspace(0.0, 1.0, n, device=bins.device).expand(r, n)
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, 0, m)
    above = torch.clamp(inds, 0, m)
    c_lo, c_hi = cdf.gather(1, below), cdf.gather(1, above)
    b_lo, b_hi = bins.gather(1, below), bins.gather(1, above)
    denom = c_hi - c_lo
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return b_lo + (u - c_lo) / denom * (b_hi - b_lo)


def sample_3sigma(low, high, n, near, far, u=None):
    """Gaussian-shaped samples between per-ray bounds, clamped to
    [near, far]."""
    t = torch.linspace(0.0, 1.0, n, device=low.device)
    step = (high - low) / (n - 1)
    edges = low[:, None] * (1.0 - t) + high[:, None] * t
    edges = torch.minimum(torch.maximum(edges, near[:, None]), far[:, None])
    step = torch.where(step.abs() < 1e-12, torch.ones_like(step), step)
    factor = (edges[:, 1:] - edges[:, :-1]) / step[:, None]
    x = torch.linspace(-3.0, 3.0, n - 1, device=low.device)
    gauss = INV_SQRT_2PI * torch.exp(-0.5 * x ** 2)
    return sample_pdf(edges, factor * gauss, n, u=u)


def guided(depth, weights, z, n, near, far, u_pred=None, train=None):
    """Depth-guided samples: around the predicted depth's 3-sigma range,
    and in training, for rays with valid stereo depth, around the target's.
    train: None, or (valid, target depth, target std, u_gt)."""
    std = torch.sqrt(((z - depth[:, None]) ** 2 * weights).sum(-1))
    z_pred = sample_3sigma(depth - 3.0 * std, depth + 3.0 * std, n, near, far,
                           u=u_pred)
    if train is None:
        return z_pred
    valid, t_depth, t_std, u_gt = train
    valid = valid > 0
    mid = (0.5 * (near + far)).expand(depth.shape)
    d = torch.where(valid, t_depth, mid)
    s = torch.where(valid, t_std.clamp_min(1e-12), torch.ones_like(t_std))
    z_gt = sample_3sigma(d - 3.0 * s, d + 3.0 * s, n, near, far, u=u_gt)
    return torch.where(valid[:, None], z_gt, z_pred)


# -------------------------------------------------------------- compositing
def composite(f, z):
    """Volume compositing of per-sample outputs f (R, S, ...) at depths z."""
    sig = f["sigma"]
    deltas = z[:, 1:] - z[:, :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[:, :1], 1e10)], -1)
    alpha = 1.0 - torch.exp(-deltas * torch.relu(sig))
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                     1.0 - alpha + 1e-10], -1), -1)[:, :-1]
    w = alpha * trans
    out = {"weights": w, "transparency": trans,
           "depth": (w * z).sum(-1)}
    if "sun_v" in f:
        out["sun"] = f["sun_v"]
    if "rgb" in f:
        irr = f["sun_v"] + (1.0 - f["sun_v"]) * f["sky"]
        out["rgb"] = torch.clamp((w[..., None] * f["rgb"] * irr).sum(-2),
                                 0.0, 1.0)
        out["albedo"], out["sky"] = f["rgb"], f["sky"]
    if "sem_logits" in f:
        out["sem_logits"] = f["sem_logits"].mean(1)
    return out


def field_at(field, o, d, z, sun, sems, heads=flops.ALL_HEADS):
    """The field at o + d z for every (ray, sample): (R, S, ...) outputs."""
    r, s = z.shape
    xyz = (o[:, None] + d[:, None] * z[..., None]).reshape(-1, 3)
    out = field(xyz, sun[:, None].expand(r, s, 3).reshape(-1, 3),
                sems[:, None].expand(r, s).reshape(-1), heads)
    return {k: v.reshape((r, s) + v.shape[1:]) for k, v in out.items()}


def render(field, render_cfg, rays, sems, draws=None, train=None,
           solar=True):
    """The view pass (stratified samples, then guided samples merged in z
    order) and the solar pass. draws: None (eval: evenly spaced) or
    (strat, u_pred); train as `guided`'s. Returns (view composite, solar
    composite or None)."""
    n = render_cfg["n_samples"]
    o, d, sun = rays[:, 0:3], rays[:, 3:6], rays[:, 8:11]
    near, far = rays[:, 6:7], rays[:, 7:8]
    strat, u_pred = draws if draws is not None else (None, None)
    z = stratified(near, far, n, strat)
    f1 = field_at(field, o, d, z, sun, sems)
    c1 = composite(f1, z)
    if render_cfg["guidedsample"]:
        z2 = guided(c1["depth"], c1["weights"], z, n, near[:, 0], far[:, 0],
                    u_pred, train)
        z2 = torch.sort(z2, dim=-1).values.detach()
        z_all = torch.cat([z, z2], dim=-1)
        z, order = torch.sort(z_all, dim=-1, stable=True)
        f2 = field_at(field, o, d, z2, sun, sems)
        f = {}
        for k in f1:
            v = torch.cat([f1[k], f2[k]], dim=1)
            if k != "sem_logits":  # mean-pooled: its order does not matter
                idx = order if v.ndim == 2 else order[..., None].expand_as(v)
                v = v.gather(1, idx)
            f[k] = v
        c1 = composite(f, z)
    c1["z"] = z
    sc = None
    if solar and render_cfg["solar_correction"]:
        sc = composite(field_at(field, o, sun, z, sun, sems, flops.SUN_HEADS),
                       z)
    return c1, sc


def eval_outputs(field, render_cfg, rays, sems):
    """A view's per-ray outputs, as an eval render keeps them: rgb, depth,
    and sun, albedo and sky composited with the weights, and the
    mean-pooled semantic logits. The solar pass feeds none of them."""
    c, _ = render(field, render_cfg, rays, sems, solar=False)
    w = c["weights"][..., None]
    out = {"rgb": c["rgb"], "depth": c["depth"],
           "sun": (w * c["sun"]).sum(-2), "albedo": (w * c["albedo"]).sum(-2),
           "sky": (w * c["sky"]).sum(-2)}
    if "sem_logits" in c:
        out["sem_logits"] = c["sem_logits"]
    return out


@torch.no_grad()
def eval_rows(cfg, weights, rays, sems, precision, block=1024):
    """eval_outputs of every row, in blocks of `block` rays."""
    field = Field(cfg["model"], weights, precision)
    parts = []
    with strict_float32():
        for i in range(0, rays.shape[0], block):
            parts.append(eval_outputs(field, cfg["render"], rays[i:i + block],
                                      sems[i:i + block]))
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


# ------------------------------------------------------------------- losses
def loss(cfg, c, sc, batch):
    """The flagship objective: colour, the solar terms, depth supervision
    and semantics, each as the configuration's loss section weighs it."""
    lc, n = cfg["loss"], batch["rays"].shape[0]
    total = torch.mean((c["rgb"] - batch["rgbs"]) ** 2)
    if lc["sc_lambda"] > 0:
        sun_sc = sc["sun"][..., 0]
        t2 = ((sc["transparency"].detach() - sun_sc) ** 2).sum(-1)
        t3 = 1.0 - (sc["weights"].detach() * sun_sc).sum(-1)
        total = total + lc["sc_lambda"] / 3.0 * (t2.mean() + t3.mean())
    if lc["depth"] and lc["ds_lambda"] > 0:
        d, t_depth = c["depth"], batch["depths"][:, 0]
        t_w, t_std = batch["depths"][:, 1], batch["depth_std"]
        std = torch.sqrt(torch.clamp_min(
            ((c["z"] - d[:, None]) ** 2 * c["weights"]).sum(-1), 1e-12))
        off = ((d - t_depth).abs() > t_std) | (std > t_std)
        mask = ((batch["valid_depth"] > 0) & off).float()
        total = total + lc["ds_lambda"] / 3.0 * (
            t_w * (d - t_depth) ** 2 * mask).sum() / n
    if lc["sem"]:
        labels = batch["sems"].long()
        valid = (labels >= 0).float()
        logp = torch.log_softmax(c["sem_logits"], dim=-1)
        nll = -logp.gather(1, labels.clamp_min(0)[:, None])[:, 0]
        total = total + lc["ss_lambda"] * (nll * valid).sum() / \
            valid.sum().clamp_min(1.0)
    return total


# ----------------------------------------------------------------- training
def step_seed(seed, step):
    """The seed of step `step`'s generator: a 32-bit hash of (seed, step)."""
    return int(np.random.SeedSequence([int(seed), int(step)])
               .generate_state(1)[0])


def step_draws(scene, batch_size, n_samples, seed, step, device):
    """Step `step`'s batch of scene rows and its renderer draws (stratified,
    predicted-depth and target-depth uniforms), in the order drawn."""
    g = torch.Generator(device=device)
    g.manual_seed(step_seed(seed, step))
    n = scene["rays"].shape[0]
    idx = torch.randint(0, n, (batch_size,), generator=g, device=device)
    u = [torch.rand((batch_size, n_samples), generator=g, device=device,
                    dtype=torch.float32) for _ in range(3)]
    return {k: v[idx] for k, v in scene.items()}, u


def train(cfg, weights, scene, batch_size, seed, steps, precision,
          half_batch=False):
    """`steps` Adam steps from `weights` on the port's draws. Returns (the
    losses, the first step's gradients, the weights after the last step),
    the gradients and weights as float32 dicts by name. half_batch: each
    step's loss is the mean over the first half of its batch (a fault)."""
    device = scene["rays"].device
    tc, rc = cfg["train"], cfg["render"]
    b1, b2 = tc["adam_betas"]
    params = {k: v.detach().clone().requires_grad_() for k, v in
              weights.items()}
    mom = {k: torch.zeros_like(v) for k, v in params.items()}
    sq = {k: torch.zeros_like(v) for k, v in params.items()}
    field = Field(cfg["model"], params, precision)
    losses, grads0 = [], None
    with strict_float32():
        for step in range(steps):
            batch, (strat, u_pred, u_gt) = step_draws(
                scene, batch_size, rc["n_samples"], seed, step, device)
            if half_batch:
                h = batch_size // 2
                batch = {k: v[:h] for k, v in batch.items()}
                strat, u_pred, u_gt = strat[:h], u_pred[:h], u_gt[:h]
            c, sc = render(field, rc, batch["rays"], batch["sems"],
                           draws=(strat, u_pred),
                           train=(batch["valid_depth"], batch["depths"][:, 0],
                                  batch["depth_std"], u_gt))
            total = loss(cfg, c, sc, batch)
            grads = torch.autograd.grad(total, list(params.values()))
            losses.append(float(total.detach()))
            if step == 0:
                grads0 = {k: g.detach().clone() for k, g in zip(params, grads)}
            lr = tc["lr"] * tc["lr_gamma"] ** (step // tc["steps_per_epoch"])
            t = step + 1
            with torch.no_grad():
                for (k, p), g in zip(params.items(), grads):
                    mom[k].mul_(b1).add_(g, alpha=1.0 - b1)
                    sq[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                    denom = (sq[k].sqrt() / math.sqrt(1.0 - b2 ** t)).add_(
                        tc["adam_eps"])
                    p.addcdiv_(mom[k], denom, value=-lr / (1.0 - b1 ** t))
    return losses, grads0, {k: v.detach() for k, v in params.items()}
