"""The plain reference of the `hash` family: the multiresolution hash
encoding of Instant-NGP (Müller et al., SIGGRAPH 2022, arXiv:2201.05989)
under SP-NeRF's trunk, heads, renderer and losses, in plain PyTorch
float32 (TF32 off), written from the configuration and independent of the
program under test. The renderer, the losses, the control's precision and
the training draws are the Siren reference's (`reference.py`), which take
the field as a callable.

The encoding of a point x in [-1, 1]^3, at each level l of L:
- the level has res_l = floor(16 b^l) cells an axis, b = exp((ln 2048 -
  ln 16) / (L - 1)) (computed in float64);
- u = clamp((x + 1) / 2, 0, 1); the cell c = min(floor(u res_l), res_l - 1)
  an axis, and the fraction in it f = u res_l - c;
- the cell's 8 corners c + (i, j, k) index the level's table directly,
  ((c_x + i) side + c_y + j) side + c_z + k with side = res_l + 1, where
  side^3 <= T; else by the spatial hash, the XOR over the axes of
  (c_a + o_a) p_a mod 2^32 with p = (1, 2654435761, 805459861), mod T;
- the corners' F features are interpolated trilinearly, by seven lerps a
  (1 - t) + b t: along z, then y, then x;
- the levels' features are concatenated, level 0 first.
The field: the encoding and the semantic embedding concatenated, two ReLU
trunk layers, and the heads (sigma by softplus; albedo, sun visibility and
sky by sigmoids; semantic logits), each product's operands rounded to the
compute dtype with float32 sums, a layer's output carried rounded, as
`reference.Field` does.

Departures from Instant-NGP, as the configuration runs it:
- 8 levels of 4 features (the paper's 16 of 2: the same 32 features a
  point), from 16 to 2048 cells an axis;
- the table stored feature-major, level l's feature f of entry t at
  `table[l, f T + t]`: a directly indexed level uses the first
  2^ceil(log2 side^3) entries of each feature's row;
- SP-NeRF's heads over two 64-wide ReLU trunk layers (the paper's density
  MLP has one hidden layer and its colour MLP two), the semantic embedding
  concatenated to the encoding, and products in the configuration's
  precision (the paper's fully fused half-precision MLPs);
- the weights are the family's, drawn from the seed: the table uniform in
  +-TABLE_BOUND of `families/hash.py` (the paper's +-1e-4 would leave the
  outputs nearly blind to the encoding).
"""

import math

import numpy as np
import torch

from . import reference

LOWER = reference.LOWER  # the control's precision, by the stated one
PRIMES = (1, 2654435761, 805459861)  # the spatial hash's, one an axis
MASK32 = 0xFFFFFFFF
BASE_RES, FINEST_RES = 16, 2048
ALL_HEADS = ("rgb", "sun", "sky", "sem")
SUN_HEADS = ("sun",)  # the solar pass reads sigma and sun_v alone
CORNERS = [(i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1)]


def level_resolutions(n_levels):
    """Cells an axis of every level."""
    b = np.exp((np.log(FINEST_RES) - np.log(BASE_RES))
               / max(n_levels - 1, 1))
    return [int(r) for r in np.floor(BASE_RES * b ** np.arange(n_levels))]


def direct(model, res):
    """Whether a level of `res` cells an axis indexes its table directly."""
    return (bool(model["hash_direct_coarse"])
            and (res + 1) ** 3 <= 2 ** model["hash_log2T"])


def corner_ids(cell, res, model, primes=PRIMES):
    """(N, 3) int64 cells -> (N,) int64 table entry of each corner, in
    CORNERS order."""
    side, size = res + 1, 2 ** model["hash_log2T"]
    out = []
    for offset in CORNERS:
        x, y, z = (cell[:, a] + offset[a] for a in range(3))
        if direct(model, res):
            out.append((x * side + y) * side + z)
        else:
            h = ((x * primes[0]) & MASK32) ^ ((y * primes[1]) & MASK32) \
                ^ ((z * primes[2]) & MASK32)
            out.append(h % size)
    return out


def lerp(a, b, t):
    return a * (1.0 - t) + b * t


def encode(model, table, xyz):
    """(N, 3) points -> (N, L F) float32 features."""
    n_feat, size = model["hash_features"], 2 ** model["hash_log2T"]
    u = torch.clamp((xyz + 1.0) * 0.5, 0.0, 1.0)
    feats = []
    for level, res in enumerate(level_resolutions(model["hash_levels"])):
        s = u * res
        cell = torch.clamp_max(torch.floor(s), float(res - 1))
        f = s - cell
        rows = table[level].view(n_feat, size)
        v = dict(zip(CORNERS, (rows[:, ids] for ids in
                               corner_ids(cell.long(), res, model))))
        fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
        vy = {(i, j): lerp(v[i, j, 0], v[i, j, 1], fz)
              for i in (0, 1) for j in (0, 1)}
        vx = {i: lerp(vy[i, 0], vy[i, 1], fy) for i in (0, 1)}
        feats.append(lerp(vx[0], vx[1], fx).t())
    return torch.cat(feats, dim=-1)


def layer_specs(model):
    """(name, fan_in, out) of every dense layer, in the field's creation
    order: the port's `dense.<i>` is the i-th."""
    h = model["hash_hidden"]
    k0 = model["hash_levels"] * model["hash_features"]
    if model["sem"]:
        k0 += model["num_sem_classes"] * model["s_embedding_factor"]
    specs = [("trunk0", k0, h), ("trunk1", h, h), ("sigma", h, 1),
             ("feats", h, h), ("rgb0", h, h), ("rgb1", h, 3),
             ("sun0", h + 3, h), ("sun1", h, h), ("sun2", h, 1),
             ("sky0", 3, h), ("sky1", h, 3)]
    if model["sem"]:
        specs += [("sem0", h, h), ("sem1", h, model["num_sem_classes"])]
    return specs


def layers_run(model, heads):
    """Names of the dense layers a field call with `heads` evaluates."""
    names = ["trunk0", "trunk1", "sigma"]
    if {"rgb", "sun"} & set(heads):
        names.append("feats")
    if "rgb" in heads:
        names += ["rgb0", "rgb1"]
    if "sun" in heads:
        names += ["sun0", "sun1", "sun2"]
    if "sky" in heads:
        names += ["sky0", "sky1"]
    if model["sem"] and "sem" in heads:
        names += ["sem0", "sem1"]
    return names


def flops_per_point(model, heads=ALL_HEADS):
    """Matrix-product operations a point (2 per weight the call uses)."""
    widths = {n: (k, o) for n, k, o in layer_specs(model)}
    return sum(2 * widths[n][0] * widths[n][1]
               for n in layers_run(model, heads))


class Field:
    """The hash-grid SP-NeRF field over a dict of float32 weights by the
    port's names ("encoding.table" (L, F T), "dense.<i>.kernel" (fan_in,
    out), "dense.<i>.bias", "semantic_embedding")."""

    def __init__(self, model, weights, precision):
        if model["beta"] or model["encoding"] != "hash":
            raise NotImplementedError("the reference covers the hash field "
                                      "without the beta path")
        self.m, self.w = model, weights
        self.q = reference.quantizer(precision)
        self.index = {name: i for i, (name, _, _) in
                      enumerate(layer_specs(model))}

    def dense(self, name, x, x2=None):
        q, i = self.q, self.index[name]
        if x2 is not None:
            x = torch.cat([x, q(x2)], dim=-1)
        y = q(x) @ q(self.w[f"dense.{i}.kernel"]) + self.w[f"dense.{i}.bias"]
        return q(y)

    def __call__(self, xyz, sun, sems, heads=ALL_HEADS):
        """Per-point outputs: sigma (N,), and by head rgb (N, 3), sun_v
        (N, 1), sky (N, 3), sem_logits (N, C)."""
        m, q, relu = self.m, self.q, torch.relu
        x_in = encode(m, self.w["encoding.table"], xyz)
        if m["sem"]:
            c = m["num_sem_classes"]
            labels = torch.where(sems < 0, c, sems).long()
            x_in = torch.cat([x_in, self.w["semantic_embedding"][labels]],
                             dim=-1)
        h = relu(self.dense("trunk1", relu(self.dense("trunk0", x_in))))
        out = {"sigma": q(torch.nn.functional.softplus(
            self.dense("sigma", h)))[:, 0]}
        feats = self.dense("feats", h) if {"rgb", "sun"} & set(heads) else None
        if "rgb" in heads:
            r = relu(self.dense("rgb0", feats))
            rgb = torch.sigmoid(self.dense("rgb1", r)) * 1.002 - 0.001
            out["rgb"] = q(rgb)
        if "sun" in heads:
            s = relu(self.dense("sun0", feats, sun))
            s = relu(self.dense("sun1", s))
            out["sun_v"] = q(torch.sigmoid(self.dense("sun2", s)))
        if "sky" in heads:
            k = relu(self.dense("sky0", sun))
            out["sky"] = q(torch.sigmoid(self.dense("sky1", k)))
        if m["sem"] and "sem" in heads:
            g = relu(self.dense("sem0", h))
            out["sem_logits"] = self.dense("sem1", g)
        return out


@torch.no_grad()
def eval_rows(cfg, weights, rays, sems, precision, block=1024):
    """`reference.eval_outputs` of the hash field at every row, in blocks
    of `block` rays."""
    field = Field(cfg["model"], weights, precision)
    parts = []
    with reference.strict_float32():
        for i in range(0, rays.shape[0], block):
            parts.append(reference.eval_outputs(
                field, cfg["render"], rays[i:i + block], sems[i:i + block]))
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def train(cfg, weights, scene, batch_size, seed, steps, precision,
          half_batch=False):
    """`steps` plain Adam steps of the hash field from `weights` on the
    port's draws (`reference.step_draws`), through `reference.render` and
    `reference.loss`. Returns (the losses, the first step's gradients, the
    weights after the last step), the gradients and weights as float32
    dicts by name. half_batch: each step's loss is the mean over the first
    half of its batch (a fault)."""
    device = scene["rays"].device
    tc, rc = cfg["train"], cfg["render"]
    b1, b2 = tc["adam_betas"]
    params = {k: v.detach().clone().requires_grad_() for k, v in
              weights.items()}
    mom = {k: torch.zeros_like(v) for k, v in params.items()}
    sq = {k: torch.zeros_like(v) for k, v in params.items()}
    field = Field(cfg["model"], params, precision)
    losses, grads0 = [], None
    with reference.strict_float32():
        for step in range(steps):
            batch, (strat, u_pred, u_gt) = reference.step_draws(
                scene, batch_size, rc["n_samples"], seed, step, device)
            if half_batch:
                h = batch_size // 2
                batch = {k: v[:h] for k, v in batch.items()}
                strat, u_pred, u_gt = strat[:h], u_pred[:h], u_gt[:h]
            c, sc = reference.render(
                field, rc, batch["rays"], batch["sems"],
                draws=(strat, u_pred),
                train=(batch["valid_depth"], batch["depths"][:, 0],
                       batch["depth_std"], u_gt))
            total = reference.loss(cfg, c, sc, batch)
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
