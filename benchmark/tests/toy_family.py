"""A toy model family for the benchmark's tests: a plain ReLU MLP field
with no Siren and no semantic head, its own weights, a program of torch
modules (`torch.nn.Linear`, `torch.optim.Adam`) and its own functional
reference with a hand-written Adam. `test_benchmark_families.py` copies
this file to `families/toy.py` of a benchmark tree: a second family is new
files only.

The field maps a point to (sigma, rgb); a ray takes `n_samples` points
evenly spaced between its near and far and composites them. Training fits
the scene's colours by their mean squared error, on rows both sides draw
from the same generator of (seed, step).
"""

import torch

from benchmark import traffic

LOWER = {"float32": "bfloat16"}  # the control's precision, by the stated one
STEPS = 1000  # purposes of the step generators: STEPS + step


def widths(model):
    """(fan_in, out) of each dense layer, first to last."""
    w, h = 3, model["width"]
    return [(w, h)] + [(h, h)] * model["hidden_layers"] + [(h, 4)]


def make_weights(model, seed, device):
    """Float32 weights by name ("dense<i>.kernel" (fan_in, out) and
    "dense<i>.bias"), uniform within torch's default bound."""
    g = traffic.generator(seed, traffic.WEIGHTS, device)
    out = {}
    for i, (fan_in, n) in enumerate(widths(model)):
        bound = fan_in ** -0.5
        for name, shape in (("kernel", (fan_in, n)), ("bias", (n,))):
            u = torch.rand(shape, generator=g, device=device)
            out[f"dense{i}.{name}"] = u.mul_(2.0 * bound).sub_(bound)
    return out


def label_classes(model):
    """One class: the field reads no labels."""
    return 1


def sample_depths(rays, n):
    """(R, n) depths evenly spaced inside each ray's [near, far]."""
    t = (torch.arange(n, device=rays.device, dtype=torch.float32) + 0.5) / n
    return rays[:, 6:7] + (rays[:, 7:8] - rays[:, 6:7]) * t


def rows(scene, batch_size, seed, step):
    g = traffic.generator(seed, STEPS + step, scene["rays"].device)
    n = scene["rays"].shape[0]
    return torch.randint(0, n, (batch_size,), generator=g,
                         device=scene["rays"].device)


def flops_per_point(model):
    return sum(2 * a * b for a, b in widths(model))


def train_flops_per_ray(cfg):
    return 3 * cfg["render"]["n_samples"] * flops_per_point(cfg["model"])


def render_flops_per_ray(cfg):
    return cfg["render"]["n_samples"] * flops_per_point(cfg["model"])


# ----------------------------------------------------------------- program
class ToyField(torch.nn.Module):
    def __init__(self, model, weights):
        super().__init__()
        layers = []
        for i, (fan_in, n) in enumerate(widths(model)):
            lin = torch.nn.Linear(fan_in, n)
            with torch.no_grad():
                lin.weight.copy_(weights[f"dense{i}.kernel"].T)
                lin.bias.copy_(weights[f"dense{i}.bias"])
            layers += [lin, torch.nn.ReLU()]
        self.mlp = torch.nn.Sequential(*layers[:-1])

    def forward(self, xyz):
        return self.mlp(xyz)


def program_render(field, rays, n):
    z = sample_depths(rays, n)
    xyz = rays[:, None, 0:3] + rays[:, None, 3:6] * z[..., None]
    raw = field(xyz.reshape(-1, 3)).reshape(z.shape + (4,))
    sigma = torch.nn.functional.softplus(raw[..., 0])
    delta = (rays[:, 7:8] - rays[:, 6:7]) / n
    alpha = 1.0 - torch.exp(-sigma * delta)
    trans = torch.cumprod(torch.cat(
        [torch.ones_like(alpha[:, :1]), 1.0 - alpha[:, :-1]], -1), -1)
    w = alpha * trans
    return {"rgb": (w[..., None] * torch.sigmoid(raw[..., 1:])).sum(1),
            "depth": (w * z).sum(1)}


def _names(field):
    """The field's parameter names -> the weights' names."""
    out = {}
    for i, k in enumerate(range(0, len(field.mlp), 2)):
        out[f"mlp.{k}.weight"] = f"dense{i}.kernel"
        out[f"mlp.{k}.bias"] = f"dense{i}.bias"
    return out


class TrainProgram:
    def __init__(self, cfg, weights, scene, device):
        tc = cfg["train"]
        self.field = ToyField(cfg["model"], weights).to(device)
        self.opt = torch.optim.Adam(self.field.parameters(), lr=tc["lr"],
                                    betas=tuple(tc["adam_betas"]),
                                    eps=tc["adam_eps"])
        self.scene, self.n = scene, cfg["render"]["n_samples"]
        self.steps, self.grads0 = 0, None

    def _ours(self, tensors):
        names = _names(self.field)
        return {names[k]: v.T.clone() if k.endswith("weight") else v.clone()
                for k, v in tensors.items()}

    def step(self, batch_size, seed):
        idx = rows(self.scene, batch_size, seed, self.steps)
        out = program_render(self.field, self.scene["rays"][idx], self.n)
        loss = ((out["rgb"] - self.scene["rgbs"][idx]) ** 2).mean()
        self.opt.zero_grad()
        loss.backward()
        if self.steps == 0:
            self.grads0 = self._ours({k: p.grad for k, p in
                                      self.field.named_parameters()})
        self.opt.step()
        self.steps += 1
        return loss.detach()

    def params(self):
        return self._ours({k: p.detach() for k, p in
                           self.field.named_parameters()})

    def first_gradients(self):
        return self.grads0


class RenderProgram:
    def __init__(self, cfg, weights, device):
        self.field = ToyField(cfg["model"], weights).to(device)
        self.n = cfg["render"]["n_samples"]

    @torch.no_grad()
    def view(self, rays, sems):
        return {k: v.cpu() for k, v in
                program_render(self.field, rays, self.n).items()}


# --------------------------------------------------------------- reference
def reference_outputs(model, weights, rays, n, precision):
    """The field and compositing written out, sample by sample."""
    q = ((lambda x: x.to(torch.bfloat16).float()) if precision == "bfloat16"
         else (lambda x: x))
    z = sample_depths(rays, n)
    delta = (rays[:, 7] - rays[:, 6]) / n
    rgb = torch.zeros(rays.shape[0], 3, device=rays.device)
    depth = torch.zeros(rays.shape[0], device=rays.device)
    trans = torch.ones(rays.shape[0], device=rays.device)
    last = len(widths(model)) - 1
    for s in range(n):
        h = rays[:, 0:3] + rays[:, 3:6] * z[:, s:s + 1]
        for i in range(last + 1):
            k, bias = weights[f"dense{i}.kernel"], weights[f"dense{i}.bias"]
            h = q(h) @ q(k) + bias
            if i < last:
                h = torch.clamp_min(h, 0.0)
        alpha = 1.0 - torch.exp(-torch.log1p(torch.exp(h[:, 0])) * delta)
        w = alpha * trans
        rgb = rgb + w[:, None] / (1.0 + torch.exp(-h[:, 1:]))
        depth = depth + w * z[:, s]
        trans = trans * (1.0 - alpha)
    return {"rgb": rgb, "depth": depth}


@torch.no_grad()
def reference_eval_rows(cfg, weights, rays, sems, precision, block=1024):
    parts = [reference_outputs(cfg["model"], weights, rays[i:i + block],
                               cfg["render"]["n_samples"], precision)
             for i in range(0, rays.shape[0], block)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def reference_train(cfg, weights, scene, batch_size, seed, steps, precision,
                    half_batch=False):
    """(losses, the first step's gradients, the weights after the steps)."""
    tc = cfg["train"]
    b1, b2 = tc["adam_betas"]
    params = {k: v.detach().clone().requires_grad_() for k, v in
              weights.items()}
    mom = {k: torch.zeros_like(v) for k, v in params.items()}
    sq = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, grads0 = [], None
    for step in range(steps):
        idx = rows(scene, batch_size, seed, step)
        if half_batch:
            idx = idx[:batch_size // 2]
        out = reference_outputs(cfg["model"], params, scene["rays"][idx],
                                cfg["render"]["n_samples"], precision)
        loss = ((out["rgb"] - scene["rgbs"][idx]) ** 2).mean()
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        if step == 0:
            grads0 = {k: g.clone() for k, g in zip(params, grads)}
        t = step + 1
        with torch.no_grad():
            for (k, p), g in zip(params.items(), grads):
                mom[k] = b1 * mom[k] + (1.0 - b1) * g
                sq[k] = b2 * sq[k] + (1.0 - b2) * g * g
                m_hat = mom[k] / (1.0 - b1 ** t)
                v_hat = sq[k] / (1.0 - b2 ** t)
                p -= tc["lr"] * m_hat / (v_hat.sqrt() + tc["adam_eps"])
    return losses, grads0, {k: v.detach() for k, v in params.items()}
