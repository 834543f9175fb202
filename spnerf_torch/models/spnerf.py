"""The SP-NeRF field as a PyTorch module.

The same network as the JAX package's flax `SPNeRF`: a sinusoidal positional
mapping, a semantic-label embedding concatenated to it, a Siren trunk with a
skip connection, and heads for sigma, albedo, sun visibility, sky colour,
optional beta and optional semantic logits.

Numerics follow the flax module: matmul operands are rounded to the compute
dtype and accumulated in float32, the bias is added in float32, and the layer
output is carried in the compute dtype. Activations are evaluated in float32
and rounded once to the compute dtype.

Dense kernels keep the flax orientation `(fan_in, out)`, so `y = x @ kernel`;
the weight bridge (`spnerf_torch.convert`) therefore copies them unchanged.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a dtype or its name ("float32" | "bfloat16")."""
    return _DTYPES[dtype] if isinstance(dtype, str) else dtype


def positional_mapping(x, n_freqs, logscale=True):
    """x -> [sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...]; no identity
    term. Output width: x.shape[-1] * 2 * n_freqs."""
    if logscale:
        freqs = 2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)
    else:
        freqs = torch.linspace(1.0, 2.0 ** (n_freqs - 1), n_freqs,
                               dtype=x.dtype, device=x.device)
    parts = []
    for k in range(n_freqs):
        parts.append(torch.sin(freqs[k] * x))
        parts.append(torch.cos(freqs[k] * x))
    return torch.cat(parts, dim=-1)


def uniform_(t, bound, generator):
    """Fill `t` from U(-bound, bound) drawn with `generator`."""
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


# bounds of the three uniform inits, as functions of fan_in
INIT_BOUNDS = {
    "torch": lambda fan_in: 1.0 / math.sqrt(fan_in),  # torch.nn.Linear default
    "sine": lambda fan_in: math.sqrt(6.0 / fan_in),  # Siren trunk
    "first_sine": lambda fan_in: 1.0 / fan_in,  # Siren first layer
}


class TorchDense(nn.Module):
    """Dense layer: compute-dtype operands, float32 accumulation, float32
    bias, output cast to the compute dtype. `kernel` is (fan_in, out)."""

    def __init__(self, fan_in, features, kernel_init="torch",
                 compute_dtype=torch.float32, generator=None):
        super().__init__()
        self.compute_dtype = as_dtype(compute_dtype)
        self.kernel = nn.Parameter(torch.empty(fan_in, features))
        self.bias = nn.Parameter(torch.empty(features))
        uniform_(self.kernel, INIT_BOUNDS[kernel_init](fan_in), generator)
        uniform_(self.bias, INIT_BOUNDS["torch"](fan_in), generator)

    def forward(self, x, x2=None):
        """x2: optional second operand, `cat([x, x2], -1) @ kernel`."""
        cd = self.compute_dtype
        if x2 is not None:
            x = torch.cat([x, x2.to(x.dtype)], dim=-1)
        # a bf16 @ bf16 matmul would round its result to bf16; the products
        # of bf16 values are exact in float32, so this is float32 accumulation
        y = x.to(cd).float() @ self.kernel.to(cd).float()
        return (y + self.bias).to(cd)


_SIN_C1 = 0.9999966
_SIN_C3 = -0.16664824
_SIN_C5 = 0.00830629
_SIN_C7 = -0.00018363


def fast_sin(x):
    """sin(x) by range reduction to [-pi/2, pi/2] and a 7th-order odd
    polynomial (max error ~7e-7). torch.round rounds half to even."""
    k = torch.round(x * (1.0 / np.pi))
    r = x - k * np.pi
    sign = 1.0 - 2.0 * torch.abs(k - 2.0 * torch.floor(k * 0.5))
    r2 = r * r
    p = r * (_SIN_C1 + r2 * (_SIN_C3 + r2 * (_SIN_C5 + r2 * _SIN_C7)))
    return sign * p


def _fast_sin_grad(x):
    """d fast_sin / dx: the polynomial's derivative, sign-flipped by k."""
    k = torch.round(x * (1.0 / np.pi))
    r = x - k * np.pi
    sign = 1.0 - 2.0 * torch.abs(k - 2.0 * torch.floor(k * 0.5))
    r2 = r * r
    return sign * (_SIN_C1 + r2 * (3.0 * _SIN_C3 + r2 * (
        5.0 * _SIN_C5 + r2 * (7.0 * _SIN_C7))))


class _Siren(torch.autograd.Function):
    """fast_sin in float32 on a compute-dtype input, rounded back to it.
    Saves only the input for backward (autograd of the polynomial would
    keep seven float32 intermediates per activation)."""

    @staticmethod
    def forward(ctx, y):
        ctx.save_for_backward(y)
        return fast_sin(y.float()).to(y.dtype)

    @staticmethod
    def backward(ctx, grad):
        (y,) = ctx.saved_tensors
        return (grad.float() * _fast_sin_grad(y.float())).to(y.dtype)


def siren(x, w0=1.0):
    y = w0 * x if w0 != 1.0 else x
    return _Siren.apply(y)


def softplus(x):
    """log(1 + exp(x)) in the stable form of `jax.nn.softplus`."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def embed_lookup(table, labels):
    return table[labels]


def layer_specs(cfg: ModelConfig):
    """(name, input segment widths, output width, init) for every dense
    layer, in creation order: index i is flax's `TorchDense_i`. A layer with
    two segments consumes the concat of two operands (the skip, feats||sun,
    feats||t)."""
    w, h = cfg.fc_units, cfg.fc_units // 2
    k0 = in_width(cfg)
    first = "first_sine" if cfg.siren else "torch"
    trunk = "sine" if cfg.siren else "torch"
    specs = [("trunk0", (k0,), w, first)]
    for i in range(1, cfg.fc_layers):
        specs.append((f"trunk{i}", (w, k0) if i in cfg.skips else (w,), w,
                      trunk))
    specs += [("sigma", (w,), 1, "torch"), ("feats", (w,), w, "torch"),
              ("rgb0", (w,), h, "torch"), ("rgb1", (h,), 3, "torch"),
              ("sun0", (w, 3), h, first), ("sun1", (h,), h, trunk),
              ("sun2", (h,), h, trunk), ("sun3", (h,), 1, trunk),
              ("sky0", (3,), h, "torch"), ("sky1", (h,), 3, "torch")]
    if cfg.beta:
        specs += [("beta0", (w, cfg.t_embedding_dims), h, "torch"),
                  ("beta1", (h,), 1, "torch")]
    if cfg.sem:
        specs += [("sem0", (w,), h, "torch"),
                  ("sem1", (h,), cfg.num_sem_classes, "torch")]
    return specs


def in_width(cfg: ModelConfig):
    """Width of the trunk input: mapped position plus semantic embedding."""
    k0 = 3 * 2 * cfg.mapping_sizes[0] if cfg.mapping else 3
    if cfg.sem:
        k0 += cfg.num_sem_classes * cfg.s_embedding_factor
    return k0


def field_input(cfg: ModelConfig, xyz, sem_labels=None, sem_table=None):
    """The trunk input: positional mapping, then the semantic embedding of
    the labels (IGNORE and other negative labels take the zero pad row)."""
    x_in = positional_mapping(xyz, cfg.mapping_sizes[0]) if cfg.mapping else xyz
    if cfg.sem:
        labels = torch.where(sem_labels < 0, cfg.num_sem_classes, sem_labels)
        emb = embed_lookup(sem_table, labels.long())
        x_in = torch.cat([x_in, emb.to(x_in.dtype)], dim=-1)
    return x_in


class SPNeRF(nn.Module):
    """The SP-NeRF radiance and semantics field.

    forward(xyz, sun_d, t_emb, sem_labels) -> dict with rgb (N,3),
    sigma (N,), sun_v (N,1), sky (N,3), and beta (N,1) and sem_logits (N,C)
    where configured. sem_labels are ints in [0, C) or IGNORE (-100).
    """

    def __init__(self, cfg: ModelConfig, compute_dtype=torch.float32,
                 generator=None):
        super().__init__()
        if cfg.encoding != "siren":
            raise NotImplementedError(f"encoding {cfg.encoding!r}")
        self.cfg = cfg
        self.compute_dtype = as_dtype(compute_dtype)
        specs = layer_specs(cfg)
        self.index = {spec[0]: i for i, spec in enumerate(specs)}
        self.dense = nn.ModuleList(
            TorchDense(sum(segs), out, init, self.compute_dtype, generator)
            for _, segs, out, init in specs)
        if cfg.sem:
            table = torch.empty(cfg.num_sem_classes + 1,
                                cfg.num_sem_classes * cfg.s_embedding_factor)
            with torch.no_grad():
                table.normal_(generator=generator)
                table[cfg.num_sem_classes] = 0.0  # padding row for IGNORE
            self.semantic_embedding = nn.Parameter(table)
        else:
            self.semantic_embedding = None

    def layer(self, name):
        return self.dense[self.index[name]]

    def forward(self, xyz, sun_d, t_emb=None, sem_labels=None,
                sigma_only=False, heads=None, solar_tail=0):
        """heads: optional subset of ("rgb", "sun", "sky", "beta", "sem");
        sigma is always computed. solar_tail (batched solar pass) is not
        ported."""
        if solar_tail:
            raise NotImplementedError(
                "solar_tail (the batched solar pass) is not ported")
        cfg = self.cfg
        act = siren if cfg.siren else F.relu
        if heads is None:
            heads = ("rgb", "sun", "sky", "beta", "sem")
        L = self.layer

        x_in = field_input(cfg, xyz, sem_labels, self.semantic_embedding)
        h = L("trunk0")(x_in)
        h = siren(h, 30.0) if cfg.siren else act(h)
        for i in range(1, cfg.fc_layers):
            h = act(L(f"trunk{i}")(h, x_in if i in cfg.skips else None))
        shared = h

        out = {"sigma": softplus(L("sigma")(shared).float())
               .to(shared.dtype)[..., 0]}
        if sigma_only:
            return out
        feats = None
        if {"rgb", "sun", "beta"} & set(heads):
            feats = L("feats")(shared)
        if "rgb" in heads:
            r = act(L("rgb0")(feats))
            out["rgb"] = (torch.sigmoid(L("rgb1")(r).float()) * 1.002
                          - 0.001).to(r.dtype)
        if "sun" in heads:
            s = act(L("sun0")(feats, sun_d))
            s = act(L("sun1")(s))
            s = act(L("sun2")(s))
            out["sun_v"] = torch.sigmoid(L("sun3")(s))
        if "sky" in heads:
            k = F.relu(L("sky0")(sun_d))
            out["sky"] = torch.sigmoid(L("sky1")(k))
        if cfg.beta and "beta" in heads:
            b = act(L("beta0")(feats, t_emb))
            out["beta"] = softplus(L("beta1")(b).float()).to(b.dtype)
        if cfg.sem and "sem" in heads:
            g = act(L("sem0")(shared))
            out["sem_logits"] = L("sem1")(g)
        return out


class TransientEmbedding(nn.Module):
    """Per-image transient embedding of the beta path."""

    def __init__(self, vocab, dims, generator=None):
        super().__init__()
        table = torch.empty(vocab, dims)
        with torch.no_grad():
            table.normal_(generator=generator)
        self.embedding = nn.Parameter(table)

    def forward(self, ts):
        return embed_lookup(self.embedding, ts.long())


def init_spnerf(generator, cfg: ModelConfig, compute_dtype=torch.float32,
                device=None):
    """A freshly initialised field, drawn from `generator` (a CPU
    `torch.Generator`) and then moved to `device`."""
    from ..device import resolve_device

    device = resolve_device(device)
    return SPNeRF(cfg, compute_dtype, generator).to(device)
