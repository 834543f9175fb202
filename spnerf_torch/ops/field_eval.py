"""Fused forward of the SP-NeRF field: the CUDA kernel, its plain version,
and the wrapper that chooses between them by the device of its input.

The kernel (`csrc/field_eval.cu`) replaces the JAX package's Pallas field
kernel (`spnerf_tpu/ops/pallas/field_eval.py`, `_make_kernel` and
`_fused_apply`). It evaluates the Siren trunk with its skip and any subset of
the heads on a tile of points with the activations in shared memory; only
the inputs and the head outputs touch device memory.

Numerics, as in the Pallas kernel: every matmul takes bf16 operands (the
activation and the weight, both rounded from float32) and accumulates in
float32; bias, pre-activations and head epilogues are float32. Since every
use of an activation is a matmul operand, the kernel keeps activations in
bf16 and is faithful to that policy.

On a CUDA tensor the wrapper launches the kernel; on a CPU tensor it runs the
plain version, `fused_field_plain`, which repeats the kernel's arithmetic
with PyTorch ops.
"""

import ctypes
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..models.spnerf import (as_dtype, fast_sin, field_input, in_width,
                             layer_specs, softplus)

ALL_HEADS = ("rgb", "sun", "sky", "beta", "sem")
HEAD_BITS = {"rgb": 1, "sun": 2, "sky": 4, "beta": 8, "sem": 16}
KPAD = 16  # the kernel's matmul depth: every K segment and N is padded to it
MAX_LAYERS = 32  # csrc/field_eval.cu MAX_LAYERS


def supports_config(cfg: ModelConfig) -> bool:
    """The sp-nerf flagship family, beta path included; relu variants and
    hash encodings use the module path."""
    return (cfg.siren and cfg.skips == (4,)
            and cfg.fc_layers >= 2 and cfg.encoding == "siren")


def _ceil(x, m=KPAD):
    return -(-x // m) * m


@dataclass
class PackedField:
    """The field's weights, once in plain form and once in the kernel's
    layout.

    Plain: `ws[i]` (K, N) float32 and `bs[i]` (N,) float32 for the layer
    `names[i]`. Kernel: every layer's weight zero-padded to (Kpad, Npad) with
    each input segment padded to a multiple of 16 rows, cast to bf16 and laid
    out row-major, one after the other, in `w_all`; biases zero-padded to
    Npad in `b_all`; `desc` holds per layer (w_off, b_off, k1, k2, npad,
    nreal), k1 and k2 being the padded widths of the two input segments.
    """

    cfg: ModelConfig
    names: List[str]
    ws: List[torch.Tensor]
    bs: List[torch.Tensor]
    sem_table: Optional[torch.Tensor]
    w_all: torch.Tensor
    b_all: torch.Tensor
    desc: np.ndarray
    k0_pad: int


def pack_params(model) -> PackedField:
    """Pack an `SPNeRF` module's weights for the fused field."""
    cfg = model.cfg
    if not supports_config(cfg):
        raise ValueError("configuration not covered by the fused field")
    specs = layer_specs(cfg)
    names = [s[0] for s in specs]
    ws = [model.layer(n).kernel.detach().float() for n in names]
    bs = [model.layer(n).bias.detach().float() for n in names]
    w_parts, b_parts, desc = [], [], []
    w_off = b_off = 0
    for (name, segs, out, _), w, b in zip(specs, ws, bs):
        kp = [_ceil(s) for s in segs]
        npad = _ceil(out)
        wp = torch.zeros(sum(kp), npad, dtype=torch.float32, device=w.device)
        src = dst = 0
        for s, p in zip(segs, kp):
            wp[dst:dst + s, :out] = w[src:src + s]
            src, dst = src + s, dst + p
        bp = torch.zeros(npad, dtype=torch.float32, device=b.device)
        bp[:out] = b
        w_parts.append(wp.to(torch.bfloat16).reshape(-1))
        b_parts.append(bp)
        desc.append((w_off, b_off, kp[0], kp[1] if len(kp) > 1 else 0, npad,
                     out))
        w_off += wp.numel()
        b_off += npad
    sem_table = (model.semantic_embedding.detach().float()
                 if cfg.sem else None)
    return PackedField(cfg=cfg, names=names, ws=ws, bs=bs,
                       sem_table=sem_table, w_all=torch.cat(w_parts),
                       b_all=torch.cat(b_parts),
                       desc=np.asarray(desc, np.int32),
                       k0_pad=_ceil(in_width(cfg)))


def active_outputs(cfg: ModelConfig, heads):
    """Ordered (name, width) of the outputs for a head subset."""
    outs = [("sigma", 1)]
    if "rgb" in heads:
        outs.append(("rgb", 3))
    if "sun" in heads:
        outs.append(("sun_v", 1))
    if "sky" in heads:
        outs.append(("sky", 3))
    if cfg.beta and "beta" in heads:
        outs.append(("beta", 1))
    if cfg.sem and "sem" in heads:
        outs.append(("sem_logits", cfg.num_sem_classes))
    return outs


def layers_run(cfg: ModelConfig, heads):
    """Names of the dense layers a field call with `heads` evaluates."""
    names = [f"trunk{k}" for k in range(cfg.fc_layers)] + ["sigma"]
    if {"rgb", "sun", "beta"} & set(heads):
        names.append("feats")
    if "rgb" in heads:
        names += ["rgb0", "rgb1"]
    if "sun" in heads:
        names += ["sun0", "sun1", "sun2", "sun3"]
    if "sky" in heads:
        names += ["sky0", "sky1"]
    if cfg.beta and "beta" in heads:
        names += ["beta0", "beta1"]
    if cfg.sem and "sem" in heads:
        names += ["sem0", "sem1"]
    return names


def flops_per_point(cfg: ModelConfig, heads=ALL_HEADS):
    """Matmul operations per point (2 per weight the call uses)."""
    widths = {n: (sum(segs), out) for n, segs, out, _ in layer_specs(cfg)}
    return sum(2 * widths[n][0] * widths[n][1] for n in layers_run(cfg, heads))


def fused_field_plain(packed: PackedField, x_in, sun, t_in=None,
                      heads=ALL_HEADS, compute_dtype="bfloat16"):
    """The fused field with PyTorch ops, op for op as the kernel computes it.

    x_in: (N, K0) float32 trunk input (mapping and semantic embedding already
    concatenated); sun: (N, 3); t_in: (N, T) when the field has a beta head.
    On CUDA run it with `torch.backends.cuda.matmul.allow_tf32 = False`.
    """
    cfg = packed.cfg
    cd = as_dtype(compute_dtype)
    w = dict(zip(packed.names, packed.ws))
    b = dict(zip(packed.names, packed.bs))

    def dense(name, x):
        # bf16 operands, exact products, float32 sums
        return x.to(cd).float() @ w[name].to(cd).float() + b[name]

    outs = dict(active_outputs(cfg, heads))
    skip = cfg.skips[0]
    x_in = x_in.float()
    sun = sun.float()

    h = fast_sin(30.0 * dense("trunk0", x_in))
    for i in range(1, cfg.fc_layers):
        if i == skip:
            h = torch.cat([h, x_in], dim=-1)
        h = fast_sin(dense(f"trunk{i}", h))
    shared = h

    res = {"sigma": softplus(dense("sigma", shared))[:, 0]}
    feats = (dense("feats", shared)
             if ("rgb" in outs or "sun_v" in outs or "beta" in outs) else None)
    if "rgb" in outs:
        r = fast_sin(dense("rgb0", feats))
        res["rgb"] = torch.sigmoid(dense("rgb1", r)) * 1.002 - 0.001
    if "sun_v" in outs:
        s = fast_sin(dense("sun0", torch.cat([feats, sun], dim=-1)))
        s = fast_sin(dense("sun1", s))
        s = fast_sin(dense("sun2", s))
        res["sun_v"] = torch.sigmoid(dense("sun3", s))
    if "sky" in outs:
        k = torch.relu(dense("sky0", sun))
        res["sky"] = torch.sigmoid(dense("sky1", k))
    if "beta" in outs:
        bb = fast_sin(dense("beta0", torch.cat([feats, t_in.float()], dim=-1)))
        res["beta"] = softplus(dense("beta1", bb))
    if "sem_logits" in outs:
        g = fast_sin(dense("sem0", shared))
        res["sem_logits"] = dense("sem1", g)
    return res


def _declare(lib):
    f = lib.spnerf_field_eval
    f.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
                  + [ctypes.c_void_p] * 7)
    f.restype = ctypes.c_int
    lib.spnerf_cuda_error_string.argtypes = [ctypes.c_int]
    lib.spnerf_cuda_error_string.restype = ctypes.c_char_p
    return f


def _padded_bf16(x, width):
    out = torch.zeros((x.shape[0], width), dtype=torch.bfloat16,
                      device=x.device)
    out[:, :x.shape[1]] = x
    return out


def fused_field_kernel(packed: PackedField, x_in, sun, t_in=None,
                       heads=ALL_HEADS):
    """Launch the CUDA kernel on CUDA tensors; same contract as
    `fused_field_plain` in bf16."""
    from . import _build

    cfg = packed.cfg
    dev = x_in.device
    if dev.type != "cuda":
        raise ValueError("fused_field_kernel takes CUDA tensors")
    for t in (sun, t_in, packed.w_all, packed.b_all):
        if t is not None and t.device != dev:
            raise ValueError(f"tensor on {t.device}, expected {dev}")
    if cfg.fc_units % 32 or len(packed.names) > MAX_LAYERS:
        raise ValueError("kernel needs fc_units % 32 == 0 and at most "
                         f"{MAX_LAYERS} layers")
    if cfg.beta and cfg.t_embedding_dims > KPAD:
        raise ValueError(f"kernel takes t_embedding_dims <= {KPAD}")
    outs = active_outputs(cfg, heads)
    n = x_in.shape[0]
    res = {nm: torch.empty((n, wd), dtype=torch.float32, device=dev)
           for nm, wd in outs}
    if n:
        xb = _padded_bf16(x_in, packed.k0_pad)
        sb = _padded_bf16(sun, KPAD)
        tb = _padded_bf16(t_in, KPAD) if "beta" in res else None
        mask = sum(HEAD_BITS[h] for h in set(heads))
        lib = _build.load("field_eval")
        ptr = lambda t: None if t is None else t.data_ptr()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
        err = _declare(lib)(
            ptr(xb), ptr(sb), ptr(tb), ptr(packed.w_all), ptr(packed.b_all),
            packed.desc.ctypes.data, len(packed.names), cfg.fc_layers,
            cfg.skips[0], cfg.fc_units, packed.k0_pad, int(cfg.beta),
            int(cfg.sem), mask, n,
            *(ptr(res.get(k)) for k in ("sigma", "rgb", "sun_v", "sky",
                                        "beta", "sem_logits")),
            stream)
        if err:
            raise RuntimeError("field_eval kernel launch failed: "
                               + lib.spnerf_cuda_error_string(err).decode())
        FusedField.launches += 1
    res["sigma"] = res["sigma"][:, 0]
    return res


class FusedField:
    """Forward-only field callable, `(xyz, sun_d, t_emb, sem_labels, heads)`
    -> dict, over packed weights. CUDA inputs go through the kernel, CPU
    inputs through its plain version.

    `FusedField.launches` counts kernel launches, process-wide.
    """

    launches = 0

    def __init__(self, packed: PackedField, compute_dtype="bfloat16"):
        self.packed = packed
        self.cfg = packed.cfg
        self.compute_dtype = compute_dtype

    def inputs(self, xyz, sun_d, t_emb, sem_labels):
        """The kernel's inputs: trunk input, sun direction, transient code."""
        cfg = self.cfg
        x_in = field_input(cfg, xyz.float(), sem_labels, self.packed.sem_table)
        t_in = None
        if cfg.beta:
            t_in = (t_emb.float() if t_emb is not None else
                    torch.zeros((xyz.shape[0], cfg.t_embedding_dims),
                                device=xyz.device))
        return x_in, sun_d.float(), t_in

    def __call__(self, xyz, sun_d, t_emb=None, sem_labels=None, heads=None):
        heads = ALL_HEADS if heads is None else tuple(heads)
        unknown = set(heads) - set(ALL_HEADS)
        if unknown:
            raise ValueError(f"unknown heads {sorted(unknown)}")
        x_in, sun, t_in = self.inputs(xyz, sun_d, t_emb, sem_labels)
        if xyz.is_cuda:
            if as_dtype(self.compute_dtype) != torch.bfloat16:
                raise NotImplementedError(
                    "the CUDA field kernel computes in bfloat16 only")
            return fused_field_kernel(self.packed, x_in, sun, t_in, heads)
        return fused_field_plain(self.packed, x_in, sun, t_in, heads,
                                 self.compute_dtype)


class PlainField(FusedField):
    """The fused field's plain version on any device: the reference the
    kernel is held against on the card."""

    def __call__(self, xyz, sun_d, t_emb=None, sem_labels=None, heads=None):
        heads = ALL_HEADS if heads is None else tuple(heads)
        x_in, sun, t_in = self.inputs(xyz, sun_d, t_emb, sem_labels)
        return fused_field_plain(self.packed, x_in, sun, t_in, heads,
                                 self.compute_dtype)
