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
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..models.spnerf import (as_dtype, fast_sin, field_input, in_width,
                             layer_specs, softplus)

ALL_HEADS = ("rgb", "sun", "sky", "beta", "sem")
KPAD = 16  # wgmma's depth: every input segment is padded to it
NCHUNK = 128  # output columns of a weight stage: a pair's two n64 wgmmas
SLAB = 64  # input rows a weight stage covers: one 128-byte swizzle atom
MAX_OPS = 32  # csrc/field_eval.cu MAX_OPS
SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on the H100
BLOCK_BYTES = 64 * 128  # one 64-row, 64-wide bf16 tile in shared memory
STAGE_BYTES = NCHUNK * 128  # one weight stage: NCHUNK rows x 64 bf16
MAX_STAGES = 6  # the weight ring's depth where shared memory holds it
OUTPUTS = ("sigma", "rgb", "sun_v", "sky", "beta", "sem_logits")
# the kernel's epilogues and operand sources (csrc/field_eval.cu EPI_*, SRC_*)
EPI = {n: i for i, n in enumerate(("sin30", "sin", "relu", "none",
                                   "softplus", "albedo", "sigmoid"))}
SRC = {n: i for i, n in enumerate(("buf0", "buf1", "x", "sun", "t"))}


def in_family(cfg: ModelConfig) -> bool:
    """The sp-nerf flagship family, beta path included, whose layers
    `pack_params` lays out and `program` orders; relu variants and hash
    encodings are not in it."""
    return (cfg.siren and cfg.skips == (4,)
            and cfg.fc_layers >= 2 and cfg.encoding == "siren")


def supports_config(cfg: ModelConfig) -> bool:
    """Whether the kernel takes the configuration: the family at a width it
    takes, fc_units a multiple of 32 with the tiles and a ring of at least
    2 weight stages in shared memory (up to 704, 640 with a beta head),
    and t_embedding_dims <= 16. Other configurations render through the
    module."""
    has_t = cfg.beta
    return (in_family(cfg) and cfg.fc_units % 32 == 0
            and not (has_t and cfg.t_embedding_dims > KPAD)
            and ring_stages(cfg.fc_units, _ceil(in_width(cfg)), has_t) > 0)


def uses_fused_kernel(device, cfg: ModelConfig, compute_dtype) -> bool:
    """Whether a render on `device` evaluates the field through the CUDA
    kernel: a covered configuration in bfloat16 on CUDA. The kernel computes
    bf16 products only; a float32 render on CUDA goes through the `SPNeRF`
    module in float32 (with TF32 off, the float32 products the JAX kernel
    computes), and the CPU always takes the module."""
    return (torch.device(device).type == "cuda" and supports_config(cfg)
            and as_dtype(compute_dtype) == torch.bfloat16)


def _ceil(x, m=KPAD):
    return -(-x // m) * m


def out_pad(n):
    """A layer's padded output width: 16 for the narrow heads, else a
    multiple of 64 (N-chunks of NCHUNK, the last one 64 wide where
    needed)."""
    return KPAD if n <= KPAD else _ceil(n, SLAB)


def swizzle_index(rows):
    """(rows, 64) element positions of a rows x 64 bf16 tile in the 128-byte
    swizzled order wgmma reads: row n's 16-byte chunk c lands at chunk
    c ^ (n % 8) of the row."""
    n = torch.arange(rows)[:, None]
    k = torch.arange(SLAB)[None, :]
    return n * SLAB + ((k // 8) ^ (n % 8)) * 8 + k % 8


@dataclass
class LayerPack:
    """Where a layer lives in the kernel's layout: byte offset of its first
    weight stage, float offset of its bias, the padded depths of its two
    input segments (k2 = 0 for one), its padded and real output widths."""

    w_off: int
    b_off: int
    k1: int
    k2: int
    npad: int
    nreal: int

    @property
    def slabs(self):
        return -(-self.k1 // SLAB) + -(-self.k2 // SLAB)

    def stages(self):
        """(n0, nc, slab) of every weight stage, in the order the ring
        receives them: N-chunk by N-chunk, each chunk's slabs in K order."""
        return [(n0, min(NCHUNK, self.npad - n0), s)
                for n0 in range(0, self.npad, NCHUNK)
                for s in range(self.slabs)]


@dataclass
class PackedField:
    """The field's weights, once in plain form and once in the kernel's
    layout.

    Plain: `ws[i]` (K, N) float32 and `bs[i]` (N,) float32 for the layer
    `names[i]`. Kernel: each layer's transposed weight, bf16, cut into
    stages of one N-chunk (NCHUNK output columns, fewer for a narrow last
    chunk) by one K-slab (64 input rows, each input segment padded to whole
    slabs), every stage laid out in the 128-byte swizzled K-major order that
    wgmma reads from shared memory, so that one bulk copy moves it; stages
    follow each other in the order `LayerPack.stages` gives, layer after
    layer, in `w_all` (bytes as bf16 pairs). Biases zero-padded to npad in
    `b_all`. `layers[name]` says where each layer is.
    """

    cfg: ModelConfig
    names: List[str]
    ws: List[torch.Tensor]
    bs: List[torch.Tensor]
    sem_table: Optional[torch.Tensor]
    w_all: torch.Tensor
    b_all: torch.Tensor
    layers: Dict[str, LayerPack]
    k0_pad: int


def pack_params(model) -> PackedField:
    """Pack an `SPNeRF` module's weights for the fused field."""
    cfg = model.cfg
    if not in_family(cfg):
        raise ValueError("configuration not covered by the fused field")
    specs = layer_specs(cfg)
    names = [s[0] for s in specs]
    ws = [model.layer(n).kernel.detach().float() for n in names]
    bs = [model.layer(n).bias.detach().float() for n in names]
    w_parts, b_parts, layers = [], [], {}
    w_off = b_off = 0
    for (name, segs, out, _), w, b in zip(specs, ws, bs):
        kp = [_ceil(s) for s in segs]
        npad = out_pad(out)
        lp = LayerPack(w_off, b_off, kp[0], kp[1] if len(kp) > 1 else 0,
                       npad, out)
        # the transposed weight, each segment padded to whole slabs
        wt = torch.zeros(npad, lp.slabs * SLAB, dtype=torch.float32,
                         device=w.device)
        src, dst = 0, 0
        for s, p in zip(segs, kp):
            wt[:out, dst:dst + s] = w[src:src + s].t()
            src, dst = src + s, dst + _ceil(p, SLAB)
        wt = wt.to(torch.bfloat16)
        for n0, nc, s in lp.stages():
            tile = wt[n0:n0 + nc, s * SLAB:(s + 1) * SLAB].reshape(-1)
            flat = torch.empty_like(tile)
            flat[swizzle_index(nc).reshape(-1).to(w.device)] = tile
            w_parts.append(flat)
        bp = torch.zeros(npad, dtype=torch.float32, device=b.device)
        bp[:out] = b
        b_parts.append(bp)
        layers[name] = lp
        w_off += 2 * npad * lp.slabs * SLAB
        b_off += npad
    sem_table = (model.semantic_embedding.detach().float()
                 if cfg.sem else None)
    return PackedField(cfg=cfg, names=names, ws=ws, bs=bs,
                       sem_table=sem_table, w_all=torch.cat(w_parts),
                       b_all=torch.cat(b_parts), layers=layers,
                       k0_pad=_ceil(in_width(cfg)))


def program(packed: PackedField, heads):
    """The kernel's layer program for a head subset: (n_ops, 11) int32 rows
    of (w_off, b_off, k1, k2, npad, nreal, a1, a2, dst, epi, out), in the
    order the kernel runs them. a1, a2: the input segments' sources (SRC);
    dst: the activation buffer written (0, 1), or -1 for a head output, out:
    its index in OUTPUTS. The trunk ping-pongs between buf0 and buf1; the
    heads run on its output X and the other buffer Y, the solar head last
    because it overwrites the features in Y."""
    cfg = packed.cfg
    outs = dict(active_outputs(cfg, heads))
    rows = []

    def op(name, a1, dst, epi, a2=None):
        lp = packed.layers[name]
        out = OUTPUTS.index(dst) if dst in OUTPUTS else -1
        rows.append((lp.w_off, lp.b_off, lp.k1, lp.k2, lp.npad, lp.nreal,
                     SRC[a1], SRC[a2] if a2 else -1,
                     -1 if out >= 0 else SRC[dst], EPI[epi], out))

    op("trunk0", "x", "buf0", "sin30")
    cur, nxt = "buf0", "buf1"
    for i in range(1, cfg.fc_layers):
        op(f"trunk{i}", cur, nxt, "sin",
           a2="x" if i == cfg.skips[0] else None)
        cur, nxt = nxt, cur
    X, Y = cur, nxt
    op("sigma", X, "sigma", "softplus")
    if "sem_logits" in outs:
        op("sem0", X, Y, "sin")
        op("sem1", Y, "sem_logits", "none")
    if {"rgb", "sun_v", "beta"} & set(outs):
        op("feats", X, Y, "none")
        if "rgb" in outs:
            op("rgb0", Y, X, "sin")
            op("rgb1", X, "rgb", "albedo")
        if "beta" in outs:
            op("beta0", Y, X, "sin", a2="t")
            op("beta1", X, "beta", "softplus")
        if "sun_v" in outs:
            op("sun0", Y, X, "sin", a2="sun")
            op("sun1", X, Y, "sin")
            op("sun2", Y, X, "sin")
            op("sun3", X, "sun_v", "sigmoid")
    if "sky" in outs:
        op("sky0", "sun", X, "relu")
        op("sky1", X, "sky", "sigmoid")
    return np.asarray(rows, np.int32)


def stream_bytes(packed: PackedField, heads):
    """Weight bytes the kernel streams for one tile of points: every stage
    of every layer the program runs (the L2 reads a tile costs, as the
    design reckons them)."""
    prog = program(packed, heads)
    npad, k1, k2 = prog[:, 4], prog[:, 2], prog[:, 3]
    slabs = -(-k1 // SLAB) + -(-k2 // SLAB)
    return int((2 * npad * slabs * SLAB).sum())


def smem_bytes(width, k0_pad, has_t, stages):
    """The kernel's dynamic shared memory (spnerf_field_eval_smem): two
    activation buffers, the input, sun and transient tiles, the ring of
    `stages` with its barriers, and 1 KB of alignment slack."""
    blocks = 2 * _ceil(width, SLAB) // SLAB + _ceil(k0_pad, SLAB) // SLAB
    return (1024 + (blocks + 1 + int(has_t)) * BLOCK_BYTES
            + stages * (STAGE_BYTES + 16))


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
    f.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
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


def ring_stages(width, k0_pad, has_t):
    """The weight ring's depth as the kernel sets it
    (spnerf_field_eval_stages): MAX_STAGES, or as many stages as shared
    memory holds beside the tiles (wide fields); 0 where not even 2 fit, a
    width the kernel does not take."""
    for stages in range(MAX_STAGES, 1, -1):
        if smem_bytes(width, k0_pad, has_t, stages) <= SMEM_LIMIT:
            return stages
    return 0


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
    if cfg.fc_units % 32:
        raise ValueError("the kernel takes fc_units % 32 == 0")
    if cfg.beta and cfg.t_embedding_dims > KPAD:
        raise ValueError(f"the kernel takes t_embedding_dims <= {KPAD}")
    has_t = cfg.beta and "beta" in heads
    if not ring_stages(cfg.fc_units, packed.k0_pad, has_t):
        raise ValueError(f"fc_units {cfg.fc_units}: the kernel's tiles and a "
                         f"ring of 2 stages do not fit {SMEM_LIMIT} bytes of "
                         f"shared memory")
    prog = program(packed, heads)
    if len(prog) > MAX_OPS:
        raise ValueError(f"the kernel runs at most {MAX_OPS} layers")
    outs = active_outputs(cfg, heads)
    n = x_in.shape[0]
    res = {nm: torch.empty((n, wd), dtype=torch.float32, device=dev)
           for nm, wd in outs}
    if n:
        xb = _padded_bf16(x_in, packed.k0_pad)
        sb = _padded_bf16(sun, KPAD)
        tb = _padded_bf16(t_in, KPAD) if has_t else None
        lib = _build.load("field_eval")
        ptr = lambda t: None if t is None else t.data_ptr()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
        err = _declare(lib)(
            ptr(xb), ptr(sb), ptr(tb), ptr(packed.w_all), ptr(packed.b_all),
            prog.ctypes.data, len(prog), cfg.fc_units, packed.k0_pad,
            int(has_t), n,
            *(ptr(res.get(k)) for k in OUTPUTS), stream)
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
                # a float32 render on CUDA takes the module
                # (uses_fused_kernel), never this kernel
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
