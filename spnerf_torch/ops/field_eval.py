"""Fused forward of the SP-NeRF field: the CUDA kernels, their plain
version, and the wrapper that chooses between them by the device of its
input.

Four kernels replace the JAX package's Pallas field kernel
(`spnerf_tpu/ops/pallas/field_eval.py`, `_make_kernel` and `_fused_apply`),
one route each (`route`). Each evaluates the Siren trunk with its skip and
any subset of the heads on a tile of points with the activations in shared
memory, walking the layer program (`program`); only the inputs and the head
outputs touch device memory.

- "wgmma" (`csrc/field_eval.cu`): bf16 operands on the tensor cores, for the
  flagship family at fc_units a multiple of 32 up to 704 (640 with a beta
  head) and t_embedding_dims <= 16 (`supports_config`). Every use of an
  activation is a matmul operand, so it keeps activations in bf16.
- "wgmma_f32" (`csrc/field_eval_f32.cu`): compute_dtype "float32" (the
  Pallas kernel's float32 dots) on the tensor cores by the 3xTF32 split,
  float32 activations in one buffer, for the family up to F32_W_MAX = 512
  wide (`supports_f32`).
- "wgmma_wide" (`csrc/field_eval_wide.cu`): the fields neither takes, up
  to W_MAX = 4096 wide with any number of semantic classes
  (`supports_wide`), on the tensor cores with a 64-point tile split across
  a cluster of 2, 4 or 8 CTAs (`wide_cluster`), each holding 1/C of every
  layer's columns: bf16 products, or float32 as three TF32 products. A
  field wider than W_MAX would need a cluster larger than the H100's
  portable 8 CTAs: it renders through the `SPNeRF` module, the port's only
  limit on the field's width.
- "general" (`csrc/field_eval_general.cu`): float32 activations and FFMA
  sums, the operands either float32 or rounded to bf16 at the product; every
  width up to GEN_W_MAX. `route` names it for no configuration: it runs
  only on request (`pack_params(..., kernel="general")`), to hold and time
  the other routes beside it.

Numerics, as in the Pallas kernel: every matmul takes compute-dtype
operands (the activation and the weight, both rounded from float32) and
accumulates in float32; bias, pre-activations and head epilogues are
float32.

On a CUDA tensor the wrapper launches its route's kernel; on a CPU tensor it
runs the plain version, `fused_field_plain`, which repeats the kernels'
arithmetic with PyTorch ops.
"""

import ctypes
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..models.spnerf import (as_dtype, fast_sin, field_input, in_width,
                             layer_specs, softplus)
from ..spans import span

ALL_HEADS = ("rgb", "sun", "sky", "beta", "sem")
KPAD = 16  # wgmma's depth: every input segment is padded to it
NCHUNK = 128  # output columns of a weight stage: a pair's two n64 wgmmas
SLAB = 64  # input rows a weight stage covers: one 128-byte swizzle atom
MAX_OPS = 32  # csrc/field_eval.cu MAX_OPS
SMEM_LIMIT = 232_448  # dynamic shared memory a block may use on the H100
BLOCK_BYTES = 64 * 128  # one 64-row, 64-wide bf16 tile in shared memory
STAGE_BYTES = NCHUNK * 128  # one weight stage: NCHUNK rows x 64 bf16
MAX_STAGES = 6  # the weight ring's depth where shared memory holds it
# the general route (csrc/field_eval_general.cu KS, THREADS, W_MAX): weight
# slabs of GKS rows, every segment and output padded to GKS; a pass of a
# layer covers GEN_THREADS x 32 / BM columns of a BM-point tile
GKS = 16
GEN_THREADS = 256
GEN_W_MAX = 1024
# the wgmma_f32 route (csrc/field_eval_f32.cu KS, NCH, STAGE_BYTES,
# MAX_STAGES, W_MAX_F32, TAIL_N, WGS, RED_FLOATS): weight stages of F32_KS K
# rows of one F32_NCH-wide chunk, hi and lo; every head output at most
# TAIL_N wide, summed over F32_WGS consumer warpgroups' partial sums
F32_KS = 16
F32_NCH = 64
F32_STAGE_BYTES = F32_NCH * 128
F32_MAX_STAGES = 12
F32_W_MAX = 512
TAIL_N = 16
F32_WGS = 3
F32_RED_BYTES = F32_WGS * 64 * TAIL_N * 4
# the layers whose output is a head output: on the wgmma_f32 route each runs
# on the registers of the layer before it
TAILS = ("sigma", "rgb1", "sun3", "sky1", "beta1", "sem1")
# the wgmma_wide route (csrc/field_eval_wide.cu NCH, MAX_STAGES, SHARE_MAX,
# W_MAX, TAIL_N, the policies' KS): clusters of WIDE_CLUSTERS CTAs, C the
# smallest with ceil64(width) / C <= WIDE_SHARE_MAX (`wide_cluster`); every
# layer's output padded to 32 C columns, 1/C of it on each CTA; weight
# stages of one K slab (F32_KS rows as hi | lo in float32, WIDE_KS_BF16 rows
# in bf16) of one 64-wide chunk; a head output's weight padded to TAIL_N
# columns a pass
WIDE_CLUSTERS = (2, 4, 8)
WIDE_SHARE_MAX = 512
W_MAX = WIDE_SHARE_MAX * WIDE_CLUSTERS[-1]
WIDE_KS_BF16 = 64
WIDE_MAX_STAGES = 12
ROUTES = ("wgmma", "general", "wgmma_f32", "wgmma_wide")
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


def supports_f32(cfg: ModelConfig) -> bool:
    """Whether the wgmma_f32 kernel takes the configuration: the family at
    fc_units 2 to F32_W_MAX (the ring at least a slab's chunks deep beside
    the buffer, `f32_stages`), at most TAIL_N semantic classes (one head
    output pass); any t_embedding_dims and trunk input width."""
    return (in_family(cfg) and cfg.fc_units >= 2
            and f32_stages(cfg.fc_units) > 0
            and not (cfg.sem and cfg.num_sem_classes > TAIL_N))


def supports_wide(cfg: ModelConfig) -> bool:
    """Whether the wgmma_wide kernel takes the configuration (any dtype):
    the family at fc_units 2 to W_MAX (on clusters of `wide_cluster`, the
    ring at least a CTA's chunks deep beside its share of the buffer,
    `wide_stages`); any number of semantic classes (the logits in passes
    of TAIL_N columns), t_embedding_dims and trunk input width."""
    return in_family(cfg) and wide_stages(cfg.fc_units) > 0


def takes_general(cfg: ModelConfig) -> bool:
    """Whether the general kernel takes the configuration (any dtype): the
    family at a width whose tiles fit (up to GEN_W_MAX)."""
    t_pad = _ceil(cfg.t_embedding_dims, GKS) if cfg.beta else 0
    return in_family(cfg) and general_tile_rows(
        cfg.fc_units, _ceil(in_width(cfg), GKS), t_pad) > 0


def route(cfg: ModelConfig, compute_dtype):
    """Which CUDA kernel evaluates the field at `compute_dtype`: "wgmma" for
    bf16 within `supports_config`; "wgmma_f32" for float32 within
    `supports_f32`; "wgmma_wide" for what neither takes within
    `supports_wide` (float32 wider than 512, or of more than TAIL_N
    semantic classes, up to W_MAX; bf16 outside the wgmma kernel's
    envelope: wider fields, fc_units not a multiple of 32, t_embedding_dims
    > 16); None outside the family, wider than W_MAX, or at another dtype.
    It never names "general", which runs only on request."""
    cd = as_dtype(compute_dtype)
    if not in_family(cfg) or cd not in (torch.bfloat16, torch.float32):
        return None
    if cd == torch.bfloat16 and supports_config(cfg):
        return "wgmma"
    if cd == torch.float32 and supports_f32(cfg):
        return "wgmma_f32"
    if supports_wide(cfg):
        return "wgmma_wide"
    return None


def uses_fused_kernel(device, cfg: ModelConfig, compute_dtype) -> bool:
    """Whether a render on `device` evaluates the field through a CUDA
    kernel: on CUDA wherever `route` names one. Elsewhere the field renders
    through the `SPNeRF` module (on CUDA a float32 module with TF32 off
    computes the float32 products the JAX kernel computes), and the CPU
    always takes the module."""
    return (torch.device(device).type == "cuda"
            and route(cfg, compute_dtype) is not None)


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


def tf32_rna(x):
    """float32 to TF32, round to nearest with ties away from zero (PTX's
    cvt.rna.tf32.f32): the low 13 bits of the significand cleared, after
    adding half of their range to the magnitude."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def f32_k_order(k):
    """The wgmma_f32 layout's K order: the physical row (input column) of
    each of the k logical rows a weight stage holds. Within every group of
    8, logical rows t and t + 4 are physical 2 t and 2 t + 1: the two k a
    thread's TF32 A fragment holds are adjacent columns of the buffer."""
    m = np.arange(k)
    return 8 * (m // 8) + 2 * (m % 4) + (m % 8) // 4


def bf16_k_order(k):
    """The wgmma_wide layout's K order in bf16, as `f32_k_order`: within
    every group of 16, logical rows 2 t, 2 t + 1, 2 t + 8, 2 t + 9 (the k
    of a thread's bf16 A fragment of a k16 step, t = lane % 4) are physical
    4 t .. 4 t + 3, so the thread loads them as one float4 a row."""
    m = np.arange(k)
    return 16 * (m // 16) + 4 * ((m % 8) // 2) + 2 * ((m % 16) // 8) + m % 2


@dataclass
class LayerPack:
    """Where a layer lives in a kernel's layout: the offset of its weights
    (in bytes, of its first weight stage, in the wgmma, wgmma_f32 and
    wgmma_wide layouts; in floats in the general one), the float offset of
    its bias, the padded depths of its two input segments (k2 = 0 for
    one), its padded and real output widths. `slabs` and `stages` describe
    the wgmma layout."""

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
    """The field's weights, once in plain form and once in the layout of the
    kernel of `route`.

    Plain: `ws[i]` (K, N) float32 and `bs[i]` (N,) float32 for the layer
    `names[i]`. Biases zero-padded to npad in `b_all`; `layers[name]` says
    where each layer is in `w_all` and `b_all`.

    "wgmma" (also where no route takes the field): each layer's transposed
    weight, bf16, cut into stages of one N-chunk (NCHUNK output columns,
    fewer for a narrow last chunk) by one K-slab (64 input rows, each input
    segment padded to whole slabs), every stage laid out in the 128-byte
    swizzled K-major order that wgmma reads from shared memory, so that one
    bulk copy moves it; stages follow each other in the order
    `LayerPack.stages` gives, layer after layer, in `w_all` (bytes as bf16
    pairs; `w_off` in bytes).

    "general": each layer's (K, N) weight, row-major float32, every input
    segment and the output zero-padded to multiples of GKS, layer after
    layer in `w_all` (`w_off` in floats); in bf16 each weight is rounded to
    bf16 when packed (`compute_dtype`).

    "wgmma_wide" (float32 `w_all` words, `w_off` in bytes; `_pack_wide`),
    for clusters of `cluster` CTAs (C): a layer of TAILS, its (K, npad)
    row-major float32 weight (rounded to bf16 in bf16), K the padded width
    of the layer before, npad = ceil16(N) (TAIL_N up to 16 columns; the
    kernel sums it in passes of TAIL_N columns). Any other layer: its
    transposed weight, npad = ceil(N, 32 C) rows, the buffer's input
    segment padded to 32 C (the writing layer's npad) and an input's to the
    policy's slab (F32_KS, WIDE_KS_BF16), its K rows in `f32_k_order` /
    `bf16_k_order`; rows [r h, (r + 1) h), h = npad / C, are CTA r's, which
    streams them as stages of one slab of one 64-wide chunk, each row a
    column's slab (hi then lo float32; or bf16) in the 128-byte swizzle:
    CTA r's stage (s, j) at byte w_off + r * ns * h * 128 + (s * h + 64 j)
    * 128, ns the layer's slabs.

    "wgmma_f32" (float32 `w_all`, `w_off` in bytes): a layer of TAILS, its
    (K, TAIL_N) row-major float32 weight, K the padded width of the layer
    before it. Any other layer: its transposed weight (npad = ceil32(N)
    rows; the buffer's input segment padded to 32, an input's to F32_KS),
    its K rows in `f32_k_order`, split into hi = tf32_rna(w) and lo =
    tf32_rna(w - hi), cut into stages of one F32_KS-deep slab of one
    F32_NCH-wide chunk (the last may be 32 wide): each row a column's
    F32_KS hi then F32_KS lo values, its 16-byte chunks in the 128-byte
    swizzle (chunk c of row n at c ^ (n % 8)); stage (s, j) at byte
    w_off + (s * npad + F32_NCH * j) * 128.
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
    route: Optional[str]
    compute_dtype: torch.dtype
    cluster: int = 0  # wgmma_wide: the CTAs of a cluster the layout is for


def _pack_general(specs, ws, bs, cd):
    """The general route's layout of the layers: (w_all, b_all, layers)."""
    w_parts, b_parts, layers = [], [], {}
    w_off = b_off = 0
    for (name, segs, out, _), w, b in zip(specs, ws, bs):
        kp = [_ceil(s, GKS) for s in segs]
        npad = _ceil(out, GKS)
        wt = torch.zeros(sum(kp), npad, dtype=torch.float32, device=w.device)
        src = dst = 0
        for s, p in zip(segs, kp):
            wt[dst:dst + s, :out] = w[src:src + s]
            src, dst = src + s, dst + p
        w_parts.append(wt.to(cd).float().reshape(-1))
        bp = torch.zeros(npad, dtype=torch.float32, device=b.device)
        bp[:out] = b
        b_parts.append(bp)
        layers[name] = LayerPack(w_off, b_off, kp[0],
                                 kp[1] if len(kp) > 1 else 0, npad, out)
        w_off += wt.numel()
        b_off += npad
    return torch.cat(w_parts), torch.cat(b_parts), layers


def _f32_pads(name, segs):
    """The wgmma_f32 layout's padded input segments of a layer: the
    buffer's (the first, but for trunk0 and sky0) to 32, as the layer before
    pads its output; an input's (trunk input, sun, transient code) to
    F32_KS."""
    return [_ceil(s, 32) if i == 0 and name not in ("trunk0", "sky0")
            else _ceil(s, F32_KS) for i, s in enumerate(segs)]


def _pack_f32(specs, ws, bs):
    """The wgmma_f32 route's layout of the layers: (w_all, b_all, layers)."""
    w_parts, b_parts, layers = [], [], {}
    w_off = b_off = 0
    for (name, segs, out, _), w, b in zip(specs, ws, bs):
        kp = _f32_pads(name, segs)
        if name in TAILS:
            npad = TAIL_N
            wt = torch.zeros(kp[0], npad, dtype=torch.float32,
                             device=w.device)
            wt[:segs[0], :out] = w
            flat = wt.reshape(-1)
        else:
            npad, ktot = _ceil(out, 32), sum(kp)
            wt = torch.zeros(npad, ktot, dtype=torch.float32, device=w.device)
            src = dst = 0
            for sw, p in zip(segs, kp):
                wt[:out, dst:dst + sw] = w[src:src + sw].t()
                src, dst = src + sw, dst + p
            wt = wt[:, torch.from_numpy(f32_k_order(ktot)).to(w.device)]
            hi = tf32_rna(wt)
            lo = tf32_rna(wt - hi)
            ns = ktot // F32_KS
            blk = torch.cat([hi.reshape(npad, ns, F32_KS),
                             lo.reshape(npad, ns, F32_KS)], dim=2)
            blk = blk.permute(1, 0, 2).reshape(ns, npad, 8, 4)
            n = torch.arange(npad, device=w.device)[:, None]
            c = torch.arange(8, device=w.device)[None, :]
            flat = blk[:, n, c ^ (n % 8), :].reshape(-1)
        w_parts.append(flat)
        bp = torch.zeros(npad, dtype=torch.float32, device=b.device)
        bp[:out] = b
        b_parts.append(bp)
        layers[name] = LayerPack(4 * w_off, b_off, kp[0],
                                 kp[1] if len(kp) > 1 else 0, npad, out)
        w_off += flat.numel()
        b_off += npad
    return torch.cat(w_parts), torch.cat(b_parts), layers


def wide_npad(n, cluster):
    """A wgmma_wide layer's padded output width on clusters of `cluster`
    CTAs: ceil(n, 32 C), so that each CTA owns whole chunks of 64 and 32
    columns."""
    return _ceil(n, 32 * cluster)


def _wide_pads(name, segs, ks, cluster):
    """The wgmma_wide layout's padded input segments of a layer: the
    buffer's (the first, but for trunk0 and sky0) to the writing layer's
    npad (`wide_npad`); an input's (trunk input, sun, transient code) to
    the policy's slab `ks`."""
    return [wide_npad(s, cluster) if i == 0 and name not in ("trunk0", "sky0")
            else _ceil(s, ks) for i, s in enumerate(segs)]


def wide_ks(compute_dtype):
    """The K rows of a wgmma_wide weight stage in the policy of
    `compute_dtype`."""
    return WIDE_KS_BF16 if as_dtype(compute_dtype) == torch.bfloat16 else F32_KS


def _swizzle_rows(blk):
    """(ns, rows, 8, e) stage rows with their 16-byte chunks in the 128-byte
    swizzle: chunk c of row n stored at c ^ (n % 8)."""
    n = torch.arange(blk.shape[1], device=blk.device)[:, None]
    c = torch.arange(8, device=blk.device)[None, :]
    return blk[:, n, c ^ (n % 8), :]


def _pack_wide(specs, ws, bs, cd, cluster):
    """The wgmma_wide route's layout of the layers for clusters of
    `cluster` CTAs: (w_all, b_all, layers)."""
    bf16 = cd == torch.bfloat16
    ks = wide_ks(cd)
    w_parts, b_parts, layers = [], [], {}
    w_off = b_off = 0
    for (name, segs, out, _), w, b in zip(specs, ws, bs):
        kp = _wide_pads(name, segs, ks, cluster)
        if name in TAILS:
            npad = _ceil(out, TAIL_N)
            wt = torch.zeros(kp[0], npad, dtype=torch.float32,
                             device=w.device)
            wt[:segs[0], :out] = w.to(cd).float()
            flat = wt.reshape(-1)
        else:
            npad, ktot = wide_npad(out, cluster), sum(kp)
            h, ns = npad // cluster, ktot // ks
            wt = torch.zeros(npad, ktot, dtype=torch.float32, device=w.device)
            src = dst = 0
            for sw, p in zip(segs, kp):
                wt[:out, dst:dst + sw] = w[src:src + sw].t()
                src, dst = src + sw, dst + p
            order = bf16_k_order(ktot) if bf16 else f32_k_order(ktot)
            wt = wt[:, torch.from_numpy(order).to(w.device)]
            if bf16:
                rows = wt.to(torch.bfloat16).reshape(npad, ns, ks)
            else:
                hi = tf32_rna(wt)
                lo = tf32_rna(wt - hi)
                rows = torch.cat([hi.reshape(npad, ns, ks),
                                  lo.reshape(npad, ns, ks)], dim=2)
            shares = [_swizzle_rows(rows[r * h:(r + 1) * h].permute(
                1, 0, 2).reshape(ns, h, 8, -1)).reshape(-1)
                for r in range(cluster)]
            flat = torch.cat(shares)
            if bf16:
                flat = flat.view(torch.float32)
        w_parts.append(flat)
        bp = torch.zeros(npad, dtype=torch.float32, device=b.device)
        bp[:out] = b
        b_parts.append(bp)
        layers[name] = LayerPack(4 * w_off, b_off, kp[0],
                                 kp[1] if len(kp) > 1 else 0, npad, out)
        w_off += flat.numel()
        b_off += npad
    return torch.cat(w_parts), torch.cat(b_parts), layers


def pack_params(model, compute_dtype="bfloat16", kernel=None,
                cluster=None) -> PackedField:
    """Pack an `SPNeRF` module's weights for the fused field at
    `compute_dtype`, in the layout of `kernel` ("wgmma", "general",
    "wgmma_f32" or "wgmma_wide"; None: `route(cfg, compute_dtype)`'s, the
    wgmma kernel's where there is none). The packed layout decides which
    kernel a `FusedField` launches on CUDA; `kernel="general"` puts a field
    another kernel takes on the general kernel instead (to hold the two
    against each other). On the wgmma_wide route `cluster` forces the
    cluster's CTAs (2, 4 or 8; None: `wide_cluster`'s), so that the
    splits of 4 and 8 CTAs can run at narrow widths."""
    cfg = model.cfg
    if not in_family(cfg):
        raise ValueError("configuration not covered by the fused field")
    cd = as_dtype(compute_dtype)
    r = route(cfg, cd) if kernel is None else kernel
    takes = {"wgmma": supports_config(cfg) and cd == torch.bfloat16,
             "wgmma_f32": supports_f32(cfg) and cd == torch.float32,
             "wgmma_wide": supports_wide(cfg),
             "general": takes_general(cfg)}
    if kernel is not None and not takes.get(kernel, False):
        raise ValueError(f"kernel {kernel!r} does not take this field at "
                         f"{cd}")
    if cluster is not None and (r != "wgmma_wide" or not wide_stages(
            cfg.fc_units, cluster)):
        raise ValueError(f"no wgmma_wide launch of fc_units {cfg.fc_units} "
                         f"on clusters of {cluster} CTAs (route {r})")
    if r == "wgmma_wide" and cluster is None:
        cluster = wide_cluster(cfg.fc_units)
    specs = layer_specs(cfg)
    names = [s[0] for s in specs]
    ws = [model.layer(n).kernel.detach().float() for n in names]
    bs = [model.layer(n).bias.detach().float() for n in names]
    sem_table = (model.semantic_embedding.detach().float()
                 if cfg.sem else None)
    if r in ("general", "wgmma_f32", "wgmma_wide"):
        pack = {"general": lambda: _pack_general(specs, ws, bs, cd),
                "wgmma_f32": lambda: _pack_f32(specs, ws, bs),
                "wgmma_wide": lambda: _pack_wide(specs, ws, bs, cd,
                                                 cluster)}[r]
        w_all, b_all, layers = pack()
        k_pad = wide_ks(cd) if r == "wgmma_wide" else GKS
        return PackedField(cfg=cfg, names=names, ws=ws, bs=bs,
                           sem_table=sem_table, w_all=w_all, b_all=b_all,
                           layers=layers, k0_pad=_ceil(in_width(cfg), k_pad),
                           route=r, compute_dtype=cd,
                           cluster=cluster if r == "wgmma_wide" else 0)
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
    return PackedField(cfg=cfg, names=names, ws=ws, bs=bs,
                       sem_table=sem_table, w_all=torch.cat(w_parts),
                       b_all=torch.cat(b_parts), layers=layers,
                       k0_pad=_ceil(in_width(cfg)), route=r,
                       compute_dtype=cd)


def program(packed: PackedField, heads):
    """The kernels' layer program for a head subset: (n_ops, 11) int32 rows
    of (w_off, b_off, k1, k2, npad, nreal, a1, a2, dst, epi, out), in the
    order the kernels run them, at the offsets and paddings of the packed
    layout. a1, a2: the input segments' sources (SRC);
    dst: the activation buffer written (0, 1), or -1 for a head output, out:
    its index in OUTPUTS. The trunk ping-pongs between buf0 and buf1; the
    heads run on its output X and the other buffer Y, the solar head last
    because it overwrites the features in Y. On the wgmma_f32 and
    wgmma_wide routes see `_program_f32`."""
    if packed.route in ("wgmma_f32", "wgmma_wide"):
        return _program_f32(packed, heads)
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


def _program_f32(packed: PackedField, heads):
    """`program` on the wgmma_f32 and wgmma_wide routes, one activation
    buffer (buf0; on wgmma_wide split between the cluster's CTAs): the
    trunk overwrites it layer by layer; a head output (out >= 0, a1 = -1)
    runs on the registers of the layer before it; dst -1 keeps a layer's
    output in registers for its head output. So sem0, rgb0 and beta0 leave
    X or feats in place, feats overwrites X once sigma and sem0 have run,
    and the solar head overwrites feats last."""
    cfg = packed.cfg
    outs = dict(active_outputs(cfg, heads))
    rows = []

    def op(name, a1, dst, epi, a2=None):
        lp = packed.layers[name]
        out = OUTPUTS.index(dst) if dst in OUTPUTS else -1
        rows.append((lp.w_off, lp.b_off, lp.k1, lp.k2, lp.npad, lp.nreal,
                     SRC[a1] if a1 else -1, SRC[a2] if a2 else -1,
                     SRC[dst] if dst == "buf0" else -1, EPI[epi], out))

    op("trunk0", "x", "buf0", "sin30")
    for i in range(1, cfg.fc_layers):
        op(f"trunk{i}", "buf0", "buf0", "sin",
           a2="x" if i == cfg.skips[0] else None)
    op("sigma", None, "sigma", "softplus")
    if "sem_logits" in outs:
        op("sem0", "buf0", None, "sin")
        op("sem1", None, "sem_logits", "none")
    if {"rgb", "sun_v", "beta"} & set(outs):
        op("feats", "buf0", "buf0", "none")
        if "rgb" in outs:
            op("rgb0", "buf0", None, "sin")
            op("rgb1", None, "rgb", "albedo")
        if "beta" in outs:
            op("beta0", "buf0", None, "sin", a2="t")
            op("beta1", None, "beta", "softplus")
        if "sun_v" in outs:
            op("sun0", "buf0", "buf0", "sin", a2="sun")
            op("sun1", "buf0", "buf0", "sin")
            op("sun2", "buf0", None, "sin")
            op("sun3", None, "sun_v", "sigmoid")
    if "sky" in outs:
        op("sky0", "sun", None, "relu")
        op("sky1", None, "sky", "sigmoid")
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


def f32_smem_bytes(width, stages):
    """The wgmma_f32 kernel's dynamic shared memory
    (spnerf_field_eval_f32_smem): 1 KB of alignment slack, the ring of
    `stages` with its barriers, the activation buffer of 64 x ceil32(width)
    floats and the head outputs' partial sums."""
    return (1024 + stages * (F32_STAGE_BYTES + 16) + 64 * _ceil(width, 32) * 4
            + F32_RED_BYTES)


def f32_stages(width):
    """The wgmma_f32 kernel's ring depth (spnerf_field_eval_f32_stages):
    F32_MAX_STAGES, or as many stages as fit beside the buffer; 0 where
    fewer than a slab's chunks (ceil32(width) / 64) fit or width is outside
    1 .. F32_W_MAX."""
    if not 1 <= width <= F32_W_MAX:
        return 0
    least = -(-_ceil(width, 32) // F32_NCH)
    for stages in range(F32_MAX_STAGES, max(least, 2) - 1, -1):
        if f32_smem_bytes(width, stages) <= SMEM_LIMIT:
            return stages
    return 0


def wide_cluster(width):
    """The CTAs of a wgmma_wide cluster at `width`
    (spnerf_field_eval_wide_cluster): the smallest of WIDE_CLUSTERS with
    ceil64(width) / C <= WIDE_SHARE_MAX, so 2 up to 1,024 wide, 4 up to
    2,048 and 8 up to W_MAX; 0 outside 2 .. W_MAX."""
    if not 2 <= width <= W_MAX:
        return 0
    return next(c for c in WIDE_CLUSTERS
                if _ceil(width, 64) <= WIDE_SHARE_MAX * c)


def wide_share(width, cluster=None):
    """The buffer columns each CTA of a cluster of `cluster` CTAs (None:
    `wide_cluster`'s) owns at `width`: wide_npad(width, C) / C."""
    c = wide_cluster(width) if cluster is None else cluster
    return wide_npad(width, c) // c


def wide_smem_bytes(width, stages, cluster=None):
    """The wgmma_wide kernel's dynamic shared memory a CTA
    (spnerf_field_eval_wide_smem) on clusters of `cluster` CTAs (None:
    `wide_cluster`'s): 1 KB of alignment slack, the ring of `stages` with
    its barriers, the meeting barriers (16 bytes), the CTA's share of the
    activation buffer (64 x `wide_share` floats) and the head outputs'
    partial sums."""
    return (1024 + stages * (F32_STAGE_BYTES + 16) + 16
            + 64 * wide_share(width, cluster) * 4 + F32_RED_BYTES)


def wide_stages(width, cluster=None):
    """The wgmma_wide kernel's ring depth (spnerf_field_eval_wide_stages)
    on clusters of `cluster` CTAs (None: `wide_cluster`'s):
    WIDE_MAX_STAGES, or as many stages as fit beside the buffer share; 0
    where fewer than a CTA's chunks of a layer fit, the width is outside
    2 .. W_MAX, or the cluster is not one of WIDE_CLUSTERS or gives a CTA
    more than WIDE_SHARE_MAX columns."""
    c = wide_cluster(width) if cluster is None else cluster
    if (not 2 <= width <= W_MAX or c not in WIDE_CLUSTERS
            or wide_share(width, c) > WIDE_SHARE_MAX):
        return 0
    least = -(-wide_share(width, c) // F32_NCH)
    for stages in range(WIDE_MAX_STAGES, max(least, 2) - 1, -1):
        if wide_smem_bytes(width, stages, c) <= SMEM_LIMIT:
            return stages
    return 0


def wide_clusters(width, compute_dtype, cluster=None):
    """Clusters of `cluster` CTAs (None: `wide_cluster`'s) of the
    wgmma_wide kernel at `width` that fit on the current CUDA device at
    once (cudaOccupancyMaxActiveClusters): the persistent grid the kernel
    launches. Builds the kernel if needed."""
    from . import _build

    lib = _build.load("field_eval_wide")
    f = lib.spnerf_field_eval_wide_clusters
    f.argtypes = [ctypes.c_int] * 3
    f.restype = ctypes.c_int
    lib.spnerf_cuda_error_string.argtypes = [ctypes.c_int]
    lib.spnerf_cuda_error_string.restype = ctypes.c_char_p
    n = f(width, int(as_dtype(compute_dtype) == torch.bfloat16),
          wide_cluster(width) if cluster is None else cluster)
    if n < 0:
        raise RuntimeError("cudaOccupancyMaxActiveClusters failed: "
                           + lib.spnerf_cuda_error_string(-n).decode())
    return n


def general_pass_cols(bm):
    """Output columns of one pass of a layer at a BM-point tile: 256
    threads, each 4 points x 8 columns (csrc/field_eval_general.cu
    pass_cols)."""
    return GEN_THREADS * 32 // bm


def general_smem_bytes(bm, width, k0_pad, t_pad):
    """The general kernel's dynamic shared memory at a BM-point tile
    (spnerf_field_eval_general_smem): two float32 activation buffers of
    ceil16(width) columns, the input, sun (16) and transient tiles, and two
    weight stages of GKS x general_pass_cols(bm) floats."""
    return 4 * (bm * (2 * _ceil(width, GKS) + k0_pad + GKS + t_pad)
                + 2 * GKS * general_pass_cols(bm))


def general_tile_rows(width, k0_pad, t_pad):
    """The general kernel's tile (spnerf_field_eval_general_tile): 64, 32
    or 16 points, the largest whose smem fits SMEM_LIMIT; 0 where none does
    or width > GEN_W_MAX."""
    if not 1 <= width <= GEN_W_MAX:
        return 0
    for bm in (64, 32, 16):
        if general_smem_bytes(bm, width, k0_pad, t_pad) <= SMEM_LIMIT:
            return bm
    return 0


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


def _declare(lib, name="spnerf_field_eval", n_ints=5):
    """The C entry `name` of a field kernel: six input pointers, `n_ints`
    ints, six output pointers and the stream."""
    f = getattr(lib, name)
    f.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * n_ints
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


def _check_launch(packed: PackedField, want, x_in, sun, t_in, heads):
    """The checks every route's wrapper makes: CUDA tensors on one device,
    weights packed for route `want`, a program the kernels take. Returns
    the program."""
    if packed.route != want:
        raise ValueError(f"weights packed for the {packed.route} route, not "
                         f"{want}: pack_params(model, compute_dtype)")
    dev = x_in.device
    if dev.type != "cuda":
        raise ValueError("the field kernels take CUDA tensors")
    for t in (sun, t_in, packed.w_all, packed.b_all):
        if t is not None and t.device != dev:
            raise ValueError(f"tensor on {t.device}, expected {dev}")
    prog = program(packed, heads)
    if len(prog) > MAX_OPS:
        raise ValueError(f"the kernels run at most {MAX_OPS} layers")
    return prog


def _float32_inputs(cfg, x_in, sun, t_in, has_t):
    """The float32 routes' inputs as the kernels read them: contiguous
    float32 (N, K0), (N, 3) and (N, T) (None without the beta head), at
    the field's widths."""
    xin = x_in.float().contiguous()
    sn = sun.float().contiguous()
    tin = t_in.float().contiguous() if has_t else None
    if (xin.shape[1] != in_width(cfg) or sn.shape[1] != 3
            or (has_t and tin.shape != (xin.shape[0], cfg.t_embedding_dims))):
        raise ValueError("inputs of other widths than the field's")
    return xin, sn, tin


def _launch(lib, fn, args, dev, tag):
    """fn(*args, stream) on the current stream of `dev`; raises on the
    cudaError_t it returns."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, stream)
    if err:
        raise RuntimeError(f"{tag} kernel launch failed: "
                           + lib.spnerf_cuda_error_string(err).decode())


def _ptr(t):
    return None if t is None else t.data_ptr()


def fused_field_kernel(packed: PackedField, x_in, sun, t_in=None,
                       heads=ALL_HEADS):
    """Launch the wgmma kernel on CUDA tensors; same contract as
    `fused_field_plain` in bf16."""
    from . import _build

    cfg = packed.cfg
    prog = _check_launch(packed, "wgmma", x_in, sun, t_in, heads)
    has_t = cfg.beta and "beta" in heads
    outs = active_outputs(cfg, heads)
    n = x_in.shape[0]
    res = {nm: torch.empty((n, wd), dtype=torch.float32, device=x_in.device)
           for nm, wd in outs}
    if n:
        xb = _padded_bf16(x_in, packed.k0_pad)
        sb = _padded_bf16(sun, KPAD)
        tb = _padded_bf16(t_in, KPAD) if has_t else None
        lib = _build.load("field_eval")
        _launch(lib, _declare(lib), (
            _ptr(xb), _ptr(sb), _ptr(tb), _ptr(packed.w_all),
            _ptr(packed.b_all), prog.ctypes.data, len(prog), cfg.fc_units,
            packed.k0_pad, int(has_t), n,
            *(_ptr(res.get(k)) for k in OUTPUTS)), x_in.device, "field_eval")
        FusedField.launches += 1
        FusedField.route_launches["wgmma"] += 1
    res["sigma"] = res["sigma"][:, 0]
    return res


def fused_field_general(packed: PackedField, x_in, sun, t_in=None,
                        heads=ALL_HEADS):
    """Launch the general route's kernel on CUDA tensors; same contract as
    `fused_field_plain` at `packed.compute_dtype`."""
    from . import _build

    cfg = packed.cfg
    prog = _check_launch(packed, "general", x_in, sun, t_in, heads)
    has_t = cfg.beta and "beta" in heads
    t_dim = cfg.t_embedding_dims if has_t else 0
    t_pad = _ceil(t_dim, GKS)
    if not general_tile_rows(cfg.fc_units, packed.k0_pad, t_pad):
        raise ValueError(f"fc_units {cfg.fc_units}: wider than "
                         f"{GEN_W_MAX}, or the tiles do not fit "
                         f"{SMEM_LIMIT} bytes")
    outs = active_outputs(cfg, heads)
    n = x_in.shape[0]
    res = {nm: torch.empty((n, wd), dtype=torch.float32, device=x_in.device)
           for nm, wd in outs}
    if n:
        xin, sn, tin = _float32_inputs(cfg, x_in, sun, t_in, has_t)
        lib = _build.load("field_eval_general")
        _launch(lib, _declare(lib, "spnerf_field_eval_general", 8), (
            _ptr(xin), _ptr(sn), _ptr(tin), _ptr(packed.w_all),
            _ptr(packed.b_all), prog.ctypes.data, len(prog), cfg.fc_units,
            xin.shape[1], packed.k0_pad, t_dim, t_pad, n,
            int(packed.compute_dtype == torch.bfloat16),
            *(_ptr(res.get(k)) for k in OUTPUTS)), x_in.device,
            "field_eval_general")
        FusedField.launches += 1
        FusedField.route_launches["general"] += 1
    res["sigma"] = res["sigma"][:, 0]
    return res


def fused_field_f32(packed: PackedField, x_in, sun, t_in=None,
                    heads=ALL_HEADS):
    """Launch the wgmma_f32 kernel on CUDA tensors; same contract as
    `fused_field_plain` in float32."""
    from . import _build

    cfg = packed.cfg
    prog = _check_launch(packed, "wgmma_f32", x_in, sun, t_in, heads)
    if not supports_f32(cfg):
        raise ValueError(f"fc_units {cfg.fc_units}: outside the wgmma_f32 "
                         f"kernel's envelope (supports_f32)")
    has_t = cfg.beta and "beta" in heads
    t_dim = cfg.t_embedding_dims if has_t else 0
    outs = active_outputs(cfg, heads)
    n = x_in.shape[0]
    res = {nm: torch.empty((n, wd), dtype=torch.float32, device=x_in.device)
           for nm, wd in outs}
    if n:
        xin, sn, tin = _float32_inputs(cfg, x_in, sun, t_in, has_t)
        lib = _build.load("field_eval_f32")
        _launch(lib, _declare(lib, "spnerf_field_eval_f32"), (
            _ptr(xin), _ptr(sn), _ptr(tin), _ptr(packed.w_all),
            _ptr(packed.b_all), prog.ctypes.data, len(prog), cfg.fc_units,
            xin.shape[1], t_dim, n,
            *(_ptr(res.get(k)) for k in OUTPUTS)), x_in.device,
            "field_eval_f32")
        FusedField.launches += 1
        FusedField.route_launches["wgmma_f32"] += 1
    res["sigma"] = res["sigma"][:, 0]
    return res


def fused_field_wide(packed: PackedField, x_in, sun, t_in=None,
                     heads=ALL_HEADS):
    """Launch the wgmma_wide kernel on CUDA tensors, on clusters of
    `packed.cluster` CTAs; same contract as `fused_field_plain` at
    `packed.compute_dtype`."""
    from . import _build

    cfg = packed.cfg
    c = packed.cluster
    if packed.route == "wgmma_wide" and (
            c not in WIDE_CLUSTERS or not wide_stages(cfg.fc_units, c)
            or any(
                lp.npad % (32 * c) for nm, lp in packed.layers.items()
                if nm not in TAILS)):
        raise ValueError(f"weights not packed for clusters of {c} CTAs at "
                         f"fc_units {cfg.fc_units}: pack_params(model, "
                         f"compute_dtype, cluster=...)")
    prog = _check_launch(packed, "wgmma_wide", x_in, sun, t_in, heads)
    if not supports_wide(cfg):
        raise ValueError(f"fc_units {cfg.fc_units}: outside the wgmma_wide "
                         f"kernel's envelope (supports_wide)")
    has_t = cfg.beta and "beta" in heads
    t_dim = cfg.t_embedding_dims if has_t else 0
    outs = active_outputs(cfg, heads)
    n = x_in.shape[0]
    res = {nm: torch.empty((n, wd), dtype=torch.float32, device=x_in.device)
           for nm, wd in outs}
    if n:
        xin, sn, tin = _float32_inputs(cfg, x_in, sun, t_in, has_t)
        lib = _build.load("field_eval_wide")
        _launch(lib, _declare(lib, "spnerf_field_eval_wide", 7), (
            _ptr(xin), _ptr(sn), _ptr(tin), _ptr(packed.w_all),
            _ptr(packed.b_all), prog.ctypes.data, len(prog), cfg.fc_units,
            xin.shape[1], t_dim, n,
            int(packed.compute_dtype == torch.bfloat16), packed.cluster,
            *(_ptr(res.get(k)) for k in OUTPUTS)), x_in.device,
            "field_eval_wide")
        FusedField.launches += 1
        FusedField.route_launches["wgmma_wide"] += 1
    res["sigma"] = res["sigma"][:, 0]
    return res


class FusedField:
    """Forward-only field callable, `(xyz, sun_d, t_emb, sem_labels, heads)`
    -> dict, over packed weights. CUDA inputs go through the kernel the
    weights are packed for (`pack_params`: by default `route(cfg,
    compute_dtype)`'s), CPU inputs through the plain version.

    `FusedField.launches` counts kernel launches of every route,
    process-wide; `FusedField.route_launches[route]` each route's.
    """

    launches = 0
    route_launches = dict.fromkeys(ROUTES, 0)

    def __init__(self, packed: PackedField, compute_dtype="bfloat16"):
        self.packed = packed
        self.cfg = packed.cfg
        self.compute_dtype = compute_dtype

    def inputs(self, xyz, sun_d, t_emb, sem_labels):
        """The kernel's inputs: trunk input, sun direction, transient code."""
        cfg = self.cfg
        with span("field.inputs"):
            x_in = field_input(cfg, xyz.float(), sem_labels,
                               self.packed.sem_table)
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
        if not xyz.is_cuda:
            return fused_field_plain(self.packed, x_in, sun, t_in, heads,
                                     self.compute_dtype)
        r, cd = self.packed.route, as_dtype(self.compute_dtype)
        if r is None:
            raise ValueError("no CUDA field kernel takes this field: render "
                             "through the module (uses_fused_kernel)")
        if r == "wgmma" and cd != torch.bfloat16:
            raise ValueError(f"the wgmma kernel computes in bfloat16, not "
                             f"{cd}: pack_params(model, compute_dtype)")
        if r == "wgmma_f32" and cd != torch.float32:
            raise ValueError(f"the wgmma_f32 kernel computes in float32, not "
                             f"{cd}: pack_params(model, compute_dtype)")
        if (r in ("general", "wgmma_wide")
                and self.packed.compute_dtype != cd):
            raise ValueError(f"weights packed at {self.packed.compute_dtype},"
                             f" not {cd}")
        launch = {"wgmma": fused_field_kernel, "general": fused_field_general,
                  "wgmma_f32": fused_field_f32,
                  "wgmma_wide": fused_field_wide}[r]
        return launch(self.packed, x_in, sun, t_in, heads)


class PlainField(FusedField):
    """The fused field's plain version on any device: the reference the
    kernel is held against on the card."""

    def __call__(self, xyz, sun_d, t_emb=None, sem_labels=None, heads=None):
        heads = ALL_HEADS if heads is None else tuple(heads)
        x_in, sun, t_in = self.inputs(xyz, sun_d, t_emb, sem_labels)
        return fused_field_plain(self.packed, x_in, sun, t_in, heads,
                                 self.compute_dtype)
