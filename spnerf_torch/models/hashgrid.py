"""Multiresolution hash-grid encoding (Instant-NGP) and the hash-trunk SP-NeRF.

The same modules as the JAX package's `HashGridEncoding` and `HashSPNeRF`,
with direct (collision-free) indexing of the levels whose dense grid fits
the table and the table gradient through the hand-written kernels
(`ops/dtab.py`) on CUDA.

Per level l the grid has res_l = floor(16 * b^l) cells per axis (b spreads
the levels from 16 to 2048). A point's 8 cell corners index the level's
table directly when (res_l + 1)^3 <= T, else by the spatial hash
xor_a(x_a * p_a) mod T; their features are interpolated trilinearly and the
levels concatenated.

Multi-AOI frames (`frames` > 1, data/multi.py): a point's frame is
round(x / FRAME_SPACING) clipped to [0, frames - 1], and the point is moved
into its frame's box before the lookup. A direct level then holds one dense
block per frame (direct when side^3 * frames <= T, index lin + frame *
side^3); a hashed level XORs frame * _FRAME_PRIME into the hash, so each
frame addresses its own pseudo-table at full resolution.

The table has one of the JAX package's two layouts, chosen as it chooses
them (`flat_storage`): the impl decides the parameter's shape, and so which
checkpoints load, and nothing else; every impl computes the same function.

* Flat (the default): each level is one row of the (L, T * F) parameter,
  ordered feature-major (row[f * T + t]), so the (F, T) view is free and its
  first t_eff columns are the level's effective table. `HashTake` gathers
  columns of that view; its backward is the feature-major table gradient,
  (F, t_eff), which the view's own autograd pads back to the row. The
  corner values are interpolated by seven lerps.
* (L, T, F) (`hash_flat_table=False`, or an impl other than "xla",
  "matmul_vjp" and "auto"): `HashTakeRows` gathers rows of the level's
  (t_eff, F) slice; its backward is the t-major table gradient. The corner
  values are interpolated by the trilinear weight product, as the JAX
  package does on this layout. With SPNERF_HASH_SW_BATCHED=1 on CUDA
  tensors (and the JAX package's other conditions, `use_batched`), one
  `HashTakeBatched` gathers every level from its full table and its
  backward is one batched table gradient (B4) for all levels.
"""

import functools
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import ModelConfig
from ..ops.dtab import dtab, dtab_levels, window_eligible
from ..ops.occgrid import frame_decompose
from ..spans import span
from ..switches import HASH_SWITCHES, refuse
from .spnerf import TorchDense, as_dtype, embed_lookup, softplus, uniform_

# the spatial hash's primes; products are taken modulo 2^32 as in uint32
_PRIMES = (1, 2654435761, 805459861)
# the multi-AOI frame index's prime, XORed into the hash
_FRAME_PRIME = 3674653429
_MASK32 = 0xFFFFFFFF

# the 8 corner offsets of a unit cell, k minor
_CORNERS = np.array([[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)],
                    dtype=np.int64)  # (8, 3)


def level_resolutions(n_levels, base_resolution=16, max_resolution=2048):
    """Cells per axis of every level, computed as the JAX package does."""
    b = float(np.exp((np.log(max_resolution) - np.log(base_resolution))
                     / max(n_levels - 1, 1)))
    return np.floor(base_resolution * b ** np.arange(n_levels)).astype(np.int64)


def direct_table_size(res, table_size, direct_coarse=True, frames=1):
    """t_eff of a directly indexed level (a power of two holding the
    (res + 1)^3 corners of each of `frames` frames), or None when the level
    is hashed."""
    side = int(res) + 1
    if direct_coarse and side ** 3 * frames <= table_size:
        return 1 << int(np.ceil(np.log2(side ** 3 * frames)))
    return None


class _Levels:
    """The per-level constants of `levels_ids` on one device, made once
    (`_levels` keeps them): a copy from host memory at every call would wait for
    the device's queue to drain and could not be captured in a CUDA graph.

    The directly indexed levels are the first `n_direct` (a level's grid
    only grows finer with its index); `res` and `res_max` are (L, 1, 1)
    float32, `side` and `side3` (n_direct, 1) int64, and `offs` the direct
    levels' corner offsets (i side + j) side + k, (n_direct, 1, 8) int64."""

    def __init__(self, resolutions, table_size, direct_coarse, frames,
                 device):
        res = np.asarray(resolutions, dtype=np.int64)
        sizes = [direct_table_size(r, table_size, direct_coarse, frames)
                 for r in res]
        self.n_direct = sum(t is not None for t in sizes)
        self.t_eff = tuple(t or table_size for t in sizes)
        side = res[:self.n_direct, None] + 1
        c = _CORNERS.T[:, None, None, :]  # (3, 1, 1, 8)
        on = lambda a, dtype=None: torch.as_tensor(a, dtype=dtype,
                                                   device=device)
        self.res = on(res[:, None, None], torch.float32)
        self.res_max = on(res[:, None, None] - 1, torch.float32)
        self.side, self.side3 = on(side), on(side ** 3)
        self.offs = on((c[0] * side[..., None] + c[1]) * side[..., None]
                       + c[2])


_levels = functools.lru_cache(maxsize=64)(_Levels)


@functools.lru_cache(maxsize=8)
def _hash_offsets(device):
    """(3, 2) int64: (o p_a) mod 2^32 of each axis a's corner offset o, on
    the device once (as `_Levels`)."""
    return torch.as_tensor([[0, p & _MASK32] for p in _PRIMES],
                           dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=8)
def _corner_floats(device):
    """(8, 3) float32 corners (i, j, k) of a unit cell, on the device once
    (as `_Levels`)."""
    return torch.as_tensor(_CORNERS, dtype=torch.float32, device=device)


def _hash_corners(base, table_size, frame=None):
    """(..., N, 3) int64 cell base -> (..., N, 8) int64 hashed corner ids;
    frame: optional (N,) int64 frame index, XORed into the hash times
    _FRAME_PRIME.

    The uint32 hash in int64: every product and sum is masked to 32 bits, so
    the ids equal the uint32 arithmetic exactly. Per axis,
    (x + i) * p = x * p + i * p modulo 2^32, so six columns suffice: an
    (..., N, 2) pair an axis, whose XORs by broadcasting give the 8
    corners in a few launches."""
    offs = _hash_offsets(base.device)
    pairs = [(((base[..., a] * _PRIMES[a]) & _MASK32)[..., None] + offs[a])
             & _MASK32 for a in range(3)]  # (..., N, 2) each
    h = (pairs[0][..., :, None, None] ^ pairs[1][..., None, :, None]
         ^ pairs[2][..., None, None, :]).flatten(-3)  # corners k minor
    if frame is not None:
        h = h ^ ((frame * _FRAME_PRIME) & _MASK32)[:, None]
    return h % table_size


def levels_ids(x01, resolutions, table_size, direct_coarse=True, frame=None,
               frames=1):
    """Corner ids, in-cell fractions and effective table sizes of several
    levels at once, in a few launches for all of them.

    x01: (N, 3) float32 in [0, 1]; frame: (N,) int64 frame indices when
    frames > 1, else None. The cell is clamped to res - 1, so a point on a
    +1 face (x01 == 1.0, as solar-pass points leaving the box are clipped
    to) interpolates onto the face corners with frac == 1.0 instead of
    addressing corner res + 1.
    Returns ids, a list of (N, 8) int64 a level, frac (L, N, 3) float32 and
    the tuple of t_eff."""
    k = _levels(tuple(int(r) for r in resolutions), table_size,
                direct_coarse, frames if frame is not None else 1,
                x01.device)
    xs = x01 * k.res  # (L, N, 3)
    x0 = torch.minimum(torch.floor(xs), k.res_max)
    frac = xs - x0
    base = x0.long()
    ids = []
    if k.n_direct:
        b = base[:k.n_direct]
        lin = (b[..., 0] * k.side + b[..., 1]) * k.side + b[..., 2]
        if frame is not None:
            lin = lin + frame * k.side3
        ids += list(lin[..., None] + k.offs)
    if k.n_direct < len(k.t_eff):
        ids += list(_hash_corners(base[k.n_direct:], table_size, frame))
    return ids, frac, k.t_eff


def level_ids(x01, res, table_size, direct_coarse=True, frame=None,
              frames=1):
    """`levels_ids` of one level of `res` cells an axis: idx (N, 8) int64,
    frac (N, 3) float32, t_eff."""
    ids, frac, t_eff = levels_ids(x01, (res,), table_size, direct_coarse,
                                  frame, frames)
    return ids[0], frac[0], t_eff[0]


class HashTake(torch.autograd.Function):
    """Columns `idx` of an (F, t_eff) table view -> (F, N, 8). Backward: the
    table gradient through `ops.dtab.dtab` (the kernels on CUDA)."""

    @staticmethod
    def forward(ctx, tab_ft, idx, impl=None):
        ctx.save_for_backward(idx)
        ctx.t_eff = tab_ft.shape[1]
        ctx.impl = impl
        return tab_ft[:, idx]

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        n_feat = ct.shape[0]
        d = dtab(idx.reshape(-1), ct.reshape(n_feat, -1), ctx.t_eff, n_feat,
                 impl=ctx.impl)
        return d, None, None


class HashTakeRows(torch.autograd.Function):
    """Rows `idx` of a (t_eff, F) table slice -> (N, 8, F). Backward: the
    t-major table gradient through `ops.dtab.dtab`, the counterpart of the
    JAX package's `_take_matmul`."""

    @staticmethod
    def forward(ctx, tab_tf, idx, impl=None):
        ctx.save_for_backward(idx)
        ctx.t_eff = tab_tf.shape[0]
        ctx.impl = impl
        return tab_tf[idx]

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        n_feat = ct.shape[-1]
        d = dtab(idx.reshape(-1), ct.reshape(-1, n_feat), ctx.t_eff, n_feat,
                 impl=ctx.impl, fmajor=False)
        return d, None, None


class HashTakeBatched(torch.autograd.Function):
    """Every level at once: an (L, T, F) table and (L, N, 8) ids -> (L, N,
    8, F), each level gathered from its full table. Backward: one batched
    table gradient, `ops.dtab.dtab_levels` (B4 on CUDA), the counterpart of
    the JAX package's `_take_batched`."""

    @staticmethod
    def forward(ctx, table, idx, impl=None):
        ctx.save_for_backward(idx)
        ctx.table_size = table.shape[1]
        ctx.impl = impl
        lev = torch.arange(table.shape[0], device=idx.device)[:, None, None]
        return table[lev, idx]

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        L, n_feat = idx.shape[0], ct.shape[-1]
        d = dtab_levels(idx.reshape(L, -1), ct.reshape(L, -1, n_feat),
                        ctx.table_size, impl=ctx.impl)
        return d, None, None


def interp_lerp(vals, frac):
    """(..., F, N, 8) corner values, (..., N, 3) fractions -> (..., N, F):
    seven lerps, k then j then i (the corners are ordered (i, j, k) with k
    minor), over any leading (level) dimensions at once."""
    v, rest = vals, 1.0 - frac
    for d in (2, 1, 0):
        fd = frac[..., None, :, d, None]
        v = v[..., 0::2] * rest[..., None, :, d, None] + v[..., 1::2] * fd
    return v[..., 0].transpose(-1, -2)


def interp_weights(vals, frac):
    """(N, 8, F) corner values, (N, 3) fractions -> (N, F): the trilinear
    weight product w (N, 8), then sum_c w[n, c] * vals[n, c, f]."""
    corners = _corner_floats(frac.device)
    w = torch.ones(frac.shape[0], 8, dtype=torch.float32, device=frac.device)
    for d in range(3):
        cd = corners[:, d][None]  # (1, 8)
        fd = frac[:, d:d + 1]  # (N, 1)
        w = w * (cd * fd + (1.0 - cd) * (1.0 - fd))
    return (w[..., None] * vals).sum(1)


HASH_IMPLS = ("auto", "xla", "sorted_vjp", "matmul_vjp", "fused_vjp")


def flat_storage(flat_table, impl):
    """True when the table is the flat (L, T * F) row, as the JAX package
    decides it: flat_table and an impl of "xla" or "matmul_vjp" ("auto"
    resolves to one of the two)."""
    if impl not in HASH_IMPLS:
        raise ValueError(f"unknown hash impl {impl!r}; one of {HASH_IMPLS}")
    return bool(flat_table) and impl in ("auto", "xla", "matmul_vjp")


def use_batched(impl, flat, device, T, F, n_points, sw_batched=None):
    """The JAX package's gate of the batched route (`HashGridEncoding`):
    impl "matmul_vjp" ("auto" is that on an accelerator), the (L, T, F)
    table, SPNERF_HASH_SW_BATCHED=1 (sw_batched: None reads it now), an
    accelerator, and a window-eligible full table for the 8 corners of
    n_points."""
    if sw_batched is None:
        sw_batched = os.environ.get("SPNERF_HASH_SW_BATCHED", "0") == "1"
    return (impl in ("auto", "matmul_vjp") and not flat and sw_batched
            and torch.device(device).type != "cpu"
            and window_eligible(T, F, n_points * 8))


class HashGridEncoding(nn.Module):
    """xyz in [-1, 1]^3 -> (N, n_levels * n_features) float32.

    `flat_table` and `impl` choose the table's layout (`flat_storage`).
    `dtab_impl`: None takes the table gradient through the kernels on CUDA
    (the plain version on the CPU); "plain" takes the plain version on any
    device, for a reference run.

    Each forward's lookup and interpolation is the span "hash.encode"
    (`spans.span`: recorded only while a profiler records), and
    `HashGridEncoding.points` counts the points encoded, process-wide."""

    points = 0

    def __init__(self, n_levels=16, n_features=2, log2_table_size=19,
                 base_resolution=16, max_resolution=2048, direct_coarse=True,
                 flat_table=True, impl="auto", frames=1, generator=None):
        super().__init__()
        self.n_levels = n_levels
        self.frames = int(frames)
        self.n_features = n_features
        self.table_size = 2 ** log2_table_size
        self.direct_coarse = direct_coarse
        self.impl = impl
        self.flat = flat_storage(flat_table, impl)
        self.resolutions = level_resolutions(n_levels, base_resolution,
                                             max_resolution)
        shape = ((n_levels, self.table_size * n_features) if self.flat
                 else (n_levels, self.table_size, n_features))
        self.table = nn.Parameter(torch.empty(shape))
        uniform_(self.table, 1e-4, generator)
        self.dtab_impl = None

    def level_table_sizes(self):
        """t_eff of every level."""
        T = self.table_size
        return [direct_table_size(r, T, self.direct_coarse, self.frames) or T
                for r in self.resolutions]

    def forward(self, xyz):
        refuse(HASH_SWITCHES)  # the JAX package's switches that change it
        HashGridEncoding.points += xyz.shape[0]
        with span("hash.encode"):
            return self._encode(xyz.float())

    def _encode(self, xyz):
        L, nf, T = self.n_levels, self.n_features, self.table_size
        frame = None
        if self.frames > 1:
            frame, xyz = frame_decompose(xyz, self.frames)
        x01 = torch.clamp((xyz + 1.0) * 0.5, 0.0, 1.0)
        ids, frac, t_eff = levels_ids(x01, self.resolutions, T,
                                      self.direct_coarse, frame, self.frames)
        levels = list(zip(ids, frac, t_eff))
        if self.flat:
            vals = torch.stack([
                HashTake.apply(self.table[l].view(nf, T)[:, :t], idx,
                               self.dtab_impl)
                for l, (idx, _, t) in enumerate(levels)])  # (L, F, N, 8)
            # (L, N, F) -> (N, L F): the levels' features side by side
            return interp_lerp(vals, frac).transpose(0, 1).reshape(
                x01.shape[0], L * nf)
        if use_batched(self.impl, False, x01.device, T, nf, x01.shape[0]):
            vals_all = HashTakeBatched.apply(
                self.table, torch.stack([idx for idx, _, _ in levels]),
                self.dtab_impl)  # (L, N, 8, F)
            return torch.cat([interp_weights(vals_all[l], frac)
                              for l, (_, frac, _) in enumerate(levels)],
                             dim=-1)
        feats = []
        for l, (idx, frac, t_eff) in enumerate(levels):
            vals = HashTakeRows.apply(self.table[l][:t_eff], idx,
                                      self.dtab_impl)  # (N, 8, F)
            feats.append(interp_weights(vals, frac))
        return torch.cat(feats, dim=-1)


def hash_layer_specs(cfg: ModelConfig):
    """(name, fan_in, out) of every dense layer in creation order: index i
    is flax's `TorchDense_i` in the JAX package's `HashSPNeRF`."""
    h = cfg.hash_hidden
    k0 = cfg.hash_levels * cfg.hash_features
    if cfg.sem:
        k0 += cfg.num_sem_classes * cfg.s_embedding_factor
    specs = [("trunk0", k0, h), ("trunk1", h, h), ("sigma", h, 1),
             ("feats", h, h), ("rgb0", h, h), ("rgb1", h, 3),
             ("sun0", h + 3, h), ("sun1", h, h), ("sun2", h, 1),
             ("sky0", 3, h), ("sky1", h, 3)]
    if cfg.beta:
        specs += [("beta0", h + cfg.t_embedding_dims, h), ("beta1", h, 1)]
    if cfg.sem:
        specs += [("sem0", h, h), ("sem1", h, cfg.num_sem_classes)]
    return specs


def check_hash_config(cfg: ModelConfig):
    """Raise ValueError for an unknown impl or a frame count below 1."""
    if cfg.hash_frames < 1:
        raise ValueError(f"hash_frames {cfg.hash_frames} < 1")
    flat_storage(cfg.hash_flat_table, cfg.hash_impl)


class HashSPNeRF(nn.Module):
    """SP-NeRF with a hash-grid trunk: the same inputs and outputs as
    `SPNeRF`, NGP-sized MLPs (two ReLU trunk layers of hash_hidden units).

    forward(xyz, sun_d, t_emb, sem_labels, heads=None, anneal=None) -> dict
    of sigma (N,), rgb (N, 3), sun_v (N, 1), sky (N, 3), [beta (N, 1)],
    [sem_logits (N, C)]. anneal: optional (L,) per-level feature weights.
    """

    def __init__(self, cfg: ModelConfig, compute_dtype=torch.float32,
                 generator=None):
        super().__init__()
        if cfg.encoding != "hash":
            raise ValueError(f"HashSPNeRF takes encoding='hash', got "
                             f"{cfg.encoding!r}")
        check_hash_config(cfg)
        self.cfg = cfg
        self.compute_dtype = as_dtype(compute_dtype)
        self.encoding = HashGridEncoding(
            n_levels=cfg.hash_levels, n_features=cfg.hash_features,
            log2_table_size=cfg.hash_log2T,
            direct_coarse=cfg.hash_direct_coarse,
            flat_table=cfg.hash_flat_table, impl=cfg.hash_impl,
            frames=cfg.hash_frames, generator=generator)
        specs = hash_layer_specs(cfg)
        self.index = {name: i for i, (name, _, _) in enumerate(specs)}
        self.dense = nn.ModuleList(
            TorchDense(fan_in, out, "torch", self.compute_dtype, generator)
            for _, fan_in, out in specs)
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
                sigma_only=False, heads=None, anneal=None, solar_tail=0):
        """heads: optional subset of ("rgb", "sun", "sky", "beta", "sem");
        sigma is always computed. solar_tail: the last `solar_tail` rows
        are solar-pass points, which need only sigma and sun_v: the
        trunk, sigma and the sun head run over every row, the rgb, sky,
        beta and sem heads over the leading rows only."""
        cfg = self.cfg
        if heads is None:
            heads = ("rgb", "sun", "sky", "beta", "sem")
        nv = xyz.shape[0] - solar_tail  # the view rows: every head
        view = (lambda v: v[:nv]) if solar_tail else (lambda v: v)
        L = self.layer

        enc = self.encoding(xyz)
        if anneal is not None:
            enc = enc * torch.repeat_interleave(
                anneal.to(enc.dtype), cfg.hash_features)[None, :]
        x_in = enc
        if cfg.sem:
            labels = torch.where(sem_labels < 0, cfg.num_sem_classes,
                                 sem_labels)
            emb = embed_lookup(self.semantic_embedding, labels.long())
            x_in = torch.cat([x_in, emb.to(x_in.dtype)], dim=-1)

        h = F.relu(L("trunk0")(x_in))
        shared = F.relu(L("trunk1")(h))
        out = {"sigma": softplus(L("sigma")(shared).float())
               .to(shared.dtype)[..., 0]}
        if sigma_only:
            return out
        feats = None
        if {"rgb", "sun", "beta"} & set(heads):
            feats = L("feats")(shared)
        if "rgb" in heads:
            r = F.relu(L("rgb0")(view(feats)))
            out["rgb"] = (torch.sigmoid(L("rgb1")(r).float()) * 1.002
                          - 0.001).to(r.dtype)
        if "sun" in heads:
            s = F.relu(L("sun0")(feats, sun_d))
            s = F.relu(L("sun1")(s))
            out["sun_v"] = torch.sigmoid(L("sun2")(s))
        if "sky" in heads:
            k = F.relu(L("sky0")(view(sun_d)))
            out["sky"] = torch.sigmoid(L("sky1")(k))
        if cfg.beta and "beta" in heads:
            b = F.relu(L("beta0")(view(feats), view(t_emb)))
            out["beta"] = softplus(L("beta1")(b).float()).to(b.dtype)
        if cfg.sem and "sem" in heads:
            g = F.relu(L("sem0")(view(shared)))
            out["sem_logits"] = L("sem1")(g)
        return out


def init_hash_spnerf(generator, cfg: ModelConfig, compute_dtype=torch.float32,
                     device=None):
    """A freshly initialised hash field, drawn from `generator` (a CPU
    `torch.Generator`) and then moved to `device`."""
    from ..device import resolve_device

    device = resolve_device(device)
    return HashSPNeRF(cfg, compute_dtype, generator).to(device)
