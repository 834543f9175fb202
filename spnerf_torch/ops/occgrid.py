"""Occupancy-grid guided coarse sampling (--occgrid): the PyTorch version of
the JAX package's `ops/occgrid.py`.

A density cache: one flat (frames * res^3,) float32 grid of densities,
updated as an EMA-max over one contiguous slab of `rows` cells a step at a
rotating offset, so every cell is refreshed once every
frames * res^3 / rows steps. The coarse samples are then drawn by inverse
CDF over `occ_bins` depth bins per ray, each weighted by the grid at its
centre plus a uniform floor: the same static sample count, placed where
density lives. Sample placement carries no gradient.

Multi-AOI: frame k's scene box is translated to x in [k*S - 1, k*S + 1]
(S = FRAME_SPACING); the grid holds one res^3 block per frame and
decomposes points by the hash encoding's rule, round(x / S).

Randomness is passed in: `update_grid` takes its in-cell jitter `u` and
`occ_z_vals` its inverse-CDF draws from the caller.
"""

import torch

from ..data.multi import FRAME_SPACING
from .sampling import sample_pdf


def init_grid(res, frames=1, device=None):
    """All-ones grid: until the sweep visits a cell, its bins sample
    uniformly (the stratified prior)."""
    return torch.ones(frames * res ** 3, dtype=torch.float32, device=device)


def _cell_centers01(lin, res):
    """Local flat cell index -> (M, 3) integer cell coordinates, x-major:
    lin = (ix * res + iy) * res + iz (as `_lookup_lin`)."""
    ix = torch.div(lin, res * res, rounding_mode="floor")
    iy = torch.div(lin, res, rounding_mode="floor") % res
    iz = lin % res
    return torch.stack([ix, iy, iz], dim=-1)


def frame_decompose(xyz, frames):
    """(..., 3) global points -> (frame index (...,) int64, the points moved
    into their frame's box): frame round(x / FRAME_SPACING) clipped to
    [0, frames - 1], the rule of the hash encoding and of the grid."""
    fidx = torch.clamp(torch.round(xyz[..., 0] / FRAME_SPACING), 0,
                       frames - 1)
    local = xyz - torch.stack(
        [fidx * FRAME_SPACING, torch.zeros_like(fidx), torch.zeros_like(fidx)],
        dim=-1)
    return fidx.long(), local


def _lookup_lin(xyz, res, frames=1):
    """(..., 3) points -> flat nearest-cell indices (int64) into the
    (frames * res^3,) grid: frame-major, x-major within a frame."""
    if frames > 1:
        fidx, xyz = frame_decompose(xyz, frames)
    x01 = torch.clamp((xyz + 1.0) * 0.5, 0.0, 1.0)
    cell = torch.clamp_max(torch.floor(x01 * res), res - 1).long()
    lin = (cell[..., 0] * res + cell[..., 1]) * res + cell[..., 2]
    if frames > 1:
        lin = lin + fidx * res ** 3
    return lin


def slab_rows(res, rows, frames=1):
    """`rows` snapped down to the largest divisor of the cell count (at
    least 1, at most the cell count), so that the slabs tile the grid."""
    n_cells = frames * res ** 3
    rows = min(max(int(rows), 1), n_cells)
    while n_cells % rows:
        rows -= 1
    return rows


@torch.no_grad()
def update_grid(occ, sigma_fn, u, step, res, rows, decay, frames=1):
    """One slab-sweep EMA update of `occ`, in place; returns it.

    The slab is the `rows` cells from (step mod n_slabs) * rows on, each
    sampled at its jittered point (cell + u) / res mapped to [-1, 1] and
    moved into its frame. sigma_fn: (M, 3) global points -> (M,) density;
    u: (rows, 3) uniform jitter in [0, 1); rows must divide
    frames * res^3. new[cell] = max(decay * old[cell], sigma(point)).
    """
    n_cells = frames * res ** 3
    if n_cells % rows:
        raise ValueError(f"{rows} rows do not tile {n_cells} cells")
    off = (int(step) % (n_cells // rows)) * rows
    lin = off + torch.arange(rows, device=u.device)
    fidx = torch.div(lin, res ** 3, rounding_mode="floor")
    cell = _cell_centers01(lin % res ** 3, res)
    xyz = ((cell.float() + u) / res) * 2.0 - 1.0
    if frames > 1:
        xyz[:, 0] += fidx.float() * FRAME_SPACING
    sigma = sigma_fn(xyz).float()
    occ[off:off + rows] = torch.maximum(occ[off:off + rows] * decay, sigma)
    return occ


@torch.no_grad()
def occ_z_vals(occ, rays_o, rays_d, near, far, n_samples, res, n_bins=128,
               floor=0.01, det=False, frames=1, u=None):
    """Grid-weighted coarse samples: (R, n_samples) ascending z values.

    `n_bins` linear depth bins per ray are weighted by the grid at their
    centres (normalized per ray to its max), plus a uniform exploration
    floor so that no bin starves; the samples are an inverse CDF of those
    weights. u: (R, n_samples) uniform draws, or None (with `det`) for
    evenly spaced quantiles.
    """
    near = near[:, None] if near.dim() == 1 else near
    far = far[:, None] if far.dim() == 1 else far
    t = torch.linspace(0.0, 1.0, n_bins + 1, dtype=rays_o.dtype,
                       device=rays_o.device)
    z_edges = near * (1.0 - t) + far * t  # (R, K+1)
    z_mid = 0.5 * (z_edges[:, :-1] + z_edges[:, 1:])  # (R, K)
    xyz = rays_o[:, None, :] + rays_d[:, None, :] * z_mid[:, :, None]
    w = occ[_lookup_lin(xyz, res, frames).reshape(-1)].reshape(z_mid.shape)
    w = w / (torch.amax(w, dim=-1, keepdim=True) + 1e-12) + floor
    z = sample_pdf(z_edges, w, n_samples, det=det, u=u)
    # compositing needs ascending z (the train draws are unordered)
    return torch.sort(z, dim=-1).values
