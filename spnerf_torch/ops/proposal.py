"""Proposal-network sampling (mip-NeRF 360 style): the PyTorch version of
the JAX package's `ops/proposal.py`.

A small density-only field places the main field's samples, trained with
the interlevel loss so that its weight histogram bounds the main field's
from above:

* `density_weights`: sigma -> compositing weights (no colour);
* `resample_from_weights`: inverse-CDF draw of the main samples;
* `interlevel_loss`: the outer-measure bound, through cumulative weights
  looked up with `torch.searchsorted` and `torch.gather` (the JAX package
  uses masked sums, a TPU device for avoiding gathers); its gradient
  reaches the proposal's weights only.
"""

import torch
import torch.nn.functional as F

from .sampling import sample_pdf


def density_weights(sigmas, z_vals):
    """sigma (R, S), z_vals (R, S) -> compositing weights (R, S), the
    discretization of `ops.compositing.composite`."""
    deltas = z_vals[:, 1:] - z_vals[:, :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[:, :1], 1e10)], -1)
    alphas = 1.0 - torch.exp(-deltas * F.relu(sigmas))
    shifted = torch.cat(
        [torch.ones_like(alphas[:, :1]), 1.0 - alphas + 1e-10], -1)
    trans = torch.cumprod(shifted, dim=-1)[:, :-1]
    return alphas * trans


def resample_from_weights(z_vals, weights, n_samples, det=False, u=None):
    """n_samples draws from the histogram on the z_vals midpoints, sorted
    ascending and detached. u: (R, n_samples) uniform draws or None."""
    z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
    z = sample_pdf(z_mid, weights[:, 1:-1], n_samples, det=det, u=u)
    return torch.sort(z.detach(), dim=-1).values


def _cum_weight_at(t_edges, w, t_query):
    """The piecewise-linear CDF of the histogram (t_edges (R, S+1),
    w (R, S)) at t_query (R, Q): the whole bins left of the query plus the
    part of the bin it lands in."""
    cw = torch.cat([torch.zeros_like(w[:, :1]), torch.cumsum(w, dim=-1)],
                   dim=-1)  # (R, S+1)
    idx = torch.searchsorted(t_edges.contiguous(), t_query.contiguous(),
                             right=True)
    s = w.shape[-1]
    lo = torch.clamp(idx - 1, 0, s - 1)
    left_edge = torch.gather(t_edges, 1, lo)
    right_edge = torch.gather(t_edges, 1, torch.clamp(idx, 1, s))
    frac = torch.where(
        right_edge > left_edge,
        torch.clamp((t_query - left_edge)
                    / torch.clamp_min(right_edge - left_edge, 1e-12),
                    0.0, 1.0),
        torch.ones_like(t_query))
    out = torch.gather(cw, 1, lo) + frac * torch.gather(w, 1, lo)
    out = torch.where(t_query <= t_edges[:, :1], torch.zeros_like(out), out)
    return torch.where(t_query >= t_edges[:, -1:], cw[:, -1:], out)


def interlevel_loss(prop_z, prop_weights, main_z, main_weights, eps=1e-3):
    """The proposal loss: the main weights over each main interval above
    the proposal's mass over the same interval.

    prop_z, prop_weights: (R, Sp); main_z, main_weights: (R, Sm). Intervals
    lie between successive samples (midpoint edges, as the compositing
    discretization). The main weights and z are detached.
    """
    main_w = main_weights.detach()

    def edges(z):
        mid = 0.5 * (z[:, :-1] + z[:, 1:])
        return torch.cat([z[:, :1], mid, z[:, -1:]], dim=-1)

    pe = edges(prop_z.detach())  # (R, Sp+1)
    me = edges(main_z.detach())  # (R, Sm+1)
    cdf_lo = _cum_weight_at(pe, prop_weights, me[:, :-1])
    cdf_hi = _cum_weight_at(pe, prop_weights, me[:, 1:])
    bound = cdf_hi - cdf_lo  # proposal mass over each main interval
    excess = torch.clamp_min(main_w - bound, 0.0)
    return torch.mean(torch.sum(excess ** 2 / (main_w + eps), dim=-1))
