"""Ray sampling: stratified, inverse-CDF, and depth-guided 3-sigma.

PyTorch versions of the JAX package's `ops/sampling.py`. Randomness is passed
in: every sampler takes its uniform draws `u` from the caller (None selects
the deterministic variant), so a test can hand the JAX and PyTorch versions
the same numbers.
"""

import math

import torch

INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def stratified_z_vals(near, far, n_samples, perturb=1.0, u=None):
    """Linear-in-depth samples, jittered inside their strata by `u`.

    near, far: (R, 1); u: (R, n_samples) or None; returns (R, n_samples).
    """
    z_steps = torch.linspace(0.0, 1.0, n_samples, dtype=near.dtype,
                             device=near.device)
    z_vals = near * (1.0 - z_steps) + far * z_steps
    if perturb > 0 and u is not None:
        z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
        upper = torch.cat([z_mid, z_vals[:, -1:]], dim=-1)
        lower = torch.cat([z_vals[:, :1], z_mid], dim=-1)
        z_vals = lower + (upper - lower) * (perturb * u)
    return z_vals


def sample_pdf(bins, weights, n_importance, det=False, u=None, eps=1e-5):
    """Inverse-CDF sampling of `n_importance` points per ray.

    bins: (R, M+1) edges; weights: (R, M); u: (R, n_importance) draws, used
    unless `det` or u is None (then evenly spaced). Returns (R, n_importance).
    """
    n_rays, m = weights.shape
    weights = weights + eps
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)

    if det or u is None:
        u = torch.linspace(0.0, 1.0, n_importance, dtype=bins.dtype,
                           device=bins.device).expand(n_rays, n_importance)
    u = u.contiguous()
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(inds - 1, 0, m)
    above = torch.clamp(inds, 0, m)
    cdf_lo = torch.take_along_dim(cdf, below, dim=1)
    cdf_hi = torch.take_along_dim(cdf, above, dim=1)
    bin_lo = torch.take_along_dim(bins, below, dim=1)
    bin_hi = torch.take_along_dim(bins, above, dim=1)

    denom = cdf_hi - cdf_lo
    denom = torch.where(denom < eps, torch.ones_like(denom), denom)
    return bin_lo + (u - cdf_lo) / denom * (bin_hi - bin_lo)


def sample_3sigma(low_3sigma, high_3sigma, n, det, near, far, u=None):
    """Gaussian-shaped sampling between per-ray [low, high] bounds clamped to
    [near, far]. low_3sigma, high_3sigma: (R,); near, far: scalars or (R,).
    Returns (R, n)."""
    dt, dev = low_3sigma.dtype, low_3sigma.device
    near = torch.as_tensor(near, dtype=dt, device=dev).expand(low_3sigma.shape)
    far = torch.as_tensor(far, dtype=dt, device=dev).expand(low_3sigma.shape)
    t_vals = torch.linspace(0.0, 1.0, n, dtype=dt, device=dev)
    step_size = (high_3sigma - low_3sigma) / (n - 1)
    edges = (low_3sigma[:, None] * (1.0 - t_vals)
             + high_3sigma[:, None] * t_vals)
    bin_edges = torch.minimum(torch.maximum(edges, near[:, None]), far[:, None])
    # guard zero-width ranges so masked-out rays stay finite
    safe_step = torch.where(torch.abs(step_size) < 1e-12,
                            torch.ones_like(step_size), step_size)
    factor = (bin_edges[:, 1:] - bin_edges[:, :-1]) / safe_step[:, None]
    x = torch.linspace(-3.0, 3.0, n - 1, dtype=dt, device=dev)
    gauss = INV_SQRT_2PI * torch.exp(-0.5 * x ** 2)
    return sample_pdf(bin_edges, factor * gauss[None, :], n, det=det, u=u)


def compute_samples_around_depth(depth, weights, z_vals, n_samples, det, near,
                                 far, u=None):
    """Resample within 3 sigma of the predicted depth distribution.
    depth: (R,); weights, z_vals: (R, S)."""
    std = torch.sqrt(torch.sum((z_vals - depth[:, None]) ** 2 * weights,
                               dim=-1))
    return sample_3sigma(depth - 3.0 * std, depth + 3.0 * std, n_samples, det,
                         near, far, u=u)


def guided_samples(pred_depth, pred_weights, z_vals, n_samples, det, near, far,
                   train, valid_depth=None, target_depth=None,
                   target_std=None, u_pred=None, u_gt=None):
    """Depth-guided sampling: around the predicted depth, and in training,
    for rays with valid stereo depth, around the target depth's 3-sigma
    interval instead. u_pred and u_gt are the two passes' draws.

    Returns (R, n_samples) z values; callers detach them.
    """
    z_pred = compute_samples_around_depth(pred_depth, pred_weights, z_vals,
                                          n_samples, det, near, far, u=u_pred)
    if not train:
        return z_pred
    if valid_depth is None or target_depth is None:
        raise ValueError("train=True needs valid_depth and target_depth")
    valid = valid_depth > 0
    dt, dev = pred_depth.dtype, pred_depth.device
    mid = torch.as_tensor(0.5 * (near + far), dtype=dt,
                          device=dev).expand(pred_depth.shape)
    safe_depth = torch.where(valid, target_depth, mid)
    safe_std = torch.where(valid, torch.clamp_min(target_std, 1e-12),
                           torch.ones_like(target_std))
    z_gt = sample_3sigma(safe_depth - 3.0 * safe_std,
                         safe_depth + 3.0 * safe_std, n_samples, det, near,
                         far, u=u_gt)
    return torch.where(valid[:, None], z_gt, z_pred)
