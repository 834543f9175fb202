"""Volume compositing: sigma -> alpha -> transmittance -> weights -> rgb and
depth, with the S-NeRF irradiance sun_v + (1 - sun_v) * sky. PyTorch version
of the JAX package's `ops/compositing.py`."""

import torch


def composite(field_out, z_vals, noise_std=0.0, noise=None):
    """Composite per-sample field outputs along rays.

    field_out: per-sample tensors (R, S, ...): sigma (R,S), and where present
    rgb (R,S,3), sun_v (R,S,1), sky (R,S,3), beta (R,S,1), sem_logits (R,S,C).
    z_vals: (R, S) sorted sample depths. noise: optional standard-normal
    draws (R, S) scaled by noise_std and added to sigma.

    Returns rgb (R,3), depth (R,), weights, transparency and z_vals (R,S),
    albedo, sun, sky (per sample), [beta], [sem_logits (R,C) mean-pooled].
    """
    sigmas = field_out["sigma"].float()
    z_vals = z_vals.float()

    deltas = z_vals[:, 1:] - z_vals[:, :-1]
    deltas = torch.cat([deltas, torch.full_like(deltas[:, :1], 1e10)], dim=-1)
    if noise is not None and noise_std != 0.0:
        sigmas = sigmas + noise * noise_std
    alphas = 1.0 - torch.exp(-deltas * torch.relu(sigmas))

    shifted = torch.cat([torch.ones_like(alphas[:, :1]), 1.0 - alphas + 1e-10],
                        dim=-1)
    transparency = torch.cumprod(shifted, dim=-1)[:, :-1]
    weights = alphas * transparency

    result = {
        "depth": torch.sum(weights * z_vals, dim=-1),
        "weights": weights,
        "transparency": transparency,
        "z_vals": z_vals,
    }
    # head-pruned evaluations (the solar pass) composite what they carry
    if "sun_v" in field_out:
        result["sun"] = field_out["sun_v"].float()
    if "rgb" in field_out:
        if "sun" not in result:
            raise ValueError("composite() with an 'rgb' head requires 'sun_v' "
                             "(irradiance = sun_v + (1 - sun_v) * sky)")
        rgbs = field_out["rgb"].float()
        sun_v = result["sun"]
        sky = field_out["sky"].float()
        irradiance = sun_v + (1.0 - sun_v) * sky
        rgb = torch.sum(weights[..., None] * rgbs * irradiance, dim=-2)
        result["rgb"] = torch.clamp(rgb, 0.0, 1.0)
        result["albedo"] = rgbs
        result["sky"] = sky
    if "beta" in field_out:
        result["beta"] = field_out["beta"].float()
    if "sem_logits" in field_out:
        # mean over samples, not weight-composited (the reference's choice)
        result["sem_logits"] = torch.mean(field_out["sem_logits"].float(),
                                          dim=1)
    return result
