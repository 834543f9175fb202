"""The ray renderer: coarse stratified pass, depth-guided resampling, and the
solar-correction pass along the sun direction. PyTorch version of the JAX
package's `ops/render.py`.

The field is any callable `field_apply(xyz, sun_d, t_emb, sem_labels,
heads=None) -> dict` over flat (N, ...) point batches: an `SPNeRF` module or
a `FusedField`.

Not ported yet (they raise NotImplementedError): the fine pass
(`n_importance > 0`), the proposal sampler, the occupancy grid, and the
JAX package's opt-in pass layouts SPNERF_BATCH_SC, SPNERF_BATCH_SOLAR and
SPNERF_NO_MERGE.
"""

import os

import torch

from ..config import RenderConfig
from .compositing import composite
from .sampling import guided_samples, stratified_z_vals

_UNPORTED_ENV = ("SPNERF_BATCH_SC", "SPNERF_BATCH_SOLAR", "SPNERF_NO_MERGE")


def check_supported(rc: RenderConfig):
    """Raise NotImplementedError for render paths this port lacks."""
    for flag in ("n_importance", "proposal", "occ_grid"):
        if getattr(rc, flag):
            raise NotImplementedError(f"render_rays: {flag} is not ported yet")
    for name in _UNPORTED_ENV:
        if os.environ.get(name) == "1":
            raise NotImplementedError(f"render_rays: {name}=1 is not ported")


def _eval_field(field_apply, rays_o, ray_dirs, z_vals, sun_d, t_emb, sems,
                heads=None):
    """The field at every (ray, sample) point; returns (R, S, ...) tensors."""
    n_rays, n_samples = z_vals.shape
    xyz = rays_o[:, None, :] + ray_dirs[:, None, :] * z_vals[:, :, None]
    sun_flat = sun_d[:, None, :].expand(n_rays, n_samples, 3).reshape(-1, 3)
    t_flat = (None if t_emb is None else
              t_emb[:, None, :].expand(n_rays, n_samples, t_emb.shape[-1])
              .reshape(-1, t_emb.shape[-1]))
    sem_flat = (None if sems is None else
                sems[:, None].expand(n_rays, n_samples).reshape(-1))
    out = field_apply(xyz.reshape(-1, 3), sun_flat, t_flat, sem_flat,
                      heads=heads)
    return {k: v.reshape((n_rays, n_samples) + v.shape[1:])
            for k, v in out.items()}


def _merge_sorted(field_a, z_a, field_b, z_b):
    """Merge two per-sample field dicts along the sample axis in z order.

    The coarse pass's outputs are reused at their z positions rather than
    re-evaluated. A stable sort and a gather apply the permutation exactly;
    sem_logits stays in concatenation order because the compositor
    mean-pools it. Returns (merged, z_sorted, z_unsorted).
    """
    z_unsort = torch.cat([z_a, z_b], dim=-1)
    z_sorted, order = torch.sort(z_unsort, dim=-1, stable=True)
    merged = {}
    for k in field_a:
        v = torch.cat([field_a[k], field_b[k]], dim=1)
        if k != "sem_logits":
            idx = order if v.ndim == 2 else order[..., None].expand_as(v)
            v = torch.take_along_dim(v, idx, dim=1)
        merged[k] = v
    return merged, z_sorted, z_unsort


def _inference(field_apply, rays_o, ray_dirs, z_vals, sun_d, t_emb, sems,
               heads=None, noise_std=0.0, noise=None):
    field_out = _eval_field(field_apply, rays_o, ray_dirs, z_vals, sun_d,
                            t_emb, sems, heads=heads)
    return composite(field_out, z_vals, noise_std=noise_std, noise=noise)


class _Draws:
    """The renderer's random numbers, by name: from `draws` (a dict a test
    fills; a missing name is no draw) or from `generator` on the rays'
    device; with neither, no draws and a deterministic render."""

    def __init__(self, device, generator=None, draws=None):
        self.device = device
        self.generator = generator
        self.draws = draws

    def uniform(self, name, shape):
        return self._get(name, shape, torch.rand)

    def normal(self, name, shape):
        return self._get(name, shape, torch.randn)

    def _get(self, name, shape, fn):
        if self.draws is not None:
            return self.draws.get(name)
        if self.generator is None:
            return None
        return fn(shape, generator=self.generator, device=self.device,
                  dtype=torch.float32)


def render_rays(field_apply, rc: RenderConfig, rays, t_emb=None, sems=None,
                train=False, valid_depth=None, target_depths=None,
                target_std=None, noise_std=0.0, generator=None, draws=None):
    """Render a batch of rays.

    rays: (R, 11) float32: origin 0:3, unit direction 3:6, near 6, far 7,
    sun direction 8:11. t_emb: (R, T) or None; sems: (R,) int or None.
    train: guided sampling also uses the target depths (valid_depth (R,),
    target_depths (R, 2), target_std (R,)).

    Randomness, as the JAX renderer's keyed draws: the stratified jitter
    "strat" (R, S) uniform; the guided pass's "u_pred" and "u_gt" (R, S)
    uniform; the sigma noise "noise0" (R, S), "noise1" and "sc_noise"
    (R, 2S) standard normal, scaled by noise_std (drawn only when
    noise_std != 0). They come from `generator` (a torch.Generator on the
    rays' device) or from `draws`, a dict of tensors by those names. With
    neither the render is deterministic, as the JAX renderer with key=None.

    Returns `_coarse`-suffixed per-ray and per-sample tensors, as the JAX
    renderer does: rgb_coarse (R,3), depth_coarse (R,), weights_coarse,
    z_vals_coarse, z_vals_unsort_coarse, weights_sc_coarse, sun_sc_coarse...
    """
    check_supported(rc)
    rnd = _Draws(rays.device, generator, draws)
    noisy = noise_std != 0.0
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]
    sun_d = rays[:, 8:11]
    n_rays, n_samples = rays.shape[0], rc.n_samples
    det = rc.perturb == 0.0

    u = rnd.uniform("strat", (n_rays, n_samples)) if rc.perturb > 0 else None
    z_vals = stratified_z_vals(near, far, n_samples, rc.perturb, u=u)
    field1 = _eval_field(field_apply, rays_o, rays_d, z_vals, sun_d, t_emb,
                         sems)
    noise = rnd.normal("noise0", z_vals.shape) if noisy else None
    result = composite(field1, z_vals, noise_std=noise_std, noise=noise)

    if rc.guidedsample:
        u_pred = u_gt = None
        if not det:
            u_pred = rnd.uniform("u_pred", (n_rays, n_samples))
            if train:
                u_gt = rnd.uniform("u_gt", (n_rays, n_samples))
        z_vals_2 = guided_samples(
            result["depth"], result["weights"], z_vals, n_samples,
            det=det, near=near[:, 0], far=far[:, 0],
            train=train, valid_depth=valid_depth,
            target_depth=None if target_depths is None else target_depths[:, 0],
            target_std=target_std, u_pred=u_pred, u_gt=u_gt)
        z_vals_2 = torch.sort(z_vals_2, dim=-1).values.detach()
        # evaluate the field only at the new samples; the coarse outputs are
        # merged in by the sort permutation
        field2 = _eval_field(field_apply, rays_o, rays_d, z_vals_2, sun_d,
                             t_emb, sems)
        field_all, z_vals, z_vals_unsort = _merge_sorted(
            field1, result["z_vals"], field2, z_vals_2)
        noise = rnd.normal("noise1", z_vals.shape) if noisy else None
        result = composite(field_all, z_vals, noise_std=noise_std,
                           noise=noise)
        result["z_vals_unsort"] = z_vals_unsort

    if rc.solar_correction:
        # the solar terms consume only sigma and sun_v: prune the other heads
        noise = rnd.normal("sc_noise", z_vals.shape) if noisy else None
        sc = _inference(field_apply, rays_o, sun_d, z_vals, sun_d, t_emb, sems,
                        heads=("sun",), noise_std=noise_std, noise=noise)
        result["weights_sc"] = sc["weights"]
        result["transparency_sc"] = sc["transparency"]
        result["sun_sc"] = sc["sun"]

    return {f"{k}_coarse": v for k, v in result.items()}
