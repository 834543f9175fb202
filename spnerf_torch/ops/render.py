"""The ray renderer: coarse samples (stratified, placed by the occupancy
grid, or placed by the proposal field), depth-guided resampling, the
solar-correction pass along the sun direction, and the hierarchical fine
pass. PyTorch version of the JAX package's `ops/render.py`.

The field is any callable `field_apply(xyz, sun_d, t_emb, sem_labels,
heads=None) -> dict` over flat (N, ...) point batches: an `SPNeRF` module or
a `FusedField`; `proposal_apply(xyz) -> sigma` is the proposal field's.

Four opt-in pass layouts, as in the JAX package (measured there and off by
default; the math is the same, the batching differs), each read from the
environment when `render_rays` is called:

* SPNERF_NO_MERGE=1 evaluates the field again at all the sorted guided
  samples instead of merging the coarse outputs in;
* SPNERF_NO_PRUNE=1 runs every head in the solar pass, and turns the two
  batched layouts off;
* SPNERF_BATCH_SC=1 evaluates the solar pass in one field call with the
  view-ray pass before it (the guided pass's new samples, or the coarse
  samples without guided sampling), every head on every row;
* SPNERF_BATCH_SOLAR=1 does the same with the solar rows pruned to sigma
  and sun_v in the model (its `solar_tail`), for a field callable that
  says it takes `solar_tail` (`supports_solar_tail`, the trainer's); the
  fine pass batches its view and solar points the same way.
"""

import os

import torch

from ..config import RenderConfig
from ..spans import span
from .compositing import composite
from .sampling import guided_samples, sample_pdf, stratified_z_vals


def _switch(name):
    """A pass-layout switch of the environment (see the module's doc)."""
    return os.environ.get(name) == "1"


def _batch_solar_enabled(field_apply):
    """SPNERF_BATCH_SOLAR=1 and a field that takes `solar_tail`."""
    return (getattr(field_apply, "supports_solar_tail", False)
            and _switch("SPNERF_BATCH_SOLAR"))


def _flat_inputs(n_rays, counts, sun_d, t_emb, sems):
    """Per-row sun directions, transient embeddings and labels for point
    sets of counts[i] samples a ray, set after set (each set ray-major)."""
    def rows(x):
        if x is None:
            return None
        parts = [x[:, None].expand((n_rays, s) + x.shape[1:])
                 .reshape((n_rays * s,) + x.shape[1:]) for s in counts]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
    return rows(sun_d), rows(t_emb), rows(sems)


def _eval_field(field_apply, rays_o, ray_dirs, z_vals, sun_d, t_emb, sems,
                heads=None):
    """The field at every (ray, sample) point; returns (R, S, ...) tensors."""
    return _eval_field_cat(field_apply, [_points(rays_o, ray_dirs, z_vals)],
                           sun_d, t_emb, sems, heads=heads)[0]


def _points(rays_o, ray_dirs, z_vals):
    """(R, S, 3) points at depths z_vals (R, S) along the rays."""
    return rays_o[:, None, :] + ray_dirs[:, None, :] * z_vals[:, :, None]


def _eval_field_cat(field_apply, xyz_sets, sun_d, t_emb, sems, heads=None):
    """One field call over the concatenation, ray by ray, of point sets
    (R, S_i, 3) that share the per-ray inputs; one (R, S_i, ...) dict a
    set."""
    n_rays = xyz_sets[0].shape[0]
    sizes = [x.shape[1] for x in xyz_sets]
    xyz = xyz_sets[0] if len(xyz_sets) == 1 else torch.cat(xyz_sets, dim=1)
    out = field_apply(xyz.reshape(-1, 3),
                      *_flat_inputs(n_rays, [sum(sizes)], sun_d, t_emb, sems),
                      heads=heads)
    out = {k: v.reshape((n_rays, sum(sizes)) + v.shape[1:])
           for k, v in out.items()}
    result, ofs = [], 0
    for n in sizes:
        result.append({k: v[:, ofs:ofs + n] for k, v in out.items()})
        ofs += n
    return result


def _eval_field_tail(field_apply, xyz_view, xyz_sc, sun_d, t_emb, sems):
    """One field call over view points (R, Sv, 3) and solar points
    (R, Ss, 3), the solar rows last and pruned in the model (`solar_tail`).
    Returns the view dict (R, Sv, ...) and the solar one (R, Ss, ...) of
    sigma and sun_v, all the solar terms read."""
    n_rays, sv = xyz_view.shape[:2]
    ss = xyz_sc.shape[1]
    xyz = torch.cat([xyz_view.reshape(-1, 3), xyz_sc.reshape(-1, 3)], dim=0)
    out = field_apply(xyz, *_flat_inputs(n_rays, [sv, ss], sun_d, t_emb, sems),
                      solar_tail=n_rays * ss)
    n_view = n_rays * sv
    view = {k: v[:n_view].reshape((n_rays, sv) + v.shape[1:])
            for k, v in out.items()}
    sc = {k: out[k][n_view:].reshape((n_rays, ss) + out[k].shape[1:])
          for k in ("sigma", "sun_v")}
    return view, sc


def _sort_perm(z_a, z_b):
    """The order that sorts the per-ray concatenation of two z sets:
    (order, z_sorted, z_unsorted). A stable sort, as the JAX package's
    argsort."""
    z_unsort = torch.cat([z_a, z_b], dim=-1)
    z_sorted, order = torch.sort(z_unsort, dim=-1, stable=True)
    return order, z_sorted, z_unsort


def _apply_perm(field_a, field_b, order):
    """The per-sample outputs of two passes, concatenated and gathered into
    sorted order (the JAX package applies the same permutation as a one-hot
    product). sem_logits stays in concatenation order: the compositor
    mean-pools it."""
    merged = {}
    for k in field_a:
        v = torch.cat([field_a[k], field_b[k]], dim=1)
        if k != "sem_logits":
            idx = order if v.ndim == 2 else order[..., None].expand_as(v)
            v = torch.take_along_dim(v, idx, dim=1)
        merged[k] = v
    return merged


def _merge_sorted(field_a, z_a, field_b, z_b):
    """Merge two per-sample field dicts along the sample axis in z order.

    The coarse pass's outputs are reused at their z positions rather than
    re-evaluated. Returns (merged, z_sorted, z_unsorted).
    """
    order, z_sorted, z_unsort = _sort_perm(z_a, z_b)
    return _apply_perm(field_a, field_b, order), z_sorted, z_unsort


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
                target_std=None, noise_std=0.0, generator=None, draws=None,
                fine_field_apply=None, proposal_apply=None, occ=None):
    """Render a batch of rays.

    rays: (R, 11) float32: origin 0:3, unit direction 3:6, near 6, far 7,
    sun direction 8:11. t_emb: (R, T) or None; sems: (R,) int or None.
    train: guided sampling also uses the target depths (valid_depth (R,),
    target_depths (R, 2), target_std (R,)). fine_field_apply: the fine
    pass's field (default `field_apply`), used when rc.n_importance > 0;
    proposal_apply: the proposal field, used when rc.proposal; occ: the
    occupancy grid, used when rc.occ_grid.

    Randomness, as the JAX renderer's keyed draws, uniform unless said:
    "strat" (R, S) the stratified jitter, or the occupancy grid's
    inverse-CDF draws, or (R, n_proposal) the proposal samples' jitter;
    "prop_pdf" (R, S) the draws that place the main samples by the
    proposal's weights; the guided pass's "u_pred" and "u_gt" (R, S);
    "pdf" (R, n_importance) the fine samples' draws; and the standard
    normal sigma noise "noise0" (R, S), "noise1" and "sc_noise" (R, 2S),
    "noise_fine" and "sc_noise_fine" (R, S' + n_importance), scaled by
    noise_std (drawn only when noise_std != 0). They come from `generator`
    (a torch.Generator on the rays' device) or from `draws`, a dict of
    tensors by those names. With neither the render is deterministic, as
    the JAX renderer with key=None.

    Returns `_coarse`-suffixed per-ray and per-sample tensors, as the JAX
    renderer does: rgb_coarse (R,3), depth_coarse (R,), weights_coarse,
    z_vals_coarse, z_vals_unsort_coarse, weights_sc_coarse, sun_sc_coarse,
    [z_prop_coarse, w_prop_coarse]; and the same `_fine`-suffixed with a
    fine pass.
    """
    if fine_field_apply is None:
        fine_field_apply = field_apply
    rnd = _Draws(rays.device, generator, draws)
    noisy = noise_std != 0.0
    rays_o, rays_d = rays[:, 0:3], rays[:, 3:6]
    near, far = rays[:, 6:7], rays[:, 7:8]
    sun_d = rays[:, 8:11]
    n_rays, n_samples = rays.shape[0], rc.n_samples
    det = rc.perturb == 0.0

    prop_extras = {}
    if rc.proposal and proposal_apply is not None:
        # the density-only proposal pass places the main samples
        from .proposal import density_weights, resample_from_weights

        u = (rnd.uniform("strat", (n_rays, rc.n_proposal))
             if rc.perturb > 0 else None)
        z_prop = stratified_z_vals(near, far, rc.n_proposal, rc.perturb, u=u)
        xyz_prop = rays_o[:, None, :] + rays_d[:, None, :] * z_prop[:, :, None]
        sigmas_prop = proposal_apply(xyz_prop.reshape(-1, 3)).reshape(
            z_prop.shape)
        w_prop = density_weights(sigmas_prop, z_prop)
        u = None if det else rnd.uniform("prop_pdf", (n_rays, n_samples))
        z_vals = resample_from_weights(z_prop, w_prop, n_samples, det=det,
                                       u=u)
        prop_extras = {"z_prop": z_prop, "w_prop": w_prop}
    elif rc.occ_grid and occ is not None:
        # the coarse budget drawn from depth bins weighted by the grid
        from .occgrid import occ_z_vals

        u = None if det else rnd.uniform("strat", (n_rays, n_samples))
        z_vals = occ_z_vals(occ, rays_o, rays_d, near, far, n_samples,
                            rc.occ_res, n_bins=rc.occ_bins,
                            floor=rc.occ_floor, det=det,
                            frames=rc.occ_frames, u=u)
    else:
        u = (rnd.uniform("strat", (n_rays, n_samples))
             if rc.perturb > 0 else None)
        z_vals = stratified_z_vals(near, far, n_samples, rc.perturb, u=u)
    # the pass layouts (see the module's doc): the solar pass evaluates the
    # field at rays_o + sun_d * z over the final z set, which is known
    # before the last view-ray field call (after the guided pass, from the
    # coarse composite and the sort alone), so the two can share one call
    no_prune = _switch("SPNERF_NO_PRUNE")
    batch_solar = (rc.solar_correction and not no_prune
                   and _batch_solar_enabled(field_apply))
    batch_sc = (rc.solar_correction and _switch("SPNERF_BATCH_SC")
                and not no_prune and not batch_solar)
    sc_field = None  # the solar pass's sigma and sun_v, when batched
    if rc.guidedsample or not (batch_sc or batch_solar):
        field1 = _eval_field(field_apply, rays_o, rays_d, z_vals, sun_d,
                             t_emb, sems)
    elif batch_solar:
        field1, sc_field = _eval_field_tail(
            field_apply, _points(rays_o, rays_d, z_vals),
            _points(rays_o, sun_d, z_vals), sun_d, t_emb, sems)
    else:
        field1, sc_field = _eval_field_cat(
            field_apply, [_points(rays_o, rays_d, z_vals),
                          _points(rays_o, sun_d, z_vals)], sun_d, t_emb, sems)
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
        if _switch("SPNERF_NO_MERGE"):
            # every sorted sample through the field again
            z_vals_unsort = torch.cat([z_vals, z_vals_2], dim=-1)
            z_vals = torch.sort(z_vals_unsort, dim=-1).values
            noise = rnd.normal("noise1", z_vals.shape) if noisy else None
            result = _inference(field_apply, rays_o, rays_d, z_vals, sun_d,
                                t_emb, sems, noise_std=noise_std, noise=noise)
        else:
            order, z_sorted, z_vals_unsort = _sort_perm(result["z_vals"],
                                                        z_vals_2)
            xyz2 = _points(rays_o, rays_d, z_vals_2)
            if batch_solar:
                field2, sc_field = _eval_field_tail(
                    field_apply, xyz2, _points(rays_o, sun_d, z_sorted),
                    sun_d, t_emb, sems)
            elif batch_sc:
                field2, sc_field = _eval_field_cat(
                    field_apply, [xyz2, _points(rays_o, sun_d, z_sorted)],
                    sun_d, t_emb, sems)
            else:
                # the field only at the new samples; the coarse outputs are
                # merged in by the sort permutation
                field2 = _eval_field(field_apply, rays_o, rays_d, z_vals_2,
                                     sun_d, t_emb, sems)
            field_all = _apply_perm(field1, field2, order)
            z_vals = z_sorted
            noise = rnd.normal("noise1", z_vals.shape) if noisy else None
            result = composite(field_all, z_vals, noise_std=noise_std,
                               noise=noise)
        result["z_vals_unsort"] = z_vals_unsort

    sc_heads = None if no_prune else ("sun",)
    if rc.solar_correction:
        # the solar terms consume only sigma and sun_v: prune the other heads
        with span("render.solar"):
            noise = rnd.normal("sc_noise", z_vals.shape) if noisy else None
            if sc_field is not None:
                sc_field = {k: sc_field[k] for k in ("sigma", "sun_v")}
                sc = composite(sc_field, z_vals, noise_std=noise_std,
                               noise=noise)
            else:
                sc = _inference(field_apply, rays_o, sun_d, z_vals, sun_d,
                                t_emb, sems, heads=sc_heads,
                                noise_std=noise_std, noise=noise)
        result["weights_sc"] = sc["weights"]
        result["transparency_sc"] = sc["transparency"]
        result["sun_sc"] = sc["sun"]

    out = {f"{k}_coarse": v for k, v in result.items()}
    out.update({f"{k}_coarse": v for k, v in prop_extras.items()})

    if rc.n_importance > 0:
        # the hierarchical fine pass: an inverse CDF of the coarse weights,
        # merged with the coarse samples, through the fine field
        z_mid = 0.5 * (z_vals[:, :-1] + z_vals[:, 1:])
        u = None if det else rnd.uniform("pdf", (n_rays, rc.n_importance))
        z_extra = sample_pdf(z_mid, out["weights_coarse"][:, 1:-1],
                             rc.n_importance, det=det, u=u).detach()
        z_fine = torch.sort(torch.cat([z_vals, z_extra], dim=-1),
                            dim=-1).values
        sc_f = None
        if (rc.solar_correction and not no_prune
                and _batch_solar_enabled(fine_field_apply)):
            # the fine view and solar points both follow from z_fine
            fine_field, sc_f = _eval_field_tail(
                fine_field_apply, _points(rays_o, rays_d, z_fine),
                _points(rays_o, sun_d, z_fine), sun_d, t_emb, sems)
        noise = rnd.normal("noise_fine", z_fine.shape) if noisy else None
        if sc_f is None:
            fine = _inference(fine_field_apply, rays_o, rays_d, z_fine, sun_d,
                              t_emb, sems, noise_std=noise_std, noise=noise)
        else:
            fine = composite(fine_field, z_fine, noise_std=noise_std,
                             noise=noise)
        if rc.solar_correction:
            with span("render.solar"):
                noise = (rnd.normal("sc_noise_fine", z_fine.shape) if noisy
                         else None)
                if sc_f is None:
                    sc = _inference(fine_field_apply, rays_o, sun_d, z_fine,
                                    sun_d, t_emb, sems, heads=sc_heads,
                                    noise_std=noise_std, noise=noise)
                else:
                    sc = composite(sc_f, z_fine, noise_std=noise_std,
                                   noise=noise)
            fine["weights_sc"] = sc["weights"]
            fine["transparency_sc"] = sc["transparency"]
            fine["sun_sc"] = sc["sun"]
        out.update({f"{k}_fine": v for k, v in fine.items()})
    return out
