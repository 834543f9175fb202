"""Whole-image eval rendering: the counterpart of the JAX package's
`Trainer.build_render_fn` and `Trainer._lean_eval_outputs`.

Rays are rendered in chunks of at most `MAX_POINTS // samples_per_ray` rays
(at least 1024), the last chunk padded by repeating the last ray. The field
runs through the fused CUDA kernel whenever the configuration is covered and
the model lies on a CUDA device, as the JAX package uses its fused kernel on
every accelerator. Lean outputs composite the per-sample sun, albedo, sky
and beta on the device and drop the per-sample tensors.

The JAX package's machinery for its remote TPU (chunks grouped per dispatch,
a depth-2 dispatch pipeline, a device mesh) is not ported: chunks here are
launched in turn on the current CUDA stream.
"""

import torch

from .ops.field_eval import FusedField, PlainField, pack_params, supports_config
from .ops.render import check_supported, render_rays

EVAL_DROP = ("weights", "transparency", "z_vals", "z_vals_unsort",
             "weights_sc", "transparency_sc", "sun_sc", "z_prop", "w_prop")


def lean_eval_outputs(out):
    """Per-ray outputs only: per-sample sun/albedo/sky/beta are composited
    with the weights, and the per-sample tensors are dropped."""
    out = dict(out)
    for typ in ("coarse", "fine"):
        wk = f"weights_{typ}"
        if wk not in out:
            continue
        w = out[wk][..., None]
        for key in ("sun", "albedo", "sky", "beta"):
            k = f"{key}_{typ}"
            if k in out and out[k].ndim == 3:
                out[k] = torch.sum(w * out[k], dim=-2)
    drop = {f"{name}_{typ}" for name in EVAL_DROP for typ in ("coarse", "fine")}
    return {k: v for k, v in out.items() if k not in drop}


MAX_POINTS = 1_500_000  # field points per chunk


def chunk_size(rc, chunk=40960):
    """Rays per chunk: rays x samples stays under MAX_POINTS, floor 1024."""
    samples_per_ray = rc.n_samples * (2 if rc.guidedsample else 1)
    samples_per_ray += rc.n_importance
    if rc.solar_correction:
        samples_per_ray *= 2
    return max(min(chunk, MAX_POINTS // max(samples_per_ray, 1)), 1024)


def build_render_fn(model, rc, t_embed=None, chunk=40960, field=None):
    """Whole-image renderer over `model` (an `SPNeRF` on its device).

    field: None evaluates the field through the fused kernel on CUDA (when
    the configuration is covered) and through the module on the CPU;
    "plain" uses the fused field's plain version on any device.

    Returns render_image(rays, t, sems=None) -> dict of lean per-ray
    tensors on the model's device, one row per ray. rays: (N, 11) array or tensor; t: the
    image's transient index; sems: (N,) labels or None.
    """
    check_supported(rc)
    mc = model.cfg
    device = next(model.parameters()).device
    chunk = chunk_size(rc, chunk)
    fused = field == "plain" or (device.type == "cuda"
                                 and supports_config(mc))

    @torch.no_grad()
    def render_image(rays, t, sems=None):
        # pack the current weights once per image
        if fused:
            cls = PlainField if field == "plain" else FusedField
            field_apply = cls(pack_params(model), rc.compute_dtype)
        else:
            field_apply = model
        rays = torch.as_tensor(rays, dtype=torch.float32, device=device)
        n = rays.shape[0]
        n_chunks = -(-n // chunk)
        pad = n_chunks * chunk - n
        if pad:
            rays = torch.cat([rays, rays[-1:].expand(pad, -1)], dim=0)
        if sems is not None:
            sems = torch.as_tensor(sems).to(device=device, dtype=torch.long)
            if pad:
                sems = torch.cat([sems, sems[-1:].expand(pad)], dim=0)
        else:
            sems = torch.zeros(n + pad, dtype=torch.long, device=device)
        t_emb = None
        if t_embed is not None:
            t_emb = t_embed(torch.full((chunk,), int(t), dtype=torch.long,
                                       device=device))
        outs = []
        for c in range(n_chunks):
            sl = slice(c * chunk, (c + 1) * chunk)
            outs.append(lean_eval_outputs(render_rays(
                field_apply, rc, rays[sl], t_emb=t_emb,
                sems=sems[sl] if mc.sem else None, train=False)))
        return {k: torch.cat([o[k] for o in outs], dim=0)[:n] for k in outs[0]}

    return render_image
