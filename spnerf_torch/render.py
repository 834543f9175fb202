"""Whole-image eval rendering: the counterpart of the JAX package's
`Trainer.build_render_fn` and `Trainer._lean_eval_outputs`.

Rays are rendered in chunks of at most `MAX_POINTS // samples_per_ray` rays
(at least 1024), the last chunk padded by repeating the last ray. The field
runs through a fused CUDA kernel whenever `ops.field_eval.route` names one
for the configuration at the render's compute dtype and the model lies on a
CUDA device, as the JAX package uses its fused kernel on every accelerator:
the wgmma kernel for bf16 fields within its envelope, the wgmma_f32 kernel
for float32 fields up to 512 wide of at most 16 semantic classes, and the
wgmma_wide kernel (a cluster of 2, 4 or 8 CTAs) for every other field of
the family up to W_MAX = 4096 wide, at any number of classes. A field
wider than 4096 would need a cluster larger than the H100's portable 8
CTAs: it renders through the module, the port's only limit on the width;
so does a configuration with a fine pass or a proposal sampler, as the JAX
package's does. With the occupancy
grid the trained grid places the samples (a uniform grid where none is
given). Lean outputs composite the per-sample sun, albedo, sky
and beta on the device and drop the per-sample tensors.

With a mesh (`parallel.data_mesh`), as the JAX package's sharded render:
the chunk is floored to a multiple of the world size, each rank renders
its contiguous share of every chunk, and the per-ray outputs are gathered
on every rank by one all-reduce of zero-filled buffers (Gloo reduces CUDA
tensors but does not gather them).

The JAX package's machinery for its remote TPU (chunks grouped per
dispatch, a depth-2 dispatch pipeline) is not ported: chunks here are
launched in turn on the current CUDA stream.
"""

import copy

import torch

from .models.spnerf import as_dtype
from .ops.field_eval import (FusedField, PlainField, pack_params,
                             uses_fused_kernel)
from .ops.occgrid import init_grid
from .ops.render import render_rays
from .spans import span

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


def module_at(model, compute_dtype):
    """`model` when it computes in `compute_dtype`, else a copy of it (the
    current weights) that does."""
    cd = as_dtype(compute_dtype)
    if model.compute_dtype == cd:
        return model
    model = copy.deepcopy(model)
    for sub in model.modules():
        if hasattr(sub, "compute_dtype"):
            sub.compute_dtype = cd
    return model


MAX_POINTS = 1_500_000  # field points per chunk


def chunk_size(rc, chunk=40960):
    """Rays per chunk: rays x samples stays under MAX_POINTS, floor 1024."""
    samples_per_ray = rc.n_samples * (2 if rc.guidedsample else 1)
    samples_per_ray += rc.n_importance
    if rc.solar_correction:
        samples_per_ray *= 2
    return max(min(chunk, MAX_POINTS // max(samples_per_ray, 1)), 1024)


def gather_shares(outs, mesh):
    """Every rank's per-ray outputs {key: (C, share, ...)} of C chunks as
    {key: (C * world * share, ...)}, chunk by chunk, rank by rank: one
    all-reduce of a flat float32 buffer that is zero outside this rank's
    share (float32 holds every output dtype exactly)."""
    keys = sorted(outs)
    sizes = [outs[k].numel() * mesh.world for k in keys]
    flat = torch.zeros(sum(sizes), dtype=torch.float32, device=mesh.device)
    gathered = {}
    for k, part in zip(keys, torch.split(flat, sizes)):
        v = outs[k]
        full = part.view((v.shape[0], mesh.world) + v.shape[1:])
        full[:, mesh.rank] = v
        gathered[k] = full
    mesh.all_reduce_(flat)
    return {k: v.reshape((-1,) + v.shape[3:]).to(outs[k].dtype)
            for k, v in gathered.items()}


def build_render_fn(model, rc, t_embed=None, chunk=40960, field=None,
                    fine=None, proposal=None, mesh=None):
    """Whole-image renderer over `model` (an `SPNeRF` on its device), with
    the fine field `fine` (rc.n_importance > 0) and the proposal field
    `proposal` (rc.proposal).

    field: None evaluates the field through the fused kernel of its route
    where `uses_fused_kernel` says so (CUDA, a configuration `route` takes
    at `rc.compute_dtype`) and through the module at `rc.compute_dtype`
    elsewhere; "plain" uses the fused field's plain version on any device.
    A configuration with a fine pass or a proposal sampler renders through
    the modules either way.

    mesh: a `parallel.DataMesh`; every rank calls render_image on the same
    rays and renders its share of each chunk.

    Returns render_image(rays, t, sems=None, occ=None) -> dict of lean
    per-ray tensors on the model's device, one row per ray. rays: (N, 11)
    array or tensor; t: the image's transient index; sems: (N,) labels or
    None; occ: the occupancy grid (rc.occ_grid; None: a uniform grid).
    """
    mc = model.cfg
    device = next(model.parameters()).device
    chunk = chunk_size(rc, chunk)
    world, rank = (1, 0) if mesh is None else (mesh.world, mesh.rank)
    chunk = max(chunk // world * world, world)
    share = chunk // world
    modules_only = rc.n_importance > 0 or rc.proposal
    fused = not modules_only and (
        field == "plain" or uses_fused_kernel(device, mc, rc.compute_dtype))

    @torch.no_grad()
    def render_image(rays, t, sems=None, occ=None):
        # pack the current weights once per image
        if fused:
            cls = PlainField if field == "plain" else FusedField
            field_apply = cls(pack_params(model, rc.compute_dtype),
                              rc.compute_dtype)
        else:
            field_apply = module_at(model, rc.compute_dtype)
        fine_apply = (None if fine is None
                      else module_at(fine, rc.compute_dtype))
        if rc.occ_grid:
            occ = (init_grid(rc.occ_res, rc.occ_frames, device) if occ is None
                   else torch.as_tensor(occ, dtype=torch.float32,
                                        device=device))
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
            t_emb = t_embed(torch.full((share,), int(t), dtype=torch.long,
                                       device=device))
        outs = []
        for c in range(n_chunks):
            sl = slice(c * chunk + rank * share, c * chunk + (rank + 1) * share)
            with span("render.chunk"):
                outs.append(lean_eval_outputs(render_rays(
                    field_apply, rc, rays[sl], t_emb=t_emb,
                    sems=sems[sl] if mc.sem else None, train=False,
                    fine_field_apply=fine_apply, proposal_apply=proposal,
                    occ=occ)))
        if mesh is None:
            return {k: torch.cat([o[k] for o in outs], dim=0)[:n]
                    for k in outs[0]}
        outs = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        return {k: v[:n] for k, v in gather_shares(outs, mesh).items()}

    return render_image
