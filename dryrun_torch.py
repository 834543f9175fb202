"""A one-device forward check and a multi-rank dry run of the PyTorch port.

`entry(device=None)` returns (fn, args): the flagship forward (the render
of 256 rays at 16 samples, width 128, random weights from seed 0);
`fn(*args)` is the (256, 3) coarse colour.

`dryrun_multichip(n, device=None)` runs every train-step variant the CLI
dispatches, over n ranks (`spnerf_torch.parallel`: NCCL where each rank
has a card of its own, Gloo on the CPU and where ranks share a card), one
step or a window of 3 steps each, on small synthetic scenes:
  1. the flagship Siren, a window of 3 steps;
  2. the sharded eval render of 300 rays;
  3. the hash field, one step;
  4. the flagship with the occupancy grid, a window of 3 steps;
  5. beta (the transient uncertainty head and its loss), one step;
  6. beta with the fine pass, a window of 3 steps;
  7. the proposal sampler (no depth loss, no guided sampling), one step;
  8. a hash field of two multi-AOI frames, half the rays in frame 1, one
     step.
Rank 0 prints one "ok" line per program, with its loss; every program's
loss must be finite and the ranks' parameters equal bit for bit. Without a
`mesh` it starts the n ranks itself as spawned processes and returns each
rank's results; given this rank's `mesh`, it runs the programs there.

    python dryrun_torch.py [--device cpu] [--ranks 2]
"""

import argparse
import os
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch

PROGRAMS = ("flagship window", "sharded eval render", "hash step",
            "occgrid window", "beta step", "beta+fine window",
            "proposal step", "dual-frame multi-AOI hash step")
RANK_TIMEOUT_S = 600.0


def _configs(n_samples=4, fc_units=32):
    from spnerf_torch.utils.synth import (flagship_configs,
                                          flagship_loss_config)

    mc, rc = flagship_configs(n_samples=n_samples, fc_units=fc_units)
    return mc, rc, flagship_loss_config()


def entry(device=None):
    """(fn, args): the flagship forward on 256 rays, fn(*args) the
    (256, 3) coarse colour."""
    from spnerf_torch.ops import render_rays
    from spnerf_torch.train.loop import Trainer
    from spnerf_torch.utils.synth import fake_batch

    mc, rc, lc = _configs(n_samples=16, fc_units=128)
    tr = Trainer(mc, rc, lc, steps_per_epoch=100, max_steps=1000,
                 device=device)
    state = tr.init_state(torch.Generator().manual_seed(0))
    batch = tr.to_device(fake_batch(np.random.default_rng(0), 256))

    @torch.no_grad()
    def fn(model, rays, sems):
        return render_rays(tr.field_apply(model), rc, rays,
                           sems=sems)["rgb_coarse"]

    return fn, (state.model, batch["rays"], batch["sems"])


def _params(state):
    """Every parameter of the state, flattened into one float32 vector on
    the host."""
    return torch.cat([p.detach().float().reshape(-1).cpu()
                      for _, p in state.named_parameters()])


def run_programs(mesh):
    """The eight programs on this rank of `mesh`: [{"program", "loss",
    "params"}], the loss None for the render."""
    from spnerf_torch.config import LossConfig, ModelConfig, RenderConfig
    from spnerf_torch.data.multi import FRAME_SPACING
    from spnerf_torch.render import build_render_fn
    from spnerf_torch.train.loop import Trainer
    from spnerf_torch.utils.synth import fake_batch

    n = mesh.world
    mc, rc, lc = _configs()
    mch = ModelConfig(fc_units=32, fc_layers=2, skips=(), encoding="hash",
                      hash_levels=4, hash_features=2, hash_log2T=10)
    rch = RenderConfig(n_samples=4, compute_dtype="float32")
    mcb, rcb, lcb = (replace(mc, beta=True), replace(rc, beta=True),
                     replace(lc, beta=True))
    mcm = replace(mch, hash_frames=2)
    out = []

    def run(name, cfgs, seed, steps, trainer_kw=None, shift_frame=False):
        tr = Trainer(*cfgs, steps_per_epoch=10, max_steps=100, mesh=mesh,
                     **(trainer_kw or {}))
        state = tr.replicate_state(tr.init_state(
            torch.Generator().manual_seed(seed)))
        host = fake_batch(np.random.default_rng(seed), 64 * n)
        if shift_frame:  # half the rays' origins in frame 1
            host["rays"][host["rays"].shape[0] // 2:, 0] += FRAME_SPACING
        data = tr.shard_data(host)
        for _ in range(steps):
            ld = tr.train_step(state, data, 8 * n, seed=seed + 1)
        loss = float(ld["loss"])
        if not np.isfinite(loss):
            raise RuntimeError(f"{name}: loss {loss}")
        if state.occ is not None and not torch.isfinite(state.occ).all():
            raise RuntimeError(f"{name}: the grid is not finite")
        out.append({"program": name, "loss": loss, "params": _params(state)})
        return tr, state

    tr, state = run(PROGRAMS[0], (mc, rc, lc), 0, 3)
    render = build_render_fn(state.model, rc, state.t_embed,
                             chunk=max(1024, n), mesh=mesh)
    rays = fake_batch(np.random.default_rng(1), 300)["rays"]
    rgb = render(rays, 0)["rgb_coarse"]
    if tuple(rgb.shape) != (300, 3) or not torch.isfinite(rgb).all():
        raise RuntimeError(f"sharded eval render: {tuple(rgb.shape)}, "
                           "or not finite")
    out.append({"program": PROGRAMS[1], "loss": None,
                "params": rgb.float().cpu()})
    run(PROGRAMS[2], (mch, rch, LossConfig()), 2, 1)
    run(PROGRAMS[3], (mc, replace(rc, occ_grid=True, occ_res=8, occ_bins=8),
                      lc), 4, 3, {"occ_rows": 64})
    run(PROGRAMS[4], (mcb, rcb, lcb), 6, 1)
    run(PROGRAMS[5], (mcb, replace(rcb, n_importance=4), lcb), 8, 3)
    run(PROGRAMS[6], (mc, replace(rc, proposal=True, n_proposal=4,
                                  guidedsample=False),
                      replace(lc, depth=False, ds_lambda=0.0)), 10, 1)
    run(PROGRAMS[7], (mcm, rch, LossConfig()), 12, 1, shift_frame=True)
    if mesh.is_main:
        for r in out:
            loss = "" if r["loss"] is None else f", loss {r['loss']:.4f}"
            print(f"dryrun_multichip({n}): {r['program']} ok{loss}",
                  flush=True)
    return out


def _rank(rank, world, device_type, init, out_path):
    from spnerf_torch.parallel import data_mesh

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    if device_type == "cpu":
        torch.set_num_threads(1)
    mesh = data_mesh(world, device_type, init_method=init,
                     timeout_s=RANK_TIMEOUT_S)
    try:
        torch.save(run_programs(mesh), out_path)
    finally:
        mesh.close()


def dryrun_multichip(n_devices, device=None, mesh=None):
    """The eight programs over n_devices ranks: this rank's results on
    `mesh`, or, without one, each rank's results from n_devices spawned
    ranks on `device` (the card unless "cpu"), their replicas checked
    equal."""
    from spnerf_torch.device import resolve_device

    if mesh is not None:
        if mesh.world != n_devices:
            raise ValueError(f"the mesh has {mesh.world} ranks, not "
                             f"{n_devices}")
        return run_programs(mesh)
    device_type = resolve_device(device).type
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(n_devices)]
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank, args=(r, n_devices, device_type,
                                                 init, outs[r]))
                 for r in range(n_devices)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + RANK_TIMEOUT_S
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join(10)
        codes = [p.exitcode for p in procs]
        if hung or codes != [0] * n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}): rank exit "
                               f"codes {codes}, {len(hung)} killed")
        results = [torch.load(o, weights_only=False) for o in outs]
    for r in results[1:]:
        for a, b in zip(results[0], r):
            if not torch.equal(a["params"], b["params"]):
                raise RuntimeError(f"{a['program']}: the ranks' replicas "
                                   "differ")
    return results


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="torch device: the card by default; 'cpu' runs "
                        "on the CPU")
    p.add_argument("--ranks", type=int, default=2)
    args = p.parse_args()
    fn, fn_args = entry(args.device)
    out = fn(*fn_args)
    print("entry ok:", tuple(out.shape), out.dtype)
    dryrun_multichip(args.ranks, args.device)
