"""Rank processes for the port's multi-rank tests on the CPU
(`tests/test_torch_parallel.py`, `tests/test_torch_layouts.py`,
`tests/test_torch_dryrun.py`), and the tests of that harness itself.

`run_ranks(job, world, inputs, tmp_path)` starts `world` spawned
processes, each one thread and one Gloo rank on a `file://` store under
`tmp_path` with a process-group timeout, runs the job named `job` on the
inputs (saved with `torch.save`) and returns each rank's result. It waits
at most `timeout` seconds, then kills the ranks and fails. This module
imports torch and the port only, so that a rank starts quickly.

Tested here: a rank that fails fails `run_ranks`, and ranks still running
at its deadline are killed and fail it, within seconds.
"""

import os
import time

import pytest
import torch
import torch.multiprocessing as mp

from spnerf_torch.config import LossConfig, ModelConfig, RenderConfig

COLLECTIVE_TIMEOUT_S = 60


def mesh_steps(mesh, job):
    """`job["steps"]` train steps of a Trainer over the mesh, once for each
    environment in job["envs"], each from a fresh state (seed 0, then
    job["weights"] in the field and job["module_weights"][name] in the
    state's module `name` when given): the loss terms of every step, the
    averaged gradients of step 0, and the parameters (every module's, named
    as `TrainState.named_parameters` names them), the optimizer state and
    the grid after the last step. job["draws"][step][rank] hands each rank
    its draws (`Trainer.train_step`)."""
    from spnerf_torch.train.loop import Trainer

    mc, rc, lc = (ModelConfig(**job["mc"]), RenderConfig(**job["rc"]),
                  LossConfig(**job["lc"]))
    runs = []
    for env in job.get("envs", [{}]):
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            tr = Trainer(mc, rc, lc, mesh=mesh, **job["trainer"])
            state = tr.init_state(torch.Generator().manual_seed(0))
            if "weights" in job:
                state.model.load_state_dict(job["weights"])
            for name, sd in job.get("module_weights", {}).items():
                getattr(state, name).load_state_dict(sd)
            state = tr.replicate_state(state)
            data = tr.shard_data(job["data"])
            losses, grads0 = [], None
            for step in range(job["steps"]):
                draws = job["draws"][step][mesh.rank] if "draws" in job \
                    else None
                ld = tr.train_step(state, data, job["batch"],
                                   seed=job.get("seed", 0), draws=draws)
                losses.append({k: float(v) for k, v in ld.items()})
                if step == 0:
                    grads0 = {k: p.grad.clone() for k, p in
                              state.named_parameters()
                              if p.grad is not None}
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        runs.append({
            "losses": losses, "grads0": grads0,
            "params": {k: p.detach().clone()
                       for k, p in state.named_parameters()},
            "optimizer": [{k: v.clone() for k, v in st.items()
                           if torch.is_tensor(v)}
                          for st in state.optimizer.state.values()],
            "occ": None if state.occ is None else state.occ.clone()})
    return {"runs": runs}


def render_view(mesh, job):
    """The eval renderer over the mesh on job["rays"] with job["weights"]
    in the field: its per-ray outputs."""
    from spnerf_torch.models import load_model
    from spnerf_torch.render import build_render_fn

    mc, rc = ModelConfig(**job["mc"]), RenderConfig(**job["rc"])
    model = load_model(mc, rc.compute_dtype, device="cpu")
    model.load_state_dict(job["weights"])
    render = build_render_fn(model, rc, chunk=job["chunk"], mesh=mesh)
    return {k: v.clone() for k, v in render(job["rays"], 0).items()}


def dryrun(mesh, job):
    """`dryrun_torch.dryrun_multichip` on this rank: its eight programs'
    losses and parameters."""
    import dryrun_torch

    return dryrun_torch.dryrun_multichip(mesh.world, mesh=mesh)


JOBS = {"mesh_steps": mesh_steps, "render_view": render_view,
        "dryrun": dryrun}


def _rank(job, rank, world, init, in_path, out_path):
    from spnerf_torch.parallel import data_mesh

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world))
    mesh = data_mesh(world, "cpu", init_method=init,
                     timeout_s=COLLECTIVE_TIMEOUT_S)
    try:
        inputs = torch.load(in_path, weights_only=False)
        torch.save(JOBS[job](mesh, inputs), out_path)
    finally:
        mesh.close()


def run_ranks(job, world, inputs, tmp_path, timeout=150.0):
    """Each rank's result of JOBS[job](mesh, inputs) over `world` Gloo
    ranks; fails when a rank fails or outlasts `timeout` seconds."""
    in_path = os.path.join(str(tmp_path), f"{job}.in.pt")
    torch.save(inputs, in_path)
    outs = [os.path.join(str(tmp_path), f"{job}.{r}.pt") for r in range(world)]
    init = "file://" + os.path.join(str(tmp_path), f"{job}.store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank,
                         args=(job, r, world, init, in_path, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    assert not hung, f"{len(hung)} ranks still running after {timeout} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"rank exit codes {codes}"
    return [torch.load(o, weights_only=False) for o in outs]


@pytest.mark.parametrize("job,timeout,message", [
    ("no_such_job", 150.0, "rank exit codes"),
    ("mesh_steps", 0.0, "still running"),
])
def test_run_ranks_fails_and_stops_its_ranks(job, timeout, message,
                                             tmp_path):
    t0 = time.monotonic()
    with pytest.raises(AssertionError, match=message):
        run_ranks(job, 2, {}, tmp_path, timeout=timeout)
    assert time.monotonic() - t0 < 60
