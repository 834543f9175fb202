"""The port's occupancy grid (`spnerf_torch/ops/occgrid.py`) against the JAX
package's `ops/occgrid.py`, on the CPU, with the same grids, points and
draws (the JAX draws from its key are handed to the port).

Tolerances: nearest-cell indices exact, with 1 and 2 frames; `update_grid`
within 1e-6 with the jitter injected (an analytic density in both
packages); the trainer's grid refresh from a field on shared weights within
1e-5 (the field's float32 differences); `occ_z_vals`, `det` and with
injected draws, within 1e-5 absolute plus 5e-5 relative, the samplers' bar
of `tests/test_torch_sampling.py` (an inverse CDF divides the rounding of
the two packages' cumulative sums by the small mass of a floor-weighted
bin: a last sample lands 2e-5 below `far` in one package and on it in the
other); the whole-image render with a trained-looking grid
against `Trainer.build_render_fn` with the Pallas kernel in interpret mode
at `tests/test_torch_render.py`'s bf16 bounds (2e-2 on the 99th
percentile and 1e-1 at most); in float32 1e-4 on the 99th percentile and
1e-3 at most (two inverse CDFs in a row, the grid's and the guided pass's,
scale the float32 differences up: 1.005e-4 seen on the depth, 5.1e-4 on
the semantic logits of 11 of 1,000 rays; 3.2e-5 with the uniform grid).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnerf_tpu import config as jconfig
from spnerf_tpu.ops import occgrid as jocc
from spnerf_tpu.train.loop import Trainer as JaxTrainer
from spnerf_torch.config import LossConfig, ModelConfig, RenderConfig
from spnerf_torch.convert import field_state_dict
from spnerf_torch.models import SPNeRF
from spnerf_torch.ops import occgrid as occ
from spnerf_torch.render import build_render_fn
from spnerf_torch.train.checkpoints import CheckpointManager
from spnerf_torch.train.loop import Trainer
from spnerf_torch.utils.synth import fake_batch

MC = dict(mapping=True, sem=True, num_sem_classes=3, fc_units=32,
          fc_layers=8, skips=(4,))
RC = dict(n_samples=8, guidedsample=True, solar_correction=True, sem=True,
          occ_grid=True, occ_res=8, occ_bins=16)
LC = dict(sc_lambda=0.1, depth=True, ds_lambda=1.0, stdscale=1.0, sem=True,
          ss_lambda=1.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tier-1 command runs six test processes on
    the machine's cores, and more threads each only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frame_points(rng, n, frames):
    """Points in every frame's box, on its faces, between frames and
    beyond the last."""
    xyz = rng.uniform(-1.3, 1.3, size=(n, 3)).astype(np.float32)
    xyz[:, 0] += 3.0 * rng.integers(0, frames, n)
    xyz[: n // 10, 0] = 1.5  # between frames 0 and 1 (round(0.5) = 0)
    xyz[n // 10: n // 5, 0] = 3.0 * frames + 0.7  # beyond the last frame
    xyz[n // 5: n // 4] = 1.0
    return xyz


def sparse_grid(rng, res, frames):
    """A grid that looks trained: most cells empty, a few dense."""
    g = rng.uniform(0.0, 20.0, size=frames * res ** 3).astype(np.float32)
    g[rng.uniform(size=g.shape) < 0.8] = 0.0
    return g


@pytest.mark.parametrize("frames", [1, 2])
def test_lookup_lin_exact(rng, frames):
    res = 8
    xyz = frame_points(rng, 700, frames)
    ref = np.asarray(jocc._lookup_lin(jnp.asarray(xyz), res, frames))
    out = occ._lookup_lin(torch.from_numpy(xyz), res, frames)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert out.max().item() < frames * res ** 3


def analytic_sigma(xp):
    """A density both packages compute the same way."""
    def fn(xyz):
        r2 = (xyz[:, 0] % 3.0 - 1.5) ** 2 + xyz[:, 1] ** 2 + xyz[:, 2] ** 2
        return 8.0 * xp.exp(-3.0 * r2) + 0.5 * xp.sin(4.0 * xyz[:, 1]) ** 2
    return fn


@pytest.mark.parametrize("frames", [1, 2])
def test_update_grid_matches_jax(rng, frames):
    """Four slabs in turn, each with its JAX jitter; the last wraps past the
    grid's end back onto slab 0 (a second visit decays)."""
    res, rows, decay = 8, 256, 0.8
    n_slabs = frames * res ** 3 // rows
    g0 = rng.uniform(0.0, 5.0, size=frames * res ** 3).astype(np.float32)
    jg, tg = jnp.asarray(g0), torch.from_numpy(g0.copy())
    key = jax.random.PRNGKey(3)
    for step in (0, 1, n_slabs - 1, n_slabs):
        k = jax.random.fold_in(key, step)
        jg = jocc.update_grid(jg, analytic_sigma(jnp), k, jnp.int32(step),
                              res, rows, decay, frames=frames)
        u = torch.from_numpy(np.array(
            jax.random.uniform(k, (rows, 3), jnp.float32)))
        occ.update_grid(tg, analytic_sigma(torch), u, step, res, rows, decay,
                        frames=frames)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                                   atol=1e-6, err_msg=str(step))
    assert not np.allclose(tg.numpy(), g0)


def test_slab_rows_match_the_jax_trainer():
    for res, frames, rows in ((8, 1, 100), (8, 2, 4096), (64, 1, 4096),
                              (64, 2, 5000), (5, 1, 7), (4, 1, 10 ** 6)):
        rc = jconfig.RenderConfig(occ_grid=True, occ_res=res,
                                  occ_frames=frames)
        jtr = JaxTrainer(jconfig.ModelConfig(), rc, jconfig.LossConfig(),
                         occ_rows=rows)
        assert occ.slab_rows(res, rows, frames) == jtr.occ_rows
    with pytest.raises(ValueError):
        occ.update_grid(torch.ones(512), analytic_sigma(torch),
                        torch.zeros(100, 3), 0, 8, 100, 0.5)


def near_far_rays(rng, n, frames):
    b = fake_batch(rng, n)
    rays = b["rays"].copy()
    rays[:, 0] += 3.0 * rng.integers(0, frames, n)  # origins in each frame
    rays[:, 6] = 0.2
    rays[:, 7] = 1.8
    return rays


@pytest.mark.parametrize("frames", [1, 2])
@pytest.mark.parametrize("det", [True, False])
def test_occ_z_vals_match_jax(rng, frames, det):
    res, n, S = 8, 200, 16
    rays = near_far_rays(rng, n, frames)
    grid = sparse_grid(rng, res, frames)
    key = jax.random.PRNGKey(5)
    ref = jocc.occ_z_vals(key, jnp.asarray(grid), jnp.asarray(rays[:, :3]),
                          jnp.asarray(rays[:, 3:6]), jnp.asarray(rays[:, 6:7]),
                          jnp.asarray(rays[:, 7:8]), S, res, n_bins=32,
                          floor=0.01, det=det, frames=frames)
    u = None if det else torch.from_numpy(np.array(
        jax.random.uniform(key, (n, S), jnp.float32)))
    r = torch.from_numpy(rays)
    out = occ.occ_z_vals(torch.from_numpy(grid), r[:, :3], r[:, 3:6],
                         r[:, 6:7], r[:, 7:8], S, res, n_bins=32, floor=0.01,
                         det=det, frames=frames, u=u)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=5e-5,
                               atol=1e-5)
    # the grid moves the samples: not the stratified placement
    assert np.abs(np.diff(out.numpy(), axis=-1)).std() > 1e-3


def pair(rc_kw=None, mc=MC):
    rcd = dict(RC, **(rc_kw or {}))
    jtr = JaxTrainer(jconfig.ModelConfig(**mc), jconfig.RenderConfig(**rcd),
                     jconfig.LossConfig(**LC), lr=5e-4, steps_per_epoch=3,
                     occ_rows=128)
    jstate = jtr.init_state(jax.random.PRNGKey(0))
    ttr = Trainer(ModelConfig(**mc), RenderConfig(**rcd), LossConfig(**LC),
                  lr=5e-4, steps_per_epoch=3, occ_rows=128, device="cpu")
    state = ttr.init_state(torch.Generator().manual_seed(0))
    state.model.load_state_dict(field_state_dict(jstate.params["coarse"]))
    return jtr, jstate, ttr, state


def test_trainer_grid_refresh_matches_jax():
    """The refresh the step makes after the optimizer update, from the same
    coarse weights and the JAX jitter: the field's sigma at IGNORE labels,
    no sun, EMA-max into the slab of the step."""
    from spnerf_tpu.ops.occgrid import update_grid as jax_update

    jtr, jstate, ttr, state = pair()
    assert ttr.occ_rows == jtr.occ_rows == 128
    g0 = np.random.default_rng(2).uniform(0, 2, 512).astype(np.float32)
    key = jax.random.PRNGKey(11)
    params = jstate.params["coarse"]

    def jsigma(xyz):
        m = xyz.shape[0]
        return jtr.model.apply({"params": params}, xyz,
                               jnp.zeros((m, 3), xyz.dtype), None,
                               jnp.full((m,), -100, jnp.int32),
                               sigma_only=True)["sigma"]

    state.occ.copy_(torch.from_numpy(g0))
    jg = jnp.asarray(g0)
    for step in (0, 3):
        jg = jax_update(jg, jsigma, key, jnp.int32(step), 8, 128, 0.8)
        u = torch.from_numpy(np.array(
            jax.random.uniform(key, (128, 3), jnp.float32)))
        ttr.refresh_grid(state, step, u)
    np.testing.assert_allclose(state.occ.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-5)
    assert not np.allclose(state.occ.numpy(), g0)


def test_train_step_refreshes_the_grid_and_resumes(tmp_path):
    """A step refreshes slab `step` from the new parameters; the grid is in
    the checkpoint and comes back bit for bit; the next step of the
    restored state equals the uninterrupted one's."""
    _, _, ttr, state = pair()
    data = {k: torch.from_numpy(v)
            for k, v in fake_batch(np.random.default_rng(1), 512).items()}
    ttr.train_step(state, data, 64)
    occ1 = state.occ.clone()
    assert torch.all(occ1[128:] == 1.0)  # only slab 0 was refreshed
    assert not torch.all(occ1[:128] == 1.0)
    CheckpointManager(str(tmp_path)).save(1, state)
    ttr.train_step(state, data, 64)
    _, _, _, fresh = pair()
    CheckpointManager(str(tmp_path)).restore(fresh)
    assert fresh.step == 1 and torch.equal(fresh.occ, occ1)
    ttr.train_step(fresh, data, 64)
    assert torch.equal(fresh.occ, state.occ)
    for (k, a), (_, b) in zip(fresh.model.state_dict().items(),
                              state.model.state_dict().items()):
        assert torch.equal(a, b), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_render_image_with_grid_matches_trainer(dtype, monkeypatch):
    """Whole-image render with the trained grid threaded through, fused
    field (its plain version; the Pallas kernel in interpret mode) in both
    packages; and the uniform grid stands in when none is given."""
    monkeypatch.setenv("SPNERF_EVAL_GROUP", "1")
    rcd = dict(RC, compute_dtype=dtype)
    jtr = JaxTrainer(jconfig.ModelConfig(**MC),
                     jconfig.RenderConfig(**rcd, use_pallas=True),
                     jconfig.LossConfig(**LC), t_vocab=5)
    params = jtr.init_state(jax.random.PRNGKey(1)).params
    batch = fake_batch(np.random.default_rng(7), 1000)
    grid = sparse_grid(np.random.default_rng(8), 8, 1)
    render_j = jtr.build_render_fn(chunk=1024)
    model = SPNeRF(ModelConfig(**MC), compute_dtype=dtype)
    model.load_state_dict(field_state_dict(params["coarse"]))
    render = build_render_fn(model, RenderConfig(**rcd), chunk=1024,
                             field="plain")
    for g in (grid, None):
        ref = render_j(params, batch["rays"], 3, batch["sems"], occ=g)
        out = render(batch["rays"], 3, batch["sems"], occ=g)
        assert set(out) == set(ref)
        for k in ref:
            err = np.abs(out[k].numpy() - ref[k])
            if dtype == "float32":
                assert np.quantile(err, 0.99) <= 1e-4, k
                assert err.max() <= 1e-3, (k, err.max())
            else:
                assert np.quantile(err, 0.99) <= 2e-2, k
                assert err.max() <= 1e-1, (k, err.max())
    # the grid changed the render
    uni = render(batch["rays"], 3, batch["sems"])
    assert (uni["depth_coarse"] - out["depth_coarse"]).abs().max() == 0
    out = render(batch["rays"], 3, batch["sems"], occ=grid)
    assert (uni["depth_coarse"] - out["depth_coarse"]).abs().max() > 1e-3
