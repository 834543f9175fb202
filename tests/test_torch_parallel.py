"""Data parallelism in the port (`spnerf_torch/parallel`, `Trainer(mesh=)`,
the sharded eval render) against the JAX package's mesh on the CPU, whose
8 virtual devices `tests/conftest.py` sets up. The port's ranks are Gloo
processes (`tests/test_torch_ranks.py`).

* `shard_data`: each rank's block equals the JAX mesh's shard of the same
  device ray for ray (exact), N not a multiple of the world size.
* A 2-rank step against `Trainer(mesh=data_mesh(2))`, 3 steps at a global
  batch of 64 (32 a rank) on shared weights. Each rank is handed the JAX
  device's batch rows and render draws from the keys `_step_impl` folds
  with the device index, and the grid case JAX's unfolded grid jitter.
  Cases: a small Siren, a small hash field, the Siren with the occupancy
  grid, and, as the JAX package's dry run has them (`__graft_entry__.py`),
  beta with the fine pass (the beta loss on from step 0), the proposal
  sampler (no depth loss, no guided sampling, its table redrawn at scale
  0.5) and a hash field of two multi-AOI frames (half the rays in frame
  1). Bars: the averaged loss 2e-5 relative at every step;
  step 0's averaged gradients within 2e-4 of each leaf's largest entry
  (the JAX ones computed device by device and averaged, as `pmean`
  does); the parameters after 3 steps within 1e-4, the trajectory bar
  (Adam turns a gradient entry within rounding of zero into a +-lr
  update of either sign, as `tests/test_torch_train.py` notes: at 4
  Siren layers one entry of 1,024 moved 1.8e-4 apart; at these 8 none
  does, the largest gap is 8.1e-6 (Siren) and 5.3e-5 (grid));
  the grid within the same 1e-4, its cells outside the 3 refreshed slabs
  exactly 1 in both. The grid is the density of the trained field, so it
  follows the parameters: they differ by up to 5.3e-5 after 3 steps here
  and the grid by 9.8e-6 (the same refresh on the same weights is held at
  1e-5 in `tests/test_torch_occgrid.py`, so 1e-6 is out of reach). The two
  ranks' parameters, optimizer state and grid are bit for bit equal.
  Two cases hold their parameters after 3 steps at 2e-4, each for one
  entry measured past 1e-4 (every other bar is the test's):
  - beta_fine: one fine-field kernel entry of 3,040 at 1.22e-4 (its Adam
    second moment 7.4e-9, a normal gradient): after step 0 the packages'
    weights differ by rounding, and the inverse CDF that places the fine
    samples is discontinuous where a draw meets a bin's edge, so a fine
    sample of one ray can land in another bin in each package at step 1
    or 2 (`tests/test_torch_paths.py` sees 1e-3 on fine depths that way);
  - frames: one table entry of 131,072 at 1.63e-4, its Adam second moment
    4.8e-18 (a gradient of ~4e-8, at Adam's eps of 1e-8, where the update
    lr * g / (|g| + eps) turns a rounding-sized change of g, or a corner
    of a point on a cell's edge, into a fraction of lr).
* A mesh of one rank equals a run without a mesh bit for bit (3 steps,
  the generator's draws).
* The sharded eval render (2 ranks) against the JAX mesh render on
  `tests/test_multichip.py`'s case (2,200 rays, chunk 64 floored to 1,024,
  a ragged tail) within 2e-5, both ranks' outputs equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnerf_tpu import config as jconfig
from spnerf_tpu.parallel import data_mesh as jax_data_mesh
from spnerf_tpu.train.loop import Trainer as JaxTrainer
from spnerf_torch.config import LossConfig, ModelConfig, RenderConfig
from spnerf_torch.convert import (field_state_dict, flax_field_params,
                                  transient_state_dict)
from spnerf_torch.data.multi import FRAME_SPACING
from spnerf_torch.parallel import DataMesh, data_mesh
from spnerf_torch.train.loop import Trainer
from spnerf_torch.utils.synth import fake_batch

from test_torch_paths import jax_draws
from test_torch_ranks import run_ranks

SIREN = dict(mapping=True, sem=True, num_sem_classes=3, fc_units=32,
             fc_layers=8, skips=(4,))
HASH = dict(encoding="hash", hash_levels=4, hash_features=2, hash_log2T=14,
            hash_hidden=32, sem=True, num_sem_classes=3)
RC = dict(n_samples=8, guidedsample=True, solar_correction=True, sem=True)
LC = dict(sc_lambda=0.1, depth=True, ds_lambda=1.0, stdscale=1.0, sem=True,
          ss_lambda=1.0)
# name: (model, render, loss) config keywords
CASES = {"siren": (SIREN, RC, LC), "hash": (HASH, RC, LC),
         "occ_grid": (SIREN, dict(RC, occ_grid=True, occ_res=8, occ_bins=16),
                      LC),
         # the beta loss on from step 0, so that step 0's gradients reach
         # the beta head and the transient embedding
         "beta_fine": (dict(SIREN, beta=True),
                       dict(RC, beta=True, n_importance=4),
                       dict(LC, beta=True, first_beta_epoch=0)),
         "proposal": (SIREN, dict(RC, proposal=True, n_proposal=4,
                                  guidedsample=False),
                      dict(LC, depth=False, ds_lambda=0.0)),
         # two multi-AOI frames: the second half of the rays in frame 1
         "frames": (dict(HASH, hash_frames=2), RC, LC)}
TRAINER = dict(lr=1e-3, steps_per_epoch=3)
PARAM_ATOL = {"beta_fine": 2e-4, "frames": 2e-4}  # see the docstring
N_DATA, BATCH, STEPS = 1001, 64, 3


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scene(case=None):
    b = fake_batch(np.random.default_rng(1), N_DATA)
    b["sems"][::7] = -100
    if case == "frames":
        b["rays"][N_DATA // 2:, 0] += FRAME_SPACING
    return b


def trainer_kw(rc):
    return dict(TRAINER, occ_rows=128) if rc.get("occ_grid") else TRAINER


@pytest.mark.parametrize("world", [2, 3])
def test_shard_data_matches_the_jax_mesh(world):
    host = scene()
    mc, rc = ModelConfig(**SIREN), RenderConfig(**RC)
    jtr = JaxTrainer(jconfig.ModelConfig(**SIREN), jconfig.RenderConfig(**RC),
                     jconfig.LossConfig(**LC), mesh=jax_data_mesh(world))
    jdata = jtr.shard_data(host)
    for rank in range(world):
        mesh = DataMesh(rank=rank, world=world, group=None, backend="gloo",
                        device=torch.device("cpu"))
        block = Trainer(mc, rc, LossConfig(**LC), mesh=mesh).shard_data(host)
        for k, arr in jdata.items():
            shards = sorted(arr.addressable_shards,
                            key=lambda s: s.index[0].start or 0)
            np.testing.assert_array_equal(block[k].numpy(),
                                          np.asarray(shards[rank].data),
                                          err_msg=f"{k} rank {rank}")


def jax_reference(case):
    """The JAX mesh run: (losses, step 0's averaged gradients, final
    params, final grid, the per-step per-device draws for the port, the
    initial params, the scene), the params and gradients of every module
    (coarse, fine, proposal, t)."""
    mkw, rkw, lkw = CASES[case]
    jtr = JaxTrainer(jconfig.ModelConfig(**mkw), jconfig.RenderConfig(**rkw),
                     jconfig.LossConfig(**lkw), mesh=jax_data_mesh(2),
                     donate=False, **trainer_kw(rkw))
    state = jtr.init_state(jax.random.PRNGKey(0))
    params = dict(state.params)
    # hash tables redrawn so that they matter: the field's at scale 0.1,
    # the proposal's at 0.5
    for key, scale in (("coarse", 0.1), ("proposal", 0.5)):
        if "HashGridEncoding_0" in params.get(key, {}):
            module = dict(params[key])
            table = module["HashGridEncoding_0"]["table"]
            module["HashGridEncoding_0"] = {"table": jnp.asarray(
                np.random.default_rng(1).normal(size=table.shape)
                .astype(np.float32) * scale)}
            params[key] = module
    state = state.replace(params=params, opt_state=jtr.tx.init(params))
    host = scene(case)
    n_local = -(-N_DATA // 2)
    padded = {k: v[np.arange(2 * n_local) % N_DATA] for k, v in host.items()}
    bpd = BATCH // 2
    key = jax.random.PRNGKey(7)
    rc = RenderConfig(**rkw)
    grad_fn = jax.jit(jax.value_and_grad(jtr._loss_fn, has_aux=True))
    draws, grads = [], None
    for step in range(STEPS):
        per = []
        for d in range(2):
            k_idx, k_render = jax.random.split(jax.random.fold_in(key, step))
            k_idx = jax.random.fold_in(k_idx, d)
            k_render = jax.random.fold_in(k_render, d)
            idx = np.asarray(jax.random.randint(k_idx, (bpd,), 0, n_local))
            dr = jax_draws(k_render, bpd, rc)
            dr["idx"] = torch.from_numpy(idx.copy())
            if jtr.occ_rows:
                k_occ = jax.random.fold_in(jax.random.fold_in(key, step),
                                           0x0CC)
                dr["occ_u"] = torch.from_numpy(np.array(jax.random.uniform(
                    k_occ, (jtr.occ_rows, 3), jnp.float32)))
            per.append(dr)
            if step == 0:
                shard = {k: jnp.asarray(v[d * n_local:(d + 1) * n_local][idx])
                         for k, v in padded.items()}
                _, g = grad_fn(params, shard, k_render, jnp.int32(0),
                               state.occ)
                grads = g if grads is None else jax.tree_util.tree_map(
                    lambda a, b: (a + b) / 2, grads, g)
        draws.append(per)
    state = jtr.replicate_state(state)
    data = jtr.shard_data(host)
    step_fn = jtr.build_train_step(BATCH)
    losses = []
    for _ in range(STEPS):
        state, ld = step_fn(state, data, key)
        losses.append(float(ld["loss"]))
    occ = None if state.occ is None else np.asarray(state.occ)
    return (losses, grads, jax.device_get(state.params), occ, draws, params,
            host)


def leaves_close(ours, ref, tag, atol=None, rel=None):
    flat = dict(jax.tree_util.tree_leaves_with_path(ours))
    leaves = jax.tree_util.tree_leaves_with_path(ref)
    assert len(flat) == len(leaves), tag
    for path, r in leaves:
        r = np.asarray(r)
        bar = atol if rel is None else rel * np.abs(r).max()
        np.testing.assert_allclose(np.asarray(flat[path]), r, rtol=0,
                                   atol=bar, err_msg=f"{tag} "
                                   + jax.tree_util.keystr(path))


PREFIXES = {"fine.": "fine", "proposal.": "proposal", "t_embed.": "t"}


def flax_modules(named):
    """{flax params key: params tree} of the port's named tensors of every
    module (`TrainState.named_parameters` names)."""
    split = {}
    for k, v in named.items():
        pre = next((p for p in PREFIXES if k.startswith(p)), "")
        split.setdefault(PREFIXES.get(pre, "coarse"), {})[k[len(pre):]] = v
    return {key: ({"embedding": d["embedding"].numpy()} if key == "t"
                  else flax_field_params(d)) for key, d in split.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_rank_step_matches_the_jax_mesh(case, tmp_path):
    mkw, rkw, lkw = CASES[case]
    losses, grads, params, occ, draws, init, host = jax_reference(case)
    modules = {name: field_state_dict(init[key])
               for key, name in (("fine", "fine"), ("proposal", "proposal"))
               if key in init}
    if "t" in init:
        modules["t_embed"] = transient_state_dict(init["t"])
    job = dict(mc=mkw, rc=rkw, lc=lkw, trainer=trainer_kw(rkw),
               weights=field_state_dict(init["coarse"]),
               module_weights=modules, data=host, steps=STEPS, batch=BATCH,
               draws=draws)
    ranks = [r["runs"][0] for r in run_ranks("mesh_steps", 2, job, tmp_path)]
    ours = ranks[0]
    np.testing.assert_allclose([d["loss"] for d in ours["losses"]], losses,
                               rtol=2e-5)
    ours_grads = flax_modules(ours["grads0"])
    ours_params = flax_modules(ours["params"])
    assert set(ours_grads) == set(ours_params) == set(params) == set(grads)
    for key in params:
        leaves_close(ours_grads[key], grads[key], f"{key} grad", rel=2e-4)
        leaves_close(ours_params[key], params[key], f"{key} param",
                     atol=PARAM_ATOL.get(case, 1e-4))
    if occ is not None:
        np.testing.assert_allclose(ours["occ"].numpy(), occ, rtol=0,
                                   atol=1e-4)
        rows = STEPS * 128
        assert not np.any(occ[:rows] == 1.0)
        assert np.all(occ[rows:] == 1.0) and torch.all(ours["occ"][rows:] == 1)
    other = ranks[1]
    for k, v in ours["params"].items():
        assert torch.equal(v, other["params"][k]), k
    for a, b in zip(ours["optimizer"], other["optimizer"]):
        assert all(torch.equal(v, b[k]) for k, v in a.items())
    assert (ours["occ"] is None) == (occ is None)
    if occ is not None:
        assert torch.equal(ours["occ"], other["occ"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_one_rank_mesh_is_no_mesh(case):
    mkw, rkw, lkw = CASES[case]
    mc, rc, lc = ModelConfig(**mkw), RenderConfig(**rkw), LossConfig(**lkw)
    kw = trainer_kw(rkw)
    data = scene(case)
    runs = []
    mesh = data_mesh(1, "cpu", timeout_s=60)
    try:
        for m in (None, mesh):
            tr = Trainer(mc, rc, lc, mesh=m, device="cpu", **kw)
            state = tr.replicate_state(tr.init_state(
                torch.Generator().manual_seed(0)))
            d = tr.shard_data(data)
            lds = [tr.train_step(state, d, BATCH, seed=5)
                   for _ in range(STEPS)]
            runs.append((lds, state))
    finally:
        mesh.close()
    (lds_a, a), (lds_b, b) = runs
    for x, y in zip(lds_a, lds_b):
        assert x.keys() == y.keys()
        assert all(float(x[k]) == float(y[k]) for k in x), (x, y)
    for (k, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), k
    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()["state"]
    for i in sa:
        assert all(torch.equal(v, sb[i][k]) for k, v in sa[i].items()), i
    assert (a.occ is None) or torch.equal(a.occ, b.occ)


def test_sharded_eval_render_matches_the_jax_mesh(tmp_path):
    mkw = dict(fc_units=32, fc_layers=2, skips=(), mapping=True)
    rkw = dict(n_samples=6, compute_dtype="float32", solar_correction=True)
    jtr = JaxTrainer(jconfig.ModelConfig(**mkw), jconfig.RenderConfig(**rkw),
                     jconfig.LossConfig(), mesh=jax_data_mesh(2),
                     donate=False)
    params = jax.device_get(jtr.init_state(jax.random.PRNGKey(0)).params)
    rays = fake_batch(np.random.default_rng(0), 2200)["rays"]
    ref = jtr.build_render_fn(chunk=64)(params, rays, 0)
    job = dict(mc=mkw, rc=rkw, weights=field_state_dict(params["coarse"]),
               rays=rays, chunk=64)
    outs = run_ranks("render_view", 2, job, tmp_path)
    assert set(outs[0]) == set(ref)
    for k, v in ref.items():
        assert outs[0][k].shape == v.shape, k
        np.testing.assert_allclose(outs[0][k].numpy(), v, rtol=0, atol=2e-5,
                                   err_msg=k)
        assert torch.equal(outs[0][k], outs[1][k]), k
