"""The port's train step against the JAX package's `Trainer`, on shared
weights and a fixed batch, in float32 on the CPU.

* The learning-rate schedule equals optax's staircase decay (1e-6 relative:
  float32 against float64 powers).
* One step's loss and every parameter gradient against
  `jax.value_and_grad(Trainer._loss_fn)` with key=None (the deterministic
  render), for a small hash configuration and a small Siren configuration.
  Loss: 2e-5 relative. Gradients: per leaf, 2e-4 of the leaf's largest
  entry. The guided pass places samples by an inverse CDF of the coarse
  weights, which scales float32 differences up (1e-4 on render outputs in
  tests/test_torch_render.py), and the depth and solar terms sum thousands
  of them.
* The same for the (L, T, F) hash table (`hash_flat_table=False`).
* A 5-step Adam trajectory on a fixed batch: losses within 1e-4 relative.
  Parameters are not compared: where a gradient entry is near zero its sign
  may differ by rounding, and Adam turns that into a ±lr update. The same
  for each optimizer option (`grad_clip`, `table_wd`,
  `table_level_lr_decay`, `weight_decay`, and `table_wd` with
  `weight_decay`) against the JAX Trainer's optax chain, each set large
  enough to move the trajectory well past the tolerance. On the (L, T, F)
  table `table_level_lr_decay` fails in both packages.
* The step with its generator (batch draws, jitter, guided draws) is a
  function of the seed.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spnerf_tpu import config as jconfig
from spnerf_tpu.train.loop import Trainer as JaxTrainer
from spnerf_tpu.train.loop import make_lr_schedule as jax_lr_schedule
from spnerf_torch.config import LossConfig, ModelConfig, RenderConfig
from spnerf_torch.convert import field_state_dict, flax_field_params
from spnerf_torch.train.loop import Trainer, make_lr_schedule
from spnerf_torch.utils.synth import fake_batch

RC = dict(n_samples=8, guidedsample=True, solar_correction=True, sem=True)
LC = dict(sc_lambda=0.1, depth=True, ds_lambda=1.0, stdscale=1.0, sem=True,
          ss_lambda=1.0)
MC = {
    "hash": dict(encoding="hash", hash_levels=4, hash_features=2,
                 hash_log2T=14, hash_hidden=32, sem=True, num_sem_classes=3),
    "hash_nonflat": dict(encoding="hash", hash_levels=4, hash_features=2,
                         hash_log2T=14, hash_hidden=32, sem=True,
                         num_sem_classes=3, hash_flat_table=False),
    "siren": dict(mapping=True, sem=True, num_sem_classes=3, fc_units=32,
                  fc_layers=8, skips=(4,)),
}
N_RAYS = 64


def test_lr_schedule_matches_optax():
    for lr, spe, gamma in ((5e-4, 1000, 0.9), (1e-2, 7, 0.5), (1e-3, 0, 0.9)):
        ours, ref = make_lr_schedule(lr, spe, gamma), jax_lr_schedule(lr, spe,
                                                                      gamma)
        for step in (0, 1, 6, 7, 999, 1000, 2500, 10 ** 4):
            np.testing.assert_allclose(ours(step), float(ref(step)),
                                       rtol=1e-6, atol=1e-38,
                                       err_msg=str(step))


def make_pair(family, lr=1e-2, **tr_kw):
    """(JAX trainer, its params, port trainer, port state) on one set of
    weights. The hash table is redrawn at scale 0.1 so that it matters."""
    mc, rc, lc = MC[family], RC, LC
    jtr = JaxTrainer(jconfig.ModelConfig(**mc), jconfig.RenderConfig(**rc),
                     jconfig.LossConfig(**lc), lr=lr, steps_per_epoch=3,
                     **tr_kw)
    params = jtr.init_state(jax.random.PRNGKey(0)).params
    coarse = dict(params["coarse"])
    if family.startswith("hash"):
        table = coarse["HashGridEncoding_0"]["table"]
        coarse["HashGridEncoding_0"] = {"table": jnp.asarray(
            np.random.default_rng(1).normal(size=table.shape)
            .astype(np.float32) * 0.1)}
    params = {"coarse": coarse}
    ttr = Trainer(ModelConfig(**mc), RenderConfig(**rc), LossConfig(**lc),
                  lr=lr, steps_per_epoch=3, device="cpu", **tr_kw)
    state = ttr.init_state(torch.Generator().manual_seed(0))
    state.model.load_state_dict(field_state_dict(params["coarse"]))
    return jtr, params, ttr, state


def batches():
    b = fake_batch(np.random.default_rng(0), N_RAYS)
    b["sems"][:4] = -100
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def port_grads(state):
    return flax_field_params({k: p.grad for k, p in
                              state.model.named_parameters()})


@pytest.mark.parametrize("family", ["hash", "siren", "hash_nonflat"])
def test_one_step_loss_and_grads_match_jax(family):
    jtr, params, ttr, state = make_pair(family)
    jb, tb = batches()
    (jloss, jd), jg = jax.value_and_grad(jtr._loss_fn, has_aux=True)(
        params, jb, None, jnp.int32(0))
    loss, td = ttr.loss_fn(state, tb, 0)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-5)
    assert set(td) == set(jd)
    for k in jd:
        np.testing.assert_allclose(td[k].item(), float(jd[k]), rtol=2e-5,
                                   atol=1e-6, err_msg=k)
    ours = port_grads(state)
    ref = jax.tree_util.tree_leaves_with_path(jg["coarse"])
    flat = dict(jax.tree_util.tree_leaves_with_path(ours))
    assert len(ref) == len(flat)
    for path, g in ref:
        g = np.asarray(g)
        scale = np.abs(g).max()
        assert scale > 0, path
        np.testing.assert_allclose(flat[path], g, rtol=0, atol=2e-4 * scale,
                                   err_msg=jax.tree_util.keystr(path))


def trajectories(n=5, family="hash", grad_fn=None, **opts):
    """n steps of the JAX Trainer's optax chain and of the port's optimizer
    from the same weights on one fixed batch: (JAX losses, port losses,
    the jitted JAX gradient function, for reuse)."""
    jtr, params, ttr, state = make_pair(family, **opts)
    jb, tb = batches()
    opt = jtr.tx.init(params)
    if grad_fn is None:
        grad_fn = jax.jit(jax.value_and_grad(jtr._loss_fn, has_aux=True))
    jlosses, tlosses = [], []
    for step in range(n):
        (jloss, _), g = grad_fn(params, jb, None, jnp.int32(step))
        updates, opt = jtr.tx.update(g, opt, params)
        params = optax.apply_updates(params, updates)
        jlosses.append(float(jloss))
        loss, _ = ttr.loss_fn(state, tb, state.step)
        ttr.apply_gradients(state, loss)
        tlosses.append(loss.item())
    assert state.step == n
    return jlosses, tlosses, grad_fn


def test_five_adam_steps_track_jax():
    jlosses, tlosses, _ = trajectories()
    assert tlosses[-1] < tlosses[0]  # it learns
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)


# large enough that each moves the 5-step losses by far more than 1e-4
OPTIONS = {
    "grad_clip": dict(grad_clip=1e-5),
    "table_wd": dict(table_wd=20.0),
    "table_level_lr_decay": dict(table_level_lr_decay=0.2),
    "weight_decay": dict(weight_decay=5.0),
    "table_wd+weight_decay": dict(table_wd=10.0, weight_decay=2.0),
}


@functools.lru_cache(maxsize=1)
def plain_trajectory():
    """The JAX losses of plain Adam and the jitted JAX gradient, shared by
    the option cases (the options change only the optimizer)."""
    jlosses, _, grad_fn = trajectories()
    return jlosses, grad_fn


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_optimizer_options_track_jax(name):
    """The option's 5-step trajectory tracks the JAX Trainer's optax chain
    within 1e-4, and differs from plain Adam's by more than 1e-3: the
    option is exercised, not vacuous."""
    jplain, grad_fn = plain_trajectory()
    jl, tl, _ = trajectories(grad_fn=grad_fn, **OPTIONS[name])
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    moved = np.max(np.abs(np.array(jl) / np.array(jplain) - 1.0))
    assert moved > 1e-3, moved


def test_level_decay_on_nonflat_table_fails_as_in_jax():
    """The (L, 1) level multiplier does not broadcast against an (L, T, F)
    table: the JAX chain fails on its first update, the port refuses when
    it builds the optimizer."""
    mc, rc, lc = MC["hash_nonflat"], RC, LC
    jtr = JaxTrainer(jconfig.ModelConfig(**mc), jconfig.RenderConfig(**rc),
                     jconfig.LossConfig(**lc), table_level_lr_decay=0.5)
    params = jtr.init_state(jax.random.PRNGKey(0)).params
    assert params["coarse"]["HashGridEncoding_0"]["table"].ndim == 3
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    with pytest.raises(ValueError):
        jtr.tx.update(zeros, jtr.tx.init(params), params)
    for flat, fails in ((False, True), (True, False)):
        ttr = Trainer(ModelConfig(**dict(mc, hash_flat_table=flat)),
                      RenderConfig(**rc), LossConfig(**lc), device="cpu",
                      table_level_lr_decay=0.5)
        if fails:
            with pytest.raises(ValueError, match="table_level_lr_decay"):
                ttr.init_state(torch.Generator().manual_seed(0))
        else:  # the flat table takes it
            ttr.init_state(torch.Generator().manual_seed(0))


def test_generator_path_is_a_function_of_the_seed():
    mc = ModelConfig(**MC["hash"])
    tr = Trainer(mc, RenderConfig(**RC), LossConfig(**LC), lr=1e-2,
                 device="cpu")
    data = tr.to_device(fake_batch(np.random.default_rng(0), 256))

    def run(seed):
        state = tr.init_state(torch.Generator().manual_seed(0))
        lds = [tr.train_step(state, data, batch_size=32, seed=seed)
               for _ in range(2)]
        return [ld["loss"].item() for ld in lds], state

    a, sa = run(5)
    b, sb = run(5)
    c, _ = run(6)
    assert a == b and a != c
    for (k, va), vb in zip(sa.model.state_dict().items(),
                           sb.model.state_dict().values()):
        assert torch.equal(va, vb), k
    # the jitter reaches the render: the same batch renders differently
    g = tr.step_generator(0, 5)
    batch = tr.sample_batch(data, 32, g)
    with torch.no_grad():
        det, _ = tr.loss_fn(sa, batch, 0)
        jit, _ = tr.loss_fn(sa, batch, 0, generator=g)
    assert det.item() != jit.item()
    ld = tr.train_steps(sa, data, 2, batch_size=32, seed=5)
    assert sa.step == 4 and np.isfinite(ld["loss"].item())


def test_render_draws_by_name_match_jax_keyed_passes():
    """With draws handed in, the render takes them where the JAX renderer
    takes its keyed draws: zero draws reproduce the lower stratum edges,
    and sigma noise moves the composite."""
    from spnerf_torch.ops.render import render_rays

    jtr, params, ttr, state = make_pair("siren")
    _, tb = batches()
    field = ttr.field_apply(state.model)
    rc = RenderConfig(**RC)
    with torch.no_grad():
        det = render_rays(field, rc, tb["rays"], sems=tb["sems"])
        zero = render_rays(field, rc, tb["rays"], sems=tb["sems"],
                           draws={"strat": torch.zeros(N_RAYS, 8)})
        noisy = render_rays(field, rc, tb["rays"], sems=tb["sems"],
                            noise_std=1.0,
                            draws={"noise0": torch.ones(N_RAYS, 8)})
    z_det, z_zero = det["z_vals_unsort_coarse"], zero["z_vals_unsort_coarse"]
    near, far = tb["rays"][:, 6:7], tb["rays"][:, 7:8]
    lin = near + (far - near) * torch.linspace(0, 1, 8)
    torch.testing.assert_close(z_det[:, :8], lin)
    lower = torch.cat([lin[:, :1], 0.5 * (lin[:, 1:] + lin[:, :-1])], -1)
    torch.testing.assert_close(z_zero[:, :8], lower)
    assert not torch.equal(noisy["depth_coarse"], det["depth_coarse"])


def test_anneal_schedule_matches_jax():
    mc = dict(MC["hash"], hash_anneal_steps=100)
    jtr = JaxTrainer(jconfig.ModelConfig(**mc), jconfig.RenderConfig(**RC),
                     jconfig.LossConfig(**LC))
    ttr = Trainer(ModelConfig(**mc), RenderConfig(**RC), LossConfig(**LC),
                  device="cpu")
    for step in (0, 1, 33, 50, 99, 100, 250):
        np.testing.assert_allclose(ttr.anneal(step).numpy(),
                                   np.asarray(jtr._anneal(jnp.int32(step))),
                                   atol=1e-7, err_msg=str(step))
    assert Trainer(ModelConfig(**MC["hash"]), RenderConfig(**RC),
                   LossConfig(**LC), device="cpu").anneal(5) is None


def test_trainer_refuses_unported_options():
    mc, rc, lc = (ModelConfig(**MC["hash"]), RenderConfig(**RC),
                  LossConfig(**LC))
    with pytest.raises(NotImplementedError):
        Trainer(mc, rc, lc, device="cpu", mesh=object())
    for rkw in (dict(occ_grid=True), dict(proposal=True),
                dict(n_importance=8)):
        with pytest.raises(NotImplementedError):
            Trainer(mc, dataclasses.replace(rc, **rkw), lc, device="cpu")
