"""The other render paths in the port against the JAX package, on the CPU:
the hierarchical fine pass's render, and one train step's loss and
gradients each with the occupancy grid, the fine pass, the proposal
sampler and the beta (transient) path.

Both packages take the same random draws: the JAX renderer draws from its
key, and the port is handed those draws by name (`jax_draws`). The
deterministic render (key=None) is not used here: its evenly spaced
inverse-CDF quantiles end at exactly 1.0, where a ray whose last coarse
bins are empty places its last fine sample on a cumulative sum that
float32 rounds a last bit apart in the two packages (1e-3 seen on fine
depths, and as much between the port and itself under a 1e-7 change of
the ray origins).

* The fine-pass render (`render_rays` with a second field of the same
  configuration, `n_importance` fine samples by an inverse CDF of the
  coarse weights, the head-pruned solar pass at the fine samples): the
  per-ray colours and depths within 1e-4, `tests/test_torch_render.py`'s
  bar; every output within 1e-4 on the 99th percentile and 1e-3 at most.
  After the guided pass, two inverse CDFs in a row place the fine samples:
  one fine depth 3e-5 apart in the packages moves a sample's sun
  visibility by 1.6e-4, and a 1e-7 change of the ray origins moves the
  port's own fine depths by 4.3e-4 and sun visibilities by 1.7e-3.
* One step, as `tests/test_torch_train.py` holds the Siren and hash steps:
  `Trainer.loss_fn` against `jax.value_and_grad(Trainer._loss_fn)` on
  shared weights of every module
  (the field, the fine field, the proposal field with its table redrawn
  at scale 0.5, the transient embedding) and a trained-looking grid. Loss
  and each term 2e-5 relative; gradients per leaf 2e-4 of the leaf's
  largest entry. The beta step runs at step 6, past the two warm-up
  epochs, so that the beta loss is on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnerf_tpu import config as jconfig
from spnerf_tpu.models import init_spnerf as jax_init_spnerf
from spnerf_tpu.ops import render_rays as jax_render_rays
from spnerf_tpu.train.loop import Trainer as JaxTrainer
from spnerf_torch.config import LossConfig, ModelConfig, RenderConfig
from spnerf_torch.convert import (field_state_dict, flax_field_params,
                                  transient_state_dict)
from spnerf_torch.models import SPNeRF
from spnerf_torch.ops import render_rays
from spnerf_torch.utils.synth import fake_batch

MC = dict(mapping=True, sem=True, num_sem_classes=3, fc_units=32,
          fc_layers=8, skips=(4,))
RC = dict(n_samples=8, guidedsample=True, solar_correction=True, sem=True)
LC = dict(sc_lambda=0.1, depth=True, ds_lambda=1.0, stdscale=1.0, sem=True,
          ss_lambda=1.0)
N_RAYS = 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tier-1 command runs six test processes on
    the machine's cores, and more threads each only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.array(a))


# the JAX renderer's keyed draws, in the order it splits its key
DRAW_NAMES = ("strat", "noise0", "guided", "noise1", "sc_noise", "pdf",
              "noise_fine", "sc_noise_fine", "prop_pdf")


def jax_draws(key, n_rays, rc):
    """The uniform draws the JAX renderer takes from `key` (no sigma
    noise), by the port's names."""
    keys = dict(zip(DRAW_NAMES, jax.random.split(key, len(DRAW_NAMES))))
    u = lambda k, n: t(jax.random.uniform(k, (n_rays, n), jnp.float32))
    draws = {"strat": u(keys["strat"], rc.n_proposal if rc.proposal
                        else rc.n_samples)}
    if rc.guidedsample:
        k1, k2 = jax.random.split(keys["guided"])
        draws.update(u_pred=u(k1, rc.n_samples), u_gt=u(k2, rc.n_samples))
    if rc.n_importance:
        draws["pdf"] = u(keys["pdf"], rc.n_importance)
    if rc.proposal:
        draws["prop_pdf"] = u(keys["prop_pdf"], rc.n_samples)
    return draws


@pytest.mark.parametrize("guided", [True, False])
def test_fine_pass_render_matches_jax(guided):
    jmodel, params = jax_init_spnerf(jax.random.PRNGKey(0),
                                     jconfig.ModelConfig(**MC))
    jfine, fparams = jax_init_spnerf(jax.random.PRNGKey(1),
                                     jconfig.ModelConfig(**MC))
    model, fine = SPNeRF(ModelConfig(**MC)), SPNeRF(ModelConfig(**MC))
    model.load_state_dict(field_state_dict(params["params"]))
    fine.load_state_dict(field_state_dict(fparams["params"]))
    batch = fake_batch(np.random.default_rng(2), 128)
    rcd = dict(RC, guidedsample=guided, n_importance=16)

    def apply(m, p):
        return lambda xyz, sun, tt, sem, heads=None, solar_tail=0: m.apply(
            p, xyz, sun, tt, sem, heads=heads)

    key = jax.random.PRNGKey(5)
    ref = jax_render_rays(apply(jmodel, params), jconfig.RenderConfig(**rcd),
                          jnp.asarray(batch["rays"]),
                          sems=jnp.asarray(batch["sems"]), key=key,
                          fine_field_apply=apply(jfine, fparams))
    with torch.no_grad():
        out = render_rays(model, RenderConfig(**rcd), t(batch["rays"]),
                          sems=t(batch["sems"]), fine_field_apply=fine,
                          draws=jax_draws(key, 128, RenderConfig(**rcd)))
    assert "rgb_fine" in out and "weights_sc_fine" in out
    assert out["z_vals_fine"].shape[1] == 8 * (2 if guided else 1) + 16
    assert set(out) == set(ref)
    for k in ref:
        err = np.abs(out[k].numpy() - np.asarray(ref[k]))
        assert np.quantile(err, 0.99) <= 1e-4, k
        assert err.max() <= (1e-4 if k.startswith(("rgb_", "depth_"))
                             else 1e-3), (k, err.max())


PATHS = {
    "occ_grid": (dict(), dict(occ_grid=True, occ_res=8, occ_bins=16),
                 dict(), 0),
    "n_importance": (dict(), dict(n_importance=8), dict(), 0),
    "proposal": (dict(), dict(proposal=True, n_proposal=16),
                 dict(prop_lambda=0.5), 0),
    "beta": (dict(beta=True), dict(beta=True), dict(beta=True), 6),
}


def port_grads(state):
    """{flax params key: grads tree} of every module of the port's state."""
    g = lambda m: {k: p.grad for k, p in m.named_parameters()}
    out = {"coarse": flax_field_params(g(state.model))}
    if state.fine is not None:
        out["fine"] = flax_field_params(g(state.fine))
    if state.proposal is not None:
        out["proposal"] = flax_field_params(g(state.proposal))
    if state.t_embed is not None:
        out["t"] = {"embedding": state.t_embed.embedding.grad.numpy()}
    return out


@pytest.mark.parametrize("path", sorted(PATHS))
def test_one_step_loss_and_grads_match_jax(path):
    from spnerf_torch.train.loop import Trainer

    mkw, rkw, lkw, step = PATHS[path]
    mc, rc, lc = dict(MC, **mkw), dict(RC, **rkw), dict(LC, **lkw)
    jtr = JaxTrainer(jconfig.ModelConfig(**mc), jconfig.RenderConfig(**rc),
                     jconfig.LossConfig(**lc), lr=1e-3, steps_per_epoch=3,
                     t_vocab=4)
    jstate = jtr.init_state(jax.random.PRNGKey(0))
    params = dict(jstate.params)
    rng = np.random.default_rng(1)
    if "proposal" in params:
        p = dict(params["proposal"])
        table = p["HashGridEncoding_0"]["table"]
        p["HashGridEncoding_0"] = {"table": jnp.asarray(
            (rng.normal(size=table.shape) * 0.5).astype(np.float32))}
        params["proposal"] = p
    occ = None
    if jstate.occ is not None:
        occ = rng.uniform(0.0, 20.0, jstate.occ.shape).astype(np.float32)
        occ[rng.uniform(size=occ.shape) < 0.8] = 0.0
    ttr = Trainer(ModelConfig(**mc), RenderConfig(**rc), LossConfig(**lc),
                  lr=1e-3, steps_per_epoch=3, t_vocab=4, device="cpu")
    state = ttr.init_state(torch.Generator().manual_seed(0))
    state.model.load_state_dict(field_state_dict(params["coarse"]))
    for key, module in (("fine", state.fine), ("proposal", state.proposal)):
        assert (key in params) == (module is not None)
        if module is not None:
            module.load_state_dict(field_state_dict(params[key]))
    assert ("t" in params) == (state.t_embed is not None)
    if state.t_embed is not None:
        state.t_embed.load_state_dict(transient_state_dict(params["t"]))
    assert (occ is None) == (state.occ is None)
    if occ is not None:
        state.occ.copy_(torch.from_numpy(occ))

    b = fake_batch(np.random.default_rng(0), N_RAYS)
    b["sems"][:4] = -100
    b["ids"] = np.random.default_rng(3).integers(0, 4, N_RAYS).astype(
        np.int32)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    key = jax.random.PRNGKey(7)
    (jloss, jd), jg = jax.value_and_grad(jtr._loss_fn, has_aux=True)(
        params, jb, key, jnp.int32(step),
        None if occ is None else jnp.asarray(occ))
    loss, td = ttr.loss_fn(state, {k: t(v) for k, v in b.items()}, step,
                           draws=jax_draws(key, N_RAYS, ttr.rc))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=2e-5)
    assert set(td) == set(jd)
    for k in jd:
        np.testing.assert_allclose(td[k].item(), float(jd[k]), rtol=2e-5,
                                   atol=1e-6, err_msg=k)
    if path == "proposal":
        assert float(jd["coarse_prop"]) > 1e-4
    if path == "beta":
        assert "coarse_logbeta" in jd
    ours = port_grads(state)
    assert set(ours) == set(jg)
    for key in jg:
        ref = jax.tree_util.tree_leaves_with_path(jg[key])
        flat = dict(jax.tree_util.tree_leaves_with_path(ours[key]))
        assert len(ref) == len(flat), key
        for lp, g in ref:
            g = np.asarray(g)
            scale = np.abs(g).max()
            assert scale > 0, (key, lp)
            np.testing.assert_allclose(
                flat[lp], g, rtol=0, atol=2e-4 * scale,
                err_msg=key + jax.tree_util.keystr(lp))
