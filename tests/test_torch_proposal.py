"""The port's proposal sampler (`spnerf_torch/ops/proposal.py`,
`spnerf_torch/models/proposal.py`) against the JAX package's, on the CPU.

Tolerances: `density_weights` and `interlevel_loss` with its gradient with
respect to the proposal's weights, 1e-6; `resample_from_weights` (`det`,
and with the JAX draws handed over) 1e-5 absolute plus 5e-5 relative, the
samplers' bar of `tests/test_torch_sampling.py`: an inverse CDF divides the
float32 rounding of the two packages' cumulative sums by the mass of the
bin it lands in, and both packages' float32 results lie 2.7e-6 to 6e-6
from the float64 one at these densities (2.4e-4 at densities up to 6,
whose transmittance leaves bins of 1e-6 mass); `ProposalField` on converted weights
(table redrawn at scale 0.5) and its table gradient, 1e-5; the render with
the proposal placing the main samples, 1e-4 (`tests/test_torch_render.py`'s
bar).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnerf_tpu import config as jconfig
from spnerf_tpu.models import init_spnerf as jax_init_spnerf
from spnerf_tpu.models.proposal import ProposalField as JaxProposal
from spnerf_tpu.ops import proposal as jprop
from spnerf_tpu.ops import render_rays as jax_render_rays
from spnerf_torch.config import ModelConfig, RenderConfig
from spnerf_torch.convert import field_state_dict, flax_field_params
from spnerf_torch.models import ProposalField, SPNeRF
from spnerf_torch.ops import proposal as prop
from spnerf_torch.ops import render_rays
from spnerf_torch.utils.synth import fake_batch

R, SP, SM = 64, 24, 16


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


@pytest.fixture
def hist(rng):
    """Sorted proposal and main z per ray, densities and main weights."""
    near = rng.uniform(0.0, 0.2, (R, 1)).astype(np.float32)
    z_p = np.sort(rng.uniform(near, near + 1.5, (R, SP)), -1).astype(
        np.float32)
    z_m = np.sort(rng.uniform(near - 0.1, near + 1.6, (R, SM)), -1).astype(
        np.float32)
    sig = rng.uniform(0.05, 1.0, (R, SP)).astype(np.float32)
    w_m = rng.uniform(size=(R, SM)).astype(np.float32)
    w_m = w_m / w_m.sum(-1, keepdims=True) * 0.9
    return z_p, z_m, sig, w_m


def test_density_weights_match_jax(hist):
    z_p, _, sig, _ = hist
    ref = jprop.density_weights(jnp.asarray(sig), jnp.asarray(z_p))
    np.testing.assert_allclose(prop.density_weights(t(sig), t(z_p)).numpy(),
                               np.asarray(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("det", [True, False])
def test_resample_from_weights_matches_jax(hist, det):
    z_p, _, sig, _ = hist
    w = np.asarray(jprop.density_weights(jnp.asarray(sig), jnp.asarray(z_p)))
    key = jax.random.PRNGKey(4)
    ref = jprop.resample_from_weights(key, jnp.asarray(z_p), jnp.asarray(w),
                                      SM, det=det)
    u = None if det else t(jax.random.uniform(key, (R, SM)))
    out = prop.resample_from_weights(t(z_p), t(w), SM, det=det, u=u)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=5e-5,
                               atol=1e-5)
    assert np.all(np.diff(out.numpy(), axis=-1) >= 0)


def test_interlevel_loss_and_gradient_match_jax(hist):
    """Value and gradient with respect to the proposal's weights; the main
    weights and z take no gradient."""
    z_p, z_m, sig, w_m = hist
    w_p = np.asarray(jprop.density_weights(jnp.asarray(sig),
                                           jnp.asarray(z_p)))
    ref, (g_wp, g_wm) = jax.value_and_grad(
        lambda a, b: jprop.interlevel_loss(jnp.asarray(z_p), a,
                                           jnp.asarray(z_m), b),
        argnums=(0, 1))(jnp.asarray(w_p), jnp.asarray(w_m))
    tw_p = t(w_p).requires_grad_()
    tw_m = t(w_m).requires_grad_()
    tz_m = t(z_m).requires_grad_()
    out = prop.interlevel_loss(t(z_p), tw_p, tz_m, tw_m)
    out.backward()
    assert float(ref) > 1e-3  # the bound is violated somewhere
    np.testing.assert_allclose(out.item(), float(ref), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tw_p.grad.numpy(), np.asarray(g_wp), rtol=0,
                               atol=1e-6)
    assert np.abs(np.asarray(g_wp)).max() > 1e-3
    assert not np.asarray(g_wm).any()
    assert tw_m.grad is None and tz_m.grad is None


def test_cum_weight_at_matches_jax(hist):
    """Queries before, inside, on the edges of and past the histogram."""
    z_p, _, sig, _ = hist
    w = np.asarray(jprop.density_weights(jnp.asarray(sig), jnp.asarray(z_p)))
    edges = np.concatenate([z_p, z_p[:, -1:] + 0.05], -1)
    q = np.concatenate([edges[:, :5], edges[:, :1] - 0.1,
                        edges[:, -1:] + 0.1,
                        0.5 * (edges[:, 3:9] + edges[:, 4:10])], -1)
    ref = jprop._cum_weight_at(jnp.asarray(edges), jnp.asarray(w),
                               jnp.asarray(q))
    out = prop._cum_weight_at(t(edges), t(w), t(q))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def proposal_pair(rng, seed=0):
    """The JAX `ProposalField` and the port's on one set of weights, the
    table redrawn at scale 0.5 so that it matters."""
    jmodel = JaxProposal()
    params = jmodel.init(jax.random.PRNGKey(seed), jnp.zeros((2, 3)))
    p = dict(params["params"])
    table = p["HashGridEncoding_0"]["table"]
    p["HashGridEncoding_0"] = {"table": jnp.asarray(
        (rng.normal(size=table.shape) * 0.5).astype(np.float32))}
    model = ProposalField()
    model.load_state_dict(field_state_dict(p))
    return jmodel, {"params": p}, model


def test_proposal_field_matches_jax(rng):
    jmodel, params, model = proposal_pair(rng)
    assert tuple(model.encoding.table.shape) == (8, 2 ** 16 * 2)
    assert model.encoding.level_table_sizes() == [8192, 32768] + [2 ** 16] * 6
    xyz = rng.uniform(-1.2, 1.2, (700, 3)).astype(np.float32)
    w = rng.normal(size=700).astype(np.float32)

    def jloss(p):
        s = jmodel.apply(p, jnp.asarray(xyz))
        return jnp.sum(s * jnp.asarray(w)), s

    (_, ref), g = jax.value_and_grad(jloss, has_aux=True)(params)
    out = model(t(xyz))
    (out * t(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=1e-5)
    grads = flax_field_params({k: p.grad for k, p in
                               model.named_parameters()})
    for path, gj in jax.tree_util.tree_leaves_with_path(g["params"]):
        gj = np.asarray(gj)
        gt = grads
        for k in path:
            gt = gt[k.key]
        assert np.abs(gj).max() > 0, path
        np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


MC = dict(mapping=True, sem=True, num_sem_classes=3, fc_units=32,
          fc_layers=8, skips=(4,))
RC = dict(n_samples=8, solar_correction=True, sem=True, proposal=True,
          n_proposal=16)


@pytest.mark.parametrize("guided", [False, True])
def test_render_with_proposal_matches_jax(rng, guided):
    """The proposal places the main samples (deterministic render); with
    guided sampling after it too."""
    jfield_model, fparams = jax_init_spnerf(jax.random.PRNGKey(0),
                                            jconfig.ModelConfig(**MC))
    field = SPNeRF(ModelConfig(**MC))
    field.load_state_dict(field_state_dict(fparams["params"]))
    jprop_model, pparams, proposal = proposal_pair(rng, seed=1)
    batch = fake_batch(np.random.default_rng(3), 128)
    rcd = dict(RC, guidedsample=guided)

    def jfield(xyz, sun, tt, sem, heads=None, solar_tail=0):
        return jfield_model.apply(fparams, xyz, sun, tt, sem, heads=heads)

    ref = jax_render_rays(
        jfield, jconfig.RenderConfig(**rcd), jnp.asarray(batch["rays"]),
        sems=jnp.asarray(batch["sems"]), key=None, train=False,
        proposal_apply=lambda xyz: jprop_model.apply(pparams, xyz))
    with torch.no_grad():
        out = render_rays(field, RenderConfig(**rcd), t(batch["rays"]),
                          sems=t(batch["sems"]), proposal_apply=proposal)
    assert {"z_prop_coarse", "w_prop_coarse"} <= set(out)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-4, rtol=0, err_msg=k)
