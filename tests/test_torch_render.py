"""The port's renderer against the JAX package's, on shared weights and rays.

* `render_rays` with the field module in float32 (coarse, guided merge,
  head-pruned solar pass, semantics): 1e-4 absolute. Guided samples are
  placed by an inverse CDF of the coarse weights, which scales the float32
  differences of the coarse pass up a little.
* The slice as a whole: the port's `render_image` with the fused field (its
  plain version on the CPU) against `Trainer.build_render_fn` with the fused
  Pallas kernel in interpret mode, one 1024-ray chunk. float32: 1e-4. bf16:
  one bf16 ulp of an activation can move a guided sample, so per-ray outputs
  are held to 2e-2 on the 99th percentile and 1e-1 at most.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnerf_tpu import config as jconfig
from spnerf_tpu.models import init_spnerf as jax_init_spnerf
from spnerf_tpu.ops import render_rays as jax_render_rays
from spnerf_torch.config import ModelConfig, RenderConfig
from spnerf_torch.convert import field_state_dict, transient_state_dict
from spnerf_torch.models import SPNeRF, TransientEmbedding
from spnerf_torch.ops import render_rays
from spnerf_torch.ops.field_eval import route
from spnerf_torch.render import build_render_fn, chunk_size
from spnerf_torch.utils.synth import fake_batch

MC = dict(mapping=True, sem=True, num_sem_classes=3, fc_units=64,
          fc_layers=8, skips=(4,))
RC = dict(n_samples=8, guidedsample=True, solar_correction=True, sem=True)


@pytest.mark.parametrize("train", [False, True])
def test_render_rays_matches_jax(train, rng):
    """train=True guides the valid rays' samples by their target depths."""
    jmodel, params = jax_init_spnerf(jax.random.PRNGKey(0),
                                     jconfig.ModelConfig(**MC))
    model = SPNeRF(ModelConfig(**MC))
    model.load_state_dict(field_state_dict(params["params"]))
    batch = fake_batch(rng, 128)
    batch["sems"][:5] = -100
    targets = ("valid_depth", "depths", "depth_std")

    def jfield(xyz, sun, t, sem, heads=None):
        return jmodel.apply(params, xyz, sun, t, sem, heads=heads)

    def jrender(rays, sems, valid, depths, std):
        return jax_render_rays(jfield, jconfig.RenderConfig(**RC), rays,
                               sems=sems, key=None, train=train,
                               valid_depth=valid, target_depths=depths,
                               target_std=std)

    ref = jax.jit(jrender)(*(jnp.asarray(batch[k])
                             for k in ("rays", "sems") + targets))
    with torch.no_grad():
        out = render_rays(model, RenderConfig(**RC),
                          torch.from_numpy(batch["rays"]),
                          sems=torch.from_numpy(batch["sems"]), train=train,
                          valid_depth=torch.from_numpy(batch["valid_depth"]),
                          target_depths=torch.from_numpy(batch["depths"]),
                          target_std=torch.from_numpy(batch["depth_std"]))
    assert set(out) == set(ref)
    for k in ref:
        assert tuple(out[k].shape) == ref[k].shape, k
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-4, rtol=0, err_msg=k)


@pytest.mark.parametrize("dtype,field", [("float32", "sem"),
                                         ("bfloat16", "sem"),
                                         ("float32", "beta"),
                                         ("float32", "wide"),
                                         ("bfloat16", "wide")])
def test_render_image_matches_trainer(dtype, field, monkeypatch):
    """The slice end to end: whole-image eval rendering. The beta case also
    carries the transient embedding of image t; the wide case is a field of
    fc_units 768, which the port renders through its wide kernel on the
    card (the wgmma kernel takes at most 704, the wgmma_f32 kernel 512) and
    the JAX package through its Pallas kernel; the card renders the other
    float32 cases through the wgmma_f32 kernel."""
    from spnerf_tpu.train.loop import Trainer

    monkeypatch.setenv("SPNERF_EVAL_GROUP", "1")
    mc = (dict(MC, sem=False, beta=True) if field == "beta"
          else dict(MC, fc_units=768) if field == "wide" else MC)
    rcd = RC if field != "beta" else dict(RC, sem=False, beta=True)
    jrc = jconfig.RenderConfig(**rcd, compute_dtype=dtype, use_pallas=True)
    tr = Trainer(jconfig.ModelConfig(**mc), jrc,
                 jconfig.LossConfig(sc_lambda=0.1, sem=mc["sem"]), t_vocab=5)
    params = tr.init_state(jax.random.PRNGKey(1)).params
    batch = fake_batch(np.random.default_rng(7), 1000)
    ref = tr.build_render_fn(chunk=1024)(params, batch["rays"], 3,
                                         batch["sems"])

    rc = RenderConfig(**rcd, compute_dtype=dtype)
    assert chunk_size(rc, 1024) == 1024
    model = SPNeRF(ModelConfig(**mc), compute_dtype=dtype)
    if field == "wide":
        assert route(model.cfg, dtype) == "wgmma_wide"
    elif dtype == "float32":
        assert route(model.cfg, dtype) == "wgmma_f32"
    model.load_state_dict(field_state_dict(params["coarse"]))
    t_embed = None
    if field == "beta":
        t_embed = TransientEmbedding(5, model.cfg.t_embedding_dims)
        t_embed.load_state_dict(transient_state_dict(params["t"]))
    out = build_render_fn(model, rc, t_embed=t_embed, chunk=1024,
                          field="plain")(batch["rays"], 3, batch["sems"])
    assert set(out) == set(ref)
    for k in ref:
        got = out[k].numpy()
        assert got.shape == ref[k].shape, k
        err = np.abs(got - ref[k])
        if dtype == "float32":
            assert err.max() <= 1e-4, (k, err.max())
        else:
            assert np.quantile(err, 0.99) <= 2e-2, (k, np.quantile(err, 0.99))
            assert err.max() <= 1e-1, (k, err.max())


def test_unported_paths_raise(monkeypatch):
    """Every path renders: the fine pass, the proposal sampler and the
    occupancy grid (each held against the JAX package in
    tests/test_torch_paths.py, test_torch_proposal.py and
    test_torch_occgrid.py), and each of the four opt-in pass layouts, which
    give the default layout's outputs (held against the JAX package's
    layouts in tests/test_torch_layouts.py). A field without
    `supports_solar_tail`, as this module, keeps separate passes under
    SPNERF_BATCH_SOLAR."""
    from spnerf_torch.models import ProposalField
    from spnerf_torch.ops.occgrid import init_grid

    model = SPNeRF(ModelConfig(**MC))
    batch = fake_batch(np.random.default_rng(0), 4)
    rays, sems = torch.from_numpy(batch["rays"]), torch.from_numpy(
        batch["sems"])
    with torch.no_grad():
        for kw, extra, key in (
                (dict(n_importance=4), dict(fine_field_apply=model),
                 "rgb_fine"),
                (dict(proposal=True, n_proposal=8),
                 dict(proposal_apply=ProposalField()), "w_prop_coarse"),
                (dict(occ_grid=True, occ_res=4), dict(occ=init_grid(4)),
                 "rgb_coarse")):
            out = render_rays(model, RenderConfig(**RC, **kw), rays,
                              sems=sems, **extra)
            assert torch.isfinite(out[key]).all(), key
        default = render_rays(model, RenderConfig(**RC), rays, sems=sems)
    for name in ("SPNERF_BATCH_SOLAR", "SPNERF_BATCH_SC", "SPNERF_NO_MERGE",
                 "SPNERF_NO_PRUNE"):
        with monkeypatch.context() as m, torch.no_grad():
            m.setenv(name, "1")
            out = render_rays(model, RenderConfig(**RC), rays, sems=sems)
        assert set(out) == set(default), name
        for k, v in default.items():
            torch.testing.assert_close(out[k], v, rtol=0, atol=1e-5,
                                       msg=f"{name} {k}")


def test_render_image_pads_and_chunks():
    """Ragged ray counts: chunks of the capped size, last ray repeated, one
    output row per input ray, identical to rendering all rays at once."""
    model = SPNeRF(ModelConfig(**MC))
    rc = RenderConfig(**RC)
    batch = fake_batch(np.random.default_rng(3), 1500)
    out = build_render_fn(model, rc, chunk=1024)(batch["rays"], 0,
                                                 batch["sems"])
    whole = build_render_fn(model, rc, chunk=4096)(batch["rays"], 0,
                                                   batch["sems"])
    for k, v in out.items():
        assert v.shape[0] == 1500, k
        torch.testing.assert_close(v, whole[k], atol=1e-5, rtol=0)
    assert "weights_coarse" not in out and "rgb_coarse" in out


def test_flagship_chunk_size():
    from spnerf_torch.utils.synth import flagship_configs

    _, rc = flagship_configs()
    assert chunk_size(rc) == 1_500_000 // 256
