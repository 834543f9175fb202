"""The renderer's four opt-in pass layouts in the port against the JAX
package with the same switch, and against the port's own default layout,
on the CPU in float32.

The switches: SPNERF_BATCH_SC (the solar pass in one field call with the
view-ray pass before it), SPNERF_BATCH_SOLAR (the same with the solar rows
pruned in the model, `solar_tail`), SPNERF_NO_MERGE (the field again at
every sorted guided sample) and SPNERF_NO_PRUNE (every head in the solar
pass, the batched layouts off). The JAX package reads the last two when it
is imported, so the test sets its module attributes.

The cases are `tests/test_batch_solar.py`'s: a small Siren with semantics
and beta, with and without guided samples; a small hash field; the fine
pass; and a field callable without `supports_solar_tail`, which keeps
separate passes under SPNERF_BATCH_SOLAR. Each renders 6 rays with the JAX
key's draws handed to the port (`jax_draws`) and differentiates the sum of
the means of its outputs. Bars: every output within 1e-5; every gradient
within 2e-4 of its leaf's largest entry (float32 sums in another order).
The fine pass's outputs (`*_fine`) are held to the JAX package at 1e-4,
`tests/test_torch_paths.py`'s bar for that pass: an inverse CDF of the
coarse weights places its samples, and the two packages' default layouts
already differ there by 1.02e-5 (albedo_fine). Against the port's own
default layout every output is held at 1e-5. The field calls show that
each layout took effect: their number, a `solar_tail` under BATCH_SOLAR,
the second pass at every sorted sample under NO_MERGE, no pruned solar
call under NO_PRUNE.

One 2-rank mesh step (Gloo, two processes) under SPNERF_BATCH_SOLAR gives
the loss of the same step in the default layout within 1e-6 relative, as
`tests/test_multichip.py` holds the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spnerf_tpu.ops.render as jax_render
from spnerf_tpu import config as jconfig
from spnerf_tpu.train.loop import Trainer as JaxTrainer
from spnerf_torch.config import LossConfig, ModelConfig, RenderConfig
from spnerf_torch.convert import field_state_dict, flax_field_params
from spnerf_torch.ops import render_rays
from spnerf_torch.train.loop import Trainer
from spnerf_torch.utils.synth import fake_batch

from test_torch_paths import jax_draws
from test_torch_ranks import run_ranks

SWITCHES = ("SPNERF_BATCH_SC", "SPNERF_BATCH_SOLAR", "SPNERF_NO_MERGE",
            "SPNERF_NO_PRUNE")
SIREN = dict(mapping=True, sem=True, num_sem_classes=3, fc_units=16,
             fc_layers=2, skips=(1,), beta=True, t_embedding_dims=4)
RC = dict(n_samples=6, solar_correction=True, sem=True)
CASES = {
    "siren_guided": (SIREN, dict(RC, guidedsample=True)),
    "siren": (SIREN, dict(RC, guidedsample=False)),
    "hash": (dict(sem=True, num_sem_classes=3, encoding="hash",
                  hash_levels=3, hash_features=2, hash_log2T=8),
             dict(RC, guidedsample=True)),
    "fine": (dict(mapping=True, fc_units=16, fc_layers=2, skips=(1,)),
             dict(n_samples=6, n_importance=2, guidedsample=False,
                  solar_correction=True)),
}
# field calls of one render under each switch (the default: 3, 2, 3, 4)
CALLS = {"SPNERF_BATCH_SC": dict(siren_guided=2, siren=1, hash=2, fine=3),
         "SPNERF_BATCH_SOLAR": dict(siren_guided=2, siren=1, hash=2, fine=2),
         "SPNERF_NO_MERGE": dict(siren_guided=3, siren=2, hash=3, fine=4),
         "SPNERF_NO_PRUNE": dict(siren_guided=3, siren=2, hash=3, fine=4)}
N = 6
KEYS = ("rgb", "sun_sc", "weights_sc", "depth", "sem_logits", "beta")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(rc):
    """6 rays with labels (one IGNORE), depth targets and, with beta,
    transient embeddings."""
    g = np.random.default_rng(0)
    rays = fake_batch(g, N)["rays"]
    return {"rays": rays, "sems": np.array([0, 1, 2, 0, 1, -100], np.int32),
            "valid": np.array([1, 0, 1, 0, 1, 0], np.float32),
            "depths": np.stack([np.full(N, 0.7, np.float32),
                                np.ones(N, np.float32)], -1),
            "std": np.full(N, 0.05, np.float32),
            "t_emb": g.normal(size=(N, 4)).astype(np.float32)}


def loss_of(out, mean):
    return sum(mean(out[f"{k}_{typ}"]) for k in KEYS
               for typ in ("coarse", "fine") if f"{k}_{typ}" in out)


def pair(case):
    """(JAX trainer, its coarse params, port trainer, port field) on shared
    weights; the hash table redrawn at scale 0.1 so that it matters."""
    mkw, rkw = CASES[case]
    jtr = JaxTrainer(jconfig.ModelConfig(**mkw), jconfig.RenderConfig(**rkw),
                     jconfig.LossConfig())
    params = dict(jtr.init_state(jax.random.PRNGKey(0)).params)
    coarse = dict(params["coarse"])
    if "HashGridEncoding_0" in coarse:
        table = coarse["HashGridEncoding_0"]["table"]
        coarse["HashGridEncoding_0"] = {"table": jnp.asarray(
            np.random.default_rng(1).normal(size=table.shape)
            .astype(np.float32) * 0.1)}
    params["coarse"] = coarse
    ttr = Trainer(ModelConfig(**mkw), RenderConfig(**rkw), LossConfig(),
                  device="cpu")
    model = ttr.init_state(torch.Generator().manual_seed(0)).model
    model.load_state_dict(field_state_dict(coarse))
    return jtr, params, ttr, model


def jax_run(jtr, params, x, apply=None):
    """The JAX renderer's outputs and the gradient of their loss."""
    rc, key = jtr.rc, jax.random.PRNGKey(1)
    t_emb = jnp.asarray(x["t_emb"]) if jtr.mc.beta else None

    def loss_fn(p):
        field = apply(p) if apply else jtr._field_apply(p, "coarse")
        out = jax_render.render_rays(
            field, rc, jnp.asarray(x["rays"]), t_emb=t_emb,
            sems=jnp.asarray(x["sems"]) if jtr.mc.sem else None, key=key,
            train=rc.guidedsample, valid_depth=jnp.asarray(x["valid"]),
            target_depths=jnp.asarray(x["depths"]),
            target_std=jnp.asarray(x["std"]))
        return loss_of(out, jnp.mean), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    return {k: np.asarray(v) for k, v in out.items()}, grads["coarse"]


def port_run(ttr, model, x, field=None, calls=None):
    """The port's outputs and the gradient of their loss; `calls` gets
    (rows, heads, solar_tail) of each call of the trainer's field."""
    rc = ttr.rc
    model.zero_grad(set_to_none=True)
    t = lambda a: torch.from_numpy(np.asarray(a))
    if field is None:
        base = ttr.field_apply(model)

        def field(xyz, sun, t_emb, sems, heads=None, solar_tail=0):
            if calls is not None:
                calls.append((xyz.shape[0], heads, solar_tail))
            return base(xyz, sun, t_emb, sems, heads=heads,
                        solar_tail=solar_tail)

        field.supports_solar_tail = base.supports_solar_tail
    out = render_rays(
        field, rc, t(x["rays"]),
        t_emb=t(x["t_emb"]) if ttr.mc.beta else None,
        sems=t(x["sems"]) if ttr.mc.sem else None, train=rc.guidedsample,
        valid_depth=t(x["valid"]), target_depths=t(x["depths"]),
        target_std=t(x["std"]),
        draws=jax_draws(jax.random.PRNGKey(1), N, rc))
    loss_of(out, torch.mean).backward()
    grads = flax_field_params({k: p.grad for k, p in model.named_parameters()})
    return {k: v.detach().numpy() for k, v in out.items()}, grads


def assert_close(out, ref, grads, ref_grads, tag, fine_atol=1e-5):
    assert set(out) == set(ref), tag
    for k, v in ref.items():
        assert out[k].shape == v.shape, (tag, k)
        np.testing.assert_allclose(
            out[k], v, rtol=0, atol=fine_atol if k.endswith("_fine") else 1e-5,
            err_msg=f"{tag} {k}")
    flat = dict(jax.tree_util.tree_leaves_with_path(grads))
    leaves = jax.tree_util.tree_leaves_with_path(ref_grads)
    assert len(flat) == len(leaves), tag
    for path, g in leaves:
        g = np.asarray(g)
        np.testing.assert_allclose(
            np.asarray(flat[path]), g, rtol=0, atol=2e-4 * np.abs(g).max(),
            err_msg=f"{tag} {jax.tree_util.keystr(path)}")


def set_switch(monkeypatch, name):
    """`name` on in both packages."""
    monkeypatch.setenv(name, "1")
    if name in ("SPNERF_NO_MERGE", "SPNERF_NO_PRUNE"):
        monkeypatch.setattr(jax_render, "_" + name.split("_", 1)[1], True)


@pytest.mark.parametrize("switch", SWITCHES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_layout_matches_jax_and_the_default(case, switch, monkeypatch):
    jtr, params, ttr, model = pair(case)
    x = inputs(ttr.rc)
    default = port_run(ttr, model, x)
    set_switch(monkeypatch, switch)
    ref = jax_run(jtr, params, x)
    calls = []
    got = port_run(ttr, model, x, calls=calls)
    assert_close(got[0], ref[0], got[1], ref[1], f"{case} {switch} vs JAX",
                 fine_atol=1e-4)
    assert_close(got[0], default[0], got[1], default[1],
                 f"{case} {switch} vs the default layout")
    assert len(calls) == CALLS[switch][case], calls
    tails = [c[2] for c in calls]
    assert any(tails) == (switch == "SPNERF_BATCH_SOLAR"), calls
    if switch == "SPNERF_NO_PRUNE":
        assert all(c[1] is None for c in calls), calls
    if switch == "SPNERF_NO_MERGE" and ttr.rc.guidedsample:
        assert calls[1] == (N * 12, None, 0), calls


def test_batch_solar_requires_field_support(monkeypatch):
    """A field callable without `supports_solar_tail` (as the eval
    renderer's fused field) keeps separate passes: no call takes a
    `solar_tail`, and the render equals the JAX package's."""
    jtr, params, ttr, model = pair("siren")
    x = inputs(ttr.rc)
    monkeypatch.setenv("SPNERF_BATCH_SOLAR", "1")
    calls = []

    def field(xyz, sun, t_emb, sems, heads=None, **kw):
        calls.append((xyz.shape[0], heads, kw))
        return model(xyz, sun, t_emb, sems, heads=heads)

    ref = jax_run(jtr, params, x, apply=lambda p: (
        lambda xyz, sun, t, s, heads=None: jtr.model.apply(
            {"params": p["coarse"]}, xyz, sun, t, s, heads=heads)))
    got = port_run(ttr, model, x, field=field)
    assert calls == [(N * 6, None, {}), (N * 6, ("sun",), {})]
    assert_close(got[0], ref[0], got[1], ref[1], "no supports_solar_tail")


def test_batch_solar_mesh_step(tmp_path):
    """Two Gloo ranks, 3 steps of the small Siren (guided, solar, depth and
    semantic losses) at a global batch of 64 under SPNERF_BATCH_SOLAR and
    in the default layout, from the same state and draws: the losses agree
    within 1e-6 relative, and the two ranks' parameters are equal."""
    mkw, rkw = SIREN, dict(RC, guidedsample=True)
    lkw = dict(sc_lambda=0.1, depth=True, ds_lambda=1.0, stdscale=1.0,
               sem=True, ss_lambda=1.0)
    job = dict(mc=mkw, rc=rkw, lc=lkw, trainer=dict(lr=1e-3,
                                                    steps_per_epoch=3),
               data=fake_batch(np.random.default_rng(2), 512), steps=3,
               batch=64, seed=3,
               envs=[{}, {"SPNERF_BATCH_SOLAR": "1"}])
    res = run_ranks("mesh_steps", 2, job, tmp_path)
    for r in res:
        default, batched = r["runs"]
        np.testing.assert_allclose([d["loss"] for d in batched["losses"]],
                                   [d["loss"] for d in default["losses"]],
                                   rtol=1e-6)
        assert np.isfinite(batched["losses"][-1]["loss"])
    for k, v in res[0]["runs"][1]["params"].items():
        assert torch.equal(v, res[1]["runs"][1]["params"][k]), k
