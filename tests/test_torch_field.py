"""The port's SP-NeRF field module against the flax field, on shared weights.

Inputs come from numpy, weights from flax through the port's weight bridge.
Tolerance: 2e-5 absolute in float32 (the two sides differ only in the order
of float32 sums and in the last bit of sin/cos).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnerf_tpu.config import ModelConfig as JaxModelConfig
from spnerf_tpu.models import init_spnerf as jax_init_spnerf
from spnerf_torch.config import ModelConfig
from spnerf_torch.convert import (field_state_dict, flax_field_params,
                                  transient_state_dict)
from spnerf_torch.models import SPNeRF, TransientEmbedding, load_model
from spnerf_torch.models.spnerf import fast_sin

ATOL = 2e-5
CASES = {
    "sem": dict(sem=True, num_sem_classes=3),
    "plain": dict(),
    "beta": dict(beta=True),
    "sem5": dict(sem=True, num_sem_classes=5),
}


def make_pair(kw, width=64, seed=0):
    """(flax model, flax params, port model) with the same weights."""
    kw = dict(mapping=True, fc_units=width, fc_layers=8, skips=(4,), **kw)
    jmodel, params = jax_init_spnerf(jax.random.PRNGKey(seed),
                                     JaxModelConfig(**kw))
    tmodel = SPNeRF(ModelConfig(**kw))
    tmodel.load_state_dict(field_state_dict(params["params"]))
    return jmodel, params, tmodel


def make_inputs(rng, n, cfg):
    xyz = rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    sun = rng.normal(size=(n, 3)).astype(np.float32)
    sun /= np.linalg.norm(sun, axis=-1, keepdims=True)
    sems = rng.integers(-1, cfg.num_sem_classes, size=n).astype(np.int32)
    sems = np.where(sems < 0, -100, sems).astype(np.int32)  # IGNORE labels
    t_emb = rng.normal(size=(n, cfg.t_embedding_dims)).astype(np.float32)
    return xyz, sun, (sems if cfg.sem else None), (t_emb if cfg.beta else None)


def run_both(jmodel, params, tmodel, inputs, **kw):
    xyz, sun, sems, t_emb = inputs
    ref = jmodel.apply(params, jnp.asarray(xyz), jnp.asarray(sun),
                       None if t_emb is None else jnp.asarray(t_emb),
                       None if sems is None else jnp.asarray(sems), **kw)
    with torch.no_grad():
        out = tmodel(torch.from_numpy(xyz), torch.from_numpy(sun),
                     None if t_emb is None else torch.from_numpy(t_emb),
                     None if sems is None else torch.from_numpy(sems), **kw)
    return ref, out


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("heads", [None, ("sun",)])
def test_field_matches_flax(case, heads, rng):
    jmodel, params, tmodel = make_pair(CASES[case])
    inputs = make_inputs(rng, 300, tmodel.cfg)
    ref, out = run_both(jmodel, params, tmodel, inputs, heads=heads)
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=ATOL, rtol=0, err_msg=k)


def test_field_sigma_only_matches_flax(rng):
    jmodel, params, tmodel = make_pair(CASES["sem"])
    inputs = make_inputs(rng, 100, tmodel.cfg)
    ref, out = run_both(jmodel, params, tmodel, inputs, sigma_only=True)
    assert set(out) == {"sigma"}
    np.testing.assert_allclose(out["sigma"].numpy(), np.asarray(ref["sigma"]),
                               atol=ATOL, rtol=0)


def test_bf16_field_close_to_flax(rng):
    """bf16 compute: both sides round operands to bf16 but the port rounds
    each activation once from float32; held to 5e-2."""
    kw = dict(mapping=True, sem=True, num_sem_classes=3, fc_units=64,
              fc_layers=8, skips=(4,))
    jmodel, params = jax_init_spnerf(jax.random.PRNGKey(0),
                                     JaxModelConfig(**kw),
                                     compute_dtype=jnp.bfloat16)
    tmodel = SPNeRF(ModelConfig(**kw), compute_dtype="bfloat16")
    tmodel.load_state_dict(field_state_dict(params["params"]))
    ref, out = run_both(jmodel, params, tmodel,
                        make_inputs(rng, 200, tmodel.cfg))
    for k in ref:
        np.testing.assert_allclose(out[k].float().numpy(),
                                   np.asarray(ref[k], np.float32),
                                   atol=5e-2, rtol=0, err_msg=k)


@pytest.mark.parametrize("case", ["sem", "beta"])
def test_weight_bridge_round_trip(case):
    _, params, tmodel = make_pair(CASES[case])
    back = flax_field_params(tmodel.state_dict())
    flat_ref = jax.tree_util.tree_leaves_with_path(params["params"])
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_ref) == len(flat_back)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(np.asarray(flat_back[path]),
                                      np.asarray(leaf))


def test_transient_embedding_matches_flax():
    from spnerf_tpu.models import TransientEmbedding as JaxTE

    te = JaxTE(vocab=7, dims=4)
    p = te.init(jax.random.PRNGKey(3), jnp.zeros((2,), jnp.int32))
    ts = np.array([0, 3, 6, 3], np.int32)
    ref = te.apply(p, jnp.asarray(ts))
    mod = TransientEmbedding(7, 4)
    mod.load_state_dict(transient_state_dict(p["params"]))
    np.testing.assert_array_equal(mod(torch.from_numpy(ts)).detach().numpy(),
                                  np.asarray(ref))


def test_fast_sin_matches_jax(rng):
    from spnerf_tpu.models.spnerf import fast_sin as jax_fast_sin

    x = (rng.normal(size=4096) * 60).astype(np.float32)
    x[:4] = [0.5 * np.pi, 1.5 * np.pi, -2.5 * np.pi, 0.0]  # rounding ties
    np.testing.assert_allclose(fast_sin(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_fast_sin(jnp.asarray(x))),
                               atol=1e-6, rtol=0)


def test_init_is_seeded_and_bounded():
    cfg = ModelConfig(mapping=True, sem=True, num_sem_classes=3, fc_units=64)
    a = load_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    b = load_model(cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    for (ka, va), (_, vb) in zip(a.state_dict().items(),
                                 b.state_dict().items()):
        assert torch.equal(va, vb), ka
    k0 = a.layer("trunk0").kernel
    assert k0.abs().max() <= 1.0 / k0.shape[0]  # first-layer sine init
    k1 = a.layer("trunk1").kernel
    assert k1.abs().max() <= np.sqrt(6.0 / k1.shape[0])
    assert torch.all(a.semantic_embedding[3] == 0)  # IGNORE pad row


def test_hash_encoding_not_ported():
    """The hash family is ported with both table layouts and with its
    multi-AOI frames (held against the JAX package in
    tests/test_torch_multi.py); a frame count below 1 is refused."""
    model = load_model(ModelConfig(encoding="hash", hash_log2T=10,
                                   hash_frames=2), device="cpu")
    assert model.encoding.frames == 2
    assert model.encoding.table.shape == (8, 2 ** 10 * 4)
    with pytest.raises(ValueError, match="hash_frames"):
        load_model(ModelConfig(encoding="hash", hash_log2T=10, hash_frames=0),
                   device="cpu")
    model = load_model(ModelConfig(encoding="hash", hash_log2T=10,
                                   hash_flat_table=False), device="cpu")
    assert model.encoding.table.shape == (8, 2 ** 10, 4)
