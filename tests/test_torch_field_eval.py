"""The fused field's plain version against the JAX package's Pallas kernel
run in interpret mode, on shared weights and numpy inputs.

Tolerances: float32 1e-5 absolute (sum order only). bf16 2e-2 absolute: both
sides round the same float32 activations to bf16 operands, but a sum-order
difference can move an activation across a rounding boundary and one bf16
ulp (2^-8 relative) then propagates through the remaining layers.

The CUDA kernel itself is tested on the card by tests/test_torch_cuda.py.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnerf_tpu.config import ModelConfig as JaxModelConfig
from spnerf_tpu.models import init_spnerf as jax_init_spnerf
from spnerf_tpu.ops.pallas import field_eval as jfe
from spnerf_torch.config import ModelConfig
from spnerf_torch.convert import field_state_dict
from spnerf_torch.models import SPNeRF
from spnerf_torch.ops import field_eval as tfe

ALL = ("rgb", "sun", "sky", "beta", "sem")


def make_pair(width=64, seed=0, **kw):
    kw = dict(mapping=True, fc_units=width, fc_layers=8, skips=(4,), **kw)
    _, params = jax_init_spnerf(jax.random.PRNGKey(seed), JaxModelConfig(**kw))
    model = SPNeRF(ModelConfig(**kw))
    model.load_state_dict(field_state_dict(params["params"]))
    return params["params"], JaxModelConfig(**kw), model


def make_inputs(rng, n, cfg):
    xyz = rng.normal(size=(n, 3)).astype(np.float32) * 0.3
    sun = rng.normal(size=(n, 3)).astype(np.float32)
    sun /= np.linalg.norm(sun, axis=-1, keepdims=True)
    sems = rng.integers(-1, cfg.num_sem_classes, size=n).astype(np.int32)
    sems = np.where(sems < 0, -100, sems).astype(np.int32)
    t_emb = rng.normal(size=(n, cfg.t_embedding_dims)).astype(np.float32)
    return xyz, sun, (sems if cfg.sem else None), (t_emb if cfg.beta else None)


def jax_fused(params, jcfg, inputs, dtype, heads):
    names, ws, bs, sem_table = jfe.pack_params(params, jcfg)
    xyz, sun, sems, t_emb = inputs
    out = jfe._fused_apply(
        ws, bs, sem_table, jnp.asarray(xyz), jnp.asarray(sun),
        None if sems is None else jnp.asarray(sems),
        None if t_emb is None else jnp.asarray(t_emb), jcfg, names, dtype,
        interpret=True, heads=tuple(heads))
    return {k: np.asarray(v) for k, v in out.items()}


def port_fused(model, inputs, dtype, heads):
    xyz, sun, sems, t_emb = inputs
    field = tfe.FusedField(tfe.pack_params(model), dtype)
    as_t = lambda a: None if a is None else torch.from_numpy(a)
    out = field(as_t(xyz), as_t(sun), as_t(t_emb), as_t(sems), heads=heads)
    return {k: v.numpy() for k, v in out.items()}


def assert_match(out, ref, atol):
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_allclose(out[k], ref[k], atol=atol, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("case", ["sem", "beta"])
def test_plain_matches_pallas_interpret(dtype, atol, case, rng):
    kw = (dict(sem=True, num_sem_classes=3) if case == "sem"
          else dict(beta=True))
    params, jcfg, model = make_pair(**kw)
    inputs = make_inputs(rng, 700, model.cfg)  # not a multiple of 512
    before = tfe.FusedField.launches
    out = port_fused(model, inputs, dtype, ALL)
    assert tfe.FusedField.launches == before  # CPU: plain version, no launch
    assert_match(out, jax_fused(params, jcfg, inputs, dtype, ALL), atol)


@pytest.mark.parametrize("heads", [(), ("rgb",), ("sun",), ("sky",),
                                   ("sem",), ("rgb", "sky", "sem")])
def test_plain_head_subsets_match_pallas(heads, rng):
    params, jcfg, model = make_pair(sem=True, num_sem_classes=3)
    inputs = make_inputs(rng, 200, model.cfg)
    assert_match(port_fused(model, inputs, "float32", heads),
                 jax_fused(params, jcfg, inputs, "float32", heads), 1e-5)


def test_every_head_subset_is_a_restriction(rng):
    """Each of the 32 head subsets gives exactly the all-heads values of the
    outputs it names, and nothing else."""
    _, _, model = make_pair(sem=True, beta=True, num_sem_classes=3)
    inputs = make_inputs(rng, 64, model.cfg)
    full = port_fused(model, inputs, "float32", ALL)
    for r in range(len(ALL) + 1):
        for heads in itertools.combinations(ALL, r):
            out = port_fused(model, inputs, "float32", heads)
            want = {"sigma"} | {dict(rgb="rgb", sun="sun_v", sky="sky",
                                     beta="beta", sem="sem_logits")[h]
                                for h in heads}
            assert set(out) == want, heads
            for k in out:
                np.testing.assert_array_equal(out[k], full[k])


def test_pack_params_layout():
    """The kernel layout holds every weight, bf16-rounded, at its padded
    place, and zeros elsewhere."""
    _, _, model = make_pair(sem=True, beta=True, num_sem_classes=3)
    p = tfe.pack_params(model)
    assert p.k0_pad == 64 and len(p.names) == len(p.desc) == 22
    nonzero = 0
    for name, w, (w_off, _, k1, k2, npad, nreal) in zip(p.names, p.ws,
                                                        p.desc):
        assert k1 % 16 == 0 and k2 % 16 == 0 and npad % 16 == 0
        blk = p.w_all[w_off:w_off + (k1 + k2) * npad].reshape(k1 + k2, npad)
        assert nreal == w.shape[1]
        # a two-segment layer's first segment (fc_units) needs no padding
        seg1 = min(k1, w.shape[0])
        assert torch.equal(blk[:seg1, :nreal], w[:seg1].bfloat16()), name
        if k2:
            rest = w.shape[0] - seg1
            assert torch.equal(blk[k1:k1 + rest, :nreal],
                               w[seg1:].bfloat16()), name
        nonzero += int((blk != 0).sum())
    assert nonzero == sum(int((w.bfloat16() != 0).sum()) for w in p.ws)


def test_flops_per_point_flagship():
    cfg = ModelConfig(mapping=True, sem=True, num_sem_classes=3)
    assert tfe.flops_per_point(cfg) == 2 * 2_690_560
    assert tfe.flops_per_point(cfg, ("sun",)) == 4_850_688


def test_kernel_refuses_cpu_tensors():
    _, _, model = make_pair(sem=True, num_sem_classes=3)
    p = tfe.pack_params(model)
    with pytest.raises(ValueError):
        tfe.fused_field_kernel(p, torch.zeros(4, 63), torch.zeros(4, 3))
