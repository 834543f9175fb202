"""The port's hash-grid encoding and hash field against the JAX package's,
on shared weights, for both table layouts: the flat feature-major row and
the (L, T, F) table (`flat_table=False`).

The JAX side runs its plain impl="xla" (scatter-add autodiff), as its own
tests do on the CPU; the port's table gradient runs through its plain
version. Tables are redrawn at scale 0.5 (the ±1e-4 init would make any
tolerance vacuous). Tolerances: corner ids bit-equal; encoding output and
table gradient 1e-5 absolute in float32 (interpolation by lerps against
JAX's weight einsum on the flat table, and sums in another order); field
outputs and table gradients of the field 2e-5. The batched take (one
gather and one B4 plain version for all levels) is held to the per-level
route at 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnerf_tpu.config import ModelConfig as JaxModelConfig
from spnerf_tpu.models import HashGridEncoding as JaxEncoding
from spnerf_tpu.models import init_hash_spnerf as jax_init_hash_spnerf
from spnerf_tpu.models import load_model as jax_load_model
from spnerf_torch.config import ModelConfig
from spnerf_torch.convert import field_state_dict, flax_field_params
from spnerf_torch.models import HashSPNeRF, init_hash_spnerf, load_model
from spnerf_torch.models.hashgrid import (HashGridEncoding, HashTakeBatched,
                                          HashTakeRows, _hash_corners,
                                          interp_weights, level_ids,
                                          level_resolutions)

ATOL_ENC = 1e-5
ATOL_FIELD = 2e-5


def points(rng, n):
    """Points inside the box, on its +1 faces and outside it (as solar-pass
    points marching off the box are)."""
    xyz = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    xyz[: n // 8, 0] = 1.0  # on a +1 face
    xyz[n // 8: n // 4] = 1.0  # the +1 corner
    xyz[n // 4: n // 3] *= 1.7  # partly outside
    return xyz


def test_hash_corner_ids_bit_equal_jax(rng):
    from spnerf_tpu.models.hashgrid import _hash_corners as jax_hash_corners

    base = rng.integers(0, 2 ** 20, (513, 3))
    base[:8] = 2 ** 20 - 1
    for T in (2 ** 19, 2 ** 15, 1 << 13):
        ref = np.asarray(jax_hash_corners(jnp.asarray(base.astype(np.uint32)),
                                          T))
        out = _hash_corners(torch.from_numpy(base), T)
        assert out.dtype == torch.int64
        np.testing.assert_array_equal(out.numpy(), ref)


def test_level_geometry_matches_jax():
    assert list(level_resolutions(8)) == [16, 32, 64, 128, 256, 512, 1024,
                                          2048]
    enc = HashGridEncoding(n_levels=8, n_features=4, log2_table_size=19)
    # direct levels: next power of two of (res + 1)^3; hashed: T
    assert enc.level_table_sizes() == [8192, 65536] + [2 ** 19] * 6


def test_direct_ids_stay_in_the_level_table(rng):
    """The cell clamp: points on the +1 face index at most corner res."""
    x01 = torch.from_numpy(np.clip((points(rng, 400) + 1) * 0.5, 0, 1))
    for res in (16, 32, 64):
        idx, frac, t_eff = level_ids(x01, res, 2 ** 19)
        side = res + 1
        assert idx.max().item() == side ** 3 - 1  # the +1 corner itself
        assert idx.min().item() >= 0 and side ** 3 <= t_eff
        assert frac.max().item() == 1.0 and frac.min().item() >= 0.0


def make_encodings(rng, L, F, log2T, seed=0, flat_table=True):
    jenc = JaxEncoding(n_levels=L, n_features=F, log2_table_size=log2T,
                       impl="xla", direct_coarse=True, flat_table=flat_table)
    x0 = jnp.zeros((2, 3), jnp.float32)
    params = jenc.init(jax.random.PRNGKey(seed), x0)
    table = (rng.normal(size=params["params"]["table"].shape) * 0.5
             ).astype(np.float32)
    params = {"params": {"table": jnp.asarray(table)}}
    tenc = HashGridEncoding(n_levels=L, n_features=F, log2_table_size=log2T,
                            flat_table=flat_table)
    assert tuple(tenc.table.shape) == table.shape
    with torch.no_grad():
        tenc.table.copy_(torch.from_numpy(table))
    return jenc, params, tenc


@pytest.mark.parametrize("flat_table", [True, False])
@pytest.mark.parametrize("L,F,log2T", [(4, 2, 16), (3, 4, 13)])
def test_encoding_and_table_gradient_match_jax(rng, L, F, log2T, flat_table):
    """(4, 2, 2^16): level 0 direct in a sliced table (t_eff 8192), the rest
    hashed; (3, 4, 2^13): level 0 direct over the whole table. Both table
    layouts: the flat row (L, T * F) and the (L, T, F) table."""
    jenc, params, tenc = make_encodings(rng, L, F, log2T,
                                        flat_table=flat_table)
    assert tenc.level_table_sizes() == [8192] + [2 ** log2T] * (L - 1)
    xyz = points(rng, 600)
    w = rng.normal(size=(600, L * F)).astype(np.float32)

    def jloss(p):
        out = jenc.apply(p, jnp.asarray(xyz))
        return jnp.sum(out * jnp.asarray(w)), out

    (_, ref), g = jax.value_and_grad(jloss, has_aux=True)(params)
    out = tenc(torch.from_numpy(xyz))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATOL_ENC, rtol=0)
    gref = np.asarray(g["params"]["table"])
    assert np.abs(gref).max() > 1.0  # a real gradient, not the init's
    np.testing.assert_allclose(tenc.table.grad.numpy(), gref, atol=ATOL_ENC,
                               rtol=1e-6)


CFGS = {
    "sem": dict(sem=True, num_sem_classes=3),
    "beta": dict(beta=True),
}


def make_fields(rng, case, flat_table=True):
    kw = dict(encoding="hash", hash_levels=4, hash_features=2, hash_log2T=14,
              hash_hidden=32, hash_flat_table=flat_table, **CFGS[case])
    jmodel = jax_load_model(JaxModelConfig(**kw), hash_impl="xla")
    n = 2
    args = (jnp.zeros((n, 3)), jnp.zeros((n, 3)),
            jnp.zeros((n, 4)) if kw.get("beta") else None,
            jnp.zeros((n,), jnp.int32) if kw.get("sem") else None)
    params = jmodel.init(jax.random.PRNGKey(1), *args)["params"]
    params = dict(params)
    params["HashGridEncoding_0"] = {"table": jnp.asarray(
        rng.normal(size=params["HashGridEncoding_0"]["table"].shape)
        .astype(np.float32) * 0.5)}
    tmodel = HashSPNeRF(ModelConfig(**kw))
    tmodel.load_state_dict(field_state_dict(params))
    return jmodel, {"params": params}, tmodel


def field_inputs(rng, n, cfg):
    xyz = points(rng, n)
    sun = rng.normal(size=(n, 3)).astype(np.float32)
    sun /= np.linalg.norm(sun, axis=-1, keepdims=True)
    sems = rng.integers(-1, cfg.num_sem_classes, size=n).astype(np.int32)
    sems = np.where(sems < 0, -100, sems).astype(np.int32)
    t_emb = rng.normal(size=(n, cfg.t_embedding_dims)).astype(np.float32)
    return xyz, sun, (t_emb if cfg.beta else None), (sems if cfg.sem else None)


@pytest.mark.parametrize("case", sorted(CFGS))
@pytest.mark.parametrize("heads", [None, ("sun",), ("rgb", "sky"),
                                   ("beta", "sem")])
def test_hash_field_matches_flax(rng, case, heads):
    jmodel, params, tmodel = make_fields(rng, case)
    inputs = field_inputs(rng, 300, tmodel.cfg)
    kw = {} if heads is None else {"heads": heads}
    ref = jmodel.apply(params, *(None if a is None else jnp.asarray(a)
                                 for a in inputs), **kw)
    with torch.no_grad():
        out = tmodel(*(None if a is None else torch.from_numpy(a)
                       for a in inputs), **kw)
    assert set(out) == set(ref)
    for k in ref:
        assert tuple(out[k].shape) == ref[k].shape, k
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=ATOL_FIELD, rtol=0, err_msg=k)


def test_hash_field_anneal_matches_flax(rng):
    jmodel, params, tmodel = make_fields(rng, "sem")
    inputs = field_inputs(rng, 200, tmodel.cfg)
    anneal = np.array([1.0, 1.0, 0.25, 0.0], np.float32)
    ref = jmodel.apply(params, *(None if a is None else jnp.asarray(a)
                                 for a in inputs), anneal=jnp.asarray(anneal))
    with torch.no_grad():
        out = tmodel(*(None if a is None else torch.from_numpy(a)
                       for a in inputs), anneal=torch.from_numpy(anneal))
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=ATOL_FIELD, rtol=0, err_msg=k)


@pytest.mark.parametrize("case", sorted(CFGS))
def test_hash_weight_bridge_round_trip(rng, case):
    _, params, tmodel = make_fields(rng, case)
    back = flax_field_params(tmodel.state_dict())
    flat_ref = jax.tree_util.tree_leaves_with_path(params["params"])
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_ref) == len(flat_back)
    for path, leaf in flat_ref:
        np.testing.assert_array_equal(np.asarray(flat_back[path]),
                                      np.asarray(leaf))


def test_hash_model_loads_and_refuses_unported_options():
    cfg = ModelConfig(encoding="hash", hash_levels=2, hash_log2T=10,
                      hash_hidden=16, sem=True, num_sem_classes=3)
    a = load_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = load_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    c = init_hash_spnerf(torch.Generator().manual_seed(3), cfg, device="cpu")
    assert isinstance(a, HashSPNeRF)
    for (k, va), vb, vc in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert torch.equal(va, vb) and torch.equal(va, vc), k
    assert a.encoding.table.abs().max() <= 1e-4
    assert a.encoding.table.shape == (2, 2 ** 10 * 4)
    # solar_tail: every head on the leading rows, sigma and sun_v on all
    # (held against the JAX package in tests/test_torch_layouts.py)
    xyz = torch.rand(5, 3, generator=torch.Generator().manual_seed(4)) - 0.5
    args = (xyz, torch.nn.functional.normalize(xyz + 1.0, dim=-1), None,
            torch.tensor([0, 1, 2, -100, 1]))
    whole, tail = a(*args), a(*args, solar_tail=2)
    assert set(tail) == set(whole)
    for k, v in whole.items():
        rows = 5 if k in ("sigma", "sun_v") else 3
        assert tail[k].shape[0] == rows, k
        torch.testing.assert_close(tail[k], v[:rows], rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", sorted(CFGS))
def test_nonflat_hash_field_and_table_gradient_match_flax(rng, case):
    """HashSPNeRF with the (L, T, F) table against JAX flat_table=False on
    shared weights (through the weight bridge): every output, and the table
    gradient of a weighted sum of them."""
    jmodel, params, tmodel = make_fields(rng, case, flat_table=False)
    assert tmodel.encoding.table.shape == (4, 2 ** 14, 2)
    inputs = field_inputs(rng, 300, tmodel.cfg)
    keys = ["sigma", "rgb", "sun_v", "sky"] + (["beta"] if tmodel.cfg.beta
                                              else ["sem_logits"])
    ws = {k: rng.normal(size=(300,) if k == "sigma" else (300, 1))
          .astype(np.float32) for k in keys}

    def jloss(p):
        out = jmodel.apply(p, *(None if a is None else jnp.asarray(a)
                                for a in inputs))
        return sum(jnp.sum(out[k] * ws[k]) for k in keys), out

    (_, ref), g = jax.value_and_grad(jloss, has_aux=True)(params)
    out = tmodel(*(None if a is None else torch.from_numpy(a)
                   for a in inputs))
    sum((out[k] * torch.from_numpy(ws[k])).sum() for k in keys).backward()
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(ref[k]), atol=ATOL_FIELD,
                                   rtol=0, err_msg=k)
    gref = np.asarray(g["params"]["HashGridEncoding_0"]["table"])
    scale = np.abs(gref).max()
    assert scale > 0
    np.testing.assert_allclose(tmodel.encoding.table.grad.numpy(), gref,
                               atol=ATOL_FIELD * max(scale, 1.0), rtol=0)


def test_take_batched_matches_per_level_route(rng):
    """HashTakeBatched (one gather from every level's full table, one plain
    B4 backward) against the per-level rows route (HashTakeRows on the
    levels' t_eff slices, per-level table gradients): the same features and
    the same (L, T, F) table gradient."""
    L, F, log2T = 4, 2, 16
    _, _, tenc = make_encodings(rng, L, F, log2T, flat_table=False)
    x01 = torch.from_numpy(np.clip((points(rng, 500) + 1) * 0.5, 0, 1))
    w = torch.from_numpy(rng.normal(size=(500, L * F)).astype(np.float32))
    levels = [level_ids(x01, r, tenc.table_size) for r in tenc.resolutions]
    assert levels[0][2] < tenc.table_size  # a direct level in a slice

    def run(batched):
        tab = tenc.table.detach().clone().requires_grad_(True)
        if batched:
            vals = HashTakeBatched.apply(
                tab, torch.stack([i for i, _, _ in levels]))
            feats = [interp_weights(vals[l], f)
                     for l, (_, f, _) in enumerate(levels)]
        else:
            feats = [interp_weights(HashTakeRows.apply(tab[l][:t], i), f)
                     for l, (i, f, t) in enumerate(levels)]
        out = torch.cat(feats, dim=-1)
        (out * w).sum().backward()
        return out.detach(), tab.grad

    out_b, g_b = run(True)
    out_l, g_l = run(False)
    assert g_b.shape == (L, 2 ** log2T, F)
    assert g_l.abs().max() > 1.0
    torch.testing.assert_close(out_b, out_l, atol=1e-5, rtol=0)
    torch.testing.assert_close(g_b, g_l, atol=1e-5, rtol=0)


@pytest.mark.parametrize("flat_table", [True, False])
def test_table_shape_per_impl_matches_jax(flat_table):
    """The impl decides the table's layout as in the JAX package: flat only
    for flat_table with "xla" or "matmul_vjp" ("auto" is one of them)."""
    from spnerf_torch.models.hashgrid import HASH_IMPLS

    for impl in HASH_IMPLS:
        kw = dict(encoding="hash", hash_levels=3, hash_features=2,
                  hash_log2T=10, hash_hidden=16, hash_flat_table=flat_table)
        jcfg = JaxModelConfig(hash_impl=impl, **kw)
        jimpl = "xla" if impl == "auto" else impl
        _, params = jax_init_hash_spnerf(
            jax.random.PRNGKey(0), jcfg, n_levels=3, n_features=2,
            log2_table_size=10, hidden=16, enc_impl=jimpl,
            flat_table=flat_table)
        ref = params["params"]["HashGridEncoding_0"]["table"].shape
        model = load_model(ModelConfig(hash_impl=impl, **kw), device="cpu")
        assert tuple(model.encoding.table.shape) == ref, impl
    with pytest.raises(ValueError, match="impl"):
        load_model(ModelConfig(hash_impl="fast", **kw), device="cpu")
