"""The port's training losses against the JAX package's, on the same
renderer outputs (random, from numpy), in every branch: colour with and
without solar terms and beta, depth as masked MSE, all-depth MSE, GNLL and
all-depth GNLL, semantics with ignored labels, and the drop schedules.
Values and input gradients in float32: 1e-6 absolute and 1e-6 relative (the
same operations, summed in another order; the GNLL of a fully transparent
ray, whose variance sits at its 1e-6 floor, reaches values in the
thousands)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnerf_tpu.config import LossConfig as JaxLossConfig
from spnerf_tpu.train import losses as jl
from spnerf_torch.config import LossConfig
from spnerf_torch.train import losses as tl

ATOL = 1e-6
RTOL = 1e-6
R, S, C = 48, 12, 3


def fake_results(seed, fine=False):
    rng = np.random.default_rng(seed)
    res = {}
    for typ in ("coarse", "fine") if fine else ("coarse",):
        w = rng.uniform(size=(R, S)).astype(np.float32) / S
        w[0] = 0.0  # a fully transparent ray
        z = np.sort(rng.uniform(size=(R, S)), axis=-1).astype(np.float32)
        res.update({
            f"rgb_{typ}": rng.uniform(size=(R, 3)).astype(np.float32),
            f"depth_{typ}": (w * z).sum(-1).astype(np.float32),
            f"weights_{typ}": w,
            f"z_vals_{typ}": z,
            f"weights_sc_{typ}": rng.uniform(size=(R, S)).astype(np.float32),
            f"transparency_sc_{typ}": rng.uniform(size=(R, S)).astype(
                np.float32),
            f"sun_sc_{typ}": rng.uniform(size=(R, S, 1)).astype(np.float32),
            f"beta_{typ}": rng.uniform(0.1, 1, size=(R, S, 1)).astype(
                np.float32),
            f"sem_logits_{typ}": rng.normal(size=(R, C)).astype(np.float32),
        })
    return res


def fake_batch(seed):
    rng = np.random.default_rng(seed + 100)
    sems = rng.integers(-1, C, R)
    return {
        "rgbs": rng.uniform(size=(R, 3)).astype(np.float32),
        "depths": np.stack([rng.uniform(size=R), rng.uniform(size=R)],
                           -1).astype(np.float32),
        "valid_depth": (rng.uniform(size=R) > 0.4).astype(np.float32),
        "depth_std": rng.uniform(0.01, 0.2, size=R).astype(np.float32),
        "sems": np.where(sems < 0, -100, sems).astype(np.int32),
    }


def both_totals(lc_kw, seed, step, use_beta, fine=False):
    """Total and terms from both packages, and the gradients of the total
    with respect to every renderer output."""
    res, batch = fake_results(seed, fine), fake_batch(seed)
    jlc, tlc = JaxLossConfig(**lc_kw), LossConfig(**lc_kw)

    def jtotal(r):
        return jl.total_loss(r, {k: jnp.asarray(v) for k, v in batch.items()},
                             jlc, step, 100.0, 200.0, use_beta_loss=use_beta)

    (jt, jd), jg = jax.value_and_grad(jtotal, has_aux=True)(
        {k: jnp.asarray(v) for k, v in res.items()})
    tres = {k: torch.from_numpy(v).requires_grad_() for k, v in res.items()}
    tt, td = tl.total_loss(tres, {k: torch.from_numpy(v)
                                  for k, v in batch.items()},
                           tlc, step, 100.0, 200.0, use_beta_loss=use_beta)
    tt.backward()
    return (jt, jd, jg), (tt, td, tres)


BRANCHES = {
    "color": dict(),
    "solar": dict(sc_lambda=0.1),
    "depth_subset": dict(depth=True, ds_lambda=1.0),
    "depth_all": dict(depth=True, ds_lambda=1.0, usealldepth=True),
    "gnll_subset": dict(depth=True, ds_lambda=1.0, gnll=True),
    "gnll_all": dict(depth=True, ds_lambda=1.0, gnll=True, usealldepth=True),
    "sem": dict(sem=True, ss_lambda=0.5),
    "beta": dict(beta=True, sc_lambda=0.1),
    "flagship": dict(sc_lambda=0.1, depth=True, ds_lambda=1.0, sem=True,
                     ss_lambda=1.0),
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
@pytest.mark.parametrize("step,use_beta", [(0, False), (150, True),
                                           (250, True)])
def test_total_loss_matches_jax(branch, step, use_beta):
    """Steps 0, 150 and 250 sit before both drops, after the depth drop
    (100) and after the semantic drop (200)."""
    fine = branch == "beta"  # each pass composites its own beta
    (jt, jd, jg), (tt, td, tres) = both_totals(BRANCHES[branch], 7, step,
                                              use_beta, fine)
    np.testing.assert_allclose(tt.item(), float(jt), atol=ATOL, rtol=RTOL)
    assert set(td) == set(jd)
    for k in jd:
        np.testing.assert_allclose(float(td[k].detach()), float(jd[k]),
                                   atol=ATOL, rtol=RTOL, err_msg=k)
    for k, g in jg.items():
        tg = tres[k].grad
        g = np.asarray(g)
        if not np.any(g):
            assert tg is None or not torch.any(tg), k
            continue
        np.testing.assert_allclose(tg.numpy(), g, atol=ATOL, rtol=RTOL,
                                   err_msg=k)


def test_solar_terms_hold_weights_and_transparency_constant():
    res = {k: torch.from_numpy(v).requires_grad_()
           for k, v in fake_results(3).items()}
    t2, t3 = tl.solar_correction_terms(
        {k[:-len("_coarse")]: v for k, v in res.items()}, 0.1)
    (t2 + t3).backward()
    assert res["transparency_sc_coarse"].grad is None
    assert res["weights_sc_coarse"].grad is None
    assert torch.any(res["sun_sc_coarse"].grad != 0)


def test_depth_std_floor_keeps_transparent_rays_finite():
    res = {k: torch.from_numpy(v).requires_grad_()
           for k, v in fake_results(5).items()}
    batch = fake_batch(5)
    batch["valid_depth"][:] = 1.0
    lc = LossConfig(depth=True, ds_lambda=1.0, gnll=True, usealldepth=True)
    depths = torch.from_numpy(batch["depths"])
    total, _ = tl.depth_loss(res, depths[:, 0], depths[:, 1],
                             torch.from_numpy(batch["valid_depth"]),
                             torch.from_numpy(batch["depth_std"]), lc)
    total.backward()
    assert torch.isfinite(res["weights_coarse"].grad).all()  # ray 0: all zero


def test_semantic_loss_ignores_void_labels():
    res = {k: torch.from_numpy(v) for k, v in fake_results(2).items()}
    labels = torch.full((R,), -100, dtype=torch.int32)
    total, d = tl.semantic_loss(res, labels, LossConfig(sem=True))
    assert total.item() == 0.0 and d["coarse_ss"].item() == 0.0
