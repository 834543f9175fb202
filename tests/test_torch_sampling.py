"""The port's samplers and compositor against the JAX package's.

Random variants get the same draws on both sides: the JAX sampler draws from
its key, and the port is handed those draws. Tolerance in float32: 1e-5
absolute plus 5e-5 relative. Depths lie in [0, 2] and only the rounding of
sums differs, but inverse-CDF sampling divides cumulative-sum differences by
small bin masses, which scales that rounding up.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnerf_tpu.ops import compositing as jc
from spnerf_tpu.ops import sampling as js
from spnerf_torch.ops import compositing as tc
from spnerf_torch.ops import sampling as ts

ATOL = 1e-5
RTOL = 5e-5
R, S = 96, 16


def t(a):
    return torch.from_numpy(np.array(a))


def close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL,
                               rtol=RTOL)


@pytest.fixture
def coarse(rng):
    """Per-ray bounds, sorted coarse z values and weights summing to <= 1."""
    near = np.zeros((R, 1), np.float32) + rng.uniform(0, 0.2, (R, 1)).astype(
        np.float32)
    far = near + 1.5
    z = np.sort(rng.uniform(near, far, (R, S)).astype(np.float32), axis=-1)
    w = rng.uniform(size=(R, S)).astype(np.float32)
    w[: R // 4] = 0.0  # empty rays: degenerate 3-sigma ranges
    w = w / np.maximum(w.sum(-1, keepdims=True), 1.0) * 0.9
    depth = (w * z).sum(-1)
    return near, far, z, w, depth


@pytest.mark.parametrize("perturb", [0.0, 1.0])
def test_stratified_z_vals(perturb, coarse):
    near, far = coarse[0], coarse[1]
    key = jax.random.PRNGKey(1)
    ref = js.stratified_z_vals(key, jnp.asarray(near), jnp.asarray(far), S,
                               perturb)
    u = jax.random.uniform(key, (R, S)) if perturb else None
    out = ts.stratified_z_vals(t(near), t(far), S, perturb,
                               u=None if u is None else t(u))
    close(out, ref)


@pytest.mark.parametrize("det", [True, False])
def test_sample_pdf(det, coarse):
    _, _, z, w, _ = coarse
    bins = np.concatenate([z, z[:, -1:] + 0.1], axis=-1)
    key = jax.random.PRNGKey(2)
    ref = js.sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), 24, det=det)
    u = None if det else t(jax.random.uniform(key, (R, 24)))
    close(ts.sample_pdf(t(bins), t(w), 24, det=det, u=u), ref)


def test_sample_3sigma_per_ray_bounds(coarse):
    near, far, _, _, depth = coarse
    lo, hi = depth - 0.3, depth + 0.3
    ref = js.sample_3sigma(None, jnp.asarray(lo), jnp.asarray(hi), S, True,
                           jnp.asarray(near[:, 0]), jnp.asarray(far[:, 0]))
    out = ts.sample_3sigma(t(lo), t(hi), S, True, t(near[:, 0]), t(far[:, 0]))
    close(out, ref)


@pytest.mark.parametrize("det", [True, False])
def test_compute_samples_around_depth(det, coarse):
    near, far, z, w, depth = coarse
    key = jax.random.PRNGKey(3)
    ref = js.compute_samples_around_depth(
        None if det else key, jnp.asarray(depth), jnp.asarray(w),
        jnp.asarray(z), S, det, 0.0, 1.7)
    u = None if det else t(jax.random.uniform(key, (R, S)))
    out = ts.compute_samples_around_depth(t(depth), t(w), t(z), S, det, 0.0,
                                          1.7, u=u)
    close(out, ref)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("det", [True, False])
def test_guided_samples(train, det, coarse, rng):
    near, far, z, w, depth = coarse
    valid = (rng.uniform(size=R) > 0.5).astype(np.float32)
    tgt = rng.uniform(0.2, 1.2, R).astype(np.float32)
    std = np.full(R, 0.05, np.float32)
    key = None if det else jax.random.PRNGKey(4)
    args = dict(near=near[:, 0], far=far[:, 0], train=train,
                valid_depth=valid, target_depth=tgt, target_std=std)
    ref = js.guided_samples(key, jnp.asarray(depth), jnp.asarray(w),
                            jnp.asarray(z), S, det,
                            **{k: (v if isinstance(v, bool) else
                                   jnp.asarray(v)) for k, v in args.items()})
    u_pred = u_gt = None
    if not det:
        k1, k2 = jax.random.split(key)
        u_pred = t(jax.random.uniform(k1, (R, S)))
        u_gt = t(jax.random.uniform(k2, (R, S)))
    out = ts.guided_samples(
        t(depth), t(w), t(z), S, det, u_pred=u_pred, u_gt=u_gt,
        **{k: (v if isinstance(v, bool) else t(v)) for k, v in args.items()})
    close(out, ref)


@pytest.mark.parametrize("heads", ["all", "sun", "sigma"])
def test_composite(heads, coarse, rng):
    _, _, z, _, _ = coarse
    f = {"sigma": rng.normal(size=(R, S)).astype(np.float32) * 5}
    if heads in ("all", "sun"):
        f["sun_v"] = rng.uniform(size=(R, S, 1)).astype(np.float32)
    if heads == "all":
        f["rgb"] = rng.uniform(size=(R, S, 3)).astype(np.float32)
        f["sky"] = rng.uniform(size=(R, S, 3)).astype(np.float32)
        f["beta"] = rng.uniform(size=(R, S, 1)).astype(np.float32)
        f["sem_logits"] = rng.normal(size=(R, S, 3)).astype(np.float32)
    ref = jc.composite({k: jnp.asarray(v) for k, v in f.items()},
                       jnp.asarray(z))
    out = tc.composite({k: t(v) for k, v in f.items()}, t(z))
    assert set(out) == set(ref)
    for k in ref:
        close(out[k], ref[k])


def test_composite_noise(coarse, rng):
    _, _, z, _, _ = coarse
    f = {"sigma": rng.normal(size=(R, S)).astype(np.float32)}
    key = jax.random.PRNGKey(5)
    ref = jc.composite({"sigma": jnp.asarray(f["sigma"])}, jnp.asarray(z),
                       noise_std=0.5, key=key)
    noise = t(jax.random.normal(key, (R, S)))
    out = tc.composite({"sigma": t(f["sigma"])}, t(z), noise_std=0.5,
                       noise=noise)
    close(out["weights"], ref["weights"])


def test_composite_rgb_needs_sun(coarse):
    z = t(coarse[2])
    with pytest.raises(ValueError):
        tc.composite({"sigma": torch.zeros(R, S),
                      "rgb": torch.zeros(R, S, 3),
                      "sky": torch.zeros(R, S, 3)}, z)
