"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: the field kernel, bf16, 2e-2 absolute (the kernel and the plain
version sum in different orders, which can move an activation by one bf16
ulp); the table-gradient kernels, float32, 1e-5 of the largest entry (sums of
up to thousands of rows in another order), B3 bitwise equal to itself and
two calls of B4 (float atomics) within the same bound of each other.
"""

import itertools

import numpy as np
import pytest
import torch

from spnerf_torch.config import ModelConfig, RenderConfig
from spnerf_torch.models import load_model
from spnerf_torch.ops import field_eval as fe
from spnerf_torch.render import build_render_fn, chunk_size
from spnerf_torch.utils.dtab_cases import (BATCHED_CASES, EDGE_CASES,
                                           batched_edge_case, dtab_plain_kept,
                                           edge_case)
from spnerf_torch.utils.synth import fake_batch

ATOL = 2e-2


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def field_inputs(n, cfg, device, seed=0):
    g = np.random.default_rng(seed)
    xyz = g.normal(size=(n, 3)).astype(np.float32) * 0.3
    sun = g.normal(size=(n, 3)).astype(np.float32)
    sun /= np.linalg.norm(sun, axis=-1, keepdims=True)
    sems = g.integers(-1, cfg.num_sem_classes, size=n)
    t_emb = g.normal(size=(n, cfg.t_embedding_dims)).astype(np.float32)
    to = lambda a: torch.from_numpy(a).to(device)
    return (to(xyz), to(sun), to(t_emb) if cfg.beta else None,
            to(np.where(sems < 0, -100, sems)) if cfg.sem else None)


def packed_field(cfg, device):
    model = load_model(cfg, "bfloat16", device=device,
                       generator=torch.Generator().manual_seed(0))
    return model, fe.pack_params(model)


@pytest.mark.cuda
@pytest.mark.parametrize("kw,n", [
    (dict(sem=True, num_sem_classes=3), 1000),
    (dict(beta=True), 777),
    (dict(sem=True, num_sem_classes=5, fc_units=256), 64),
])
def test_kernel_matches_plain_every_head_subset(device, kw, n):
    cfg = ModelConfig(mapping=True, fc_units=kw.pop("fc_units", 128), **kw)
    _, p = packed_field(cfg, device)
    args = field_inputs(n, cfg, device)
    for r in range(len(fe.ALL_HEADS) + 1):
        for heads in itertools.combinations(fe.ALL_HEADS, r):
            before = fe.FusedField.launches
            out = fe.FusedField(p)(*args, heads=heads)
            torch.cuda.synchronize()
            assert fe.FusedField.launches == before + 1
            ref = fe.PlainField(p)(*args, heads=heads)
            assert set(out) == set(ref), heads
            for k in ref:
                assert out[k].shape == ref[k].shape
                err = (out[k] - ref[k]).abs().max().item()
                assert err <= ATOL, (heads, k, err)


@pytest.mark.cuda
def test_kernel_refuses_float32_compute(device):
    cfg = ModelConfig(mapping=True, sem=True, num_sem_classes=3, fc_units=64)
    _, p = packed_field(cfg, device)
    with pytest.raises(NotImplementedError):
        fe.FusedField(p, "float32")(*field_inputs(16, cfg, device))


@pytest.mark.cuda
def test_render_image_uses_kernel(device):
    """The eval renderer on CUDA launches the kernel three times per chunk
    and agrees with the same render through the plain field."""
    cfg = ModelConfig(mapping=True, sem=True, num_sem_classes=3, fc_units=128)
    rc = RenderConfig(n_samples=16, guidedsample=True, solar_correction=True,
                      sem=True, compute_dtype="bfloat16")
    model, _ = packed_field(cfg, device)
    batch = fake_batch(np.random.default_rng(0), 3000)
    fe.FusedField.launches = 0
    out = build_render_fn(model, rc, chunk=1024)(batch["rays"], 0,
                                                 batch["sems"])
    torch.cuda.synchronize()
    assert fe.FusedField.launches == 3 * -(-3000 // chunk_size(rc, 1024))
    ref = build_render_fn(model, rc, chunk=1024, field="plain")(
        batch["rays"], 0, batch["sems"])
    for k in ref:
        err = (out[k] - ref[k]).abs()
        assert torch.isfinite(out[k]).all(), k
        assert torch.quantile(err.flatten().float(), 0.99) <= 2e-2, k


# ------------------------------------------------ table gradient, B2 and B3

def dtab_case(kind, device, seed=0):
    """(ids, ct_fm, t_eff) on the card: uniform ids, skewed ids (half the
    rows on 64 ids), ids at the end of the table, a ragged row count, and a
    table too large for B2's shared-memory form."""
    g = np.random.default_rng(seed)
    t_eff, F, M = {"uniform": (2 ** 16, 4, 300_000),
                   "skewed": (2 ** 19, 4, 524_288),
                   "end": (8192, 4, 100_000),
                   "ragged": (8192, 2, 1_000_003),
                   "f8": (2 ** 13, 8, 4097),
                   "large": (2 ** 19, 4, 200_000)}[kind]
    ids = g.integers(0, t_eff, M)
    if kind == "skewed":
        ids[: M // 2] = g.integers(0, 64, M // 2)
    if kind == "end":
        ids = g.integers(t_eff - 200, t_eff, M)
    ct = g.normal(size=(F, M)).astype(np.float32)
    return (torch.from_numpy(ids.astype(np.int32)).to(device),
            torch.from_numpy(ct).to(device), t_eff)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["uniform", "skewed", "end", "ragged", "f8",
                                  "large"])
@pytest.mark.parametrize("name", ["dense", "sorted"])
def test_dtab_kernels_match_plain(device, kind, name):
    """Both kernels against the plain version: max abs error within 1e-5 of
    the largest entry (float32 sums in another order). B3 gives the same
    bits twice."""
    from spnerf_torch.ops import dtab as dt

    ids, ct, t_eff = dtab_case(kind, device)
    fn = dt.dtab_dense if name == "dense" else dt.dtab_sorted
    before = dt.launches[f"dtab_{name}"]
    out = fn(ids, ct, t_eff)
    torch.cuda.synchronize()
    assert dt.launches[f"dtab_{name}"] == before + 1
    ref = dt.dtab_plain(ids, ct, t_eff)
    err = (out - ref).abs().max().item()
    assert err <= 1e-5 * max(ref.abs().max().item(), 1.0), err
    if name == "sorted":
        assert torch.equal(out, fn(ids, ct, t_eff))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["uniform", "skewed", "end", "ragged", "f8",
                                  "large"])
@pytest.mark.parametrize("name", ["dense", "sorted", "partials"])
def test_dtab_kernels_match_plain_tmajor(device, kind, name):
    """B2, B3 and B3′ on the t-major layout of the (L, T, F) table (ct
    (M, F), out (t_eff, F)) against the plain version; B3′ also on the
    feature-major layout. 1e-5 of the largest entry."""
    from spnerf_torch.ops import dtab as dt

    ids, ct_fm, t_eff = dtab_case(kind, device)
    key = {"dense": "dtab_dense", "sorted": "dtab_sorted",
           "partials": "dtab_sorted_partials"}[name]
    fn = {"dense": dt.dtab_dense, "sorted": dt.dtab_sorted,
          "partials": dt.dtab_sorted_partials}[name]
    for fmajor in ((False, True) if name == "partials" else (False,)):
        ct = ct_fm if fmajor else ct_fm.t().contiguous()
        before = dt.launches[key]
        out = fn(ids, ct, t_eff, fmajor=fmajor)
        torch.cuda.synchronize()
        assert dt.launches[key] == before + 1
        ref = dt.dtab_plain(ids, ct, t_eff, fmajor=fmajor)
        assert out.shape == ref.shape
        err = (out - ref).abs().max().item()
        assert err <= 1e-5 * max(ref.abs().max().item(), 1.0), (fmajor, err)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(EDGE_CASES))
@pytest.mark.parametrize("name", ["dense", "sorted", "partials"])
def test_dtab_window_kernels_edge_cases(device, kind, name):
    """B2, B3 and B3′ on the edge cases, in both layouts, with int64 and
    int32 ids, against the plain version within 1e-5 of the largest entry;
    ids outside [0, t_eff) dropped (int64 ids at -2^40 not wrapped onto a
    row); B3 the same bits twice."""
    from spnerf_torch.ops import dtab as dt

    key = {"dense": "dtab_dense", "sorted": "dtab_sorted",
           "partials": "dtab_sorted_partials"}[name]
    fn = getattr(dt, key)
    for fmajor, ids64 in itertools.product((True, False), (True, False)):
        ids, ct, t_eff = edge_case(kind, device, fmajor, ids64)
        before = dt.launches[key]
        out = fn(ids, ct, t_eff, fmajor=fmajor)
        torch.cuda.synchronize()
        assert dt.launches[key] == before + (1 if ids.numel() else 0)
        ref = dtab_plain_kept(ids, ct, t_eff, fmajor=fmajor)
        assert out.shape == ref.shape and torch.isfinite(out).all()
        err = (out - ref).abs().max().item()
        assert err <= 1e-5 * max(ref.abs().max().item(), 1.0), \
            (fmajor, ids64, err)
        if name == "sorted":
            assert torch.equal(out, fn(ids, ct, t_eff, fmajor=fmajor))


@pytest.mark.cuda
@pytest.mark.parametrize("M,F,t_eff", [
    (524_288, 4, 2 ** 19), (1_048_576, 4, 65_536), (1, 1, 1), (0, 4, 8),
    (50_000, 3, 10_000), (100_000, 8, 2 ** 16), (300_000, 4, 2 ** 21 + 5),
    (10, 1, 2 ** 30),
])
def test_owner_plan(device, M, F, t_eff):
    """B3's plan from the C side: a window of S table rows, a power of two
    whose S * F floats fit 32 KB of shared memory; slices of as few windows
    as keep them at 1,024 or fewer, covering [0, t_eff) with none empty; the
    scratch holds at least the partitioned ids and cotangent. At the hash
    step's hashed levels, 256 slices of one window of 2,048 rows."""
    from spnerf_torch.ops import dtab as dt

    plan = dt.owner_plan(M, F, t_eff, torch.cuda.current_device())
    S, wps, n = plan.S, plan.wps, plan.n_slices
    assert S >= 4 and S & (S - 1) == 0 and 4 * S * F <= 32 * 1024
    assert 1 <= n <= 1024 and n * S * wps >= t_eff > (n - 1) * S * wps
    assert wps == 1 or -(-t_eff // (S * (wps - 1))) > 1024
    assert plan.scratch_words >= (1 + F) * M
    if (M, F, t_eff) == (524_288, 4, 2 ** 19):
        assert (S, wps, n) == (2048, 1, 256)


def batched_case(device, M=300_000, seed=0):
    """(ids (L, M), ct (L, M, F), T) with L = 5 levels: uniform, direct-coarse
    ids below 4,913, skewed onto 64 ids, ids at both ends of the level, and
    out-of-range ids (-1, T, T + 5) mixed into a uniform level."""
    g = np.random.default_rng(seed)
    T, F = 2 ** 19, 4
    ids = g.integers(0, T, (5, M))
    ids[1] = g.integers(0, 4913, M)
    ids[2, : M // 2] = g.integers(0, 64, M // 2)
    ids[3] = np.where(g.uniform(size=M) < 0.5, g.integers(0, 100, M),
                      g.integers(T - 100, T, M))
    bad = g.uniform(size=M) < 0.1
    ids[4] = np.where(bad, g.choice([-1, T, T + 5], M), ids[4])
    ct = g.normal(size=(5, M, F)).astype(np.float32)
    return (torch.from_numpy(ids.astype(np.int32)).to(device),
            torch.from_numpy(ct).to(device), T)


@pytest.mark.cuda
def test_dtab_batched_matches_plain_and_repeats(device):
    """B4 against its plain version (1e-5 of the largest entry), two calls
    within the same bound of each other (float atomics), out-of-range ids
    dropped in their own level, and the router launching it once per
    call."""
    from spnerf_torch.ops import dtab as dt

    ids, ct, T = batched_case(device)
    before = dict(dt.launches)
    out = dt.dtab_levels(ids, ct, T)
    torch.cuda.synchronize()
    assert dt.launches["dtab_batched"] == before["dtab_batched"] + 1
    assert sum(dt.launches.values()) == sum(before.values()) + 1
    ref = dt.dtab_batched_plain(ids, ct, T)
    assert out.shape == (5, T, 4)
    err = (out - ref).abs().max().item()
    assert err <= 1e-5 * max(ref.abs().max().item(), 1.0), err
    again = dt.dtab_batched(ids, ct, T)
    assert (again - out).abs().max() <= 1e-5 * max(ref.abs().max(), 1.0)
    # level 4 equals its in-range rows alone
    keep = (ids[4] >= 0) & (ids[4] < T)
    one = dt.dtab_plain(ids[4][keep], ct[4][keep], T, fmajor=False)
    assert (out[4] - one).abs().max() <= 1e-5 * max(one.abs().max(), 1.0)
    assert dt.dtab_levels(ids, ct, T, impl="plain").shape == out.shape


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(BATCHED_CASES))
def test_dtab_batched_edge_cases(device, kind):
    """B4 on the batched edge cases with int64 and int32 ids: each level
    against `dtab_batched_plain`'s within 1e-5 of the level's largest entry,
    and each level against the per-level plain version of its in-range rows
    alone, so an id outside [0, T) (-2^40, -1, T, T + 2^32) neither wraps
    onto a row nor spills into the next level. One launch a call with rows,
    none without."""
    from spnerf_torch.ops import dtab as dt

    for ids64 in (True, False):
        ids, ct, T = batched_edge_case(kind, device, ids64)
        before = dt.launches["dtab_batched"]
        out = dt.dtab_batched(ids, ct, T)
        torch.cuda.synchronize()
        assert dt.launches["dtab_batched"] == before + (1 if ids.numel()
                                                         else 0)
        ref = dt.dtab_batched_plain(ids, ct, T)
        assert out.shape == ref.shape and torch.isfinite(out).all()
        for l in range(ids.shape[0]):
            keep = (ids[l] >= 0) & (ids[l] < T)
            alone = dt.dtab_plain(ids[l][keep], ct[l][keep], T, fmajor=False)
            scale = 1e-5 * max(ref[l].abs().max().item(), 1.0)
            assert (out[l] - ref[l]).abs().max().item() <= scale, (ids64, l)
            assert (out[l] - alone).abs().max().item() <= scale, (ids64, l)


def small_hash_trainer(device, flat_table=True):
    from spnerf_torch.config import LossConfig
    from spnerf_torch.train.loop import Trainer

    mc = ModelConfig(encoding="hash", hash_levels=4, hash_log2T=16,
                     hash_hidden=32, sem=True, num_sem_classes=3,
                     hash_flat_table=flat_table)
    rc = RenderConfig(n_samples=16, guidedsample=True, solar_correction=True,
                      sem=True, compute_dtype="bfloat16")
    lc = LossConfig(sc_lambda=0.1, depth=True, ds_lambda=1.0, sem=True,
                    ss_lambda=1.0)
    tr = Trainer(mc, rc, lc, lr=1e-2, device=device)
    state = tr.init_state(torch.Generator().manual_seed(0))
    data = tr.to_device(fake_batch(np.random.default_rng(0), 4096))
    return mc, tr, state, data


def step_grads(tr, state, data, impl, batch=512):
    state.model.encoding.dtab_impl = impl
    state.optimizer.zero_grad(set_to_none=True)
    g = tr.step_generator(0, 1)
    loss, _ = tr.loss_fn(state, tr.sample_batch(data, batch, g), 0,
                         generator=g)
    loss.backward()
    state.model.encoding.dtab_impl = None
    return loss.item(), state.model.encoding.table.grad.clone()


@pytest.mark.cuda
def test_dtab_router_launches_kernels_on_cuda(device):
    from spnerf_torch.ops import dtab as dt

    for t_eff, M, name in ((8192, 524_288, "dense"),
                           (2 ** 19, 524_288, "sorted"),
                           (2 ** 19, 524_287, "dense")):
        ids = torch.randint(0, t_eff, (M,), device=device, dtype=torch.int32)
        ct = torch.randn(4, M, device=device)
        before = dict(dt.launches)
        out = dt.dtab(ids, ct, t_eff, 4)
        torch.cuda.synchronize()
        assert dt.launches[f"dtab_{name}"] == before[f"dtab_{name}"] + 1
        assert sum(dt.launches.values()) == sum(before.values()) + 1
        ref = dt.dtab(ids, ct, t_eff, 4, impl="plain")
        assert sum(dt.launches.values()) == sum(before.values()) + 1
        assert (out - ref).abs().max() <= 1e-5 * max(ref.abs().max(), 1.0)


@pytest.mark.cuda
def test_hash_train_step_runs_through_kernels(device):
    """A small hash step on the card: every table gradient goes through a
    kernel, and the table gradient agrees with the plain version's."""
    from spnerf_torch.config import LossConfig
    from spnerf_torch.ops import dtab as dt
    from spnerf_torch.train.loop import Trainer

    mc = ModelConfig(encoding="hash", hash_levels=4, hash_log2T=16,
                     hash_hidden=32, sem=True, num_sem_classes=3)
    rc = RenderConfig(n_samples=16, guidedsample=True, solar_correction=True,
                      sem=True, compute_dtype="bfloat16")
    lc = LossConfig(sc_lambda=0.1, depth=True, ds_lambda=1.0, sem=True,
                    ss_lambda=1.0)
    tr = Trainer(mc, rc, lc, lr=1e-2, device=device)
    state = tr.init_state(torch.Generator().manual_seed(0))
    data = tr.to_device(fake_batch(np.random.default_rng(0), 4096))

    def grads(impl):
        return step_grads(tr, state, data, impl)

    before = sum(dt.launches.values())
    loss_k, g_k = grads(None)
    torch.cuda.synchronize()
    assert sum(dt.launches.values()) == before + 3 * mc.hash_levels
    loss_p, g_p = grads("plain")
    assert sum(dt.launches.values()) == before + 3 * mc.hash_levels
    assert abs(loss_k - loss_p) <= 1e-6 * abs(loss_p)
    assert (g_k - g_p).abs().max() <= 1e-4 * g_p.abs().max()
    ld = tr.train_steps(state, data, 2, batch_size=512)
    assert np.isfinite(ld["loss"].item())


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["tlf", "tlf_batched", "flat_sw_acc0"])
def test_hash_step_variants_run_through_kernels(device, monkeypatch, variant):
    """The (L, T, F) table's step (per-level t-major B2/B3, or B4 under
    SPNERF_HASH_SW_BATCHED=1) and the flat step under SPNERF_HASH_SW_ACC=0
    (B3′): every table gradient through a kernel of the variant, the table
    gradient within 1e-4 of the plain run's largest entry, the loss within
    1e-6."""
    from spnerf_torch.ops import dtab as dt

    if variant == "tlf_batched":
        monkeypatch.setenv("SPNERF_HASH_SW_BATCHED", "1")
    if variant == "flat_sw_acc0":
        monkeypatch.setenv("SPNERF_HASH_SW_ACC", "0")
    mc, tr, state, data = small_hash_trainer(
        device, flat_table=variant == "flat_sw_acc0")
    # batch 512 x 16 samples x 8 corners = 65,536 rows: hashed T = 2^16
    # levels are window-eligible from 4 * 256 * 1024 / 16 = 65,536 rows on
    before = dict(dt.launches)
    loss_k, g_k = step_grads(tr, state, data, None)
    torch.cuda.synchronize()
    n = {k: dt.launches[k] - before[k] for k in before}
    if variant == "tlf_batched":
        assert n == {"dtab_dense": 0, "dtab_sorted": 0,
                     "dtab_sorted_partials": 0, "dtab_batched": 3}, n
        assert g_k.shape == (4, 2 ** 16, 4)
    else:
        assert sum(n.values()) == 3 * mc.hash_levels, n
        assert n["dtab_batched"] == 0
        window = "dtab_sorted_partials" if variant == "flat_sw_acc0" \
            else "dtab_sorted"
        assert n[window] > 0, n
    loss_p, g_p = step_grads(tr, state, data, "plain")
    assert abs(loss_k - loss_p) <= 1e-6 * abs(loss_p)
    assert (g_k - g_p).abs().max() <= 1e-4 * g_p.abs().max()
    ld = tr.train_steps(state, data, 2, batch_size=512)
    assert np.isfinite(ld["loss"].item())
