"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances: the field kernels in bf16, 2e-2 absolute (the kernel and the
plain version sum in different orders, which can move an activation by one
bf16 ulp); the general, wgmma_f32 and wgmma_wide field kernels in
float32, 1e-4
absolute (the same float32 products in another sum order, or as three TF32
products without lo x lo, through eight layers); the
table-gradient kernels, float32, 1e-5 of the largest entry (sums of
up to thousands of rows in another order), B3 bitwise equal to itself and
two calls of B4 (float atomics) within the same bound of each other. The DSM
splat (`index_add_` on the card) against the same splat on the CPU: empty
cells equal, values within 1e-4 m (float atomics); `run_validation` on a
small synthetic AOI renders through B1 and gives a finite MAE, and its test
view through B1 agrees with the plain render (per-ray p99 within 2e-2).
The Siren epilogue kernels (`csrc/siren_act.cu`) bit for bit against the
plain composition, alone and in a flagship field's forward and backward.
The training CLI's `main` on a small AOI validates through B1, and its
checkpoint restores on the card bit for bit; with --occgrid too, the grid
included. B1 on grid-placed samples and on a second multi-AOI frame's
points, and B2 at the proposal field's shapes (F = 2, T = 2^16), at the
same bars.
"""

import itertools

import numpy as np
import pytest
import torch

from spnerf_torch.config import ModelConfig, RenderConfig
from spnerf_torch.models import load_model
from spnerf_torch.models.spnerf import TransientEmbedding
from spnerf_torch.ops import field_eval as fe
from spnerf_torch.render import build_render_fn, chunk_size
from spnerf_torch.utils.dtab_cases import (BATCHED_CASES, EDGE_CASES,
                                           batched_edge_case, edge_case)
from spnerf_torch.utils.synth import fake_batch
from test_torch_siren_act import UnfusedSineLayer, epilogue_inputs

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


F32_ATOL = 1e-4


def packed_field(cfg, device, dtype="bfloat16", kernel=None, cluster=None):
    model = load_model(cfg, dtype, device=device,
                       generator=torch.Generator().manual_seed(0))
    return model, fe.pack_params(model, dtype, kernel=kernel,
                                 cluster=cluster)


def hold_kernel(p, args, heads, dtype="bfloat16"):
    """One launch against the plain version: the same outputs within ATOL
    (F32_ATOL in float32), and one launch counted on the packed route."""
    before = fe.FusedField.launches
    on_route = fe.FusedField.route_launches[p.route]
    out = fe.FusedField(p, dtype)(*args, heads=heads)
    torch.cuda.synchronize()
    assert fe.FusedField.launches == before + 1
    assert fe.FusedField.route_launches[p.route] == on_route + 1
    ref = fe.PlainField(p, dtype)(*args, heads=heads)
    assert set(out) == set(ref), heads
    atol = F32_ATOL if dtype == "float32" else ATOL
    for k in ref:
        assert out[k].shape == ref[k].shape
        assert torch.isfinite(out[k]).all(), (heads, k)
        err = (out[k] - ref[k]).abs().max().item()
        assert err <= atol, (heads, k, err)


@pytest.mark.cuda
@pytest.mark.parametrize("kw,n", [
    (dict(sem=True, num_sem_classes=3), 1000),
    (dict(beta=True), 777),
    (dict(sem=True, num_sem_classes=5, fc_units=256), 64),
    (dict(sem=True, num_sem_classes=3, fc_units=96), 63),
    (dict(sem=True, beta=True, num_sem_classes=3, fc_units=160), 65),
    (dict(sem=True, num_sem_classes=20, fc_units=96), 1),
    (dict(beta=True, fc_units=160), 3 * 64 + 5),
    (dict(sem=True, beta=True, num_sem_classes=3, fc_units=640), 200),
    (dict(fc_units=704), 130),
])
def test_kernel_matches_plain_every_head_subset(device, kw, n):
    """Every head subset at widths 96 to 256, with n of 1, 63, 64, 65, an
    odd tile count (4 tiles, the last ragged) and more; 20 semantic classes
    take a 64-wide head. At 640 the ring holds 3 stages, 2 with the beta
    head; at 704 it holds 2."""
    cfg = ModelConfig(mapping=True, fc_units=kw.pop("fc_units", 128), **kw)
    _, p = packed_field(cfg, device)
    args = field_inputs(n, cfg, device)
    for r in range(len(fe.ALL_HEADS) + 1):
        for heads in itertools.combinations(fe.ALL_HEADS, r):
            hold_kernel(p, args, heads)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 65, 3 * 64, 5 * 64 + 1, 4000, 300_001])
def test_kernel_ragged_tile_counts(device, n):
    """Tile counts of 1, 2, 3 and 6 (fewer tiles than CTAs), 63 and more
    tiles than the grid has CTAs, each with a ragged last tile, against the
    plain version."""
    cfg = ModelConfig(mapping=True, sem=True, beta=True, num_sem_classes=3,
                      fc_units=160)
    _, p = packed_field(cfg, device)
    args = field_inputs(n, cfg, device, seed=n)
    hold_kernel(p, args, fe.ALL_HEADS)
    hold_kernel(p, args, ("sun",))


@pytest.mark.cuda
def test_ring_stages_match_the_kernel(device):
    """The wrapper's ring depth and width limit (`ring_stages`, which
    `supports_config` reads) are the kernel's own."""
    from spnerf_torch.ops import _build

    lib = _build.load("field_eval")
    for width, k0_pad, has_t in itertools.product(range(32, 1057, 32),
                                                  (16, 64, 80, 128), (0, 1)):
        assert (lib.spnerf_field_eval_stages(width, k0_pad, has_t)
                == fe.ring_stages(width, k0_pad, has_t)), (width, k0_pad)


@pytest.mark.cuda
def test_kernel_refuses_float32_compute(device):
    """The wgmma kernel computes in bf16 only: a field packed for it
    refuses float32 compute on the card (a float32 field is packed for the
    wgmma_f32 or the general route, `pack_params(model, "float32")`)."""
    cfg = ModelConfig(mapping=True, sem=True, num_sem_classes=3, fc_units=64)
    _, p = packed_field(cfg, device)
    assert p.route == "wgmma"
    with pytest.raises(ValueError):
        fe.FusedField(p, "float32")(*field_inputs(16, cfg, device))


GENERAL_CASES = [
    ("float32", dict(sem=True, num_sem_classes=3, fc_units=512), 1000),
    ("float32", dict(sem=True, beta=True, num_sem_classes=3, fc_units=96),
     65),
    ("float32", dict(beta=True, fc_units=160), 3 * 64 + 5),
    ("float32", dict(sem=True, num_sem_classes=20, fc_units=256), 1),
    ("float32", dict(sem=True, beta=True, num_sem_classes=3, fc_units=768),
     200),
    ("float32", dict(fc_units=1024), 33),
    ("bfloat16", dict(sem=True, num_sem_classes=3, fc_units=80), 130),
    ("bfloat16", dict(sem=True, beta=True, num_sem_classes=3, fc_units=768),
     200),
    ("bfloat16", dict(sem=True, beta=True, num_sem_classes=3,
                      fc_units=800), 17),
    ("bfloat16", dict(beta=True, t_embedding_dims=32, fc_units=128), 63),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kw,n", GENERAL_CASES)
def test_general_kernel_matches_plain_every_head_subset(device, dtype, kw, n):
    """The general kernel against the plain version, every head subset: in
    float32 at the flagship width (32-point tiles), at 96 to 256 (64-point
    tiles), 768 and 1024 (16-point tiles); in bf16 at the widths and shapes
    the wgmma kernel does not take (80, 768, 800 with a beta head, a
    transient code of 32); n of 1, 17, 33, 63, 65, a ragged tile count and
    more. Float32 fields up to 512 wide route to wgmma_f32, the others but
    20 semantic classes to wgmma_wide; all are packed for the general
    kernel here, as the parent's route."""
    cfg = ModelConfig(mapping=True, fc_units=kw.pop("fc_units"), **kw)
    assert fe.route(cfg, dtype) == (
        "wgmma_f32" if fe.supports_f32(cfg) and dtype == "float32"
        else "wgmma_wide" if fe.supports_wide(cfg) else "general")
    _, p = packed_field(cfg, device, dtype, kernel="general")
    args = field_inputs(n, cfg, device)
    for r in range(len(fe.ALL_HEADS) + 1):
        for heads in itertools.combinations(fe.ALL_HEADS, r):
            hold_kernel(p, args, heads, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 33, 4000, 300_001])
def test_general_kernel_ragged_tile_counts(device, n):
    """The flagship in float32 (32-point tiles) packed for the general
    kernel: one tile, one ragged, two, more tiles than the grid has CTAs,
    each with a ragged last tile."""
    cfg = ModelConfig(mapping=True, sem=True, num_sem_classes=3)
    _, p = packed_field(cfg, device, "float32", kernel="general")
    args = field_inputs(n, cfg, device, seed=n)
    hold_kernel(p, args, fe.ALL_HEADS, "float32")
    hold_kernel(p, args, ("sun",), "float32")


@pytest.mark.cuda
def test_general_tile_matches_the_kernel(device):
    """The wrapper's tile and shared-memory reckoning
    (`general_tile_rows`, `general_smem_bytes`, which `route` reads) are
    the general kernel's own."""
    from spnerf_torch.ops import _build

    lib = _build.load("field_eval_general")
    for width, k0_pad, t_pad in itertools.product(
            list(range(16, 1057, 16)) + [1, 80, 100],
            (16, 64, 80, 128), (0, 16, 32)):
        bm = fe.general_tile_rows(width, k0_pad, t_pad)
        assert (lib.spnerf_field_eval_general_tile(width, k0_pad, t_pad)
                == bm), (width, k0_pad, t_pad)
        if bm:
            assert (lib.spnerf_field_eval_general_smem(bm, width, k0_pad,
                                                       t_pad)
                    == fe.general_smem_bytes(bm, width, k0_pad, t_pad))


F32_CASES = [
    (dict(sem=True, num_sem_classes=3, fc_units=512), 1000),
    (dict(sem=True, beta=True, num_sem_classes=3, fc_units=512,
          t_embedding_dims=16), 130),
    (dict(sem=True, beta=True, num_sem_classes=3, fc_units=96,
          t_embedding_dims=20), 65),
    (dict(beta=True, fc_units=80), 3 * 64 + 5),
    (dict(sem=True, num_sem_classes=16, fc_units=256), 1),
    (dict(sem=True, num_sem_classes=3, fc_units=480), 63),
    (dict(fc_units=32), 64),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kw,n", F32_CASES)
def test_f32_kernel_matches_plain_every_head_subset(device, kw, n):
    """The wgmma_f32 kernel against the plain float32 version (TF32 off),
    every head subset, within F32_ATOL: the flagship width with and without
    a beta head, 96 with a transient code of 20, 80 and 480 (a 32-wide last
    chunk), 16 semantic classes, 32; n of 1, 63, 64, 65, a ragged tile count
    and more."""
    cfg = ModelConfig(mapping=True, fc_units=kw.pop("fc_units"), **kw)
    assert fe.route(cfg, "float32") == "wgmma_f32"
    _, p = packed_field(cfg, device, "float32")
    args = field_inputs(n, cfg, device)
    for r in range(len(fe.ALL_HEADS) + 1):
        for heads in itertools.combinations(fe.ALL_HEADS, r):
            hold_kernel(p, args, heads, "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 65, 3 * 64, 4000, 300_001])
def test_f32_kernel_ragged_tile_counts(device, n):
    """The flagship in float32 on the wgmma_f32 kernel: one tile, two, three,
    more tiles than the grid has CTAs, the last ragged."""
    cfg = ModelConfig(mapping=True, sem=True, num_sem_classes=3)
    _, p = packed_field(cfg, device, "float32")
    assert p.route == "wgmma_f32"
    args = field_inputs(n, cfg, device, seed=n)
    hold_kernel(p, args, fe.ALL_HEADS, "float32")
    hold_kernel(p, args, ("sun",), "float32")


@pytest.mark.cuda
def test_f32_stages_match_the_kernel(device):
    """The wrapper's ring depth and shared-memory reckoning (`f32_stages`,
    `f32_smem_bytes`, which `supports_f32` reads) are the kernel's own."""
    from spnerf_torch.ops import _build

    lib = _build.load("field_eval_f32")
    for width in range(0, 1057):
        stages = fe.f32_stages(width)
        assert lib.spnerf_field_eval_f32_stages(width) == stages, width
        if stages:
            assert (lib.spnerf_field_eval_f32_smem(width, stages)
                    == fe.f32_smem_bytes(width, stages))


@pytest.mark.cuda
def test_f32_kernel_never_falls_back(device, monkeypatch):
    """A float32 field on the wgmma_f32 route refuses bf16 compute, and when
    its kernel cannot be had the call raises: no launch of the general
    kernel, the module or the plain version takes its place."""
    from spnerf_torch.ops import _build

    cfg = ModelConfig(mapping=True, sem=True, num_sem_classes=3, fc_units=64)
    _, p = packed_field(cfg, device, "float32")
    args = field_inputs(16, cfg, device)
    with pytest.raises(ValueError):
        fe.FusedField(p, "bfloat16")(*args)

    def broken(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")

    monkeypatch.setattr(_build, "load", broken)
    before = dict(fe.FusedField.route_launches)
    with pytest.raises(RuntimeError, match="field_eval_f32"):
        fe.FusedField(p, "float32")(*args)
    assert fe.FusedField.route_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width,beta", [(768, True), (1024, False),
                                        (1024, True)])
@pytest.mark.parametrize("n", [1, 65])
def test_wide_kernel_matches_plain_every_head_subset(device, dtype, width,
                                                     beta, n):
    """The wgmma_wide kernel (a cluster of two CTAs) against the plain
    version, every head subset, in both policies at 768 and 1024, with and
    without a beta head: one point (the tile's other 63 rows padding), and
    65 (two tiles, the second with one point)."""
    cfg = ModelConfig(mapping=True, sem=True, beta=beta, num_sem_classes=3,
                      fc_units=width)
    assert fe.route(cfg, dtype) == "wgmma_wide"
    _, p = packed_field(cfg, device, dtype)
    args = field_inputs(n, cfg, device, seed=n)
    for r in range(len(fe.ALL_HEADS) + 1):
        for heads in itertools.combinations(fe.ALL_HEADS, r):
            hold_kernel(p, args, heads, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kw,n", [
    ("bfloat16", dict(sem=True, beta=True, num_sem_classes=3, fc_units=80),
     130),
    ("bfloat16", dict(beta=True, t_embedding_dims=32, fc_units=128), 63),
    ("bfloat16", dict(sem=True, num_sem_classes=16, fc_units=736), 3 * 64 + 5),
    ("float32", dict(sem=True, beta=True, num_sem_classes=3, fc_units=544),
     4000),
    ("float32", dict(fc_units=896), 300_001)])
def test_wide_kernel_other_shapes(device, dtype, kw, n):
    """The wgmma_wide kernel on the other shapes it takes: 80 (not a
    multiple of 32), a transient code of 32, 16 semantic classes at 736,
    float32 at 544 and 896; ragged tile counts and more tiles than the
    grid has clusters; all heads and the solar pass."""
    cfg = ModelConfig(mapping=True, fc_units=kw.pop("fc_units"), **kw)
    assert fe.route(cfg, dtype) == "wgmma_wide"
    _, p = packed_field(cfg, device, dtype)
    args = field_inputs(n, cfg, device, seed=n)
    hold_kernel(p, args, fe.ALL_HEADS, dtype)
    hold_kernel(p, args, ("sun",), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cluster,width,kw,n", [
    (4, 96, dict(beta=True), 130), (4, 160, {}, 65),
    (8, 200, dict(beta=True, t_embedding_dims=20), 4 * 64 + 3),
    (8, 512, {}, 1000), (4, 1536, {}, 1000), (8, 3072, dict(beta=True), 70)])
def test_wide_kernel_on_clusters_of_four_and_eight(device, dtype, cluster,
                                                   width, kw, n):
    """The wgmma_wide kernel on clusters of 4 and 8 CTAs: forced at 96,
    160, 200 and 512 (shares of 32 and 64 columns, a padded share), and
    the route's own clusters at 1,536 (4) and 3,072 (8); all heads and the
    solar pass against the plain version (float32 within F32_ATOL), each
    launch equal bit for bit to a second one."""
    cfg = ModelConfig(mapping=True, sem=True, num_sem_classes=3,
                      fc_units=width, **kw)
    _, p = packed_field(cfg, device, dtype, kernel="wgmma_wide",
                        cluster=cluster)
    assert p.cluster == cluster
    args = field_inputs(n, cfg, device, seed=n)
    for heads in (fe.ALL_HEADS, ("sun",)):
        hold_kernel(p, args, heads, dtype)
        a = fe.FusedField(p, dtype)(*args, heads=heads)
        b = fe.FusedField(p, dtype)(*args, heads=heads)
        assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,width,classes,cluster", [
    ("bfloat16", 1024, 150, 2), ("float32", 512, 150, 2),
    ("float32", 512, 17, 2), ("bfloat16", 736, 64, 2),
    ("float32", 96, 150, 4), ("bfloat16", 200, 150, 8)])
def test_wide_kernel_wide_semantic_heads(device, dtype, width, classes,
                                         cluster):
    """Semantic heads of more than 16 classes on the wide kernel (the
    logits in passes of 16 columns): every head subset against the plain
    version on 65 points, each launch equal bit for bit to a second one;
    the float32 fields of 512 and less route there too."""
    cfg = ModelConfig(mapping=True, sem=True, beta=True,
                      num_sem_classes=classes, fc_units=width)
    if cluster == 2 and not (dtype == "bfloat16" and width % 32 == 0
                             and width <= 640):
        assert fe.route(cfg, dtype) == "wgmma_wide"
    _, p = packed_field(cfg, device, dtype, kernel="wgmma_wide",
                        cluster=cluster)
    args = field_inputs(65, cfg, device, seed=classes)
    for r in range(len(fe.ALL_HEADS) + 1):
        for heads in itertools.combinations(fe.ALL_HEADS, r):
            hold_kernel(p, args, heads, dtype)
    a = fe.FusedField(p, dtype)(*args)
    b = fe.FusedField(p, dtype)(*args)
    assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.cuda
def test_wide_stages_match_the_kernel(device):
    """The wrapper's cluster, ring depth and shared-memory reckoning
    (`wide_cluster`, `wide_stages`, `wide_smem_bytes`, which
    `supports_wide` reads) are the kernel's own for clusters of 2, 4 and 8
    CTAs, and at least one cluster of its CTAs fits the card at every
    width the route takes."""
    import ctypes

    from spnerf_torch.ops import _build

    lib = _build.load("field_eval_wide")
    for name, ints in (("stages", 2), ("smem", 3), ("clusters", 3)):
        getattr(lib, f"spnerf_field_eval_wide_{name}").argtypes = (
            [ctypes.c_int] * ints)
    widths = list(range(0, 1057)) + list(range(1057, fe.W_MAX + 2, 31)) + [
        2048, 3072, fe.W_MAX, fe.W_MAX + 1]
    for width in widths:
        assert (lib.spnerf_field_eval_wide_cluster(width)
                == fe.wide_cluster(width)), width
        for c in (0, *fe.WIDE_CLUSTERS, 3):
            stages = fe.wide_stages(width, c)
            assert lib.spnerf_field_eval_wide_stages(width, c) == stages
            if stages:
                assert (lib.spnerf_field_eval_wide_smem(width, stages, c)
                        == fe.wide_smem_bytes(width, stages, c))
    for width in (2, 80, 512, 768, 1024, 1536, 2048, 3072, 4096):
        for bf16 in (0, 1):
            assert lib.spnerf_field_eval_wide_clusters(
                width, bf16, fe.wide_cluster(width)) >= 1


@pytest.mark.cuda
def test_wide_kernel_never_falls_back(device, monkeypatch):
    """A field on the wgmma_wide route refuses the other dtype's compute,
    and when its kernel cannot be had the call raises: no other kernel, the
    module or the plain version takes its place."""
    from spnerf_torch.ops import _build

    cfg = ModelConfig(mapping=True, sem=True, num_sem_classes=3, fc_units=768)
    _, p = packed_field(cfg, device, "bfloat16")
    assert p.route == "wgmma_wide"
    args = field_inputs(16, cfg, device)
    with pytest.raises(ValueError):
        fe.FusedField(p, "float32")(*args)

    def broken(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")

    monkeypatch.setattr(_build, "load", broken)
    before = dict(fe.FusedField.route_launches)
    with pytest.raises(RuntimeError, match="field_eval_wide"):
        fe.FusedField(p, "bfloat16")(*args)
    assert fe.FusedField.route_launches == before


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


@pytest.mark.cuda
def test_float32_render_takes_the_module(device):
    """A float32 render on CUDA (which took the module before the general
    kernel was ported, then the general kernel) launches the wgmma_f32
    kernel three times a chunk and no other, and agrees with the plain
    float32 render within 1e-4."""
    cfg = ModelConfig(mapping=True, sem=True, num_sem_classes=3, fc_units=128)
    rc = RenderConfig(n_samples=16, guidedsample=True, solar_correction=True,
                      sem=True, compute_dtype="float32")
    model, _ = packed_field(cfg, device)
    batch = fake_batch(np.random.default_rng(0), 1500)
    fe.FusedField.launches = 0
    fe.FusedField.route_launches.update(dict.fromkeys(fe.ROUTES, 0))
    out = build_render_fn(model, rc, chunk=1024)(batch["rays"], 0,
                                                 batch["sems"])
    torch.cuda.synchronize()
    launches = 3 * -(-1500 // chunk_size(rc, 1024))
    assert fe.FusedField.launches == launches
    assert fe.FusedField.route_launches == {"wgmma": 0, "general": 0,
                                            "wgmma_f32": launches,
                                            "wgmma_wide": 0}
    ref = build_render_fn(model, rc, chunk=1024, field="plain")(
        batch["rays"], 0, batch["sems"])
    for k in ref:
        assert torch.isfinite(out[k]).all(), k
        assert (out[k] - ref[k]).abs().max().item() <= F32_ATOL, k


@pytest.mark.cuda
@pytest.mark.parametrize("beta", [False, True])
def test_wide_render_takes_the_module(device, beta):
    """A bf16 render of a field wider than the wgmma kernel takes (768;
    it took the module before the general kernel was ported, then the
    general kernel) launches the wide kernel three times a chunk and agrees
    with the render through the plain field (per-ray p99 within 2e-2)."""
    cfg = ModelConfig(mapping=True, sem=True, beta=beta, num_sem_classes=3,
                      fc_units=768)
    assert not fe.supports_config(cfg)
    assert fe.route(cfg, "bfloat16") == "wgmma_wide"
    rc = RenderConfig(n_samples=16, guidedsample=True, solar_correction=True,
                      sem=True, compute_dtype="bfloat16")
    model, _ = packed_field(cfg, device)
    t_embed = (TransientEmbedding(5, cfg.t_embedding_dims,
                                  torch.Generator().manual_seed(1)).to(device)
               if beta else None)
    batch = fake_batch(np.random.default_rng(0), 1500)
    fe.FusedField.launches = 0
    fe.FusedField.route_launches.update(dict.fromkeys(fe.ROUTES, 0))
    out = build_render_fn(model, rc, t_embed, chunk=1024)(
        batch["rays"], 2, batch["sems"])
    torch.cuda.synchronize()
    launches = 3 * -(-1500 // chunk_size(rc, 1024))
    assert fe.FusedField.route_launches == {"wgmma": 0, "general": 0,
                                            "wgmma_f32": 0,
                                            "wgmma_wide": launches}
    ref = build_render_fn(model, rc, t_embed, chunk=1024, field="plain")(
        batch["rays"], 2, batch["sems"])
    assert set(out) == set(ref)
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
        ref = dt.dtab_plain(ids, ct, t_eff, fmajor=fmajor)
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


@pytest.mark.cuda
@pytest.mark.parametrize("radius,sigma", [(0, np.inf), (1, np.inf), (1, 0.8)])
def test_dsm_splat_on_card_matches_cpu(device, radius, sigma):
    from spnerf_torch.evaluation.dsm import rasterize_dsm

    g = np.random.default_rng(radius)
    n, xoff, yoff = 200_000, 435520.0, 3354480.0
    easts = xoff + g.uniform(-3, 203, n)
    norths = yoff - g.uniform(-3, 153, n)
    alts = g.uniform(-20, 30, n)
    kw = dict(xoff=xoff, yoff=yoff, resolution=0.5, xsize=400, ysize=300,
              radius=radius, sigma=sigma)
    card = rasterize_dsm(easts, norths, alts, device=device, **kw)
    assert card.device.type == torch.device(device).type
    card = card.cpu().numpy()
    ref = rasterize_dsm(easts, norths, alts, device="cpu", **kw).numpy()
    np.testing.assert_array_equal(np.isnan(card), np.isnan(ref))
    np.testing.assert_allclose(card, ref, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_run_validation_renders_through_the_kernel(device, tmp_path):
    import argparse

    from spnerf_torch.cli.train import run_validation
    from spnerf_torch.config import LossConfig
    from spnerf_torch.data import load_scene
    from spnerf_torch.train.loop import Trainer
    from spnerf_torch.utils.logging import MetricLogger
    from spnerf_torch.utils.synth_scene import write_synthetic_aoi

    aoi = write_synthetic_aoi(str(tmp_path / "aoi"), width=48, height=44,
                              roi_size=28, seed=6)
    scene = load_scene(aoi["json_dir"], aoi["img_dir"], aoi["depth_dir"],
                       aoi["sem_dir"], "JAX_269", sem=True,
                       num_sem_classes=3, verbose=False)
    mc = ModelConfig(mapping=True, sem=True, num_sem_classes=3, fc_units=64)
    rc = RenderConfig(n_samples=8, guidedsample=True, solar_correction=True,
                      sem=True, compute_dtype="bfloat16")
    tr = Trainer(mc, rc, LossConfig(), device=device)
    state = tr.init_state(torch.Generator().manual_seed(0))
    args = argparse.Namespace(aoi_id="JAX_269", gt_dir=aoi["gt_dir"],
                              logs_dir=str(tmp_path / "logs"), chunk=1024,
                              sem=True, num_sem_classes=3)
    fe.FusedField.launches = 0
    mean = run_validation(tr, scene, state, args, 0,
                          MetricLogger(args.logs_dir, tensorboard=False),
                          False)
    chunks = -(-48 * 44 // chunk_size(rc, 1024))
    assert fe.FusedField.launches == 3 * chunks * len(scene.val_images)
    assert np.isfinite(mean["mae"]) and np.isfinite(mean["psnr"])
    # B1 on the loaded test view (RPC rays, sparse labels, a ragged last
    # chunk of 64 rays) against the plain render
    sample = scene.load_val_image(scene.val_images[-1], with_sem=True)
    assert (sample["sems"] < 0).any()
    view = (sample["rays"], 0, sample["sems"])
    out = build_render_fn(state.model, rc, state.t_embed, chunk=1024)(*view)
    ref = build_render_fn(state.model, rc, state.t_embed, chunk=1024,
                          field="plain")(*view)
    for k in ref:
        err = (out[k] - ref[k]).abs()
        assert torch.isfinite(out[k]).all(), k
        assert torch.quantile(err.flatten().float(), 0.99) <= ATOL, k


@pytest.mark.cuda
def test_training_cli_on_the_card(device, tmp_path):
    """`main` on a small AOI: its final validation renders through B1, and
    the saved checkpoint restores on the card to the state `main` ended
    with, bit for bit."""
    from spnerf_torch.cli.train import main
    from spnerf_torch.config import (build_train_parser, finalize_args,
                                     loss_config_from_args,
                                     model_config_from_args,
                                     render_config_from_args)
    from spnerf_torch.train.checkpoints import CheckpointManager
    from spnerf_torch.train.loop import Trainer
    from spnerf_torch.utils.synth_scene import write_synthetic_aoi

    write_synthetic_aoi(str(tmp_path / "dataset" / "DFC2019_269"), width=48,
                        height=44, roi_size=28, seed=6)
    argv = ["--aoi_id", "JAX_269", "--model", "sp-nerf", "--exp_name", "c",
            "--no_timestamp_exp_name", "--project_dir", str(tmp_path),
            "--mapping", "--guidedsample", "--sem", "--num_sem_classes", "3",
            "--sc_lambda", "0.1", "--depth", "--ds_lambda", "1.0",
            "--ss_lambda", "1.0", "--fc_units", "64", "--n_samples", "8",
            "--chunk", "1024", "--batch_size", "256", "--log_every", "2",
            "--max_train_steps", "4", "--device", str(device)]
    fe.FusedField.launches = 0
    state = main(argv)
    args = finalize_args(build_train_parser().parse_args(argv),
                         make_dirs=False)
    rc = render_config_from_args(args)
    chunks = -(-48 * 44 // chunk_size(rc, 1024))
    assert fe.FusedField.launches == 3 * chunks * 2  # two validation views
    tr = Trainer(model_config_from_args(args), rc,
                 loss_config_from_args(args), device=device)
    fresh = tr.init_state(torch.Generator().manual_seed(1))
    mgr = CheckpointManager(tmp_path / "output" / "c" / "ckpts")
    assert mgr.all_steps() == [4]
    assert mgr.restore(fresh) is fresh and fresh.step == state.step == 4
    saved = state.optimizer.state_dict()["state"]
    restored = fresh.optimizer.state_dict()["state"]
    for (k, a), b in zip(state.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert b.device.type == "cuda" and torch.equal(a, b), k
    for i in saved:
        for k in ("exp_avg", "exp_avg_sq"):
            assert restored[i][k].device.type == "cuda"
            assert torch.equal(saved[i][k], restored[i][k]), (i, k)


@pytest.mark.cuda
def test_kernel_on_grid_placed_and_second_frame_points(device):
    """B1 where the occupancy grid places the samples (the render against
    the plain render, per-ray p99 within 2e-2) and on points of a
    multi-AOI run's second frame (x near 3 * 1 + [-1, 1]: the positional
    mapping sees x up to 4), every head subset within ATOL."""
    cfg = ModelConfig(mapping=True, sem=True, num_sem_classes=3, fc_units=128)
    rc = RenderConfig(n_samples=16, guidedsample=True, solar_correction=True,
                      sem=True, compute_dtype="bfloat16", occ_grid=True,
                      occ_res=16)
    model, p = packed_field(cfg, device)
    g = np.random.default_rng(4)
    occ = torch.from_numpy(g.uniform(0, 20, 16 ** 3).astype(np.float32)
                           * (g.uniform(size=16 ** 3) < 0.2)).to(device)
    batch = fake_batch(np.random.default_rng(0), 3000)
    fe.FusedField.launches = 0
    out = build_render_fn(model, rc, chunk=1024)(batch["rays"], 0,
                                                 batch["sems"], occ=occ)
    torch.cuda.synchronize()
    assert fe.FusedField.launches == 3 * -(-3000 // chunk_size(rc, 1024))
    ref = build_render_fn(model, rc, chunk=1024, field="plain")(
        batch["rays"], 0, batch["sems"], occ=occ)
    uniform = build_render_fn(model, rc, chunk=1024, field="plain")(
        batch["rays"], 0, batch["sems"])
    assert (uniform["depth_coarse"] - ref["depth_coarse"]).abs().max() > 1e-2
    for k in ref:
        err = (out[k] - ref[k]).abs()
        assert torch.isfinite(out[k]).all(), k
        assert torch.quantile(err.flatten().float(), 0.99) <= 2e-2, k
    xyz, sun, t_emb, sems = field_inputs(70_001, cfg, device, seed=2)
    xyz = xyz + torch.tensor([3.0, 0.0, 0.0], device=device)
    for heads in (None, ("sun",), ("rgb", "sky", "sem")):
        hold_kernel(p, (xyz, sun, t_emb, sems), heads)


@pytest.mark.cuda
def test_proposal_table_gradient_on_b2(device):
    """The proposal field's table gradient (F = 2, T = 2^16; t_eff 8,192,
    32,768 and 65,536) routes to B2 at a step's row counts and agrees with
    the plain version; a proposal train step launches B2 once a level."""
    from spnerf_torch.ops import dtab as dt
    from spnerf_torch.train.loop import Trainer
    from spnerf_torch.config import LossConfig

    g = np.random.default_rng(1)
    M = 1024 * 64 * 8
    for t_eff in (8192, 32768, 65536):
        assert dt.route(t_eff, 2, M) == "dense"
        ids = torch.from_numpy(g.integers(0, t_eff, M)).to(device)
        ct = torch.from_numpy(g.normal(size=(2, M)).astype(np.float32)).to(
            device)
        out = dt.dtab(ids, ct, t_eff, 2)
        ref = dt.dtab_plain(ids, ct, t_eff)
        assert out.shape == (2, t_eff)
        assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    cfg = ModelConfig(mapping=True, sem=True, num_sem_classes=3, fc_units=64)
    rc = RenderConfig(n_samples=16, solar_correction=True, sem=True,
                      compute_dtype="bfloat16", proposal=True)
    tr = Trainer(cfg, rc, LossConfig(sc_lambda=0.1, sem=True), device=device)
    state = tr.init_state(torch.Generator().manual_seed(0))
    data = tr.to_device(fake_batch(np.random.default_rng(2), 4096))
    for k in dt.launches:
        dt.launches[k] = 0
    ld = tr.train_step(state, data, batch_size=256)
    torch.cuda.synchronize()
    assert dt.launches["dtab_dense"] == 8 and np.isfinite(ld["loss"].item())
    assert sum(dt.launches.values()) == 8


@pytest.mark.cuda
def test_occgrid_cli_on_the_card(device, tmp_path):
    """`main --occgrid` on a small AOI: its validation renders through B1
    with the trained grid, and the checkpoint gives the grid back on the
    card bit for bit, with the field and the Adam state."""
    from spnerf_torch.cli.train import main
    from spnerf_torch.config import (build_train_parser, finalize_args,
                                     loss_config_from_args,
                                     model_config_from_args,
                                     render_config_from_args)
    from spnerf_torch.train.checkpoints import CheckpointManager
    from spnerf_torch.train.loop import Trainer
    from spnerf_torch.utils.synth_scene import write_synthetic_aoi

    write_synthetic_aoi(str(tmp_path / "dataset" / "DFC2019_269"), width=48,
                        height=44, roi_size=28, seed=6)
    argv = ["--aoi_id", "JAX_269", "--model", "sp-nerf", "--exp_name", "o",
            "--no_timestamp_exp_name", "--project_dir", str(tmp_path),
            "--mapping", "--guidedsample", "--sem", "--num_sem_classes", "3",
            "--sc_lambda", "0.1", "--ss_lambda", "1.0", "--fc_units", "64",
            "--n_samples", "8", "--occgrid", "--occ_res", "16",
            "--occ_rows", "512", "--chunk", "1024", "--batch_size", "256",
            "--log_every", "2", "--max_train_steps", "4",
            "--device", str(device)]
    fe.FusedField.launches = 0
    state = main(argv)
    assert state.occ.device.type == "cuda"
    assert (state.occ != 1.0).sum().item() > 0  # four slabs refreshed
    args = finalize_args(build_train_parser().parse_args(argv),
                         make_dirs=False)
    rc = render_config_from_args(args)
    chunks = -(-48 * 44 // chunk_size(rc, 1024))
    assert fe.FusedField.launches == 3 * chunks * 2
    tr = Trainer(model_config_from_args(args), rc,
                 loss_config_from_args(args), occ_rows=512, device=device)
    fresh = tr.init_state(torch.Generator().manual_seed(1))
    mgr = CheckpointManager(tmp_path / "output" / "o" / "ckpts")
    assert mgr.restore(fresh) is fresh and fresh.step == 4
    assert fresh.occ.device.type == "cuda"
    assert torch.equal(fresh.occ, state.occ)
    for (k, a), b in zip(state.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    saved = state.optimizer.state_dict()["state"]
    restored = fresh.optimizer.state_dict()["state"]
    for i in saved:
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(saved[i][k], restored[i][k]), (i, k)


def siren_inputs(n, width, dtype, device):
    return [t.to(device) for t in epilogue_inputs(n, width, dtype)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("w0", [30.0, 1.0])
@pytest.mark.parametrize("n,width", [(4097, 512), (3001, 1024), (4099, 256),
                                     (1001, 6)])
def test_siren_act_kernel_matches_plain(device, dtype, w0, n, width):
    """Both kernels bit for bit against the plain composition on the card:
    the flagship's and the 1024-wide field's widths and the 256-wide heads
    (the 16-byte path), rows that leave a ragged last block and a ragged
    grid-stride pass, and a width of 6 (the one-element path)."""
    from spnerf_torch.models.spnerf import (sine_layer_grad_plain,
                                            sine_layer_plain)
    from spnerf_torch.ops import siren_act

    y, bias, gs = siren_inputs(n, width, dtype, device)
    s_plain, z_plain = sine_layer_plain(y, bias, w0, dtype)
    gy_plain = sine_layer_grad_plain(gs, z_plain, w0)
    s, z = siren_act.forward(y, bias, w0, dtype)
    gy = siren_act.backward(gs, z, w0)
    gy_strided = siren_act.backward(
        torch.cat([gs, gs[:, :3]], dim=1)[:, :width], z, w0)
    torch.cuda.synchronize()
    assert s.dtype == z.dtype == dtype and gy.dtype == torch.float32
    assert torch.equal(z, z_plain)
    assert torch.equal(s, s_plain)
    assert torch.equal(gy, gy_plain)
    assert torch.equal(gy_strided, gy_plain)


@pytest.mark.cuda
def test_siren_act_refuses_what_it_does_not_take(device):
    from spnerf_torch.ops import siren_act

    y, bias, gs = siren_inputs(8, 16, torch.bfloat16, device)
    with pytest.raises(ValueError):
        siren_act.forward(y.cpu(), bias.cpu(), 1.0, torch.bfloat16)
    with pytest.raises(ValueError):
        siren_act.forward(y.half(), bias, 1.0, torch.bfloat16)
    with pytest.raises(ValueError):
        siren_act.forward(y, bias, 1.0, torch.float16)
    with pytest.raises(ValueError):
        siren_act.forward(y, bias[:8], 1.0, torch.bfloat16)
    _, z = siren_act.forward(y, bias, 1.0, torch.bfloat16)
    with pytest.raises(ValueError):
        siren_act.backward(gs.float(), z, 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_siren_act_field_step_matches_the_unfused_field(device, dtype,
                                                        monkeypatch):
    """A flagship-configuration field's forward and backward with a solar
    tail, through the kernels and through the unfused composition: every
    output and every parameter's gradient equal. One forward and one
    backward launch per Siren activation (13 with every head, 11 pruned to
    the sun head), none through the plain version."""
    from spnerf_torch.models import spnerf
    from spnerf_torch.models.spnerf import SineLayer
    from spnerf_torch.utils.synth import flagship_configs

    mc, _ = flagship_configs()
    n_view, n_sc = 3000, 1001
    xyz, sun, _, sems = field_inputs(n_view + n_sc, mc, device, seed=3)
    model = load_model(mc, dtype, device=device,
                       generator=torch.Generator().manual_seed(0))
    weights = [torch.randn(1, generator=torch.Generator().manual_seed(k))
               .item() for k in range(8)]

    def step(heads, tail):
        model.zero_grad()
        out = model(xyz, sun, None, sems, heads=heads, solar_tail=tail)
        loss = sum(w * v.float().square().mean()
                   for w, v in zip(weights, out.values()))
        loss.backward()
        grads = {k: p.grad.clone() for k, p in model.named_parameters()
                 if p.grad is not None}
        return out, grads

    for heads, tail, acts in ((None, n_sc, 13), (("sun",), 0, 11)):
        launches = dict(SineLayer.launches)
        plain = dict(SineLayer.plain_calls)
        out, grads = step(heads, tail)
        torch.cuda.synchronize()
        for way in ("forward", "backward"):
            assert SineLayer.launches[way] - launches[way] == acts, way
        assert SineLayer.plain_calls == plain
        with monkeypatch.context() as m:
            m.setattr(spnerf, "SineLayer", UnfusedSineLayer)
            ref_out, ref_grads = step(heads, tail)
        assert out.keys() == ref_out.keys()
        for k in out:
            assert torch.equal(out[k], ref_out[k]), k
        assert grads.keys() == ref_grads.keys()
        for k in grads:
            assert torch.equal(grads[k], ref_grads[k]), k
