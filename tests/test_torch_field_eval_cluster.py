"""B1's wide route (`csrc/field_eval_wide.cu`, "wgmma_wide") on clusters of
4 and 8 CTAs and with semantic heads wider than TAIL_N, on the CPU: the
C-CTA schedule emulated with torch ops (`emulate_wide` of
tests/test_torch_field_eval_wide.py, on packs whose cluster is forced so
that 4- and 8-CTA splits run at narrow widths), the packed layout read
back, the cluster, shared-memory and ring reckoning up to 4,096 wide, the
route table at its edges, the wrapper's refusals, the port against the
JAX package on the same weights, and the float32 sums' drift with the
depth in the tensor cores' rounding model (`utils/f32_sums.py`), which the
kernel's slab sums past 1,024 wide hold.

Tolerances, those of tests/test_torch_field_eval_wide.py: `emulate_wide`
against the plain version 1e-6 with exact float32 products ("float32"),
1e-5 as three TF32 products ("tf32x3"), 2e-2 in bf16; the plain version and
the emulation against the Pallas kernel in interpret mode 1e-5 (float32)
and 2e-2 (bf16); the port's plain field against the JAX module 2e-5 in
float32 (tests/test_torch_field.py's bar) and 2e-2 in bf16, where both
sides carry bf16 operands but the JAX module also rounds each layer's
output to bf16.

The CUDA kernel itself is tested on the card by tests/test_torch_cuda.py
and `chip_smoke.py` phase 21.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spnerf_tpu.config import ModelConfig as JaxModelConfig
from spnerf_tpu.models.spnerf import SPNeRF as JaxSPNeRF
from spnerf_torch.config import ModelConfig
from spnerf_torch.convert import flax_field_params
from spnerf_torch.models import SPNeRF
from spnerf_torch.models.spnerf import layer_specs
from spnerf_torch.ops import field_eval as tfe
from spnerf_torch.utils import f32_sums
from test_torch_field_eval import (ALL, assert_match, jax_fused, make_inputs,
                                   make_pair)
from test_torch_field_eval_wide import (_inputs, check_wide_layout,
                                        emulate_wide, wide_pack)

POLICIES = [("float32", 1e-6), ("tf32x3", 1e-5), ("bfloat16", 2e-2)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tier-1 command runs six test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def held(p, heads, policy, atol, rng, n=130):
    """`emulate_wide` on pack `p` against the plain version, `heads`, on n
    points of numpy inputs."""
    dtype = "bfloat16" if policy == "bfloat16" else "float32"
    field = tfe.FusedField(p, dtype)
    x_in, sun, t_in = _inputs(rng, n, p, field)
    has_t = p.cfg.beta and "beta" in heads
    prog = tfe.program(p, heads)
    assert len(prog) <= tfe.MAX_OPS
    out = emulate_wide(p, prog, x_in, sun, t_in if has_t else None, policy)
    ref = tfe.fused_field_plain(p, x_in, sun, t_in, heads, dtype)
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_allclose(out[k].numpy(), ref[k].numpy(), atol=atol,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("policy,atol", POLICIES)
@pytest.mark.parametrize("cluster,width,kw", [
    (4, 96, dict(beta=True)), (4, 160, {}),
    (4, 256, dict(beta=True, t_embedding_dims=20)), (8, 200, {}),
    (8, 512, dict(beta=True))])
@pytest.mark.parametrize("heads", [ALL, ("sun",)])
def test_cluster_schedule_matches_plain(policy, atol, cluster, width, kw,
                                        heads, rng):
    """The C-CTA schedule on packs forced to C = 4 and 8: at 96 on 4 CTAs
    (128 columns: a share of one 32-wide chunk), at 160 on 4 (192 columns
    padded to 256: shares of one 64-wide chunk, the last one padding), at
    256 on 4 (64 a share), at 200 on 8 (256 columns, 32 a share) and at 512
    on 8 (64 a share), with transient codes of 4 and 20; all heads and the
    solar pass's."""
    dtype = "bfloat16" if policy == "bfloat16" else "float32"
    p = wide_pack(width, dtype, cluster=cluster, **kw)
    assert p.cluster == cluster
    assert p.layers["trunk1"].npad == tfe._ceil(width, 32 * cluster)
    held(p, heads, policy, atol, rng)


@pytest.mark.parametrize("policy,atol", POLICIES)
@pytest.mark.parametrize("classes", [17, 64, 150])
@pytest.mark.parametrize("cluster", [2, 4])
def test_wide_heads_schedule_matches_plain(policy, atol, classes, cluster,
                                           rng):
    """Semantic heads of 17, 64 and 150 classes (ADE20K's count) at 80 wide
    with a beta head, on 2 and 4 CTAs: the logits' weight padded to
    ceil16(classes) columns, summed in passes of TAIL_N, every head."""
    dtype = "bfloat16" if policy == "bfloat16" else "float32"
    p = wide_pack(80, dtype, cluster=cluster, beta=True,
                  num_sem_classes=classes)
    lp = p.layers["sem1"]
    assert (lp.nreal, lp.npad) == (classes, tfe._ceil(classes, tfe.TAIL_N))
    held(p, ALL, policy, atol, rng, n=70)


@pytest.mark.parametrize("policy,atol", POLICIES)
@pytest.mark.parametrize("cluster", [2, 8])
def test_narrowest_field_on_the_wide_route(policy, atol, cluster, rng):
    """fc_units 2, whose heads' hidden layers are 1 wide (one padded chunk
    a CTA), packed for the wide kernel (its route in bf16; wgmma_f32's in
    float32) computes the plain version's outputs on 2 and 8 CTAs;
    fc_units 1 (no module has one) takes no kernel, so `route` names the
    general kernel for no width."""
    dtype = "bfloat16" if policy == "bfloat16" else "float32"
    p = wide_pack(2, dtype, cluster=cluster, beta=True)
    assert tfe.route(p.cfg, dtype) == (
        "wgmma_wide" if dtype == "bfloat16" else "wgmma_f32")
    assert p.layers["rgb0"].npad == 32 * cluster
    assert p.layers["rgb0"].nreal == 1
    held(p, ALL, policy, atol, rng, n=40)
    assert tfe.route(dataclasses.replace(p.cfg, fc_units=1), dtype) is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cluster,width,kw", [
    (4, 160, dict(beta=True, t_embedding_dims=20)), (8, 200, {}),
    (2, 80, dict(num_sem_classes=150))])
def test_cluster_layout(dtype, cluster, width, kw):
    """Read back through the swizzle and the K order, the C shares of
    every wide layer give the module's weights exactly, the layers tile
    `w_all`, the biases are the module's: at C = 4 and 8 and with 150
    classes."""
    p = wide_pack(width, dtype, cluster=cluster, **kw)
    assert p.cluster == cluster
    check_wide_layout(p)


def test_cluster_reckoning():
    """For C in 2, 4, 8 at 1,536, 2,048, 3,072 and 4,096 wide: a launch
    exists where each CTA owns at most 512 columns, its ring is at least a
    share's chunks deep and fits 232,448 bytes; the default cluster is the
    smallest that exists; the pinned values."""
    for width in (1536, 2048, 3072, 4096):
        takes = []
        for c in tfe.WIDE_CLUSTERS:
            share = tfe.wide_share(width, c)
            assert share * c == tfe._ceil(width, 32 * c)
            stages = tfe.wide_stages(width, c)
            if share > tfe.WIDE_SHARE_MAX:
                assert stages == 0, (width, c)
                continue
            takes.append(c)
            assert stages >= max(2, -(-share // 64))
            assert tfe.wide_smem_bytes(width, stages, c) <= tfe.SMEM_LIMIT
            if stages < tfe.WIDE_MAX_STAGES:
                assert tfe.wide_smem_bytes(width, stages + 1,
                                           c) > tfe.SMEM_LIMIT
        assert tfe.wide_cluster(width) == takes[0]
    assert [tfe.wide_cluster(w) for w in (1536, 2048, 3072, 4096)] == [
        4, 4, 8, 8]
    assert tfe.wide_share(1056) == 288  # 1,088 columns padded to 1,152
    assert tfe.wide_stages(1536, 4) == tfe.wide_stages(3072, 8) == 12
    assert tfe.wide_smem_bytes(1536, 12, 4) == 210_128
    assert tfe.wide_stages(4096, 4) == 0 and tfe.wide_stages(2048, 2) == 0
    assert tfe.wide_stages(64, 3) == tfe.wide_stages(64, 16) == 0


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("width,classes,want", [
    (1025, 3, "wgmma_wide"), (2048, 3, "wgmma_wide"),
    (4096, 3, "wgmma_wide"), (4097, 3, None), (1024, 17, "wgmma_wide"),
    (1024, 150, "wgmma_wide"), (512, 17, "f32_wide"), (512, 64, "f32_wide"),
    (512, 150, "f32_wide"), (96, 150, "f32_wide"), (80, 150, "wgmma_wide")])
def test_route_at_the_edges(dtype, width, classes, want):
    """The route at 1,025, 2,048, 4,096 and 4,097 wide and at 17, 64 and 150
    classes: the wide kernel up to W_MAX, the module above it; a bf16 field
    within the wgmma envelope keeps the one-CTA kernel at any class count,
    a float32 one of more than 16 classes goes to the wide kernel on 2
    CTAs; the general kernel for none."""
    cfg = ModelConfig(fc_units=width, mapping=True, sem=True,
                      num_sem_classes=classes)
    if want == "f32_wide":
        want = "wgmma" if dtype == "bfloat16" else "wgmma_wide"
    assert tfe.route(cfg, dtype) == want
    assert tfe.uses_fused_kernel("cuda", cfg, dtype) is (want is not None)
    if want == "wgmma_wide":
        assert tfe.supports_wide(cfg)
        assert tfe.wide_cluster(width) == (2 if width <= 1024 else 4
                                           if width <= 2048 else 8)
    if width <= 512:
        p = tfe.pack_params(SPNeRF(cfg), dtype)
        assert p.route == want
        assert p.cluster == (2 if want == "wgmma_wide" else 0)


def test_cluster_wrapper_refusals(rng):
    """The wide wrapper refuses CPU tensors on a pack of 4 or 8 CTAs, and a
    pack whose cluster is not the one its layout was made for (before it
    looks at the tensors); on the CPU a FusedField over a pack of 8 runs
    the plain version and launches nothing."""
    x, sun = torch.zeros(4, 63), torch.zeros(4, 3)
    for c in (4, 8):
        p = wide_pack(96, "bfloat16", cluster=c)
        with pytest.raises(ValueError, match="CUDA tensors"):
            tfe.fused_field_wide(p, x, sun)
    p = wide_pack(96, "float32", cluster=2)
    for other in (8, 3, 0):
        with pytest.raises(ValueError, match=f"clusters of {other} CTAs"):
            tfe.fused_field_wide(dataclasses.replace(p, cluster=other), x,
                                 sun)
    p8 = wide_pack(96, "float32", cluster=8)
    field = tfe.FusedField(p8, "float32")
    before = dict(tfe.FusedField.route_launches)
    xyz = torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32))
    s = torch.ones(5, 3) / 3 ** 0.5
    sems = torch.zeros(5, dtype=torch.long)
    out = field(xyz, s, None, sems)
    x_in, sun_t, _ = field.inputs(xyz, s, None, sems)
    ref = tfe.fused_field_plain(p8, x_in, sun_t, None, ALL, "float32")
    for k in ref:
        assert torch.equal(out[k], ref[k])
    assert tfe.FusedField.route_launches == before


def numpy_field(cfg, seed):
    """An `SPNeRF` with numpy-seeded weights: Siren-scaled uniform kernels
    (1 / fan_in on the first sine layers, sqrt(6 / fan_in) / 30 on the
    others), small uniform biases and semantic table."""
    g = np.random.default_rng(seed)
    model = SPNeRF(cfg)
    sd = model.state_dict()
    for name, segs, out, init in layer_specs(cfg):
        i = model.index[name]
        fan_in = sum(segs)
        bound = (1 / fan_in if init == "first_sine"
                 else np.sqrt(6 / fan_in) / 30)
        sd[f"dense.{i}.kernel"] = torch.from_numpy(g.uniform(
            -bound, bound, (fan_in, out)).astype(np.float32))
        sd[f"dense.{i}.bias"] = torch.from_numpy(g.uniform(
            -0.1, 0.1, out).astype(np.float32))
    if cfg.sem:
        sd["semantic_embedding"] = torch.from_numpy(g.uniform(
            -1, 1, tuple(sd["semantic_embedding"].shape)).astype(np.float32))
    model.load_state_dict(sd)
    return model


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5),
                                        ("bfloat16", 2e-2)])
def test_plain_field_matches_the_jax_module_at_1536(dtype, atol, rng):
    """At 1,536 wide (a 4-CTA field on the card) with the semantic and beta
    heads, the port's plain field (what the wide kernel is held against)
    and the JAX package's module agree on the same numpy-seeded weights,
    converted through `convert.py`, and 64 points of numpy inputs."""
    kw = dict(mapping=True, fc_units=1536, fc_layers=8, skips=(4,),
              sem=True, num_sem_classes=3, beta=True)
    model = numpy_field(ModelConfig(**kw), seed=1536)
    assert tfe.route(model.cfg, dtype) == "wgmma_wide"
    assert tfe.wide_cluster(1536) == 4
    xyz, sun, sems, t_emb = make_inputs(rng, 64, model.cfg)
    jmodel = JaxSPNeRF(cfg=JaxModelConfig(**kw), compute_dtype=(
        jnp.float32 if dtype == "float32" else jnp.bfloat16))
    ref = jax.jit(jmodel.apply)(
        {"params": flax_field_params(model.state_dict())}, jnp.asarray(xyz),
        jnp.asarray(sun), jnp.asarray(t_emb), jnp.asarray(sems))
    field = tfe.FusedField(tfe.pack_params(model, dtype), dtype)
    out = field(*(torch.from_numpy(a) for a in (xyz, sun, t_emb, sems)))
    assert_match({k: v.numpy() for k, v in out.items()},
                 {k: np.asarray(v, np.float32) for k, v in ref.items()},
                 atol)


@pytest.fixture(scope="module")
def ade20k_pair():
    """(flax params, JAX config, port module) of one 80-wide field of 150
    classes with a beta head, on the same weights."""
    return make_pair(width=80, sem=True, beta=True, num_sem_classes=150)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
def test_plain_and_schedule_match_pallas_at_150_classes(dtype, atol,
                                                        ade20k_pair, rng):
    """150 semantic classes at fc_units 80 with a beta head (the wide
    route in both dtypes): the plain version and the emulated schedule (2
    CTAs, the logits in ten passes) agree with the Pallas kernel in
    interpret mode on the same weights and 64 points."""
    params, jcfg, model = ade20k_pair
    assert tfe.route(model.cfg, dtype) == "wgmma_wide"
    inputs = make_inputs(rng, 64, model.cfg)
    ref = jax_fused(params, jcfg, inputs, dtype, ALL)
    p = tfe.pack_params(model, dtype)
    assert p.route == "wgmma_wide" and p.cluster == 2
    field = tfe.FusedField(p, dtype)
    as_t = lambda a: None if a is None else torch.from_numpy(a)
    xyz, sun, sems, t_emb = inputs
    out = field(as_t(xyz), as_t(sun), as_t(t_emb), as_t(sems))
    assert_match({k: v.numpy() for k, v in out.items()}, ref, atol)
    x_in, sun_t, t_in = field.inputs(as_t(xyz), as_t(sun), as_t(t_emb),
                                     as_t(sems))
    emu = emulate_wide(p, tfe.program(p, ALL), x_in, sun_t, t_in,
                       "tf32x3" if dtype == "float32" else dtype)
    assert_match({k: v.numpy() for k, v in emu.items()}, ref, atol)


def test_round_toward_zero():
    """`toward_zero` rounds float64 to float32 toward zero: a value a float32
    holds stays, one between two float32s goes to the one nearer zero, on
    either sign."""
    x = torch.tensor([1.0, -2.5, 0.0, 1.0 + 2.0 ** -30, -(1.0 + 2.0 ** -30),
                      1.0 - 2.0 ** -30], dtype=torch.float64)
    got = f32_sums.toward_zero(x)
    assert got.dtype == torch.float32
    below_one = torch.nextafter(torch.tensor(1.0), torch.tensor(0.0)).item()
    assert got.tolist() == [1.0, -2.5, 0.0, 1.0, -1.0, below_one]


def test_truncated_sums_drift_with_depth_and_slabs_hold_them():
    """The wide route's float32 sums in the tensor cores' rounding model
    (`f32_sums.tc_sum`: three TF32 products a k step, each wgmma's sum
    rounded toward zero). With one accumulator through the whole K, the
    distance from the float64 product grows with the depth, about in
    proportion (2,048 deep against 512); with a fresh partial sum every
    16-deep slab added rounded to nearest (the kernel's schedule) it stays
    within 3x of float32 sums rounded to nearest at either depth, and a
    tenth of the one accumulator's at 2,048. 16 x 16 outputs, seed 0."""
    r = f32_sums.emulate([512, 2048], n=16, width=16, seed=0)
    assert r[2048]["one_accumulator"] >= 3 * r[512]["one_accumulator"]
    for k in (512, 2048):
        assert r[k]["per_slab"] <= 3 * r[k]["float32_rn"], (k, r[k])
    assert r[2048]["per_slab"] <= r[2048]["one_accumulator"] / 10
