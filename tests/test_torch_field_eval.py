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
from spnerf_torch.models.spnerf import fast_sin, softplus
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
    field = tfe.FusedField(tfe.pack_params(model, dtype), dtype)
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


def stage_tile(p, lp, n0, nc, s):
    """The weight stage (n0, nc, s) of a layer read back from `w_all` at the
    offset the kernel's producer computes: nc rows (output columns) x 64
    (input rows), unswizzled (row n's 16-byte chunk c sits at c ^ (n % 8))."""
    ns = -(-lp.k1 // 64) + -(-lp.k2 // 64)
    off = (lp.w_off + (n0 * ns + s * nc) * 128) // 2
    flat = p.w_all[off:off + nc * 64]
    n = torch.arange(nc)[:, None]
    k = torch.arange(64)[None, :]
    return flat[n * 64 + ((k // 8) ^ (n % 8)) * 8 + k % 8]


def unpacked(p, name):
    """A layer's (K, N) weight rebuilt from its stages: (ceil64(k1) +
    ceil64(k2), npad), each input segment from a slab boundary."""
    lp = p.layers[name]
    ns = -(-lp.k1 // 64) + -(-lp.k2 // 64)
    w = torch.zeros(ns * 64, lp.npad, dtype=torch.bfloat16)
    for n0 in range(0, lp.npad, 128):
        nc = min(128, lp.npad - n0)
        for s in range(ns):
            w[s * 64:(s + 1) * 64, n0:n0 + nc] = stage_tile(p, lp, n0, nc,
                                                            s).t()
    return w


@pytest.mark.parametrize("width", [64, 96, 160, 320])
def test_pack_params_layout(width):
    """Every weight, rounded to bf16, comes back from its swizzled place in
    the kernel's stages, and everything else in `w_all` is zero; the stages
    tile `w_all` exactly, layer after layer."""
    _, _, model = make_pair(width=width, sem=True, beta=True,
                            num_sem_classes=3)
    p = tfe.pack_params(model)
    assert p.k0_pad == 64 and len(p.names) == len(p.layers) == 22
    end = nonzero = 0
    for name, w, b in zip(p.names, p.ws, p.bs):
        lp = p.layers[name]
        assert lp.w_off == end and lp.k1 % 16 == 0 and lp.k2 % 16 == 0
        assert lp.nreal == w.shape[1]
        assert lp.npad == (16 if lp.nreal <= 16 else -(-lp.nreal // 64) * 64)
        got = unpacked(p, name)
        k1 = w.shape[0] if not lp.k2 else width  # first segment's real depth
        k1p = -(-lp.k1 // 64) * 64
        assert torch.equal(got[:k1, :lp.nreal], w[:k1].bfloat16()), name
        if lp.k2:
            assert torch.equal(got[k1p:k1p + w.shape[0] - k1, :lp.nreal],
                               w[k1:].bfloat16()), name
        nonzero += int((got != 0).sum())
        end += 2 * got.numel()
        bias = p.b_all[lp.b_off:lp.b_off + lp.npad]
        assert torch.equal(bias[:lp.nreal], b)
        assert not bias[lp.nreal:].any()
    assert end == 2 * p.w_all.numel()
    assert nonzero == int((p.w_all != 0).sum())
    assert nonzero == sum(int((w.bfloat16() != 0).sum()) for w in p.ws)


def emulate(p, prog, x_in, sun, t_in):
    """The kernel's layer program run with torch ops on weights read back
    from its stages: bf16 activation buffers, float32 sums, bias and
    activation, the head outputs in float32."""
    n = x_in.shape[0]
    pad = lambda a, w: torch.nn.functional.pad(a, (0, w - a.shape[1]))
    width = p.cfg.fc_units
    srcs = {0: torch.zeros(n, -(-width // 64) * 64),
            1: torch.zeros(n, -(-width // 64) * 64),
            2: pad(x_in, 128).bfloat16().float(),
            3: pad(sun, 64).bfloat16().float(),
            4: pad(t_in, 64).bfloat16().float() if t_in is not None else None}
    acts = [lambda v: fast_sin(30.0 * v), fast_sin, torch.relu, lambda v: v,
            softplus, lambda v: torch.sigmoid(v) * 1.002 - 0.001,
            torch.sigmoid]
    res = {}
    for w_off, b_off, k1, k2, npad, nreal, a1, a2, dst, epi, out in prog:
        name = next(nm for nm, lp in p.layers.items() if lp.w_off == w_off)
        w = unpacked(p, name).float()
        k1p = -(-k1 // 64) * 64
        a = torch.zeros(n, w.shape[0])
        a[:, :k1] = srcs[a1][:, :k1]
        if k2:
            a[:, k1p:k1p + k2] = srcs[a2][:, :k2]
        y = acts[epi](a @ w + p.b_all[b_off:b_off + npad])
        if dst >= 0:
            srcs[dst][:, :npad] = y.bfloat16().float()
        else:
            res[tfe.OUTPUTS[out]] = y[:, :nreal]
    res["sigma"] = res["sigma"][:, 0]
    return res


@pytest.mark.parametrize("width", [64, 96, 160, 320])
@pytest.mark.parametrize("heads", [ALL, ("sun",), ("rgb", "sky"),
                                   ("beta", "sem"), ()])
def test_program_matches_plain(width, heads, rng):
    """The kernel's layer program (`program`), run on weights read back from
    the kernel's stages, computes the plain version's outputs for the head
    subset (bf16, 2e-2: both round the same activations, in other sum
    orders)."""
    _, _, model = make_pair(width=width, sem=True, beta=True,
                            num_sem_classes=3)
    p = tfe.pack_params(model)
    field = tfe.FusedField(p)
    xyz, sun, sems, t_emb = make_inputs(rng, 130, model.cfg)
    as_t = torch.from_numpy
    x_in, sun_t, t_in = field.inputs(as_t(xyz), as_t(sun), as_t(t_emb),
                                     as_t(sems))
    prog = tfe.program(p, heads)
    assert len(prog) <= tfe.MAX_OPS
    out = emulate(p, prog, x_in, sun_t, t_in)
    ref = tfe.fused_field_plain(p, x_in, sun_t, t_in, heads)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), ref[k].numpy(), atol=2e-2,
                                   rtol=0, err_msg=k)


def test_program_stream_and_smem():
    """The flagship's weight stream a tile (all heads and the solar pass),
    and the kernel's weight ring: 5 stages beside the flagship's tiles (4
    with a beta head), 2 at fc_units 640 with a beta head and 704 without;
    none for wider fields, which the kernel does not take."""
    cfg = ModelConfig(mapping=True, sem=True, num_sem_classes=3)
    p = tfe.pack_params(SPNeRF(cfg, "bfloat16"))
    per_tile = tfe.stream_bytes(p, ALL)
    assert per_tile == 2 * sum(lp.npad * lp.slabs * 64
                               for lp in p.layers.values())
    assert tfe.stream_bytes(p, ("sun",)) < per_tile
    assert tfe.ring_stages(512, 64, False) == 5
    assert tfe.ring_stages(512, 64, True) == 4
    assert tfe.ring_stages(640, 64, True) == 2
    assert tfe.ring_stages(704, 64, False) == 2
    assert tfe.ring_stages(64, 64, False) == tfe.MAX_STAGES
    for width, has_t in ((672, True), (736, False)):
        assert tfe.ring_stages(width, 64, has_t) == 0


@pytest.mark.parametrize("width,beta,want", [
    (640, True, True), (672, True, False), (704, False, True),
    (736, False, False), (768, False, False), (800, True, False),
    (100, False, False)])
def test_wide_fields_route_to_the_module(width, beta, want):
    """The wgmma kernel takes fc_units that are multiples of 32 up to 704
    (640 with a beta head); a bf16 render of any other width up to W_MAX on
    CUDA takes the wide kernel (these widths took the module before the
    general kernel was ported, then the general kernel; only fields wider
    than W_MAX still take the module), and the weights pack for its
    route."""
    cfg = ModelConfig(mapping=True, sem=True, beta=beta, num_sem_classes=3,
                      fc_units=width)
    assert tfe.supports_config(cfg) is want
    assert tfe.route(cfg, "bfloat16") == ("wgmma" if want else "wgmma_wide")
    assert tfe.uses_fused_kernel("cuda", cfg, "bfloat16")
    p = tfe.pack_params(SPNeRF(cfg, "bfloat16"))
    assert p.route == tfe.route(cfg, "bfloat16")
    assert p.layers["trunk1"].nreal == width


@pytest.mark.parametrize("device,dtype,want", [
    ("cuda", "bfloat16", True), ("cuda", torch.bfloat16, True),
    ("cuda", "float32", True), ("cpu", "bfloat16", False),
    ("cpu", "float32", False)])
def test_uses_fused_kernel(device, dtype, want):
    """Renders take a kernel on CUDA in both dtypes (bf16 the wgmma kernel,
    float32 the general one), and the CPU never takes one; nor does an
    uncovered configuration."""
    cfg = ModelConfig(mapping=True, sem=True, num_sem_classes=3)
    assert tfe.uses_fused_kernel(device, cfg, dtype) is want
    relu = ModelConfig(mapping=True, siren=False)
    assert not tfe.uses_fused_kernel(device, relu, dtype)


def test_flops_per_point_flagship():
    cfg = ModelConfig(mapping=True, sem=True, num_sem_classes=3)
    assert tfe.flops_per_point(cfg) == 2 * 2_690_560
    assert tfe.flops_per_point(cfg, ("sun",)) == 4_850_688


def test_kernel_refuses_cpu_tensors():
    _, _, model = make_pair(sem=True, num_sem_classes=3)
    p = tfe.pack_params(model)
    with pytest.raises(ValueError):
        tfe.fused_field_kernel(p, torch.zeros(4, 63), torch.zeros(4, 3))
