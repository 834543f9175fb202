"""The fused field's general route (`csrc/field_eval_general.cu`) on the
CPU: its routing, its packed layout, its tile and shared-memory reckoning,
its schedule emulated with torch ops, and the plain version against the JAX
package's Pallas kernel in interpret mode at the widths and shapes the wgmma
kernel does not take.

Tolerances. The emulated schedule against the plain version: float32 1e-6
(the same float32 products, summed slab by slab in another order), bf16
2e-2 (as `test_program_matches_plain`: a sum-order difference can move an
activation across a bf16 rounding boundary). The plain version against the
Pallas kernel: float32 1e-5, bf16 2e-2, the bars of
tests/test_torch_field_eval.py.

The CUDA kernel itself is tested on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from spnerf_torch.config import ModelConfig
from spnerf_torch.models import SPNeRF
from spnerf_torch.models.spnerf import fast_sin, softplus
from spnerf_torch.ops import field_eval as tfe
from test_torch_field_eval import (ALL, assert_match, jax_fused, make_inputs,
                                   make_pair, port_fused)

# the flagship's trunk input: 10-frequency mapping + 3-class embedding
FLAGSHIP = dict(mapping=True, sem=True, num_sem_classes=3)


def emulate_general(p, prog, x_in, sun, t_in):
    """The general kernel's schedule with torch ops, on weights read back
    from `w_all` at the offsets the kernel computes: the points in tiles of
    BM (the last one zero-padded; every tile runs the same arithmetic, so
    all run at once here), K-major float32 activation buffers (rounded to
    bf16 in the bf16 policy), each layer in passes of NC columns, each pass
    summed slab by slab (GKS rows of the layer's row-major matrix), then
    bias and activation."""
    cfg = p.cfg
    bf16 = p.compute_dtype == torch.bfloat16
    op = (lambda v: v.bfloat16().float()) if bf16 else (lambda v: v)
    t_pad = 0 if t_in is None else -(-t_in.shape[1] // tfe.GKS) * tfe.GKS
    bm = tfe.general_tile_rows(cfg.fc_units, p.k0_pad, t_pad)
    nc = tfe.general_pass_cols(bm)
    wbuf = -(-cfg.fc_units // tfe.GKS) * tfe.GKS
    acts = [lambda v: fast_sin(30.0 * v), fast_sin, torch.relu, lambda v: v,
            softplus, lambda v: torch.sigmoid(v) * 1.002 - 0.001,
            torch.sigmoid]
    n = x_in.shape[0]
    rows = -(-n // bm) * bm

    def tile_of(a, cols):
        out = torch.zeros(rows, cols)
        out[:n, :a.shape[1]] = a
        return op(out)

    srcs = {0: torch.zeros(rows, wbuf), 1: torch.zeros(rows, wbuf),
            2: tile_of(x_in, p.k0_pad), 3: tile_of(sun, tfe.GKS),
            4: None if t_in is None else tile_of(t_in, t_pad)}
    res = {}
    for w_off, b_off, k1, k2, npad, nreal, a1, a2, dst, epi, out in prog:
        w = p.w_all[w_off:w_off + (k1 + k2) * npad].view(k1 + k2, npad)
        y = torch.zeros(rows, npad)
        for n0 in range(0, npad, nc):
            cols = min(nc, npad - n0)
            acc = torch.zeros(rows, cols)
            for k in range(0, k1 + k2, tfe.GKS):
                a = (srcs[a1][:, k:k + tfe.GKS] if k < k1
                     else srcs[a2][:, k - k1:k - k1 + tfe.GKS])
                acc = acc + a @ w[k:k + tfe.GKS, n0:n0 + cols]
            y[:, n0:n0 + cols] = acts[epi](
                acc + p.b_all[b_off + n0:b_off + n0 + cols])
        if dst >= 0:
            srcs[dst][:, :npad] = op(y)
        else:
            res[tfe.OUTPUTS[out]] = y[:n, :nreal]
    res["sigma"] = res["sigma"][:, 0]
    return res


def general_pack(width, dtype, seed=0, kernel=None, **kw):
    cfg = ModelConfig(fc_units=width, **{**FLAGSHIP, **kw})
    model = SPNeRF(cfg, generator=torch.Generator().manual_seed(seed))
    return tfe.pack_params(model, dtype, kernel=kernel)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-6),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("width,kw", [
    (48, dict(beta=True)), (80, dict(beta=True)),
    (96, dict(beta=True, t_embedding_dims=32)), (400, {})])
@pytest.mark.parametrize("heads", [ALL, ("sun",), ("rgb", "sky"),
                                   ("beta", "sem"), ()])
def test_schedule_matches_plain(dtype, atol, width, kw, heads, rng):
    """The general kernel's schedule (`emulate_general`: its tiles, passes
    and slabs on the packed layout, its operand rounding) computes the
    plain version's outputs for the head subset, in both policies at
    widths the wgmma kernel does not take (float32 packed for the general
    kernel, which the wgmma_f32 route leaves these widths to only when
    asked); tiles of 64 points (two tiles and a ragged third) and, at 400,
    of 32 points."""
    p = general_pack(width, dtype, kernel="general", **kw)
    assert p.route == "general"
    field = tfe.FusedField(p, dtype)
    xyz, sun, sems, t_emb = make_inputs(rng, 130, p.cfg)
    as_t = lambda a: None if a is None else torch.from_numpy(a)
    x_in, sun_t, t_in = field.inputs(as_t(xyz), as_t(sun), as_t(t_emb),
                                     as_t(sems))
    prog = tfe.program(p, heads)
    assert len(prog) <= tfe.MAX_OPS
    has_t = p.cfg.beta and "beta" in heads
    out = emulate_general(p, prog, x_in, sun_t, t_in if has_t else None)
    ref = tfe.fused_field_plain(p, x_in, sun_t, t_in, heads, dtype)
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_allclose(out[k].numpy(), ref[k].numpy(), atol=atol,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width", [80, 96, 768])
def test_pack_general_layout(dtype, width):
    """Every weight, rounded to the compute dtype, comes back from its
    place in the general layout's row-major (k1 + k2, npad) matrices, each
    segment from a multiple of 16; everything else in `w_all` is zero, the
    layers tile it exactly, and the biases are float32 as the module's."""
    p = general_pack(width, dtype, kernel="general", beta=True,
                     t_embedding_dims=20)
    cd = tfe.as_dtype(dtype)
    assert p.route == "general" and p.compute_dtype == cd
    assert p.k0_pad == 64 and len(p.layers) == len(p.names) == 22
    end = nonzero = 0
    for name, w, b in zip(p.names, p.ws, p.bs):
        lp = p.layers[name]
        assert lp.w_off == end and lp.w_off % 4 == 0
        assert lp.k1 % 16 == lp.k2 % 16 == lp.npad % 16 == 0
        assert lp.npad == -(-w.shape[1] // 16) * 16 == -(-lp.nreal // 16) * 16
        got = p.w_all[end:end + (lp.k1 + lp.k2) * lp.npad].view(
            lp.k1 + lp.k2, lp.npad)
        k1 = w.shape[0] if not lp.k2 else width
        want = w.to(cd).float()
        assert torch.equal(got[:k1, :lp.nreal], want[:k1]), name
        if lp.k2:
            assert torch.equal(got[lp.k1:lp.k1 + w.shape[0] - k1, :lp.nreal],
                               want[k1:]), name
        nonzero += int((got != 0).sum())
        end += got.numel()
        bias = p.b_all[lp.b_off:lp.b_off + lp.npad]
        assert torch.equal(bias[:lp.nreal], b) and not bias[lp.nreal:].any()
    assert end == p.w_all.numel()
    assert nonzero == int((p.w_all != 0).sum())
    assert nonzero == sum(int((w.to(cd) != 0).sum()) for w in p.ws)


def test_tile_and_smem_reckoning():
    """Every width from 1 to GEN_W_MAX fits the general kernel's buffers and
    stages in 232,448 bytes, with the flagship's input and a transient code
    of up to 32; the tile shrinks with the width (64, 32, 16 points); the
    flagship's value is pinned; nothing wider than GEN_W_MAX is taken."""
    assert tfe.GEN_W_MAX >= 1024
    for t_pad in (0, 16, 32):
        tiles = [tfe.general_tile_rows(w, 64, t_pad)
                 for w in range(1, tfe.GEN_W_MAX + 1)]
        assert all(t in (64, 32, 16) for t in tiles), t_pad
        assert tiles == sorted(tiles, reverse=True)
        for w, bm in zip(range(1, tfe.GEN_W_MAX + 1), tiles):
            assert tfe.general_smem_bytes(bm, w, 64, t_pad) <= tfe.SMEM_LIMIT
            if bm < 64:  # the next larger tile does not fit
                assert tfe.general_smem_bytes(2 * bm, w, 64,
                                              t_pad) > tfe.SMEM_LIMIT
        assert tfe.general_tile_rows(tfe.GEN_W_MAX + 1, 64, t_pad) == 0
    # the flagship: 32-point tiles, 256-column passes, 174,080 bytes
    assert tfe.general_tile_rows(512, 64, 0) == 32
    assert tfe.general_pass_cols(32) == 256
    assert tfe.general_smem_bytes(32, 512, 64, 0) == 174_080
    assert tfe.general_tile_rows(1024, 64, 16) == 16
    assert [tfe.general_pass_cols(bm) for bm in (16, 32, 64)] == [512, 256,
                                                                  128]


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("width,beta,t_dims", [
    (512, False, 16), (512, True, 16), (96, True, 16), (640, True, 16),
    (704, False, 16), (672, True, 16), (736, False, 16), (768, True, 16),
    (800, False, 16), (1024, True, 16), (80, False, 16), (100, True, 16),
    (512, True, 32), (1056, False, 16)])
def test_route(device, dtype, width, beta, t_dims):
    """`route` and `uses_fused_kernel` over device x dtype x width x beta x
    transient width: bf16 within the wgmma envelope takes "wgmma" (the
    flagship among them), float32 up to F32_W_MAX "wgmma_f32" (the
    flagship among them), float32 above it up to W_MAX and bf16 outside the
    envelope "wgmma_wide" (which took "general" before the wide kernel),
    wider fields no kernel; only CUDA renders take a kernel. The weights
    pack for the route, and for the plain field where there is none."""
    cfg = ModelConfig(fc_units=width, beta=beta, t_embedding_dims=t_dims,
                      **FLAGSHIP)
    if width > tfe.W_MAX:
        want = None
    elif dtype == "bfloat16" and tfe.supports_config(cfg):
        want = "wgmma"
    elif dtype == "float32" and width <= tfe.F32_W_MAX:
        want = "wgmma_f32"
    else:
        want = "wgmma_wide"
    if (width, beta, t_dims) == (512, False, 16):
        # the flagship renders
        assert want == ("wgmma" if dtype == "bfloat16" else "wgmma_f32")
    if (width % 32 or (beta and t_dims > 16) or width > 704
            or (beta and width > 640)):
        assert not tfe.supports_config(cfg)
    assert tfe.route(cfg, dtype) == want
    assert tfe.route(cfg, tfe.as_dtype(dtype)) == want
    assert tfe.uses_fused_kernel(device, cfg, dtype) is (
        device == "cuda" and want is not None)
    if width <= 160:
        p = tfe.pack_params(SPNeRF(cfg), dtype)
        assert p.route == want and p.layers["trunk1"].nreal == width


def test_route_outside_the_family():
    for kw in (dict(siren=False), dict(skips=()), dict(encoding="hash")):
        cfg = ModelConfig(**{**FLAGSHIP, **kw})
        for dtype in ("bfloat16", "float32"):
            assert tfe.route(cfg, dtype) is None
            assert not tfe.uses_fused_kernel("cuda", cfg, dtype)
    cfg = ModelConfig(**FLAGSHIP)
    assert tfe.route(cfg, torch.float16) is None


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
@pytest.mark.parametrize("width,kw", [
    (768, dict(sem=True, num_sem_classes=3)), (768, dict(beta=True)),
    (800, dict(sem=True, num_sem_classes=3)),
    (800, dict(sem=True, beta=True, num_sem_classes=3)),
    (80, dict(sem=True, beta=True, num_sem_classes=3)),
    (64, dict(beta=True, t_embedding_dims=32))])
def test_plain_matches_pallas_outside_the_wgmma_envelope(dtype, atol, width,
                                                         kw, rng):
    """The plain version, which the general and wide kernels are held
    against on the card, against the Pallas kernel in interpret mode at
    fc_units 768 and 800 with and without a beta head, at 80 (not a
    multiple of 32) and at a transient code of 32, in both dtypes; the
    field packs for the wgmma_wide route (for the wgmma_f32 route in
    float32 up to 512) and, on the CPU, launches nothing."""
    params, jcfg, model = make_pair(width=width, **kw)
    assert tfe.route(model.cfg, dtype) == (
        "wgmma_f32" if dtype == "float32" and width <= tfe.F32_W_MAX
        else "wgmma_wide")
    inputs = make_inputs(rng, 100, model.cfg)
    before = tfe.FusedField.launches
    out = port_fused(model, inputs, dtype, ALL)
    assert tfe.FusedField.launches == before
    assert_match(out, jax_fused(params, jcfg, inputs, dtype, ALL), atol)


def test_pack_for_a_kernel():
    """`kernel=` packs a field for the named kernel whatever `route` says:
    the flagship in bf16 on the general kernel, with bf16-rounded weights;
    an unknown name, or a kernel that does not take the field at that
    dtype, raises."""
    model = SPNeRF(ModelConfig(**FLAGSHIP), "bfloat16")
    assert tfe.pack_params(model).route == "wgmma"
    p = tfe.pack_params(model, "bfloat16", kernel="general")
    assert p.route == "general" and p.compute_dtype == torch.bfloat16
    assert torch.equal(p.w_all, p.w_all.bfloat16().float())
    for kernel, dtype in (("tensor", "bfloat16"), ("wgmma", "float32")):
        with pytest.raises(ValueError):
            tfe.pack_params(model, dtype, kernel=kernel)
    wide = SPNeRF(ModelConfig(fc_units=768, **FLAGSHIP))
    with pytest.raises(ValueError):
        tfe.pack_params(wide, "bfloat16", kernel="wgmma")


def test_general_kernel_refuses_cpu_tensors_and_other_packs():
    """Each route's wrapper takes CUDA tensors and weights packed for its
    route only."""
    p = general_pack(64, "float32", kernel="general")
    x, sun = torch.zeros(4, 63), torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfe.fused_field_general(p, x, sun)
    with pytest.raises(ValueError, match="packed for the general route"):
        tfe.fused_field_kernel(p, x, sun)
    wg = general_pack(64, "bfloat16")
    assert wg.route == "wgmma"
    with pytest.raises(ValueError, match="packed for the wgmma route"):
        tfe.fused_field_general(wg, x, sun)
