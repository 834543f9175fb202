"""The fused field's float32 route (`csrc/field_eval_f32.cu`, "wgmma_f32")
on the CPU: the 3xTF32 split of the weights, the packed layout read back
through the swizzle, the routing and shared-memory reckoning at every width,
the kernel's arithmetic emulated with torch ops over the layer program, and
the wrapper's refusals.

Tolerances. `emulate_f32` (TF32 splits by integer ops on the float32 bits,
the three products of every k8 step, each step's eight exact products
added to the float32 accumulator with one rounding, the head outputs as
float32 sums) against the plain float32 version and against the Pallas
kernel in interpret mode: 1e-5, the bar of float32 in
tests/test_torch_field_eval.py. The products drop lo x lo (2^-22 of each
product) and round each step's sum once; through eight layers with the
sin(30 x) first layer the emulation stayed within 8.7e-7 of the plain
version on every head at widths 32 to 160 (130 points of seed 0).

The CUDA kernel itself is tested on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from spnerf_torch.config import ModelConfig
from spnerf_torch.models import SPNeRF
from spnerf_torch.models.spnerf import fast_sin, layer_specs, softplus
from spnerf_torch.ops import field_eval as tfe
from test_torch_field_eval import (ALL, assert_match, jax_fused, make_inputs,
                                   make_pair)

FLAGSHIP = dict(mapping=True, sem=True, num_sem_classes=3)
ACTS = [lambda v: fast_sin(30.0 * v), fast_sin, torch.relu, lambda v: v,
        softplus, lambda v: torch.sigmoid(v) * 1.002 - 0.001, torch.sigmoid]


def f32_pack(width, seed=0, **kw):
    cfg = ModelConfig(fc_units=width, **{**FLAGSHIP, **kw})
    model = SPNeRF(cfg, generator=torch.Generator().manual_seed(seed))
    return tfe.pack_params(model, "float32")


def tf32_bits(x):
    """TF32 round to nearest, ties away from zero, by integer ops on the
    float32 bits (int64, so no sign trickery): the kernel's cvt.rna."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64)
    mag = bits & 0x7FFFFFFF
    out = (bits & ~0x7FFFFFFF) | ((mag + 0x1000) & 0x7FFFE000)
    out = torch.where(out >= 2 ** 31, out - 2 ** 32, out)
    return out.to(torch.int32).view(torch.float32)


def read_stages(p, name):
    """A wide layer's (hi, lo) as stored: (npad, k1 + k2) each, K in the
    logical order of the stages (`f32_k_order`), unswizzled."""
    lp = p.layers[name]
    ktot = lp.k1 + lp.k2
    ns = ktot // tfe.F32_KS
    start = lp.w_off // 4
    flat = p.w_all[start:start + ns * lp.npad * 2 * tfe.F32_KS]
    blk = flat.view(ns, lp.npad, 8, 4)
    n = torch.arange(lp.npad)[:, None]
    c = torch.arange(8)[None, :]
    blk = blk[:, n, c ^ (n % 8), :].reshape(ns, lp.npad, 2 * tfe.F32_KS)
    hi = blk[:, :, :tfe.F32_KS].permute(1, 0, 2).reshape(lp.npad, ktot)
    lo = blk[:, :, tfe.F32_KS:].permute(1, 0, 2).reshape(lp.npad, ktot)
    return hi, lo


def emulate_f32(p, prog, x_in, sun, t_in):
    """The wgmma_f32 kernel's arithmetic with torch ops over its program,
    on weights read back from `w_all`: one float32 activation buffer; each
    wide layer's A operand (the buffer or an input, columns in the stages'
    K order) split into hi and lo TF32 parts, every 16-deep slab's two k8
    steps summed as lo_a hi_b, hi_a lo_b, hi_a hi_b (each step's eight
    products exact, added to the accumulator with one float32 rounding),
    bias and activation in float32; a head output (out >= 0) from the
    layer before it in float32, its warpgroups' partial sums (64 columns
    each, chunk j to warpgroup j % F32_WGS) added in order, then the
    bias."""
    n = x_in.shape[0]
    wa = -(-p.cfg.fc_units // 32) * 32
    buf = torch.zeros(n, wa)
    inputs = {2: x_in, 3: sun, 4: t_in}
    res, prev = {}, None
    for w_off, b_off, k1, k2, npad, nreal, a1, a2, dst, epi, out in prog:
        bias = p.b_all[b_off:b_off + npad]
        if out >= 0:
            wt = p.w_all[w_off // 4:w_off // 4 + k1 * tfe.TAIL_N].view(
                k1, tfe.TAIL_N)
            part = torch.zeros(tfe.F32_WGS, n, tfe.TAIL_N)
            for j in range(0, k1, tfe.F32_NCH):
                g = (j // tfe.F32_NCH) % tfe.F32_WGS
                seg = prev[:, j:j + tfe.F32_NCH].double()
                part[g] += (seg @ wt[j:j + tfe.F32_NCH].double()).float()
            s = part[0]
            for g in range(1, tfe.F32_WGS):
                s = s + part[g]
            res[tfe.OUTPUTS[out]] = ACTS[epi](s + bias)[:, :nreal]
            continue
        segs = []
        for src, k in ((a1, k1), (a2, k2)):
            if k == 0:
                continue
            a = torch.zeros(n, k)
            if src == 0:
                a[:] = buf[:, :k]
            else:
                v = inputs[src]
                a[:, :v.shape[1]] = v
            segs.append(a)
        a = torch.cat(segs, dim=1)[:, torch.from_numpy(
            tfe.f32_k_order(k1 + k2))]
        a_hi = tf32_bits(a)
        a_lo = tf32_bits(a - a_hi)
        b_hi, b_lo = read_stages(p, _name_at(p, w_off))
        acc = torch.zeros(n, npad)
        for k in range(0, k1 + k2, 8):
            ks = slice(k, k + 8)
            for x, w in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
                acc = (acc.double() + x[:, ks].double()
                       @ w[:, ks].double().t()).float()
        prev = ACTS[epi](acc + bias)
        if dst == 0:
            buf[:, :npad] = prev
    res["sigma"] = res["sigma"][:, 0]
    return res


def _name_at(p, w_off):
    return next(nm for nm, lp in p.layers.items() if lp.w_off == w_off)


def _inputs(rng, n, p, field):
    xyz, sun, sems, t_emb = make_inputs(rng, n, p.cfg)
    as_t = lambda a: None if a is None else torch.from_numpy(a)
    return field.inputs(as_t(xyz), as_t(sun), as_t(t_emb), as_t(sems))


@pytest.mark.parametrize("width,kw", [
    (32, dict(beta=True)), (64, {}), (80, dict(beta=True)),
    (96, dict(beta=True, t_embedding_dims=20)), (160, {})])
@pytest.mark.parametrize("heads", [ALL, ("sun",), ("rgb", "sky"),
                                   ("beta", "sem"), ()])
def test_emulation_matches_plain(width, kw, heads, rng):
    """The kernel's arithmetic (`emulate_f32` on the packed layout and the
    program) computes the plain float32 version's outputs for the head
    subset within 1e-5, at widths with one, two and three chunks a layer, a
    32-wide last chunk (80: 96 columns), a beta head with transient codes of
    4 and 20."""
    p = f32_pack(width, **kw)
    assert p.route == "wgmma_f32"
    field = tfe.FusedField(p, "float32")
    x_in, sun, t_in = _inputs(rng, 130, p, field)
    prog = tfe.program(p, heads)
    assert len(prog) <= tfe.MAX_OPS
    has_t = p.cfg.beta and "beta" in heads
    out = emulate_f32(p, prog, x_in, sun, t_in if has_t else None)
    ref = tfe.fused_field_plain(p, x_in, sun, t_in, heads, "float32")
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_allclose(out[k].numpy(), ref[k].numpy(), atol=1e-5,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("width,kw", [
    (64, dict(sem=True, num_sem_classes=3)),
    (64, dict(sem=True, beta=True, num_sem_classes=3)),
    (96, dict(beta=True, t_embedding_dims=20))])
def test_emulation_matches_pallas(width, kw, rng):
    """The emulated kernel against the JAX package's Pallas kernel at
    compute_dtype float32 in interpret mode, every head, 1e-5; the field
    routes to wgmma_f32."""
    params, jcfg, model = make_pair(width=width, **kw)
    assert tfe.route(model.cfg, "float32") == "wgmma_f32"
    inputs = make_inputs(rng, 200, model.cfg)
    p = tfe.pack_params(model, "float32")
    field = tfe.FusedField(p, "float32")
    as_t = lambda a: None if a is None else torch.from_numpy(a)
    xyz, sun, sems, t_emb = inputs
    x_in, sun_t, t_in = field.inputs(as_t(xyz), as_t(sun), as_t(t_emb),
                                     as_t(sems))
    out = emulate_f32(p, tfe.program(p, ALL), x_in, sun_t, t_in)
    assert_match({k: v.numpy() for k, v in out.items()},
                  jax_fused(params, jcfg, inputs, "float32", ALL), 1e-5)


@pytest.mark.parametrize("width", [32, 80, 512])
def test_split_reconstructs_the_weights(width):
    """hi + lo gives back every weight within 2^-21 of its magnitude, and
    both parts are TF32 values (low 13 bits zero); the host's split is the
    integer one of the emulation."""
    p = f32_pack(width, beta=True)
    for name, w in zip(p.names, p.ws):
        if name in tfe.TAILS:
            continue
        hi, lo = read_stages(p, name)
        for part in (hi, lo):
            assert not (part.view(torch.int32) & 0x1FFF).any(), name
        wl = tfe.tf32_rna(w)
        assert torch.equal(wl, tf32_bits(w)), name
        assert torch.equal(tfe.tf32_rna(w - wl), tf32_bits(w - wl)), name
    w = torch.from_numpy(np.random.default_rng(1).normal(
        size=100_000).astype(np.float32)) * 10.0 ** torch.arange(-6, 4).repeat(
            10_000).float()
    hi = tfe.tf32_rna(w)
    lo = tfe.tf32_rna(w - hi)
    assert ((hi + lo - w).abs() <= w.abs() * 2.0 ** -21).all()
    assert ((hi - w).abs() <= w.abs() * 2.0 ** -11).all()
    # ties round away from zero
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert torch.equal(tfe.tf32_rna(tie), torch.tensor([1.0 + 2.0 ** -10,
                                                        -(1.0 + 2.0 ** -10)]))


@pytest.mark.parametrize("width,kw", [(512, {}), (80, dict(beta=True)),
                                      (96, dict(beta=True,
                                                t_embedding_dims=20))])
def test_pack_f32_layout(width, kw):
    """Read back through the swizzle and the K order, every wide layer's
    stages give tf32_rna(Wᵀ) and tf32_rna(Wᵀ - hi) exactly, each segment
    where the program reads it (the buffer's padded to 32, inputs to 16),
    zero elsewhere; a head output's weight is its (K, 16) row-major float32
    matrix; the layers tile `w_all` exactly, each wide one's stages at
    1,024-byte multiples, and the biases are the module's."""
    p = f32_pack(width, **kw)
    specs = {s[0]: s for s in layer_specs(p.cfg)}
    assert p.route == "wgmma_f32" and p.compute_dtype == torch.float32
    assert p.k0_pad == 64
    end = 0
    for name, w, b in zip(p.names, p.ws, p.bs):
        lp = p.layers[name]
        segs = specs[name][1]
        assert lp.w_off == 4 * end, name
        pads = tfe._f32_pads(name, segs)
        assert [lp.k1, lp.k2][:len(segs)] == pads
        if name in tfe.TAILS:
            assert lp.npad == tfe.TAIL_N
            got = p.w_all[end:end + lp.k1 * lp.npad].view(lp.k1, lp.npad)
            want = torch.zeros_like(got)
            want[:w.shape[0], :w.shape[1]] = w
            assert torch.equal(got, want), name
        else:
            assert lp.npad == -(-w.shape[1] // 32) * 32
            assert lp.w_off % 1024 == 0
            hi, lo = read_stages(p, name)
            wt = torch.zeros(lp.npad, lp.k1 + lp.k2)
            src = dst = 0
            for sw, pad in zip(segs, pads):
                wt[:w.shape[1], dst:dst + sw] = w[src:src + sw].t()
                src, dst = src + sw, dst + pad
            back_hi = torch.empty_like(hi)
            back_lo = torch.empty_like(lo)
            order = torch.from_numpy(tfe.f32_k_order(lp.k1 + lp.k2))
            back_hi[:, order] = hi
            back_lo[:, order] = lo
            assert torch.equal(back_hi, tf32_bits(wt)), name
            assert torch.equal(back_lo, tf32_bits(wt - back_hi)), name
        end += lp.k1 * lp.npad if name in tfe.TAILS else (
            2 * lp.npad * (lp.k1 + lp.k2))
        bias = p.b_all[lp.b_off:lp.b_off + lp.npad]
        assert torch.equal(bias[:lp.nreal], b) and not bias[lp.nreal:].any()
    assert end == p.w_all.numel()


def test_k_order():
    """Within every 8-group, logical rows t and t + 4 are physical 2 t and
    2 t + 1 (a permutation of each group)."""
    order = tfe.f32_k_order(32)
    assert list(order[:8]) == [0, 2, 4, 6, 1, 3, 5, 7]
    assert sorted(order) == list(range(32))
    assert list(order[8:16]) == [8 + i for i in order[:8]]


@pytest.mark.parametrize("beta", [False, True])
def test_route_and_reckoning_every_width(beta):
    """At every width from 1 to 1024: float32 takes "wgmma_f32" from 2 to
    512 (the flagship among them) and "wgmma_wide" above it, up to W_MAX;
    bf16 takes wgmma within its envelope and wgmma_wide outside it; the
    ring fits 232,448 bytes at least a slab's chunks deep; the flagship's
    reckoning is pinned; 17 semantic classes leave the float32 flagship
    to the wide kernel (which took the general kernel's place there);
    fc_units 1 (no module has one) takes no kernel."""
    for width in range(1, 1025):
        cfg = ModelConfig(fc_units=width, beta=beta, **FLAGSHIP)
        stages = tfe.f32_stages(width)
        if width <= tfe.F32_W_MAX:
            assert stages >= max(2, -(-width // tfe.F32_NCH)), width
            assert tfe.f32_smem_bytes(width, stages) <= tfe.SMEM_LIMIT
            if stages < tfe.F32_MAX_STAGES:
                assert tfe.f32_smem_bytes(width, stages + 1) > tfe.SMEM_LIMIT
        else:
            assert stages == 0
        takes = 2 <= width <= tfe.F32_W_MAX
        assert tfe.supports_f32(cfg) is takes, width
        assert tfe.route(cfg, "float32") == (
            "wgmma_f32" if takes else "wgmma_wide" if width >= 2
            else None), width
        bf16 = tfe.route(cfg, "bfloat16")
        assert bf16 == ("wgmma" if tfe.supports_config(cfg) else
                        "wgmma_wide" if width >= 2 else None)
    assert tfe.f32_stages(512) == 10
    assert tfe.f32_smem_bytes(512, 10) == 226_464
    assert tfe.f32_stages(256) == tfe.F32_MAX_STAGES
    cfg = ModelConfig(fc_units=512, **{**FLAGSHIP, "num_sem_classes": 17})
    assert not tfe.supports_f32(cfg)
    assert tfe.route(cfg, "float32") == "wgmma_wide"


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_flagship_routes(device):
    """The flagship renders float32 through wgmma_f32 on CUDA, bf16 through
    wgmma; `pack_params(..., kernel="general")` still packs float32 for the
    FFMA kernel (the parent's route, to time the two in one run); a
    float32 field of 544 packs for the wide kernel, or the general one on
    request."""
    mc = ModelConfig(fc_units=512, **FLAGSHIP)
    assert tfe.route(mc, "float32") == "wgmma_f32"
    assert tfe.route(mc, "bfloat16") == "wgmma"
    assert tfe.uses_fused_kernel(device, mc, "float32") is (device == "cuda")
    model = SPNeRF(ModelConfig(fc_units=64, **FLAGSHIP))
    assert tfe.pack_params(model, "float32").route == "wgmma_f32"
    assert tfe.pack_params(model, "float32", kernel="general").route == (
        "general")
    assert tfe.pack_params(model, "float32",
                           kernel="wgmma_f32").route == "wgmma_f32"
    for kernel, dtype in (("wgmma_f32", "bfloat16"), ("wgmma", "float32")):
        with pytest.raises(ValueError):
            tfe.pack_params(model, dtype, kernel=kernel)
    wide = SPNeRF(ModelConfig(fc_units=544, **FLAGSHIP))
    with pytest.raises(ValueError):
        tfe.pack_params(wide, "float32", kernel="wgmma_f32")
    assert tfe.pack_params(wide, "float32").route == "wgmma_wide"
    assert tfe.pack_params(wide, "float32", kernel="general").route == (
        "general")


def test_f32_kernel_refuses_cpu_tensors_and_other_packs(rng):
    """The wgmma_f32 wrapper takes CUDA tensors and weights packed for its
    route only, the others refuse its pack; on the CPU a FusedField runs
    the plain float32 version and launches nothing."""
    p = f32_pack(64)
    x, sun = torch.zeros(4, 63), torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfe.fused_field_f32(p, x, sun)
    for launch in (tfe.fused_field_kernel, tfe.fused_field_general):
        with pytest.raises(ValueError, match="packed for the wgmma_f32"):
            launch(p, x, sun)
    for other in (tfe.pack_params(SPNeRF(p.cfg), "float32", kernel="general"),
                  tfe.pack_params(SPNeRF(p.cfg), "bfloat16")):
        with pytest.raises(ValueError, match=f"packed for the {other.route}"):
            tfe.fused_field_f32(other, x, sun)
    field = tfe.FusedField(p, "float32")
    before = dict(tfe.FusedField.route_launches)
    xyz = torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32))
    sems = torch.zeros(5, dtype=torch.long)
    out = field(xyz, torch.ones(5, 3) / 3 ** 0.5, None, sems)
    ref = tfe.fused_field_plain(p, *field.inputs(
        xyz, torch.ones(5, 3) / 3 ** 0.5, None, sems)[:2], None, ALL,
        "float32")
    for k in ref:
        assert torch.equal(out[k], ref[k])
    assert tfe.FusedField.route_launches == before
    assert "wgmma_f32" in tfe.ROUTES


def test_program_keeps_one_buffer():
    """The wgmma_f32 program writes only buf0, keeps the hidden layer of
    every head output in registers (dst -1) and follows it with that head
    output (a1 -1, out >= 0); the solar head, which overwrites feats, runs
    after every other reader of feats."""
    p = f32_pack(64, beta=True)
    prog = tfe.program(p, ALL)
    names = [_name_at(p, row[0]) for row in prog]
    for row, name in zip(prog, names):
        w_off, b_off, k1, k2, npad, nreal, a1, a2, dst, epi, out = row
        assert dst in (0, -1) and a1 != tfe.SRC["buf1"]
        if name in tfe.TAILS:
            assert out >= 0 and a1 == -1 and dst == -1
        else:
            assert out == -1
    for i, name in enumerate(names):
        if name in tfe.TAILS:
            assert names[i - 1] not in tfe.TAILS
    assert names.index("sun0") > max(names.index(n)
                                      for n in ("rgb0", "beta0"))
    assert names.index("feats") > names.index("sem0")
