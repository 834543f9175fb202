"""The fused field's wide route (`csrc/field_eval_wide.cu`, "wgmma_wide") on
the CPU: its routing, its packed layout read back through the swizzle and
the K order for both CTAs of the cluster, its shared-memory and ring
reckoning at every width, the two-CTA schedule emulated with torch ops,
the plain version against the JAX package's Pallas kernel in interpret mode
at 768, and the wrapper's refusals.

Tolerances. `emulate_wide` against the plain version: with exact float32
products ("float32") 1e-6, as the general route's schedule (the same
products summed slab by slab, each CTA's half, in another order); as three
TF32 products ("tf32x3", the kernel's float32 policy) 1e-5, the bar of
tests/test_torch_field_eval_f32.py (lo x lo dropped); bf16 2e-2, as
`test_program_matches_plain` (a sum-order difference can move an activation
across a bf16 rounding boundary). The plain version and the emulation
against the Pallas kernel: float32 1e-5, bf16 2e-2, the bars of
tests/test_torch_field_eval.py.

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
from test_torch_field_eval_f32 import tf32_bits

FLAGSHIP = dict(mapping=True, sem=True, num_sem_classes=3)
ACTS = [lambda v: fast_sin(30.0 * v), fast_sin, torch.relu, lambda v: v,
        softplus, lambda v: torch.sigmoid(v) * 1.002 - 0.001, torch.sigmoid]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tier-1 command runs six test processes on
    the machine's cores, and more threads each only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def wide_pack(width, dtype, seed=0, cluster=None, **kw):
    cfg = ModelConfig(fc_units=width, **{**FLAGSHIP, **kw})
    model = SPNeRF(cfg, generator=torch.Generator().manual_seed(seed))
    return tfe.pack_params(model, dtype, kernel="wgmma_wide",
                           cluster=cluster)


def _name_at(p, w_off):
    return next(nm for nm, lp in p.layers.items() if lp.w_off == w_off)


def read_wide(p, name):
    """A wide layer's weights as stored, the shares of the cluster's
    `p.cluster` CTAs stitched back into (npad, k1 + k2) in the logical K
    order of the stages, unswizzled: (hi, lo) in float32, (w, None) in
    bf16."""
    lp = p.layers[name]
    ktot, h = lp.k1 + lp.k2, lp.npad // p.cluster
    ks = tfe.wide_ks(p.compute_dtype)
    ns = ktot // ks
    bf16 = p.compute_dtype == torch.bfloat16
    words = ks // 2 if bf16 else 2 * ks  # float32 words of a stage row
    start = lp.w_off // 4
    parts = []
    for r in range(p.cluster):
        flat = p.w_all[start + r * ns * h * words:
                       start + (r + 1) * ns * h * words]
        if bf16:
            flat = flat.view(torch.bfloat16)
        blk = flat.view(ns, h, 8, -1)
        n = torch.arange(h)[:, None]
        c = torch.arange(8)[None, :]
        blk = blk[:, n, c ^ (n % 8), :].reshape(ns, h, -1)
        parts.append(blk.permute(1, 0, 2))  # (h, ns, row)
    rows = torch.cat(parts)  # (npad, ns, row)
    if bf16:
        return rows.reshape(lp.npad, ktot).float(), None
    return (rows[:, :, :ks].reshape(lp.npad, ktot),
            rows[:, :, ks:].reshape(lp.npad, ktot))


def emulate_wide(p, prog, x_in, sun, t_in, policy):
    """The wgmma_wide kernel's schedule with torch ops over its program, on
    weights read back from `w_all` at the offsets the kernel computes, for
    the pack's cluster of C = `p.cluster` CTAs: the activation buffer as C
    shares, CTA r's holding columns [r h, (r + 1) h) of the layer that
    wrote it; each CTA's output columns of a layer
    summed k step by k step (8 deep in float32, 16 in bf16) in the stages'
    K order, each step's exact products added to the float32 accumulator
    with one rounding, A read from the half that owns the step's columns;
    "tf32x3" splits both operands into TF32 hi and lo and sums lo_a hi_b,
    hi_a lo_b, hi_a hi_b; "bfloat16" rounds the activations to bf16 (the
    weights are packed so); "float32" takes the exact products of the
    float32 activations with the stored hi + lo.
    A head output: each CTA's K share from the layer before (rounded to
    bf16 in bf16), its warpgroups' partial sums (64-column chunks, chunk j
    to warpgroup j % 3) added rank 0's, then rank 1's, ..., then the bias;
    its columns (npad of them, any number) in one go, as the kernel's
    passes of TAIL_N columns sum each column the same way."""
    bf16 = policy == "bfloat16"
    step = 16 if bf16 else 8
    order_of = tfe.bf16_k_order if bf16 else tfe.f32_k_order
    n = x_in.shape[0]
    cl = p.cluster
    share = tfe.wide_share(p.cfg.fc_units, cl)
    shares = [torch.zeros(n, share) for _ in range(cl)]
    inputs = {2: x_in, 3: sun, 4: t_in}
    rnd = (lambda v: v.bfloat16().float()) if bf16 else (lambda v: v)
    res, prev = {}, None
    for w_off, b_off, k1, k2, npad, nreal, a1, a2, dst, epi, out in prog:
        bias = p.b_all[b_off:b_off + npad]
        if out >= 0:
            wt = p.w_all[w_off // 4:w_off // 4 + k1 * npad].view(k1, npad)
            h = k1 // cl
            s = None
            for r in range(cl):
                for g in range(3):
                    part = torch.zeros(n, npad)
                    for j in range(g * 64, h, 3 * 64):
                        cols = slice(r * h + j, r * h + min(j + 64, h))
                        part += (rnd(prev[:, cols]).double()
                                 @ wt[cols].double()).float()
                    s = part if s is None else s + part
            res[tfe.OUTPUTS[out]] = ACTS[epi](s + bias)[:, :nreal]
            continue
        segs = []
        for src, k in ((a1, k1), (a2, k2)):
            if k == 0:
                continue
            a = torch.zeros(n, k)
            if src == 0:
                hs = k // cl  # the writing layer's columns a CTA holds
                for r in range(cl):
                    a[:, r * hs:(r + 1) * hs] = shares[r][:, :hs]
            else:
                v = inputs[src]
                a[:, :v.shape[1]] = v
            segs.append(a)
        a = torch.cat(segs, dim=1)[:, torch.from_numpy(order_of(k1 + k2))]
        w_hi, w_lo = read_wide(p, _name_at(p, w_off))
        if policy == "tf32x3":
            a_hi = tf32_bits(a)
            a_lo = tf32_bits(a - a_hi)
            terms = [(a_lo, w_hi), (a_hi, w_lo), (a_hi, w_hi)]
        elif bf16:
            terms = [(rnd(a), w_hi)]
        else:
            terms = [(a, w_hi if w_lo is None else w_hi + w_lo)]
        h = npad // cl
        steps = (k1 + k2) // step
        y = torch.zeros(n, npad)
        for r in range(cl):
            cols = slice(r * h, (r + 1) * h)
            # every k step's exact products at once, (steps, n, h) ...
            prods = sum(torch.einsum(
                "nsk,hsk->snh", x.double().view(n, steps, step),
                w[cols].double().view(h, steps, step)) for x, w in terms)
            # ... added to the float32 accumulator step by step
            acc = torch.zeros(n, h)
            for p_s in prods:
                acc = (acc.double() + p_s).float()
            y[:, cols] = acc
        prev = ACTS[epi](y + bias)
        if dst == 0:
            for r in range(cl):
                shares[r][:, :h] = prev[:, r * h:(r + 1) * h]
    res["sigma"] = res["sigma"][:, 0]
    return res


def _inputs(rng, n, p, field):
    xyz, sun, sems, t_emb = make_inputs(rng, n, p.cfg)
    as_t = lambda a: None if a is None else torch.from_numpy(a)
    return field.inputs(as_t(xyz), as_t(sun), as_t(t_emb), as_t(sems))


@pytest.mark.parametrize("policy,atol", [("float32", 1e-6),
                                         ("tf32x3", 1e-5),
                                         ("bfloat16", 2e-2)])
@pytest.mark.parametrize("width,kw", [
    (48, dict(beta=True)), (80, dict(beta=True)),
    (96, dict(beta=True, t_embedding_dims=32)), (160, {})])
@pytest.mark.parametrize("heads", [ALL, ("sun",), ("rgb", "sky"),
                                   ("beta", "sem"), ()])
def test_schedule_matches_plain(policy, atol, width, kw, heads, rng):
    """The kernel's two-CTA schedule (`emulate_wide` on the packed layout
    and the program) computes the plain version's outputs for the head
    subset, in both policies, at widths whose halves are one 32-wide chunk
    (48: 64 columns), a 64-wide chunk, and at 160 (192 columns: 96 a CTA,
    a 64-wide and a 32-wide chunk), with transient codes of 4 and 32;
    130 points (the kernel's tiles do not change the arithmetic)."""
    dtype = "bfloat16" if policy == "bfloat16" else "float32"
    p = wide_pack(width, dtype, **kw)
    assert p.route == "wgmma_wide" and p.compute_dtype == tfe.as_dtype(dtype)
    field = tfe.FusedField(p, dtype)
    x_in, sun, t_in = _inputs(rng, 130, p, field)
    prog = tfe.program(p, heads)
    assert len(prog) <= tfe.MAX_OPS
    has_t = p.cfg.beta and "beta" in heads
    out = emulate_wide(p, prog, x_in, sun, t_in if has_t else None, policy)
    ref = tfe.fused_field_plain(p, x_in, sun, t_in, heads, dtype)
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_allclose(out[k].numpy(), ref[k].numpy(), atol=atol,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
def test_plain_and_schedule_match_pallas_at_768(dtype, atol, rng):
    """At fc_units 768 the field (semantic and beta heads) routes to
    wgmma_wide in both dtypes; the plain version (which the kernel is held
    against on the card) and the emulated schedule agree with the Pallas
    kernel in interpret mode on the same weights (through `convert.py`) and
    200 points of numpy inputs; the CPU launches nothing."""
    params, jcfg, model = make_pair(width=768, sem=True, beta=True,
                                    num_sem_classes=3)
    assert tfe.route(model.cfg, dtype) == "wgmma_wide"
    inputs = make_inputs(rng, 200, model.cfg)
    ref = jax_fused(params, jcfg, inputs, dtype, ALL)
    p = tfe.pack_params(model, dtype)
    assert p.route == "wgmma_wide"
    field = tfe.FusedField(p, dtype)
    xyz, sun, sems, t_emb = inputs
    as_t = lambda a: None if a is None else torch.from_numpy(a)
    before = dict(tfe.FusedField.route_launches)
    out = field(as_t(xyz), as_t(sun), as_t(t_emb), as_t(sems))
    assert tfe.FusedField.route_launches == before
    assert_match({k: v.numpy() for k, v in out.items()}, ref, atol)
    x_in, sun_t, t_in = field.inputs(as_t(xyz), as_t(sun), as_t(t_emb),
                                     as_t(sems))
    emu = emulate_wide(p, tfe.program(p, ALL), x_in, sun_t, t_in,
                       "tf32x3" if dtype == "float32" else dtype)
    assert_match({k: v.numpy() for k, v in emu.items()}, ref, atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width,kw", [(80, dict(beta=True)),
                                      (160, dict(beta=True,
                                                 t_embedding_dims=20)),
                                      (768, {})])
def test_pack_wide_layout(dtype, width, kw):
    """Read back through the swizzle and the K order, both CTAs' halves of
    every wide layer give the module's weight (rounded to bf16, or split
    into tf32_rna hi and lo) exactly, each segment where the program reads
    it (the buffer's padded to 64, an input's to the policy's slab), zero
    elsewhere; a head output's weight is its (K, 16) row-major float32
    matrix (bf16-rounded in bf16); the layers tile `w_all` exactly, every
    offset a multiple of 16 bytes; the biases are the module's."""
    p = wide_pack(width, dtype, **kw)
    assert p.route == "wgmma_wide" and p.k0_pad == 64
    check_wide_layout(p)


def check_wide_layout(p):
    """`test_pack_wide_layout`'s checks on the pack `p`, for its cluster's
    `p.cluster` CTAs: the shares read back give the module's weights, the
    layers tile `w_all`, the biases are the module's."""
    cd = p.compute_dtype
    bf16 = cd == torch.bfloat16
    ks = tfe.wide_ks(cd)
    specs = {s[0]: s for s in layer_specs(p.cfg)}
    end = 0
    for name, w, b in zip(p.names, p.ws, p.bs):
        lp = p.layers[name]
        segs = specs[name][1]
        assert lp.w_off == 4 * end and lp.w_off % 16 == 0, name
        pads = tfe._wide_pads(name, segs, ks, p.cluster)
        assert [lp.k1, lp.k2][:len(segs)] == pads
        if name in tfe.TAILS:
            assert lp.npad == tfe._ceil(w.shape[1], tfe.TAIL_N)
            got = p.w_all[end:end + lp.k1 * lp.npad].view(lp.k1, lp.npad)
            want = torch.zeros_like(got)
            want[:w.shape[0], :w.shape[1]] = w.to(cd).float()
            assert torch.equal(got, want), name
            end += got.numel()
        else:
            assert lp.npad == tfe.wide_npad(w.shape[1], p.cluster)
            assert all(k % ks == 0 for k in pads)
            wt = torch.zeros(lp.npad, lp.k1 + lp.k2)
            src = dst = 0
            for sw, pad in zip(segs, pads):
                wt[:w.shape[1], dst:dst + sw] = w[src:src + sw].t()
                src, dst = src + sw, dst + pad
            order = torch.from_numpy((tfe.bf16_k_order if bf16 else
                                      tfe.f32_k_order)(lp.k1 + lp.k2))
            hi, lo = read_wide(p, name)
            back_hi = torch.empty_like(hi)
            back_hi[:, order] = hi
            if bf16:
                assert lo is None
                assert torch.equal(back_hi, wt.bfloat16().float()), name
            else:
                back_lo = torch.empty_like(lo)
                back_lo[:, order] = lo
                assert torch.equal(back_hi, tf32_bits(wt)), name
                assert torch.equal(back_lo, tf32_bits(wt - back_hi)), name
            end += lp.npad * (lp.k1 + lp.k2) * (1 if bf16 else 2) // (
                2 if bf16 else 1)
        bias = p.b_all[lp.b_off:lp.b_off + lp.npad]
        assert torch.equal(bias[:lp.nreal], b) and not bias[lp.nreal:].any()
    assert end == p.w_all.numel()


def test_bf16_k_order():
    """Within every 16-group, logical rows 2 t, 2 t + 1, 2 t + 8, 2 t + 9 are
    physical 4 t .. 4 t + 3 (a permutation of each group)."""
    order = tfe.bf16_k_order(32)
    for t in range(4):
        assert [order[i] for i in (2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)] \
            == [4 * t, 4 * t + 1, 4 * t + 2, 4 * t + 3]
    assert sorted(order) == list(range(32))
    assert list(order[16:]) == [16 + i for i in order[:16]]


def test_smem_and_ring_reckoning():
    """At every width from 2 to W_MAX (4,096), on its clusters of 2, 4 or
    8 CTAs, each CTA owns whole 32-column chunks, at most 512 columns, and
    the ring is at least a CTA's chunks of a layer deep (and 2), fits
    232,448 bytes beside the buffer share, and is as deep as fits up to
    WIDE_MAX_STAGES; nothing outside 2 .. W_MAX; the values at 768, 1024,
    2048 and 4096 are pinned."""
    assert tfe.W_MAX == 4096
    for width in range(2, tfe.W_MAX + 1):
        c = tfe.wide_cluster(width)
        assert c == (2 if width <= 1024 else 4 if width <= 2048 else 8)
        share = tfe.wide_share(width)
        assert share % 32 == 0 and share <= tfe.WIDE_SHARE_MAX, width
        stages = tfe.wide_stages(width)
        assert stages >= max(2, -(-share // 64)), width
        assert tfe.wide_smem_bytes(width, stages) <= tfe.SMEM_LIMIT
        if stages < tfe.WIDE_MAX_STAGES:
            assert tfe.wide_smem_bytes(width, stages + 1) > tfe.SMEM_LIMIT
    for width in (0, 1, tfe.W_MAX + 1, 8192):
        assert tfe.wide_stages(width) == 0 and tfe.wide_cluster(width) == 0
    assert tfe.wide_stages(1024) == 10
    assert tfe.wide_smem_bytes(1024, 10) == 226_480
    assert tfe.wide_stages(768) == 12
    assert tfe.wide_smem_bytes(768, 12) == 210_128
    assert tfe.wide_stages(2048) == tfe.wide_stages(4096) == 10
    assert tfe.wide_smem_bytes(4096, 10) == 226_480


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("width,beta,t_dims,classes", [
    (512, False, 16, 3), (512, True, 16, 3), (544, False, 16, 3),
    (544, True, 16, 3), (704, False, 16, 3), (704, True, 16, 3),
    (736, False, 16, 3), (736, True, 16, 3), (768, False, 16, 3),
    (768, True, 16, 3), (1024, False, 16, 3), (1024, True, 16, 3),
    (80, True, 16, 3), (512, True, 32, 3), (768, False, 16, 17),
    (1056, False, 16, 3), (1025, True, 16, 3), (2048, False, 16, 3),
    (4096, True, 16, 3), (4097, False, 16, 3), (512, False, 16, 17),
    (512, True, 16, 64), (1024, False, 16, 150), (4096, False, 16, 150)])
def test_route_table(device, dtype, width, beta, t_dims, classes):
    """bf16 within the wgmma envelope takes "wgmma" (any number of classes)
    and float32 up to 512 with at most 16 classes "wgmma_f32" (the flagship
    among them, unchanged); what neither takes goes to "wgmma_wide" up to
    W_MAX (4,096) with any number of semantic classes (bf16 wider than 704
    or 640 with beta, 80, a transient code of 32; float32 from 544, and at
    512 with 17 or 64 classes; 17 classes took "general" before), wider
    fields to no kernel; "general" for none; only CUDA renders take a
    kernel."""
    cfg = ModelConfig(fc_units=width, beta=beta, t_embedding_dims=t_dims,
                      mapping=True, sem=True, num_sem_classes=classes)
    bf16 = dtype == "bfloat16"
    envelope = (width % 32 == 0 and width <= (640 if beta else 704)
                and not (beta and t_dims > 16))
    if width > tfe.W_MAX:
        want = None
    elif bf16 and envelope:
        want = "wgmma"
    elif not bf16 and width <= tfe.F32_W_MAX and classes <= 16:
        want = "wgmma_f32"
    else:
        want = "wgmma_wide"
    if (width, beta, classes) == (512, False, 3) and t_dims == 16:
        assert want == ("wgmma" if bf16 else "wgmma_f32")
    assert tfe.supports_config(cfg) is (envelope and width <= tfe.W_MAX)
    assert tfe.supports_wide(cfg) is (width <= tfe.W_MAX)
    assert tfe.route(cfg, dtype) == want
    assert tfe.route(cfg, tfe.as_dtype(dtype)) == want
    assert tfe.uses_fused_kernel(device, cfg, dtype) is (
        device == "cuda" and want is not None)


def test_pack_for_the_wide_kernel():
    """`kernel="wgmma_wide"` packs any width of the family up to W_MAX in
    either dtype (the flagship too, to time it beside the one-CTA kernels),
    on clusters of 2 below 1,025 wide or of a forced 4 or 8; 17 semantic
    classes pack (the logits' weight padded to 32 columns, two passes of
    TAIL_N), and float32 routes there; another cluster size, or a field
    outside the family, raises; the route's own packing goes to it where
    `route` says so."""
    model = SPNeRF(ModelConfig(fc_units=64, **FLAGSHIP))
    for dtype in ("bfloat16", "float32"):
        p = tfe.pack_params(model, dtype, kernel="wgmma_wide")
        assert p.route == "wgmma_wide" and p.cluster == 2
        assert p.compute_dtype == tfe.as_dtype(dtype)
        for c in (4, 8):
            assert tfe.pack_params(model, dtype, kernel="wgmma_wide",
                                   cluster=c).cluster == c
        for c in (1, 3, 16):
            with pytest.raises(ValueError):
                tfe.pack_params(model, dtype, kernel="wgmma_wide", cluster=c)
    assert tfe.pack_params(model, "float32").route == "wgmma_f32"
    assert tfe.pack_params(model, "float32").cluster == 0
    with pytest.raises(ValueError):
        tfe.pack_params(model, "float32", cluster=4)
    many = SPNeRF(ModelConfig(fc_units=64, **{**FLAGSHIP,
                                              "num_sem_classes": 17}))
    p = tfe.pack_params(many, "bfloat16", kernel="wgmma_wide")
    assert p.layers["sem1"].npad == 32 and p.layers["sem1"].nreal == 17
    assert tfe.pack_params(many, "float32").route == "wgmma_wide"
    wide = SPNeRF(ModelConfig(fc_units=544, **FLAGSHIP))
    assert tfe.pack_params(wide, "float32").route == "wgmma_wide"
    assert tfe.pack_params(wide, "float32", kernel="general").route == (
        "general")
    with pytest.raises(ValueError):
        tfe.pack_params(SPNeRF(ModelConfig(**{**FLAGSHIP, "siren": False})),
                        "float32", kernel="wgmma_wide")


def test_wide_kernel_refuses_cpu_tensors_and_other_packs(rng):
    """The wgmma_wide wrapper takes CUDA tensors and weights packed for its
    route only, the other routes refuse its pack; on the CPU a FusedField runs the plain version
    and launches nothing."""
    p = wide_pack(80, "bfloat16")
    x, sun = torch.zeros(4, 63), torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfe.fused_field_wide(p, x, sun)
    for launch in (tfe.fused_field_kernel, tfe.fused_field_general,
                   tfe.fused_field_f32):
        with pytest.raises(ValueError, match="packed for the wgmma_wide"):
            launch(p, x, sun)
    for other in (tfe.pack_params(SPNeRF(p.cfg), "float32", kernel="general"),
                  tfe.pack_params(SPNeRF(p.cfg), "float32")):
        with pytest.raises(ValueError, match=f"packed for the {other.route}"):
            tfe.fused_field_wide(other, x, sun)
    assert "wgmma_wide" in tfe.ROUTES
    field = tfe.FusedField(p, "bfloat16")
    before = dict(tfe.FusedField.route_launches)
    xyz = torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32))
    sems = torch.zeros(5, dtype=torch.long)
    s = torch.ones(5, 3) / 3 ** 0.5
    out = field(xyz, s, None, sems)
    x_in, sun_t, _ = field.inputs(xyz, s, None, sems)
    ref = tfe.fused_field_plain(p, x_in, sun_t, None, ALL, "bfloat16")
    for k in ref:
        assert torch.equal(out[k], ref[k])
    assert tfe.FusedField.route_launches == before
