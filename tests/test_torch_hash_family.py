"""The benchmark's hash family over the port, on the CPU at a small size:
its render and train programs against its plain reference
(`benchmark/reference_hash.py`), three faults of that reference read above
the tolerances (so the table's scale makes the encoding matter), the
encoding's `hash.encode` span and `HashGridEncoding.points` counter, and
the direct levels' corner ids made without a copy from the host. On the
card (marked `cuda`): the render program at the cell's own size judged
correct by the cell's limits, and the float8 control judged not."""

import copy

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import calibrate, check, flops, harness, reference_hash, spec
from spnerf_torch import spans
from spnerf_torch.models import hashgrid
from spnerf_torch.models.hashgrid import HashGridEncoding, level_ids

SEED = 2 ** 33 + 24  # more than 32 signed bits hold
# Tolerances of the small runs below, in float32 unless stated. The port
# and the reference compute the same float32 operations; only the order of
# a few sums differs (the products' and the compositing's), which read
# 1e-6 or less at this size (render 1.1e-6 on sem_logits; train 2e-7 on
# grad and change, loss equal). In bfloat16 rendering both round the same
# float32 sums of the same rounded operands, and read 0 on the CPU. Each
# tolerance leaves about 10x room above those readings and stays under a
# tenth of what each fault below reads (render 1.3e-3 or more on some
# output, train 4e-4 on loss and 4e-2 on grad and change).
RENDER_TOL = 1e-5
TRAIN_TOL = {"loss": 1e-5, "grad": 1e-5, "change": 1e-5}
# The small field: 4 levels, the first indexed directly (17^3 <= 2^13),
# three hashed; 16 wide; 8 samples a pass; 64 rays.
SMALL = {"hash_levels": 4, "hash_log2T": 13, "hash_hidden": 16}


def small_cell(kind, dtype="float32"):
    """The hash cell of traffic `kind` at the small size, with limits at
    the tolerances above."""
    base = spec.load_cell("hash.render")
    cfg = copy.deepcopy(base.config)
    cfg["model"].update(SMALL)
    cfg["render"].update(n_samples=8, compute_dtype=dtype)
    mix = spec.read_json(spec.HERE / "traffic" / f"{kind}.json")
    if kind == "render":
        mix = dict(mix, view_w=8, view_h=8, check_rays=64)
        limits = dict.fromkeys(base.limits, RENDER_TOL)
    else:
        mix = dict(mix, batch_rays=64, scene_rays=1024)
        limits = TRAIN_TOL
    return spec.Cell(f"hash.{kind}", 1, cfg, mix, limits, [], [], base.family)


def prime_changed(cell, res, model, primes=reference_hash.PRIMES,
                  ids=reference_hash.corner_ids):
    """The first hashed level with its z prime off by 18."""
    hashed = [r for r in reference_hash.level_resolutions(
        model["hash_levels"]) if not reference_hash.direct(model, r)]
    if res == hashed[0]:
        primes = primes[:2] + (primes[2] + 18,)
    return ids(cell, res, model, primes)


def finest_dropped(model, table, xyz, encode=reference_hash.encode):
    feats = encode(model, table, xyz).clone()
    feats[:, -model["hash_features"]:] = 0.0
    return feats


def nearest(a, b, t):
    """The nearer corner's value in place of the lerp."""
    return torch.where(t < 0.5, a, b)


FAULTS = {"prime_changed": ("corner_ids", prime_changed),
          "finest_dropped": ("encode", finest_dropped),
          "nearest_corner": ("lerp", nearest)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_render_program_matches_the_reference(dtype):
    out = harness.run_cell(small_cell("render", dtype), SEED, 0.0, 0, "cpu")
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


def test_train_program_matches_the_reference():
    out = harness.run_cell(small_cell("train"), SEED, 0.0, 0, "cpu")
    assert out["correct"], out["checks"]
    assert len([k for k in out["readings"] if k.startswith("loss_step")]) == 3


@pytest.mark.parametrize("kind", ["render", "train"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_of_the_reference_reads_above_the_tolerances(kind, fault,
                                                           monkeypatch):
    name, wrong = FAULTS[fault]
    monkeypatch.setattr(reference_hash, name, wrong)
    cell = small_cell(kind)
    out = harness.run_cell(cell, SEED, 0.0, 0, "cpu")
    assert not out["correct"], out["checks"]
    # not by a hair: some number reads ten times its tolerance
    assert max(out["readings"][k] / lim for k, lim in cell.limits.items()
               if not isinstance(out["readings"][k], str)) > 10.0


def small_encoding():
    enc = HashGridEncoding(n_levels=4, n_features=4, log2_table_size=13,
                           generator=torch.Generator().manual_seed(3))
    xyz = torch.rand((300, 3), generator=torch.Generator().manual_seed(4))
    return enc, xyz * 2.0 - 1.0


def test_encode_span_is_kept_only_under_a_profiler():
    enc, xyz = small_encoding()
    spans.reset()
    try:
        enc(xyz)
        assert spans.totals() == {}
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            enc(xyz)
            enc(xyz[:10])
        kept = spans.totals()
        assert set(kept) == {"hash.encode"}
        assert kept["hash.encode"]["n"] == 2
        assert kept["hash.encode"]["parents"] == [None]
        assert kept["hash.encode"]["device_s"] is None  # no CUDA here
        names = [e.name() for e in prof.profiler.kineto_results.events()]
        assert names.count("hash.encode") == 2
    finally:
        spans.reset()


def test_points_counter_counts_every_point_encoded():
    enc, xyz = small_encoding()
    start = HashGridEncoding.points
    enc(xyz)
    enc(xyz[:7])
    assert HashGridEncoding.points - start == 307


def test_family_reads_the_counter_over_a_render():
    """A view of 64 rays: one chunk (padded), 8 + 8 view samples and 16
    solar samples a ray."""
    from benchmark import program
    from spnerf_torch.render import chunk_size

    cell = small_cell("render")
    family = cell.family
    weights = family.make_weights(cell.config["model"], SEED, "cpu")
    prog = family.RenderProgram(cell.config, weights, "cpu")
    rays = torch.zeros((64, 11))
    rays[:, 3], rays[:, 7], rays[:, 10] = 1.0, 1.5, 1.0
    counts = {}
    with family.count_points(counts):
        prog.view(rays, torch.zeros(64, dtype=torch.long))
    chunk = chunk_size(program.port_configs(cell.config)[1])
    assert counts == {family.ENCODED: chunk * (8 + 8 + 16)}


def test_family_refuses_a_port_without_the_counter(monkeypatch):
    """A port whose encoding has no point counter cannot run the
    configuration: loading the family fails at once, naming the counter,
    before any weight is drawn."""
    monkeypatch.delattr(HashGridEncoding, "points")
    with pytest.raises(RuntimeError, match="HashGridEncoding.points"):
        spec.load_family("hash")
    with pytest.raises(RuntimeError, match="HashGridEncoding.points"):
        spec.load_cell("hash.render")


def test_direct_ids_equal_the_host_built_offsets(monkeypatch):
    """The direct levels' corner ids, bit for bit those of the offsets the
    port used to build on the host at every call, and no tensor made from
    host data by a level's ids or interpolation once its constants exist
    on the device."""
    corners = np.array([[i, j, k] for i in (0, 1) for j in (0, 1)
                        for k in (0, 1)], dtype=np.int64)
    g = torch.Generator().manual_seed(5)
    x01 = torch.rand((500, 3), generator=g)
    x01[:4] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0],
                            [1.0, 0.0, 0.5], [0.999999, 1.0, 0.0]])
    frame = torch.randint(0, 3, (500,), generator=g)
    for res, fr in ((16, None), (32, None), (64, None), (16, frame)):
        idx, frac, t_eff = level_ids(x01, res, 2 ** 19, frame=fr,
                                     frames=1 if fr is None else 3)
        side = res + 1
        base = torch.clamp_max(torch.floor(x01 * res), res - 1).long()
        lin = (base[:, 0] * side + base[:, 1]) * side + base[:, 2]
        if fr is not None:
            lin = lin + fr * side ** 3
        offs = torch.as_tensor((corners[:, 0] * side + corners[:, 1]) * side
                               + corners[:, 2])
        assert t_eff is not None and idx.dtype == torch.int64
        assert torch.equal(idx, lin[:, None] + offs[None])
    plain = level_ids(x01, 16, 2 ** 19)[0]
    cells = (x01 * 2048).long()
    hashed = hashgrid._hash_corners(cells, 2 ** 19)
    vals = torch.rand(500, 8, 4, generator=g)
    first = hashgrid.interp_weights(vals, x01)
    made = []
    as_tensor = torch.as_tensor
    monkeypatch.setattr(torch, "as_tensor",
                        lambda *a, **k: (made.append(a), as_tensor(*a, **k))[1])
    assert torch.equal(level_ids(x01, 16, 2 ** 19)[0], plain)
    assert torch.equal(hashgrid.interp_weights(vals, x01), first)
    assert torch.equal(hashgrid._hash_corners(cells, 2 ** 19), hashed)
    assert made == []


def test_hashed_ids_equal_the_per_corner_arithmetic():
    """The hashed levels' corner ids, bit for bit those of the port's
    earlier arithmetic: each corner's three masked products and sums
    XORed, the corners stacked, the frame's term XORed, mod T."""
    g = torch.Generator().manual_seed(6)
    mask, primes = 0xFFFFFFFF, (1, 2654435761, 805459861)
    for top in (2049, 2 ** 31):
        base = torch.randint(0, top, (2000, 3), generator=g)
        frame = torch.randint(0, 5, (2000,), generator=g)
        hx = [(base[:, a] * primes[a]) & mask for a in range(3)]
        cols = [((hx[0] + ((i * primes[0]) & mask)) & mask)
                ^ ((hx[1] + ((j * primes[1]) & mask)) & mask)
                ^ ((hx[2] + ((k * primes[2]) & mask)) & mask)
                for i in (0, 1) for j in (0, 1) for k in (0, 1)]
        plain = torch.stack(cols, dim=-1)
        framed = plain ^ ((frame * 3674653429) & mask)[:, None]
        for size in (2 ** 19, 2 ** 13, 1000):
            assert torch.equal(hashgrid._hash_corners(base, size),
                               plain % size)
            assert torch.equal(hashgrid._hash_corners(base, size, frame),
                               framed % size)


@pytest.mark.parametrize("frames", [1, 3])
def test_encoding_equals_the_level_by_level_composition(frames):
    """All levels at once give, bit for bit, the features of the levels one
    at a time: each level's ids, its gather from its (F, t_eff) view, its
    seven lerps, the levels concatenated."""
    enc = HashGridEncoding(n_levels=8, n_features=4, log2_table_size=19,
                           frames=frames,
                           generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        enc.table.uniform_(-1.0, 1.0, generator=torch.Generator().manual_seed(8))
    xyz = torch.rand((1000, 3), generator=torch.Generator().manual_seed(9))
    xyz = (xyz * 2.4 - 1.2) * frames
    xyz[:10] = float(frames)  # on a +1 face
    frame, local = None, xyz
    if frames > 1:
        frame, local = hashgrid.frame_decompose(xyz, frames)
    x01 = torch.clamp((local + 1.0) * 0.5, 0.0, 1.0)
    feats = []
    for level, res in enumerate(enc.resolutions):
        idx, frac, t_eff = level_ids(x01, res, enc.table_size, frame=frame,
                                     frames=frames)
        v = enc.table[level].view(4, enc.table_size)[:, :t_eff][:, idx]
        for d in (2, 1, 0):
            fd = frac[:, d][None, :, None]
            v = v[..., 0::2] * (1.0 - fd) + v[..., 1::2] * fd
        feats.append(v[..., 0].t())
    with torch.no_grad():
        assert torch.equal(enc(xyz), torch.cat(feats, dim=-1))


def test_operation_counts_of_the_cell():
    """The MLPs' products a point (2 per weight: trunk 35x64 + 64x64,
    sigma, feats, albedo 64x64 + 64x3, sun 67x64 + 64x64 + 64x1, sky 3x64 +
    64x3, semantics 64x64 + 64x3), and the encoding's least traffic."""
    cfg = spec.load_cell("hash.render").config
    model, family = cfg["model"], spec.load_family("hash")
    assert reference_hash.flops_per_point(model) == 55_808
    assert reference_hash.flops_per_point(model, ("sun",)) == 2 * (
        35 * 64 + 64 * 64 + 64 + 64 * 64 + 67 * 64 + 64 * 64 + 64)
    assert family.render_flops_per_ray(cfg) == 128 * 55_808
    assert family.encode_work(model, 10, "bfloat16") == (
        10 * 32 * 21, 10 * (12 + 64))
    assert reference_hash.level_resolutions(8) == [
        16, 32, 64, 128, 256, 512, 1024, 2048]
    assert [reference_hash.direct(model, r) for r in (16, 32, 64, 128)] == [
        True, True, True, False]


def test_encode_readers(monkeypatch):
    from benchmark import port_spans

    cell = spec.load_cell("hash.render")
    points = {"hash.encode": 3_000_000}
    ctx = harness.Context("render", cell.config, cell.traffic, 30.0, 2,
                          2 * 160_776, None, points, None, cell.family)
    device_ms = spec.load_reader("hash.encode_device_ms")
    roofline = spec.load_reader("hash.encode_roofline_pct")
    monkeypatch.setattr(port_spans, "totals", dict)  # nothing recorded
    assert device_ms(ctx) is None and roofline(ctx) is None
    monkeypatch.setattr(port_spans, "totals", lambda: {"hash.encode": {
        "n": 168, "device_s": 0.5, "host_s": 0.1, "parents": [None]}})
    assert device_ms(ctx) == pytest.approx(250.0)
    least = 3_000_000 * 76 / flops.PEAK_HBM_BYTES  # bytes bound it
    assert roofline(ctx) == pytest.approx(100.0 * least / 0.5)
    ctx.field_points = {}  # a port without the counter
    assert roofline(ctx) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_render_cell_is_correct_on_the_card(card):
    """The render program at the cell's own size, one view, against the
    reference on the cell's 16,384 rays, at the cell's limits."""
    out = harness.run_cell(spec.load_cell("hash.render"), SEED, 0.0, 0, card)
    assert out["correct"], out["checks"]


@pytest.mark.cuda
def test_render_control_fails_the_limits_on_the_card(card):
    """The reference with float8 operands, judged by the reference at the
    cell's precision, reads above the cell's limits."""
    cell = spec.load_cell("hash.render")
    numbers = calibrate.control_render(cell, SEED, card)["control"]
    assert not check.judge(numbers, cell.limits), numbers
