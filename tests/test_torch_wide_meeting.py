"""B1's wide kernel on the CPU: a model of its cluster meeting, the soak's
schedule and reckoning, the wait record's layout, and `hold_b1`'s record.

The model (`explore`) is an explicit-state search over `meet` in
`spnerf_torch/csrc/field_eval_wide.cu` for a cluster of C CTAs: C meeting
threads, one a CTA, each arriving in turn on each of its C - 1 peers'
barriers (count C - 1: a phase completes at its (C - 1)-th arrival), each
arrival a step of its own, and then polling its own barrier with
`try_wait.parity`, which succeeds while the barrier's current phase
parity differs from the one asked for. Any thread may take its next step
at any time, so a poll may lag any number of its peers' steps. With one
barrier a CTA a state is reachable whose polls never succeed; with two,
taken as the kernel takes them, every interleaving finishes, and no thread
leaves meeting k before all its peers arrived for it. C = 2, 3 and 4 (the
kernel runs 2, 4 and 8; 3 is the smallest that mixes the arrivals of
several peers on one barrier; at 6 the search takes 12 s over 338K states
for three meetings, and 8 is past what it can enumerate here).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from spnerf_torch.config import ModelConfig
from spnerf_torch.models import load_model
from spnerf_torch.ops import field_eval as fe
from spnerf_torch.utils import hold_b1
from spnerf_torch.utils import wide_checks as wc

SRC = (Path(__file__).resolve().parent.parent / "spnerf_torch" / "csrc"
       / "field_eval_wide.cu").read_text()
# meetings a search runs, by the cluster's CTAs: at least three, so that a
# barrier is taken again (meetings k and k + 2) while a peer lags
MEETINGS = {2: 6, 3: 6, 4: 6}
WAIT = "wait"


def barrier_of(k, barriers):
    """(barrier index, parity) of meeting k, as `meet` computes them."""
    if barriers == 1:
        return 0, k & 1
    return k & 1, (k >> 1) & 1


def peer_of(r, j, ctas):
    """The CTA that thread r's j-th arrival of a meeting goes to, as
    `meet` orders them: ranks r + 1, ..., r + C - 1 (mod C)."""
    return (r + j + 1) % ctas


def arrived(thread, r, k, y, ctas):
    """Whether thread y (at `thread`, (meeting, arrivals made or WAIT)) has
    made its arrival for meeting k on thread r's barrier."""
    ky, jy = thread
    if ky != k:
        return ky > k
    return jy == WAIT or jy > (r - y) % ctas - 1


def explore(barriers, n=None, ctas=2):
    """Every state reachable by the C = `ctas` meeting threads over n
    meetings. A thread's state is (meeting k, arrivals made so far or
    WAIT); a barrier's is (completed phases, arrivals in its current
    phase). Returns (states whose threads are not all done and none can
    move, (thread, meeting, state) where a thread left a meeting before
    every peer arrived for it, every state reached)."""
    n = MEETINGS[ctas] if n is None else n
    need = ctas - 1
    start = (((0, 0),) * ctas, (((0, 0),) * barriers,) * ctas)
    seen, todo = {start}, [start]
    stuck, early = [], []
    while todo:
        state = todo.pop()
        threads, comps = state
        moved = False
        for r in range(ctas):
            k, j = threads[r]
            if k == n:
                continue
            b, parity = barrier_of(k, barriers)
            new_threads = list(threads)
            new_comps = [list(c) for c in comps]
            if j != WAIT:
                y = peer_of(r, j, ctas)
                phases, count = new_comps[y][b]
                count += 1
                if count == need:  # the phase completes
                    phases, count = phases + 1, 0
                new_comps[y][b] = (phases, count)
                new_threads[r] = (k, WAIT if j + 1 == need else j + 1)
            elif new_comps[r][b][0] % 2 != parity:  # try_wait.parity
                if not all(arrived(threads[y], r, k, y, ctas)
                           for y in range(ctas) if y != r):
                    early.append((r, k, state))
                new_threads[r] = (k + 1, 0)
            else:
                continue
            moved = True
            nxt = (tuple(new_threads), tuple(map(tuple, new_comps)))
            if nxt not in seen:
                seen.add(nxt)
                todo.append(nxt)
        if not moved and not all(t[0] == n for t in threads):
            stuck.append(state)
    return stuck, early, seen


def test_the_model_takes_the_kernels_barrier_and_parity():
    """`barrier_of` and `peer_of` are what `meet` computes in both forms,
    and each barrier expects one arrival from each peer a phase."""
    two = re.search(r"const uint32_t off = 8 \* \(k & 1\), parity = "
                    r"\(k >> 1\) & 1;", SRC)
    one = re.search(r"#if WIDE_ONE_BARRIER\s+const uint32_t off = 0, "
                    r"parity = k & 1;", SRC)
    assert two and one
    assert "wait_timed<true>(own_bar + off, parity" in SRC
    assert [barrier_of(k, 2) for k in range(4)] == [(0, 0), (1, 0), (0, 1),
                                                    (1, 1)]
    assert re.search(r"for \(int j = 1; j < C; \+\+j\) \{\s+const uint32_t "
                     r"peer_bar = map_rank\(own_bar \+ off, \(rank \+ j\) "
                     r"% C\);", SRC)
    assert [peer_of(1, j, 4) for j in range(3)] == [2, 3, 0]
    assert "mbar_init(xbar, C - 1);" in SRC
    assert "mbar_init(xbar + 8, C - 1);" in SRC


@pytest.mark.parametrize("ctas", [2, 3, 4])
def test_one_barrier_can_hang(ctas):
    stuck, early, seen = explore(1, ctas=ctas)
    assert stuck, len(seen)
    if ctas == 2:
        # the hang of the kernel's first form: rank r waits at meeting k for
        # a phase its peer completed twice (its arrivals for k and k + 1)
        ((k0, pc0), (k1, pc1)), comps = stuck[0]
        assert pc0 == pc1 == WAIT and abs(k0 - k1) == 1
        lagging = 0 if k0 < k1 else 1
        assert comps[lagging][0][0] == min(k0, k1) + 2
    else:
        # a phase completed on a mix of meetings' arrivals: a thread can
        # also leave a meeting before every peer arrived for it
        assert early


@pytest.mark.parametrize("ctas", [2, 3, 4])
def test_two_barriers_finish_every_interleaving(ctas):
    stuck, early, seen = explore(2, ctas=ctas)
    assert not stuck and not early
    n = MEETINGS[ctas]
    done = (((n, 0),) * ctas,
            (((n // 2 + n % 2, 0), (n // 2, 0)),) * ctas)
    assert done in seen
    # polls lag: a thread a whole meeting ahead of another, its arrivals
    # for the next meeting made before the lagging thread's poll
    assert any(len({t[0] for t in s[0]}) > 1
               and any(t[1] == WAIT for t in s[0]) for s in seen)


def test_wait_record_layout_matches_the_kernel():
    for name, value in (("REC_KINDS", len(wc.WAIT_KINDS)),
                        ("REC_SLOTS", wc.REC_SLOTS),
                        ("REC_INTS", wc.REC_INTS), ("WAIT_MEET", 0),
                        ("WAIT_FULL", 1), ("WAIT_EMPTY", 2)):
        assert re.search(rf"#define {name} {value}\b", SRC), name
    assert "q[7] = (int)ctas;" in SRC and "q[8] = 1;" in SRC
    assert wc.REC_FIELDS[7:] == ("ctas", "whole")


def _record(rows):
    """The wait record's ints holding `rows` (kind, rank, cluster, thread,
    index, parity, it, ctas), each made whole, in their kinds' slots."""
    ints = np.zeros(wc.REC_SIZE, np.int32)
    slots = {}
    for row in rows:
        kind = row[0]
        slot = slots.get(kind, 0)
        o = 3 + (kind * wc.REC_SLOTS + slot) * wc.REC_INTS
        ints[o:o + wc.REC_INTS] = (*row, 1)
        slots[kind] = slot + 1
        ints[kind] = slots[kind]
    return ints


def test_a_one_barrier_hang_reads_as_a_phase_completed_twice():
    """A record as the one-barrier copy leaves it at its first meeting:
    rank 0 waits at meeting 0, rank 1 at meeting 1, both producers on a
    ring stage."""
    ints = _record([(0, 0, 5, 0, 0, 0, -1, 2), (0, 1, 5, 0, 1, 1, -1, 2),
                    (2, 0, 5, 384, 3, 0, 11, 2), (2, 1, 5, 384, 3, 0, 11, 2)])
    rec = wc.parse_wait_record(ints)
    assert rec["counts"] == {"meeting": 2, "full": 0, "empty": 2}
    ints[2] = 1  # a header the two noting threads raced on
    assert wc.parse_wait_record(ints)["counts"]["empty"] == 2
    assert [r["kind"] for r in rec["records"]] == ["meeting"] * 2 + [
        "empty"] * 2
    assert {r["ctas"] for r in rec["records"]} == {2}
    one = wc.meeting_analysis(rec["records"], 1)
    assert [(a["rank"], a["completed_twice"]) for a in one] == [(0, True),
                                                                (1, False)]
    assert one[0]["arrivals"] == 2 and one[0]["needed"] == 1
    two = wc.meeting_analysis(rec["records"], 2)
    assert not any(a["completed_twice"] for a in two)


def test_meeting_analysis_of_a_cluster_of_four():
    """Four ranks of a one-barrier cluster: rank 0 waits at meeting 0 while
    ranks 1-3 wait at meeting 1, so its barrier took 6 arrivals (3 peers,
    meetings 0 and 1) where one phase needs 3: it completed twice. With
    two barriers the same record shows no such phase; a cluster whose
    ranks did not all note a wait is left out."""
    rows = [(0, 0, 7, 0, 0, 0, -1, 4)] + [
        (0, r, 7, 0, 1, 1, -1, 4) for r in (1, 2, 3)] + [
        (0, 0, 9, 0, 4, 0, -1, 4)]
    recs = wc.parse_wait_record(_record(rows))["records"]
    one = wc.meeting_analysis(recs, 1)
    assert {a["cluster"] for a in one} == {7}
    by_rank = {a["rank"]: a for a in one}
    assert by_rank[0]["arrivals"] == 6 and by_rank[0]["needed"] == 1
    assert by_rank[0]["completed_twice"]
    assert by_rank[1]["arrivals"] == 5 and not by_rank[1]["completed_twice"]
    assert not any(a["completed_twice"] for a in wc.meeting_analysis(recs, 2))


def test_soak_schedule_covers_the_inputs_within_its_budget():
    first, rest = wc.schedule(0)
    assert len(first) == len(wc.combos()) * len(wc.SOAK_POINTS) == 160
    assert {c for c, _ in first} == set(wc.combos())
    assert {c[0][1] for c, _ in first} == {2, 4, 8}  # the clusters' CTAs
    assert {n for _, n in first} == {1, 63, 64, 65, 4_223, 4_224, 4_225,
                                     8_449, 131_195, 374_976}
    counts = {}
    for key in rest:
        counts[key] = counts.get(key, 0) + 1
    assert set(counts) == set(first)  # every input launched again
    assert rest != sorted(rest)  # shuffled
    assert wc.schedule(0) == (first, rest) and wc.schedule(1)[1] != rest
    r = wc.reckon(first, rest)
    assert r["launches"] >= 20_000
    assert sum(n <= 4_224 for _, n in rest) > 0.9 * len(rest)  # mostly small
    assert r["seconds"] <= wc.SOAK_BUDGET_S
    # 4,224 points: one tile a cluster; one more point: a second round
    assert wc.rounds(4_224) == 1 and wc.rounds(4_225) == 2
    assert wc.meetings(4_224, 15) == 66 * 30 + 66
    assert wc.meetings(1, 12) == 24 + 1
    assert wc.meetings(374_976, 15) == 5_859 * 30 + 66
    assert wc.meetings(4_224, 15, 16) == 66 * 30 + 16
    assert r["meetings"] == sum(
        wc.meetings(n, wc.SOAK_LAYERS[c[2]], wc.CLUSTERS_BY_CTAS[c[0][1]])
        for c, n in first + rest)


def test_soak_layers_match_the_program():
    """SOAK_LAYERS, the layers that meet, are the program's rows that
    write activations on the flagship family (checked at a small width)."""
    cfg = ModelConfig(mapping=True, sem=True, num_sem_classes=3, fc_units=64)
    model = load_model(cfg, "bfloat16", device="cpu",
                       generator=torch.Generator().manual_seed(0))
    packed = fe.pack_params(model, "bfloat16", kernel="wgmma_wide")
    for tag, layers in wc.SOAK_LAYERS.items():
        prog = fe.program(packed, wc.heads_of(tag))
        assert int((prog[:, 10] < 0).sum()) == layers


@pytest.fixture(scope="module")
def small_field():
    cfg = ModelConfig(mapping=True, sem=True, num_sem_classes=3, fc_units=64)
    model = load_model(cfg, "bfloat16", device="cpu",
                       generator=torch.Generator().manual_seed(0))
    g = np.random.default_rng(0)
    xyz = torch.from_numpy(g.normal(size=(37, 3)).astype(np.float32) * 0.3)
    sun = torch.nn.functional.normalize(torch.from_numpy(
        g.normal(size=(37, 3)).astype(np.float32)), dim=-1)
    sems = torch.from_numpy(g.integers(0, 3, size=37))
    return fe.pack_params(model, "bfloat16"), xyz, sun, sems


def test_hold_records_both_controls_on_the_cpu(small_field):
    """On the CPU the plain version stands in for the kernel (distance 0),
    the float32 control is the bf16 rounding's size, and TF32 changes
    nothing (tensor-core control 0, its ratio None)."""
    packed, xyz, sun, sems = small_field

    def run():
        fe.FusedField(packed, "bfloat16")(xyz, sun, None, sems)
        fe.FusedField(packed, "bfloat16")(xyz, sun, None, sems,
                                          heads=("sun",))

    rec = hold_b1.hold_b1_launches(run, "cpu", controls=True)
    assert rec["launches_held"] == 2 and rec["max_abs_err"] == 0.0
    assert rec["points"] == [37, 37]
    assert set(rec["outputs"][1]) == {"sigma", "sun_v"}
    for rows in rec["outputs"]:
        for row in rows.values():
            assert row["err"] == 0.0 and row["control_f32"] > 0
            assert row["ratio_f32"] == 0.0
            assert row["control_tc"] == 0.0 and row["ratio_tc"] is None
    assert rec["max_ratio_past_atol"] is None
    assert rec["max_tc_ratio_past_atol"] is None
    assert set(rec["by_output"]) == set(rec["outputs"][0])
    plain = hold_b1.hold_b1_launches(run, "cpu")
    assert "outputs" not in plain and plain["max_abs_err"] == 0.0


def test_hold_bars_take_both_ratios():
    """Past KERNEL_ATOL every output, sigma and rgb as well as sun
    visibility, goes to both controls, and both shares must hold."""
    row = hold_b1.output_row(0.03, 0.2, 0.01)
    assert row["ratio_f32"] == pytest.approx(0.15)
    assert row["ratio_tc"] == pytest.approx(3.0)
    atol = hold_b1.KERNEL_ATOL
    assert hold_b1.verdict(row, atol) is not None  # no share
    assert hold_b1.verdict(row, atol, 0.45) is None
    assert hold_b1.verdict(row, atol, 0.1) is not None
    assert hold_b1.verdict(row, atol, 0.45, 4.0) is None
    assert "tensor-core" in hold_b1.verdict(row, atol, 0.45, 2.0)
    assert hold_b1.verdict(hold_b1.output_row(0.01, 0.2, 0.01), atol) is None
    assert hold_b1.largest_ratios([{"sun_v": row}, None]) == (
        pytest.approx(0.15), pytest.approx(3.0))
    assert hold_b1.output_row(0.0, 0.0, 0.0)["ratio_f32"] is None


def test_every_output_goes_to_both_controls(small_field, monkeypatch):
    """A bf16 launch whose sigma, rgb or sky alone sits past KERNEL_ATOL
    passes within both shares and fails outside either, as sun visibility
    does: the bar no longer keeps sigma, rgb, sky and beta at
    KERNEL_ATOL."""
    packed, xyz, sun, sems = small_field
    launch = hold_b1.Launch(packed, "bfloat16", xyz, sun, None, sems,
                            ("rgb", "sun", "sky", "sem"))
    ref = fe.PlainField(packed, "bfloat16")(*launch.args(),
                                             heads=launch.heads)
    wide = {k: v + 0.2 for k, v in ref.items()}
    tc = {k: v + 0.015 for k, v in ref.items()}
    monkeypatch.setattr(hold_b1, "controls_of", lambda _: (wide, tc))
    for k in ("sigma", "rgb", "sky", "sun_v"):
        off = dict(ref)
        off[k] = ref[k] + 0.03
        monkeypatch.setattr(fe.FusedField, "__call__",
                            lambda self, *a, heads=None, out=off: out)
        rec = hold_b1.hold_launch(launch, "t", control_share=0.45,
                                  tc_share=3.0)
        assert rec["outputs"][k]["err"] == pytest.approx(0.03, rel=1e-3)
        with pytest.raises(hold_b1.B1Mismatch,
                           match=f", {k}: max abs err .* float32 control"):
            hold_b1.hold_launch(launch, "t", control_share=0.1, tc_share=3.0)
        with pytest.raises(hold_b1.B1Mismatch,
                           match=f", {k}: max abs err .* tensor-core"):
            hold_b1.hold_launch(launch, "t", control_share=0.45,
                                tc_share=1.5)
        with pytest.raises(hold_b1.B1Mismatch):
            hold_b1.hold_launch(launch, "t")


def test_shares_take_the_controls_only_past_the_bar(small_field,
                                                    monkeypatch):
    """With the shares alone, a bf16 launch whose outputs all lie within
    KERNEL_ATOL passes without its controls (the two plain fields are not
    run, its rows are None); with `controls` it gets them."""
    packed, xyz, sun, sems = small_field
    launch = hold_b1.Launch(packed, "bfloat16", xyz, sun, None, sems, None)

    def no_controls(_):
        raise AssertionError("controls taken")

    monkeypatch.setattr(hold_b1, "controls_of", no_controls)
    rec = hold_b1.hold_launch(launch, "t", control_share=0.45, tc_share=3.0)
    assert rec["err"] == 0.0 and rec["outputs"] is None
    with pytest.raises(AssertionError, match="controls taken"):
        hold_b1.hold_launch(launch, "t", controls=True, control_share=0.45,
                            tc_share=3.0)


def test_render_rows_beside_both_controls(small_field):
    packed, xyz, sun, sems = small_field

    def render(rays, _, s):
        return {"v": rays.sum(-1)}

    def render32(rays, _, s):
        return {"v": rays.sum(-1) + 1e-3}

    rays = torch.ones(50, 11)
    out = {"v": rays.sum(-1) + 2e-3}
    rows = hold_b1.render_rows(out, render, render32, rays, 0, sems)
    r = rows["v"]
    assert r["max"] == pytest.approx(2e-3, rel=1e-3)
    assert r["control_f32_max"] == pytest.approx(1e-3, rel=1e-3)
    assert r["control_tc_max"] == 0.0 and r["ratio_tc"] is None
    assert r["ratio_f32"] == pytest.approx(2.0, rel=1e-3)
