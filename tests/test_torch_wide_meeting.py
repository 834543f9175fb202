"""B1's wide kernel on the CPU: a model of its cluster meeting, the soak's
schedule and reckoning, the wait record's layout, and `hold_b1`'s record.

The model (`explore`) is an explicit-state search over `meet` in
`spnerf_torch/csrc/field_eval_wide.cu`: two meeting threads, one a CTA,
each arriving on its peer's count-1 mbarrier and then polling its own
with `try_wait.parity`, which succeeds while the barrier's current phase
parity differs from the one asked for. Any thread may take its next step
at any time, so a poll may lag any number of its peer's steps. With one
barrier a CTA a state is reachable whose polls never succeed; with two,
taken as the kernel takes them, every interleaving finishes, and no thread
leaves meeting k before its peer arrived for it.
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
MEETINGS = 6


def barrier_of(k, barriers):
    """(barrier index, parity) of meeting k, as `meet` computes them."""
    if barriers == 1:
        return 0, k & 1
    return k & 1, (k >> 1) & 1


def explore(barriers, n=MEETINGS):
    """Every state reachable by the two meeting threads over n meetings.
    A thread's state is (meeting k, "arrive" or "wait"); a barrier's is its
    count of completed phases. Returns (states whose threads are not both
    done and none can move, meetings a thread left before its peer arrived
    for them, every state reached)."""
    start = ((0, "arrive"), (0, "arrive"), ((0,) * barriers,) * 2)
    seen, todo = {start}, [start]
    stuck, early = [], []
    while todo:
        state = todo.pop()
        threads, comps = state[:2], state[2]
        moved = False
        for r in (0, 1):
            k, pc = threads[r]
            if k == n:
                continue
            b, parity = barrier_of(k, barriers)
            new_threads, new_comps = list(threads), [list(c) for c in comps]
            if pc == "arrive":
                new_comps[1 - r][b] += 1  # completes the peer's phase
                new_threads[r] = (k, "wait")
            elif new_comps[r][b] % 2 != parity:  # try_wait.parity succeeds
                kp, pcp = threads[1 - r]
                if not (kp > k or (kp == k and pcp == "wait")):
                    early.append((r, k, state))
                new_threads[r] = (k + 1, "arrive")
            else:
                continue
            moved = True
            nxt = (*new_threads, tuple(map(tuple, new_comps)))
            if nxt not in seen:
                seen.add(nxt)
                todo.append(nxt)
        if not moved and not all(t[0] == n for t in threads):
            stuck.append(state)
    return stuck, early, seen


def test_the_model_takes_the_kernels_barrier_and_parity():
    """`barrier_of` is what `meet` computes in both forms."""
    two = re.search(r"const uint32_t off = 8 \* \(k & 1\), parity = "
                    r"\(k >> 1\) & 1;", SRC)
    one = re.search(r"#if WIDE_ONE_BARRIER\s+const uint32_t off = 0, "
                    r"parity = k & 1;", SRC)
    assert two and one
    assert "wait_timed<true>(own_bar + off, parity" in SRC
    assert [barrier_of(k, 2) for k in range(4)] == [(0, 0), (1, 0), (0, 1),
                                                    (1, 1)]


def test_one_barrier_can_hang():
    stuck, early, seen = explore(1)
    assert stuck, len(seen)
    # the hang of the kernel's first form: rank r waits at meeting k for a
    # phase its peer completed twice (its arrivals for k and k + 1)
    (k0, pc0), (k1, pc1), comps = stuck[0]
    assert pc0 == pc1 == "wait" and abs(k0 - k1) == 1
    lagging = 0 if k0 < k1 else 1
    assert comps[lagging][0] == min(k0, k1) + 2


def test_two_barriers_finish_every_interleaving():
    stuck, early, seen = explore(2)
    assert not stuck and not early
    n = MEETINGS
    assert ((n, "arrive"), (n, "arrive"), ((n // 2,) * 2,) * 2) in seen
    # polls lag: a thread a whole meeting ahead of the other, its arrival
    # for the next meeting made before the lagging thread's poll
    assert any(s[0][0] != s[1][0] and "wait" in (s[0][1], s[1][1])
               for s in seen)


def test_wait_record_layout_matches_the_kernel():
    for name, value in (("REC_KINDS", len(wc.WAIT_KINDS)),
                        ("REC_SLOTS", wc.REC_SLOTS),
                        ("REC_INTS", wc.REC_INTS), ("WAIT_MEET", 0),
                        ("WAIT_FULL", 1), ("WAIT_EMPTY", 2)):
        assert re.search(rf"#define {name} {value}\b", SRC), name
    assert "q[7] = 1;" in SRC


def test_a_one_barrier_hang_reads_as_a_phase_completed_twice():
    """A record as the one-barrier copy leaves it at its first meeting:
    rank 0 waits at meeting 0, rank 1 at meeting 1, both producers on a
    ring stage."""
    ints = np.zeros(wc.REC_SIZE, np.int32)
    rows = [(0, 0, 5, 0, 0, 0, -1), (0, 1, 5, 0, 1, 1, -1),
            (2, 0, 5, 384, 3, 0, 11), (2, 1, 5, 384, 3, 0, 11)]
    slots = {0: 0, 2: 0}
    for row in rows:
        kind = row[0]
        o = 3 + (kind * wc.REC_SLOTS + slots[kind]) * wc.REC_INTS
        ints[o:o + wc.REC_INTS] = (*row, 1)
        slots[kind] += 1
        ints[kind] = slots[kind]
    rec = wc.parse_wait_record(ints)
    assert rec["counts"] == {"meeting": 2, "full": 0, "empty": 2}
    ints[2] = 1  # a header the two noting threads raced on
    assert wc.parse_wait_record(ints)["counts"]["empty"] == 2
    assert [r["kind"] for r in rec["records"]] == ["meeting"] * 2 + [
        "empty"] * 2
    one = wc.meeting_analysis(rec["records"], 1)
    assert [(a["rank"], a["completed_twice"]) for a in one] == [(0, True),
                                                                (1, False)]
    assert one[0]["arrivals"] == 2 and one[0]["needed"] == 1
    two = wc.meeting_analysis(rec["records"], 2)
    assert not any(a["completed_twice"] for a in two)


def test_soak_schedule_covers_the_inputs_within_its_budget():
    first, rest = wc.schedule(0)
    assert len(first) == len(wc.combos()) * len(wc.SOAK_POINTS) == 80
    assert {c for c, _ in first} == set(wc.combos())
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
    assert r["meetings"] == sum(wc.meetings(n, wc.SOAK_LAYERS[c[2]])
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
    row = hold_b1.output_row(0.03, 0.2, 0.01)
    assert row["ratio_f32"] == pytest.approx(0.15)
    assert row["ratio_tc"] == pytest.approx(3.0)
    atol = hold_b1.KERNEL_ATOL
    assert hold_b1.verdict("sun_v", row, atol) is not None  # no share
    assert hold_b1.verdict("sun_v", row, atol, 0.45) is None
    assert hold_b1.verdict("sun_v", row, atol, 0.1) is not None
    assert hold_b1.verdict("sun_v", row, atol, 0.45, 4.0) is None
    assert "tensor-core" in hold_b1.verdict("sun_v", row, atol, 0.45, 2.0)
    assert hold_b1.verdict("rgb", row, atol, 0.45, 4.0) is not None
    assert hold_b1.verdict("rgb", hold_b1.output_row(0.01, 0.2, 0.01),
                           atol) is None
    assert hold_b1.largest_ratios([{"sun_v": row}, None]) == (
        pytest.approx(0.15), pytest.approx(3.0))
    assert hold_b1.output_row(0.0, 0.0, 0.0)["ratio_f32"] is None


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
