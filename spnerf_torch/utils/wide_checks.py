"""Check B1's wide kernel (`csrc/field_eval_wide.cu`) on the card: its
cluster meeting under stress and over a long soak, and its sums on
trained fields beside the controls of `utils/hold_b1.py`.

Usage (from the repository root, on a machine with a CUDA device):

    python -m spnerf_torch.utils.wide_checks stress
    python -m spnerf_torch.utils.wide_checks soak --processes 10
    python -m spnerf_torch.utils.wide_checks trained --steps 300

Each prints JSON lines, the last one its result with the card's name and
power limit.

stress: two copies of the kernel built here (`STRESS_VARIANTS`), in which
rank 0's meeting thread waits STRESS_DELAY_NS between its arrivals and its
first poll at every meeting and a wait traps after ~1 s: one with a single
meeting barrier a CTA (the form that can hang) and one with the shipped
two, each on clusters of 2, 4 and 8 CTAs (STRESS_FIELDS). Each runs in a
process of its own, since a trap ends the CUDA context. The first should
trap with its wait record naming the meeting barrier; the second should
finish every launch with the undelayed kernel's output bit for bit.

soak: the shipped kernel through `fused_field_wide` on the inputs of
`schedule` (768 and 1024 wide on clusters of two, 768 on clusters of 4 and
8, bf16 and float32, all heads and the solar pass's, SOAK_POINTS points)
in a shuffled order: the first launch on each
input held against the plain version, every later one equal to it bit for
bit. `--processes` runs that many schedules (seeds 0, 1, ...), each in a
process of its own, so that a trap ends one of them and is counted.
`chip_smoke.py`'s phase 20 runs one schedule (`soak`). The cluster
meetings it reports are reckoned from each launch's points (`meetings`),
not counted by the kernel.

trained: the flagship flags at `--fc_units 1024` in bf16, `--steps` steps
on `write_synthetic_aoi`'s AOI, then each launch of the test view's first
chunk and that chunk's render beside both controls, and whether every
launch meets the bar of a trained field (`hold_b1`: past KERNEL_ATOL, every
output within both control shares); then a 704-wide bf16
field trained 10 steps, whose first chunk's launches go through the
one-CTA wgmma kernel and through the wide kernel (the field packed for it)
on the same inputs, each beside both controls: what the cluster adds to
the tensor cores' sums.
"""

import argparse
import ctypes
import itertools
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch

# the wait record of csrc/field_eval_wide.cu: REC_KINDS counts, then
# REC_SLOTS records of REC_INTS ints a kind (WAIT_MEET, WAIT_FULL,
# WAIT_EMPTY in that order)
WAIT_KINDS = ("meeting", "full", "empty")
REC_SLOTS = 16
REC_FIELDS = ("kind", "rank", "cluster", "thread", "index", "parity", "it",
              "ctas", "whole")
REC_INTS = len(REC_FIELDS)
REC_SIZE = len(WAIT_KINDS) * (1 + REC_SLOTS * REC_INTS)

# the stress copies: rank 0's meeting thread waits STRESS_DELAY_NS before
# its first poll, long enough for the peer to run a whole layer (at most
# ~0.2 ms a tile at 1024 in float32); a wait traps after STRESS_TRAP_CYCLES
# (~1 s at the H100's clock) and notes itself half-way
STRESS_DELAY_NS = 2_000_000
STRESS_TRAP_CYCLES = 2_000_000_000
STRESS_VARIANTS = {
    "one_barrier_delay": ["WIDE_ONE_BARRIER=1",
                          f"WIDE_MEET_DELAY_NS={STRESS_DELAY_NS}",
                          f"WIDE_TRAP_CYCLES={STRESS_TRAP_CYCLES}LL"],
    "two_barrier_delay": [f"WIDE_MEET_DELAY_NS={STRESS_DELAY_NS}",
                          f"WIDE_TRAP_CYCLES={STRESS_TRAP_CYCLES}LL"],
}
# n = 64 first: one tile, one cluster, so the records are that cluster's
STRESS_POINTS = (64, 1, 4_224, 4_225, 8_449)
# the fields each stress copy runs on clusters of 2, 4 and 8 CTAs (768
# packed for clusters of 4 and 8), each cluster size in a process of its own
STRESS_FIELDS = {2: (1024, 768), 4: (768,), 8: (768,)}

# (fc_units, the cluster's CTAs) of the soak's fields: the route's own
# clusters of two at 768 and 1024, and the 768-wide field packed for
# clusters of 4 and 8 (the same work as at 2: only the meeting, the shares
# and the grid change)
SOAK_FIELDS = ((768, 2), (1024, 2), (768, 4), (768, 8))
SOAK_DTYPES = ("bfloat16", "float32")
SOAK_HEADS = ("all", "sun")
# launches of each input a schedule makes after its first: one point; a
# tile less one, one tile, a tile and one; 66 clusters x 64 points (one tile
# a cluster of two) less one, at it, one more (a second round for one
# cluster); two rounds and one more; then the full-width checks' 131,195
# points and the eval render's all-head launch (374,976), which take 32 and
# 89 rounds on clusters of two
SOAK_REPEATS = {1: 200, 63: 200, 64: 200, 65: 200, 4_223: 200, 4_224: 200,
                4_225: 30, 8_449: 20, 131_195: 1, 374_976: 1}
SOAK_POINTS = tuple(SOAK_REPEATS)
SOAK_BUDGET_S = 60
SOAK_SYNC_EVERY = 1000  # launches between synchronisations
BM = 64  # points a tile
CLUSTERS = 66  # clusters of two CTAs on the H100 at 768 and 1024, both dtypes
# clusters of each size that fit the H100 at once, by the cluster's CTAs
# (`wide_clusters` on an H100 80GB HBM3, chip_smoke.py phase 2: 66, 30 and
# 15 at every width and in both dtypes; the soak reads the card's own)
CLUSTERS_BY_CTAS = {2: CLUSTERS, 4: 30, 8: 15}
# The wide kernel's launch times and its plain version's (ms) on an H100
# 80GB HBM3 at 700.00 W (PERF.md, the wide route's row; the upper ends):
# all heads on 374,976 points, the solar pass's heads on 749,952; a field
# on clusters of 4 or 8 is reckoned at the two-CTA time of its width
LAUNCH_POINTS = {"all": 374_976, "sun": 749_952}
LAUNCH_MS = {(768, "bfloat16", "all"): 57.76, (768, "bfloat16", "sun"): 97.24,
             (1024, "bfloat16", "all"): 84.27,
             (1024, "bfloat16", "sun"): 140.58,
             (768, "float32", "all"): 137.83, (768, "float32", "sun"): 240.90,
             (1024, "float32", "all"): 229.67,
             (1024, "float32", "sun"): 401.31}
PLAIN_MS = {(768, "bfloat16", "all"): 315.14, (768, "bfloat16", "sun"): 557.75,
            (1024, "bfloat16", "all"): 454.90,
            (1024, "bfloat16", "sun"): 813.09,
            (768, "float32", "all"): 293.33, (768, "float32", "sun"): 525.92,
            (1024, "float32", "all"): 425.60,
            (1024, "float32", "sun"): 768.64}
HOST_MS = 0.3  # a launch's host side with its comparison (a reckoning)
SETUP_S = 10  # the fields and their inputs, the process's start
# the program's layers that are not a head output, each of which meets
# twice a tile, on the flagship family: 8 trunk layers, sem0, feats, rgb0,
# sun0-2 and sky0 for all heads; the trunk, feats and sun0-2 for the solar
# pass's
SOAK_LAYERS = {"all": 15, "sun": 12}

def heads_of(tag):
    from ..ops import field_eval as fe

    return fe.ALL_HEADS if tag == "all" else ("sun",)


# ------------------------------------------------------------ wait record

def parse_wait_record(ints):
    """The wait record's ints as {"counts": {kind: whole records},
    "slots": {kind: the kind's header, the slots taken as the last noting
    thread wrote it (racy; past REC_SLOTS, records were dropped)},
    "records": [{"kind", "rank", "cluster", "thread", "index", "parity",
    "it", "ctas"}]}: "rank" out of "ctas", the cluster's CTAs."""
    ints = [int(v) for v in ints]
    k = len(WAIT_KINDS)
    records = []
    for kind in range(k):
        for slot in range(REC_SLOTS):
            o = k + (kind * REC_SLOTS + slot) * REC_INTS
            row = dict(zip(REC_FIELDS, ints[o:o + REC_INTS]))
            if row.pop("whole"):
                row["kind"] = WAIT_KINDS[row["kind"]]
                records.append(row)
    return {"counts": {w: sum(r["kind"] == w for r in records)
                       for w in WAIT_KINDS},
            "slots": dict(zip(WAIT_KINDS, ints[:k])), "records": records}


def meeting_analysis(records, barriers):
    """For each cluster whose C ranks (the records' "ctas") all noted a
    meeting wait: rank r waits at meeting k_r, and each peer p, waiting at
    k_p, has arrived on r's barriers for meetings 0 .. k_p (an arrival
    comes before its own wait). Meeting k takes barrier k % `barriers` and
    needs that barrier's (k // barriers + 1)-th completion, each of C - 1
    arrivals; "completed_twice" where the peers' arrivals on it already
    reach one completion more, so the phase the waiter asks for came and
    went."""
    by_cluster, ctas = {}, {}
    for r in records:
        if r["kind"] == "meeting":
            by_cluster.setdefault(r["cluster"], {})[r["rank"]] = r["index"]
            ctas[r["cluster"]] = r["ctas"]
    out = []
    for cluster, ranks in sorted(by_cluster.items()):
        c = ctas[cluster]
        if set(ranks) != set(range(c)):
            continue
        for rank, k in sorted(ranks.items()):
            bar = k % barriers
            arrivals = sum(1 for p, k_peer in ranks.items() if p != rank
                           for m in range(k_peer + 1)
                           if m % barriers == bar)
            needed = k // barriers + 1
            out.append({"cluster": cluster, "rank": rank, "ctas": c,
                        "meeting": k,
                        "peer_meetings": {p: kp for p, kp in ranks.items()
                                          if p != rank},
                        "barrier": bar, "arrivals": arrivals,
                        "needed": needed,
                        "completed_twice": arrivals >= (needed + 1) * (c - 1)})
    return out


class WaitRecord:
    """The wait record of a loaded wide-kernel library, zeroed; `read()`
    parses it. It lies in host memory, so reading it needs no CUDA call and
    works after a trap."""

    def __init__(self, lib):
        fn = lib.spnerf_field_eval_wide_wait_record
        fn.argtypes = []
        fn.restype = ctypes.c_void_p
        addr = fn()
        if not addr:
            raise RuntimeError("the wide kernel's wait record could not be "
                               "set up")
        self.ints = (ctypes.c_int * REC_SIZE).from_address(addr)

    def read(self):
        return parse_wait_record(self.ints)


# -------------------------------------------------------------- the soak

def combos():
    """((width, cluster's CTAs), dtype, heads tag) of every field and head
    subset a schedule launches."""
    return list(itertools.product(SOAK_FIELDS, SOAK_DTYPES, SOAK_HEADS))


def _timed(combo):
    """The LAUNCH_MS / PLAIN_MS key of a combo: its width, dtype and
    heads."""
    return combo[0][0], combo[1], combo[2]


def schedule(seed=0):
    """(first, rest): the first launch on each input, (combo, n) in order,
    then every later launch, SOAK_REPEATS[n] of each input, shuffled."""
    first = [(c, n) for c in combos() for n in SOAK_POINTS]
    rest = [(c, n) for c, n in first for _ in range(SOAK_REPEATS[n])]
    order = np.random.default_rng(seed).permutation(len(rest))
    return first, [rest[i] for i in order]


def rounds(n, clusters=CLUSTERS):
    """Tiles a cluster runs one after another on n points."""
    return -(-(-(-n // BM)) // clusters)


def meetings(n, layers, clusters=CLUSTERS):
    """Cluster meetings of a launch on n points: two a layer a tile, and
    every cluster's closing one."""
    tiles = -(-n // BM)
    return tiles * 2 * layers + min(tiles, clusters)


def reckon(first, rest, layers=SOAK_LAYERS, clusters=CLUSTERS_BY_CTAS):
    """What a schedule costs by the measured launch times (LAUNCH_MS,
    PLAIN_MS): launches, meetings (`clusters`: the clusters that fit, by
    the cluster's CTAs), the kernel's seconds (each launch at least
    HOST_MS; a launch's time grows with its rounds on two-CTA clusters),
    the plain version's seconds on the first launches, and their sum with
    SETUP_S."""
    def launch_ms(combo, n):
        per_round = LAUNCH_MS[_timed(combo)] / rounds(
            LAUNCH_POINTS[combo[2]])
        return max(rounds(n) * per_round, HOST_MS)

    launches = first + rest
    device_s = sum(launch_ms(c, n) for c, n in launches) / 1e3
    plain_s = sum(PLAIN_MS[_timed(c)] * n / LAUNCH_POINTS[c[2]]
                  for c, n in first) / 1e3
    return {"launches": len(launches),
            "meetings": sum(meetings(n, layers[c[2]], clusters[c[0][1]])
                            for c, n in launches),
            "device_s": device_s, "plain_s": plain_s,
            "seconds": device_s + plain_s + SETUP_S}


def soak(device, seed=0, log=print):
    """One schedule (`schedule(seed)`) through `fused_field_wide` on
    `device`, the kernel's wait record set. Returns {"launches" (the
    wrapper's count), "scheduled", "meetings_reckoned" (`meetings` summed
    over the launches made), "mismatches" (later launches'
    outputs not equal bit for bit to their input's first), "traps",
    "max_abs_err_first", "s", ...}; a launch that fails (a trap ends the
    CUDA context) stops it with traps 1, the error and the wait record.
    Raises hold_b1.B1Mismatch where a first launch is outside its bar."""
    from ..config import ModelConfig
    from ..models import load_model
    from ..ops import _build
    from ..ops import field_eval as fe
    from .hold_b1 import F32_ATOL, KERNEL_ATOL, B1Mismatch, tf32

    first, rest = schedule(seed)
    record = WaitRecord(_build.load("field_eval_wide"))
    g = np.random.default_rng(seed)
    pool = max(SOAK_POINTS)
    xyz = torch.from_numpy(g.normal(size=(pool, 3)).astype(np.float32)
                           * 0.3).to(device)
    sun = torch.nn.functional.normalize(torch.from_numpy(
        g.normal(size=(pool, 3)).astype(np.float32)), dim=-1).to(device)
    sems = torch.from_numpy(g.integers(0, 3, size=pool)).to(device)
    fields, clusters = {}, {}
    for (width, ctas), dtype in itertools.product(SOAK_FIELDS, SOAK_DTYPES):
        mc = ModelConfig(mapping=True, sem=True, num_sem_classes=3,
                         fc_units=width)
        model = load_model(mc, dtype, device=device,
                           generator=torch.Generator().manual_seed(width))
        if fe.route(mc, dtype) != "wgmma_wide":
            raise ValueError(f"{dtype} fc_units {width} routes to "
                             f"{fe.route(mc, dtype)}")
        packed = fe.pack_params(model, dtype, cluster=ctas)
        x_in, sn, _ = fe.FusedField(packed, dtype).inputs(xyz, sun, None,
                                                          sems)
        fields[((width, ctas), dtype)] = (packed, x_in, sn)
        clusters[((width, ctas), dtype)] = fe.wide_clusters(width, dtype,
                                                            ctas)
    layers = {h: int((fe.program(packed, heads_of(h))[:, 10] < 0).sum())
              for h in SOAK_HEADS}
    by_ctas = {f[1]: n for (f, _), n in clusters.items()}
    res = {"seed": seed, "scheduled": len(first) + len(rest),
           "layers": layers, "clusters": {f"{d} {w} on {c}": n for
                                          ((w, c), d), n in clusters.items()},
           "reckoned": reckon(first, rest, layers, by_ctas),
           "meetings_reckoned": 0, "mismatches": 0, "traps": 0,
           "max_abs_err_first": 0.0}
    outs, bad = {}, {}

    def run(combo, n):
        packed, x_in, sn = fields[combo[:2]]
        res["meetings_reckoned"] += meetings(n, layers[combo[2]],
                                             clusters[combo[:2]])
        return fe.fused_field_wide(packed, x_in[:n], sn[:n], None,
                                   heads_of(combo[2]))

    before = fe.FusedField.route_launches["wgmma_wide"]
    t0 = time.perf_counter()
    try:
        with tf32(False):
            for combo, n in first:
                out = run(combo, n)
                packed, x_in, sn = fields[combo[:2]]
                ref = fe.fused_field_plain(packed, x_in[:n], sn[:n], None,
                                           heads_of(combo[2]), combo[1])
                err = max((out[k] - ref[k]).abs().max().item() for k in ref)
                atol = KERNEL_ATOL if combo[1] == "bfloat16" else F32_ATOL
                if not err <= atol:
                    raise B1Mismatch(f"soak, {combo} on {n} points: max abs "
                                     f"err {err} > {atol}")
                res["max_abs_err_first"] = max(res["max_abs_err_first"], err)
                outs[combo, n] = out
                bad[combo, n] = torch.zeros((), dtype=torch.int64,
                                            device=device)
            for i, (combo, n) in enumerate(rest):
                out, ref = run(combo, n), outs[combo, n]
                for k in ref:
                    bad[combo, n].add_((out[k] != ref[k]).any())
                if (i + 1) % SOAK_SYNC_EVERY == 0:
                    torch.cuda.synchronize(device)
                    if (i + 1) % (20 * SOAK_SYNC_EVERY) == 0:
                        log(f"soak seed {seed}: {i + 1} of {len(rest)} "
                            f"launches at {time.perf_counter() - t0:.1f} s")
            torch.cuda.synchronize(device)
            res["mismatches"] = int(sum(v.item() for v in bad.values()))
            res["mismatched_inputs"] = [
                [*c, n] for (c, n), v in bad.items() if v.item()]
    except RuntimeError as e:
        res.update(traps=1, error=str(e)[:500], record=record.read())
    res["s"] = time.perf_counter() - t0
    res["launches"] = fe.FusedField.route_launches["wgmma_wide"] - before
    return res


# ------------------------------------------------------------ subprocesses

def run_child(argv, timeout):
    """`python -m spnerf_torch.utils.wide_checks *argv` in a process group
    of its own, killed whole at `timeout` s. Returns (exit code or None on
    the time limit, the last JSON object it printed or None, the tail of
    its output)."""
    cmd = [sys.executable, "-m", "spnerf_torch.utils.wide_checks", *argv]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        text, _ = proc.communicate(timeout=timeout)
        rc = proc.returncode
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        text, _ = proc.communicate()
        rc = None
    last = None
    for line in text.splitlines():
        if line.startswith("{"):
            try:
                last = json.loads(line)
            except json.JSONDecodeError:
                pass
    return rc, last, text.splitlines()[-40:]


def stress_child(variant, device, cluster=2):
    """One stress copy's launches (see the module's docstring) on clusters
    of `cluster` CTAs (the fields of STRESS_FIELDS), each against the
    shipped kernel's output on the same inputs; prints its record and ends
    the process (after a trap the CUDA context is gone)."""
    from ..config import ModelConfig
    from ..models import load_model
    from ..ops import _build
    from ..ops import field_eval as fe
    from .time_wide_variants import build_variant, launch

    lib, ptxas = build_variant(variant, STRESS_VARIANTS[variant])
    shipped = _build.load("field_eval_wide")
    record = WaitRecord(lib)
    one = "WIDE_ONE_BARRIER=1" in STRESS_VARIANTS[variant]
    res = {"variant": variant, "cluster": cluster,
           "defines": STRESS_VARIANTS[variant], "ptxas": ptxas,
           "launches": 0, "equal": 0, "differ": 0, "trapped": False,
           "delay_s": 0.0}
    g = np.random.default_rng(1)
    n_max = max(STRESS_POINTS)
    xyz = torch.from_numpy(g.normal(size=(n_max, 3)).astype(np.float32)
                           * 0.3).to(device)
    sun = torch.nn.functional.normalize(torch.from_numpy(
        g.normal(size=(n_max, 3)).astype(np.float32)), dim=-1).to(device)
    sems = torch.from_numpy(g.integers(0, 3, size=n_max)).to(device)
    t0 = time.perf_counter()
    try:
        for width, dtype in itertools.product(STRESS_FIELDS[cluster],
                                              SOAK_DTYPES):
            mc = ModelConfig(mapping=True, sem=True, num_sem_classes=3,
                             fc_units=width)
            packed = fe.pack_params(load_model(
                mc, dtype, device=device,
                generator=torch.Generator().manual_seed(width)), dtype,
                cluster=cluster)
            x_in, sn, _ = fe.FusedField(packed, dtype).inputs(xyz, sun, None,
                                                              sems)
            for h, n in itertools.product(SOAK_HEADS, STRESS_POINTS):
                layers = int((fe.program(packed, heads_of(h))[:, 10] < 0)
                             .sum())
                ref = launch(shipped, packed, x_in[:n], sn[:n], heads_of(h))
                for _ in range(2):
                    res["at"] = [width, dtype, h, n]
                    out = launch(lib, packed, x_in[:n], sn[:n], heads_of(h))
                    torch.cuda.synchronize(device)
                    res["launches"] += 1
                    # rank 0 of every cluster waits at each of its meetings:
                    # the least the launch can take
                    res["delay_s"] += ((rounds(
                        n, CLUSTERS_BY_CTAS[cluster]) * 2 * layers + 1)
                        * STRESS_DELAY_NS / 1e9)
                    same = all(torch.equal(out[k], ref[k]) for k in ref)
                    res["equal" if same else "differ"] += 1
    except RuntimeError as e:
        res.update(trapped=True, error=str(e)[:500])
    res["s"] = time.perf_counter() - t0
    res["record"] = record.read()
    res["meeting_analysis"] = meeting_analysis(res["record"]["records"],
                                               1 if one else 2)
    print(json.dumps(res), flush=True)
    os._exit(0)


def stress(timeout=900):
    """Each stress copy on each cluster size in a process of its own; its
    record and verdict."""
    out = {}
    for variant in STRESS_VARIANTS:
        for cluster in STRESS_FIELDS:
            rc, res, tail = run_child(
                ["stress-child", variant, "--cluster", str(cluster)], timeout)
            res = res or {"tail": tail}
            recs = res.get("record", {}).get("records", [])
            res["rc"] = rc
            res["names_meeting"] = any(r["kind"] == "meeting" for r in recs)
            res["completed_twice"] = any(
                a["completed_twice"] for a in res.get("meeting_analysis", []))
            tag = f"{variant} on {cluster}"
            out[tag] = res
            print(json.dumps({tag: res}), flush=True)
    return out


def soak_many(processes, timeout=600):
    """`processes` schedules (seeds 0 ..), each in a process of its own;
    their counts added up (a process that dies counts one trap)."""
    total = {"launches": 0, "meetings_reckoned": 0, "mismatches": 0,
             "traps": 0, "s": 0.0, "processes": []}
    for seed in range(processes):
        rc, res, tail = run_child(["soak-child", "--seed", str(seed)],
                                  timeout)
        if res is None or rc != 0:
            res = {**(res or {}), "traps": max(1, (res or {}).get("traps", 0)),
                   "rc": rc, "tail": tail}
        for k in ("launches", "meetings_reckoned", "mismatches", "traps",
                  "s"):
            total[k] += res.get(k, 0)
        total["processes"].append({k: res.get(k) for k in (
            "seed", "launches", "meetings_reckoned", "mismatches", "traps",
            "s", "max_abs_err_first", "error", "record", "rc", "tail")
            if res.get(k) is not None})
        print(json.dumps({"soak": total["processes"][-1]}), flush=True)
    return total


# --------------------------------------------------------- trained fields

def trained(device, steps=300, log=print):
    """The trained fields' readings (see the module's docstring)."""
    from ..cli import train as cli_train
    from ..config import (build_train_parser, finalize_args,
                          model_config_from_args, render_config_from_args)
    from ..ops import field_eval as fe
    from ..render import build_render_fn, chunk_size
    from .hold_b1 import (KERNEL_ATOL, TC_CONTROL_SHARE, WIDE_CONTROL_SHARE,
                          by_output, hold_launch, record_launches,
                          render_rows, verdict)
    from .synth import FLAGSHIP_CLI_FLAGS
    from .synth_scene import write_synthetic_aoi

    res = {}
    with tempfile.TemporaryDirectory() as project:
        write_synthetic_aoi(os.path.join(project, "dataset", "DFC2019_269"),
                            aoi_id="JAX_269")
        for units, n_steps in ((1024, steps), (704, 10)):
            argv = FLAGSHIP_CLI_FLAGS + [
                "--img_downscale", "4", "--fc_units", str(units),
                "--max_train_steps", str(n_steps),
                "--project_dir", project, "--device", str(device),
                "--exp_name", f"wide{units}"]
            t0 = time.perf_counter()
            state = cli_train.main(argv)
            torch.cuda.synchronize(device)
            r = res[f"{units} x {n_steps} steps"] = {
                "s": time.perf_counter() - t0}
            args = finalize_args(build_train_parser().parse_args(argv),
                                 make_dirs=False)
            mc, rc = model_config_from_args(args), render_config_from_args(
                args)
            r["route"] = fe.route(mc, rc.compute_dtype)
            _, scene, _ = cli_train.build_trainer_and_scene(args, device)
            sample = scene.load_val_image(scene.val_images[-1],
                                          with_sem=True)
            chunk = chunk_size(rc, args.chunk)
            rays, sems = sample["rays"][:chunk], sample["sems"][:chunk]
            render = build_render_fn(state.model, rc, state.t_embed,
                                     chunk=args.chunk)
            outs = []
            launches = record_launches(
                lambda: outs.append(render(rays, 0, sems)))
            tag = f"fc_units {units}, {n_steps} steps"
            kernels = {r["route"]: None}
            if units != 1024:
                kernels["wgmma_wide"] = fe.pack_params(
                    state.model, rc.compute_dtype, kernel="wgmma_wide")
            for name, pk in kernels.items():
                rows = [hold_launch(x, tag, controls=True, packed=pk,
                                    check=False)["outputs"]
                        for x in launches]
                # the bar of a trained field: past KERNEL_ATOL, every output
                # within both control shares
                misses = [f"launch {i}, {k}: {why}"
                          for i, out in enumerate(rows)
                          for k, row in out.items()
                          if (why := verdict(row, KERNEL_ATOL,
                                             WIDE_CONTROL_SHARE,
                                             TC_CONTROL_SHARE))]
                r[name] = {"launches": rows, "by_output": by_output(rows),
                           "bar_passes": not misses, "bar_misses": misses}
            plain, plain32 = (build_render_fn(
                state.model, c, state.t_embed, chunk=args.chunk,
                field="plain") for c in (rc, replace(
                    rc, compute_dtype="float32")))
            r["render"] = render_rows(outs[0], plain, plain32, rays, 0, sems)
            log(json.dumps({tag: {k: v for k, v in r.items()
                                  if k != "launches"}}))
            del state, render, scene, outs, launches
            torch.cuda.empty_cache()
    return res


def main(argv=None):
    from ..device import card_info

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("stress")
    s = sub.add_parser("soak")
    s.add_argument("--processes", type=int, default=10)
    t = sub.add_parser("trained")
    t.add_argument("--steps", type=int, default=300)
    c = sub.add_parser("stress-child")
    c.add_argument("variant", choices=tuple(STRESS_VARIANTS))
    c.add_argument("--cluster", type=int, default=2,
                   choices=tuple(STRESS_FIELDS))
    c = sub.add_parser("soak-child")
    c.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if args.cmd == "stress-child":
        return stress_child(args.variant, dev, args.cluster)
    if args.cmd == "soak-child":
        res = soak(dev, args.seed)
        print(json.dumps(res), flush=True)
        return res
    card = ", ".join(card_info(dev) or ("not read",))
    res = {"stress": lambda: stress(),
           "soak": lambda: soak_many(args.processes),
           "trained": lambda: trained(dev, args.steps)}[args.cmd]()
    print(json.dumps({args.cmd: res, "card": card}), flush=True)
    return res


if __name__ == "__main__":
    main()
