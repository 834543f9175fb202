"""Where a train step's time goes on the card.

Usage (from the repository root, on a machine with a CUDA device):

    python -m spnerf_torch.utils.profile_step --family hash --steps 5
    SPNERF_HASH_SW_BATCHED=1 python -m spnerf_torch.utils.profile_step \
        --no_flat_table

`--no_flat_table` profiles the hash step with the (L, T, F) table. The
table-gradient router reads SPNERF_HASH_SW_ACC and SPNERF_HASH_SW_BATCHED
from the environment at call time, so the hash step's variants are
profiled by setting them for the command; the output names them.

Builds the flagship ("siren") or hash train step of `train_setup`, takes 2
warm-up steps, times `--steps` steps with CUDA events, then runs the same
number of steps under `torch.profiler` and prints one JSON line: ms/step
without the profiler, the device's busy time per step (the union of its
kernel intervals) and idle share over the profiled window, kernel launches
per step, and the device time per step of the kernels that take most of it,
by name and by class (the port's own kernels, sort, matrix products, the
rest). Device times come from the profiler's CUDA activity records; where it
records none, they are printed as null ("not measured").
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

CLASSES = (  # (class, substrings of the kernel name), first match wins
    ("port: dtab", ("dtab_scatter", "slice_", "tile_agg")),
    ("port: field_eval", ("field_eval",)),
    ("sort", ("radix", "Sort", "sort")),
    ("matmul", ("gemm", "sm90_xmma", "cutlass", "Gemm")),
    ("index / scatter / gather", ("index", "scatter", "gather", "Index")),
    ("reduce", ("reduce", "Reduce", "scan", "Scan")),
)


def classify(name):
    for cls, keys in CLASSES:
        if any(k in name for k in keys):
            return cls
    return "elementwise and other"


def busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", choices=("hash", "siren"), default="hash")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--no_flat_table", action="store_true",
                    help="hash family: the (L, T, F) table")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_step needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from .synth import train_setup

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip().splitlines()[0]
    tr, data = train_setup(args.family, device="cuda",
                           flat_table=not args.no_flat_table)
    state = tr.init_state(torch.Generator().manual_seed(0))
    for _ in range(2):
        tr.train_step(state, data, args.batch)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.steps):
        tr.train_step(state, data, args.batch)
    end.record()
    torch.cuda.synchronize()
    ms_per_step = start.elapsed_time(end) / args.steps

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            tr.train_step(state, data, args.batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    rec = {"family": args.family, "batch": args.batch, "steps": args.steps,
           "flat_table": not args.no_flat_table,
           "env": {k: v for k, v in sorted(os.environ.items())
                   if k.startswith("SPNERF_")},
           "ms_per_step": ms_per_step, "card": card}
    if not kernels:
        rec.update(device_busy_ms_per_step=None, idle_share=None,
                   kernels_per_step=None, top=None, classes=None)
    else:
        by_name, by_class = {}, {}
        for e in kernels:
            d = e.time_range.end - e.time_range.start
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + d)
            by_class[classify(e.name)] = by_class.get(classify(e.name),
                                                      0.0) + d
        busy = busy_us([(e.time_range.start, e.time_range.end)
                        for e in kernels])
        per = 1e3 * args.steps  # us over the window -> ms per step
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:args.top]
        rec.update(
            profiled_wall_ms_per_step=wall_us / per,
            device_busy_ms_per_step=busy / per,
            idle_share=1.0 - busy / wall_us,
            kernels_per_step=len(kernels) / args.steps,
            classes={c: t / per for c, t in sorted(by_class.items(),
                                                    key=lambda kv: -kv[1])},
            top=[{"name": name[:80], "ms_per_step": t / per,
                  "launches_per_step": n / args.steps}
                 for name, (n, t) in top])
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
