"""Time the hash train step's table-gradient variants in turns on the card.

Usage (from the repository root, on a machine with a CUDA device):

    python -m spnerf_torch.utils.time_variants --rounds 5 --steps 10

The variants, all at the hash configuration of `train_setup("hash")`
(L8 F4 T=2^19, batch 1024):
  flat         the flat feature-major table, 3 B2 + 21 B3 per step;
  tlf          the (L, T, F) table, 3 B2 + 21 B3 on t-major cotangents;
  sw_acc0      the flat table with SPNERF_HASH_SW_ACC=0, 3 B2 + 21 B3′;
  tlf_batched  the (L, T, F) table with SPNERF_HASH_SW_BATCHED=1, 3 B4.
Each variant gets its own trainer, state (seed 0) and scene, and one
warm-up step. Then each of `--rounds` rounds runs every variant's `--steps`
steps in turn, each block timed with CUDA events, so the host's noise falls
on all variants alike. Prints one JSON line: per variant the median
ms/step, every block's ms/step, rays/s at the median, the kernel launches
of one step, the step's peak memory above what was allocated before it,
and the card's name and power limit.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

VARIANTS = {  # name: (flat table, env)
    "flat": (True, {}),
    "tlf": (False, {}),
    "sw_acc0": (True, {"SPNERF_HASH_SW_ACC": "0"}),
    "tlf_batched": (False, {"SPNERF_HASH_SW_BATCHED": "1"}),
}
ENV_NAMES = ("SPNERF_HASH_SW_ACC", "SPNERF_HASH_SW_BATCHED")


def set_env(env):
    """The variant's env, with the other variants' names cleared."""
    for name in ENV_NAMES:
        os.environ.pop(name, None)
    os.environ.update(env)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=1024)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("time_variants needs a CUDA device")
    from ..device import card_info
    from ..ops import dtab as dt
    from .synth import train_setup

    card = ", ".join(card_info())
    runs = {}
    for name, (flat, env) in VARIANTS.items():
        set_env(env)
        tr, data = train_setup("hash", device="cuda", flat_table=flat)
        state = tr.init_state(torch.Generator().manual_seed(0))
        tr.train_step(state, data, args.batch)  # warm-up
        for k in dt.launches:
            dt.launches[k] = 0
        tr.train_step(state, data, args.batch)
        torch.cuda.synchronize()
        runs[name] = {"trainer": tr, "data": data, "state": state,
                      "launches": dict(dt.launches), "ms": [], "peak": 0.0}
    for _ in range(args.rounds):
        for name, (_, env) in VARIANTS.items():
            set_env(env)
            r = runs[name]
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.steps):
                ld = r["trainer"].train_step(r["state"], r["data"], args.batch)
            end.record()
            torch.cuda.synchronize()
            if not np.isfinite(ld["loss"].item()):
                sys.exit(f"{name}: loss {ld['loss'].item()}")
            r["ms"].append(start.elapsed_time(end) / args.steps)
            r["peak"] = max(r["peak"],
                            (torch.cuda.max_memory_allocated() - base) / 1e9)
    set_env({})
    out = {"card": card, "batch": args.batch, "rounds": args.rounds,
           "steps_per_block": args.steps, "variants": {}}
    for name, r in runs.items():
        ms = float(np.median(r["ms"]))
        out["variants"][name] = {
            "ms_per_step": ms, "ms_per_step_blocks": r["ms"],
            "rays_per_s": args.batch / ms * 1e3, "launches": r["launches"],
            "step_peak_above_resident_gb": r["peak"]}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
