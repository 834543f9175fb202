"""The readings a cell's correctness limits are set from, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control_seeds 7,8,9] [--out <file.json>]

For each of --seeds, the program's numbers from a run of the cell (a window
of one step or one view; the numbers do not depend on its length). For
each of --control_seeds, the control's numbers: the reference computed one
precision step below the configuration's in the program's place, judged
by the reference at the configuration's precision; and in training cells
the numbers of a fault planted in that reference, each step's loss taken
over half its batch. The lower reading of a number is the largest over the
program's seeds, the upper the smallest over the control's (and the
faults'). Runs on the card; the numbers go to standard output and --out.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def control_train(cell, seed, device):
    """{variant: numbers} of the control and the half-batch fault."""
    from benchmark import check, harness, traffic

    cfg, family = cell.config, cell.family
    weights = family.make_weights(cfg["model"], seed, device)
    classes = family.label_classes(cfg["model"])
    scene = traffic.make_scene(cell.traffic, classes, seed, device)
    dtype = cfg["render"]["compute_dtype"]
    ref = harness.train_reference(cell, weights, scene, seed, dtype)
    out = {}
    for name, kw in (("control", dict(precision=family.LOWER[dtype])),
                     ("half_batch", dict(precision=dtype, half_batch=True))):
        got = harness.train_reference(cell, weights, scene, seed, **kw)
        out[name] = check.train_numbers(got, ref, weights)
    return out


def control_render(cell, seed, device):
    """{"control": numbers} on the sample a one-view run checks."""
    from benchmark import check, harness, traffic

    cfg, mix, family = cell.config, cell.traffic, cell.family
    weights = family.make_weights(cfg["model"], seed, device)
    views = traffic.make_views(mix, family.label_classes(cfg["model"]), seed,
                               device)
    placeholder = [{"rgb": views[0][0][:, :1].cpu()}]
    _, rays, sems = harness.render_sample(placeholder, views, seed,
                                          int(mix["check_rays"]))
    dtype = cfg["render"]["compute_dtype"]
    ref = family.reference_eval_rows(cfg, weights, rays, sems, dtype)
    low = family.reference_eval_rows(cfg, weights, rays, sems,
                                     family.LOWER[dtype])
    return {"control": check.render_numbers(low, ref)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control_seeds", type=seeds, default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness, spec

    if not torch.cuda.is_available():
        sys.exit("calibrate: no CUDA device")
    device = torch.device("cuda:0")
    cell = spec.load_cell(args.workload)
    rec = {"workload": cell.name, "program": {}, "control": {}}
    for s in args.seeds:
        t = time.perf_counter()
        out = harness.run_cell(cell, s, 0.0, 0, device)
        rec["program"][s] = out["readings"]
        print(json.dumps({"seed": s, "side": "program",
                          "numbers": rec["program"][s],
                          "s": time.perf_counter() - t}), flush=True)
    run = control_train if cell.traffic["kind"] == "train" else control_render
    for s in args.control_seeds:
        t = time.perf_counter()
        rec["control"][s] = run(cell, s, device)
        print(json.dumps({"seed": s, "side": "control",
                          "numbers": rec["control"][s],
                          "s": time.perf_counter() - t}), flush=True)
        harness.free(device)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1))


if __name__ == "__main__":
    main()
