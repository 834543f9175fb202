"""Run tools: the `render` and `summarize-runs` subcommands of the JAX
package's `tools.py`.

`python -m spnerf_torch.tools <subcommand>`:

  render          render every validation view (and its DSM, depth, sun,
                  albedo and semantic outputs) from a saved checkpoint: it
                  reads the run's opts.json, rebuilds the trainer and the
                  scene, restores --step best|latest|N and runs
                  `run_validation`, which renders through the fused field
                  kernel (B1) on the card, placing the samples by the
                  checkpoint's occupancy grid where the run has one.
                  `python eval_torch.py` can then score the outputs.
  summarize-runs  one table over training runs: the encoding, the last
                  step, the median logged rays/s and each view's newest
                  validation PSNR/SSIM/MAE (from logs/metrics.jsonl).

The data-preparation and visualisation subcommands are not ported yet
(ROADMAP A7).
"""

import argparse
import glob
import json
import os
import sys


def _cmd_render(args):
    from argparse import Namespace

    import torch

    from .cli.train import build_trainer_and_scene, run_validation
    from .device import resolve_device
    from .train.checkpoints import CheckpointManager
    from .utils.logging import MetricLogger

    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)  # B1 launches on the current card
    opts_path = os.path.join(args.run_dir, "logs", "opts.json")
    if not os.path.exists(opts_path):
        sys.exit(f"no {opts_path} — --run_dir must be a training output dir "
                 "(<project>/output/<exp_name>)")
    with open(opts_path) as f:
        rargs = Namespace(**json.load(f))
    if args.dataset_dir:
        # the dataset moved since training: derive the per-kind dirs as
        # finalize_args does
        rargs.dataset_dir = args.dataset_dir
        rargs.depth_dir = os.path.join(args.dataset_dir, "Depth")
        rargs.json_dir = os.path.join(args.dataset_dir, "JSON")
        rargs.img_dir = os.path.join(args.dataset_dir, "RGB", rargs.aoi_id)
        rargs.sem_dir = os.path.join(args.dataset_dir, "Semantic")
        rargs.gt_dir = os.path.join(args.dataset_dir, "Truth")
    if args.chunk:
        rargs.chunk = args.chunk
    if args.img_downscale:
        # the field is resolution-independent: rays come from the RPC at
        # the requested scale, the normalisation from the recorded scene.loc
        rargs.img_downscale = float(args.img_downscale)
    if args.n_samples:
        rargs.n_samples = int(args.n_samples)
    if args.out_dir:
        rargs.logs_dir = args.out_dir
    os.makedirs(rargs.logs_dir, exist_ok=True)

    trainer, scene, steps_per_epoch = build_trainer_and_scene(rargs, device)
    state = trainer.init_state()
    ckpt = CheckpointManager(os.path.join(args.run_dir, "ckpts"))
    if args.step is None or args.step == "latest":
        step = ckpt.latest_step()
    elif args.step == "best":
        step = ckpt.best_step()
        if step is None:
            sys.exit("no checkpoint carries a val_psnr metric — "
                     "use --step latest or a numeric step")
    else:
        try:
            step = int(args.step)
        except ValueError:
            sys.exit(f"--step must be an integer, 'best' or 'latest' "
                     f"(got {args.step!r})")
    if step is None:
        sys.exit(f"no checkpoints under {args.run_dir}/ckpts")
    if ckpt.restore(state, step=step) is None:
        sys.exit(f"checkpoint step {step} not found; "
                 f"available: {ckpt.all_steps()}")
    epoch = (args.epoch_number if args.epoch_number is not None
             else state.step // max(steps_per_epoch, 1))
    logger = MetricLogger(rargs.logs_dir, tensorboard=False)
    mean = run_validation(trainer, scene, state, rargs, epoch, logger,
                          save_images=True)
    logger.close()
    print(json.dumps({"step": state.step, "epoch_number": epoch,
                      **{k: round(v, 4) for k, v in mean.items()}}))
    return {"step": state.step, "epoch_number": epoch, **mean}


def _cmd_summarize_runs(args):
    """Per run dir: the recorded encoding, the last train step, the median
    logged rays/s (the first window pays the warm-up, so the median) and
    each view's newest validation metrics."""
    import numpy as np

    rows = []
    run_dirs = []
    for d in args.run_dir:
        mpath = os.path.join(d, "logs", "metrics.jsonl")
        if os.path.exists(mpath):
            run_dirs.append(d)
        else:
            run_dirs.extend(sorted(
                p for p in glob.glob(os.path.join(d, "*"))
                if os.path.exists(os.path.join(p, "logs", "metrics.jsonl"))))
    for d in run_dirs:
        name = os.path.basename(os.path.normpath(d))
        opts = {}
        opath = os.path.join(d, "logs", "opts.json")
        if os.path.exists(opath):
            with open(opath) as f:
                opts = json.load(f)
        last_step, rays, finals = 0, [], {}
        with open(os.path.join(d, "logs", "metrics.jsonl")) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                split = rec.get("split", "")
                step = int(rec.get("step", 0))
                if split == "train":
                    last_step = max(last_step, step)
                    if "rays_per_sec" in rec:
                        rays.append(float(rec["rays_per_sec"]))
                elif split.startswith("val_"):
                    view = split[4:]
                    if step >= finals.get(view, (0, None))[0]:
                        finals[view] = (step, rec)
        rate = float(np.median(rays)) if rays else float("nan")
        row = {"run": name, "steps": last_step, "rays_per_sec": round(rate),
               "encoding": opts.get("encoding", "?"),
               "views": {}}
        for view, (step, rec) in sorted(finals.items()):
            row["views"][view] = {k: round(float(rec[k]), 3)
                                  for k in ("psnr", "ssim", "mae")
                                  if k in rec and np.isfinite(rec[k])}
        rows.append(row)
    if args.json:
        print(json.dumps(rows))
        return rows

    def _view_label(v):
        # "JAX_269_011_RGB" -> "011", keeping a ".fN" frame suffix; the full
        # name for ids of fewer than two '_'-separated parts
        parts = v.split("_")
        if len(parts) < 2:
            return v
        label = parts[-2]
        if "." in parts[-1]:
            label += parts[-1][parts[-1].index("."):]
        return label

    for row in rows:
        views = "  ".join(
            f"{_view_label(v)}: "
            + "/".join(str(m.get(k, "—")) for k in ("psnr", "ssim", "mae"))
            for v, m in row["views"].items())
        print(f"{row['run']:<16} {row['encoding']:<6} "
              f"step {row['steps']:<6} {row['rays_per_sec']:>7,} rays/s  "
              f"{views}")
    return rows


def build_parser():
    p = argparse.ArgumentParser(
        prog="python -m spnerf_torch.tools",
        description="SP-NeRF run tools (PyTorch/CUDA)")
    sub = p.add_subparsers(dest="command", required=True)

    rd = sub.add_parser(
        "render",
        help="render validation views + DSM from a saved checkpoint")
    rd.add_argument("--run_dir", type=str, required=True,
                    help="training output dir: <project>/output/<exp_name>")
    rd.add_argument("--step", type=str, default=None,
                    help="checkpoint step to restore: a step number, 'best' "
                         "(highest recorded val_psnr) or 'latest' (default)")
    rd.add_argument("--epoch_number", type=int, default=None,
                    help="epoch label in output filenames (default: "
                         "step // steps_per_epoch, the label training would "
                         "have used)")
    rd.add_argument("--chunk", type=int, default=None,
                    help="override the recorded render chunk size")
    rd.add_argument("--img_downscale", type=float, default=None,
                    help="render at this downscale instead of the training "
                         "one")
    rd.add_argument("--n_samples", type=int, default=None,
                    help="coarse samples per ray at render time")
    rd.add_argument("--dataset_dir", type=str, default=None,
                    help="override the recorded dataset location "
                         "(relocated runs)")
    rd.add_argument("--out_dir", type=str, default=None,
                    help="write logs/{val,train}/... outputs here instead "
                         "of the run's own logs dir")
    rd.add_argument("--device", type=str, default=None,
                    help="torch device: the card by default; 'cpu' runs on "
                         "the CPU")
    rd.set_defaults(fn=_cmd_render)

    sr = sub.add_parser(
        "summarize-runs",
        help="tabulate throughput + final per-view validation metrics "
             "across training run dirs (reads logs/metrics.jsonl)")
    sr.add_argument("run_dir", nargs="+",
                    help="run dirs (<project>/output/<exp>) or a parent "
                         "output/ dir to scan")
    sr.add_argument("--json", action="store_true",
                    help="machine-readable output")
    sr.set_defaults(fn=_cmd_summarize_runs)
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
