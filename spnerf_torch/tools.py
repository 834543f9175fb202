"""Helper and run tools: the subcommands of the JAX package's `tools.py`.

`python -m spnerf_torch.tools <subcommand>`:

  utm-to-geocentric  MicMac *_3DPts.txt (UTM) -> *_3DPts_ecef.txt
  convert-tiff       GeoTIFF -> MicMac-compatible uncompressed TIFF
  cal-rmse-depth     MAE/RMSE of MicMac input depth against the lidar DSM;
                     the DSM splat runs on the card unless --device cpu
  viz-depth-in       sparse input depth: raw, over the image, side by side
  viz-dsm            DSM GeoTIFF -> viridis PNG
  render             render every validation view (and its DSM, depth, sun,
                     albedo and semantic outputs) from a saved checkpoint: it
                     reads the run's opts.json, rebuilds the trainer and the
                     scene, restores --step best|latest|N and runs
                     `run_validation`, which renders through the fused field
                     kernel (B1) on the card, placing the samples by the
                     checkpoint's occupancy grid where the run has one.
                     `python eval_torch.py` can then score the outputs.
  summarize-runs     one table over training runs: the encoding, the last
                     step, the median logged rays/s and each view's newest
                     validation PSNR/SSIM/MAE (from logs/metrics.jsonl).

The viz subcommands draw with matplotlib; where it does not import they
name the PNGs they skip. The JAX package's `warm-cache` fills XLA's
compilation cache and has no counterpart here.
"""

import argparse
import glob
import json
import os
import sys


def _cmd_utm_to_geocentric(args):
    from .data.micmac import convert_3dpts_file

    if args.file:
        files = list(args.file)
    else:
        files = sorted(glob.glob(os.path.join(args.file_dir, "*_3DPts.txt")))
        if not files:
            sys.exit(f"no *_3DPts.txt under {args.file_dir}")
    outs = []
    for f in files:
        outs.append(convert_3dpts_file(f, aoi_id=args.aoi_id, zone=args.zone,
                                       northern=not args.south))
        print(f"{f} -> {outs[-1]}")
    return outs


def _cmd_convert_tiff(args):
    from .data.micmac import convert_tiff

    os.makedirs(args.out_dir, exist_ok=True)
    outs = []
    for f in args.input:
        outs.append(convert_tiff(f, os.path.join(args.out_dir,
                                                 os.path.basename(f))))
        print(f"{f} -> {outs[-1]}")
    return outs


def _cmd_cal_rmse_depth(args):
    from .data.micmac import cal_rmse_depth
    from .device import resolve_device

    device = resolve_device(args.device)
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
    stats = cal_rmse_depth(args.pts3d_ecef, args.gt_dir, args.aoi_id,
                           out_dir=args.out_dir, device=device)
    print(json.dumps(stats))
    return stats


def _cmd_viz_depth_in(args):
    from .visualization.depth import visualize_depth_points

    depth = visualize_depth_points(args.pts2d, args.pts3d, args.image,
                                   args.out_prefix)
    if os.path.exists(f"{args.out_prefix}_raw.png"):
        print(f"wrote {args.out_prefix}_{{raw,overlay,side_by_side}}.png")
    return depth


def _cmd_viz_dsm(args):
    from .visualization.depth import visualize_dsm

    out = visualize_dsm(args.dsm, args.output)
    if out is not None:
        print(f"wrote {out}")
    return out


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
        description="SP-NeRF helper and run tools (PyTorch/CUDA)")
    sub = p.add_subparsers(dest="command", required=True)

    u = sub.add_parser("utm-to-geocentric",
                       help="MicMac *_3DPts.txt (UTM) -> *_3DPts_ecef.txt")
    u.add_argument("--file_dir", type=str,
                   help="directory of *_3DPts.txt files")
    u.add_argument("--file", type=str, nargs="*",
                   help="explicit file list (alternative to --file_dir)")
    u.add_argument("--aoi_id", type=str,
                   help="AOI id whose city prefix selects the UTM zone "
                        "(e.g. JAX_269)")
    u.add_argument("--zone", type=int, default=None,
                   help="explicit UTM zone (overrides --aoi_id)")
    u.add_argument("--south", action="store_true",
                   help="southern hemisphere (default northern)")
    u.set_defaults(fn=_cmd_utm_to_geocentric)

    c = sub.add_parser("convert-tiff",
                       help="re-encode GeoTIFFs MicMac-compatibly")
    c.add_argument("input", type=str, nargs="+")
    c.add_argument("--out_dir", type=str, required=True)
    c.set_defaults(fn=_cmd_convert_tiff)

    r = sub.add_parser("cal-rmse-depth",
                       help="score MicMac input depth against the lidar DSM")
    r.add_argument("--pts3d_ecef", type=str, required=True)
    r.add_argument("--gt_dir", type=str, required=True,
                   help="directory with <aoi>_DSM.{tif,txt}")
    r.add_argument("--aoi_id", type=str, required=True)
    r.add_argument("--out_dir", type=str, default=None,
                   help="optionally save the rasterized depth DSM here")
    r.add_argument("--device", type=str, default=None,
                   help="torch device of the DSM splat: the card by "
                        "default; 'cpu' runs on the CPU")
    r.set_defaults(fn=_cmd_cal_rmse_depth)

    vi = sub.add_parser("viz-depth-in",
                        help="visualize sparse input depth on the image")
    vi.add_argument("--pts2d", type=str, required=True)
    vi.add_argument("--pts3d", type=str, required=True)
    vi.add_argument("--image", type=str, required=True)
    vi.add_argument("--out_prefix", type=str, required=True)
    vi.set_defaults(fn=_cmd_viz_depth_in)

    vo = sub.add_parser("viz-dsm", help="DSM GeoTIFF -> viridis PNG")
    vo.add_argument("dsm", type=str)
    vo.add_argument("output", type=str)
    vo.set_defaults(fn=_cmd_viz_dsm)

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
    if (args.command == "utm-to-geocentric" and args.zone is None
            and not args.aoi_id):
        sys.exit("utm-to-geocentric needs --aoi_id or --zone")
    if (args.command == "utm-to-geocentric" and not args.file
            and not args.file_dir):
        sys.exit("utm-to-geocentric needs --file_dir or --file")
    return args.fn(args)


if __name__ == "__main__":
    main()
