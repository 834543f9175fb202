"""Offline evaluation: the PyTorch version of the JAX package's
`cli/evaluate.py`, command-line compatible with `python eval.py ...`.

Walks the validation images a training run saved at one epoch
(logs/val/{dsm,rgb,semantic}/*_epoch{N}.tif) and computes for each: the DSM
altitude MAE (ROI crop, NCC registration, the offline NaN -> min fill), PSNR,
SSIM and LPIPS(alex) on `--device` (the card by default), mIoU and OA where
a semantic prediction was saved, and the residual-map PNGs. Prints the
per-image and mean metrics.

One departure from the JAX package: where matplotlib does not import,
`plot_residual_map` prints one line naming the two PNGs it did not write
and returns; the metrics, the rdsm file and the diff GeoTIFFs are
unchanged.
"""

import argparse
import os
import re

import numpy as np
import torch

from ..config import SEMANTIC_CONFIG
from ..device import resolve_device
from ..evaluation.lpips import lpips as lpips_fn
from ..evaluation.lpips import load_weights as load_lpips_weights
from ..evaluation.mae import dsm_pointwise_diff
from ..evaluation.metrics import miou, overall_accuracy, psnr, ssim
from ..io import read_geotiff
from ..utils.resize import resize_bilinear


def plot_residual_map(residual_map_path, src_id, output_dir, clip_percent=98):
    """Original and percentile-enhanced residual PNGs (reference
    eval.py:252-288); without matplotlib, one line naming them."""
    names = [os.path.join(output_dir, f"{src_id}_residual_map_{name}.png")
             for name in ("original", "enhanced")]
    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib is not installed: {' and '.join(names)} not "
              "written")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    residual, _ = read_geotiff(residual_map_path)
    residual = np.asarray(residual, np.float64)
    max_abs = np.nanmax(np.abs(residual))
    for out, cmap, vmin, vmax in (
        (names[0], "RdBu", -max_abs, max_abs),
        (names[1], "coolwarm",
         np.nanpercentile(residual, 100 - clip_percent),
         np.nanpercentile(residual, clip_percent)),
    ):
        plt.figure(figsize=(10, 8))
        plt.imshow(residual, cmap=cmap, vmin=vmin, vmax=vmax)
        plt.colorbar(label="")
        plt.axis("off")
        plt.savefig(out, dpi=300, bbox_inches="tight", pad_inches=0)
        plt.close()


def _load_rgb(path):
    arr, _ = read_geotiff(path)
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 2:
        arr = np.repeat(arr[:, :, None], 3, axis=2)
    if arr.max() > 1.05:
        arr = arr / 255.0
    return np.clip(arr, 0.0, 1.0)


def _semantic_metrics(pred_sem_path, gt_cls_path):
    """mIoU / OA of a saved semantic prediction against the dataset CLS tif.

    Both rasters carry the original DFC2019 class ids (the validation saver
    maps the port's indices back); both are mapped to indices through
    SEMANTIC_CONFIG's label_mapping and compared where the truth's class is
    in the table. The class count is the smallest table that holds every id
    of the prediction."""
    pred, _ = read_geotiff(pred_sem_path)
    gt, _ = read_geotiff(gt_cls_path)
    pred = np.asarray(pred).squeeze().astype(np.int64)
    gt = np.asarray(gt).squeeze().astype(np.int64)
    if gt.shape != pred.shape:
        # a prediction at a downscaled grid: nearest-neighbour the truth
        ri = (np.arange(pred.shape[0]) * gt.shape[0] / pred.shape[0]).astype(int)
        ci = (np.arange(pred.shape[1]) * gt.shape[1] / pred.shape[1]).astype(int)
        gt = gt[np.ix_(ri, ci)]
    n_classes = None
    for n, cfg in sorted(SEMANTIC_CONFIG.items()):
        if set(np.unique(pred)).issubset(set(cfg["label_mapping"]) | {65}):
            n_classes = n
            break
    if n_classes is None:
        n_classes = max(SEMANTIC_CONFIG)
    label_map = SEMANTIC_CONFIG[n_classes]["label_mapping"]
    remap = np.full(max(max(label_map), 65) + 1, -1, np.int64)
    for orig, internal in label_map.items():
        remap[orig] = internal
    pred_i = remap[np.clip(pred, 0, len(remap) - 1)]
    gt_i = remap[np.clip(gt, 0, len(remap) - 1)]
    labeled = gt_i >= 0
    if not labeled.any():
        return float("nan"), float("nan")
    return (float(miou(pred_i[labeled], gt_i[labeled], n_classes)),
            float(overall_accuracy(pred_i[labeled], gt_i[labeled])))


def eval_aoi(args):
    """Per-image and mean metrics of the run's saved outputs at
    args.epoch_number; args: project/exp paths as `main` derives them,
    dataset_dir, skip_lpips and device (None: the card)."""
    device = resolve_device(getattr(args, "device", None))
    pred_dsm_dir = os.path.join(args.logs_dir, "val", "dsm")
    pred_rgb_dir = os.path.join(args.logs_dir, "val", "rgb")
    pred_sem_dir = os.path.join(args.logs_dir, "val", "semantic")
    gt_dsm_dir = os.path.join(args.dataset_dir, "Truth")
    gt_rgb_base = os.path.join(args.dataset_dir, "RGB")
    epoch = args.epoch_number
    out_dir = os.path.join(args.output_dir, "dsm_diff")
    os.makedirs(out_dir, exist_ok=True)

    suffix = f"_epoch{epoch}.tif"
    files = sorted(f for f in os.listdir(pred_dsm_dir) if f.endswith(suffix))

    # fail loudly without LPIPS weights: averaging NaNs would misstate a
    # headline metric; --skip_lpips opts out
    compute_lpips = not getattr(args, "skip_lpips", False)
    if compute_lpips and load_lpips_weights() is None:
        raise SystemExit(
            "LPIPS weights not found: set SPNERF_LPIPS_WEIGHTS to an .npz of "
            "the spec in spnerf_torch.evaluation.lpips.weight_spec (the JAX "
            "package's convert_torch_lpips_to_npz writes one), or pass "
            "--skip_lpips to evaluate without the LPIPS metric."
        )

    stats = {"psnr": [], "ssim": [], "mae": [], "lpips": [], "miou": [],
             "oa": []}
    for fname in files:
        src_id = fname[: -len(suffix)]
        # views saved under a ".fN" frame-suffixed label carry the bare
        # image id in the dataset
        gt_id = re.sub(r"\.f\d+$", "", src_id)
        aoi_id = "_".join(gt_id.split("_")[:2])
        pred_dsm_path = os.path.join(pred_dsm_dir, fname)
        pred_rgb_path = os.path.join(pred_rgb_dir, f"{src_id}{suffix}")
        gt_dsm_path = os.path.join(gt_dsm_dir, f"{aoi_id}_DSM.tif")
        gt_roi_path = os.path.join(gt_dsm_dir, f"{aoi_id}_DSM.txt")
        gt_rgb_path = os.path.join(gt_rgb_base, aoi_id, f"{gt_id}.tif")
        missing = [p for p in (pred_rgb_path, gt_dsm_path, gt_roi_path,
                               gt_rgb_path) if not os.path.exists(p)]
        if missing:
            print(f"{src_id}: missing {missing}, skipped")
            continue

        diff_path = os.path.join(out_dir, f"{src_id}_rdsm_diff_epoch{epoch}.tif")
        rdsm_path = os.path.join(out_dir, f"{src_id}_rdsm_epoch{epoch}.tif")
        err = dsm_pointwise_diff(
            pred_dsm_path, gt_dsm_path, np.loadtxt(gt_roi_path),
            out_rdsm_path=rdsm_path, out_err_path=diff_path, nan_fill_min=True,
        )
        mae_v = float(np.mean(np.abs(err)))
        plot_residual_map(diff_path, src_id, out_dir)

        pred_rgb = _load_rgb(pred_rgb_path)
        gt_rgb = _load_rgb(gt_rgb_path)
        if gt_rgb.shape != pred_rgb.shape:
            # a run trained at img_downscale > 1: the truth to its grid
            gt_rgb = resize_bilinear(
                gt_rgb, pred_rgb.shape[0], pred_rgb.shape[1]
            ).astype(np.float32)
        pred_t = torch.from_numpy(pred_rgb).to(device)
        gt_t = torch.from_numpy(gt_rgb).to(device)
        psnr_v = float(psnr(pred_t, gt_t))
        ssim_v = float(ssim(pred_t, gt_t))
        lpips_v = (lpips_fn(pred_rgb, gt_rgb, device=device)
                   if compute_lpips else float("nan"))

        sem_str = ""
        pred_sem_path = os.path.join(pred_sem_dir, f"{src_id}{suffix}")
        gt_cls_path = os.path.join(args.dataset_dir, "Semantic",
                                   f"{aoi_id}_CLS.tif")
        if os.path.exists(pred_sem_path) and os.path.exists(gt_cls_path):
            miou_v, oa_v = _semantic_metrics(pred_sem_path, gt_cls_path)
            stats["miou"].append(miou_v)
            stats["oa"].append(oa_v)
            sem_str = f" / mIoU {miou_v:.3f} / OA {oa_v:.3f}"

        for k, v in (("psnr", psnr_v), ("ssim", ssim_v), ("mae", mae_v),
                     ("lpips", lpips_v)):
            stats[k].append(v)
        print(f"{src_id}: PSNR {psnr_v:.3f} / SSIM {ssim_v:.3f} / "
              f"LPIPS {lpips_v:.3f} / MAE {mae_v:.3f}{sem_str}")

    def _nmean(v):
        # an all-NaN column (lpips under --skip_lpips) stays NaN quietly
        a = np.asarray(v, dtype=float)
        return float(np.nanmean(a)) if a.size and np.isfinite(a).any() \
            else float("nan")

    print(f"\nMean PSNR: {_nmean(stats['psnr']):.3f}")
    print(f"Mean SSIM: {_nmean(stats['ssim']):.3f}")
    print(f"Mean MAE: {_nmean(stats['mae']):.3f}")
    print(f"Mean LPIPS: {_nmean(stats['lpips']):.3f}")
    if stats["miou"]:
        print(f"Mean mIoU: {_nmean(stats['miou']):.3f}")
        print(f"Mean OA: {_nmean(stats['oa']):.3f}")
    print()
    print("Eval finished!")
    return {k: _nmean(v) for k, v in stats.items()}


def build_test_parser():
    p = argparse.ArgumentParser(
        description="Evaluate SP-NeRF outputs (PyTorch/CUDA)")
    p.add_argument("--project_dir", type=str, required=True)
    p.add_argument("--exp_name", type=str, required=True)
    p.add_argument("--dataset_dir", type=str, required=True)
    p.add_argument("--epoch_number", type=int, default=28)
    p.add_argument("--skip_lpips", action="store_true",
                   help="evaluate without LPIPS (no weights available)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device of the metrics: the card by default; "
                        "'cpu' runs on the CPU")
    return p


def main(argv=None):
    args = build_test_parser().parse_args(argv)
    args.logs_dir = os.path.join(args.project_dir, "output", args.exp_name, "logs")
    args.output_dir = os.path.join(args.project_dir, "output", args.exp_name, "eval")
    return eval_aoi(args)


if __name__ == "__main__":
    main()
