"""Validation during training: the single-AOI half of the JAX package's
`cli/train.py` (`predefined_val_ts`, `_val_metrics`, `_val_labels`,
`run_validation`).

`run_validation` renders every validation view through the eval renderer
(`render.build_render_fn`: B1 on CUDA in bf16), computes PSNR and SSIM on
the trainer's device, turns the predicted depth into a lat/lon/alt point
cloud and a DSM (splatted on the trainer's device), registers that DSM on
the lidar truth and logs the altitude MAE. As in the JAX package and the
reference, a failure of the MAE or of the image grid is printed and the
run goes on.

Not ported yet (ROADMAP A4, A5): the parser, `build_trainer_and_scene`,
`main`, the watchdog, and multi-AOI scenes.
"""

import os

import numpy as np
import torch

from ..evaluation.dsm import dsm_from_latlonalt
from ..evaluation.mae import compute_mae_and_save_dsm_diff
from ..evaluation.metrics import miou, overall_accuracy, psnr, ssim
from ..evaluation.outputs import save_nerf_output_to_images
from ..render import build_render_fn


def predefined_val_ts(img_id):
    """Transient-embedding index used at test time (reference eval.py:23-24)."""
    return 0


def _val_metrics(mean):
    """Checkpoint metrics dict from a validation summary. A NaN val_psnr
    (validation produced no val rows) would rank above real metrics;
    substitute -inf so metric-less saves never outrank real ones."""
    psnr_v = mean.get("psnr", float("nan"))
    if psnr_v != psnr_v:  # NaN
        psnr_v = float("-inf")
    return {"val_psnr": float(psnr_v)}


def _val_labels(items):
    """Per-item log labels for validation records (aoi_id, scene, record):
    an image id that repeats gets a frame index suffix so its rows stay
    distinguishable. Unique ids are unchanged."""
    frame_of, counts = {}, {}
    for _, sub, rec in items:
        frame_of.setdefault(id(sub), len(frame_of))
        counts[rec.img_id] = counts.get(rec.img_id, 0) + 1
    return [rec.img_id if counts[rec.img_id] == 1
            else f"{rec.img_id}.f{frame_of[id(sub)]}"
            for _, sub, rec in items]


def run_validation(trainer, scene, state, args, epoch, logger, save_images):
    """Render every validation image of `scene` (a `SatelliteScene`); log
    PSNR/SSIM/MAE (reference validation_step, main.py:188-299) and return
    their means over the test views.

    args: a namespace with aoi_id, gt_dir, logs_dir, chunk, sem and
    num_sem_classes (the training CLI's names). The field renders from
    `state` on the trainer's device."""
    if "," in args.aoi_id:
        raise NotImplementedError(
            "multi-AOI validation is not ported (ROADMAP A5)")
    device = trainer.device
    render = build_render_fn(state.model, trainer.rc, state.t_embed,
                             chunk=args.chunk)
    all_scalars = []
    items = [(args.aoi_id, scene, rec) for rec in scene.val_images]
    labels = _val_labels(items)
    for i, (aoi_id, sub_scene, rec) in enumerate(items):
        sample = sub_scene.load_val_image(rec, with_sem=args.sem)
        t = predefined_val_ts(rec.img_id)
        out = render(sample["rays"], t, sample.get("sems"))
        typ = "fine" if "rgb_fine" in out else "coarse"
        h, w = sample["h"], sample["w"]
        img_t = out[f"rgb_{typ}"].float().reshape(h, w, 3)
        gt_t = torch.as_tensor(sample["rgbs"], device=device).reshape(h, w, 3)
        psnr_v = float(psnr(img_t, gt_t))
        ssim_v = float(ssim(img_t, gt_t))
        out = {k: v.float().cpu().numpy() for k, v in out.items()}
        img = out[f"rgb_{typ}"].reshape(h, w, 3)
        gt = sample["rgbs"].reshape(h, w, 3)

        split = "train" if i == 0 else "val"  # image 0 is the train-debug view
        out_dir = os.path.join(args.logs_dir, split)
        mae_v = float("nan")
        try:
            depth = out[f"depth_{typ}"]
            lats, lons, alts = sub_scene.latlonalt_from_depth(sample["rays"],
                                                              depth)
            tmp_dsm = os.path.join(out_dir, "dsm",
                                   f"tmp_pred_dsm_{rec.img_id}.tif")
            os.makedirs(os.path.dirname(tmp_dsm), exist_ok=True)
            dsm_from_latlonalt(lats, lons, alts, dsm_path=tmp_dsm,
                               device=device)
            mae_v = compute_mae_and_save_dsm_diff(
                tmp_dsm, rec.img_id, aoi_id, args.gt_dir,
                os.path.join(out_dir, "dsm"), epoch, save=False,
            )
            os.remove(tmp_dsm)
        except Exception as exc:  # reference swallows MAE failures (main.py:272-287)
            print(f"MAE computation failed for {rec.img_id}: {exc}")

        if save_images:
            save_nerf_output_to_images(sub_scene, sample, out, out_dir, epoch,
                                       args.num_sem_classes, label=labels[i],
                                       device=device)

        # TensorBoard image grid: GT / prediction / depth (+ sem colors),
        # like reference main.py:221-250
        try:
            from ..evaluation.outputs import (
                convert_semantic_to_color,
                visualize_depth,
            )

            grid = [np.moveaxis(gt, -1, 0), np.moveaxis(img, -1, 0),
                    np.moveaxis(
                        visualize_depth(
                            out[f"depth_{typ}"].reshape(h, w)
                        ).astype(np.float32) / 255.0, -1, 0)]
            if f"sem_logits_{typ}" in out and "sems" in sample:
                pred_sem = np.argmax(out[f"sem_logits_{typ}"], -1).reshape(h, w)
                gt_sem = np.asarray(sample["sems"]).reshape(h, w)
                for sm in (gt_sem, pred_sem):
                    grid.append(np.moveaxis(
                        convert_semantic_to_color(
                            sm, args.num_sem_classes
                        ).astype(np.float32) / 255.0, -1, 0))
            logger.log_images(int(state.step),
                              f"{split}_{i}/GT_pred_depth_sems",
                              np.stack(grid))
        except Exception as exc:
            # image grids are best-effort, but never fail silently
            print(f"validation image grid failed for {rec.img_id}: {exc!r}")
        scalars = {"psnr": psnr_v, "ssim": ssim_v, "mae": mae_v}
        # semantic quality over the pixels with a ground-truth label (>= 0)
        if f"sem_logits_{typ}" in out and "sems" in sample:
            pred_sem = np.argmax(out[f"sem_logits_{typ}"], -1).ravel()
            gt_sem = np.asarray(sample["sems"]).ravel()
            labeled = gt_sem >= 0
            if labeled.any():
                scalars["miou"] = float(miou(pred_sem[labeled],
                                             gt_sem[labeled],
                                             args.num_sem_classes))
                scalars["oa"] = float(overall_accuracy(pred_sem[labeled],
                                                       gt_sem[labeled]))
        logger.log(int(state.step), scalars, split=f"{split}_{labels[i]}")
        if split == "val":
            all_scalars.append(scalars)
        sem_str = (f" miou {scalars['miou']:.3f} oa {scalars['oa']:.3f}"
                   if "miou" in scalars else "")
        print(f"[val e{epoch}] {labels[i]}: psnr {psnr_v:.2f} ssim {ssim_v:.3f} "
              f"mae {mae_v:.3f}{sem_str}")

    keys = ("psnr", "ssim", "mae") + (
        ("miou", "oa") if any("miou" in s for s in all_scalars) else ())
    mean = {k: float(np.nanmean([s[k] for s in all_scalars if k in s]))
            for k in keys} if all_scalars else {}
    if mean:
        logger.log(int(state.step), mean, split="val")
    return mean
