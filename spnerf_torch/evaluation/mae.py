"""DSM accuracy: crop to the lidar ROI, register, and compute the altitude MAE.

The GDAL-free chain of `spnerf_tpu/evaluation/mae.py`, after the reference
SP-NeRF's (`modules/utils.py:142-245`, `eval.py:144-249`):

  1. crop the predicted DSM GeoTIFF to the ROI bbox (the reference shells out to
     gdal.Translate projWin; here the crop is a window read computed from the
     raster geotransform);
  2. register to the lidar DSM with the multiscale NCC
     (`spnerf_torch.evaluation.registration`); on failure fall back to the
     mean-Z shift like the reference does when dsmr is unavailable;
  3. error map = registered - ground truth; MAE = nanmean(|err|).
"""

import os

import numpy as np

from ..io import read_geotiff, write_geotiff
from . import registration


def crop_to_roi(arr, transform, xoff, yoff_top, xsize, ysize, resolution):
    """Window-read [xoff, yoff_top] .. +size from a north-up raster, NaN-padding
    outside coverage. transform: (x0, xres, y0, yres<0)."""
    x0, xres, y0, yres = transform
    col0 = int(round((xoff - x0) / xres))
    row0 = int(round((yoff_top - y0) / yres))  # yres < 0
    out = np.full((ysize, xsize), np.nan, dtype=np.float64)
    src_r0, src_c0 = max(0, row0), max(0, col0)
    src_r1 = min(arr.shape[0], row0 + ysize)
    src_c1 = min(arr.shape[1], col0 + xsize)
    if src_r1 > src_r0 and src_c1 > src_c0:
        out[src_r0 - row0: src_r1 - row0, src_c0 - col0: src_c1 - col0] = arr[
            src_r0:src_r1, src_c0:src_c1
        ]
    return out


def dsm_pointwise_diff(
    pred_dsm_path,
    gt_dsm_path,
    roi_metadata,
    gt_mask_path=None,
    out_rdsm_path=None,
    out_err_path=None,
    nan_fill_min=False,
):
    """Error map between predicted and lidar DSM after NCC registration.

    roi_metadata: (xoff, yoff_south, size_px, resolution) from {aoi}_DSM.txt.
    """
    xoff, yoff = float(roi_metadata[0]), float(roi_metadata[1])
    xsize = ysize = int(roi_metadata[2])
    resolution = float(roi_metadata[3])
    yoff_top = yoff + ysize * resolution

    pred, pred_profile = read_geotiff(pred_dsm_path)
    pred = np.asarray(pred, np.float64)
    if pred_profile.get("nodata") is not None and not np.isnan(pred_profile["nodata"]):
        pred[pred == pred_profile["nodata"]] = np.nan
    transform = pred_profile.get("transform")
    if transform is None:
        raise ValueError(f"{pred_dsm_path} has no geotransform")
    pred_crop = crop_to_roi(pred, transform, xoff, yoff_top, xsize, ysize, resolution)

    gt, gt_profile = read_geotiff(gt_dsm_path)
    gt = np.asarray(gt, np.float64)
    if gt.shape != pred_crop.shape:
        # the lidar raster is exactly the ROI window in the DFC2019 layout; if it
        # carries its own transform, crop it the same way
        if gt_profile.get("transform") is not None:
            gt = crop_to_roi(gt, gt_profile["transform"], xoff, yoff_top,
                             xsize, ysize, resolution)
        else:
            raise ValueError("GT DSM shape mismatch and no transform to crop by")

    if gt_mask_path is not None:
        mask, _ = read_geotiff(gt_mask_path)
        pred_crop[np.asarray(mask) == 9] = np.nan  # water class

    try:
        dx, dy, a, b = registration.compute_shift(gt, pred_crop, scaling=False)
        pred_r = registration.apply_shift(pred_crop, dx, dy, a, b)
    except Exception as exc:  # mean-Z fallback (reference eval.py:223-232)
        print(f"NCC registration failed ({exc}); falling back to mean-Z shift")
        pred_r = pred_crop + np.nanmean(gt - pred_crop)

    if nan_fill_min:
        # offline-eval variant: NaNs replaced by the global min altitude before
        # differencing (reference eval.py:234-237); the in-training variant
        # keeps NaNs and uses nanmean instead (modules/utils.py:209,245)
        fill = min(np.nanmin(pred_r), np.nanmin(gt))
        pred_r = np.nan_to_num(pred_r, nan=fill)
        gt = np.nan_to_num(gt, nan=fill)

    err = pred_r - gt
    out_transform = (xoff, resolution, yoff_top, -resolution)
    if out_rdsm_path is not None:
        write_geotiff(out_rdsm_path, pred_r.astype(np.float32),
                      transform=out_transform, epsg=pred_profile.get("epsg"),
                      nodata=float("nan"))
    if out_err_path is not None:
        write_geotiff(out_err_path, err.astype(np.float32),
                      transform=out_transform, epsg=pred_profile.get("epsg"),
                      nodata=float("nan"))
    return err


def compute_mae_and_save_dsm_diff(
    pred_dsm_path, src_id, aoi_id, gt_dir, out_dir, epoch_number, save=True
):
    """MAE against {gt_dir}/{aoi}_DSM.tif within {aoi}_DSM.txt ROI
    (reference modules/utils.py:229-245)."""
    gt_dsm_path = os.path.join(gt_dir, f"{aoi_id}_DSM.tif")
    gt_roi_path = os.path.join(gt_dir, f"{aoi_id}_DSM.txt")
    for path in (gt_roi_path, gt_dsm_path):
        if not os.path.exists(path):
            raise FileNotFoundError(f"{path} not found")

    roi = np.loadtxt(gt_roi_path)
    rdsm_path = os.path.join(out_dir, f"{src_id}_rdsm_epoch{epoch_number}.tif")
    diff_path = os.path.join(out_dir, f"{src_id}_rdsm_diff_epoch{epoch_number}.tif")
    os.makedirs(out_dir, exist_ok=True)
    err = dsm_pointwise_diff(
        pred_dsm_path, gt_dsm_path, roi,
        out_rdsm_path=rdsm_path if save else None,
        out_err_path=diff_path if save else None,
    )
    return float(np.nanmean(np.abs(err)))
