"""Dense-depth supervision made from a lidar DSM
(`spnerf_tpu/data/synth_depth.py`).

Depth supervision reads MicMac dense-stereo outputs (`{img_id}_2DPts.txt`,
`{img_id}_3DPts_ecef.txt`, `{img_id}_Correl.txt`), which an external MicMac
pipeline makes. Where those files are missing, this module writes files of
the same contract from the lidar DSM: for a grid of image pixels it meets
each pixel's RPC ray with the DSM surface by a fixed-point iteration on the
altitude (localize at the current altitude, look the DSM up at the ground
point, repeat) and keeps the pixels whose final point reprojects within a
pixel, with a correlation score from that reprojection error.

The geometry is what an ideal dense-stereo matcher would recover, so a run
supervised this way exercises the depth loss and guided sampling as MicMac
depth would. All of it is float64 numpy on the host.
"""

import os

import numpy as np

from ..geo import RPCModel
from ..geo.ellipsoid import geodetic_to_ecef
from ..geo.utm import latlon_to_utm
from ..io.jsonio import read_dict_from_json
from ..io.tiff import read_geotiff
from .micmac import utm_zone_for_aoi


def _dsm_lookup(dsm, xoff, yoff_top, res, easts, norths):
    """Nearest-neighbour altitude lookup; NaN outside the ROI."""
    cols = np.floor((easts - xoff) / res).astype(np.int64)
    rows = np.floor((yoff_top - norths) / res).astype(np.int64)
    ok = ((cols >= 0) & (cols < dsm.shape[1])
          & (rows >= 0) & (rows < dsm.shape[0]))
    alts = np.full(easts.shape, np.nan)
    alts[ok] = dsm[rows[ok], cols[ok]]
    return alts


def synthesize_depth_for_image(meta, dsm, roi, zone, northern, stride=2,
                               iters=6):
    """One image -> (pts2d (N, 2) int64 [col, row], pts3d_ecef (N, 3),
    correl (N,)).

    meta: the per-image JSON dict (rpc, width, height); dsm: (H, W) lidar
    altitudes; roi: (xoff, south yoff, size, res).
    """
    rpc = RPCModel.from_dict(meta["rpc"])
    xoff, yoff, size, res = [float(v) for v in roi]
    yoff_top = yoff + size * res

    cols, rows = np.meshgrid(
        np.arange(0, int(meta["width"]), stride, dtype=np.int64),
        np.arange(0, int(meta["height"]), stride, dtype=np.int64),
    )
    cols = cols.reshape(-1).astype(np.float64)
    rows = rows.reshape(-1).astype(np.float64)

    alts = np.full(cols.shape, float(np.nanmean(dsm)))
    lons = lats = None
    for _ in range(iters):
        lons, lats = rpc.localization(cols, rows, alts)
        easts, norths, _, _ = latlon_to_utm(lats, lons, zone, northern)
        new_alts = _dsm_lookup(dsm, xoff, yoff_top, res, easts, norths)
        alts = np.where(np.isfinite(new_alts), new_alts, alts)
    easts, norths, _, _ = latlon_to_utm(lats, lons, zone, northern)
    valid = np.isfinite(_dsm_lookup(dsm, xoff, yoff_top, res, easts, norths))
    # at surface discontinuities (building edges) the iteration oscillates
    # between roof and ground: keep the points that reproject onto their
    # pixel, as a stereo matcher rejects low-correlation pixels
    pc, pr = rpc.projection(lons, lats, alts)
    reproj_err = np.hypot(pc - cols, pr - rows)
    valid &= reproj_err < 1.0
    x, y, z = geodetic_to_ecef(lats[valid], lons[valid], alts[valid])
    pts2d = np.stack([cols[valid], rows[valid]], axis=-1).astype(np.int64)
    pts3d = np.stack([x, y, z], axis=-1)
    # a matcher's confidence, 100 at a perfect reprojection; the scene
    # loader's depth std model reads it
    correl = 100.0 * (1.0 - reproj_err[valid])
    return pts2d, pts3d, correl


def synthesize_depth_from_lidar(json_dir, gt_dir, aoi_id, out_depth_dir,
                                stride=2, verbose=True):
    """Write the MicMac-contract depth files of every train image; returns
    the image ids written."""
    os.makedirs(out_depth_dir, exist_ok=True)
    dsm, _ = read_geotiff(os.path.join(gt_dir, f"{aoi_id}_DSM.tif"))
    dsm = np.asarray(dsm, np.float64)
    if dsm.ndim == 3:
        dsm = dsm[..., 0]
    roi = np.loadtxt(os.path.join(gt_dir, f"{aoi_id}_DSM.txt"))
    zone, northern = utm_zone_for_aoi(aoi_id)

    with open(os.path.join(json_dir, "train.txt")) as f:
        names = [ln.strip() for ln in f if ln.strip()]
    written = []
    for name in names:
        meta = read_dict_from_json(os.path.join(json_dir, name))
        img_id = os.path.splitext(meta["img"])[0]
        pts2d, pts3d, correl = synthesize_depth_for_image(
            meta, dsm, roi, zone, northern, stride=stride)
        np.savetxt(os.path.join(out_depth_dir, f"{img_id}_2DPts.txt"),
                   pts2d, fmt="%d")
        np.savetxt(os.path.join(out_depth_dir, f"{img_id}_3DPts_ecef.txt"),
                   pts3d)
        np.savetxt(os.path.join(out_depth_dir, f"{img_id}_Correl.txt"),
                   correl)
        written.append(img_id)
        if verbose:
            print(f"synthesized {len(pts2d)} depth points for {img_id}")
    return written
