"""MicMac dense-depth helpers (`spnerf_tpu/data/micmac.py`).

* `utm_to_geocentric` / `convert_3dpts_file`: MicMac `*_3DPts.txt` UTM
  points to ECEF (`*_3DPts_ecef.txt`), the file `load_scene` reads, with the
  UTM zone of the AOI's city (`AOI_UTM_ZONES`).
* `dense_depth_to_dsm` / `cal_rmse_depth`: the depth points splatted into a
  DSM on the lidar ROI's grid and scored against the lidar DSM, the check
  that stereo depth is good enough to supervise. The splat runs on `device`
  (`evaluation/dsm.py`, one `index_add_`): the card unless the caller asks
  for the CPU.
* `convert_tiff`: a GeoTIFF re-encoded as uncompressed striped TIFF, which
  MicMac reads.

Everything but the splat is float64 numpy on the host. The MicMac `mm3d`
binaries are external programs; their text outputs are the input contract.
"""

import os

import numpy as np

from ..geo import ecef_to_latlon, geodetic_to_ecef
from ..geo.utm import utm_to_latlon
from ..io import read_geotiff, write_geotiff

# the UTM zones of the DFC2019 cities
AOI_UTM_ZONES = {
    "JAX": (17, True),   # Jacksonville: zone 17N
    "OMA": (15, True),   # Omaha: zone 15N
}


def utm_zone_for_aoi(aoi_id):
    key = aoi_id.split("_")[0]
    if key not in AOI_UTM_ZONES:
        raise KeyError(f"unknown AOI prefix {key}; add it to AOI_UTM_ZONES")
    return AOI_UTM_ZONES[key]


def utm_to_geocentric(pts_utm, zone, northern=True):
    """(N, 3) [east, north, alt] UTM -> (N, 3) ECEF metres."""
    pts = np.asarray(pts_utm, np.float64)
    lat, lon = utm_to_latlon(pts[:, 0], pts[:, 1], zone, northern)
    x, y, z = geodetic_to_ecef(lat, lon, pts[:, 2])
    return np.stack([x, y, z], axis=-1)


def convert_3dpts_file(in_path, out_path=None, aoi_id=None, zone=None,
                       northern=True):
    """`*_3DPts.txt` (UTM) -> `*_3DPts_ecef.txt` (or `out_path`)."""
    if zone is None:
        zone, northern = utm_zone_for_aoi(aoi_id)
    pts = np.loadtxt(in_path, dtype=np.float64).reshape(-1, 3)
    ecef = utm_to_geocentric(pts, zone, northern)
    if out_path is None:
        base, ext = os.path.splitext(in_path)
        out_path = base + "_ecef" + ext
    np.savetxt(out_path, ecef, fmt="%.6f")
    return out_path


def dense_depth_to_dsm(pts3d_ecef, roi_txt, dsm_path=None, device=None):
    """ECEF depth points -> (DSM on the lidar ROI grid, grid), splatted on
    `device`."""
    from ..evaluation.dsm import dsm_from_latlonalt

    pts = np.asarray(pts3d_ecef, np.float64)
    lat, lon, alt = ecef_to_latlon(pts[:, 0], pts[:, 1], pts[:, 2])
    return dsm_from_latlonalt(lat, lon, alt, roi_txt=roi_txt,
                              dsm_path=dsm_path, device=device)


def cal_rmse_depth(pts3d_ecef_path, gt_dir, aoi_id, out_dir=None,
                   device=None):
    """MAE and RMSE (m) of the depth points' DSM against the lidar DSM, and
    the share of ROI cells the points cover."""
    roi_txt = os.path.join(gt_dir, f"{aoi_id}_DSM.txt")
    gt_path = os.path.join(gt_dir, f"{aoi_id}_DSM.tif")
    pts = np.loadtxt(pts3d_ecef_path, dtype=np.float64).reshape(-1, 3)
    dsm, _ = dense_depth_to_dsm(
        pts, roi_txt,
        dsm_path=os.path.join(out_dir, f"{aoi_id}_depth_dsm.tif")
        if out_dir else None, device=device)
    gt, _ = read_geotiff(gt_path)
    diff = dsm - np.asarray(gt, np.float64)
    return {"mae": float(np.nanmean(np.abs(diff))),
            "rmse": float(np.sqrt(np.nanmean(diff ** 2))),
            "coverage": float(np.isfinite(dsm).mean())}


def convert_tiff(in_path, out_path):
    """Re-encode a GeoTIFF as plain uncompressed striped TIFF."""
    arr, profile = read_geotiff(in_path)
    write_geotiff(out_path, np.asarray(arr), profile=profile)
    return out_path
