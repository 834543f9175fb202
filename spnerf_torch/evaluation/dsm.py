"""DSM extraction: UTM point cloud -> gridded Digital Surface Model.

The rasterizer of `spnerf_tpu/evaluation/dsm.py` (which replaces the
reference SP-NeRF's `plyflatten`, called with radius=1, sigma=inf):

  * each point lands in cell (col, row) = (floor((x-xoff)/res), floor((yoff-y)/res));
  * with radius r it contributes to the (2r+1)^2 neighborhood of that cell with
    Gaussian weights exp(-d^2 / (2 sigma^2)) — sigma=inf gives uniform weights,
    so each cell is the plain average of contributing points (the reference's
    configuration);
  * empty cells are NaN (plyflatten behavior).

The splat runs on the device as one `index_add_` of (weight * altitude,
weight) pairs over all (2r+1)^2 neighbour offsets, where the JAX package
runs one `segment_sum` per offset. On CUDA the sums use float atomics, so a
cell's value is not bitwise repeatable; which cells are empty is.
"""

import numpy as np
import torch

from ..device import resolve_device
from ..geo import latlon_to_utm
from ..geo.utm import utm_epsg
from ..io import write_geotiff


def rasterize_dsm(
    easts,
    norths,
    alts,
    xoff,
    yoff,
    resolution,
    xsize: int,
    ysize: int,
    radius: int = 1,
    sigma: float = np.inf,
    device=None,
):
    """Average-splat rasterization on `device`. Returns a (ysize, xsize)
    float32 tensor on the device, NaN in empty cells.

    The origin subtraction happens in float64 on the host: UTM northings near
    the DFC2019 scenes are ~3.4e6 m, where float32 spacing (~0.25-0.5 m) is
    comparable to the 0.5 m cell size — casting before subtracting would move
    points one row/column. Only the small origin-relative fractional
    coordinates go to the float32 device splat, as in the JAX package.
    """
    device = resolve_device(device)
    easts = np.asarray(easts, np.float64)
    norths = np.asarray(norths, np.float64)
    fx = ((easts - float(xoff)) / float(resolution)).astype(np.float32)
    fy = ((float(yoff) - norths) / float(resolution)).astype(np.float32)
    return _splat(torch.from_numpy(fx).to(device),
                  torch.from_numpy(fy).to(device),
                  torch.as_tensor(np.asarray(alts, np.float32)).to(device),
                  xsize=int(xsize), ysize=int(ysize), radius=int(radius),
                  sigma=float(sigma))


def _splat(fx, fy, alts, *, xsize: int, ysize: int, radius: int,
           sigma: float):
    """fx, fy, alts: (N,) float32 tensors on one device."""
    cx = torch.floor(fx).to(torch.int32)
    cy = torch.floor(fy).to(torch.int32)
    offs = torch.arange(-radius, radius + 1, dtype=torch.int32,
                        device=fx.device)
    dy, dx = torch.meshgrid(offs, offs, indexing="ij")
    col = cx[None] + dx.reshape(-1, 1)  # (K, N), offsets dy-major as JAX
    row = cy[None] + dy.reshape(-1, 1)
    ok = (col >= 0) & (col < xsize) & (row >= 0) & (row < ysize)
    if np.isfinite(sigma):
        d2 = (col + 0.5 - fx) ** 2 + (row + 0.5 - fy) ** 2
        w = torch.exp(-d2 / (2.0 * sigma ** 2))
    else:
        w = torch.ones_like(col, dtype=torch.float32)
    w = torch.where(ok, w, 0.0)
    idx = torch.where(ok, row * xsize + col, 0).reshape(-1)
    pairs = torch.stack([w * alts, w], dim=-1).reshape(-1, 2)
    acc = torch.zeros((ysize * xsize, 2), dtype=torch.float32,
                      device=fx.device).index_add_(0, idx, pairs)
    num, den = acc[:, 0], acc[:, 1]
    dsm = torch.where(den > 0, num / torch.clamp_min(den, 1e-12),
                      torch.nan)
    return dsm.reshape(ysize, xsize)


def dsm_from_latlonalt(lats, lons, alts, roi_txt=None, dsm_path=None,
                       resolution=0.5, device=None):
    """lat/lon/alt point cloud -> DSM raster as a numpy array (+ optional
    GeoTIFF output), splatted on `device`.

    Mirrors get_dsm_from_nerf_prediction (satellite_scene.py:507-568): the ROI txt
    gives (xoff, yoff, size_px, resolution) with yoff measured from the bottom
    (hence the + size*res correction); without it the bounds come from the cloud.
    """
    easts, norths, zone, northern = latlon_to_utm(np.asarray(lats), np.asarray(lons))

    if roi_txt is not None:
        meta = np.loadtxt(roi_txt)
        xoff, yoff = float(meta[0]), float(meta[1])
        xsize = ysize = int(meta[2])
        resolution = float(meta[3])
        yoff += ysize * resolution  # ROI yoff is the south edge
    else:
        xmin, xmax = easts.min(), easts.max()
        ymin, ymax = norths.min(), norths.max()
        xoff = np.floor(xmin / resolution) * resolution
        xsize = int(1 + np.floor((xmax - xoff) / resolution))
        yoff = np.ceil(ymax / resolution) * resolution
        ysize = int(1 - np.floor((ymin - yoff) / resolution))

    dsm = rasterize_dsm(easts, norths, alts, xoff, yoff, resolution,
                        xsize=int(xsize), ysize=int(ysize),
                        device=device).cpu().numpy()

    if dsm_path is not None:
        write_geotiff(
            dsm_path, dsm.astype(np.float32),
            transform=(xoff, resolution, yoff, -resolution),
            epsg=utm_epsg(zone, northern), nodata=float("nan"),
        )
    return dsm, (xoff, yoff, resolution, int(xsize), int(ysize))
