"""A synthetic DFC2019 AOI written to disk in the layout `load_scene` reads.

`write_synthetic_aoi(root, ...)` writes, from one numpy `Generator(seed)`:

  root/JSON/{img}.json, train.txt, test.txt   per-image metadata (img,
      height/width, min_alt/max_alt, sun_elevation/sun_azimuth, an `rpc` dict
      in rpcm format, the ROI as a `geojson` polygon with its centre)
  root/RGB/{aoi}/{img}.tif                    uint8 RGB
  root/Depth/{img}_2DPts.txt, _3DPts_ecef.txt, _Correl.txt   MicMac-format
      depth of each train image
  root/Semantic/{aoi}_CLS.tif                 DFC2019 class ids on the ROI grid
  root/Truth/{aoi}_DSM.tif, {aoi}_DSM.txt     the lidar DSM and its ROI
      (xoff, south yoff, size, resolution) in UTM 17N

The ROI lies over Jacksonville (UTM 17N). Its surface is a sloped ground
plane with flat-roofed box buildings, a water patch and tree patches (class
5, which three-class runs ignore); the DSM holds it at the cell centres.
Each camera is a rational, near-affine RPC looking off-nadir: altitude moves
the image point through the RPC's altitude terms, and small cross and
denominator terms keep `localization` doing real Gauss-Newton work. No
scene.loc is written: the first `load_scene` fits it.

Depth points, and `surface_points` of any image, come from the fixed-point
ray-surface intersection of `data/synth_depth.py` (localize at the current
altitude, look the DSM up at the ground point, repeat; keep the pixels whose
final point reprojects within a pixel).

`write_raw_aoi(root, ...)` writes the same kind of AOI in the layout of the
raw DFC2019 release instead, the input of `data/create_dataset.py`:

  root/RGB/{aoi}/{img}.tif     uint8 RGB, larger than the ROI's footprint,
      the RPC00B block in tag 50844 and the sun angles as NITF_USE00A_SUN_EL
      and _SUN_AZ items of the GDAL-metadata tag (42112)
  root/Truth/{aoi}_DSM.tif, {aoi}_DSM.txt   the lidar DSM and its ROI

The image and ROI sizes are arguments: the bundled AOI's 813 x 793 px and
512 x 512 cells at 0.5 m on the card, a few tens of pixels in tests.
`write_raw_aoi` sizes its images from the crop it should give (about 800 px
a side over a 512-cell ROI on the card), within a margin of a quarter of
that on each side.
"""

import os

import numpy as np

from ..data.create_dataset import (_T_GDAL_METADATA, _T_RPC,
                                   rpc_to_geotiff_tag)
from ..data.synth_depth import synthesize_depth_for_image
from ..geo import RPCModel, latlon_to_utm, utm_to_latlon
from ..io import write_dict_to_json, write_geotiff

ZONE, NORTHERN = 17, True  # Jacksonville
CENTER_LATLON = (30.3124, -81.6626)
GROUND_ALT = 2.0  # m, at the ROI centre
RESOLUTION = 0.5  # m, the DFC2019 lidar grid
DEPTH_STRIDE = 4  # MicMac depth at every 4th pixel of every 4th row
RAW_IMAGES = 4  # JAX_269's count: 2 train and 2 test after the split
RAW_MARGIN = 0.25  # of the crop, on each side of a raw image
WATER, TREES, BUILDING, GROUND = 9, 5, 6, 2
_COLORS = {GROUND: (150, 140, 120), BUILDING: (200, 90, 80),
           WATER: (40, 70, 140), TREES: (50, 120, 50)}


def _boxes(rng, size, count):
    """`count` rectangles (r0, r1, c0, c1) of 8-20% of the ROI's side."""
    out = []
    for _ in range(count):
        h, w = (rng.uniform(0.08, 0.2, 2) * size).astype(int) + 2
        r0, c0 = rng.integers(0, size - max(h, w), 2)
        out.append((r0, r0 + h, c0, c0 + w))
    return out


def _surface(rng, size, res):
    """(dsm (size, size) float32, classes (size, size) uint8)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    x, y = (xx + 0.5 - size / 2) * res, (size / 2 - yy - 0.5) * res
    slope = rng.uniform(-0.02, 0.02, 2)
    dsm = GROUND_ALT + slope[0] * x + slope[1] * y
    cls = np.full((size, size), GROUND, np.uint8)
    (r0, r1, c0, c1), = _boxes(rng, size, 1)
    dsm[r0:r1, c0:c1] = GROUND_ALT - 1.0
    cls[r0:r1, c0:c1] = WATER
    for r0, r1, c0, c1 in _boxes(rng, size, 2):
        cls[r0:r1, c0:c1] = np.where(cls[r0:r1, c0:c1] == GROUND, TREES,
                                     cls[r0:r1, c0:c1])
    for r0, r1, c0, c1 in _boxes(rng, size, 3):
        dsm[r0:r1, c0:c1] = GROUND_ALT + rng.uniform(3.0, 8.0)
        cls[r0:r1, c0:c1] = BUILDING
    return dsm.astype(np.float32), cls


def _rpc(rng, width, height, gsd, alt_scale):
    """A rational near-affine RPC of an off-nadir view centred on the ROI."""
    lat0, lon0 = CENTER_LATLON
    m_lat = 111_132.0  # metres per degree near 30 N
    m_lon = 111_320.0 * np.cos(np.radians(lat0))
    col_scale, row_scale = width / 2.0, height / 2.0
    lon_scale = col_scale * gsd / m_lon
    lat_scale = row_scale * gsd / m_lat
    off_nadir = np.radians(rng.uniform(5.0, 25.0))
    azimuth = rng.uniform(0.0, 2 * np.pi)
    lean = np.tan(off_nadir) * alt_scale / gsd  # px per normalized altitude
    col_num, row_num = np.zeros(20), np.zeros(20)
    col_den, row_den = np.zeros(20), np.zeros(20)
    # monomials: 1, y (lon), x (lat), z (alt), yx, yz, xz, y^2, x^2, z^2, ...
    col_num[1] = 1.0
    col_num[2] = rng.uniform(-0.02, 0.02)
    col_num[3] = lean * np.sin(azimuth) / col_scale
    row_num[2] = -1.0
    row_num[1] = rng.uniform(-0.02, 0.02)
    row_num[3] = -lean * np.cos(azimuth) / row_scale
    for num in (col_num, row_num):
        num[[4, 7, 8]] = rng.uniform(-3e-3, 3e-3, 3)
    for den in (col_den, row_den):
        den[0] = 1.0
        den[[1, 2]] = rng.uniform(-2e-3, 2e-3, 2)
        den[3] = rng.uniform(-5e-4, 5e-4)
    return RPCModel(
        row_offset=row_scale, col_offset=col_scale, lat_offset=lat0,
        lon_offset=lon0, alt_offset=GROUND_ALT, row_scale=row_scale,
        col_scale=col_scale, lat_scale=lat_scale, lon_scale=lon_scale,
        alt_scale=alt_scale, row_num=row_num, row_den=row_den,
        col_num=col_num, col_den=col_den)


def surface_points(meta, dsm, roi, stride=1):
    """One image -> (pts2d (N, 2) int64 [col, row], pts3d (N, 3) ECEF,
    correl (N,)): the pixels on a `stride` grid whose ray meets the DSM
    surface (`data/synth_depth.py`). roi: (xoff, south yoff, size, res)."""
    return synthesize_depth_for_image(meta, np.asarray(dsm, np.float64), roi,
                                      ZONE, NORTHERN, stride=stride)


def _rgb(rng, rpc, cls, roi, width, height):
    """uint8 (height, width, 3): each pixel the colour of the class under
    it at ground altitude (the affine part of the RPC inverted), with
    noise."""
    xoff, yoff, size, res = roi
    cols, rows = np.meshgrid(np.arange(width, dtype=np.float64),
                             np.arange(height, dtype=np.float64))
    a = np.array([[rpc.col_num[1], rpc.col_num[2]],
                  [rpc.row_num[1], rpc.row_num[2]]])
    tc = (cols.ravel() - rpc.col_offset) / rpc.col_scale
    tr = (rows.ravel() - rpc.row_offset) / rpc.row_scale
    nlon, nlat = np.linalg.solve(a, np.stack([tc, tr]))
    easts, norths, _, _ = latlon_to_utm(nlat * rpc.lat_scale + rpc.lat_offset,
                                        nlon * rpc.lon_scale + rpc.lon_offset,
                                        ZONE, NORTHERN)
    c = np.clip(np.floor((easts - xoff) / res).astype(np.int64), 0, size - 1)
    r = np.clip(np.floor((yoff + size * res - norths) / res).astype(np.int64),
                0, size - 1)
    lut = np.zeros((256, 3), np.float64)
    for k, rgb in _COLORS.items():
        lut[k] = rgb
    img = lut[cls[r, c]] + rng.normal(0.0, 12.0, (c.size, 3))
    return np.clip(img, 0, 255).astype(np.uint8).reshape(height, width, 3)


def _write_lidar(gt_dir, aoi_id, roi_size, rng):
    """The ROI (xoff, south yoff, size, res) centred on CENTER_LATLON, its
    surface and classes from `rng`, the DSM written as {aoi}_DSM.tif and
    {aoi}_DSM.txt under gt_dir. Returns (roi, dsm, cls, transform)."""
    resolution = RESOLUTION
    e0, n0, _, _ = latlon_to_utm(np.array([CENTER_LATLON[0]]),
                                 np.array([CENTER_LATLON[1]]), ZONE, NORTHERN)
    half = roi_size * resolution / 2
    roi = (float(np.round(e0[0] - half)), float(np.round(n0[0] - half)),
           int(roi_size), float(resolution))
    dsm, cls = _surface(rng, roi_size, resolution)
    transform = (roi[0], resolution, roi[1] + roi_size * resolution,
                 -resolution)
    write_geotiff(os.path.join(gt_dir, f"{aoi_id}_DSM.tif"), dsm,
                  transform=transform, epsg=32600 + ZONE)
    np.savetxt(os.path.join(gt_dir, f"{aoi_id}_DSM.txt"),
               np.array(roi, np.float64), fmt="%.6f")
    return roi, dsm, cls, transform


def write_synthetic_aoi(root, aoi_id="JAX_269", width=813, height=793,
                        roi_size=512, n_train=3, seed=0):
    """Write the AOI under `root`: n_train train images and one test image
    of width x height px, a roi_size x roi_size lidar ROI at RESOLUTION.
    Returns {"json_dir", "img_dir", "depth_dir", "sem_dir", "gt_dir",
    "train", "test", "roi"} (the image ids of each split and the ROI as
    (xoff, south yoff, size, res))."""
    resolution = RESOLUTION
    rng = np.random.default_rng(seed)
    dirs = {"json_dir": os.path.join(root, "JSON"),
            "img_dir": os.path.join(root, "RGB", aoi_id),
            "depth_dir": os.path.join(root, "Depth"),
            "sem_dir": os.path.join(root, "Semantic"),
            "gt_dir": os.path.join(root, "Truth")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    roi, dsm, cls, transform = _write_lidar(dirs["gt_dir"], aoi_id,
                                            roi_size, rng)
    write_geotiff(os.path.join(dirs["sem_dir"], f"{aoi_id}_CLS.tif"), cls,
                  transform=transform, epsg=32600 + ZONE)
    half = roi_size * resolution / 2

    corners = np.array([[0, 0], [1, 0], [1, 1], [0, 1], [0, 0]], np.float64)
    lat_c, lon_c = utm_to_latlon(roi[0] + corners[:, 0] * 2 * half,
                                 roi[1] + corners[:, 1] * 2 * half,
                                 ZONE, NORTHERN)
    geojson = {"type": "Polygon",
               "coordinates": [np.stack([lon_c, lat_c], -1).tolist()],
               "center": [float(np.mean(lon_c[:4])),
                          float(np.mean(lat_c[:4]))]}
    # the image covers the ROI with a 10% margin
    gsd = 1.1 * roi_size * resolution / min(width, height)
    lo, hi = float(dsm.min()) - 5.0, float(dsm.max()) + 5.0
    ids = [f"{aoi_id}_{k:03d}_RGB" for k in range(n_train + 1)]
    for k, img_id in enumerate(ids):
        rpc = _rpc(rng, width, height, gsd, alt_scale=(hi - lo) / 2)
        write_geotiff(os.path.join(dirs["img_dir"], f"{img_id}.tif"),
                      _rgb(rng, rpc, cls, roi, width, height))
        meta = {"img": f"{img_id}.tif", "height": height, "width": width,
                "min_alt": lo, "max_alt": hi,
                "sun_elevation": float(rng.uniform(40.0, 70.0)),
                "sun_azimuth": float(rng.uniform(100.0, 200.0)),
                "rpc": rpc.to_dict(), "geojson": geojson}
        write_dict_to_json(meta, os.path.join(dirs["json_dir"],
                                              f"{img_id}.json"))
        if k < n_train:
            pts2d, pts3d, correl = surface_points(meta, dsm, roi,
                                                  stride=DEPTH_STRIDE)
            base = os.path.join(dirs["depth_dir"], img_id)
            np.savetxt(f"{base}_2DPts.txt", pts2d, fmt="%d")
            np.savetxt(f"{base}_3DPts_ecef.txt", pts3d, fmt="%.6f")
            np.savetxt(f"{base}_Correl.txt", correl, fmt="%.6f")
    for name, split in (("train.txt", ids[:n_train]),
                        ("test.txt", ids[n_train:])):
        with open(os.path.join(dirs["json_dir"], name), "w") as f:
            f.write("\n".join(f"{i}.json" for i in split) + "\n")
    return dict(dirs, train=ids[:n_train], test=ids[n_train:], roi=roi)


def raw_image_xml(el, az, date):
    """GDAL-metadata XML carrying the NITF items GDAL copies from an NTF."""
    return ('<GDALMetadata>\n'
            f'  <Item name="NITF_STDIDC_ACQUISITION_DATE">{date}</Item>\n'
            f'  <Item name="NITF_USE00A_SUN_EL">{el:+.1f}</Item>\n'
            f'  <Item name="NITF_USE00A_SUN_AZ">{az:+.1f}</Item>\n'
            '</GDALMetadata>')


def write_raw_aoi(root, aoi_id="JAX_269", crop_px=800, roi_size=512,
                  sun_metadata=True, seed=0):
    """Write a raw DFC2019 AOI under `root`: RAW_IMAGES images whose crop
    to the roi_size-cell lidar ROI is about crop_px a side, each image
    (1 + 2 * RAW_MARGIN) times that, and the lidar DSM. sun_metadata=False
    leaves tag 42112 out. Returns {"img_dir", "gt_dir", "roi", "sun"} (sun:
    {img file: (elevation, azimuth)}, as written)."""
    rng = np.random.default_rng(seed)
    dirs = {"img_dir": os.path.join(root, "RGB", aoi_id),
            "gt_dir": os.path.join(root, "Truth")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    roi, dsm, cls, _ = _write_lidar(dirs["gt_dir"], aoi_id, roi_size, rng)

    gsd = roi_size * RESOLUTION / crop_px
    size = int(round(crop_px * (1 + 2 * RAW_MARGIN)))
    lo, hi = float(dsm.min()) - 5.0, float(dsm.max()) + 5.0
    sun = {}
    for k in range(RAW_IMAGES):
        name = f"{aoi_id}_{k:03d}_RGB.tif"
        rpc = _rpc(rng, size, size, gsd, alt_scale=(hi - lo) / 2)
        el, az = rng.uniform(40.0, 70.0), rng.uniform(100.0, 200.0)
        sun[name] = (round(el, 1), round(az, 1))
        xml = raw_image_xml(el, az, f"2015{k + 1:02d}15")
        write_geotiff(os.path.join(dirs["img_dir"], name),
                      _rgb(rng, rpc, cls, roi, size, size),
                      extra_double_tags={_T_RPC: rpc_to_geotiff_tag(rpc)},
                      extra_ascii_tags={_T_GDAL_METADATA: xml}
                      if sun_metadata else None)
    return dict(dirs, roi=roi, sun=sun)
