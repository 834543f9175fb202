"""DFC2019 AOI -> training dataset (`spnerf_tpu/data/create_dataset.py`).

`python -m spnerf_torch.data.create_dataset --aoi_id JAX_269 --dataset_dir
<raw> --output_dir <out>` crops the AOI's GeoTIFFs to the lidar ROI (with
the RPC offsets moved by the crop), writes the per-image JSON metadata the
scene loader reads (size, the RPC dict in rpcm format, sun angles, the
footprint as GeoJSON, min/max altitude from the lidar DSM), seeded
train/test splits and the sun-angle list `<aoi>_sunangles.txt`.

* RPCs come from the RPC00B block in GeoTIFF tag 50844 (92 doubles in
  rpcm's term order), read by the port's own TIFF parser.
* The footprint's reference altitude is the lidar DSM's mean.
* Sun angles, in this order: `<aoi>_sunangles.txt` in the raw dataset
  (img el az a line), the image's NITF_USE00A_* items in its GDAL-metadata
  tag (42112), a USE00A TRE in an MSI sidecar NITF in --msi_dir, else 0.
  The crop keeps tag 42112, as GDAL-based croppers keep a GeoTIFF's
  metadata, so the cropped image still carries its sun angles. (The JAX
  package's crop writes only the RPC tag; its JSONs of a cropped AOI take
  their angles from a sidecar file or get 0.)
* `--ba` runs the external sat-bundleadjust pipeline (`run_ba`) where the
  `bundle_adjust` and `rpcm` packages import; otherwise an existing
  `ba_files/` is used, else the original RPCs, with a note. BA keypoints
  are copied into the JSONs (d["keypoints"]).

Everything here is float64 numpy on the host; no step uses the device.
"""

import argparse
import glob
import os
import re
import shutil
import struct
from dataclasses import replace

import numpy as np

from ..geo import RPCModel
from ..geo.utm import utm_to_latlon
from ..io import get_file_id, read_geotiff, write_dict_to_json, write_geotiff
from ..io.tiff import _read_ifd_raw

_T_RPC = 50844  # RPCCoefficientTag (RPC00B block as 92 doubles)
_T_GDAL_METADATA = 42112  # GDAL metadata XML (<GDALMetadata><Item name=...>)

# DFC2019 AOI prefixes -> UTM zone
AOI_ZONES = {"JAX": (17, True), "OMA": (15, True)}


def rpc_from_geotiff(path):
    """The RPC00B block of GeoTIFF tag 50844 -> RPCModel.

    Block layout: [err_bias, err_rand, line_off, samp_off, lat_off, lon_off,
    height_off, line_scale, samp_scale, lat_scale, lon_scale, height_scale,
    line_num(20), line_den(20), samp_num(20), samp_den(20)].
    """
    tags, _, _ = _read_ifd_raw(path)
    if _T_RPC not in tags:
        raise ValueError(f"{path} carries no RPC coefficient tag (50844)")
    v = np.asarray(tags[_T_RPC], np.float64)
    if v.size < 92:
        raise ValueError(f"{path}: short RPC block of {v.size} values")
    return RPCModel(
        row_offset=v[2], col_offset=v[3],
        lat_offset=v[4], lon_offset=v[5], alt_offset=v[6],
        row_scale=v[7], col_scale=v[8],
        lat_scale=v[9], lon_scale=v[10], alt_scale=v[11],
        row_num=v[12:32], row_den=v[32:52],
        col_num=v[52:72], col_den=v[72:92],
    )


def rpc_to_geotiff_tag(rpc: RPCModel):
    """RPCModel -> the 92-double RPC00B block (inverse of rpc_from_geotiff)."""
    return np.concatenate([
        [0.0, 0.0, rpc.row_offset, rpc.col_offset, rpc.lat_offset,
         rpc.lon_offset, rpc.alt_offset, rpc.row_scale, rpc.col_scale,
         rpc.lat_scale, rpc.lon_scale, rpc.alt_scale],
        rpc.row_num, rpc.row_den, rpc.col_num, rpc.col_den,
    ])


def read_roi_lonlat(aoi_id, dataset_dir):
    """The lidar ROI (a UTM window) -> its (4, 2) lon/lat corners."""
    prefix = aoi_id.split("_")[0]
    if prefix not in AOI_ZONES:
        raise ValueError(f"AOI {aoi_id} not in zone table {list(AOI_ZONES)}")
    zone, northern = AOI_ZONES[prefix]
    roi = np.loadtxt(os.path.join(dataset_dir, "Truth", f"{aoi_id}_DSM.txt"))
    xoff, yoff, size, res = roi[0], roi[1], int(roi[2]), roi[3]
    easts = np.array([xoff, xoff, xoff + size * res, xoff + size * res])
    norths = np.array([yoff, yoff + size * res, yoff + size * res, yoff])
    lats, lons = utm_to_latlon(easts, norths, zone, northern)
    return np.stack([lons, lats], axis=-1)


def image_lonlat_aoi(rpc, h, w, z):
    """GeoJSON polygon of an image's footprint at altitude z, with its
    centre."""
    cols = np.array([0.0, w, w, 0.0])
    rows = np.array([0.0, 0.0, h, h])
    lons, lats = rpc.localization(cols, rows, np.full(4, float(z)))
    poly = {"coordinates": [np.stack([lons, lats], -1).tolist()],
            "type": "Polygon"}
    poly["center"] = [float(lons.min() + (lons.max() - lons.min()) / 2),
                      float(lats.min() + (lats.max() - lats.min()) / 2)]
    return poly


def crop_geotiff_to_lonlat_aoi(geotiff_path, output_path, lonlat_aoi, z):
    """Crop an image to the pixel bounding box of the lon/lat AOI at
    altitude z, move the RPC offsets by the crop's origin and keep the
    GDAL-metadata tag. Returns ((x0, y0), the adjusted RPC)."""
    rpc = rpc_from_geotiff(geotiff_path)
    lons, lats = lonlat_aoi[:, 0], lonlat_aoi[:, 1]
    cols, rows = rpc.projection(lons, lats, np.full(len(lons), float(z)))
    arr, profile = read_geotiff(geotiff_path)
    h, w = arr.shape[:2]
    x0 = int(np.clip(np.floor(cols.min()), 0, w - 1))
    x1 = int(np.clip(np.ceil(cols.max()), x0 + 1, w))
    y0 = int(np.clip(np.floor(rows.min()), 0, h - 1))
    y1 = int(np.clip(np.ceil(rows.max()), y0 + 1, h))
    rpc_adj = replace(rpc, row_offset=rpc.row_offset - y0,
                      col_offset=rpc.col_offset - x0)
    meta = _gdal_metadata_xml(geotiff_path)
    write_geotiff(output_path, arr[y0:y1, x0:x1], profile=profile,
                  extra_double_tags={_T_RPC: rpc_to_geotiff_tag(rpc_adj)},
                  extra_ascii_tags={_T_GDAL_METADATA: meta} if meta else None)
    return (x0, y0), rpc_adj


def load_sun_angles(dataset_dir, aoi_id):
    """{img: (elevation, azimuth)} from an optional `<aoi>_sunangles.txt`."""
    path = os.path.join(dataset_dir, f"{aoi_id}_sunangles.txt")
    out = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 3:
                    out[parts[0]] = (float(parts[1]), float(parts[2]))
    return out


def _gdal_metadata_xml(path):
    """The text of a TIFF's GDAL-metadata tag (42112), or None."""
    try:
        tags, _, _ = _read_ifd_raw(path)
    except (OSError, ValueError, KeyError, struct.error):
        return None
    raw = tags.get(_T_GDAL_METADATA)
    if raw is None:
        return None
    return raw.decode("utf-8", "replace") if isinstance(raw, bytes) else str(raw)


def _gdal_metadata_items(path):
    """The NITF_* items of a GeoTIFF's GDAL-metadata tag: GDAL copies an
    NTF's header fields there when it translates the NTF to GeoTIFF."""
    text = _gdal_metadata_xml(path)
    if text is None:
        return {}
    return dict(re.findall(r'<Item name="([^"]+)"[^>]*>([^<]*)</Item>', text))


def _sun_angles_from_use00a(ntf_path):
    """(SUN_EL, SUN_AZ) from a NITF file's USE00A TRE, or None.

    The 6-byte TRE tag, a 5-digit length, and the TRE's last two 5-character
    fields, which the USE00A layout (STDI-0002, 107 bytes) defines as SUN_EL
    and SUN_AZ. Only the first 1 MiB is read: TREs sit in the headers before
    the pixels, which are large and could hold the tag by chance."""
    with open(ntf_path, "rb") as f:
        data = f.read(1 << 20)
    pos = data.find(b"USE00A")
    if pos < 0:
        return None
    try:
        cel = int(data[pos + 6: pos + 11])
        tre = data[pos + 11: pos + 11 + cel]
        if len(tre) < cel:
            return None
        return float(tre[-10:-5]), float(tre[-5:])
    except (ValueError, IndexError):
        return None


def sun_angles_from_image_metadata(rgb_path, msi_dir=None):
    """(sun elevation, sun azimuth, acquisition date) of an image: its
    NITF_USE00A_* metadata items, else the MSI sidecar NITF named by
    NITF_IID2 or the image's stem in `msi_dir`, else zeros."""
    items = _gdal_metadata_items(rgb_path)
    date = items.get("NITF_STDIDC_ACQUISITION_DATE", "")
    if "NITF_USE00A_SUN_EL" in items and "NITF_USE00A_SUN_AZ" in items:
        return (float(items["NITF_USE00A_SUN_EL"]),
                float(items["NITF_USE00A_SUN_AZ"]), date)
    if msi_dir:
        iid2 = items.get("NITF_IID2", "").replace(" ", "_")
        stem = os.path.splitext(os.path.basename(rgb_path))[0]
        names = [s for s in (iid2, stem) if s]
        for cand in (f"{n}{ext}" for n in names for ext in (".NTF", ".ntf")):
            p = os.path.join(msi_dir, cand)
            if os.path.exists(p):
                angles = _sun_angles_from_use00a(p)
                if angles is not None:
                    return angles[0], angles[1], date
    return 0.0, 0.0, date


def run_ba(img_dir, output_dir):
    """Refine the RPCs with the sat-bundleadjust pipeline into
    `<output_dir>/ba_files` (its log, `rpcs_adj/` and `ba_params/`).
    Needs the external `bundle_adjust` and `rpcm` packages; raises
    ImportError where they are absent."""
    import sys

    from bundle_adjust import loader
    from bundle_adjust.ba_pipeline import BundleAdjustmentPipeline
    from bundle_adjust.cam_utils import SatelliteImage
    import rpcm

    images = sorted(glob.glob(os.path.join(img_dir, "*.tif")))
    rpcs = [rpcm.rpc_from_geotiff(p) for p in images]
    ba_input = {
        "in_dir": img_dir,
        "out_dir": os.path.join(output_dir, "ba_files"),
        "images": [SatelliteImage(fn, rpc) for fn, rpc in zip(images, rpcs)],
    }
    os.makedirs(ba_input["out_dir"], exist_ok=True)
    log_path = os.path.join(ba_input["out_dir"], "bundle_adjust.log")
    print(f"Running bundle adjustment for RPC refinement (log: {log_path})")
    tracks_config = {"FT_reset": False, "FT_save": True,
                     "FT_sift_detection": "s2p",
                     "FT_sift_matching": "epipolar_based"}
    out, err = sys.stdout, sys.stderr
    with open(log_path, "w+") as log_file:
        sys.stdout = sys.stderr = log_file
        try:
            pipeline = BundleAdjustmentPipeline(
                ba_input, tracks_config=tracks_config,
                extra_ba_config={"cam_model": "rpc"})
            pipeline.run()
        finally:
            sys.stdout, sys.stderr = out, err

    params_dir = os.path.join(pipeline.out_dir, "ba_params")
    os.makedirs(params_dir, exist_ok=True)
    bap = pipeline.ba_params
    np.save(os.path.join(params_dir, "pts_ind.npy"), bap.pts_ind)
    np.save(os.path.join(params_dir, "cam_ind.npy"), bap.cam_ind)
    np.save(os.path.join(params_dir, "pts3d.npy"),
            bap.pts3d_ba - pipeline.global_transform)
    np.save(os.path.join(params_dir, "pts2d.npy"), bap.pts2d)
    used = [pipeline.images[i].geotiff_path for i in bap.cam_prev_indices]
    loader.save_list_of_paths(os.path.join(params_dir, "geotiff_paths.txt"),
                              used)
    return ba_input["out_dir"]


def _ba_keypoints(output_dir, json_dir):
    """The BA run's keypoints under `output_dir/ba_files/ba_params`, or
    None; copies its pts3d.npy beside the JSONs."""
    params_dir = os.path.join(output_dir, "ba_files", "ba_params")
    paths_txt = os.path.join(params_dir, "geotiff_paths.txt")
    if not os.path.exists(paths_txt):
        return None
    with open(paths_txt) as f:
        names = [os.path.basename(ln.strip()) for ln in f if ln.strip()]
    pts3d = os.path.join(params_dir, "pts3d.npy")
    if os.path.exists(pts3d):
        shutil.copyfile(pts3d, os.path.join(json_dir, "pts3d.npy"))
    return {"names": names,
            **{k: np.load(os.path.join(params_dir, f"{k}.npy"))
               for k in ("pts_ind", "cam_ind", "pts2d")}}


def create_dataset_from_dfc2019(aoi_id, img_dir, dataset_dir, output_dir,
                                use_ba=False, sun_angles_list=None,
                                msi_dir=None):
    """Write one JSON per image of `img_dir` under `output_dir/JSON`;
    appends (img, el, az) to sun_angles_list. Returns the JSON directory."""
    os.makedirs(output_dir, exist_ok=True)
    json_dir = os.path.join(output_dir, "JSON")
    os.makedirs(json_dir, exist_ok=True)

    dsm, _ = read_geotiff(os.path.join(dataset_dir, "Truth",
                                       f"{aoi_id}_DSM.tif"))
    dsm = np.asarray(dsm, np.float64)
    min_alt = int(np.round(np.nanmin(dsm) - 1))
    max_alt = int(np.round(np.nanmax(dsm) + 1))
    z_ref = float(np.nanmean(dsm))
    sun_angles = load_sun_angles(dataset_dir, aoi_id)
    ba_kps = _ba_keypoints(output_dir, json_dir) if use_ba else None

    for rgb_p in sorted(glob.glob(os.path.join(img_dir, "*.tif"))):
        arr, _ = read_geotiff(rgb_p)
        rpc = rpc_from_geotiff(rgb_p)
        if use_ba:
            adj = os.path.join(output_dir,
                               f"ba_files/rpcs_adj/{get_file_id(rgb_p)}.rpc_adj")
            if os.path.exists(adj):
                rpc = _rpc_from_rpc_file(adj)
            else:
                print(f"no adjusted RPC for {rgb_p}; using original")
        img = os.path.basename(rgb_p)
        meta_el, meta_az, date = sun_angles_from_image_metadata(rgb_p, msi_dir)
        el, az = sun_angles.get(img, (meta_el, meta_az))
        d = {
            "img": img,
            "height": int(arr.shape[0]),
            "width": int(arr.shape[1]),
            "sun_elevation": el,
            "sun_azimuth": az,
            "acquisition_date": date,
            "geojson": image_lonlat_aoi(rpc, arr.shape[0], arr.shape[1], z_ref),
            "min_alt": min_alt,
            "max_alt": max_alt,
            "rpc": rpc.to_dict(),
        }
        if ba_kps is not None and img in ba_kps["names"]:
            sel = ba_kps["cam_ind"] == ba_kps["names"].index(img)
            d["keypoints"] = {
                "2d_coordinates": ba_kps["pts2d"][sel].tolist(),
                "pts3d_indices": ba_kps["pts_ind"][sel].tolist(),
            }
        write_dict_to_json(d, os.path.join(json_dir, f"{get_file_id(rgb_p)}.json"))
        if sun_angles_list is not None:
            sun_angles_list.append((img, el, az))
    return json_dir


def _rpc_from_rpc_file(path):
    """An RPC text file (`LINE_OFF: v` lines) -> RPCModel."""
    vals = {}
    with open(path) as f:
        for line in f:
            if ":" in line:
                k, v = line.split(":", 1)
                vals[k.strip()] = v.split()[0]

    def coef(prefix):
        return np.array([float(vals[f"{prefix}_{i}"]) for i in range(1, 21)])

    return RPCModel(
        row_offset=float(vals["LINE_OFF"]), col_offset=float(vals["SAMP_OFF"]),
        lat_offset=float(vals["LAT_OFF"]), lon_offset=float(vals["LONG_OFF"]),
        alt_offset=float(vals["HEIGHT_OFF"]),
        row_scale=float(vals["LINE_SCALE"]), col_scale=float(vals["SAMP_SCALE"]),
        lat_scale=float(vals["LAT_SCALE"]), lon_scale=float(vals["LONG_SCALE"]),
        alt_scale=float(vals["HEIGHT_SCALE"]),
        row_num=coef("LINE_NUM_COEFF"), row_den=coef("LINE_DEN_COEFF"),
        col_num=coef("SAMP_NUM_COEFF"), col_den=coef("SAMP_DEN_COEFF"),
    )


def create_train_test_splits(sample_ids, test_percent=0.15, min_test_samples=2,
                             seed=None):
    """A random (train, test) split, seeded by `seed`."""
    rng = np.random.default_rng(seed)
    ids = np.array(sample_ids)
    order = rng.permutation(len(ids))
    n_test = max(min_test_samples, int(test_percent * len(ids)))
    return (ids[order[: len(ids) - n_test]].tolist(),
            ids[order[-n_test:]].tolist())


def create_satellite_dataset(aoi_id, dataset_dir, output_dir, crop_aoi=True,
                             ba=False, splits=True, seed=0, msi_dir=None):
    """The whole preparation of `dataset_dir` (RGB/<aoi>/*.tif,
    Truth/<aoi>_DSM.{tif,txt}) into `output_dir/<aoi>`. Returns (that
    directory, its image directory, its JSON directory)."""
    img_dir = os.path.join(dataset_dir, "RGB", aoi_id)
    out = os.path.join(output_dir, aoi_id)
    os.makedirs(out, exist_ok=True)

    truth_out = os.path.join(out, "Truth")
    os.makedirs(truth_out, exist_ok=True)
    for suffix in ("_DSM.txt", "_DSM.tif"):
        shutil.copyfile(os.path.join(dataset_dir, "Truth", aoi_id + suffix),
                        os.path.join(truth_out, aoi_id + suffix))

    if crop_aoi:
        aoi_lonlat = read_roi_lonlat(aoi_id, dataset_dir)
        dsm, _ = read_geotiff(os.path.join(dataset_dir, "Truth",
                                           f"{aoi_id}_DSM.tif"))
        z_ref = float(np.nanmean(np.asarray(dsm, np.float64)))
        crop_dir = os.path.join(out, "RGB", aoi_id)
        os.makedirs(crop_dir, exist_ok=True)
        for p in sorted(glob.glob(os.path.join(img_dir, "*.tif"))):
            crop_geotiff_to_lonlat_aoi(p, os.path.join(crop_dir,
                                                       os.path.basename(p)),
                                       aoi_lonlat, z_ref)
        img_dir = crop_dir

    if ba and not os.path.isdir(os.path.join(out, "ba_files")):
        try:
            run_ba(img_dir, out)
        except ImportError:
            print("bundle adjustment requested but the sat-bundleadjust "
                  "pipeline (`bundle_adjust` + `rpcm`) is not installed and "
                  "no ba_files/ exist — continuing with original RPCs. "
                  "Install it, or run BA separately and re-invoke with "
                  "ba_files/ in place.")
            ba = False

    sun_angles = []
    json_dir = create_dataset_from_dfc2019(aoi_id, img_dir, dataset_dir, out,
                                           use_ba=ba,
                                           sun_angles_list=sun_angles,
                                           msi_dir=msi_dir)
    if splits:
        files = sorted(os.path.basename(p)
                       for p in glob.glob(os.path.join(json_dir, "*.json")))
        train, test = create_train_test_splits(files, seed=seed)
        with open(os.path.join(json_dir, "train.txt"), "w") as f:
            f.write("\n".join(train) + "\n")
        with open(os.path.join(json_dir, "test.txt"), "w") as f:
            f.write("\n".join(test) + "\n")

    with open(os.path.join(out, f"{aoi_id}_sunangles.txt"), "w") as f:
        for img, el, az in sun_angles:
            f.write(f"{img} {el} {az}\n")
    return out, img_dir, json_dir


def main(argv=None):
    p = argparse.ArgumentParser(description="Prepare a DFC2019 satellite dataset")
    p.add_argument("--aoi_id", type=str, required=True)
    p.add_argument("--dataset_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--no_crop", action="store_true")
    p.add_argument("--ba", action="store_true",
                   help="run sat-bundleadjust if installed, else consume "
                        "pre-existing ba_files/")
    p.add_argument("--msi_dir", type=str, default=None,
                   help="directory of MSI sidecar NITFs for sun-angle "
                        "extraction")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    out, img_dir, json_dir = create_satellite_dataset(
        args.aoi_id, args.dataset_dir, args.output_dir,
        crop_aoi=not args.no_crop, ba=args.ba, seed=args.seed,
        msi_dir=args.msi_dir,
    )
    print(f"dataset written to {out}\n  images: {img_dir}\n  json: {json_dir}")
    return out, img_dir, json_dir


if __name__ == "__main__":
    main()
