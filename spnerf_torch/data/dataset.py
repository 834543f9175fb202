"""Satellite scene assembly: rays + RGB + stereo depth + semantics.

The loader of `spnerf_tpu/data/dataset.py`, after the reference SP-NeRF's
`SatelliteSceneDataset` (`datasets/satellite_scene.py:89-614`): the scene is
assembled once on the host into flat numpy arrays, which `Trainer.to_device`
moves to the device whole; each step draws its batch there.

Data contracts preserved from the reference:
  * 11-column ray layout [o, d, near, far, sun_d];
  * scene.loc normalization (center/range), fitted from all images' rays and
    written beside the JSONs when absent;
  * MicMac sparse depth: {id}_2DPts.txt / {id}_3DPts_ecef.txt / {id}_Correl.txt,
    std = stdscale * (1 - normalized_corr) + margin, scaled by the global depth
    range;
  * DFC2019 semantic rasters {aoi}_CLS.tif with label remapping and dense
    (down-then-up nearest) or sparse (strided grid) supervision, sampled at
    the ray grid's size;
  * validation iterates whole images; image 0 is the first *training* image kept
    for debugging.

Host float64 geodesy throughout; the arrays come out float32 / int32.
"""

import glob
import os
from dataclasses import dataclass, field, replace
from typing import List, Optional

import numpy as np

from ..config import IGNORE_LABEL, SEMANTIC_CONFIG
from ..geo import RPCModel, ecef_to_latlon
from ..io import get_file_id, read_dict_from_json, read_tiff, write_dict_to_json
from ..utils.resize import resize_bilinear, resize_nearest
from .rays import SceneNorm, cast_rays, image_grid, sun_direction


def load_rgb_image(img_path, downscale=1.0):
    """GeoTIFF RGB -> (h*w, 3) float32 in [0, 1], bilinear-downscaled
    (reference load_tensor_from_rgb_geotiff, satellite_scene.py:71-86)."""
    img = read_tiff(img_path).astype(np.float64) / 255.0  # (H, W, 3)
    if downscale > 1:
        h = int(img.shape[0] // downscale)
        w = int(img.shape[1] // downscale)
        img = resize_bilinear(img, h, w)
    return img.reshape(-1, 3).astype(np.float32)


def _cast_image_rays(meta, downscale, cache_dir=None):
    """Cast (and cache) the full-image ray set for one metadata dict."""
    img_id = get_file_id(meta["img"])
    cache_path = (
        os.path.join(cache_dir, f"{img_id}_d{downscale:g}.npy") if cache_dir else None
    )
    if cache_path and os.path.exists(cache_path):
        return np.load(cache_path)
    h = int(meta["height"] // downscale)
    w = int(meta["width"] // downscale)
    rpc = RPCModel.from_dict(meta["rpc"]).rescaled(1.0 / downscale)
    cols, rows = image_grid(w, h)
    rays = cast_rays(cols, rows, rpc, float(meta["min_alt"]), float(meta["max_alt"]))
    if cache_path:
        os.makedirs(cache_dir, exist_ok=True)
        np.save(cache_path, rays)
    return rays


@dataclass
class ImageRecord:
    json_path: str
    meta: dict
    img_id: str
    t: int  # image index used for the transient embedding
    h: int
    w: int


@dataclass
class SatelliteScene:
    """All host-side arrays for one AOI, ready to ship to device."""

    # train arrays, all length N = sum(h*w) over train images
    rays: np.ndarray  # (N, 11) float32
    rgbs: np.ndarray  # (N, 3) float32
    ids: np.ndarray  # (N,) int32
    depths: np.ndarray  # (N, 2) float32 [depth, weight]
    valid_depth: np.ndarray  # (N,) float32 0/1
    depth_std: np.ndarray  # (N,) float32
    sems: np.ndarray  # (N,) int32 (-100 void)
    valid_sem: np.ndarray  # (N,) float32 0/1

    norm: SceneNorm = None
    train_images: List[ImageRecord] = field(default_factory=list)
    val_images: List[ImageRecord] = field(default_factory=list)

    # --- held for val-image loading
    img_dir: str = ""
    sem_path: str = ""
    img_downscale: float = 1.0
    sem_cfg: Optional[dict] = None
    dense_ss: bool = False
    sem_downscale: float = 8.0
    cache_dir: Optional[str] = None

    def __len__(self):
        return self.rays.shape[0]

    # ------------------------------------------------------------- validation
    def load_val_image(self, rec: ImageRecord, with_sem=False):
        """Rays + rgbs (+ semantic labels) for one whole image, cast on demand
        (reference val __getitem__, satellite_scene.py:593-613)."""
        rays = _cast_image_rays(rec.meta, self.img_downscale, self.cache_dir)
        rays = self.norm.normalize_rays(rays)
        sun = sun_direction(rec.meta["sun_elevation"], rec.meta["sun_azimuth"])
        rays = np.concatenate(
            [rays, np.tile(sun[None], (rays.shape[0], 1))], axis=-1
        ).astype(np.float32)
        img_p = os.path.join(self.img_dir, rec.meta["img"])
        rgbs = load_rgb_image(img_p, self.img_downscale)
        out = {"rays": rays, "rgbs": rgbs, "src_id": rec.img_id,
               "h": rec.h, "w": rec.w, "t": rec.t}
        if with_sem and self.sem_cfg is not None:
            sems, _ = _load_semantics(
                self.sem_path, [rec.meta], self.sem_cfg,
                dense_ss=self.dense_ss, sem_downscale=self.sem_downscale,
                img_downscale=self.img_downscale,
            )
            out["sems"] = sems
        return out

    # -------------------------------------------------------- DSM extraction
    def latlonalt_from_depth(self, rays, depth):
        """(rays (R,>=8) normalized, depth (R,)) -> lat/lon/alt of the predicted
        surface points (reference satellite_scene.py:475-505). float64 host math."""
        rays = np.asarray(rays, np.float64)
        depth = np.asarray(depth, np.float64).reshape(-1, 1)
        xyz_n = rays[:, 0:3] + rays[:, 3:6] * depth
        xyz = self.norm.denormalize_points(xyz_n)
        return ecef_to_latlon(xyz[:, 0], xyz[:, 1], xyz[:, 2])


def _read_split(json_dir, name):
    with open(os.path.join(json_dir, name)) as f:
        entries = [ln for ln in f.read().split("\n") if ln.strip()]
    return [os.path.join(json_dir, e) for e in entries]


def _scene_norm(json_dir, img_downscale, verbose=True):
    """Load scene.loc, creating it from all JSON rays if absent
    (reference init_scaling_params, satellite_scene.py:391-413)."""
    loc_path = os.path.join(json_dir, "scene.loc")
    if not os.path.exists(loc_path):
        if verbose:
            print("scene.loc not found; fitting normalization from all image rays")
        pts = []
        for json_p in sorted(glob.glob(os.path.join(json_dir, "*.json"))):
            meta = read_dict_from_json(json_p)
            rays = _cast_image_rays(meta, img_downscale)
            pts.append(rays[:, 0:3])
            pts.append(rays[:, 0:3] + rays[:, 7:8] * rays[:, 3:6])
        norm, d = SceneNorm.fit(np.concatenate(pts, axis=0))
        write_dict_to_json(d, loc_path)
        return norm
    return SceneNorm.from_scene_loc(read_dict_from_json(loc_path))


def _load_depth(depth_dir, metas, norm, img_downscale, stdscale, margin,
                verbose=True):
    """Sparse MicMac stereo depth -> per-ray supervision arrays (full image
    layout, invalid rays zero). Reference load_depth_data
    (satellite_scene.py:223-297). Missing point files yield all-invalid
    supervision (the bundled dataset strips the 3D blobs)."""
    depths_list, weights_list, stds_list, valid_list = [], [], [], []
    depth_min, depth_max = np.inf, -np.inf

    for meta in metas:
        img_id = get_file_id(meta["img"])
        h, w = int(meta["height"]), int(meta["width"])
        nh, nw = int(h / img_downscale), int(w / img_downscale)
        n_ds = nh * nw

        p2d_p = os.path.join(depth_dir, f"{img_id}_2DPts.txt")
        p3d_p = os.path.join(depth_dir, f"{img_id}_3DPts_ecef.txt")
        corr_p = os.path.join(depth_dir, f"{img_id}_Correl.txt")
        if not (os.path.exists(p2d_p) and os.path.exists(p3d_p)
                and os.path.exists(corr_p)):
            if verbose:
                print(f"depth files for {img_id} missing; no depth supervision")
            depths_list.append(np.zeros(n_ds, np.float32))
            weights_list.append(np.zeros(n_ds, np.float32))
            stds_list.append(np.zeros(n_ds, np.float32))
            valid_list.append(np.zeros(n_ds, np.float32))
            continue

        pts2d = np.loadtxt(p2d_p, dtype=np.int64).reshape(-1, 2)
        pts3d = np.loadtxt(p3d_p, dtype=np.float64).reshape(-1, 3)
        corr = np.loadtxt(corr_p, dtype=np.float64).ravel()
        spread = corr.max() - corr.min()
        # constant correlation (e.g. synthesized depth): treat as uniformly
        # reliable rather than dividing by zero
        corr = (corr - corr.min()) / spread if spread > 0 else np.ones_like(corr)

        rpc = RPCModel.from_dict(meta["rpc"]).rescaled(1.0 / img_downscale)
        cols, rows = (pts2d / img_downscale).T
        rays = norm.normalize_rays(
            cast_rays(cols, rows, rpc, float(meta["min_alt"]), float(meta["max_alt"]))
        )
        pts3d_n = norm.normalize_points(pts3d)
        depths = np.linalg.norm(pts3d_n - rays[:, 0:3], axis=1)
        std = stdscale * (1.0 - corr) + margin

        depth_min = min(depth_min, depths.min())
        depth_max = max(depth_max, depths.max())

        # scatter into the full-resolution image grid, then nearest-downscale
        def padded(values):
            full = np.zeros(h * w, np.float64)
            full[pts2d[:, 1] * w + pts2d[:, 0]] = values
            if img_downscale != 1:
                full = resize_nearest(full.reshape(h, w), nh, nw).ravel()
            return full.astype(np.float32)

        valid = np.zeros(h * w, np.float64)
        valid[pts2d[:, 1] * w + pts2d[:, 0]] = 1.0

        depths_list.append(padded(depths))
        weights_list.append(padded(corr))
        stds_list.append(padded(std))
        valid_list.append(
            resize_nearest(valid.reshape(h, w), nh, nw).ravel().astype(np.float32)
            if img_downscale != 1 else valid.astype(np.float32)
        )
        if verbose:
            print(f"depth {img_id}: {depths.shape[0]} pts "
                  f"({depths.shape[0] * 100.0 / (h * w):.3f}% of pixels), "
                  f"range [{depths.min():.5f}, {depths.max():.5f}]")

    depth_range = (depth_max - depth_min) if np.isfinite(depth_max) else 0.0
    return (
        np.stack([np.concatenate(depths_list), np.concatenate(weights_list)], axis=-1),
        np.concatenate(valid_list),
        np.concatenate(stds_list) * depth_range,
    )


def _load_semantics(sem_path, metas, sem_cfg, dense_ss, sem_downscale,
                    img_downscale=1.0, verbose=False):
    """DFC2019 CLS raster -> per-ray labels (+valid mask) for each image.

    Reference load_semantic_data (satellite_scene.py:299-389). As in the JAX
    package, the raster is sampled at the ray grid's size (the reference
    samples it at the original image size, which misaligns the labels for
    img_downscale != 1; the two agree at img_downscale=1).
    """
    raster = read_tiff(sem_path).astype(np.int64)
    mapped = np.full_like(raster, IGNORE_LABEL)
    for original, new in sem_cfg["label_mapping"].items():
        mapped[raster == original] = new
    sh, sw = mapped.shape
    sds = int(sem_downscale)

    sems_list, valid_list = [], []
    for meta in metas:
        h = int(meta["height"] // img_downscale)
        w = int(meta["width"] // img_downscale)
        if dense_ss:
            down = resize_nearest(mapped, sh // sds, sw // sds)
            labels = resize_nearest(down, h, w)
            valid = (labels != IGNORE_LABEL).astype(np.float32)
        else:
            labels = resize_nearest(mapped, h, w).copy()
            mask = np.zeros((h, w), np.float32)
            mask[0::sds, 0::sds] = 1.0
            mask *= (labels != IGNORE_LABEL).astype(np.float32)
            labels[mask == 0] = IGNORE_LABEL
            valid = mask
        sems_list.append(labels.ravel().astype(np.int32))
        valid_list.append(valid.ravel())
        if verbose:
            print(f"semantics: {valid.mean() * 100:.3f}% of pixels supervised")
    return np.concatenate(sems_list), np.concatenate(valid_list)


def load_scene(
    json_dir,
    img_dir,
    depth_dir,
    sem_dir,
    aoi_id,
    img_downscale=1.0,
    stdscale=1.0,
    margin=0.0001,
    sem=False,
    num_sem_classes=5,
    dense_ss=False,
    sem_downscale=8.0,
    load_depth=True,
    cache_dir=None,
    verbose=True,
    frame_offset=None,
) -> SatelliteScene:
    """Assemble the full training scene (+ validation records).

    frame_offset: optional (3,) translation applied in normalized space —
    multi-AOI runs give each AOI a disjoint cube (see SceneNorm)."""
    norm = _scene_norm(json_dir, img_downscale, verbose)
    if frame_offset is not None:
        norm = replace(norm, frame_offset=np.asarray(frame_offset, np.float64))
    sem_path = os.path.join(sem_dir, f"{aoi_id}_CLS.tif")
    sem_cfg = SEMANTIC_CONFIG[num_sem_classes] if sem else None

    train_json = _read_split(json_dir, "train.txt")
    test_json = _read_split(json_dir, "test.txt")

    all_rays, all_rgbs, all_ids, metas, train_recs = [], [], [], [], []
    for t, json_p in enumerate(train_json):
        if not os.path.isfile(json_p):
            if verbose:
                print(f"{json_p} missing, skipped")
            continue
        meta = read_dict_from_json(json_p)
        img_id = get_file_id(meta["img"])
        h = int(meta["height"] // img_downscale)
        w = int(meta["width"] // img_downscale)

        rays = _cast_image_rays(meta, img_downscale, cache_dir)
        rays = norm.normalize_rays(rays)
        sun = sun_direction(meta["sun_elevation"], meta["sun_azimuth"])
        rays = np.concatenate(
            [rays, np.tile(sun[None], (rays.shape[0], 1))], axis=-1
        ).astype(np.float32)

        rgbs = load_rgb_image(os.path.join(img_dir, meta["img"]), img_downscale)
        all_rays.append(rays)
        all_rgbs.append(rgbs)
        all_ids.append(np.full(rays.shape[0], t, np.int32))
        metas.append(meta)
        train_recs.append(ImageRecord(json_p, meta, img_id, t, h, w))
        if verbose:
            print(f"image {img_id} loaded ({t + 1}/{len(train_json)})")

    rays = np.concatenate(all_rays, axis=0)
    rgbs = np.concatenate(all_rgbs, axis=0)
    ids = np.concatenate(all_ids, axis=0)
    n = rays.shape[0]

    if load_depth:
        depths, valid_depth, depth_std = _load_depth(
            depth_dir, metas, norm, img_downscale, stdscale, margin, verbose
        )
    else:
        depths = np.zeros((n, 2), np.float32)
        valid_depth = np.zeros(n, np.float32)
        depth_std = np.zeros(n, np.float32)

    if sem:
        sems, valid_sem = _load_semantics(
            sem_path, metas, sem_cfg, dense_ss, sem_downscale,
            img_downscale=img_downscale, verbose=verbose,
        )
    else:
        sems = np.full(n, IGNORE_LABEL, np.int32)
        valid_sem = np.zeros(n, np.float32)

    # validation: test images, plus train image 0 for debugging
    # (reference load_val_split, satellite_scene.py:145-158)
    n_train = len(train_json)
    val_recs = []
    if train_recs:
        first = train_recs[0]
        val_recs.append(ImageRecord(first.json_path, first.meta, first.img_id, 0,
                                    first.h, first.w))
    for i, json_p in enumerate(test_json):
        meta = read_dict_from_json(json_p)
        img_id = get_file_id(meta["img"])
        val_recs.append(ImageRecord(
            json_p, meta, img_id, i + n_train,
            int(meta["height"] // img_downscale),
            int(meta["width"] // img_downscale),
        ))

    return SatelliteScene(
        rays=rays, rgbs=rgbs, ids=ids,
        depths=depths, valid_depth=valid_depth, depth_std=depth_std,
        sems=sems, valid_sem=valid_sem,
        norm=norm, train_images=train_recs, val_images=val_recs,
        img_dir=img_dir, sem_path=sem_path, img_downscale=float(img_downscale),
        sem_cfg=sem_cfg, dense_ss=dense_ss, sem_downscale=sem_downscale,
        cache_dir=cache_dir,
    )
