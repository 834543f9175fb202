"""Validation/eval output images: depth, DSM, rgb, semantics, shadow-model maps.

`spnerf_tpu/evaluation/outputs.py`: the reference SP-NeRF's output-directory
contract (its `eval.py:27-101` writes logs/{val,train}/{depth,dsm,rgb,gt_rgb,
semantic,sun,albedo,beta,sky}/{src_id}_epoch{N}.tif), so downstream tooling can
consume either package's runs.

cv2 / rasterio replaced by matplotlib colormaps (imported where used) + the
self-contained GeoTIFF writer (`spnerf_torch.io.tiff`).
"""

import os

import numpy as np

from ..config import SEMANTIC_CONFIG
from ..io import write_geotiff
from .dsm import dsm_from_latlonalt


def visualize_depth(depth):
    """Depth map -> (H, W, 3) uint8 jet colormap (reference
    modules/utils.py:324-340 uses cv2 COLORMAP_JET; matplotlib 'jet' here)."""
    import matplotlib

    x = np.nan_to_num(np.asarray(depth, np.float64))
    mi, ma = x.min(), x.max()
    x = (x - mi) / (ma - mi + 1e-8)
    return (matplotlib.colormaps["jet"](x)[..., :3] * 255).astype(np.uint8)


def convert_semantic_to_color(sem_pred, num_sem_classes):
    """(H, W) class indices -> (H, W, 3) uint8 colors
    (reference modules/utils.py:369-390)."""
    color_mapping = SEMANTIC_CONFIG[num_sem_classes]["color_mapping"]
    out = np.full(sem_pred.shape + (3,), 255, np.uint8)
    for label, color in color_mapping.items():
        out[sem_pred == label] = color
    return out


def remap_semantics_to_original(sem_pred, num_sem_classes):
    """Internal indices -> DFC2019 class IDs, 65 (unlabeled) elsewhere
    (reference modules/utils.py:393-410)."""
    class_mapping = SEMANTIC_CONFIG[num_sem_classes]["class_mapping"]
    out = np.full_like(sem_pred, 65, dtype=np.int32)
    for idx, cid in class_mapping.items():
        out[sem_pred == idx] = cid
    return out


def save_sem_image(sem_pred, output_path, num_sem_classes):
    """Colored semantic PNG with a class legend (+ _no_legend variant), like
    reference modules/utils.py:413-463. Where matplotlib does not import,
    one line names the two PNGs, which are not written (the JAX package
    raises; the semantic GeoTIFF beside them carries the prediction)."""
    paths = (output_path, os.path.splitext(output_path)[0] + "_no_legend"
             + os.path.splitext(output_path)[1])
    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib is not installed: {' and '.join(paths)} not "
              "written")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    color_mapping = SEMANTIC_CONFIG[num_sem_classes]["color_mapping"]
    names = SEMANTIC_CONFIG[num_sem_classes]["semantic_names"]
    vis = convert_semantic_to_color(sem_pred.astype(np.uint8), num_sem_classes)

    os.makedirs(os.path.dirname(output_path), exist_ok=True)
    for with_legend, path in zip((True, False), paths):
        plt.figure(figsize=(12, 12))
        plt.imshow(vis, interpolation="nearest")
        plt.axis("off")
        if with_legend:
            handles = [
                plt.Line2D([0], [0], marker="o", color="w", label=names[k],
                           markerfacecolor=np.array(color_mapping[k]) / 255,
                           markersize=10, linestyle="None")
                for k in sorted(names)
            ]
            plt.legend(handles=handles, loc="upper right", title="Classes")
        plt.savefig(path, bbox_inches="tight", pad_inches=0, dpi=300)
        plt.close()


def _save_image(arr_chw, out_path):
    """(C, H, W) float -> float32 GeoTIFF (profile-free; the reference copies the
    source image's profile, which only matters for georeferenced viewers)."""
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    arr = np.asarray(arr_chw, np.float32)
    write_geotiff(out_path, np.moveaxis(arr, 0, -1))


def _composited(results, typ, key):
    """Per-ray value for `key`: the lean render path (`render.build_render_fn`)
    composites sun/albedo/sky/beta on device; per-sample (R, S, C) arrays from
    the full path are weight-composited here (reference eval.py:60-101)."""
    v = np.asarray(results[f"{key}_{typ}"])
    if v.ndim == 3:
        w = np.asarray(results[f"weights_{typ}"])[..., None]
        v = np.sum(w * v, axis=-2)
    return v


def save_nerf_output_to_images(scene, sample, results, out_dir, epoch_number,
                               num_sem_classes, label=None, device=None):
    """Write the full set of per-image outputs for one rendered view.

    scene: SatelliteScene (for DSM extraction); sample: dict with rays (R,11),
    rgbs (R,3), src_id, h, w; results: renderer output dict (numpy). `label`
    overrides the filename stem. The DSM is splatted on `device`."""
    rays = np.asarray(sample["rays"])
    rgbs = np.asarray(sample["rgbs"])
    src_id = label or sample["src_id"]
    h, w = int(sample["h"]), int(sample["w"])
    typ = "fine" if "rgb_fine" in results else "coarse"

    depth = np.asarray(results[f"depth_{typ}"])
    lats, lons, alts = scene.latlonalt_from_depth(rays, depth)

    _save_image(alts.reshape(1, h, w),
                f"{out_dir}/depth/{src_id}_epoch{epoch_number}.tif")

    gt_roi = None
    dsm_path = f"{out_dir}/dsm/{src_id}_epoch{epoch_number}.tif"
    dsm_from_latlonalt(lats, lons, alts, roi_txt=gt_roi, dsm_path=dsm_path,
                       device=device)

    img = np.moveaxis(np.asarray(results[f"rgb_{typ}"]).reshape(h, w, 3), -1, 0)
    _save_image(img, f"{out_dir}/rgb/{src_id}_epoch{epoch_number}.tif")
    img_gt = np.moveaxis(rgbs.reshape(h, w, 3), -1, 0)
    _save_image(img_gt, f"{out_dir}/gt_rgb/{src_id}_epoch{epoch_number}.tif")

    if f"sem_logits_{typ}" in results:
        sem_pred = np.argmax(results[f"sem_logits_{typ}"], axis=-1).reshape(h, w)
        remapped = remap_semantics_to_original(sem_pred, num_sem_classes)
        _save_image(remapped[None].astype(np.float32),
                    f"{out_dir}/semantic/{src_id}_epoch{epoch_number}.tif")
        save_sem_image(sem_pred, f"{out_dir}/semantic/{src_id}_epoch{epoch_number}.png",
                       num_sem_classes)

    if f"sun_{typ}" in results:
        s_v = _composited(results, typ, "sun")
        _save_image(s_v.reshape(h, w).reshape(1, h, w),
                    f"{out_dir}/sun/{src_id}_epoch{epoch_number}.tif")
        albedo = _composited(results, typ, "albedo")
        _save_image(np.moveaxis(albedo.reshape(h, w, 3), -1, 0),
                    f"{out_dir}/albedo/{src_id}_epoch{epoch_number}.tif")
        if f"beta_{typ}" in results:
            beta = _composited(results, typ, "beta")
            _save_image(beta.reshape(1, h, w),
                        f"{out_dir}/beta/{src_id}_epoch{epoch_number}.tif")
        if f"sky_{typ}" in results:
            sky = _composited(results, typ, "sky")
            _save_image(np.moveaxis(sky.reshape(h, w, 3), -1, 0),
                        f"{out_dir}/sky/{src_id}_epoch{epoch_number}.tif")

    return dsm_path
