"""Depth pictures (`spnerf_tpu/visualization/depth.py`): the sparse input
depth as a padded image, over its source image and beside it, and a DSM as
a viridis PNG.

matplotlib is imported only where a PNG is drawn. Where it does not
import, each function prints one line naming the PNGs it does not write
and returns.
"""

import numpy as np

from ..io import read_geotiff, read_tiff


def _pyplot(paths):
    """matplotlib's pyplot on the Agg backend, or None after naming the
    PNGs that are not written."""
    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib is not installed: {' and '.join(paths)} not "
              "written")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def padded_depth_image(image_shape, points_2d, values):
    """Sparse per-pixel values ((N, 2) [col, row] points) scattered into a
    NaN-padded (H, W) image."""
    h, w = image_shape[:2]
    out = np.full((h, w), np.nan)
    pts = np.asarray(points_2d, np.int64)
    vals = np.asarray(values, np.float64)
    ok = (pts[:, 0] >= 0) & (pts[:, 0] < w) & (pts[:, 1] >= 0) & (pts[:, 1] < h)
    out[pts[ok, 1], pts[ok, 0]] = vals[ok]
    return out


def visualize_depth_points(pts2d_path, pts3d_path, image_path, out_prefix):
    """`<out_prefix>_raw.png` (the depth image), `_overlay.png` (over the
    image) and `_side_by_side.png`; returns the depth image."""
    pts2d = np.loadtxt(pts2d_path, dtype=np.int64).reshape(-1, 2)
    pts3d = np.loadtxt(pts3d_path, dtype=np.float64).reshape(-1, 3)
    img = read_tiff(image_path)
    depth = padded_depth_image(img.shape, pts2d, pts3d[:, 2])
    plt = _pyplot([f"{out_prefix}_{k}.png"
                   for k in ("raw", "overlay", "side_by_side")])
    if plt is None:
        return depth

    plt.figure(figsize=(7, 7))
    im = plt.imshow(depth, cmap="viridis", interpolation="nearest")
    plt.axis("off")
    plt.colorbar(im, label="Depth (Z value)")
    plt.savefig(f"{out_prefix}_raw.png", dpi=300, bbox_inches="tight")
    plt.close()

    overlay_depth_on_image(img, depth, f"{out_prefix}_overlay.png")

    fig, axes = plt.subplots(1, 2, figsize=(14, 7))
    axes[0].imshow(img)
    axes[0].set_axis_off()
    axes[1].imshow(depth, cmap="viridis", interpolation="nearest")
    axes[1].set_axis_off()
    plt.savefig(f"{out_prefix}_side_by_side.png", dpi=300, bbox_inches="tight")
    plt.close()
    return depth


def overlay_depth_on_image(image, depth_image, output_path, alpha=0.6):
    """The depth scatter over its source image."""
    plt = _pyplot([output_path])
    if plt is None:
        return
    plt.figure(figsize=(7, 7))
    plt.imshow(image)
    masked = np.ma.masked_invalid(depth_image)
    plt.imshow(masked, cmap="viridis", alpha=alpha, interpolation="nearest")
    plt.axis("off")
    plt.savefig(output_path, dpi=300, bbox_inches="tight", pad_inches=0)
    plt.close()


def visualize_dsm(dsm_path, output_path):
    """A DSM GeoTIFF as a viridis PNG, empty cells at the lowest altitude;
    returns output_path, or None where matplotlib is missing."""
    plt = _pyplot([output_path])
    if plt is None:
        return None
    dsm, _ = read_geotiff(dsm_path)
    dsm = np.asarray(dsm, np.float64)
    dsm_min = np.nanmin(dsm)
    dsm = np.nan_to_num(dsm, nan=dsm_min)

    plt.figure(figsize=(10, 8))
    plt.imshow(dsm, cmap="viridis", vmin=dsm_min, vmax=np.nanmax(dsm))
    plt.colorbar()
    plt.axis("off")
    plt.savefig(output_path, dpi=300, bbox_inches="tight", pad_inches=0)
    plt.close()
    return output_path
