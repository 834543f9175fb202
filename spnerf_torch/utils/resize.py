"""Image resizing that reproduces torch.nn.functional.interpolate semantics.

The reference SP-NeRF resizes rgbs with torchvision `T.Resize(..., BILINEAR)` on
tensors (= F.interpolate bilinear, align_corners=False, no antialias) and
depth/semantic rasters with F.interpolate 'nearest'. These numpy copies of
`spnerf_tpu/utils/resize.py` pin the exact pixel values on the host, as the JAX
package does.

Host-side only (data preparation); not on the training hot path.
"""

import numpy as np


def _source_coords_bilinear(out_size, in_size):
    """align_corners=False source coordinates: (i + 0.5) * scale - 0.5."""
    scale = in_size / out_size
    return (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5


def resize_bilinear(img, out_h, out_w):
    """Bilinear resize of (H, W) or (H, W, C) float array, torch semantics
    (align_corners=False, no antialias)."""
    img = np.asarray(img, dtype=np.float64)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    in_h, in_w, _ = img.shape

    ys = _source_coords_bilinear(out_h, in_h)
    xs = _source_coords_bilinear(out_w, in_w)

    y0 = np.clip(np.floor(ys).astype(np.int64), 0, in_h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, in_w - 1)
    y1 = np.clip(y0 + 1, 0, in_h - 1)
    x1 = np.clip(x0 + 1, 0, in_w - 1)
    wy = np.clip(ys - np.floor(ys), 0.0, 1.0)
    wx = np.clip(xs - np.floor(xs), 0.0, 1.0)
    # clamp the interpolation weight at the borders like torch (coords < 0 -> 0)
    wy = np.where(ys < 0, 0.0, wy)
    wx = np.where(xs < 0, 0.0, wx)

    top = img[y0][:, x0] * (1 - wx)[None, :, None] + img[y0][:, x1] * wx[None, :, None]
    bot = img[y1][:, x0] * (1 - wx)[None, :, None] + img[y1][:, x1] * wx[None, :, None]
    out = top * (1 - wy)[:, None, None] + bot * wy[:, None, None]
    return out[:, :, 0] if squeeze else out


def resize_nearest(img, out_h, out_w):
    """Nearest resize of (H, W) or (H, W, C), torch 'nearest' semantics:
    src_idx = floor(dst_idx * in/out)."""
    img = np.asarray(img)
    in_h, in_w = img.shape[:2]
    ys = np.minimum((np.arange(out_h) * (in_h / out_h)).astype(np.int64), in_h - 1)
    xs = np.minimum((np.arange(out_w) * (in_w / out_w)).astype(np.int64), in_w - 1)
    return img[ys][:, xs]
