"""Image metrics: PSNR, SSIM, mIoU, overall accuracy.

The definitions of the JAX package's `evaluation/metrics.py`: PSNR with a
peak of 1.0; SSIM with kornia-0.5.3 semantics (3x3 Gaussian window of sigma
1.5, reflect padding, C1 = 0.01^2, C2 = 0.03^2, mean of the index map);
mIoU with empty-union classes counting IoU 0. Results are 0-dim tensors.
"""

import numpy as np
import torch
import torch.nn.functional as F


def mse(pred, gt, valid_mask=None):
    err = (pred - gt) ** 2
    if valid_mask is not None:
        maskf = valid_mask.to(err.dtype)
        return torch.sum(err * maskf) / torch.clamp_min(
            torch.sum(maskf) * err[0].numel(), 1.0)
    return torch.mean(err)


def psnr(pred, gt, valid_mask=None):
    return -10.0 * torch.log10(mse(pred, gt, valid_mask))


def _gaussian_kernel2d(window_size, sigma):
    half = (window_size - 1) / 2.0
    x = np.arange(window_size, dtype=np.float64) - half
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def _filter2d_reflect(img, kernel):
    """Depthwise filtering with reflect padding. img: (C, H, W)."""
    k = kernel.shape[0]
    pad = k // 2
    h, w = img.shape[1], img.shape[2]
    padded = F.pad(img[None], (pad, pad, pad, pad), mode="reflect")[0]
    out = torch.zeros_like(img)
    for dy in range(k):
        for dx in range(k):
            out = out + float(kernel[dy, dx]) * padded[:, dy:dy + h, dx:dx + w]
    return out


def ssim(pred, gt, window_size=3, max_val=1.0):
    """Mean SSIM of two (C, H, W) or (H, W, C) images in [0, 1]."""
    pred = torch.as_tensor(pred, dtype=torch.float32)
    gt = torch.as_tensor(gt, dtype=torch.float32, device=pred.device)
    if (pred.ndim == 3 and pred.shape[-1] in (1, 3)
            and pred.shape[0] not in (1, 3)):
        pred = torch.movedim(pred, -1, 0)
        gt = torch.movedim(gt, -1, 0)
    kernel = _gaussian_kernel2d(window_size, 1.5)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2

    mu1 = _filter2d_reflect(pred, kernel)
    mu2 = _filter2d_reflect(gt, kernel)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _filter2d_reflect(pred * pred, kernel) - mu1_sq
    sigma2_sq = _filter2d_reflect(gt * gt, kernel) - mu2_sq
    sigma12 = _filter2d_reflect(pred * gt, kernel) - mu1_mu2
    ssim_map = ((2.0 * mu1_mu2 + c1) * (2.0 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return torch.mean(ssim_map)


def miou(pred_labels, gt_labels, num_classes):
    """Mean IoU over classes; empty-union classes count as IoU 0."""
    pred = torch.as_tensor(pred_labels).reshape(-1)
    gt = torch.as_tensor(gt_labels).reshape(-1).to(pred.device)
    ious = []
    for cls in range(num_classes):
        p, g = pred == cls, gt == cls
        inter = torch.sum(p & g).float()
        union = torch.sum(p | g).float()
        ious.append(torch.where(union == 0, torch.zeros_like(union),
                                inter / torch.clamp_min(union, 1.0)))
    return torch.mean(torch.stack(ious))


def overall_accuracy(pred_labels, gt_labels):
    pred = torch.as_tensor(pred_labels).reshape(-1)
    gt = torch.as_tensor(gt_labels).reshape(-1).to(pred.device)
    return torch.mean((pred == gt).float())
