"""Reconstruction and generation metrics: PSNR, SSIM, FID statistics
(``deco_tpu/train/metrics.py``).

The per-image functions take NHWC tensors on any device and compute in
fp32 there; the FID moments are float64 on the host. FID follows the ADM
protocol: Inception activations -> (mu, sigma) -> Frechet distance, with
the matrix square root taken by eigendecomposition (no scipy).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from deco_tpu_torch.models.inception import compute_fid_features, random_inception


def psnr(pred, target, data_range: float = 255.0):
    """Mean over the batch of each image's PSNR (the per-image-mean variant;
    the production protocol pools one squared error over the epoch:
    :func:`squared_error_stats` and :func:`psnr_from_stats`)."""
    mse = ((pred.float() - target.float()) ** 2).mean(dim=(1, 2, 3))
    return (20 * np.log10(data_range) - 10 * torch.log10(mse + 1e-12)).mean()


def squared_error_stats(pred, target):
    """(sum of squared error, element count) as Python floats: the
    torchmetrics ``PeakSignalNoiseRatio(dim=None)`` state. Plain sums, so
    batches merge by addition; accumulate them in float64 on the host. The
    sum is taken in float64 (exact for uint8-range integers), where the JAX
    package sums in float32."""
    sse = ((pred.double() - target.double()) ** 2).sum()
    return float(sse), float(pred.numel())


def psnr_from_stats(sse: float, n_obs: float, data_range: float = 255.0):
    """Global-MSE PSNR ``10 log10(range^2 n / sse)``; ``inf`` for sse == 0, as
    torchmetrics gives."""
    mse = sse / max(n_obs, 1.0)
    if mse == 0.0:
        return float("inf")
    return float(20 * np.log10(data_range) - 10 * np.log10(mse))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(pred, target, data_range: float = 255.0, kernel_size: int = 11,
         sigma: float = 1.5, per_image: bool = False):
    """Structural similarity over NHWC batches: Gaussian window (11, 1.5),
    k1 = 0.01, k2 = 0.03, the VALID-window map averaged (torchmetrics
    ``StructuralSimilarityIndexMeasure`` defaults: it reflect-pads, filters
    and crops the pad back off). ``per_image`` gives the (B,) per-image means."""
    pred = pred.float().permute(0, 3, 1, 2)
    target = target.float().permute(0, 3, 1, 2)
    c = pred.shape[1]
    kernel = torch.from_numpy(_gaussian_kernel(kernel_size, sigma)).to(pred.device)
    kernel = kernel.expand(c, 1, kernel_size, kernel_size)

    def filt(x):
        return F.conv2d(x, kernel, groups=c)

    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_p, mu_t = filt(pred), filt(target)
    mu_p2, mu_t2, mu_pt = mu_p**2, mu_t**2, mu_p * mu_t
    sig_p = filt(pred**2) - mu_p2
    sig_t = filt(target**2) - mu_t2
    sig_pt = filt(pred * target) - mu_pt
    num = (2 * mu_pt + c1) * (2 * sig_pt + c2)
    den = (mu_p2 + mu_t2 + c1) * (sig_p + sig_t + c2)
    ratio = num / den
    return ratio.mean(dim=(1, 2, 3)) if per_image else ratio.mean()


class FIDStats:
    """Streaming (mu, sigma) of (N, D) activation batches, float64 moments."""

    def __init__(self, dim: int):
        self.n = 0
        self.s1 = np.zeros((dim,), np.float64)
        self.s2 = np.zeros((dim, dim), np.float64)

    def update(self, acts: np.ndarray):
        acts = np.asarray(acts, np.float64)
        self.n += acts.shape[0]
        self.s1 += acts.sum(0)
        self.s2 += acts.T @ acts

    def merge(self, other: "FIDStats"):
        self.n += other.n
        self.s1 += other.s1
        self.s2 += other.s2

    def finalize(self):
        mu = self.s1 / self.n
        cov = self.s2 / (self.n - 1) - np.outer(mu, mu) * self.n / (self.n - 1)
        return mu, cov


def frechet_distance(mu1, cov1, mu2, cov2, eps: float = 1e-6) -> float:
    """Frechet distance of two Gaussians. tr sqrtm(cov1 cov2) is taken as
    tr sqrtm(sqrt(cov1) cov2 sqrt(cov1)), a symmetric matrix, by two
    eigendecompositions (negative eigenvalues of round-off clipped to 0).
    ``eps`` is accepted for the JAX signature and unused there too."""
    mu1, mu2 = np.asarray(mu1), np.asarray(mu2)
    cov1, cov2 = np.asarray(cov1), np.asarray(cov2)
    diff = mu1 - mu2
    vals1, vecs1 = np.linalg.eigh(cov1)
    sqrt1 = (vecs1 * np.sqrt(np.clip(vals1, 0, None))) @ vecs1.T
    inner = sqrt1 @ cov2 @ sqrt1
    vals, _ = np.linalg.eigh((inner + inner.T) / 2)
    tr_sqrt = np.sqrt(np.clip(vals, 0, None)).sum()
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2 * tr_sqrt)


def to_unit_range(images) -> np.ndarray:
    """float32 [0, 1] images from uint8-range or [0, 1] ones (max > 1.5
    means uint8 range, the JAX package's test)."""
    arr = np.asarray(images, np.float32)
    return arr / 255.0 if arr.max() > 1.5 else arr


def fid_from_images(images01_a, images01_b, tower=None, batch_size: int = 64,
                    device="cuda") -> float:
    """FID between two image sets ([0, 1] or uint8-range NHWC) through the
    Inception ``tower`` (default: :func:`~deco_tpu_torch.models.inception.random_inception`
    on ``device``, whose FIDs compare only with each other)."""
    if tower is None:
        tower = random_inception(device=device)
    stats = []
    for images in (images01_a, images01_b):
        feats = compute_fid_features(to_unit_range(images), tower, batch_size)
        s = FIDStats(feats.shape[1])
        s.update(feats)
        stats.append(s.finalize())
    return frechet_distance(*stats[0], *stats[1])
