"""Evaluation metrics: PSNR and SSIM (numpy), and the LPIPS scorer.  The
port's copy of ``ddnerf_tpu/eval/metrics.py``.

Replaces the reference's metric stack (eval_nerf.py:128-160,
validation_utils/validation.py:7-16) without the skimage/lpips dependencies:

* PSNR — trivial, shared with the train loop (core.math.mse2psnr);
* SSIM — a NumPy implementation of the standard Wang et al. formulation
  matching ``skimage.metrics.structural_similarity`` defaults (7x7 uniform
  window, K1=0.01, K2=0.03).  The reference computes it twice through two
  skimage API generations (validation.py:14-15) that are numerically the same
  algorithm with different ``data_range`` handling; both variants are exposed;
* LPIPS — :class:`Lpips` over ``eval/lpips_net.py`` with local weights.
"""

from __future__ import annotations

import warnings
import zipfile
from typing import Optional, Tuple

import numpy as np


def psnr(image: np.ndarray, target: np.ndarray) -> float:
    mse = float(np.mean((np.asarray(image) - np.asarray(target)) ** 2))
    mse = max(mse, 1e-5)
    return -10.0 * np.log10(mse)


def rgb2gray(image: np.ndarray) -> np.ndarray:
    """ITU-R BT.601 luma — what cv2.cvtColor(RGB2GRAY) computes
    (validation.py:13-14)."""
    image = np.asarray(image, np.float32)
    return image[..., 0] * 0.299 + image[..., 1] * 0.587 + image[..., 2] * 0.114


def _uniform_filter(x: np.ndarray, size: int) -> np.ndarray:
    """Mean filter with reflect-symmetric padding (scipy/skimage default)."""
    pad = size // 2
    x = np.pad(x, pad, mode="symmetric")
    c = np.cumsum(np.cumsum(x, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)))
    s = (
        c[size:, size:]
        - c[:-size, size:]
        - c[size:, :-size]
        + c[:-size, :-size]
    )
    return s / (size * size)


def ssim(
    image: np.ndarray,
    target: np.ndarray,
    data_range: Optional[float] = None,
    win_size: int = 7,
    k1: float = 0.01,
    k2: float = 0.03,
) -> float:
    """Grayscale SSIM, skimage-compatible (uniform window, sample covariance
    normalization N/(N-1))."""
    im = np.asarray(image, np.float64)
    tg = np.asarray(target, np.float64)
    if data_range is None:
        # Legacy compare_ssim default for float inputs: range of the joint
        # dtype (1.0 for [0,1] floats is wrong; skimage used im.max-im.min
        # only if specified).  We follow the modern API: caller supplies it.
        data_range = 1.0

    n = win_size**2
    cov_norm = n / (n - 1)

    ux = _uniform_filter(im, win_size)
    uy = _uniform_filter(tg, win_size)
    uxx = _uniform_filter(im * im, win_size)
    uyy = _uniform_filter(tg * tg, win_size)
    uxy = _uniform_filter(im * tg, win_size)

    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    a1 = 2 * ux * uy + c1
    a2 = 2 * vxy + c2
    b1 = ux**2 + uy**2 + c1
    b2 = vx + vy + c2
    s = (a1 * a2) / (b1 * b2)

    pad = (win_size - 1) // 2
    return float(s[pad:-pad, pad:-pad].mean())


def calc_ssim(image: np.ndarray, target: np.ndarray) -> Tuple[float, float]:
    """The reference's two-variant SSIM (validation.py:7-16): v1 via the
    legacy ``compare_ssim`` (whose float default assumed the dtype range
    [-1, 1], i.e. data_range=2), v2 via the modern API with
    ``data_range = image.max() - image.min()``."""
    image_gray = rgb2gray(image)
    target_gray = rgb2gray(target)
    v1 = ssim(target_gray, image_gray, data_range=2.0)
    v2 = ssim(
        target_gray, image_gray,
        data_range=float(image_gray.max() - image_gray.min()),
    )
    return v1, v2


class Lpips:
    """AlexNet-LPIPS scorer on ``device``; requires local weights.

    ``weights_path`` is an ``.npz`` with AlexNet conv kernels and the LPIPS
    linear weights (``eval/lpips_net.py``).  Without a path, ``available``
    is False and ``__call__`` returns None: eval then omits the metric from
    results.txt (the reference hard-depends on downloading AlexNet,
    eval_nerf.py:92).  A path that cannot be read does the same with one
    warning, where the JAX class is silent."""

    def __init__(self, weights_path: Optional[str] = None, device="cpu"):
        self.available = False
        self._weights = None
        if weights_path is None:
            return
        from ddnerf_tpu_torch.eval.lpips_net import load_weights

        try:
            self._weights = load_weights(weights_path, device)
        except (OSError, ValueError, zipfile.BadZipFile) as e:
            warnings.warn(f"LPIPS weights {weights_path!r} unreadable "
                          f"({type(e).__name__}: {e}): lpips_coarse / "
                          "lpips_fine are left out of results.txt",
                          stacklevel=2)
            return
        self.available = True

    def __call__(self, image: np.ndarray, target: np.ndarray
                 ) -> Optional[float]:
        if not self.available:
            return None
        from ddnerf_tpu_torch.eval.lpips_net import lpips_distance

        return float(lpips_distance(self._weights, image, target))
