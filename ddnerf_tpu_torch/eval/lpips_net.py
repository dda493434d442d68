"""AlexNet-LPIPS in torch.

Counterpart of ``ddnerf_tpu/eval/lpips_net.py``: the perceptual metric of
Zhang et al. 2018 as the reference uses it (eval_nerf.py:92,
``lpips.LPIPS(net='alex')``): AlexNet conv features at 5 taps, each
unit-normalized over its channels, squared differences weighted by the
1x1 linear heads, the spatial mean, summed over the taps.

Weights come from a local ``.npz`` (no download): ``conv{0..4}_w`` (OIHW),
``conv{0..4}_b`` and ``lin{0..4}_w`` ([C]), the file that
``scripts/convert_lpips_weights.py`` writes for both packages; it is read
with numpy.

The convolutions are ``F.conv2d``, as the JAX package's are XLA
convolutions outside any Pallas kernel.  On a CUDA device cuDNN would run
them in TF32 (``torch.backends.cudnn.allow_tf32`` defaults to True), which
moves the distance by about 1e-3 from the float32 value: the metric is
computed inside ``torch.backends.cudnn.flags(allow_tf32=False)``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

# AlexNet's feature extractor: (out_ch, kernel, stride, pad), with
# maxpool(3, 2) after taps 0 and 1 (torchvision's layout).
_CONVS = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]

# LPIPS's scaling layer (ImageNet normalization).
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def load_weights(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """The ``.npz`` at ``path`` -> float32 tensors on ``device``."""
    with np.load(path) as data:
        return {k: torch.tensor(np.asarray(data[k], np.float32), device=device)
                for k in data.files}


def _features(weights: Dict[str, torch.Tensor], x: torch.Tensor):
    taps = []
    for i, (_, _, stride, pad) in enumerate(_CONVS):
        x = F.conv2d(x, weights[f"conv{i}_w"], weights[f"conv{i}_b"],
                     stride=stride, padding=pad)
        x = F.relu(x)
        taps.append(x)
        if i in (0, 1):
            x = F.max_pool2d(x, kernel_size=3, stride=2)
    return taps


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(x ** 2, dim=1, keepdim=True))
    return x / (norm + eps)


@torch.no_grad()
def lpips_distance(weights: Dict[str, torch.Tensor], image,
                   target) -> torch.Tensor:
    """image / target: ``[H, W, 3]`` numpy arrays in [0, 1] -> the
    0-d LPIPS distance, on the weights' device."""
    dev = weights["conv0_w"].device
    shift = torch.tensor(_SHIFT, device=dev)
    scale = torch.tensor(_SCALE, device=dev)

    def prep(img):
        img = torch.as_tensor(np.ascontiguousarray(img, np.float32),
                              device=dev)
        img = (img * 2.0 - 1.0 - shift) / scale
        return img.permute(2, 0, 1)[None]  # NCHW

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        taps0 = _features(weights, prep(image))
        taps1 = _features(weights, prep(target))
    total = torch.zeros((), device=dev)
    for i, (f0, f1) in enumerate(zip(taps0, taps1)):
        d = (_unit_normalize(f0) - _unit_normalize(f1)) ** 2
        lin = weights[f"lin{i}_w"].reshape(1, -1, 1, 1)
        total = total + torch.mean(torch.sum(d * lin, dim=1))
    return total
