"""Plain PyTorch version of the fused-MLP forward kernel, at the kernel's
interface: flat ray-major rows and per-ray view directions.

Counterpart of ``ddnerf_tpu/kernels/fused_mlp.py::_reference_apply``.  The
arithmetic is the module's own forward (:mod:`ddnerf_tpu_torch.models.mlp`:
operands rounded to the compute dtype, float32 products and activations),
so the kernel, this function and the module agree up to summation order.
"""

from __future__ import annotations

import torch


def fused_mlp_reference(net, ipe: torch.Tensor, dirs: torch.Tensor,
                        samples_per_ray: int) -> torch.Tensor:
    """``ipe [N, 96]`` (row ``r`` belongs to ray ``r // K``), ``dirs
    [N // K, 27]`` -> ``[N, 4|6]`` float32.  Runs on any device; on a GPU
    the caller keeps TF32 off."""
    k = samples_per_ray
    rays = ipe.shape[0] // k
    out = net(ipe.float().reshape(rays, k, ipe.shape[1]), dirs.float())
    return out.reshape(rays * k, out.shape[-1])
