"""ddnerf_tpu_torch — the PyTorch/CUDA port of :mod:`ddnerf_tpu` for NVIDIA
Hopper GPUs.

The package mirrors the JAX package's layout so each module's counterpart
is easy to find:

* :mod:`ddnerf_tpu_torch.core` — frustum Gaussians, IPE, samplers, volume
  rendering (plain torch on tensors);
* :mod:`ddnerf_tpu_torch.models` — the MLPs as ``nn.Module`` s and the
  coarse→fine render pipeline;
* :mod:`ddnerf_tpu_torch.kernels` — hand-written ``sm_90a`` CUDA kernels,
  each beside its plain PyTorch version;
* :mod:`ddnerf_tpu_torch.render` / :mod:`ddnerf_tpu_torch.eval` /
  :mod:`ddnerf_tpu_torch.cli` — chunked whole-image rendering, the eval
  entry point and its command line.

The package stands alone: it imports nothing of :mod:`ddnerf_tpu`, not even
the modules there that hold no JAX code.  It keeps its own config
(:mod:`ddnerf_tpu_torch.config`), data loaders and ray datasets
(:mod:`ddnerf_tpu_torch.data`), PSNR/SSIM metrics
(:mod:`ddnerf_tpu_torch.eval.metrics`) and results writer and documenter
(:mod:`ddnerf_tpu_torch.viz`), under the same module names.  Nothing here
imports JAX, Flax, Optax or Orbax, nor imageio or matplotlib: image files
and figures go through PIL and the standard library.
"""

__version__ = "0.1.0"
