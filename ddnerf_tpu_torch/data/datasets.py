"""The device-resident ray store and random ray batches from it.

Counterpart of ``ddnerf_tpu/data/datasets.py::sample_rays_on_device``
(reference dataset.py:50-59, without its per-step host transfer).  The
store itself is the JAX package's framework-free
``TrainRayDataset.device_store()`` (``[n_img, n_pix, 10]`` =
``[ro(3), rd(3), radius(1), rgb(3)]``), moved to the device once.
"""

from __future__ import annotations

import torch

from ddnerf_tpu.data.assembly import get_datasets
from ddnerf_tpu_torch.config import Config


def load_train_store(cfg: Config, device):
    """Build the datasets of ``cfg`` and move the training ray store to
    ``device`` -> (store ``[n_img, n_pix, 10]``, validation dataset, cfg).
    The returned cfg carries the near/far that pose normalization may have
    rescaled.  A store above ``parallel.max_store_gb`` is an error: host-side
    ray sampling is not ported yet."""
    train_ds, val_ds, cfg = get_datasets(cfg)
    host_store = train_ds.device_store()
    limit = cfg.parallel.max_store_gb * 1024**3
    if host_store.nbytes >= limit:
        raise ValueError(
            f"the ray store is {host_store.nbytes / 1024**3:.2f} GiB, above "
            f"parallel.max_store_gb={cfg.parallel.max_store_gb}: host-side "
            "ray sampling is not ported yet")
    return torch.from_numpy(host_store).to(device), val_ds, cfg


def sample_rays_on_device(store: torch.Tensor, generator: torch.Generator,
                          num_rays: int, single_image_mode: bool):
    """``num_rays`` random rows of ``store`` -> (ro [R, 3], rd [R, 3],
    radii [R, 1], rgb [R, 3]).  ``single_image_mode`` draws every ray from
    one random image (the reference's blender default).  ``generator``
    lives on the store's device."""
    n_img, n_pix, _ = store.shape
    dev = store.device
    if single_image_mode:
        img = torch.randint(0, n_img, (), generator=generator, device=dev)
        idx = torch.randint(0, n_pix, (num_rays,), generator=generator,
                            device=dev)
        rows = store[img, idx]
    else:
        flat = torch.randint(0, n_img * n_pix, (num_rays,),
                             generator=generator, device=dev)
        rows = store.reshape(n_img * n_pix, -1)[flat]
    return rows[:, 0:3], rows[:, 3:6], rows[:, 6:7], rows[:, 7:10]
