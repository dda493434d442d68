"""The ray store over several ranks: which pixels each rank holds.

Counterpart of ``ddnerf_tpu/parallel/distributed.py``.  The store
``[n_img, n_pix, 10]`` is split over its **pixel axis**, not its image
axis: every rank holds a contiguous 1/D block of the pixel columns of every
image, so ``single_image_mode`` keeps its meaning (all ranks draw from the
same image) and a step's draw needs no collective.  The pixel axis is first
wrap-padded to a multiple of D.

A JAX process may drive several devices and assembles one global array from
per-process slices (``global_store``, ``global_batch``).  A torch rank
drives one device and only ever holds its own block, so those two have no
counterpart here: :func:`build_sharded_store` returns this rank's block on
this rank's device.  ``jax.process_index`` / ``process_count`` become
:func:`process_index` / :func:`process_count`: the rank and the world size
of the default group, 0 and 1 without one.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def pad_store_pixels(store: np.ndarray, n_shards: int) -> np.ndarray:
    """Pad the pixel axis to a multiple of ``n_shards`` by wrapping.  The
    duplicated rays are real rays of the same images; the bias is at most
    ``(n_shards - 1) / n_pix``.  A pad larger than ``n_pix`` cycles the
    pixel axis as often as needed."""
    n_pix = store.shape[1]
    pad = (-n_pix) % n_shards
    if pad == 0:
        return store
    idx = np.arange(n_pix + pad) % n_pix
    return np.take(store, idx, axis=1)


def process_ray_slice(num_rays: int) -> slice:
    """The contiguous range of a global ray batch this rank takes."""
    n_proc, idx = process_count(), process_index()
    per = -(-num_rays // n_proc)
    return slice(idx * per, min((idx + 1) * per, num_rays))


def process_pixel_slice(n_pix_padded: int, n_shards: int) -> slice:
    """This rank's contiguous pixel-column block of the (padded) store: the
    blocks of its ``n_shards / process_count()`` shards, in rank order."""
    n_proc = process_count()
    if n_shards % n_proc:
        raise ValueError(
            f"mesh width {n_shards} must be a multiple of the process count "
            f"{n_proc}: each host feeds whole device shards")
    width = n_pix_padded // n_shards * (n_shards // n_proc)
    idx = process_index()
    return slice(idx * width, (idx + 1) * width)


def host_local_store_slice(store: np.ndarray, n_shards: int) -> np.ndarray:
    """Pad and slice a host ``[n_img, n_pix, C]`` store down to this rank's
    pixel block."""
    store = pad_store_pixels(store, n_shards)
    return store[:, process_pixel_slice(store.shape[1], n_shards)]


def build_sharded_store(host_store: np.ndarray, n_shards: int,
                        device) -> torch.Tensor:
    """This rank's ``[n_img, n_pix_padded / n_shards * (shards per rank),
    C]`` block of ``host_store``, on ``device``; no rank holds pixels it
    does not own."""
    block = np.ascontiguousarray(host_local_store_slice(host_store, n_shards))
    return torch.from_numpy(block).to(device)
