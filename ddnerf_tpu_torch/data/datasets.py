"""Ray datasets: the host-side precompute (numpy), the device-resident ray
store and random ray batches from it.

Counterpart of ``ddnerf_tpu/data/datasets.py``.  ``TrainRayDataset``
precomputes every ray of every training image on the host (reference
dataset.py:28-48); its ``device_store()`` (``[n_img, n_pix, 10]`` =
``[ro(3), rd(3), radius(1), rgb(3)]``) moves to the device once and
:func:`sample_rays_on_device` draws each step's batch there (reference
dataset.py:50-59, without its per-step host transfer).  ``ValRayDataset``
serves whole validation images and render poses.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.core.rays import get_ray_bundle_np, ndc_mipnerf_rays


class TrainRayDataset:
    """Precomputes all training rays; samples random ray batches.

    Mirrors ``TrainDataset`` (dataset.py:8-59) including ``single_image_mode``
    (all rays of one random image per iteration).
    """

    def __init__(self, poses, images, focal, ndc_rays=False, single_image_mode=False):
        images = np.asarray(images, dtype=np.float32)
        poses = np.asarray(poses, dtype=np.float32)
        self.images = images
        self.poses = poses
        self.H, self.W = images.shape[1], images.shape[2]
        self.focal = focal
        self.ndc = ndc_rays
        self.near_plane = 1.0  # NDC projection near plane (dataset.py:26)
        self.single_image_mode = single_image_mode

        n = images.shape[0]
        npix = self.H * self.W
        self.origins = np.empty((n, npix, 3), np.float32)
        self.directions = np.empty((n, npix, 3), np.float32)
        self.radii = np.empty((n, npix, 1), np.float32)
        self.target = images[..., :3].reshape(n, npix, 3)

        for i in range(n):
            ro, rd, radii = get_ray_bundle_np(self.H, self.W, focal, poses[i])
            if self.ndc:
                ro, rd, radii = ndc_mipnerf_rays(
                    self.H, self.W, focal, ro, rd, self.near_plane
                )
                radii = radii[..., None]
            self.origins[i] = ro.reshape(-1, 3)
            self.directions[i] = rd.reshape(-1, 3)
            self.radii[i] = radii.reshape(-1, 1)

        self.num_rays = n * npix

    # ------------------------------------------------- host-side sampling

    def sample_batch(self, rng: np.random.Generator, num_rays: int):
        """Host-side random ray batch (parity with dataset.py:50-59).
        Returns numpy (origins, directions, radii, rgb)."""
        if self.single_image_mode:
            img = int(rng.integers(self.images.shape[0]))
            idx = rng.integers(0, self.origins.shape[1], size=num_rays)
            return (
                self.origins[img, idx],
                self.directions[img, idx],
                self.radii[img, idx],
                self.target[img, idx],
            )
        flat_idx = rng.integers(0, self.num_rays, size=num_rays)
        img, idx = np.divmod(flat_idx, self.origins.shape[1])
        return (
            self.origins[img, idx],
            self.directions[img, idx],
            self.radii[img, idx],
            self.target[img, idx],
        )

    # ---------------------------------------------- device-resident store

    def device_store(self):
        """Stack the ray store into one [n_img, n_pix, 10] array of
        ``[ro(3), rd(3), radius(1), rgb(3)]`` for device-side sampling."""
        return np.concatenate(
            [self.origins, self.directions, self.radii, self.target], axis=-1
        )


class ValRayDataset:
    """Whole-image validation bundles, round-robin; render-pose iterator;
    depth-analysis keypoint rays.  Mirrors ``ValDataset``
    (dataset.py:63-167)."""

    def __init__(self, poses, images, focal, ndc_rays=False, cfg=None, render_poses=None):
        self.images = np.asarray(images, dtype=np.float32)
        self.poses = np.asarray(poses, dtype=np.float32)
        self.H, self.W = self.images.shape[1], self.images.shape[2]
        self.focal = focal
        self.ndc = ndc_rays
        self.near_plane = 1.0
        self.current_idx = 0
        self.served_idx = 0  # index of the image most recently served
        self.render_poses = render_poses
        self.render_idx = 0
        self.cfg = cfg

    def __len__(self):
        return self.images.shape[0]

    def _bundle(self, pose):
        ro, rd, radii = get_ray_bundle_np(self.H, self.W, self.focal, pose)
        if self.ndc:
            ro, rd, radii = ndc_mipnerf_rays(
                self.H, self.W, self.focal, ro, rd, self.near_plane
            )
            radii = radii[..., None]
        return ro, rd, radii

    def get_next_validation_rays(self):
        """(origins, directions, radii, gt_image) for the next val image
        (dataset.py:137-148); advances the round-robin index."""
        ro, rd, radii = self._bundle(self.poses[self.current_idx])
        gt = self.images[self.current_idx]
        self.served_idx = self.current_idx
        self.current_idx = (self.current_idx + 1) % self.images.shape[0]
        return ro, rd, radii, gt

    def get_next_validation_pose(self):
        """(pose, gt_image) twin of :meth:`get_next_validation_rays` for
        device-side ray generation (renderer.render_image_from_pose) —
        same round-robin semantics, no host ray bundling."""
        pose = self.poses[self.current_idx]
        gt = self.images[self.current_idx]
        self.served_idx = self.current_idx
        self.current_idx = (self.current_idx + 1) % self.images.shape[0]
        return pose, gt

    def get_current_regular_validation_rays(self, fixed: bool = False):
        """Non-NDC rays for the NDC-depth un-warp of the image just rendered
        (dataset.py:150-154).

        Reference quirk: the reference
        reads ``current_idx`` AFTER the round-robin advance, so its un-warp
        uses the NEXT image's pose — the visualized metric depth of a val
        image is un-warped through the wrong camera.  Default (``fixed=
        False``) reproduces that for parity; ``fixed=True`` (config:
        ``dataset.fix_validation_unwarp_rays``) un-warps through the pose
        of the image actually served.  Both behaviors are parity-tested
        (tests/test_poses_render.py)."""
        idx = self.served_idx if fixed else self.current_idx
        return get_ray_bundle_np(self.H, self.W, self.focal, self.poses[idx])

    def get_next_render_pose(self):
        ro, rd, radii = self._bundle(self.render_poses[self.render_idx])
        self.render_idx += 1
        return ro, rd, radii

    # -------------------------------------------------- depth-analysis rays

    def load_depth_analysis_rays(self, cfg):
        """Rays through hand-annotated keypoints with metric depths
        (dataset.py:92-134 + the fern.yml fixture).  Returns (origins,
        directions, radii, depths list, rgb)."""
        import yaml

        with open(cfg.train_params.depth_analysis_path) as f:
            data = yaml.safe_load(f)

        img_idx = data["img_idx"]
        factor = int(data["resized_by"] / cfg.dataset.downsample_factor)

        image_target = self.images[img_idx]
        pose_target = self.poses[img_idx]

        ro, rd, radii = get_ray_bundle_np(self.H, self.W, self.focal, pose_target)
        if cfg.dataset.ndc_rays:
            ro_ndc, rd_ndc, radii_ndc = ndc_mipnerf_rays(
                self.H, self.W, self.focal, ro, rd
            )

        annotated = list(data["pixels_and_depth"].values())
        coords = np.array([(factor * np.array(c[:2])) for c in annotated], np.int64)
        depths = [float(c[2]) for c in annotated]

        sel = (coords[:, 0], coords[:, 1])
        rgb = image_target[sel]

        if cfg.dataset.ndc_rays:
            # Convert annotated metric depths to NDC depth (dataset.py:124-128)
            d = np.asarray(depths) - (1.0 + ro[sel][:, 2])
            d = d * rd[sel][:, 2] / (-1.0 + d * rd[sel][:, 2])
            depths = [float(x) for x in d]
            return (
                ro_ndc[sel],
                rd_ndc[sel],
                radii_ndc[sel].reshape(-1, 1),
                depths,
                rgb,
            )
        return ro[sel], rd[sel], radii[sel].reshape(-1, 1), depths, rgb


def load_train_store(cfg: Config, device, mesh=None):
    """Build the datasets of ``cfg`` and move the training ray store to
    ``device`` -> (store ``[n_img, n_pix, 10]``, validation dataset, cfg).
    The returned cfg carries the near/far that pose normalization may have
    rescaled.  A store whose share per rank is at or above
    ``parallel.max_store_gb`` stays on the host
    (``ddnerf_tpu/train/loop.py:92-96``): the first element is then the
    :class:`TrainRayDataset` itself, whose ``sample_batch`` the loop draws
    from (:class:`PrefetchedHostBatches`).  On a data-parallel ``mesh``
    (``parallel/mesh.py``) the device store is this rank's pixel block
    (``parallel/distributed.py::build_sharded_store``)."""
    from ddnerf_tpu_torch.data.assembly import get_datasets  # imports this module

    train_ds, val_ds, cfg = get_datasets(cfg)
    host_store = train_ds.device_store()
    shards = 1 if mesh is None else mesh.size
    if host_store.nbytes / shards >= cfg.parallel.max_store_gb * 1024**3:
        return train_ds, val_ds, cfg
    if shards > 1:
        from ddnerf_tpu_torch.parallel.distributed import build_sharded_store

        return build_sharded_store(host_store, shards, device), val_ds, cfg
    return torch.from_numpy(host_store).to(device), val_ds, cfg


class PrefetchedHostBatches:
    """Ray batches sampled on the host and uploaded one step ahead
    (``ddnerf_tpu/train/loop.py:134-176``).

    ``take()`` gives the batch of the step about to run; ``prefetch()``,
    called right after that step was dispatched, samples the next batch and
    starts its upload (from pinned memory, on a side stream), so both
    overlap the step on the device.  The host rng is drawn in the order of
    a synchronous loop, and no more often: the prefetch stops once every one
    of the ``steps_expected`` steps has its batch (the entry prefetch counts
    as one).  ``prefetch=False`` samples and uploads inside ``take()``, the
    synchronous loop itself.  ``draws`` counts the batches sampled.

    ``rows``: the part of each sampled batch this process uploads.  On a
    data-parallel group every rank draws the whole global batch from the
    same seeded generator, as the JAX loop does, and takes its
    ``process_ray_slice`` (``parallel/distributed.py``)."""

    def __init__(self, train_ds: TrainRayDataset, num_rays: int, seed: int,
                 device, steps_expected: int, prefetch: bool = True,
                 rows: Optional[slice] = None):
        self.train_ds, self.num_rays, self.rows = train_ds, num_rays, rows
        self.device = torch.device(device)
        self.rng = np.random.default_rng(seed)
        self.steps_expected = steps_expected
        self.ahead = prefetch
        self.draws = 0
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._next = self._sample_upload() if prefetch else None

    def _sample_upload(self):
        """Sample on the host and start the upload -> (rows ``[R, 10]`` on
        the device, the event that marks them there)."""
        batch = np.concatenate(
            self.train_ds.sample_batch(self.rng, self.num_rays), axis=-1)
        if self.rows is not None:
            batch = np.ascontiguousarray(batch[self.rows])
        rows = torch.from_numpy(batch)
        self.draws += 1
        if self._stream is None:
            return rows, None
        with torch.cuda.stream(self._stream):
            dev_rows = rows.pin_memory().to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        return dev_rows, ready

    def take(self):
        """The next step's batch ``{origins, directions, radii, rgb}``."""
        if self._next is None:  # nothing uploaded ahead: sample now
            if self.draws >= self.steps_expected:
                raise RuntimeError(
                    f"batch {self.draws + 1} of {self.steps_expected} asked for")
            self._next = self._sample_upload()
        (rows, ready), self._next = self._next, None
        if ready is not None:
            main = torch.cuda.current_stream(self.device)
            main.wait_event(ready)
            rows.record_stream(main)
        return {"origins": rows[:, 0:3], "directions": rows[:, 3:6],
                "radii": rows[:, 6:7], "rgb": rows[:, 7:10]}

    def prefetch(self) -> None:
        if self.ahead and self.draws < self.steps_expected:
            self._next = self._sample_upload()


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
        # One flat gather: indexing with the 0-d ``img`` itself would read
        # it on the host, and the host would wait for the device.
        rows = store.reshape(n_img * n_pix, -1)[img * n_pix + idx]
    else:
        flat = torch.randint(0, n_img * n_pix, (num_rays,),
                             generator=generator, device=dev)
        rows = store.reshape(n_img * n_pix, -1)[flat]
    return rows[:, 0:3], rows[:, 3:6], rows[:, 6:7], rows[:, 7:10]
