"""Observability: TensorBoard + JSONL metrics writer.  The port's copy of
``ddnerf_tpu/viz/documentation.py``.

Rewrite of the reference ``Documenter``
(``validation_utils/documentation.py``).  Three channels:

* TensorBoard events (:mod:`ddnerf_tpu_torch.viz.tfevents`, written with
  the standard library and numpy on every machine) with the reference's
  exact tag layout so existing dashboards keep working;
* a machine-readable ``metrics.jsonl`` (one line per write) — the reference
  had no machine-readable metrics; this is the channel tests/benches consume;
* console progress is left to the train loop (tqdm-style prints,
  train_model.py:180-191).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np

from ddnerf_tpu_torch.viz.tfevents import EventsWriter
from ddnerf_tpu_torch.viz.visualization import (
    cast_to_disparity_image,
    cast_to_image,
    get_density_distribution_plots,
)


class Documenter:
    def __init__(self, logdir: str, use_tensorboard: bool = True,
                 primary: bool = True):
        """``primary``: where several processes share a logdir only one may
        write it; the caller says which.  Non-primary Documenters are
        no-ops.  With ``use_tensorboard`` the events file is created here;
        a logdir where it cannot be created or written raises."""
        self.primary = primary
        self.logdir = logdir
        self._jsonl = None
        self.writer = None
        if not primary:
            return
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        if use_tensorboard:
            self.writer = EventsWriter(logdir)

    # ------------------------------------------------------------- scalars

    def _scalar(self, tag: str, value, idx: int):
        if self.writer is not None:
            self.writer.add_scalar(tag, float(value), idx)

    def _jsonl_write(self, record: dict):
        if self._jsonl is None:
            return
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def write_train_iter(self, idx: int, metrics: Dict[str, float],
                         extra_scalars: Optional[Dict[str, float]] = None):
        """Per-iter train scalars (reference documentation.py:11-26)."""
        m = {k: float(v) for k, v in metrics.items()}
        self._scalar("train/loss", m["loss"], idx)
        self._scalar("train/coarse_loss", m["loss_coarse"], idx)
        self._scalar("train/fine_loss", m["loss_fine"], idx)
        self._scalar("train/psnr_coarse", m["psnr_coarse"], idx)
        self._scalar("train/psnr_fine", m["psnr_fine"], idx)
        self._scalar("train_params/lr", m["lr"], idx)
        if "dp_loss" in m:
            self._scalar("train_depth/depth_prediction_loss", m["dp_loss"], idx)
            self._scalar("train_depth/sig_reg", m["sig_reg"], idx)
            self._scalar("train_depth/sig_loss", m["sig_loss"], idx)
            self._scalar("train_depth/mus_reg", m["mus_reg"], idx)
            self._scalar("train_depth/mus_loss", m["mus_loss"], idx)
        for tag, v in (extra_scalars or {}).items():
            self._scalar(tag, v, idx)
        self._jsonl_write({"kind": "train", "step": idx, "time": time.time(), **m})

    # ---------------------------------------------------------- validation

    def write_valid_iter(self, idx: int, metrics: Dict[str, float],
                         output: Dict[int, Dict[str, np.ndarray]],
                         img_target: np.ndarray, is_ddnerf: bool):
        """Validation scalars + rgb/disp images + mu/sigma histograms
        (reference documentation.py:30-53)."""
        m = {k: float(v) for k, v in metrics.items()}
        self._scalar("validation/loss", m["loss"], idx)
        self._scalar("validation/coarse_loss", m["loss_coarse"], idx)
        self._scalar("validation/fine_loss", m["loss_fine"], idx)
        self._scalar("validation/psnr_fine", m["psnr_fine"], idx)
        self._scalar("validation/psnr_coarse", m["psnr_coarse"], idx)
        if "dp_loss" in m:
            self._scalar("validation/depth_prediction_loss", m["dp_loss"], idx)
        if self.writer is not None:
            self.writer.add_image("rgb_coarse/coarse",
                                  cast_to_image(output[0]["rgb"]), idx)
            self.writer.add_image("disparity_coarse/coarse",
                                  cast_to_disparity_image(output[0]["disp"]), idx)
            self.writer.add_image("rgb_fine/fine",
                                  cast_to_image(output[1]["rgb"]), idx)
            self.writer.add_image("disparity_fine/fine",
                                  cast_to_disparity_image(output[1]["disp"]), idx)
            self.writer.add_image("rgb/target", cast_to_image(img_target), idx)
            if is_ddnerf:
                # The mu/sigma histograms are masked to pdf > 0.1 upstream;
                # early in training no section may pass the threshold, and
                # a histogram of no values is refused — skip, don't crash.
                if "mus_hist" in output[0] and output[0]["mus_hist"].size:
                    self.writer.add_histogram(
                        "depth_prediction/mu_hist",
                        output[0]["mus_hist"].reshape(-1, 1), idx)
                    self.writer.add_histogram(
                        "depth_prediction/sigma_hist",
                        output[0]["sigmas_hist"].reshape(-1, 1), idx)
                    self.writer.add_histogram(
                        "depth_prediction/smoothed_sigmas",
                        output[0]["smoothed_sigmas_hist"].reshape(-1, 1), idx)
                if output[0].get("corrected_disp_map") is not None:
                    self.writer.add_image(
                        "disparity_coarse_corr/coarse_corr",
                        cast_to_disparity_image(output[0]["corrected_disp_map"]),
                        idx)
        self._jsonl_write({"kind": "validation", "step": idx,
                           "time": time.time(), **m})

    # ------------------------------------------------------ depth analysis

    def write_depth_analysis_rays(self, idx: int, output, da_depth: List[float],
                                  near: float, far: float):
        """Per-ray density-distribution figures (documentation.py:56-60)."""
        if self.writer is None:
            return
        for j in range(len(da_depth)):
            self.writer.add_image(
                f"density_distribution_ray_{j}/ray_{j}",
                get_density_distribution_plots(output, j, da_depth, near, far,
                                               idx, tb_mode=True),
                idx,
            )

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
        if self.writer is not None:
            self.writer.close()
