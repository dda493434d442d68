"""Visualization: image casts, density-distribution plots, validation image
dumps, results.txt writer.

Rewrite of ``validation_utils/visualization.py`` on NumPy +
matplotlib + imageio (no torch/torchvision).
"""

from __future__ import annotations

import io
import os
from typing import Dict, List

import numpy as np


def cast_to_disparity_image(arr: np.ndarray) -> np.ndarray:
    """Min-max normalize a scalar map to uint8 [1, H, W]
    (reference visualization.py:11-17).  Empty rays (acc=0) yield NaN
    disparity; they are mapped to 0 rather than poisoning the normalization.
    """
    arr = np.asarray(arr, np.float32)
    arr = np.nan_to_num(arr, nan=0.0, posinf=0.0, neginf=0.0)
    rng = arr.max() - arr.min()
    img = (arr - arr.min()) / (rng if rng > 0 else 1.0)
    img = np.clip(img, 0, 1) * 255
    h, w = img.shape
    return img.astype(np.uint8).reshape(1, h, w)


def cast_to_image(arr: np.ndarray) -> np.ndarray:
    """[H, W, 3] float in [0,1] -> uint8 [3, H, W] (channels-first for
    TensorBoard, reference visualization.py:20-27)."""
    arr = np.asarray(arr, np.float32)
    img = np.clip(arr, 0.0, 1.0) * 255
    return np.moveaxis(img.astype(np.uint8), -1, 0)


# Figure styling per destination.  TB thumbnails are small and dense;
# standalone eval figures are larger with readable fonts.  The rendered
# *content* (curve labels/colors, tick rows, GT marker) is the parity surface
# with the reference's depth-analysis figures (visualization.py:37-98); the
# drawing code below is an original object-API restatement.
_FIG_STYLES = {
    True: dict(size=(7, 5), dpi=150, legend_pt=6, tick_pt=8),    # tb_mode
    False: dict(size=(9, 6), dpi=150, legend_pt=15, tick_pt=15),
}

# (output cycle, pdf key, legend label, matplotlib color) for each curve that
# can appear in a per-ray distribution figure.  DD-specific curves are drawn
# only when the model produced them.
_CURVE_SPECS = (
    (0, "uniform_incell_pdf", "h-c", "b"),
    (1, "uniform_incell_pdf", "h-f", "m"),
    (1, "gaussian_incell_pdf", "f-dd", "g"),
    (1, "smoothed_gaussian_incell_pdf", "smoothed f-dd", "r"),
)


def gen_plot(x, y_list, legend, colors, gt, t_vals, title, tb_mode=False):
    """Per-ray density-distribution figure -> PNG buffer.

    Draws each pdf curve over the depth grid ``x``, marks the coarse / fine
    sample positions as two tick rows below the axis, and flags the annotated
    GT depth (if any) with a triangle above them.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    style = _FIG_STYLES[bool(tb_mode)]
    fig, ax = plt.subplots(figsize=style["size"])
    try:
        for y, label, color in zip(y_list, legend, colors):
            ax.plot(x, y, c=color, label=label)

        # Tick rows sit a fixed fraction of the coarse pdf's peak below zero.
        row_gap = 0.0675 * float(np.max(y_list[0]))
        for row, (ticks, label) in enumerate(
            zip(t_vals, ("coarse samples", "fine samples"))
        ):
            ticks = np.asarray(ticks)
            ax.scatter(ticks, np.full(ticks.shape, -row * row_gap),
                       c=colors[row], label=label)
        if gt > 0:
            ax.scatter([gt], [row_gap], s=100, c="orange", marker="^",
                       label="points of interest")

        ax.legend(fontsize=style["legend_pt"], loc="upper left")
        ax.tick_params(labelsize=style["tick_pt"])
        ax.set_title(title, fontsize=style["tick_pt"])

        buf = io.BytesIO()
        fig.savefig(buf, format="png", dpi=style["dpi"])
    finally:
        plt.close(fig)
    buf.seek(0)
    return buf


def get_density_distribution_plots(output, j, gt_depth, near, far, i=0,
                                   tb_mode=True) -> np.ndarray:
    """Per-ray coarse/fine histogram pdfs + Gaussian in-cell pdfs + sample
    ticks + GT depth marker (the reference's depth-analysis figure,
    visualization.py:74-98).  Returns a [3or4, H, W] uint8 image."""
    from PIL import Image

    curves = [
        (np.asarray(output[cycle][key][j]), label, color)
        for cycle, key, label, color in _CURVE_SPECS
        if key in output[cycle]
    ]
    title = f"Distributions and samples - ray_{j}"
    if tb_mode:
        title += f"- iteration {i}"

    buff = gen_plot(
        x=np.linspace(near, far, 1000),
        y_list=[c[0] for c in curves],
        legend=[c[1] for c in curves],
        colors=[c[2] for c in curves],
        gt=gt_depth[j],
        t_vals=[np.asarray(output[0]["t_vals"][j]),
                np.asarray(output[1]["t_vals"][j])],
        title=title,
        tb_mode=tb_mode,
    )
    with Image.open(buff) as img:
        return np.array(img).transpose(2, 0, 1)


def save_validation_images(output_dict: Dict[int, Dict[str, np.ndarray]],
                           path: str) -> None:
    """PNG dumps: rgb/disp/depth per cycle + mu-corrected disparity
    (reference visualization.py:101-135)."""
    import imageio.v2 as imageio

    os.makedirs(path, exist_ok=True)
    imageio.imwrite(os.path.join(path, "rgb_coarse.png"),
                    cast_to_image(output_dict[0]["rgb"]).transpose(1, 2, 0))
    imageio.imwrite(os.path.join(path, "coarse.png"),
                    cast_to_disparity_image(output_dict[0]["disp"]).squeeze())
    imageio.imwrite(os.path.join(path, "depth_coarse.png"),
                    cast_to_disparity_image(output_dict[0]["depth"]).squeeze())
    if output_dict[0].get("corrected_disp_map") is not None:
        imageio.imwrite(
            os.path.join(path, "mus.png"),
            cast_to_disparity_image(output_dict[0]["corrected_disp_map"]).squeeze(),
        )
    imageio.imwrite(os.path.join(path, "rgb_fine.png"),
                    cast_to_image(output_dict[1]["rgb"]).transpose(1, 2, 0))
    imageio.imwrite(os.path.join(path, "depth_fine.png"),
                    cast_to_disparity_image(output_dict[1]["depth"]).squeeze())
    imageio.imwrite(os.path.join(path, "fine.png"),
                    cast_to_disparity_image(output_dict[1]["disp"]).squeeze())


def write_dicts_to_a_file(summary_dict: Dict[str, List[float]],
                          results_dict: Dict, results_file: str) -> None:
    """results.txt: averages + per-image metrics
    (reference visualization.py:137-150)."""
    with open(results_file, "w") as f:
        print("average overall results:\n", file=f)
        for key in summary_dict:
            score = sum(summary_dict[key]) / len(summary_dict[key])
            print(f"{key}: \t {score:.4}", file=f)
        print("\nper image results:\n", file=f)
        for key1 in results_dict:
            for key2 in results_dict[key1]:
                print(f"image {key1} , {key2}: \t {results_dict[key1][key2]:.4}",
                      file=f)
