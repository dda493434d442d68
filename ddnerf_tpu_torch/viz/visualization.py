"""Visualization: image casts, density-distribution plots, validation image
dumps, results.txt writer.

Rewrite of ``validation_utils/visualization.py`` on NumPy and PIL (the
JAX package draws its figures with matplotlib and writes through imageio;
neither is needed here); PNGs go through
:mod:`ddnerf_tpu_torch.data.images`.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from ddnerf_tpu_torch.data.images import write_image


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


# Figure size per destination, in pixels (the JAX package's matplotlib
# figures: 7 x 5 in for TensorBoard, 9 x 6 in standalone, at 150 dpi).  The
# rendered *content* (curve labels and colours, tick rows, GT marker) is the
# parity surface with the reference's depth-analysis figures
# (visualization.py:37-98); the figure is drawn with PIL, which every
# installation of the port has, where the JAX package uses matplotlib.
_FIG_SIZES = {True: (1050, 750), False: (1350, 900)}  # tb_mode -> (W, H)

# (output cycle, pdf key, legend label, colour) for each curve that can
# appear in a per-ray distribution figure.  DD-specific curves are drawn
# only when the model produced them.  The colours are matplotlib's "b",
# "m", "g", "r".
_CURVE_SPECS = (
    (0, "uniform_incell_pdf", "h-c", (0, 0, 255)),
    (1, "uniform_incell_pdf", "h-f", (191, 0, 191)),
    (1, "gaussian_incell_pdf", "f-dd", (0, 128, 0)),
    (1, "smoothed_gaussian_incell_pdf", "smoothed f-dd", (255, 0, 0)),
)
_GT_COLOR = (255, 165, 0)  # "orange"


def gen_plot(x, y_list, legend, colors, gt, t_vals, title,
             tb_mode=False) -> np.ndarray:
    """Per-ray density-distribution figure -> uint8 ``[H, W, 3]``.

    Draws each pdf curve over the depth grid ``x``, marks the coarse / fine
    sample positions as two rows of dots below the axis, and flags the
    annotated GT depth (if any) with a triangle above them.
    """
    from PIL import Image, ImageDraw

    width, height = _FIG_SIZES[bool(tb_mode)]
    left, right, top, bottom = 90, width - 30, 50, height - 50
    x = np.asarray(x, np.float64)
    ys = [np.nan_to_num(np.asarray(y, np.float64)) for y in y_list]
    # The dot rows sit a fixed fraction of the coarse pdf's peak below zero.
    row_gap = 0.0675 * float(np.max(ys[0]))
    y_hi = max(max(float(y.max()) for y in ys), row_gap, 1e-12) * 1.05
    y_lo = -2.0 * max(row_gap, 0.05 * y_hi)
    x_lo, x_hi = float(x.min()), float(x.max())

    def px(xv, yv):
        fx = (np.asarray(xv, np.float64) - x_lo) / max(x_hi - x_lo, 1e-12)
        fy = (np.asarray(yv, np.float64) - y_lo) / (y_hi - y_lo)
        return left + fx * (right - left), bottom - fy * (bottom - top)

    img = Image.new("RGB", (width, height), (255, 255, 255))
    draw = ImageDraw.Draw(img)
    draw.rectangle([left, top, right, bottom], outline=(0, 0, 0))
    zero_y = float(px(x_lo, 0.0)[1])
    draw.line([left, zero_y, right, zero_y], fill=(200, 200, 200))
    for frac in np.linspace(0.0, 1.0, 6):  # axis labels
        xv = x_lo + frac * (x_hi - x_lo)
        draw.text((float(px(xv, 0)[0]) - 12, bottom + 8), f"{xv:.3g}",
                  fill=(0, 0, 0))
        yv = frac * y_hi
        draw.text((8, float(px(x_lo, yv)[1]) - 6), f"{yv:.3g}",
                  fill=(0, 0, 0))
    for y, color in zip(ys, colors):
        cx, cy = px(x, y)
        draw.line(list(zip(cx.tolist(), cy.tolist())), fill=color, width=2)

    entries = list(zip(legend, colors))
    for row, (ticks, label) in enumerate(
            zip(t_vals, ("coarse samples", "fine samples"))):
        ticks = np.asarray(ticks, np.float64)
        cx, cy = px(ticks, np.full(ticks.shape, -row * row_gap))
        for u, v in zip(cx.tolist(), cy.tolist()):
            draw.ellipse([u - 4, v - 4, u + 4, v + 4], fill=colors[row])
        entries.append((label, colors[row]))
    if gt > 0:
        u, v = (float(c) for c in px(gt, row_gap))
        draw.polygon([(u - 9, v + 8), (u + 9, v + 8), (u, v - 9)],
                     fill=_GT_COLOR)
        entries.append(("points of interest", _GT_COLOR))

    for k, (label, color) in enumerate(entries):  # legend, upper left
        y0 = top + 10 + 16 * k
        draw.rectangle([left + 10, y0 + 2, left + 26, y0 + 10], fill=color)
        draw.text((left + 32, y0), label, fill=(0, 0, 0))
    draw.text((left, 18), title, fill=(0, 0, 0))
    return np.asarray(img)


def get_density_distribution_plots(output, j, gt_depth, near, far, i=0,
                                   tb_mode=True) -> np.ndarray:
    """Per-ray coarse/fine histogram pdfs + Gaussian in-cell pdfs + sample
    positions + GT depth marker (the reference's depth-analysis figure,
    visualization.py:74-98).  Returns a [3, H, W] uint8 image."""
    curves = [
        (np.asarray(output[cycle][key][j]), label, color)
        for cycle, key, label, color in _CURVE_SPECS
        if key in output[cycle]
    ]
    title = f"Distributions and samples - ray_{j}"
    if tb_mode:
        title += f"- iteration {i}"
    figure = gen_plot(
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
    return figure.transpose(2, 0, 1)


def save_validation_images(output_dict: Dict[int, Dict[str, np.ndarray]],
                           path: str) -> None:
    """PNG dumps: rgb/disp/depth per cycle + mu-corrected disparity
    (reference visualization.py:101-135)."""
    os.makedirs(path, exist_ok=True)
    write_image(os.path.join(path, "rgb_coarse.png"),
                    cast_to_image(output_dict[0]["rgb"]).transpose(1, 2, 0))
    write_image(os.path.join(path, "coarse.png"),
                    cast_to_disparity_image(output_dict[0]["disp"]).squeeze())
    write_image(os.path.join(path, "depth_coarse.png"),
                    cast_to_disparity_image(output_dict[0]["depth"]).squeeze())
    if output_dict[0].get("corrected_disp_map") is not None:
        write_image(
            os.path.join(path, "mus.png"),
            cast_to_disparity_image(output_dict[0]["corrected_disp_map"]).squeeze(),
        )
    write_image(os.path.join(path, "rgb_fine.png"),
                    cast_to_image(output_dict[1]["rgb"]).transpose(1, 2, 0))
    write_image(os.path.join(path, "depth_fine.png"),
                    cast_to_disparity_image(output_dict[1]["depth"]).squeeze())
    write_image(os.path.join(path, "fine.png"),
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
