"""Image files in and out, without imageio.

The loaders and the artifact writers of the JAX package go through
imageio; the port reads through PIL (imageio's own PNG and JPEG reader is
pillow, so the decoded pixels are the same) and writes PNGs with the
standard library (:func:`ddnerf_tpu_torch.render.media.write_png`), so it
runs where imageio is not installed.
"""

from __future__ import annotations

import numpy as np

from ddnerf_tpu_torch.render.media import write_png


def read_image(path: str) -> np.ndarray:
    """The decoded pixels of an image file: uint8 ``[H, W]`` or
    ``[H, W, C]``, as ``imageio.imread`` returns them."""
    from PIL import Image

    with Image.open(path) as im:
        return np.array(im)


def write_image(path: str, image: np.ndarray) -> None:
    """Write uint8 ``[H, W]``, ``[H, W, 3]`` or ``[H, W, 4]`` as a PNG
    (``path`` must end in ``.png``)."""
    if not path.lower().endswith(".png"):
        raise ValueError(f"{path!r}: the port writes PNG files only")
    write_png(path, image)
