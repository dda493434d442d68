"""The pipeline's encode stage as one kernel (``csrc/ipe_encode.cu``): ray
sections to the rows the fused MLP kernels read.

:func:`ipe_encode` takes a network call's fenceposts and rays and returns
its IPE rows ``[N*S, 96]`` and view-direction rows ``[N, 27]`` in the
network's compute dtype, in one launch on a card.  Its plain version,
:func:`ipe_encode_reference`, is the composition it replaces:
``core/math.py::cast_rays``, ``integrated_pos_enc`` and
``positional_encoding``, then the cast; the wrapper runs it for CPU
tensors, and the kernel is held to it on the card.  The source says what
bounds the kernel and how it is laid out.

Counted as ``ipe_encode`` (``ipe_encode_f32`` for float32 rows) in the
kernels' launch and capture counters (``fused_mlp.LAUNCHES`` /
``CAPTURED``, the tracer's groups ``kernels.launches`` /
``kernels.captured``).
"""

from __future__ import annotations

import torch

from ddnerf_tpu_torch.core.math import (
    cast_rays,
    integrated_pos_enc,
    positional_encoding,
)
from ddnerf_tpu_torch.models.mlp import DIR_DIM, IPE_DIM
from ddnerf_tpu_torch.utils.profiling import counters

NAMES = ("ipe_encode", "ipe_encode_f32")
LAUNCHES = counters("kernels.launches", NAMES)
CAPTURED = counters("kernels.captured", NAMES)

RAY_SHAPES = ("cone", "cylinder")
DTYPES = (torch.bfloat16, torch.float32)


def ipe_encode_reference(t_vals, origins, directions, radii, viewdirs,
                         ray_shape: str = "cone", double_angle: bool = True,
                         dtype: torch.dtype = torch.float32):
    """The plain composition: ``(ipe [N*S, 96], dirs [N, 27])`` in
    ``dtype``."""
    means, covs = cast_rays(t_vals, origins, directions, radii, ray_shape)
    ipe = integrated_pos_enc((means, covs), double_angle=double_angle)
    dirs = positional_encoding(viewdirs, num_freqs=4)
    return ipe.reshape(-1, IPE_DIM).to(dtype), dirs.to(dtype)


def _rows(x: torch.Tensor, name: str, n: int, width: int) -> torch.Tensor:
    """``x`` as ``[n, width]`` f32 rows with unit column stride (a view of
    a wider row, as the training batch's columns are, is taken as it is)."""
    if x.dim() != 2 or tuple(x.shape) != (n, width):
        raise ValueError(f"{name} must be [{n}, {width}], got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {x.dtype}")
    return x if width == 1 or x.stride(1) == 1 else x.contiguous()


def ipe_encode(t_vals: torch.Tensor, origins: torch.Tensor,
               directions: torch.Tensor, radii: torch.Tensor,
               viewdirs: torch.Tensor, ray_shape: str = "cone",
               double_angle: bool = True,
               dtype: torch.dtype = torch.bfloat16):
    """Encode the S sections of N rays for a network of compute dtype
    ``dtype``: ``t_vals [N, S+1]``, ``origins`` / ``directions`` /
    ``viewdirs [N, 3]`` and ``radii [N, 1]`` (float32) -> ``(ipe [N*S, 96],
    dirs [N, 27])`` in ``dtype``, ray-major (row ``r`` of ipe belongs to ray
    ``r // S``).  ``ray_shape``: ``cone`` or ``cylinder``;
    ``double_angle``: ``parallel.ipe_double_angle``.  The result equals
    :func:`ipe_encode_reference`'s on the same device (see the source for
    the arithmetic)."""
    if ray_shape not in RAY_SHAPES:
        raise ValueError(f"unknown ray_shape {ray_shape!r}")
    if dtype not in DTYPES:
        raise ValueError(f"the encode kernel writes bfloat16 or float32 rows; "
                         f"got {dtype}")
    if t_vals.dim() != 2 or t_vals.shape[1] < 2:
        raise ValueError(f"t_vals must be [N, S+1] with S >= 1, got "
                         f"{tuple(t_vals.shape)}")
    n, s = t_vals.shape[0], t_vals.shape[1] - 1
    args = [_rows(x, name, n, w) for x, name, w in (
        (t_vals, "t_vals", s + 1), (origins, "origins", 3),
        (directions, "directions", 3), (radii, "radii", 1),
        (viewdirs, "viewdirs", 3))]
    dev = t_vals.device
    if any(x.device != dev for x in args):
        raise ValueError("t_vals and the rays must lie on one device")
    if dev.type == "cpu":
        return ipe_encode_reference(*args, ray_shape, double_angle, dtype)
    if dev.type != "cuda":
        raise ValueError(f"no encode kernel for device {dev}")

    ipe = torch.empty((n * s, IPE_DIM), dtype=dtype, device=dev)
    dirs = torch.empty((n, DIR_DIM), dtype=dtype, device=dev)
    if n == 0:
        return ipe, dirs
    from ddnerf_tpu_torch.kernels import build

    lib = build.load_library()
    ptrs = [v for x in args for v in (x.data_ptr(), x.stride(0))]
    f32 = dtype == torch.float32
    err = lib.ddnerf_ipe_encode(
        *ptrs, ipe.data_ptr(), dirs.data_ptr(), n, s,
        int(ray_shape == "cone"), int(bool(double_angle)), int(f32),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "ipe_encode")
    counts = CAPTURED if torch.cuda.is_current_stream_capturing() else LAUNCHES
    counts["ipe_encode_f32" if f32 else "ipe_encode"] += 1
    return ipe, dirs
