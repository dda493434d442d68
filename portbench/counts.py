"""The yardstick's arithmetic: operations and bytes of the MipMLP /
DepthMipMLP forward and backward from their shapes, the least time the
card could take for them, and the published peaks it is measured against.

Frozen copy of ``chip_smoke.py``'s ``_row_macs``, ``_param_counts``,
``_bound_ms`` and ``kernel_bounds`` (the bf16 rows), so that no later
change to the program moves the benchmark's roofline.
"""

from __future__ import annotations

from typing import Dict, Tuple

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, no
# sparsity), at its 700 W power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
DIRS_MACS = 128 * 27  # the dir layer's view-direction columns, once per ray


def row_macs(hidden: int, depth_head: bool) -> int:
    """Multiply-adds per row (sample) of one forward of a network of width
    ``hidden``, every weight once except the view-direction columns
    (:data:`DIRS_MACS`, once per ray): 8 w^2 + 321 w + 384, + 256 for the
    depth head (607,104 at 256 with it)."""
    return 8 * hidden ** 2 + 321 * hidden + 384 + (256 if depth_head else 0)


def param_counts(hidden: int, depth_head: bool) -> Tuple[int, int]:
    """(weights, biases) of a network of width ``hidden``."""
    return (row_macs(hidden, depth_head) + DIRS_MACS,
            9 * hidden + 128 + 1 + 3 + (2 if depth_head else 0))


def bound_ms(flop: float, nbytes: float) -> Tuple[float, str]:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over the memory rate -> (ms, which)."""
    t_flop, t_bytes = flop / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_flop, t_bytes) * 1e3, ("operations" if t_flop >= t_bytes
                                        else "bytes")


def forward_flop(hidden: int, depth_head: bool, rows: int, rays: int) -> float:
    """Operations of one forward over ``rows`` samples of ``rays`` rays."""
    return 2.0 * (rows * row_macs(hidden, depth_head) + rays * DIRS_MACS)


def backward_flop(hidden: int, depth_head: bool, rows: int, rays: int) -> float:
    """Operations of one backward: the weight gradients repeat the
    forward's multiply-adds; the cotangent chain all but those whose input
    is the IPE or the view directions."""
    macs = rows * row_macs(hidden, depth_head) + rays * DIRS_MACS
    no_dgrad = rows * 2 * 96 * hidden + rays * DIRS_MACS
    return 2.0 * (2 * macs - no_dgrad)


def kernel_bounds(hidden: int, rows: int, rays: int, train_rows: int,
                  train_rays: int, depth_head: bool = True,
                  ) -> Dict[str, Tuple[float, str]]:
    """``{kernel: (bound_ms, bound_by)}`` of the bf16 kernels: the
    forwards B1 / B3 on ``rows`` samples of ``rays`` rays, the training
    pair B1s / B2 on ``train_rows`` of ``train_rays``.  Forward: reads the
    IPE (96 bf16 a row; B3 means and covariances, 6 f32), the dirs (27 bf16
    a ray) and the parameters, writes out_dim f32 a row; B1s also writes
    the stash, (9 H + 128) bf16 a row.  Backward: reads the IPE, dirs,
    cotangent (out_dim f32 a row), stash and weights, writes one f32
    gradient a parameter."""
    out_dim = 6 if depth_head else 4
    e = 2
    weights, biases = param_counts(hidden, depth_head)
    params = e * weights + 4 * biases
    out = {}
    fwd = forward_flop(hidden, depth_head, rows, rays)
    io = rays * 27 * e + params + rows * out_dim * 4
    out["fused_mlp_fwd"] = bound_ms(fwd, io + rows * 96 * e)
    out["fused_enc_mlp_fwd"] = bound_ms(fwd, io + rows * 6 * 4)
    stash = train_rows * (9 * hidden + 128) * e
    io = train_rows * 96 * e + train_rays * 27 * e + params
    out["fused_mlp_fwd_stash"] = bound_ms(
        forward_flop(hidden, depth_head, train_rows, train_rays),
        io + train_rows * out_dim * 4 + stash)
    out["fused_mlp_bwd"] = bound_ms(
        backward_flop(hidden, depth_head, train_rows, train_rays),
        io + train_rows * out_dim * 4 + stash + (weights + biases) * 4)
    return out


def train_step_work(nets, rays: int, samples: Tuple[int, int]):
    """One training step of ``nets`` (``(hidden, depth_head)`` per cycle,
    coarse then fine; mip-NeRF's shared net appears twice) on ``rays``
    rays with ``samples`` sections per cycle -> (MLP operations, least ms
    of the stash forwards and backwards)."""
    flop, ms = 0.0, 0.0
    for (hidden, depth_head), k in zip(nets, samples):
        rows = rays * k
        flop += (forward_flop(hidden, depth_head, rows, rays)
                 + backward_flop(hidden, depth_head, rows, rays))
        b = kernel_bounds(hidden, rows, rays, rows, rays, depth_head)
        ms += b["fused_mlp_fwd_stash"][0] + b["fused_mlp_bwd"][0]
    return flop, ms


def frame_work(nets, pixels: int, chunk: int, samples: Tuple[int, int]):
    """One frame of ``pixels`` rays rendered in chunks of ``chunk`` through
    the forward kernel fed the torch IPE -> (MLP operations, least ms of
    the forwards, one launch per chunk and cycle)."""
    flop, ms = 0.0, 0.0
    for start in range(0, pixels, chunk):
        rays = min(chunk, pixels - start)
        for (hidden, depth_head), k in zip(nets, samples):
            flop += forward_flop(hidden, depth_head, rays * k, rays)
            ms += kernel_bounds(hidden, rays * k, rays, 1, 1,
                                depth_head)["fused_mlp_fwd"][0]
    return flop, ms
