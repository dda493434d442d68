"""Plain PyTorch versions of the fused-MLP kernels, at the kernels'
interface: flat ray-major rows and per-ray view directions.

* :func:`fused_mlp_reference` — the forward (B1 render mode), counterpart
  of ``ddnerf_tpu/kernels/fused_mlp.py::_reference_apply``;
* :func:`fused_mlp_stash_reference` — the training forward (B1 stash
  mode): the outputs and the activations the backward reads;
* :func:`fused_enc_mlp_reference` — the forward fed raw means and
  covariances (B3, ``ddnerf_tpu/kernels/fused_mlp.py::
  fused_enc_mlp_forward``): the direct-form IPE, then the forward;
* :func:`fused_mlp_backward_reference` — the backward (B2,
  ``ddnerf_tpu/kernels/fused_mlp_bwd.py::_bwd_kernel``), written out with
  the kernel's rounding points;
* :func:`tf32_split_pack_reference` — the TF32 planes of a float32 weight
  pack (``csrc/fused_mlp_f32.cu::tf32_split_kernel``), from
  :func:`tf32_round` and :func:`tf32_split` on the float32 bits;
* :func:`pack_mask_bits` / :func:`unpack_mask_bits` — the layout of the
  relu-mask words that B1s writes and B2's cotangent chain reads
  (``csrc/mask_bits.cuh``), both ways.

The forward arithmetic is the module's own (:mod:`ddnerf_tpu_torch.models.
mlp`: operands rounded to the compute dtype, float32 products and
activations), so the kernels, these functions and the module agree up to
summation order.  The backward is explicit, not autograd through the
module: autograd through ``_q(weight)`` would round every weight gradient
to bf16 (the cast's VJP), where the kernel accumulates them in float32.
On a GPU the caller keeps TF32 off.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ddnerf_tpu_torch.core.math import integrated_pos_enc

NUM_STASH = 9  # x0..x7, feat: the first 7 slabs are the TPU split layout
NUM_RELU = 8  # x0..x7: the stash slabs with a relu mask
MASK_ROWS = 64  # rows of a group of mask words (a wgmma's m64)
TF32_DROP = 13  # float32 mantissa bits below TF32's ten


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` of every element of float32 ``x``: the nearest
    value with the low :data:`TF32_DROP` mantissa bits zero, ties away from
    zero, in integer arithmetic on the bits (adding half of the dropped
    unit to the magnitude, then clearing the dropped bits; a carry moves
    into the exponent, up to infinity past the largest TF32 value).
    Subnormals round the same way; infinities and NaNs stay as they are."""
    bits = x.contiguous().view(torch.int32)
    finite = (bits & 0x7F800000) != 0x7F800000
    half = 1 << (TF32_DROP - 1)
    rounded = (bits + half) & ~((1 << TF32_DROP) - 1)
    return torch.where(finite, rounded, bits).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """``(big, small)``: ``big = tf32_round(x)``, ``small = tf32_round(x -
    big)`` (``x - big`` is exact in float32), so that ``big + small`` is
    ``x`` to within ``2**-22 |x|``."""
    big = tf32_round(x)
    return big, tf32_round(x - big)


class Stash(NamedTuple):
    """The training forward's activations in the compute dtype.

    ``trunk [9, N, H]``: x0..x6 (``trunk[:7]`` is the TPU kernel's
    ``split_h_stash`` trunk layout), then x7 and feat, which this port
    stashes instead of recomputing from x6; ``h [N, 128]``.  ``bits``: the
    relu masks of x0..x7 and h as int32 words (:func:`pack_mask_bits`'s
    layout), which the bfloat16 fused kernels write and read; None where
    no kernel reads them (the plain versions, the float32 and wide plans).
    """

    trunk: torch.Tensor
    h: torch.Tensor
    bits: Optional[torch.Tensor] = None


def mask_bits_shape(n: int, width: int, dir_width: int = 128) -> tuple:
    """Shape of the mask words of ``n`` rows at kernel width ``width``:
    a row of ``16 width + 2 dir_width`` int32 words per group of
    :data:`MASK_ROWS` rows, ``(8 width + dir_width) / 8`` bytes a row."""
    return (-(-n // MASK_ROWS), 2 * (NUM_RELU * width + dir_width))


def _to_words(mask: torch.Tensor) -> torch.Tensor:
    """``[groups * 64, C * 64]`` 0/1 (int64) -> ``[groups, 128 C]`` words
    (int64): row ``16 w + 8 half + g``, column ``64 c + 8 i + 2 q + e`` of a
    group is bit ``16 e + 15 - (2 i + half)`` of word ``c`` of thread
    ``32 w + 4 g + q``, whose ``C`` words are consecutive (the wgmma
    accumulator fragment: ``csrc/hopper_common.cuh``, ``wgmma_k16``)."""
    groups, cols = mask.shape[0] // MASK_ROWS, mask.shape[1] // 64
    # [g, w, half, g8, c, i, q, e] -> [g, w, g8, q, c, e, i, half]
    bits = mask.reshape(groups, 4, 2, 8, cols, 8, 4, 2).permute(
        0, 1, 3, 6, 4, 7, 5, 2)
    bits = bits.reshape(groups, 128, cols, 2, 16).flip(-1)
    shifts = torch.arange(32, device=mask.device)
    return (bits.reshape(groups, 128, cols, 32) << shifts).sum(-1).reshape(
        groups, -1)


def _from_words(words: torch.Tensor, cols: int) -> torch.Tensor:
    """:func:`_to_words` undone for ``cols`` columns: ``[groups, 128 cols /
    64]`` words (int64) -> ``[groups * 64, cols]`` 0/1."""
    groups, cols = words.shape[0], cols // 64
    bits = (words.unsqueeze(-1)
            >> torch.arange(32, device=words.device)) & 1
    bits = bits.reshape(groups, 128 * cols, 2, 16).flip(-1)
    # [g, w, g8, q, c, e, i, half] -> [g, w, half, g8, c, i, q, e]
    bits = bits.reshape(groups, 4, 8, 4, cols, 2, 8, 2).permute(
        0, 1, 7, 2, 4, 6, 3, 5)
    return bits.reshape(groups * MASK_ROWS, cols * 64)


def pack_mask_bits(trunk_mask: torch.Tensor, h_mask: torch.Tensor,
                   width: int) -> torch.Tensor:
    """The mask words of ``csrc/mask_bits.cuh``: ``trunk_mask [8, N, w]``
    (x0..x7 > 0, ``w <= width``) and ``h_mask [N, D]`` (h > 0) ->
    ``int32`` :func:`mask_bits_shape` ``(N, width, D)``.  Columns from
    ``w`` to ``width`` and rows past ``N`` read 0.  In a group of
    :data:`MASK_ROWS` rows, mask ``m`` (x0..x7, then h) takes the words
    from ``128 (width / 64) m``, ``width / 64`` (``D / 64`` for h) a
    thread, in :func:`_to_words`'s order."""
    n = trunk_mask.shape[1]
    rows = mask_bits_shape(n, width, h_mask.shape[1])[0] * MASK_ROWS
    regions = []
    for mask, cols in [(m, width) for m in trunk_mask] + [
            (h_mask, h_mask.shape[1])]:
        full = torch.zeros(rows, cols, dtype=torch.int64,
                           device=mask.device)
        full[:n, :mask.shape[1]] = mask.to(torch.int64)
        regions.append(_to_words(full))
    words = torch.cat(regions, 1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def unpack_mask_bits(words: torch.Tensor, n: int, width: int,
                     dir_width: int = 128) -> tuple:
    """:func:`pack_mask_bits` undone: ``words`` -> ``(trunk_mask [8, n,
    width], h_mask [n, dir_width])``, bool."""
    words = words.to(torch.int64) & 0xFFFFFFFF
    out, at = [], 0
    for cols in [width] * NUM_RELU + [dir_width]:
        size = 2 * cols
        out.append(_from_words(words[:, at:at + size], cols)[:n].bool())
        at += size
    return torch.stack(out[:NUM_RELU]), out[NUM_RELU]


def fused_mlp_reference(net, ipe: torch.Tensor, dirs: torch.Tensor,
                        samples_per_ray: int) -> torch.Tensor:
    """``ipe [N, 96]`` (row ``r`` belongs to ray ``r // K``), ``dirs
    [N // K, 27]`` -> ``[N, 4|6]`` float32."""
    k = samples_per_ray
    rays = ipe.shape[0] // k
    out = net(ipe.float().reshape(rays, k, ipe.shape[1]), dirs.float())
    return out.reshape(rays * k, out.shape[-1])


def fused_enc_mlp_reference(net, means: torch.Tensor, covs: torch.Tensor,
                            dirs: torch.Tensor,
                            samples_per_ray: int) -> torch.Tensor:
    """``means`` / ``covs [N, 3]`` (ray-major rows), ``dirs [N // K, 27]``
    -> ``[N, 4|6]`` float32: the direct-form IPE
    (``integrated_pos_enc(double_angle=False)``, JAX's oracle for B3 in
    tests/test_fused_mlp.py), then :func:`fused_mlp_reference`."""
    ipe = integrated_pos_enc((means.float(), covs.float()),
                             double_angle=False)
    return fused_mlp_reference(net, ipe, dirs, samples_per_ray)


@torch.no_grad()
def fused_mlp_stash_reference(net, ipe: torch.Tensor, dirs: torch.Tensor,
                              samples_per_ray: int):
    """The training forward: ``(out [N, 4|6] f32, Stash)``."""
    k = samples_per_ray
    n = ipe.shape[0]
    out, acts = net.forward_acts(ipe.float().reshape(n // k, k, ipe.shape[1]),
                                 dirs.float())
    cdt = net.compute_dtype
    trunk = torch.stack([a.reshape(n, -1) for a in acts[:NUM_STASH]]).to(cdt)
    h = acts[NUM_STASH].reshape(n, -1).to(cdt)
    return out.reshape(n, out.shape[-1]), Stash(trunk, h)


@torch.no_grad()
def fused_mlp_backward_reference(net, ipe: torch.Tensor, dirs: torch.Tensor,
                                 g: torch.Tensor, samples_per_ray: int,
                                 stash: Stash, per_ray_dirs: bool = False,
                                 accumulate: torch.dtype = torch.float32,
                                 ) -> Dict[str, torch.Tensor]:
    """Parameter gradients of the fused MLP for the cotangent ``g [N, 4|6]``
    -> ``{parameter name: float32 gradient}`` (``net.named_parameters()``
    names and shapes).  No input gradients: ipe and dirs are detached
    upstream.  The rounding points are ``_bwd_kernel``'s: g in the compute
    dtype on entry; each matmul's cotangent operand rounded, bias sums
    taken in f32 before the rounding; relu masks from the stashed
    activations.  The dirs weight gradient follows
    ``parallel.kernel_per_ray_dirs``: ``per_ray_dirs=False`` (the JAX
    package's default, its per-sample branch) multiplies each sample's
    rounded cotangent by its ray's dirs, here as the f32 sum of the ray's
    rounded cotangents times the dirs (the same products; the dirs are the
    same for every sample of a ray); ``True`` rounds the f32 sum of the
    ray's cotangents once.  A stash wider than the network (the kernel's,
    at a zero-padded width) is read up to the network's width.
    ``accumulate``: the dtype of the products and sums between the rounding
    points (float64 measures how far float32 accumulation moves the
    result: ``scripts/b2_rounding_floor.py``).
    """
    def q(x):  # net._q at float32
        return x.to(net.compute_dtype).to(accumulate)

    k = samples_per_ray
    n, hid, dh = ipe.shape[0], net.hidden_size, net.dir_hidden
    acts = [a[:, :hid].to(accumulate) for a in stash.trunk]  # x0..x7, feat
    x7, feat = acts[7], acts[8]
    h = stash.h.to(accumulate)
    ipe = q(ipe.float())
    dirs = q(dirs.float())
    g = q(g.float())
    grads: Dict[str, torch.Tensor] = {}

    def put(name, weight, bias):
        grads[f"{name}.weight"] = weight
        grads[f"{name}.bias"] = bias

    heads = [("fc_rgb", g[:, 0:3])]
    if net.depth_head:
        heads.append(("fc_mu_sigma", g[:, 4:6]))
    g_h = torch.zeros(n, dh, dtype=accumulate, device=g.device)
    for name, gk in heads:
        put(name, gk.T @ q(h), gk.sum(0))
        g_h = g_h + gk @ q(getattr(net, name).weight)
    g_h = torch.where(h > 0, g_h, 0.0)
    g_h_c = q(g_h)
    if per_ray_dirs:
        g_dproj = q(g_h.reshape(n // k, k, dh).sum(1))
    else:
        g_dproj = g_h_c.reshape(n // k, k, dh).sum(1)
    g_alpha = g[:, 3:4]
    put("layers_dir.0", torch.cat([g_h_c.T @ feat, g_dproj.T @ dirs], 1),
        g_h.sum(0))
    put("fc_alpha", g_alpha.T @ feat, g_alpha.sum(0))

    wd = q(net.layers_dir[0].weight)
    g_feat = g_h_c @ wd[:, :hid] + g_alpha * q(net.fc_alpha.weight)
    g_feat_c = q(g_feat)
    put("fc_feat", g_feat_c.T @ x7, g_feat.sum(0))
    gx = g_feat_c @ q(net.fc_feat.weight)
    for i in range(net.num_trunk_layers - 1, -1, -1):
        gi = torch.where(acts[i] > 0, gx, 0.0)
        gi_c = q(gi)
        if i == 0:
            inp = ipe
        elif i == net.skip_layer:
            inp = torch.cat([ipe, acts[i - 1]], 1)
        else:
            inp = acts[i - 1]
        put(f"layers_xyz.{i}", gi_c.T @ inp, gi.sum(0))
        if i > 0:
            w = q(net.layers_xyz[i].weight)
            gx = gi_c @ (w[:, ipe.shape[1]:] if i == net.skip_layer else w)
    return {name: grads[name] for name, _ in net.named_parameters()}


@torch.no_grad()
def tf32_split_pack_reference(buf: torch.Tensor, w_off, rows) -> None:
    """Fill planes 1..4 of ``buf`` (five planes of a float32 weight pack,
    the first the packed weights with matrix offsets ``w_off`` and row
    counts ``rows``): every weight's big and small TF32 part in the packed
    layout, then both with each matrix transposed to [in, out] at its own
    offset."""
    plane = buf.numel() // 5
    w = buf[:plane]
    big, small = tf32_split(w)
    buf[plane:2 * plane] = big
    buf[2 * plane:3 * plane] = small
    ends = (*w_off[1:], plane)
    for o, e, r in zip(w_off, ends, rows):
        for i, part in ((3, big), (4, small)):
            buf[i * plane + o:i * plane + e] = \
                part[o:e].view(r, -1).T.reshape(-1)


@torch.no_grad()
def tf32_planes_t_reference(g: torch.Tensor) -> torch.Tensor:
    """The transposed TF32 planes of a float32 cotangent slab ``g [n,
    cols]`` in the layout the wide plan's float32 backward writes for its
    weight gradients (``csrc/fused_mlp_wide.cu``, the chain's epilogue):
    ``[2, cols, ldt]`` with ``ldt`` = ``n`` rounded up to a multiple of 32,
    plane 0 the big and plane 1 the small parts of ``g.T``
    (:func:`tf32_split`), the columns past ``n`` zero."""
    n, cols = g.shape
    out = g.new_zeros((2, cols, -(-n // 32) * 32))
    big, small = tf32_split(g.T)
    out[0, :, :n] = big
    out[1, :, :n] = small
    return out
