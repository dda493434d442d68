"""Plain PyTorch versions of the fused-MLP kernels, at the kernels'
interface: flat ray-major rows and per-ray view directions.

* :func:`fused_mlp_reference` — the forward (B1 render mode), counterpart
  of ``ddnerf_tpu/kernels/fused_mlp.py::_reference_apply``;
* :func:`fused_mlp_stash_reference` — the training forward (B1 stash
  mode): the outputs and the activations the backward reads;
* :func:`fused_mlp_backward_reference` — the backward (B2,
  ``ddnerf_tpu/kernels/fused_mlp_bwd.py::_bwd_kernel``), written out with
  the kernel's rounding points.

The forward arithmetic is the module's own (:mod:`ddnerf_tpu_torch.models.
mlp`: operands rounded to the compute dtype, float32 products and
activations), so the kernels, these functions and the module agree up to
summation order.  The backward is explicit, not autograd through the
module: autograd through ``_q(weight)`` would round every weight gradient
to bf16 (the cast's VJP), where the kernel accumulates them in float32.
On a GPU the caller keeps TF32 off.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

NUM_STASH = 9  # x0..x7, feat: the first 7 slabs are the TPU split layout


class Stash(NamedTuple):
    """The training forward's activations in the compute dtype.

    ``trunk [9, N, H]``: x0..x6 (``trunk[:7]`` is the TPU kernel's
    ``split_h_stash`` trunk layout), then x7 and feat, which this port
    stashes instead of recomputing from x6; ``h [N, 128]``.
    """

    trunk: torch.Tensor
    h: torch.Tensor


def fused_mlp_reference(net, ipe: torch.Tensor, dirs: torch.Tensor,
                        samples_per_ray: int) -> torch.Tensor:
    """``ipe [N, 96]`` (row ``r`` belongs to ray ``r // K``), ``dirs
    [N // K, 27]`` -> ``[N, 4|6]`` float32."""
    k = samples_per_ray
    rays = ipe.shape[0] // k
    out = net(ipe.float().reshape(rays, k, ipe.shape[1]), dirs.float())
    return out.reshape(rays * k, out.shape[-1])


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
                                 stash: Stash) -> Dict[str, torch.Tensor]:
    """Parameter gradients of the fused MLP for the cotangent ``g [N, 4|6]``
    -> ``{parameter name: float32 gradient}`` (``net.named_parameters()``
    names and shapes).  No input gradients: ipe and dirs are detached
    upstream.  The rounding points are ``_bwd_kernel``'s: g in the compute
    dtype on entry; each matmul's cotangent operand rounded, bias sums
    taken in f32 before the rounding; relu masks from the stashed
    activations; the per-ray dirs cotangent summed in f32, then rounded.
    """
    q = net._q
    k = samples_per_ray
    n, hid, dh = ipe.shape[0], net.hidden_size, net.dir_hidden
    acts = [a.float() for a in stash.trunk]  # x0..x7, feat
    x7, feat = acts[7], acts[8]
    h = stash.h.float()
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
    g_h = torch.zeros(n, dh, dtype=torch.float32, device=g.device)
    for name, gk in heads:
        put(name, gk.T @ q(h), gk.sum(0))
        g_h = g_h + gk @ q(getattr(net, name).weight)
    g_h = torch.where(h > 0, g_h, 0.0)
    g_h_c = q(g_h)
    g_dproj = q(g_h.reshape(n // k, k, dh).sum(1))
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
