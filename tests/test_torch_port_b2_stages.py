"""``chip_smoke.py::b2_stage_readings``, the stage-by-stage check that holds
the fused backward (B2) on the card, on the CPU: the kernel's launch is
replaced by a stand-in that computes what B2 leaves behind (its bf16
cotangent slabs in the workspace layout of ``csrc/fused_mlp_bwd.cu``, its
float32 gradients in the packed layout) at the plain version's rounding
points.  A sound stand-in reads within ``B2_STAGE_LIMITS``; each fault that
``scripts/b2_rounding_floor.py`` patches into the CUDA source, made here in
the stand-in, breaks the limit of the stage it touches."""

import pytest
import torch

import chip_smoke as cs
from ddnerf_tpu_torch.kernels import fused_mlp as fk
from ddnerf_tpu_torch.kernels import reference as ref
from ddnerf_tpu_torch.models.mlp import DepthMipMLP, MipMLP

FAULTS = {
    "cotangent rounded toward zero": "flip_share",
    "biases summed after rounding": "biases",
    "weight gradients rounded to bf16": "weights",
    "a quarter of the rows dropped from the weight gradients": "weights",
    "per-sample dirs cotangent summed unrounded": "dirs",
}


def _bf16(t):
    return t.bfloat16().float()


def _bf16_toward_zero(t):
    return (t.view(torch.int32) & ~0xFFFF).view(torch.float32)


def _stand_in(fault=None):
    """A ``chip_smoke._b2_launch`` computing B2 in plain float32 (with
    ``fault``): ``(gw, gb, workspace bytes, packed weights)``."""

    def launch(torch_, net, ipe, dirs, g, k, stash, per_ray, lib=None):
        n, hid = ipe.shape[0], fk.kernel_width(net.hidden_size)
        kw = fk.pack_weights(net)
        w = [m.float() for m in cs._packed_mats(kw, kw.w, hid)]
        x, h = stash.trunk.float(), stash.h.float()
        rnd = _bf16_toward_zero if fault == "cotangent rounded toward zero" \
            else _bf16
        gs = torch.zeros(n, 64)
        gs[:, 0:3] = g[:, 0:3]
        if net.depth_head:
            gs[:, 3:5] = g[:, 4:6]
        gs[:, 16] = g[:, 3]
        gs = _bf16(gs)
        g_h = torch.where(h > 0, gs[:, :16] @ w[10], 0.0)
        gd = rnd(g_h)
        pre, gt = [None] * 9, [None] * 9
        pre[8] = torch.cat([gd, gs[:, 16:17]], 1) @ w[9][:129]
        gt[8] = rnd(pre[8])
        for layer, out in [(8, 7)] + [(i, i - 1) for i in range(7, 0, -1)]:
            wm = w[layer][:, 96:] if layer == 5 else w[layer]
            pre[out] = torch.where(x[out] > 0, gt[layer] @ wm, 0.0)
            gt[out] = rnd(pre[out])

        rows = n - n // 4 if fault == \
            "a quarter of the rows dropped from the weight gradients" else n
        ipe_b = _bf16(ipe)
        mats = []
        for i in range(8):
            act = (ipe_b if i == 0 else torch.cat([ipe_b, x[4]], 1) if i == 5
                   else x[i - 1])
            mats.append(gt[i][:rows].T @ act[:rows])
        mats.append(gt[8].T @ x[7])
        w_dir = torch.zeros(144, hid)
        w_dir[:128] = gd.T @ x[8]
        w_dir[128] = gs[:, 16] @ x[8]
        mats += [w_dir, gs[:, :16].T @ h]
        per_row = g_h.view(n // k, k, 128)
        if per_ray:
            g_dproj = _bf16(per_row.sum(1))
        elif fault == "per-sample dirs cotangent summed unrounded":
            g_dproj = per_row.sum(1)
        else:
            g_dproj = _bf16(per_row).sum(1)
        w_dirs = torch.zeros(128, 32)
        w_dirs[:, :dirs.shape[1]] = g_dproj.T @ _bf16(dirs)
        mats.append(w_dirs)
        if fault == "weight gradients rounded to bf16":
            mats = [_bf16(m) for m in mats]
        gw = torch.cat([m.reshape(-1) for m in mats])

        summed = gt if fault == "biases summed after rounding" else pre
        b_dir = torch.zeros(144)
        b_dir[:128] = g_h.sum(0)
        b_dir[128] = gs[:, 16].sum()
        gb = torch.cat([torch.stack([summed[i].sum(0) for i in range(8)])
                        .reshape(-1), summed[8].sum(0), b_dir,
                        gs[:, :16].sum(0)])

        def region(t):
            b = t.contiguous().reshape(-1).view(torch.uint8)
            return torch.cat([b, torch.zeros(-b.numel() % 256,
                                             dtype=torch.uint8)])

        ws = torch.cat([region(gs.bfloat16()), region(gd.bfloat16()),
                        region(g_h), region(torch.stack(gt).bfloat16())])
        return gw, gb, ws, kw

    return launch


def _case(depth_head, hidden, rays=20, k=7, seed=3):
    gen = torch.Generator().manual_seed(seed + hidden)
    net = (DepthMipMLP if depth_head else MipMLP)(
        hidden_size=hidden, compute_dtype=torch.bfloat16, generator=gen)
    ipe = torch.rand(rays * k, 96, generator=gen) * 2 - 1
    dirs = torch.rand(rays, 27, generator=gen) * 2 - 1
    g = torch.randn(rays * k, net.out_dim, generator=gen)
    _, stash = ref.fused_mlp_stash_reference(net, ipe, dirs, k)
    if fk.kernel_width(hidden) != hidden:  # the kernel's padded stash
        wide = ref.Stash(torch.zeros(
            stash.trunk.shape[0], rays * k, fk.kernel_width(hidden),
            dtype=stash.trunk.dtype), stash.h)
        wide.trunk[..., :hidden] = stash.trunk
        stash = wide
    return net, ipe, dirs, g, k, stash


def _readings(monkeypatch, fault, depth_head, hidden, per_ray):
    monkeypatch.setattr(cs, "_b2_launch", _stand_in(fault))
    net, ipe, dirs, g, k, stash = _case(depth_head, hidden)
    return net, cs.b2_stage_readings(torch, net, ipe, dirs, g, k, stash,
                                     per_ray)


@pytest.mark.parametrize("per_ray", [False, True])
@pytest.mark.parametrize("depth_head", [False, True])
@pytest.mark.parametrize("hidden", [64, 96])
def test_sound_backward_reads_within_the_stage_limits(monkeypatch, hidden,
                                                      depth_head, per_ray):
    net, (stages, grads) = _readings(monkeypatch, None, depth_head, hidden,
                                     per_ray)
    over = {key: stages[key] for key, limit in cs.B2_STAGE_LIMITS.items()
            if not stages[key] <= limit}
    assert not over, over
    assert list(grads) == [name for name, _ in net.named_parameters()]
    for name, p in net.named_parameters():
        assert grads[name].shape == p.shape, name


@pytest.mark.parametrize("fault", list(FAULTS))
def test_each_injected_fault_breaks_its_stage_limit(monkeypatch, fault):
    _, (stages, _) = _readings(monkeypatch, fault, True, 96, False)
    key = FAULTS[fault]
    assert stages[key] > cs.B2_STAGE_LIMITS[key], (fault, stages)
