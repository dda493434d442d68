"""Fused NeRF MLP forward: the hand-written Hopper kernel
(``csrc/fused_mlp_fwd.cu``) and its wrapper.

Replaces ``ddnerf_tpu/kernels/fused_mlp.py::fused_mlp_forward`` in render
mode (no activation stash, per-ray view directions).  The kernel computes
the whole MipMLP / DepthMipMLP network per tile of 128 rows with every
activation in shared memory; the CUDA source says what bounds it and how
it is laid out.

On a CPU tensor the wrapper runs the plain PyTorch version
(:func:`ddnerf_tpu_torch.kernels.reference.fused_mlp_reference`); on a CUDA
tensor it launches the kernel or raises.  There is no fallback from one to
the other.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ddnerf_tpu_torch.kernels.reference import fused_mlp_reference
from ddnerf_tpu_torch.models.mlp import DIR_DIM, IPE_DIM

# Launch count of each kernel: +1 per launch of the CUDA kernel, never for
# the plain version, so a run can show that its main path went through it.
LAUNCHES = {"fused_mlp_fwd": 0}

SUPPORTED_HIDDEN = (64, 128, 256)
DIR_HIDDEN = 128
DIR_LAYER_ROWS = 144  # Wd_feat rows | fc_alpha | zero pad (an n8 multiple)
HEAD_ROWS = 16  # fc_rgb (3) | fc_mu_sigma (2) | zero pad
DIRS_LD = 32  # row stride of the packed Wd_dirs


class KernelWeights(NamedTuple):
    """One network's weights in the kernel's packed layout (see the
    layout table at the top of ``csrc/fused_mlp_fwd.cu``)."""

    w: torch.Tensor  # bf16, every matrix in torch [out, in] layout
    b: torch.Tensor  # f32 biases
    w_off: tuple  # 12 element offsets into w
    b_off: tuple  # 4 element offsets into b


@torch.no_grad()
def pack_weights(net) -> KernelWeights:
    """Pack ``net``'s parameters for the kernel, on ``net``'s device.
    Weights are rounded to bf16 (round-to-nearest-even, as the TPU kernel's
    ``astype``); biases stay f32."""
    hid, dh = net.hidden_size, net.dir_hidden
    ref = net.fc_feat.weight
    wd = net.layers_dir[0].weight  # [dh, hid + 27]

    w_dir = ref.new_zeros(DIR_LAYER_ROWS, hid)
    w_dir[:dh] = wd[:, :hid]
    w_dir[dh] = net.fc_alpha.weight[0]
    w_head = ref.new_zeros(HEAD_ROWS, dh)
    w_head[:3] = net.fc_rgb.weight
    w_dirs = ref.new_zeros(dh, DIRS_LD)
    w_dirs[:, :DIR_DIM] = wd[:, hid:]

    b_dir = ref.new_zeros(DIR_LAYER_ROWS)
    b_dir[:dh] = net.layers_dir[0].bias
    b_dir[dh] = net.fc_alpha.bias[0]
    b_head = ref.new_zeros(HEAD_ROWS)
    b_head[:3] = net.fc_rgb.bias
    if net.depth_head:
        w_head[3:5] = net.fc_mu_sigma.weight
        b_head[3:5] = net.fc_mu_sigma.bias

    mats = [layer.weight for layer in net.layers_xyz]
    mats += [net.fc_feat.weight, w_dir, w_head, w_dirs]
    biases = [torch.stack([layer.bias for layer in net.layers_xyz]),
              net.fc_feat.bias, b_dir, b_head]

    def offsets(parts):
        offs, total = [], 0
        for t in parts:
            offs.append(total)
            total += t.numel()
        return tuple(offs)

    w_off, b_off = offsets(mats), offsets(biases)
    # 16-byte alignment of every matrix for the kernel's cp.async copies.
    assert all(o % 8 == 0 for o in w_off), w_off
    w = torch.cat([m.reshape(-1) for m in mats]).to(torch.bfloat16)
    b = torch.cat([t.reshape(-1) for t in biases]).float()
    return KernelWeights(w.contiguous(), b.contiguous(), w_off, b_off)


def _packed(net) -> KernelWeights:
    """``pack_weights`` cached on the module until a parameter changes."""
    key = tuple((p.data_ptr(), p._version) for p in net.parameters())
    cached = getattr(net, "_fused_mlp_pack", None)
    if cached is None or cached[0] != key:
        cached = (key, pack_weights(net))
        net._fused_mlp_pack = cached
    return cached[1]


def _check_net(net, device) -> None:
    if net.compute_dtype != torch.bfloat16:
        raise ValueError(
            "the fused MLP kernel computes in bf16; this network's compute "
            f"dtype is {net.compute_dtype} (use parallel.pallas_mlp: off for "
            "float32 compute)")
    if (net.hidden_size not in SUPPORTED_HIDDEN
            or net.dir_hidden != DIR_HIDDEN
            or net.num_trunk_layers != 8 or net.skip_layer != 5):
        raise ValueError(
            "the fused MLP kernel takes 8 trunk layers with the skip at 5, "
            f"hidden width in {SUPPORTED_HIDDEN} and a {DIR_HIDDEN}-wide "
            f"dir branch; got hidden={net.hidden_size}, "
            f"dir_hidden={net.dir_hidden}, layers={net.num_trunk_layers}, "
            f"skip={net.skip_layer}")
    if net.fc_feat.weight.device != device:
        raise ValueError(f"network is on {net.fc_feat.weight.device}, "
                         f"inputs on {device}")


def fused_mlp_forward(net, ipe: torch.Tensor, dirs: torch.Tensor,
                      samples_per_ray: int) -> torch.Tensor:
    """Evaluate ``net`` (a MipMLP / DepthMipMLP) on ray-major rows.

    ``ipe [N, 96]``: row ``r`` belongs to ray ``r // K``;
    ``dirs [N // K, 27]``: the view-direction PE of each ray;
    ``samples_per_ray``: K.  Returns ``[N, 4|6]`` float32 =
    (rgb, alpha[, raw_mu, raw_sigma]).
    """
    k = int(samples_per_ray)
    n = ipe.shape[0]
    if ipe.dim() != 2 or ipe.shape[1] != IPE_DIM:
        raise ValueError(f"ipe must be [N, {IPE_DIM}], got {tuple(ipe.shape)}")
    if k <= 0 or n % k:
        raise ValueError(f"{n} rows are not whole rays of {k} samples")
    if tuple(dirs.shape) != (n // k, DIR_DIM):
        raise ValueError(f"dirs must be [{n // k}, {DIR_DIM}] (one row per "
                         f"ray), got {tuple(dirs.shape)}")
    if dirs.device != ipe.device:
        raise ValueError(f"ipe on {ipe.device}, dirs on {dirs.device}")
    if ipe.device.type == "cpu":
        return fused_mlp_reference(net, ipe, dirs, k)
    if ipe.device.type != "cuda":
        raise ValueError(f"no fused MLP kernel for device {ipe.device}")

    _check_net(net, ipe.device)
    from ddnerf_tpu_torch.kernels import build

    lib = build.load_library()
    kw = _packed(net)
    out = torch.empty((n, net.out_dim), dtype=torch.float32, device=ipe.device)
    if n == 0:
        return out
    ipe_b = ipe.to(torch.bfloat16).contiguous()
    dirs_b = dirs.to(torch.bfloat16).contiguous()
    if ipe_b.data_ptr() % 16:
        ipe_b = ipe_b.clone()  # the kernel copies IPE rows in 16-byte chunks
    dproj = torch.empty((n // k, DIR_HIDDEN), dtype=torch.float32,
                        device=ipe.device)
    i64 = ctypes.c_longlong
    err = lib.ddnerf_fused_mlp_fwd(
        ipe_b.data_ptr(), dirs_b.data_ptr(), kw.w.data_ptr(), kw.b.data_ptr(),
        dproj.data_ptr(), out.data_ptr(), n, k, net.hidden_size,
        int(net.depth_head), (i64 * len(kw.w_off))(*kw.w_off),
        (i64 * len(kw.b_off))(*kw.b_off),
        torch.cuda.current_stream(ipe.device).cuda_stream,
    )
    build.check(lib, err, "fused_mlp_fwd")
    LAUNCHES["fused_mlp_fwd"] += 1
    return out
