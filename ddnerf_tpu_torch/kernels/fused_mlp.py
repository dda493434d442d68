"""Fused NeRF MLP kernels and their wrappers: the forward
(``csrc/fused_mlp_fwd.cu``) in render and stash mode and fed raw means and
covariances (the in-kernel IPE), the backward (``csrc/fused_mlp_bwd.cu``),
and the ``autograd.Function`` that joins them for training.  Each wrapper
dispatches on the network's compute dtype: bfloat16 runs those kernels,
float32 their float32 counterparts (``csrc/fused_mlp_f32.cu``, counted
under the same names with ``_f32`` appended), which round nothing and
read the float32 pack's TF32 planes (:func:`with_tf32_planes`).  And on
the network's width: up to :data:`MAX_FUSED_HIDDEN` the fused plans, above
it the wide plan (``csrc/fused_mlp_wide.cu``, one GEMM launch per layer
with the activations through device memory, both dtypes; counted as
``wide_*``, e.g. ``wide_mlp_fwd_stash`` and ``wide_mlp_bwd_f32``).

Replaces ``ddnerf_tpu/kernels/fused_mlp.py::fused_mlp_forward`` (render
mode, and ``stash=True``), ``fused_enc_mlp_forward`` (render only),
``ddnerf_tpu/kernels/fused_mlp_bwd.py::fused_mlp_backward`` and its custom
VJP ``fused_mlp_train_apply``, with per-ray view directions.  The forward
computes the whole MipMLP / DepthMipMLP network per tile of 128 rows with
every activation in shared memory; the backward computes every parameter
gradient from the forward's stash in deterministic passes (the cotangent
chain, the weight gradients, fixed-order reductions).  The CUDA
sources say what bounds them and how they are laid out.

On a CPU tensor each wrapper runs its plain PyTorch version
(:mod:`ddnerf_tpu_torch.kernels.reference`); on a CUDA tensor it launches
the kernel or raises.  There is no fallback from one to the other.

Under CUDA-graph capture (``train/step.py::CapturedTrainStep``) a wrapper's
call records its launches into the graph instead of running them.  Every
buffer a wrapper allocates then comes from the graph's private pool, and
the C entry points bake those addresses into the launch nodes: as kernel
arguments and inside the TMA tensor maps, which are ``__grid_constant__``
arguments encoded on the host from the addresses.  A replay is therefore
right as long as everything the graph reads or writes outside its pool
stays where it was: the parameters, the inputs the caller made outside the
capture, and the graph object itself, which owns the pool.  The weight pack
is made inside the graph at every step (:func:`_packed`), since a replay
runs no Python that could notice a changed parameter.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import torch

from ddnerf_tpu_torch.kernels.reference import (
    NUM_STASH,
    Stash,
    fused_enc_mlp_reference,
    fused_mlp_backward_reference,
    fused_mlp_reference,
    fused_mlp_stash_reference,
    tf32_split_pack_reference,
)
from ddnerf_tpu_torch.models.mlp import DIR_DIM, IPE_DIM
from ddnerf_tpu_torch.utils.profiling import counters

# Launch count of each kernel: +1 per launch of the CUDA kernel, never for
# the plain version, so a run can show that its main path went through it.
# The tracer's counter group ``kernels.launches``.
LAUNCHES = counters("kernels.launches", (
    "fused_mlp_fwd", "fused_mlp_fwd_stash", "fused_mlp_bwd",
    "fused_enc_mlp_fwd", "fused_mlp_fwd_f32", "fused_mlp_fwd_stash_f32",
    "fused_mlp_bwd_f32", "fused_enc_mlp_fwd_f32",
    "wide_mlp_fwd", "wide_mlp_fwd_stash", "wide_mlp_bwd", "wide_enc_mlp_fwd",
    "wide_mlp_fwd_f32", "wide_mlp_fwd_stash_f32", "wide_mlp_bwd_f32",
    "wide_enc_mlp_fwd_f32"))
# Under CUDA-graph capture a wrapper launches nothing: it records its kernel
# into the graph and counts here (``kernels.captured``).  The graph's owner
# reads what a capture added and adds that to LAUNCHES at every replay,
# where the kernels run.
CAPTURED = counters("kernels.captured", LAUNCHES)


def _count(name: str, net) -> None:
    """One launch of kernel ``name`` (a fused plan's) at ``net``'s compute
    dtype and width: the wide plan's counterpart above
    :data:`MAX_FUSED_HIDDEN`."""
    if is_wide(net.hidden_size):
        name = "wide_" + name[len("fused_"):]
    if net.compute_dtype == torch.float32:
        name += "_f32"
    counts = CAPTURED if torch.cuda.is_current_stream_capturing() else LAUNCHES
    counts[name] += 1

# The widths the fused plans are built for; a network of another width up
# to MAX_FUSED_HIDDEN runs at the next of them with its weights
# zero-padded (:func:`pack_weights`).  A wider network runs the wide plan
# at its width rounded up to a multiple of WIDE_ALIGN, which has no upper
# limit but device memory (as the JAX kernels check no width).  A padded
# unit's pre-activation is 0 and relu keeps it 0, so it adds nothing
# forward; its mask is 0, so its cotangent is 0 and it adds nothing to any
# gradient: the padding is exact.
KERNEL_WIDTHS = (64, 128, 192, 256, 384, 512)
MAX_FUSED_HIDDEN = KERNEL_WIDTHS[-1]
WIDE_ALIGN = 64
DIR_HIDDEN = 128
DIR_LAYER_ROWS = 144  # Wd_feat rows | fc_alpha | zero pad (an n8 multiple)
HEAD_ROWS = 16  # fc_rgb (3) | fc_mu_sigma (2) | zero pad
DIRS_LD = 32  # row stride of the packed Wd_dirs


def _named_params(net) -> list:
    """``list(net.named_parameters())`` read off the network's own layers:
    the same names and tensors in the same order, without ``nn.Module``'s
    recursive walk, which takes more host time than launching the kernels
    does (every wrapper call needs the list)."""
    layers = [(f"layers_xyz.{i}", m) for i, m in enumerate(net.layers_xyz)]
    layers += [("fc_feat", net.fc_feat), ("fc_alpha", net.fc_alpha),
               ("layers_dir.0", net.layers_dir[0]), ("fc_rgb", net.fc_rgb)]
    if net.depth_head:
        layers.append(("fc_mu_sigma", net.fc_mu_sigma))
    return [(f"{name}.{leaf}", getattr(m, leaf)) for name, m in layers
            for leaf in ("weight", "bias")]


def kernel_width(hidden: int) -> int:
    """The width the kernels run a network of width ``hidden`` at: the
    smallest of :data:`KERNEL_WIDTHS` that is at least ``hidden``, and above
    them ``hidden`` rounded up to a multiple of :data:`WIDE_ALIGN` (the
    wide plan)."""
    if hidden < 1:
        raise ValueError(f"a hidden width must be positive; got {hidden}")
    for width in KERNEL_WIDTHS:
        if hidden <= width:
            return width
    return -(-hidden // WIDE_ALIGN) * WIDE_ALIGN


def is_wide(hidden: int) -> bool:
    """Whether a network of width ``hidden`` runs the wide plan."""
    return hidden > MAX_FUSED_HIDDEN


def stash_width(net, device) -> int:
    """Width of the stash slabs of a training forward on ``device``: the
    kernels' (padded) width on a card, the network's on the CPU, where the
    plain version makes the stash."""
    hid = net.hidden_size
    return hid if torch.device(device).type == "cpu" else kernel_width(hid)


def _pad(t: torch.Tensor, shape) -> torch.Tensor:
    """``t`` in the leading corner of a zero tensor of ``shape``."""
    out = t.new_zeros(shape)
    out[tuple(slice(0, n) for n in t.shape)] = t
    return out


class KernelWeights(NamedTuple):
    """One network's weights in the kernel's packed layout (see the
    layout table at the top of ``csrc/fused_mlp_fwd.cu``)."""

    w: torch.Tensor  # compute dtype, every matrix in torch [out, in] layout
    b: torch.Tensor  # f32 biases
    w_off: tuple  # 12 element offsets into w
    b_off: tuple  # 4 element offsets into b
    # float32 only: w followed by its TF32 planes, one buffer whose first
    # plane w views (:func:`with_tf32_planes`); None at bfloat16.
    planes: Optional[torch.Tensor] = None


# The float32 pack's planes: w itself, every weight's TF32 big and small
# part (big = tf32(x), small = tf32(x - big); tf32 rounds to nearest, ties
# away from zero), in the packed layout and transposed (matrix [out, in] ->
# [in, out] at its own offset).
TF32_PLANES = ("f32", "big", "small", "big_t", "small_t")


def plane_size(w_off) -> int:
    """Elements of one plane of a pack with offsets ``w_off``: its last
    matrix, Wd_dirs, is [128, 32]."""
    return w_off[-1] + DIR_HIDDEN * DIRS_LD


def packed_rows(width: int) -> tuple:
    """Rows (outputs) of the 12 packed matrices at kernel width ``width``."""
    return (width,) * 9 + (DIR_LAYER_ROWS, HEAD_ROWS, DIR_HIDDEN)


def with_tf32_planes(kw: KernelWeights) -> KernelWeights:
    """``kw`` (a float32 pack) with its TF32 planes: one buffer of
    ``len(TF32_PLANES)`` planes, the first ``kw.w``, the others made by the
    split kernel (``csrc/fused_mlp_f32.cu::tf32_split_kernel``) on a card
    and by its plain version on the CPU.  The float32 kernels read the
    planes from the pack's address: the returned ``w`` is a view of the
    buffer's first plane."""
    plane = plane_size(kw.w_off)
    width = (kw.w_off[1] - kw.w_off[0]) // IPE_DIM  # W0 is [width, 96]
    buf = kw.w.new_empty(len(TF32_PLANES) * plane)
    buf[:plane] = kw.w
    if buf.is_cuda:
        from ddnerf_tpu_torch.kernels import build

        lib = build.load_library()
        split = (lib.ddnerf_wide_tf32_split if is_wide(width)
                 else lib.ddnerf_tf32_split)
        err = split(buf.data_ptr(), width, _offsets(kw)[0],
                    torch.cuda.current_stream(buf.device).cuda_stream)
        build.check(lib, err, "tf32_split")
    else:
        tf32_split_pack_reference(buf, kw.w_off, packed_rows(width))
    return kw._replace(w=buf[:plane], planes=buf)


def _weights_ptr(kw: KernelWeights, cdt: torch.dtype) -> int:
    """The address of the pack a kernel reads: a float32 pack's planes."""
    if cdt != torch.float32:
        return kw.w.data_ptr()
    if kw.planes is None or kw.planes.data_ptr() != kw.w.data_ptr():
        raise ValueError("a float32 pack must carry its TF32 planes "
                         "(with_tf32_planes), its w their first plane")
    return kw.planes.data_ptr()


@torch.no_grad()
def pack_weights(net) -> KernelWeights:
    """Pack ``net``'s parameters for the kernels, on ``net``'s device, at
    :func:`kernel_width`: a narrower network's trunk, fc_feat and dir-layer
    matrices and biases get zero rows and columns past its width.  Weights
    are cast to the network's compute dtype (bf16: round-to-nearest-even, as
    the TPU kernel's ``astype``; float32: unchanged, with the TF32 planes
    of :func:`with_tf32_planes` beside them); biases stay f32.  The backward
    kernel writes its f32 gradients in the layout of ``w``
    (:func:`unpack_grads`)."""
    hid, dh = net.hidden_size, net.dir_hidden
    width = kernel_width(hid)
    ref = net.fc_feat.weight
    wd = net.layers_dir[0].weight  # [dh, hid + 27]

    w_dir = ref.new_zeros(DIR_LAYER_ROWS, width)
    w_dir[:dh, :hid] = wd[:, :hid]
    w_dir[dh, :hid] = net.fc_alpha.weight[0]
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

    mats = [layer.weight for layer in net.layers_xyz] + [net.fc_feat.weight]
    b_trunk = torch.stack([layer.bias for layer in net.layers_xyz])
    b_feat = net.fc_feat.bias
    if width != hid:
        skip = net.skip_layer
        mats = [_pad(m, (width, width)) if i not in (0, skip) else
                _pad(m, (width, IPE_DIM)) if i == 0 else
                torch.cat([_pad(m[:, :IPE_DIM], (width, IPE_DIM)),
                           _pad(m[:, IPE_DIM:], (width, width))], 1)
                for i, m in enumerate(mats)]
        b_trunk = _pad(b_trunk, (len(net.layers_xyz), width))
        b_feat = _pad(b_feat, (width,))
    mats += [w_dir, w_head, w_dirs]
    biases = [b_trunk, b_feat, b_dir, b_head]

    def offsets(parts):
        offs, total = [], 0
        for t in parts:
            offs.append(total)
            total += t.numel()
        return tuple(offs)

    w_off, b_off = offsets(mats), offsets(biases)
    # 16-byte alignment of every matrix: each is the base of a TMA tensor map.
    assert all(o % 8 == 0 for o in w_off), w_off
    w = torch.cat([m.reshape(-1) for m in mats]).to(net.compute_dtype)
    b = torch.cat([t.reshape(-1) for t in biases]).float()
    kw = KernelWeights(w.contiguous(), b.contiguous(), w_off, b_off)
    return with_tf32_planes(kw) if net.compute_dtype == torch.float32 else kw


def unpack_grads(net, kw: KernelWeights, gw: torch.Tensor,
                 gb: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`pack_weights` for gradients: ``gw`` / ``gb``
    laid out as ``kw.w`` / ``kw.b`` -> ``{parameter name: tensor}`` in
    ``net.named_parameters()`` order (views where the layout allows), each
    cut to the network's width where the layout is padded."""
    hid, dh = net.hidden_size, net.dir_hidden
    width = kernel_width(hid)
    # One split per buffer, then a view per matrix: this runs twice per
    # train step on the host's clock, so it spends few dispatches.
    ends_w = (*kw.w_off[1:], gw.numel())
    ends_b = (*kw.b_off[1:], gb.numel())
    mats = gw.split([e - o for o, e in zip(kw.w_off, ends_w)])
    b_trunk, b_feat, b_dir, b_head = gb.split(
        [e - o for o, e in zip(kw.b_off, ends_b)])

    padded = width != hid
    grads = {}
    for i, (layer, bias) in enumerate(zip(net.layers_xyz,
                                          b_trunk.view(-1, width).unbind(0))):
        w = mats[i].view(width, layer.in_features + (width - hid) * (i > 0))
        if padded:
            w, bias = w[:hid], bias[:hid]
            if i == net.skip_layer:
                w = torch.cat([w[:, :IPE_DIM], w[:, IPE_DIM:IPE_DIM + hid]], 1)
            elif i > 0:
                w = w[:, :hid]
        grads[f"layers_xyz.{i}.weight"] = w
        grads[f"layers_xyz.{i}.bias"] = bias
    w_feat = mats[8].view(width, width)
    w_dir = mats[9].view(DIR_LAYER_ROWS, width)
    if padded:
        w_feat, b_feat, w_dir = w_feat[:hid, :hid], b_feat[:hid], w_dir[:, :hid]
    grads["fc_feat.weight"] = w_feat
    grads["fc_feat.bias"] = b_feat
    grads["fc_alpha.weight"] = w_dir[dh:dh + 1]
    grads["fc_alpha.bias"] = b_dir[dh:dh + 1]
    grads["layers_dir.0.weight"] = torch.cat(
        [w_dir[:dh], mats[11].view(dh, DIRS_LD)[:, :DIR_DIM]], 1)
    grads["layers_dir.0.bias"] = b_dir[:dh]
    w_head = mats[10].view(HEAD_ROWS, dh)
    grads["fc_rgb.weight"], grads["fc_rgb.bias"] = w_head[:3], b_head[:3]
    if net.depth_head:
        grads["fc_mu_sigma.weight"] = w_head[3:5]
        grads["fc_mu_sigma.bias"] = b_head[3:5]
    return {name: grads[name] for name, _ in _named_params(net)}


def _packed(net) -> KernelWeights:
    """``pack_weights`` cached on the module until a parameter changes.
    Under CUDA-graph capture the key differs from any made outside one, so
    the first call of a capture packs inside the graph, into the graph's
    own buffers, and the later calls of the same step share that pack.  A
    replay changes the parameters without moving their version counters:
    whoever replays a graph calls :func:`forget_packed` afterwards."""
    capturing = (net.fc_feat.weight.is_cuda
                 and torch.cuda.is_current_stream_capturing())
    key = (capturing,
           tuple((p.data_ptr(), p._version) for _, p in _named_params(net)))
    cached = getattr(net, "_fused_mlp_pack", None)
    if cached is None or cached[0] != key:
        cached = (key, pack_weights(net))
        net._fused_mlp_pack = cached
    return cached[1]


def forget_packed(net) -> None:
    """Drop ``net``'s cached pack: its parameters were changed where no
    version counter sees it (a CUDA-graph replay), or the pack lives in a
    graph's pool and must not be read from outside."""
    net._fused_mlp_pack = None


def _check_net(net, device) -> None:
    if net.compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(
            "the fused MLP kernels compute in bfloat16 or float32; this "
            f"network's compute dtype is {net.compute_dtype}")
    if (net.hidden_size < 1 or net.dir_hidden != DIR_HIDDEN
            or net.num_trunk_layers != 8 or net.skip_layer != 5):
        raise ValueError(
            "the fused MLP kernel takes 8 trunk layers with the skip at 5 "
            f"and a {DIR_HIDDEN}-wide dir branch (the JAX kernel's network; "
            f"any hidden width); got hidden={net.hidden_size}, "
            f"dir_hidden={net.dir_hidden}, layers={net.num_trunk_layers}, "
            f"skip={net.skip_layer}")
    if net.fc_feat.weight.device != device:
        raise ValueError(f"network is on {net.fc_feat.weight.device}, "
                         f"inputs on {device}")


def _check_rows(ipe: torch.Tensor, dirs: torch.Tensor, k: int,
                name: str = "ipe", width: int = IPE_DIM) -> int:
    n = ipe.shape[0]
    if ipe.dim() != 2 or ipe.shape[1] != width:
        raise ValueError(f"{name} must be [N, {width}], got "
                         f"{tuple(ipe.shape)}")
    if k <= 0 or n % k:
        raise ValueError(f"{n} rows are not whole rays of {k} samples")
    if tuple(dirs.shape) != (n // k, DIR_DIM):
        raise ValueError(f"dirs must be [{n // k}, {DIR_DIM}] (one row per "
                         f"ray), got {tuple(dirs.shape)}")
    if dirs.device != ipe.device:
        raise ValueError(f"{name} on {ipe.device}, dirs on {dirs.device}")
    if ipe.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused MLP kernel for device {ipe.device}")
    return n


def _rows(ipe: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    rows = ipe.to(dtype).contiguous()
    if rows.data_ptr() % 16:
        rows = rows.clone()  # the kernels copy IPE rows in 16-byte chunks
    return rows


def _wide_workspace(nbytes: int, dev) -> torch.Tensor:
    """The wide plan's scratch (activations, cotangent slabs, partial
    sums) of the size its C entry point asks for."""
    if nbytes < 0:
        raise ValueError("the wide plan refuses these arguments")
    return torch.empty(nbytes, dtype=torch.uint8, device=dev)


def _offsets(kw: KernelWeights):
    i64 = ctypes.c_longlong
    return (i64 * len(kw.w_off))(*kw.w_off), (i64 * len(kw.b_off))(*kw.b_off)


def fused_mlp_forward(net, ipe: torch.Tensor, dirs: torch.Tensor,
                      samples_per_ray: int, stash: bool = False):
    """Evaluate ``net`` (a MipMLP / DepthMipMLP) on ray-major rows.

    ``ipe [N, 96]``: row ``r`` belongs to ray ``r // K``;
    ``dirs [N // K, 27]``: the view-direction PE of each ray;
    ``samples_per_ray``: K.  Returns ``[N, 4|6]`` float32 =
    (rgb, alpha[, raw_mu, raw_sigma]); with ``stash`` (the training
    forward) ``(out, Stash)``, the activations the backward reads, with
    trunk slabs :func:`stash_width` wide (on a card the columns past the
    network's width are zero).
    """
    k = int(samples_per_ray)
    n = _check_rows(ipe, dirs, k)
    if ipe.device.type == "cpu":
        if stash:
            return fused_mlp_stash_reference(net, ipe, dirs, k)
        return fused_mlp_reference(net, ipe, dirs, k)

    _check_net(net, ipe.device)
    from ddnerf_tpu_torch.kernels import build

    dev, hid, cdt = ipe.device, kernel_width(net.hidden_size), net.compute_dtype
    out = torch.empty((n, net.out_dim), dtype=torch.float32, device=dev)
    acts = None
    if stash:
        acts = Stash(
            torch.empty((NUM_STASH, n, hid), dtype=cdt, device=dev),
            torch.empty((n, DIR_HIDDEN), dtype=cdt, device=dev))
    if n == 0:
        return (out, acts) if stash else out
    lib = build.load_library()
    kw = _packed(net)
    ipe_c = _rows(ipe, cdt)
    dirs_c = dirs.to(cdt).contiguous()
    dproj = torch.empty((n // k, DIR_HIDDEN), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    stash_ptrs = ((acts.trunk.data_ptr(), acts.h.data_ptr()) if stash
                  else (None, None))
    if is_wide(hid):
        f32 = int(cdt == torch.float32)
        ws = _wide_workspace(lib.ddnerf_wide_fwd_workspace(n, hid, f32,
                                                           int(stash), 0), dev)
        err = lib.ddnerf_wide_fwd(
            ipe_c.data_ptr(), dirs_c.data_ptr(), _weights_ptr(kw, cdt),
            kw.b.data_ptr(), dproj.data_ptr(), out.data_ptr(), *stash_ptrs,
            ws.data_ptr(), ws.numel(), n, k, hid, int(net.depth_head), f32,
            *_offsets(kw), stream)
    else:
        entry = (lib.ddnerf_fused_mlp_fwd_f32 if cdt == torch.float32
                 else lib.ddnerf_fused_mlp_fwd)
        err = entry(
            ipe_c.data_ptr(), dirs_c.data_ptr(), _weights_ptr(kw, cdt),
            kw.b.data_ptr(), dproj.data_ptr(), out.data_ptr(), *stash_ptrs,
            n, k, hid, int(net.depth_head), *_offsets(kw), stream)
    name = "fused_mlp_fwd_stash" if stash else "fused_mlp_fwd"
    build.check(lib, err, name)
    _count(name, net)
    return (out, acts) if stash else out


def fused_enc_mlp_forward(net, means: torch.Tensor, covs: torch.Tensor,
                          dirs: torch.Tensor,
                          samples_per_ray: int) -> torch.Tensor:
    """Evaluate ``net`` on ray-major rows given by their Gaussians: ``means``
    / ``covs [N, 3]`` (float32; row ``r`` belongs to ray ``r // K``), with
    the IPE computed inside the kernel in the direct form, and ``dirs
    [N // K, 27]``.  Returns ``[N, 4|6]`` float32, the contract of
    :func:`fused_mlp_forward` fed ``integrated_pos_enc(double_angle=False)``.
    Forward only: the render paths' ``render_kernel_variant: ipe2``.
    """
    k = int(samples_per_ray)
    n = _check_rows(means, dirs, k, name="means", width=3)
    if tuple(covs.shape) != tuple(means.shape) or covs.device != means.device:
        raise ValueError(f"covs must be [{n}, 3] on {means.device}, got "
                         f"{tuple(covs.shape)} on {covs.device}")
    if means.device.type == "cpu":
        return fused_enc_mlp_reference(net, means, covs, dirs, k)

    _check_net(net, means.device)
    from ddnerf_tpu_torch.kernels import build

    dev, cdt = means.device, net.compute_dtype
    out = torch.empty((n, net.out_dim), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = build.load_library()
    kw = _packed(net)
    means32 = means.float().contiguous()
    covs32 = covs.float().contiguous()
    dirs_c = dirs.to(cdt).contiguous()
    dproj = torch.empty((n // k, DIR_HIDDEN), dtype=torch.float32, device=dev)
    hid = kernel_width(net.hidden_size)
    args = (means32.data_ptr(), covs32.data_ptr(), dirs_c.data_ptr(),
            _weights_ptr(kw, cdt), kw.b.data_ptr(), dproj.data_ptr(),
            out.data_ptr())
    tail = (*_offsets(kw), torch.cuda.current_stream(dev).cuda_stream)
    if is_wide(hid):
        f32 = int(cdt == torch.float32)
        ws = _wide_workspace(lib.ddnerf_wide_fwd_workspace(n, hid, f32, 0, 1),
                             dev)
        err = lib.ddnerf_wide_enc_fwd(*args, ws.data_ptr(), ws.numel(), n, k,
                                      hid, int(net.depth_head), f32, *tail)
    else:
        entry = (lib.ddnerf_fused_enc_mlp_fwd_f32 if cdt == torch.float32
                 else lib.ddnerf_fused_enc_mlp_fwd)
        err = entry(*args, n, k, hid, int(net.depth_head), *tail)
    build.check(lib, err, "fused_enc_mlp_fwd")
    _count("fused_enc_mlp_fwd", net)
    return out


def fused_mlp_backward(net, ipe: torch.Tensor, dirs: torch.Tensor,
                       g: torch.Tensor, samples_per_ray: int,
                       stash: Stash, per_ray_dirs: bool = False,
                       ) -> Dict[str, torch.Tensor]:
    """Parameter gradients of :func:`fused_mlp_forward` for the cotangent
    ``g [N, 4|6]``, from the ``stash`` of the same forward ->
    ``{parameter name: float32 gradient}`` in ``net.named_parameters()``
    order.  ``per_ray_dirs`` is ``parallel.kernel_per_ray_dirs``: where the
    dirs weight gradient rounds the dir layer's cotangent, per sample
    (False, the JAX package's default) or once per ray (True); see
    :func:`~ddnerf_tpu_torch.kernels.reference.fused_mlp_backward_reference`.
    Deterministic: the same inputs give bitwise the same gradients.
    The kernel's TMA tensor maps (weights, stash, workspace slabs) are
    encoded inside the C entry point at every call: the stash and the
    workspace are fresh storage each time, so no map outlives its call.
    Recorded into a CUDA graph, the maps and the addresses of ``gw``,
    ``gb``, the padded dirs, the float32 cotangent and the workspace are
    baked into the launch nodes; all of them, and the stash and the weight
    pack, are then storage of the graph's pool, which lives as long as the
    graph does.  What must stay alive and in place beside the graph is what
    it reads from outside its pool: the network's parameters.
    """
    k = int(samples_per_ray)
    n = _check_rows(ipe, dirs, k)
    hid = stash_width(net, ipe.device)
    if tuple(g.shape) != (n, net.out_dim):
        raise ValueError(f"g must be [{n}, {net.out_dim}], got "
                         f"{tuple(g.shape)}")
    if (tuple(stash.trunk.shape) != (NUM_STASH, n, hid)
            or tuple(stash.h.shape) != (n, net.dir_hidden)):
        raise ValueError(
            f"stash shapes {tuple(stash.trunk.shape)} / "
            f"{tuple(stash.h.shape)} do not match ({NUM_STASH}, {n}, {hid}) "
            f"/ ({n}, {net.dir_hidden}): pass the stash of the same forward")
    if ipe.device.type == "cpu":
        return fused_mlp_backward_reference(net, ipe, dirs, g, k, stash,
                                            per_ray_dirs)

    _check_net(net, ipe.device)
    for name, t in (("g", g), ("stash", stash.trunk), ("stash h", stash.h)):
        if t.device != ipe.device:
            raise ValueError(f"{name} on {t.device}, ipe on {ipe.device}")
    cdt = net.compute_dtype
    if stash.trunk.dtype != cdt or stash.h.dtype != cdt:
        raise ValueError(f"the stash must be {cdt} (the kernel forward's at "
                         "the network's compute dtype)")
    from ddnerf_tpu_torch.kernels import build

    dev, f32 = ipe.device, cdt == torch.float32
    lib = build.load_library()
    kw = _packed(net)
    gw = torch.empty(kw.w.numel(), dtype=torch.float32, device=dev)
    gb = torch.empty(kw.b.numel(), dtype=torch.float32, device=dev)
    if n == 0:
        return unpack_grads(net, kw, gw.zero_(), gb.zero_())
    ipe_c = _rows(ipe, cdt)
    if f32:  # [rays, 27] as they are
        dirs_p = dirs.float().contiguous()
    else:  # [rays, 32]: 27 features, zero padded for the bf16 kernel's loads
        dirs_p = torch.zeros((n // k, DIRS_LD), dtype=cdt, device=dev)
        dirs_p[:, :DIR_DIM] = dirs
    g32 = g.float().contiguous()
    trunk, h = stash.trunk.contiguous(), stash.h.contiguous()
    args = (ipe_c.data_ptr(), dirs_p.data_ptr(), g32.data_ptr(),
            trunk.data_ptr(), h.data_ptr(), _weights_ptr(kw, cdt),
            gw.data_ptr(), gb.data_ptr())
    tail = (*_offsets(kw), torch.cuda.current_stream(dev).cuda_stream)
    if is_wide(hid):
        ws = _wide_workspace(lib.ddnerf_wide_bwd_workspace(n, k, hid, int(f32)),
                             dev)
        err = lib.ddnerf_wide_bwd(*args, ws.data_ptr(), ws.numel(), n, k, hid,
                                  int(net.depth_head), int(per_ray_dirs),
                                  int(f32), *tail)
    else:
        ws_bytes = (lib.ddnerf_fused_mlp_bwd_workspace_f32 if f32
                    else lib.ddnerf_fused_mlp_bwd_workspace)(n, k, hid)
        ws = torch.empty(ws_bytes, dtype=torch.uint8, device=dev)
        entry = (lib.ddnerf_fused_mlp_bwd_f32 if f32
                 else lib.ddnerf_fused_mlp_bwd)
        err = entry(*args, ws.data_ptr(), ws_bytes, n, k, hid,
                    int(net.depth_head), int(per_ray_dirs), *tail)
    build.check(lib, err, "fused_mlp_bwd")
    _count("fused_mlp_bwd", net)
    return unpack_grads(net, kw, gw, gb)


class _FusedMLPTrain(torch.autograd.Function):
    """B1 in stash mode forward, B2 backward (``fused_mlp_train_apply``'s
    custom VJP, fused_mlp_bwd.py:539-568).  Saves the compute-dtype inputs
    and the stash; returns the B2 gradient of every parameter and ``None``
    for ipe and dirs, whose gradients are structurally zero: the IPE comes
    from detached fenceposts and the view directions are data."""

    @staticmethod
    def forward(ctx, net, ipe, dirs, samples_per_ray, per_ray_dirs, *params):
        out, stash = fused_mlp_forward(net, ipe, dirs, samples_per_ray,
                                       stash=True)
        ctx.net, ctx.samples_per_ray = net, samples_per_ray
        ctx.per_ray_dirs = per_ray_dirs
        ctx.save_for_backward(ipe, dirs, stash.trunk, stash.h)
        return out

    @staticmethod
    def backward(ctx, g):
        ipe, dirs, trunk, h = ctx.saved_tensors
        grads = fused_mlp_backward(ctx.net, ipe, dirs, g, ctx.samples_per_ray,
                                   Stash(trunk, h), ctx.per_ray_dirs)
        return (None, None, None, None, None, *grads.values())


def fused_mlp_train_apply(net, ipe: torch.Tensor, dirs: torch.Tensor,
                          samples_per_ray: int,
                          per_ray_dirs: bool = False) -> torch.Tensor:
    """The training forward of ``net`` on ray-major rows (as
    :func:`fused_mlp_forward`) whose backward is the B2 kernel (with
    ``per_ray_dirs`` as :func:`fused_mlp_backward`): gradients flow into
    ``net``'s parameters only.  The inputs are detached and cast to the
    compute dtype first, as the JAX pipeline's
    ``stop_gradient(ipe.astype(cdt))``."""
    cdt = net.compute_dtype
    return _FusedMLPTrain.apply(net, ipe.detach().to(cdt),
                                dirs.detach().to(cdt), int(samples_per_ray),
                                bool(per_ray_dirs),
                                *(p for _, p in _named_params(net)))
