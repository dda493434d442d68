"""The coarse→fine pipelines on torch tensors: DDNeRF and mip-NeRF.

Counterpart of ``ddnerf_tpu/models/nerf.py``.  ``nerf.type: DDNerfModel``
(reference models.py:207-322) is ``_render_dd`` in its three modes:
stratified sample → cast to frustum Gaussians → IPE → coarse DepthMipMLP →
composite → truncated-Gaussian resample → fine MipMLP → composite, and in
``train`` / ``validation`` the μ/σ regularizers and the depth-prediction
loss (``core/dd.py``).  ``nerf.type: GeneralMipNerfModel`` (reference
models.py:75-114) is ``_render_mipnerf``: ONE shared MipMLP evaluated in
both cycles, with the plain inverse-CDF resampler
(``core/sampling.py::sample_pdf``) between them and no depth head, so no
dp loss and no μ/σ maps.  Rays arrive as the caller made them: world-space
or NDC-projected (``render/renderer.py``, ``data/datasets.py``).

Random draws come from one ``torch.Generator`` in a fixed order, the order
of the JAX package's four split keys: the stratified jitter, the density
noise of cycle 0, the resampler's jitter, the density noise of cycle 1.

The networks run through the fused MLP kernels as ``parallel.pallas_mlp``
selects, per direction:

* ``mode="train"``: the stash forward + fused backward
  (:func:`~ddnerf_tpu_torch.kernels.fused_mlp.fused_mlp_train_apply`)
  under ``train``, ``auto`` and ``all``; the plain module with autograd
  under ``off`` and ``render``, as the JAX package's XLA path;
* ``mode="validation"`` / ``"render"``: under ``render``, ``auto`` and
  ``all`` (as ``_use_pallas``) the forward kernel that
  ``parallel.render_kernel_variant`` selects: ``mlp``, the render-mode
  forward fed IPE rows; ``ipe2``, the forward that
  computes the direct-form IPE itself from raw means and covariances
  (:func:`~ddnerf_tpu_torch.kernels.fused_mlp.fused_enc_mlp_forward`,
  forward only, so training never takes it).  Else the plain module.

Where a kernel is fed IPE rows (the training kernels, and ``mlp``), one
launch of the encode kernel (``kernels/encode.py``) makes them and the
view-direction rows from the fenceposts and the rays, in the compute
dtype.  The plain module takes that kernel's plain version, the
composition of ``core/math.py``'s functions; ``ipe2`` takes the means,
covariances and dirs rows from ``core/math.py``.

``render_kernel_variant`` (``mlp | ipe2``) and ``ipe_variant`` (``stack |
fused``, and ``fused`` not with ``ipe_transposed``) are checked at
construction with the JAX package's errors; ``ipe_variant`` otherwise
only shapes TPU programs and is ignored.

On a CPU each kernel wrapper itself runs its plain version.  The JAX
package's probe-and-fallback ladder has no counterpart: a kernel that fails
to build or launch raises.

Both kernel directions take the view directions once per ray, whatever
``parallel.kernel_per_ray_dirs`` says; the switch sets where the training
backward rounds the dirs weight gradient's cotangent, as in the JAX
package, where it is not bit-neutral (fused_mlp_bwd.py:236-248): ``false``
(the default) rounds each sample's dir-layer cotangent to bf16 before the
sum over the ray, ``true`` rounds the per-ray sum once.  Under
``parallel.compute_dtype: float32`` the kernels are their float32
counterparts, which round nothing, and the two settings are the same sum.
``parallel.bwd_block_rows`` (a TPU block size) is accepted and ignored.

Any ``coarse_hidden_size`` / ``fine_hidden_size`` runs through the
kernels, each network at its own width: up to 512 through the fused plans
(their widths and the zero padding between them:
``kernels/fused_mlp.py::KERNEL_WIDTHS``), above it through the wide plan
(``csrc/fused_mlp_wide.cu``, the width padded to a multiple of 64), as the
JAX kernels take any width.

Config switches that only shape TPU programs are accepted and ignored:
``ipe_transposed``, ``raw_lane_inputs``, ``alpha_vpu``, ``split_h_stash``,
``kernel_stash_acts`` (the port always stashes), ``render_block_rows``,
``ipe_variant`` (once checked), ``fetch_dtype``, ``fetch_precision``,
``skip_resampler_sort`` (the resampler's sort is the identity and is
never run here), and the other layout / compiler knobs of
``ParallelConfig``.  ``num_devices`` and ``data_axis`` are not among them:
they are the data-parallel group's (``parallel/mesh.py``), and a pipeline
made with that group's ``mesh`` takes the dp loss over the global batch in
its training renders.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.core import math as mmath
from ddnerf_tpu_torch.core import dd, rendering, sampling
from ddnerf_tpu_torch.kernels.encode import ipe_encode, ipe_encode_reference
from ddnerf_tpu_torch.kernels.fused_mlp import (
    fused_enc_mlp_forward,
    fused_mlp_forward,
    fused_mlp_train_apply,
)
from ddnerf_tpu_torch.models.mlp import DepthMipMLP, MipMLP
from ddnerf_tpu_torch.utils.profiling import span

_KERNEL_POLICIES = ("render", "auto", "all")  # forward kernel: eval paths
_TRAIN_KERNEL_POLICIES = ("train", "auto", "all")  # stash fwd + bwd kernels
_POLICIES = ("off", "train", "render", "auto", "all")
_MODES = ("train", "validation", "render")
_RENDER_VARIANTS = ("mlp", "ipe2")
_IPE_VARIANTS = ("stack", "fused")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class RayBatch:
    """A bundle of rays (the reference's packed ``[ro, rd, radius, near,
    far, viewdirs]`` layout, models.py:144-162).  ``rows``: where the
    bundle is one rank's share of a sharded render's chunk, which rows of
    the chunk it holds (``core/draws.py``); None otherwise."""

    origins: torch.Tensor  # [N, 3]
    directions: torch.Tensor  # [N, 3]
    radii: torch.Tensor  # [N, 1]
    viewdirs: torch.Tensor  # [N, 3]
    near: torch.Tensor  # [N, 1]
    far: torch.Tensor  # [N, 1]
    rows: Optional[Tuple[int, int, int]] = None

    @classmethod
    def create(cls, origins, directions, radii, near: float, far: float,
               rows: Optional[Tuple[int, int, int]] = None):
        origins = origins.reshape(-1, 3)
        directions = directions.reshape(-1, 3)
        ones = torch.ones_like(directions[:, :1])
        return cls(
            origins=origins,
            directions=directions,
            radii=radii.reshape(-1, 1),
            viewdirs=directions / torch.linalg.norm(directions, dim=-1,
                                                    keepdim=True),
            near=near * ones,
            far=far * ones,
            rows=rows,
        )


class ScheduleValues(NamedTuple):
    """The annealed values the resampler reads (train_model.py:121-142).
    ``gaussian_smooth_factor`` is a Python float, or a 0-d device tensor
    where the step is a captured graph that must read it at every replay;
    ``pdf_padding`` is a Python branch of the resampler."""

    gaussian_smooth_factor: Union[float, torch.Tensor]
    pdf_padding: bool

    @classmethod
    def for_eval(cls, cfg: Config) -> "ScheduleValues":
        """Eval-time fixup (eval_nerf.py:53-55): padding off and the final
        smoothing only if training passed the flip."""
        tp = cfg.train_params
        passed_flip = tp.max_pdf_pad_iters < cfg.experiment.train_iters
        return cls(
            gaussian_smooth_factor=float(
                tp.final_smooth if passed_flip else tp.gaussian_smooth_factor),
            pdf_padding=bool(tp.pdf_padding and not passed_flip),
        )


class NerfPipeline:
    """The coarse and fine networks on ``device`` plus the render functions.

    Weights are drawn from ``torch.Generator().manual_seed(seed)`` (torch's
    ``nn.Linear`` init) unless a checkpoint is loaded with
    :meth:`load_state_dicts`.  ``mesh``: the data-parallel group this
    pipeline's rank belongs to (``parallel/mesh.py``), or None; the train
    step and the renderer read it from here.
    """

    def __init__(self, cfg: Config, device="cpu", seed: int = 0, mesh=None):
        par = cfg.parallel
        # The render selectors, checked as ddnerf_tpu/models/nerf.py:137-156.
        if par.render_kernel_variant not in _RENDER_VARIANTS:
            raise ValueError(
                f"parallel.render_kernel_variant="
                f"{par.render_kernel_variant!r}: expected mlp | ipe2 (the "
                "'ipe' fused_ipe_mlp kernel was retired in the JAX package)")
        if par.ipe_variant not in _IPE_VARIANTS:
            raise ValueError(f"parallel.ipe_variant={par.ipe_variant!r}: "
                             "expected stack | fused")
        if par.ipe_variant == "fused" and par.ipe_transposed:
            raise ValueError(
                "parallel.ipe_variant='fused' measures the row-major "
                "assembly and is unreachable under ipe_transposed=true; set "
                "ipe_transposed: false for that A/B")
        policy = "all" if par.use_pallas_mlp else par.pallas_mlp
        if policy not in _POLICIES:
            raise ValueError(f"parallel.pallas_mlp={policy!r}: expected one "
                             f"of {' | '.join(_POLICIES)}")
        if par.compute_dtype not in _DTYPES:
            raise ValueError(f"parallel.compute_dtype={par.compute_dtype!r}: "
                             f"expected {' | '.join(_DTYPES)}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = mesh
        self.use_kernel = policy in _KERNEL_POLICIES
        self.use_train_kernel = policy in _TRAIN_KERNEL_POLICIES
        self.render_variant = par.render_kernel_variant
        cdt = _DTYPES[par.compute_dtype]
        if self.device.type == "cuda":
            # The plain float32 matmuls (models/mlp.py) must not use TF32
            # (the float32 kernels do not read this flag).
            torch.backends.cuda.matmul.allow_tf32 = False
        gen = torch.Generator().manual_seed(seed)
        # Static for the life of the pipeline (ddnerf_tpu/models/nerf.py:
        # 164-175): DDNeRF has a coarse net with the depth head and a fine
        # net; mip-NeRF one net for both cycles (models.py:28).
        self.shared_net = not cfg.is_ddnerf()
        if self.shared_net:
            self.coarse = MipMLP(hidden_size=cfg.nerf.coarse_hidden_size,
                                 compute_dtype=cdt, generator=gen)
            self.fine = None
        else:
            self.coarse = DepthMipMLP(hidden_size=cfg.nerf.coarse_hidden_size,
                                      compute_dtype=cdt, generator=gen)
            self.fine = MipMLP(hidden_size=cfg.nerf.fine_hidden_size,
                               compute_dtype=cdt, generator=gen)
        for net in self.networks():
            net.to(self.device).eval()
        ds = cfg.dataset
        self._eps_mask_pdf = (ds.type.lower() == "blender"
                              or ds.basedir.endswith("segmented"))
        self._filter_empty = ds.type.lower() == "blender"

    def networks(self):
        """The pipeline's networks, coarse first: two for DDNeRF, the one
        shared net for mip-NeRF."""
        return [self.coarse] if self.shared_net else [self.coarse, self.fine]

    def load_state_dicts(self, coarse: Dict[str, torch.Tensor],
                         fine: Optional[Dict[str, torch.Tensor]] = None,
                         ) -> None:
        """Load the networks' weights (a checkpoint's ``model_1_state_dict``
        and ``model_2_state_dict``).  mip-NeRF has one network and takes no
        ``fine``; DDNeRF needs both."""
        if self.shared_net != (fine is None):
            held = ("model_1_state_dict only" if fine is None else
                    "model_1_state_dict and model_2_state_dict")
            want = ("one shared network (model_1_state_dict only)"
                    if self.shared_net else
                    "two networks (model_1_state_dict and model_2_state_dict)")
            raise ValueError(
                f"nerf.type={self.cfg.nerf.type!r} has {want}, but the "
                f"weights given hold {held}")
        self.coarse.load_state_dict(coarse)
        if fine is not None:
            self.fine.load_state_dict(fine)

    def parameters(self):
        """Every parameter once, coarse net first."""
        return [p for net in self.networks() for p in net.parameters()]

    # --------------------------------------------------------------- network

    def _run_network(self, net, rays: RayBatch, t_vals,
                     mode: str) -> torch.Tensor:
        """cast_rays → IPE → viewdir PE → MLP: ``[N, S, 4|6]``.  The span
        ``ddnerf.pipeline.encode`` holds what comes before the network: on
        the kernel paths fed IPE rows, one launch of the encode kernel
        (:func:`~ddnerf_tpu_torch.kernels.encode.ipe_encode`, rows in the
        compute dtype); ``ipe2`` the means, covariances and dirs rows its
        kernel reads; the plain network the kernel's plain version
        (:func:`~ddnerf_tpu_torch.kernels.encode.ipe_encode_reference`, f32).
        ``ddnerf.pipeline.mlp`` holds the kernel or the plain network."""
        kernel = self.use_train_kernel if mode == "train" else self.use_kernel
        # ipe2: the IPE is computed inside the kernel (JAX
        # models/nerf.py:677-703).
        in_kernel_ipe = (mode != "train" and self.use_kernel
                         and self.render_variant == "ipe2")
        n, s = t_vals.shape[0], t_vals.shape[-1] - 1
        encode_args = (t_vals, rays.origins, rays.directions, rays.radii,
                       rays.viewdirs, self.cfg.nerf.ray_shape,
                       self.cfg.parallel.ipe_double_angle)
        with span("ddnerf.pipeline.encode"):
            if in_kernel_ipe:
                means, covs = mmath.cast_rays(t_vals, rays.origins,
                                              rays.directions, rays.radii,
                                              self.cfg.nerf.ray_shape)
                dirs = mmath.positional_encoding(rays.viewdirs, num_freqs=4)
            elif kernel:
                ipe, dirs = ipe_encode(*encode_args, net.compute_dtype)
            else:
                ipe, dirs = ipe_encode_reference(*encode_args)
        with span("ddnerf.pipeline.mlp"):
            if in_kernel_ipe:
                flat = fused_enc_mlp_forward(net, means.reshape(n * s, 3),
                                             covs.reshape(n * s, 3), dirs, s)
            elif not kernel:
                return net(ipe.reshape(n, s, -1), dirs)
            elif mode == "train":
                flat = fused_mlp_train_apply(
                    net, ipe, dirs, s, self.cfg.parallel.kernel_per_ray_dirs)
            else:
                flat = fused_mlp_forward(net, ipe, dirs, s)
        return flat.reshape(n, s, -1)

    # ---------------------------------------------------------------- render

    def render_rays(self, rays: RayBatch, sched: ScheduleValues,
                    mode: str = "render",
                    generator: Optional[torch.Generator] = None,
                    ) -> Dict[int, Dict[str, torch.Tensor]]:
        """Full coarse→fine pass -> ``{0: coarse maps, 1: fine maps}``
        (the reference's ``ret_dict``, models.py:297).  ``generator`` draws
        the stratified jitter (``perturb``) and the density noise
        (``radiance_field_noise_std``); without one there is no noise, as the
        JAX package without an rng key, and ``perturb`` is an error.

        ``mode="train"`` builds the autograd graph into the networks and,
        for DDNeRF, adds the dp loss and the μ/σ regularizers;
        ``"validation"`` adds them too, without a graph; ``"render"``
        returns the maps only.  mip-NeRF returns the same maps in every
        mode."""
        if mode not in _MODES:
            raise ValueError(f"mode={mode!r}: expected one of "
                             f"{' | '.join(_MODES)}")
        render = self._render_mipnerf if self.shared_net else self._render_dd
        if mode == "train":
            return render(rays, sched, mode, generator)
        with torch.inference_mode():
            return render(rays, sched, mode, generator)

    def _check_generator(self, mc, mode: str, generator) -> None:
        if mc.perturb and generator is None:
            raise ValueError(f"nerf.{'train' if mode == 'train' else 'validation'}"
                             ".perturb draws stratified jitter: pass a "
                             "torch.Generator")

    def _first_cycle_tvals(self, rays: RayBatch, mc, generator):
        ds = self.cfg.dataset
        with span("ddnerf.pipeline.sample"):
            return sampling.sample_first_cycle(
                rays.near, rays.far, mc.num_coarse, lindisp=mc.lindisp,
                perturb=mc.perturb,
                combined=ds.combined_sampling_method, combined_near=ds.near,
                combined_split=ds.combined_split, generator=generator,
                rows=rays.rows)

    def _render_mipnerf(self, rays: RayBatch, sched: ScheduleValues,
                        mode: str, generator: Optional[torch.Generator]):
        """GeneralMipNerfModel.predict (models.py:75-114), JAX
        ``_render_mipnerf`` (models/nerf.py:769-813): the shared net in both
        cycles, the plain inverse-CDF resampler between them.  In ``train``
        mode the net appears twice in one autograd graph, and autograd sums
        the two backward results on each parameter."""
        cfg = self.cfg
        mc = cfg.nerf.mode(mode)
        self._check_generator(mc, mode, generator)
        ret: Dict[int, Dict[str, torch.Tensor]] = {}
        t_vals = self._first_cycle_tvals(rays, mc, generator)
        for i in range(2):
            if i == 1:
                # Without a graph: detached, as stop_gradient in JAX.
                with span("ddnerf.pipeline.resample"):
                    t_vals = sampling.sample_pdf(
                        t_vals, ret[0]["weights"], mc.num_fine + 1,
                        pdf_padding=sched.pdf_padding, det=not mc.perturb,
                        generator=generator, rows=rays.rows)
            raw = self._run_network(self.coarse, rays, t_vals, mode)
            with span("ddnerf.pipeline.composite"):
                out = rendering.volume_render(
                    raw[..., :3], raw[..., 3], t_vals, rays.directions,
                    generator=generator, noise_std=mc.radiance_field_noise_std,
                    white_background=mc.white_background,
                    eps_mask_pdf=self._eps_mask_pdf,
                    analytic_weights_vjp=cfg.parallel.composite_custom_vjp,
                    rows=rays.rows)
            ret[i] = {"rgb": out.rgb, "disp": out.disp, "acc": out.acc,
                      "weights": out.weights, "depth": out.depth,
                      "t_vals": t_vals}
        return ret

    def _render_dd(self, rays: RayBatch, sched: ScheduleValues, mode: str,
                   generator: Optional[torch.Generator]):
        """DDNerfModel.predict (models.py:207-322), JAX ``_render_dd``
        (models/nerf.py:815-952)."""
        cfg = self.cfg
        mc = cfg.nerf.mode(mode)
        tp = cfg.train_params
        ds = cfg.dataset
        self._check_generator(mc, mode, generator)
        composite_kw = dict(
            generator=generator, noise_std=mc.radiance_field_noise_std,
            white_background=mc.white_background,
            eps_mask_pdf=self._eps_mask_pdf,
            analytic_weights_vjp=cfg.parallel.composite_custom_vjp,
            rows=rays.rows)

        # ---- cycle 0: coarse with the depth-distribution head
        t0 = self._first_cycle_tvals(rays, mc, generator)
        raw0 = self._run_network(self.coarse, rays, t0, mode)  # [N, S, 6]
        raw_mus, raw_sigmas = raw0[..., 4], raw0[..., 5]
        with span("ddnerf.pipeline.composite"):
            mus = torch.sigmoid(raw_mus)
            sigmas = torch.sigmoid(raw_sigmas) + 0.001
            out0 = rendering.volume_render(raw0[..., :3], raw0[..., 3], t0,
                                           rays.directions, mus=mus,
                                           **composite_kw)

        with span("ddnerf.pipeline.resample"):
            # Smooth the in-cell distribution before resampling
            # (models.py:266-273)
            smoothed_sigmas = sigmas * sched.gaussian_smooth_factor
            s_left_tail, s_part_inside = mmath.truncated_gaussian_tails(
                mus, smoothed_sigmas)

            # ---- cycle 1: fine.  The resampler runs without a graph: t1 is
            # detached, as stop_gradient(t1) in JAX (models/nerf.py:879).
            t1 = sampling.sample_pdf_with_mu_sigma(
                t0, out0.weights, mus, smoothed_sigmas, s_part_inside,
                s_left_tail, mc.num_fine + 1, near=ds.near, far=ds.far,
                pdf_padding=sched.pdf_padding,
                det=not mc.perturb,
                generator=generator, rows=rays.rows)
        raw1 = self._run_network(self.fine, rays, t1, mode)  # [N, M, 4]
        with span("ddnerf.pipeline.composite"):
            out1 = rendering.volume_render(raw1[..., :3], raw1[..., 3], t1,
                                           rays.directions, **composite_kw)
        ret0 = {"rgb": out0.rgb, "disp": out0.disp, "acc": out0.acc,
                "weights": out0.weights, "depth": out0.depth,
                "corrected_disp_map": out0.corrected_disp, "t_vals": t0}
        ret1 = {"rgb": out1.rgb, "disp": out1.disp, "acc": out1.acc,
                "weights": out1.weights, "depth": out1.depth, "t_vals": t1}
        if mode == "render":
            return {0: ret0, 1: ret1}

        with span("ddnerf.pipeline.dp_loss"):
            # L2 regularizers on the raw heads (models.py:248-252): per-ray sums
            # averaged over rays.
            n_rays = raw_mus.shape[0]
            sig_loss = torch.sum(raw_sigmas ** 2) / n_rays
            mus_loss = torch.sum(raw_mus ** 2) / n_rays
            mus_reg = tp.dist_reg_coeficient * mus_loss
            sig_reg = tp.dist_reg_coeficient * sig_loss
            left_tail, part_inside = mmath.truncated_gaussian_tails(mus, sigmas)

            # ---- depth-prediction loss (models.py:284-289), with the JAX
            # pipeline's stop-gradients (models/nerf.py:910-925).
            dp = dd.estimate_dp_loss(
                t1, t0.detach(), out1.weights.detach(), out0.weights, mus, sigmas,
                left_tail.detach(), part_inside.detach(),
                filter_empty_rays=self._filter_empty,
                variant=tp.dp_loss_variant,
                mesh=self.mesh if mode == "train" else None,
            ) * (t1.shape[-1] - 1)
            ret1["dp_loss"] = dp + mus_reg + sig_reg
        ret0.update(mus=mus, sigmas=sigmas, smoothed_sigmas=smoothed_sigmas,
                    mus_loss=mus_loss, sig_loss=sig_loss, mus_reg=mus_reg,
                    sig_reg=sig_reg)
        return {0: ret0, 1: ret1}
