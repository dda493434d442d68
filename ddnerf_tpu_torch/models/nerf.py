"""The coarse→fine DDNeRF render pipeline on torch tensors.

Counterpart of ``ddnerf_tpu/models/nerf.py`` (reference DDNerfModel,
models.py:207-322) for ``mode="render"``: stratified sample → cast to
frustum Gaussians → IPE → coarse DepthMipMLP → composite → truncated-
Gaussian resample → fine MipMLP → composite.  The train and validation
modes (dp loss, ``core/dd.py``), mip-NeRF and NDC come with later slices.

The networks run through the fused MLP kernel when ``parallel.pallas_mlp``
selects it for rendering (``render``, ``auto``, ``all`` — as
``_use_pallas`` does), else through the plain modules (``off`` / ``train``:
the user's explicit choice, as the JAX package's XLA path).  On a CPU the
kernel wrapper itself runs the plain version.  The JAX package's
probe-and-fallback ladder has no counterpart: a kernel that fails to build
or launch raises.

Config switches that only shape TPU programs are accepted and ignored:
``ipe_transposed``, ``raw_lane_inputs``, ``alpha_vpu``,
``render_block_rows``, ``fetch_dtype``, ``fetch_precision``,
``skip_resampler_sort`` (the resampler's sort is the identity and is never
run here), and the other layout / compiler knobs of ``ParallelConfig``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional

import torch

from ddnerf_tpu_torch.config import Config
from ddnerf_tpu_torch.core import math as mmath
from ddnerf_tpu_torch.core import rendering, sampling
from ddnerf_tpu_torch.kernels.fused_mlp import fused_mlp_forward
from ddnerf_tpu_torch.models.mlp import DepthMipMLP, MipMLP

_KERNEL_POLICIES = ("render", "auto", "all")
_POLICIES = ("off", "train") + _KERNEL_POLICIES
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class RayBatch:
    """A bundle of rays (the reference's packed ``[ro, rd, radius, near,
    far, viewdirs]`` layout, models.py:144-162)."""

    origins: torch.Tensor  # [N, 3]
    directions: torch.Tensor  # [N, 3]
    radii: torch.Tensor  # [N, 1]
    viewdirs: torch.Tensor  # [N, 3]
    near: torch.Tensor  # [N, 1]
    far: torch.Tensor  # [N, 1]

    @classmethod
    def create(cls, origins, directions, radii, near: float, far: float):
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
        )


class ScheduleValues(NamedTuple):
    """The annealed values the resampler reads (train_model.py:121-142)."""

    gaussian_smooth_factor: float
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
    :meth:`load_state_dicts`.
    """

    def __init__(self, cfg: Config, device="cpu", seed: int = 0):
        if not cfg.is_ddnerf():
            raise NotImplementedError(
                f"nerf.type={cfg.nerf.type!r}: the port renders DDNerfModel; "
                "mip-NeRF comes with a later slice")
        par = cfg.parallel
        policy = "all" if par.use_pallas_mlp else par.pallas_mlp
        if policy not in _POLICIES:
            raise ValueError(f"parallel.pallas_mlp={policy!r}: expected one "
                             f"of {' | '.join(_POLICIES)}")
        if par.compute_dtype not in _DTYPES:
            raise ValueError(f"parallel.compute_dtype={par.compute_dtype!r}: "
                             f"expected {' | '.join(_DTYPES)}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.use_kernel = policy in _KERNEL_POLICIES
        cdt = _DTYPES[par.compute_dtype]
        if self.device.type == "cuda":
            # The plain float32 matmuls (models/mlp.py) must not use TF32.
            torch.backends.cuda.matmul.allow_tf32 = False
            if self.use_kernel and cdt != torch.bfloat16:
                raise ValueError(
                    f"parallel.pallas_mlp={policy!r} runs the bf16 fused MLP "
                    f"kernel on {self.device}, but parallel.compute_dtype="
                    f"{par.compute_dtype!r}; set pallas_mlp: off for "
                    "float32 compute")
        gen = torch.Generator().manual_seed(seed)
        self.coarse = DepthMipMLP(hidden_size=cfg.nerf.coarse_hidden_size,
                                  compute_dtype=cdt, generator=gen)
        self.fine = MipMLP(hidden_size=cfg.nerf.fine_hidden_size,
                           compute_dtype=cdt, generator=gen)
        self.coarse.to(self.device).eval()
        self.fine.to(self.device).eval()
        ds = cfg.dataset
        self._eps_mask_pdf = (ds.type.lower() == "blender"
                              or ds.basedir.endswith("segmented"))

    def load_state_dicts(self, coarse: Dict[str, torch.Tensor],
                         fine: Dict[str, torch.Tensor]) -> None:
        self.coarse.load_state_dict(coarse)
        self.fine.load_state_dict(fine)

    # --------------------------------------------------------------- network

    def _run_network(self, net, rays: RayBatch, t_vals) -> torch.Tensor:
        """cast_rays → IPE → viewdir PE → MLP: ``[N, S, 4|6]``."""
        means, covs = mmath.cast_rays(t_vals, rays.origins, rays.directions,
                                      rays.radii, self.cfg.nerf.ray_shape)
        ipe = mmath.integrated_pos_enc(
            (means, covs), double_angle=self.cfg.parallel.ipe_double_angle)
        dirs = mmath.positional_encoding(rays.viewdirs, num_freqs=4)
        if not self.use_kernel:
            return net(ipe, dirs)
        n, s = means.shape[0], means.shape[1]
        flat = fused_mlp_forward(net, ipe.reshape(n * s, -1), dirs,
                                 samples_per_ray=s)
        return flat.reshape(n, s, -1)

    # ---------------------------------------------------------------- render

    @torch.inference_mode()
    def render_rays(self, rays: RayBatch, sched: ScheduleValues,
                    mode: str = "render",
                    generator: Optional[torch.Generator] = None,
                    ) -> Dict[int, Dict[str, torch.Tensor]]:
        """Full coarse→fine pass -> ``{0: coarse maps, 1: fine maps}``
        (the reference's ``ret_dict``, models.py:297).  ``generator`` draws
        the stratified jitter (``perturb``) and the density noise
        (``radiance_field_noise_std``); without one there is no noise, as the
        JAX package without an rng key, and ``perturb`` is an error."""
        if mode != "render":
            raise NotImplementedError(
                f"mode={mode!r}: the port renders (mode='render'); train and "
                "validation modes come with the training slice")
        cfg = self.cfg
        mc = cfg.nerf.validation
        ds = cfg.dataset
        if mc.perturb and generator is None:
            raise ValueError("nerf.validation.perturb draws stratified "
                             "jitter: pass a torch.Generator")
        composite_kw = dict(
            generator=generator, noise_std=mc.radiance_field_noise_std,
            white_background=mc.white_background,
            eps_mask_pdf=self._eps_mask_pdf)

        t0 = sampling.sample_first_cycle(
            rays.near, rays.far, mc.num_coarse, lindisp=mc.lindisp,
            perturb=mc.perturb,
            combined=ds.combined_sampling_method, combined_near=ds.near,
            combined_split=ds.combined_split, generator=generator)
        raw0 = self._run_network(self.coarse, rays, t0)  # [N, S, 6]
        mus = torch.sigmoid(raw0[..., 4])
        sigmas = torch.sigmoid(raw0[..., 5]) + 0.001
        out0 = rendering.volume_render(raw0[..., :3], raw0[..., 3], t0,
                                       rays.directions, mus=mus,
                                       **composite_kw)

        smoothed_sigmas = sigmas * sched.gaussian_smooth_factor
        s_left_tail, s_part_inside = mmath.truncated_gaussian_tails(
            mus, smoothed_sigmas)
        t1 = sampling.sample_pdf_with_mu_sigma(
            t0, out0.weights, mus, smoothed_sigmas, s_part_inside,
            s_left_tail, mc.num_fine + 1, near=ds.near, far=ds.far,
            pdf_padding=sched.pdf_padding,
            det=not mc.perturb,
            generator=generator)
        raw1 = self._run_network(self.fine, rays, t1)  # [N, M, 4]
        out1 = rendering.volume_render(raw1[..., :3], raw1[..., 3], t1,
                                       rays.directions, **composite_kw)
        return {
            0: {"rgb": out0.rgb, "disp": out0.disp, "acc": out0.acc,
                "weights": out0.weights, "depth": out0.depth,
                "corrected_disp_map": out0.corrected_disp, "t_vals": t0},
            1: {"rgb": out1.rgb, "disp": out1.disp, "acc": out1.acc,
                "weights": out1.weights, "depth": out1.depth, "t_vals": t1},
        }
