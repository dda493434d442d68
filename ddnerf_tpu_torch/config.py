"""Configuration of the port: the YAML schema of ``configs/*.yml`` as a tree
of frozen dataclasses.

Counterpart of ``ddnerf_tpu/config.py``, kept as the port's own copy with
the same classes, fields and defaults, so one YAML file (or one logdir's
``config.yml`` snapshot) means the same thing to both packages.  The
reference implementation mutates a YACS-style ``CfgNode`` at run time
(annealed ``gaussian_smooth_factor``, the ``pdf_padding`` flip, the
automatic ``dist_reg_coeficient``, the pose-normalization rescale of
near/far); here the config is immutable and those quantities are pure
schedules of the step (:mod:`ddnerf_tpu_torch.core.schedules`).

``Config.from_yaml`` accepts the reference YAML layout verbatim, including
the keys the reference reads through ``try/except`` defaults.  The
``parallel:`` block carries switches that select code paths of the JAX
package on a TPU; the port accepts all of them, reads the few that have a
meaning on a GPU and ignores the rest (see :class:`ParallelConfig`).
"""

from __future__ import annotations

import io
from dataclasses import dataclass, field, fields, is_dataclass, replace
from typing import Any, Optional, Tuple

import yaml


def _get(d: dict, key: str, default):
    if d is None:
        return default
    v = d.get(key, default)
    return default if v is None and default is not None else v


@dataclass(frozen=True)
class ExperimentConfig:
    """Reference: ``experiment:`` block (config_blender.yml:2-16)."""

    id: str = "experiment"
    logdir: str = "logs"
    randomseed: int = 42
    train_iters: int = 200001
    validate_every: int = 2000
    save_every: int = 2000
    print_every: int = 200
    # Checkpoint retention.  1 = the reference's single rolling checkpoint
    # (train_model.py:248-263); larger keeps history so eval/video can select
    # a specific step (eval_nerf.py:173-178).
    max_keep_ckpts: int = 1
    # Train-scalar density in metrics.jsonl.  0 = one point per
    # ``print_every``; N >= 1 = a point every N iterations.  Default 1 = the
    # reference's every-iteration train curves (documentation.py:11-26).
    train_scalars_every: int = 1


@dataclass(frozen=True)
class TrainParamsConfig:
    """Reference: ``train_params:`` block (config_blender.yml:18-30).

    ``pdf_padding``/``gaussian_smooth_factor`` are *initial* values here; their
    per-step evolution lives in :mod:`ddnerf_tpu_torch.core.schedules`.
    """

    pdf_padding: bool = True
    max_pdf_pad_iters: int = 20000
    gaussian_smooth_factor: float = 1.7
    final_smooth: float = 1.1
    finnish_smooth: int = 150000
    depth_analysis_rays: bool = False
    depth_analysis_path: str = ""
    dist_reg_coeficient: float = 0.02
    set_automatic_dist_reg_coeficient: bool = True
    loss_coeficients: Tuple[float, ...] = (1.0, 1.0)
    dp_coeficient: float = 0.1
    # "kl" (the reference's active dd_utils loss) or "js" (the Jensen-Shannon
    # form from its experimental loss.py v6 ``mse`` branch).
    dp_loss_variant: str = "kl"


@dataclass(frozen=True)
class DatasetConfig:
    """Reference: ``dataset:`` block (config_blender.yml:32-62)."""

    type: str = "blender"
    basedir: str = ""
    single_image_mode: bool = True
    ndc_rays: bool = False
    near: float = 2.0
    far: float = 6.0
    combined_sampling_method: bool = False
    combined_split: float = 2.0
    downsample_factor: int = 4
    spherify: bool = False
    normalize_poses: bool = False
    normalize_factor: float = 5.0
    bd_factor: Optional[float] = None
    llffhold: int = 8
    half_res: bool = False
    testskip: int = 1
    # extension: procedurally generated scene for tests and smoke runs.
    synthetic: bool = False
    # Reference quirk fix (off = reference parity): the reference un-warps a
    # validation image's NDC depth through the NEXT image's camera (it reads
    # the round-robin index after the advance, dataset.py:137-154).  True
    # un-warps through the pose of the image actually rendered.
    fix_validation_unwarp_rays: bool = False


@dataclass(frozen=True)
class OptimizerConfig:
    """Reference: ``optimizer:`` + ``scheduler:`` blocks. The reference ignores
    its own ``scheduler`` block and hardcodes the mip-NeRF log-lerp schedule
    (train_model.py:101-107); we expose those knobs explicitly."""

    type: str = "adam"
    lr: float = 1.0e-3
    lr_init: float = 5.0e-4
    lr_final: float = 5.0e-6
    lr_delay_steps: int = 2500
    lr_delay_mult: float = 0.01


@dataclass(frozen=True)
class NerfModeConfig:
    """Reference: ``nerf.train`` / ``nerf.validation`` blocks
    (config_blender.yml:85-124)."""

    num_random_rays: int = 2048
    chunksize: int = 16384
    perturb: bool = True
    num_coarse: int = 32
    num_fine: int = 32
    white_background: bool = False
    radiance_field_noise_std: float = 1.0
    lindisp: bool = False


@dataclass(frozen=True)
class NerfConfig:
    """Reference: ``nerf:`` block (config_blender.yml:76-124)."""

    type: str = "DDNerfModel"  # or "GeneralMipNerfModel"
    coarse_hidden_size: int = 256
    fine_hidden_size: int = 256
    ray_shape: str = "cone"
    train: NerfModeConfig = field(default_factory=NerfModeConfig)
    validation: NerfModeConfig = field(
        default_factory=lambda: NerfModeConfig(perturb=False)
    )

    def mode(self, mode: str) -> NerfModeConfig:
        return self.train if mode == "train" else self.validation


@dataclass(frozen=True)
class ParallelConfig:
    """Execution switches (no reference equivalent).  Every field of the JAX
    package's ``parallel:`` block is accepted so that its configs and
    snapshots load unchanged; the port reads the first group and ignores the
    second, which selects TPU layouts, block sizes and compiler options."""

    # ---- read by the port
    # precision policy of the MLP evaluation: "float32" | "bfloat16"
    compute_dtype: str = "float32"
    # Fused MLP kernels: "off" | "render" | "train" | "auto" | "all".
    # "train" = stash forward + fused backward for training steps, "render"
    # = the forward kernel (see render_kernel_variant) on the whole-image
    # validation / eval / video paths, "auto" = both, "all" = the same as
    # "auto" on a GPU.  A kernel that fails to build or launch raises.
    pallas_mlp: str = "off"
    # legacy bool alias for pallas_mlp ("all" when True)
    use_pallas_mlp: bool = False
    # Split each train batch into microbatches of this many rays with
    # gradient accumulation; 0 = no microbatching.
    microbatch_rays: int = 0
    # Budget of one rank's share of the device-resident ray store; a larger
    # share stays on the host and is sampled there.
    max_store_gb: float = 6.0
    # Which forward kernel renders: "mlp" = the IPE assembled in torch, then
    # the fused MLP forward; "ipe2" = the forward that computes the IPE
    # itself from raw [N, 3] means and covariances.  "ipe" is retired.
    render_kernel_variant: str = "mlp"
    # IPE sin/cos via the double-angle recurrence (core/math.py).
    ipe_double_angle: bool = True
    # Assembly of the kernel-path IPE: "stack" | "fused" (direct form).
    ipe_variant: str = "stack"
    # Hand-derived adjoint for the compositing weights (one reverse cumsum
    # instead of autodiff through the exclusive-cumprod chain).
    composite_custom_vjp: bool = True
    # The data-parallel group (parallel/mesh.py): data_axis names its one
    # axis; num_devices 0 = every rank torchrun launched, 1 = a single
    # process, N = the world size must be N (a mismatch raises).
    data_axis: str = "data"
    num_devices: int = 0

    # ---- accepted and ignored (TPU layouts, block sizes, compiler)
    donate_state: bool = True
    remat_mlp: bool = False
    remat_ipe: bool = True
    kernel_stash_acts: bool = True
    # Read by the port (it stands here to keep the JAX package's field
    # order): where the fused backward rounds the dirs weight gradient's
    # cotangent, per sample (false) or once per ray (true); the dirs are per
    # ray in memory either way.
    kernel_per_ray_dirs: bool = False
    bwd_block_rows: int = 2048
    scoped_vmem_limit_kib: int = 32768
    render_block_rows: int = 0
    ipe_early_cast: bool = False
    split_h_stash: bool = False
    relu_save_output: bool = True
    relu_bf16_residual: bool = True
    split_skip_layer: bool = True
    fetch_precision: str = "mixed"
    ipe_transposed: bool = False
    skip_resampler_sort: bool = True
    raw_lane_inputs: bool = True
    fetch_dtype: str = "float32"
    alpha_vpu: bool = False


@dataclass(frozen=True)
class Config:
    experiment: ExperimentConfig = field(default_factory=ExperimentConfig)
    train_params: TrainParamsConfig = field(default_factory=TrainParamsConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    nerf: NerfConfig = field(default_factory=NerfConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)

    # ------------------------------------------------------------------ YAML

    @classmethod
    def from_yaml(cls, path_or_stream) -> "Config":
        if hasattr(path_or_stream, "read"):
            d = yaml.safe_load(path_or_stream)
        else:
            with open(path_or_stream, "r") as f:
                d = yaml.safe_load(f)
        return cls.from_dict(d or {})

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        exp = d.get("experiment", {}) or {}
        tp = d.get("train_params", {}) or {}
        ds = d.get("dataset", {}) or {}
        opt = d.get("optimizer", {}) or {}
        nerf = d.get("nerf", {}) or {}
        par = d.get("parallel", {}) or {}

        def build(dc_cls, src: dict, **extra):
            kwargs = dict(extra)
            dc_fields = {f.name: f for f in fields(dc_cls)}
            for k, v in (src or {}).items():
                if k in dc_fields and not isinstance(v, dict):
                    if isinstance(v, list):
                        v = tuple(v)
                    # YAML 1.1 reads bare off/on/yes/no as booleans; a str
                    # field (e.g. ``pallas_mlp: off``) wants the word back.
                    if isinstance(v, bool) and dc_fields[k].type in (str, "str"):
                        v = {True: "on", False: "off"}[v]
                    kwargs[k] = v
            return dc_cls(**kwargs)

        bd = ds.get("bd_factor", None)
        if bd is False or bd == 0:
            bd = None
        ds = dict(ds)
        ds["bd_factor"] = bd

        nerf_cfg = build(
            NerfConfig,
            nerf,
            train=build(NerfModeConfig, nerf.get("train", {})),
            validation=build(NerfModeConfig, nerf.get("validation", {})),
        )
        return cls(
            experiment=build(ExperimentConfig, exp),
            train_params=build(TrainParamsConfig, tp),
            dataset=build(DatasetConfig, ds),
            optimizer=build(OptimizerConfig, opt),
            nerf=nerf_cfg,
            parallel=build(ParallelConfig, par),
        )

    def to_dict(self) -> dict:
        def conv(obj):
            if is_dataclass(obj):
                return {f.name: conv(getattr(obj, f.name)) for f in fields(obj)}
            if isinstance(obj, tuple):
                return list(obj)
            return obj

        return conv(self)

    def dump(self) -> str:
        """YAML round-trip, mirroring ``CfgNode.dump`` (cfgnode.py:167) used by
        the config-snapshot contract (train_model.py:44-46)."""
        buf = io.StringIO()
        yaml.safe_dump(self.to_dict(), buf, default_flow_style=False)
        return buf.getvalue()

    # ------------------------------------------------------------- utilities

    def replace_at(self, path: str, value: Any) -> "Config":
        """Return a new Config with ``path`` (dot-separated) replaced."""
        parts = path.split(".")

        def rec(node, parts):
            if len(parts) == 1:
                return replace(node, **{parts[0]: value})
            child = getattr(node, parts[0])
            return replace(node, **{parts[0]: rec(child, parts[1:])})

        return rec(self, parts)

    def merge_from_list(self, opts) -> "Config":
        """YACS-style CLI overrides: alternating ``key value`` pairs with
        dot-separated keys (reference ``CfgNode.merge_from_list``,
        cfgnode.py:208).  Values are YAML-parsed and coerced to the type of
        the field they replace.  Returns a new Config.
        """
        if len(opts) % 2:
            raise ValueError(f"override list must be key/value pairs: {opts}")
        cfg = self
        for key, raw in zip(opts[::2], opts[1::2]):
            node = cfg
            for part in key.split(".")[:-1]:
                node = getattr(node, part)  # raises AttributeError on typo
            leaf = key.split(".")[-1]
            old = getattr(node, leaf)
            val = yaml.safe_load(raw) if isinstance(raw, str) else raw
            if (isinstance(old, str) and isinstance(raw, str)
                    and not isinstance(val, str)):
                # YAML 1.1 coerces bare off/on/yes/no/123 — but the field
                # wants a string (e.g. ``parallel.pallas_mlp off``), so the
                # raw CLI token wins.
                val = raw
            if old is not None and val is not None:
                if isinstance(old, bool):
                    if not isinstance(val, bool):
                        raise ValueError(f"{key} expects a bool, got {raw!r}")
                elif isinstance(old, float) and isinstance(val, int):
                    val = float(val)
                elif isinstance(old, float) and isinstance(val, str):
                    # YAML 1.1 leaves "1e-3" (no dot) as a string.
                    try:
                        val = float(val)
                    except ValueError:
                        raise ValueError(
                            f"{key} expects float, got {raw!r}"
                        ) from None
                elif isinstance(old, tuple) and isinstance(val, list):
                    val = tuple(val)
                elif type(val) is not type(old):
                    raise ValueError(
                        f"{key} expects {type(old).__name__}, got {raw!r}"
                    )
            cfg = cfg.replace_at(key, val)
        return cfg

    def resolved(self) -> "Config":
        """Apply the derived-value rules the reference applies at startup:

        * auto ``dist_reg_coeficient = clip(1/num_coarse, 0.01, 0.12)``
          (train_model.py:124-126);
        * pose-normalization rescale of near/far/combined_split
          (data_utils.py:67-74) is handled in the data layer, not here, so the
          config stays the single source of truth for raw values.
        """
        cfg = self
        if cfg.train_params.set_automatic_dist_reg_coeficient:
            coef = min(max(1.0 / cfg.nerf.train.num_coarse, 0.01), 0.12)
            cfg = cfg.replace_at("train_params.dist_reg_coeficient", coef)
        return cfg

    def is_ddnerf(self) -> bool:
        return self.nerf.type == "DDNerfModel"


def load_config(path: str) -> Config:
    return Config.from_yaml(path).resolved()
