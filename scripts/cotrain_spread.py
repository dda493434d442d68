"""How far rounding alone moves a co-trained quality reading: each package
trained alone from the JAX initialization of
``tests/test_torch_port_quality.py::cotrain`` (its narrowing: 32-wide, 8 +
8 samples, 256 rays, ``lr_init`` 5e-3 from step 0, f32, 300 steps) on the
batches of ``default_rng(seed)``, with the first weight leaf scaled by
``1 + nudge``, then its fine PSNR on the validation views.  Where a package
against itself moves by more than the co-trained gate (0.5 dB) under a
nudge of 1e-7, one batch stream cannot hold the two packages to that gate.

    JAX_PLATFORMS=cpu python scripts/cotrain_spread.py --config ff_mipnerf.yml \\
        [--package jax|port] [--nudges 0,1e-7,1e-6] [--seeds 11] [--scene ff]

``--scene ff`` is the 32² LLFF capture of
``tests/test_torch_port_quality_ndc.py`` (NDC), ``blender`` the written
blender scene of ``tests/test_torch_port_quality.py``, ``real360`` the
ring of ``tests/test_torch_port_quality_real360.py``.  Imports both
packages; runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

STEPS, RAYS = 300, 256


def _scene(kind, root):
    """The quality tests' scene of ``kind`` under ``root`` -> overrides."""
    path = os.path.join(root, kind)
    if kind == "ff":
        from ddnerf_tpu_torch.data.synthetic import write_synthetic_llff

        write_synthetic_llff(path, size=128, n=10, seed=1)
        return ["dataset.basedir", path,
                "train_params.depth_analysis_rays", "false"]
    if kind == "real360":
        from ddnerf_tpu_torch.data.synthetic import write_synthetic_real360

        write_synthetic_real360(path, size=128, n=10, seed=1)
        return ["dataset.basedir", path]
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_synthetic_dataset_torch",
        os.path.join(REPO, "scripts", "make_synthetic_dataset_torch.py"))
    writer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(writer)
    writer.main([path, "--size", "32", "--train", "8", "--val", "2",
                 "--test", "1", "--seed", "1"])
    return ["dataset.basedir", path]


def reading(config, opts, package, nudge, seed):
    """One package alone: fine PSNR after :data:`STEPS` steps."""
    import jax
    import jax.numpy as jnp
    from test_torch_port_quality import NARROW, _jax_psnr, _port_psnr

    from ddnerf_tpu.config import load_config as jax_load_config
    from ddnerf_tpu.data.assembly import get_datasets as jax_get_datasets
    from ddnerf_tpu.models.nerf import NerfPipeline as JaxPipeline
    from ddnerf_tpu.train.state import create_train_state
    from ddnerf_tpu.train.step import make_train_step
    from ddnerf_tpu_torch.config import load_config
    from ddnerf_tpu_torch.data.assembly import get_datasets
    from ddnerf_tpu_torch.models.nerf import NerfPipeline
    from ddnerf_tpu_torch.train.state import TrainState
    from ddnerf_tpu_torch.train.step import train_step
    from ddnerf_tpu_torch.utils.weights import pipeline_state_from_params

    name = os.path.join(REPO, "configs", config)
    opts = [*opts, *NARROW]
    jcfg = jax_load_config(name).merge_from_list(
        opts + ["parallel.pallas_mlp", "off"]).resolved()
    cfg = load_config(name).merge_from_list(
        opts + ["parallel.pallas_mlp", "auto"]).resolved()
    _, jval, jcfg = jax_get_datasets(jcfg)
    train, val, cfg = get_datasets(cfg)
    jpipe = JaxPipeline(jcfg)
    jstate = create_train_state(jcfg, jpipe, jax.random.PRNGKey(0))
    leaves, tree = jax.tree_util.tree_flatten(jstate.params)
    leaves[0] = leaves[0] * (1.0 + nudge)
    jstate = jstate.replace(params=jax.tree_util.tree_unflatten(tree, leaves))
    rng = np.random.default_rng(seed)
    if package == "jax":
        jstep = jax.jit(make_train_step(jcfg, jpipe))
        for _ in range(STEPS):
            ro, rd, radii, rgb = train.sample_batch(rng, RAYS)
            jstate, _ = jstep(jstate, {
                "origins": jnp.asarray(ro), "directions": jnp.asarray(rd),
                "radii": jnp.asarray(radii), "rgb": jnp.asarray(rgb)})
        return _jax_psnr(jcfg, jpipe, jstate.params, jval, STEPS)
    pipe = NerfPipeline(cfg, "cpu")
    pipe.load_state_dicts(**pipeline_state_from_params(jstate.params))
    state = TrainState(cfg, pipe)
    for _ in range(STEPS):
        ro, rd, radii, rgb = train.sample_batch(rng, RAYS)
        train_step(cfg, pipe, state, {
            "origins": torch.from_numpy(ro), "directions": torch.from_numpy(rd),
            "radii": torch.from_numpy(radii), "rgb": torch.from_numpy(rgb)})
    return _port_psnr(cfg, pipe, val, STEPS)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", default="ff_mipnerf.yml")
    parser.add_argument("--scene", default="ff",
                        choices=("ff", "blender", "real360"))
    parser.add_argument("--package", default="jax", choices=("jax", "port"))
    parser.add_argument("--nudges", default="0,1e-7,1e-6")
    parser.add_argument("--seeds", default="11")
    parser.add_argument("--threads", type=int, default=2)
    args = parser.parse_args(argv)
    torch.set_num_threads(args.threads)
    with tempfile.TemporaryDirectory() as root:
        opts = _scene(args.scene, root)
        for seed in map(int, args.seeds.split(",")):
            for nudge in map(float, args.nudges.split(",")):
                psnr = reading(args.config, opts, args.package, nudge, seed)
                print(f"{args.config} ({args.scene}) {args.package} batch "
                      f"seed {seed} nudge {nudge:g}: psnr_fine after {STEPS} "
                      f"steps {psnr:.3f}", flush=True)


if __name__ == "__main__":
    main()
