"""CLI: training on the GPU.  Mirrors ``python -m ddnerf_tpu.cli.train``
(reference ``train_model.py --config X.yml``):

    python -m ddnerf_tpu_torch.cli.train --config CONFIG [--max-iters N]
        [--device cuda|cuda:1|cpu] [dot.path value ...]

The positional pairs override the config (reference
CfgNode.merge_from_list), e.g. ``experiment.logdir /tmp/runs
nerf.train.num_random_rays 1024``.  CUDA asked for and absent is an error,
never a run on the CPU.
"""

import argparse
import json

from ddnerf_tpu_torch.config import load_config
from ddnerf_tpu_torch.kernels.fused_mlp import LAUNCHES
from ddnerf_tpu_torch.train.loop import train


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True,
                        help="Path to (.yml) config file.")
    parser.add_argument("--max-iters", type=int, default=0,
                        help="Override experiment.train_iters (0 = use config).")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default: cuda).")
    parser.add_argument("opts", nargs="*", default=[],
                        help="Config overrides as 'dot.path value' pairs.")
    args = parser.parse_args(argv)

    cfg = load_config(args.config)
    if args.opts:
        cfg = cfg.merge_from_list(args.opts).resolved()
    _, logdir = train(cfg, max_iters=args.max_iters or None,
                      device=args.device)
    print(f"logdir: {logdir}")
    # Which kernels the run went through (0 = the plain versions ran).
    print("kernel launches: " + json.dumps(LAUNCHES, sort_keys=True))
    print("Done!")


if __name__ == "__main__":
    main()
