"""CLI: evaluation on the GPU.  Mirrors ``python -m ddnerf_tpu.cli.eval``
(reference ``eval_nerf.py --logdir ...``) for a logdir holding
``config.yml`` and a reference-format ``checkpoint.ckpt``:

    python -m ddnerf_tpu_torch.cli.eval --logdir LOGDIR [--max-images N]
        [--torch-checkpoint PATH] [--device cuda|cuda:1|cpu]
"""

import argparse
import json

from ddnerf_tpu_torch.eval.evaluate import MAX_VALIDATION_IMAGES, eval_model
from ddnerf_tpu_torch.kernels.fused_mlp import LAUNCHES


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--logdir", type=str, required=True,
                        help="Experiment logdir (config.yml + checkpoint.ckpt).")
    parser.add_argument("--max-images", type=int,
                        default=MAX_VALIDATION_IMAGES,
                        help="Cap on validation images (reference "
                             "MAX_VALIDATION_IMAGES=10).")
    parser.add_argument("--torch-checkpoint", type=str, default=None,
                        help="Reference checkpoint.ckpt to evaluate "
                             "(default: LOGDIR/checkpoint.ckpt).")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; CUDA asked for and absent is an "
                             "error (default: cuda).")
    args = parser.parse_args(argv)
    eval_model(args.logdir, max_images=args.max_images,
               torch_checkpoint=args.torch_checkpoint, device=args.device)
    # Which kernels the render went through (0 = the plain version ran).
    print("kernel launches: " + json.dumps(LAUNCHES, sort_keys=True))


if __name__ == "__main__":
    main()
