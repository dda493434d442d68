"""CLI: evaluation on the GPU.  Mirrors ``python -m ddnerf_tpu.cli.eval``
(reference ``eval_nerf.py --logdir ... [--save_images --extract_ptc]``)
for a logdir holding ``config.yml`` and reference-format checkpoints:

    python -m ddnerf_tpu_torch.cli.eval --logdir LOGDIR [--max-images N]
        [--save_images] [--extract_ptc] [--checkpoint STEP]
        [--torch-checkpoint PATH] [--device cuda|cuda:1|cpu]

``--lpips-weights W.npz`` (AlexNet-LPIPS weights, e.g. written by
``scripts/convert_lpips_weights.py``) adds ``lpips_coarse`` / ``lpips_fine``
to results.txt.  Under ``torchrun --nproc_per_node N`` every rank renders
its share of each image and rank 0 writes (see ``cli/train.py``).
"""

import argparse

from ddnerf_tpu_torch.eval.evaluate import MAX_VALIDATION_IMAGES, eval_model
from ddnerf_tpu_torch.parallel.mesh import launch_report, launched


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--logdir", type=str, required=True,
                        help="Experiment logdir (config.yml + checkpoint.ckpt).")
    parser.add_argument("--save_images", action="store_true",
                        help="Write validation/{i}/*.png and gt.png.")
    parser.add_argument("--extract_ptc", action="store_true",
                        help="Extract a point cloud per validation image "
                             "(validation/ptc_{i}.npy).")
    parser.add_argument("--lpips-weights", type=str, default=None,
                        help="Local AlexNet-LPIPS weights (.npz); adds "
                             "lpips_coarse / lpips_fine to results.txt.")
    parser.add_argument("--max-images", type=int,
                        default=MAX_VALIDATION_IMAGES,
                        help="Cap on validation images (reference "
                             "MAX_VALIDATION_IMAGES=10).")
    parser.add_argument("--torch-checkpoint", type=str, default=None,
                        help="A checkpoint file to evaluate instead of the "
                             "logdir's.")
    parser.add_argument("--checkpoint", type=int, default=None,
                        help="Evaluate a retained checkpoint step "
                             "(checkpoint_{STEP}.ckpt; default: the newest).")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; CUDA asked for and absent is an "
                             "error (default: cuda).")
    args = parser.parse_args(argv)
    with launched(args.device) as mesh:
        eval_model(args.logdir, extract_ptc=args.extract_ptc,
                   save_images=args.save_images,
                   lpips_weights=args.lpips_weights,
                   max_images=args.max_images,
                   torch_checkpoint=args.torch_checkpoint,
                   checkpoint_step=args.checkpoint, device=args.device)
        said = launch_report(mesh)
    if said:
        print(said)


if __name__ == "__main__":
    main()
