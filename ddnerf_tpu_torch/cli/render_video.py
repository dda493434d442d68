"""CLI: video rendering on the GPU.  Mirrors ``python -m
ddnerf_tpu.cli.render_video`` (reference ``render_video.py --logdir ...
[--save_images]``) for a logdir holding ``config.yml`` and a
reference-format ``checkpoint.ckpt``:

    python -m ddnerf_tpu_torch.cli.render_video --logdir LOGDIR
        [--save_images] [--max-frames N] [--checkpoint STEP]
        [--torch-checkpoint PATH] [--device cuda|cuda:1|cpu]
        [--profile-frames N]

``--profile-frames N`` first renders N frames with the tracer live and
prints where a frame's time goes by stage (device ms from CUDA events,
host ms), then N frames under ``torch.profiler`` into
``LOGDIR/plugins/profile/``, and prints that trace's digest.

Under ``torchrun --nproc_per_node N`` every rank renders its share of each
frame and rank 0 writes (see ``cli/train.py``).
"""

import argparse

from ddnerf_tpu_torch.parallel.mesh import launch_report, launched
from ddnerf_tpu_torch.render.video import render_model_video


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--logdir", type=str, required=True,
                        help="Experiment logdir (config.yml + checkpoint.ckpt).")
    parser.add_argument("--save_images", action="store_true",
                        help="Also write video/frame_%%04d.png per frame.")
    parser.add_argument("--max-frames", type=int, default=0,
                        help="Render only the first N render poses (0: all).")
    parser.add_argument("--torch-checkpoint", type=str, default=None,
                        help="A checkpoint file to render instead of the "
                             "logdir's.")
    parser.add_argument("--checkpoint", type=int, default=None,
                        help="Render a retained checkpoint step "
                             "(checkpoint_{STEP}.ckpt; default: the newest).")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; CUDA asked for and absent is an "
                             "error (default: cuda).")
    parser.add_argument("--profile-frames", type=int, default=0,
                        help="Before the video: N frames with the tracer "
                             "live (their stage table printed), then N "
                             "under torch.profiler into the logdir.")
    args = parser.parse_args(argv)
    with launched(args.device) as mesh:
        render_model_video(args.logdir, save_images=args.save_images,
                           max_frames=args.max_frames,
                           torch_checkpoint=args.torch_checkpoint,
                           checkpoint_step=args.checkpoint,
                           device=args.device,
                           profile_frames=args.profile_frames)
        said = launch_report(mesh)
    if said:
        print(said)


if __name__ == "__main__":
    main()
