"""CLI: training on the GPU.  Mirrors ``python -m ddnerf_tpu.cli.train``
(reference ``train_model.py --config X.yml [--load-checkpoint path]``):

    python -m ddnerf_tpu_torch.cli.train --config CONFIG [--max-iters N]
        [--load-checkpoint PATH] [--device cuda|cuda:1|cpu]
        [--step-mode graph|eager] [--profile-steps N] [--debug-nans]
        [dot.path value ...]

The positional pairs override the config (reference
CfgNode.merge_from_list), e.g. ``experiment.logdir /tmp/runs
nerf.train.num_random_rays 1024``.  A logdir that already holds a
checkpoint is resumed from it; ``--load-checkpoint`` names another logdir
or checkpoint file to start from.  CUDA asked for and absent is an error,
never a run on the CPU.  On a CUDA device the step is one captured CUDA
graph replayed per iteration (``--step-mode graph``, the default there);
``--step-mode eager`` runs it as plain PyTorch calls, as the CPU does.
``--profile-steps N`` turns the program's tracer on before the step is
built, so that the captured graph times each stage on the device, prints
the stage table of N steady steps run without a profiler, then traces N
more under ``torch.profiler`` (``utils/profiling.py``).

Data parallelism: launched as ``torchrun --nproc_per_node N -m
ddnerf_tpu_torch.cli.train ...`` (``python -m torch.distributed.run`` is
the same launcher), every rank trains on its share of each step's rays
(``parallel/mesh.py``): ``--device cuda`` gives rank ``LOCAL_RANK`` card
``cuda:LOCAL_RANK`` and the NCCL backend, ``--device cuda:K`` puts every
rank on card K and ``--device cpu`` on the CPU, both under gloo (the eager
step).  Rank 0 alone prints and writes.  Several nodes are torchrun's
multi-node launch (``--nnodes``, ``--rdzv-endpoint``).
"""

import argparse

from ddnerf_tpu_torch.config import load_config
from ddnerf_tpu_torch.parallel.mesh import launch_report, launched
from ddnerf_tpu_torch.train.loop import STEP_MODES, train
from ddnerf_tpu_torch.utils.debug import nan_debug_mode


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True,
                        help="Path to (.yml) config file.")
    parser.add_argument("--load-checkpoint", type=str, default="",
                        help="A logdir or checkpoint file to resume from "
                             "(default: the run's own logdir, if it holds a "
                             "checkpoint).")
    parser.add_argument("--max-iters", type=int, default=0,
                        help="Override experiment.train_iters (0 = use config).")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default: cuda).")
    parser.add_argument("--step-mode", choices=STEP_MODES, default=None,
                        help="graph: the step as a captured CUDA graph, one "
                             "replay per iteration (default on a CUDA "
                             "device); eager: plain PyTorch calls (default "
                             "on the CPU and with host-side ray sampling).")
    parser.add_argument("--profile-steps", type=int, default=0,
                        help="Run N steady steps with the tracer live and "
                             "print their stage table (graph nodes, device "
                             "and host ms by stage), then N under "
                             "torch.profiler into the logdir and print "
                             "that trace's digest.")
    parser.add_argument("--debug-nans", action="store_true",
                        help="Enable autograd anomaly detection and a finite "
                             "check of every step's parameters, loss and "
                             "gradients: raise at the first NaN (sanitizer "
                             "mode, slower; runs the eager step).")
    parser.add_argument("opts", nargs="*", default=[],
                        help="Config overrides as 'dot.path value' pairs.")
    args = parser.parse_args(argv)

    cfg = load_config(args.config)
    if args.opts:
        cfg = cfg.merge_from_list(args.opts).resolved()
    with launched(args.device) as mesh, nan_debug_mode(args.debug_nans):
        _, logdir = train(cfg, max_iters=args.max_iters or None,
                          device=args.device,
                          load_checkpoint=args.load_checkpoint,
                          profile_steps=args.profile_steps,
                          step_mode=args.step_mode)
        said = launch_report(mesh)
    if said:
        print(f"logdir: {logdir}")
        print(said)
        print("Done!")


if __name__ == "__main__":
    main()
