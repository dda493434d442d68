"""Write the procedural sphere scene as a real on-disk dataset, with the
PyTorch port's modules only (no imageio, no JAX).

The same command line as ``scripts/make_synthetic_dataset.py`` and, for
the same arguments, the same files:

* ``--format blender`` (default): ``transforms_{train,val,test}.json`` and
  RGBA PNGs ``{split}/r_{j}.png``, the layout ``load_blender_data`` reads;
* ``--format llff``: a forward-facing capture, ``images/image%03d.png`` and
  ``poses_bounds.npy``, the layout ``load_llff_data`` reads;
* ``--format real360`` (this script only): the LLFF layout again, with the
  cameras on a ring around the scene looking at its centre, for
  ``configs/real360_*.yml`` (``dataset.type: real360``).

Run:  python scripts/make_synthetic_dataset_torch.py OUTDIR \\
          [--format blender|llff|real360] [--size 800] [--train 24] \\
          [--val 2] [--test 2] [--seed 0]
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ddnerf_tpu_torch.data.images import write_image  # noqa: E402
from ddnerf_tpu_torch.data.synthetic import (  # noqa: E402
    generate_synthetic_blender,
    write_synthetic_llff,
    write_synthetic_real360,
)


def write_blender(args) -> None:
    """The blender splits: the first ``--train`` views of the generator
    train, its held-out views are cut into ``--val`` and ``--test``."""
    images, poses, _, hwf, i_split = generate_synthetic_blender(
        num_train=args.train,
        num_val=args.val + args.test,
        height=args.size,
        width=args.size,
        seed=args.seed,
    )
    h, w, focal = hwf
    camera_angle_x = 2.0 * float(np.arctan(0.5 * w / focal))
    held_out = list(i_split[1])
    splits = (("train", list(i_split[0])), ("val", held_out[:args.val]),
              ("test", held_out[args.val:args.val + args.test]))
    os.makedirs(args.outdir, exist_ok=True)
    for split, idxs in splits:
        os.makedirs(os.path.join(args.outdir, split), exist_ok=True)
        frames = []
        for j, i in enumerate(idxs):
            rel = f"./{split}/r_{j}"
            write_image(os.path.join(args.outdir, f"{rel}.png"),
                        (np.clip(images[i], 0, 1) * 255).astype(np.uint8))
            frames.append({
                "file_path": rel,
                "transform_matrix": np.asarray(poses[i], np.float64).tolist(),
            })
        with open(os.path.join(args.outdir, f"transforms_{split}.json"),
                  "w") as fp:
            json.dump({"camera_angle_x": camera_angle_x, "frames": frames},
                      fp, indent=1)
    print(f"wrote {args.train}/{args.val}/{args.test} train/val/test views "
          f"at {args.size}x{args.size} to {args.outdir} "
          f"(camera_angle_x={camera_angle_x:.4f})")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("--format", default="blender",
                    choices=("blender", "llff", "real360"))
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--train", type=int, default=24)
    ap.add_argument("--val", type=int, default=2)
    ap.add_argument("--test", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.format == "blender":
        write_blender(args)
        return
    n = args.train + args.val + args.test
    writer = (write_synthetic_llff if args.format == "llff"
              else write_synthetic_real360)
    writer(args.outdir, size=args.size, n=n, seed=args.seed)
    layout = ("forward-facing" if args.format == "llff"
              else "360-degree ring")
    print(f"wrote {n} {layout} views at {args.size}x{args.size} "
          f"(LLFF layout) to {args.outdir}")


if __name__ == "__main__":
    main()
