#!/usr/bin/env bash
# Dress rehearsal of the PyTorch port: the flow of scripts/dress_rehearsal.sh
# (an on-disk dataset -> train CLI -> eval CLI -> video CLI -> PSNR gates)
# through ddnerf_tpu_torch's CLIs, flag for flag, under the same PSNR gates.
#
# Default shape: 400x400, 12 views, 3k iterations of configs/blender_dd.yml
# at full width (8x256 trunks, 2048 rays, bf16, pallas_mlp: auto), the
# captured step; --full runs 800x800, 24 views, 20k iterations; --llff runs
# configs/ff_dd.yml on a forward-facing LLFF capture (minify cache, NDC rays,
# the spiral video path).  The scenes come from
# scripts/make_synthetic_dataset_torch.py, which writes the same files as
# scripts/make_synthetic_dataset.py, the writer the gates were calibrated
# on: psnr_fine 20.67 -> gate 19.0 (blender), 30.12 -> 27.0 (llff),
# 34.27 -> 28.0 (--full blender).
#
# --device cpu runs the same flow at smoke sizes (64x64, 60 iterations, a
# 32-wide model, gate 8.0, no rays/s gate), as the JAX script does under
# JAX_PLATFORMS=cpu.  The rays/s floor is a sanity bound, not a speed
# reading: the train records' rays/s since the run's start (set-up, the
# capture and the validations included) peaked at 251,504 (blender, the
# kernels built in that process) to 616,144 (llff) at the default shape on
# one NVIDIA H100 80GB HBM3 at 700 W; the floor is a fifth of the lowest.
#
# Usage:  scripts/dress_rehearsal_torch.sh [--full] [--llff] [--keep]
#             [--device cuda|cpu]
set -euo pipefail
cd "$(dirname "$0")/.."

FULL=0; LLFF=0; KEEP=0; DEVICE=cuda
while [[ $# -gt 0 ]]; do
  case "$1" in
    --full) FULL=1 ;;
    --llff) LLFF=1 ;;
    --keep) KEEP=1 ;;
    --device) DEVICE=$2; shift ;;
    *) echo "unknown flag $1 (expected --full/--llff/--keep/--device D)" >&2
       exit 2 ;;
  esac
  shift
done

SIZE=400; VIEWS=12; ITERS=3000; MIN_RAYS_S=50000
if [[ $FULL == 1 ]]; then SIZE=800; VIEWS=24; ITERS=20000; fi
if [[ $LLFF == 1 ]]; then
  FORMAT=llff
  CONFIG=configs/ff_dd.yml
  MIN_PSNR=27.0  # the JAX package's 30.12 at 400^2; the same gate at --full
  # The synthetic scene has no keypoint file.
  EXTRA_ARGS=(train_params.depth_analysis_rays False)
else
  FORMAT=blender
  CONFIG=configs/blender_dd.yml
  MIN_PSNR=19.0  # the JAX package's 20.67 at 3k iterations
  [[ $FULL == 1 ]] && MIN_PSNR=28.0  # its 34.27 at 800^2 / 20k
  EXTRA_ARGS=(dataset.synthetic False)
fi
MODEL_ARGS=()
if [[ $DEVICE == cpu ]]; then
  SIZE=64; VIEWS=6; ITERS=60; MIN_PSNR=8.0; MIN_RAYS_S=0
  MODEL_ARGS=(nerf.coarse_hidden_size 32 nerf.fine_hidden_size 32
              nerf.train.num_coarse 8 nerf.train.num_fine 8
              nerf.train.num_random_rays 256
              nerf.validation.num_coarse 8 nerf.validation.num_fine 8
              nerf.validation.chunksize 4096)
fi

WORK=${DRESS_WORKDIR:-${TMPDIR:-/tmp}/ddnerf_dress_torch}
DS="$WORK/dataset_${FORMAT}_$SIZE"
LOGROOT="$WORK/logs"
RUN_ID="dress_${FORMAT}_$SIZE"
LOGDIR="$LOGROOT/$RUN_ID"
[[ $KEEP == 1 ]] || rm -rf "$LOGDIR"

now() { date +%s.%N; }

echo "== dataset ($FORMAT, $SIZE x $SIZE, $VIEWS views) =="
if [[ ! -f "$DS/transforms_train.json" && ! -f "$DS/poses_bounds.npy" ]]; then
  python scripts/make_synthetic_dataset_torch.py "$DS" --format "$FORMAT" \
      --size "$SIZE" --train "$VIEWS" --val 2 --test 2
fi

echo "== train ($ITERS iters) =="
T0=$(now)
python -m ddnerf_tpu_torch.cli.train --config "$CONFIG" --device "$DEVICE" \
    dataset.basedir "$DS" "${EXTRA_ARGS[@]}" \
    experiment.id "$RUN_ID" experiment.logdir "$LOGROOT" \
    experiment.train_iters "$ITERS" \
    experiment.validate_every $((ITERS / 3)) \
    experiment.save_every $((ITERS / 2)) \
    experiment.print_every $((ITERS / 10)) \
    experiment.train_scalars_every 20 \
    train_params.max_pdf_pad_iters $((ITERS / 4)) \
    train_params.finnish_smooth $((ITERS / 4)) \
    "${MODEL_ARGS[@]}"

echo "== eval =="
T1=$(now)
# AlexNet-LPIPS weights converted by scripts/convert_lpips_weights.py (its
# documented output name is lpips_alex.npz).
LPIPS_ARGS=()
if [[ -f "$WORK/lpips_alex.npz" ]]; then
  LPIPS_ARGS=(--lpips-weights "$WORK/lpips_alex.npz")
fi
python -m ddnerf_tpu_torch.cli.eval --logdir "$LOGDIR" --max-images 2 \
    --device "$DEVICE" "${LPIPS_ARGS[@]}"

echo "== video (3 frames) =="
T2=$(now)
python -m ddnerf_tpu_torch.cli.render_video --logdir "$LOGDIR" \
    --max-frames 3 --device "$DEVICE"
T3=$(now)

echo "== thresholds (PSNR >= $MIN_PSNR, train rays/s >= $MIN_RAYS_S) =="
python - "$LOGDIR" "$MIN_PSNR" "$MIN_RAYS_S" "$T0" "$T1" "$T2" "$T3" <<'PY'
import json, re, sys

logdir, min_psnr, min_rays = sys.argv[1], float(sys.argv[2]), float(sys.argv[3])
t0, t1, t2, t3 = map(float, sys.argv[4:8])
text = open(f"{logdir}/validation/results.txt").read()
metrics = dict(re.findall(r"^(psnr_fine|ssim_v[12]_fine): \t (\S+)$", text,
                           re.M))
assert "psnr_fine" in metrics, "psnr_fine missing from results.txt"
psnr = float(metrics["psnr_fine"])
with open(f"{logdir}/metrics.jsonl") as f:
    ends = [r for r in map(json.loads, f)
            if r.get("kind") == "train" and "rays_per_sec" in r]
rate = max(r["rays_per_sec"] for r in ends) if ends else 0.0
# The loop's pace between its last two block ends (no validation between).
step_ms = ((ends[-1]["time"] - ends[-2]["time"]) * 1e3
           / (ends[-1]["step"] - ends[-2]["step"])) if len(ends) > 1 else 0.0
print(f"eval psnr_fine={psnr} ssim_v1_fine={metrics.get('ssim_v1_fine')} "
      f"ssim_v2_fine={metrics.get('ssim_v2_fine')} "
      f"(gate {min_psnr}), train rays/s peak={rate:.0f} (gate {min_rays:.0f}), "
      f"loop {step_ms:.3f} ms/step; wall train {t1 - t0:.1f} s, "
      f"eval {t2 - t1:.1f} s, video {t3 - t2:.1f} s")
assert psnr >= min_psnr, f"PSNR {psnr} below gate {min_psnr}"
assert rate >= min_rays, f"rays/s {rate:.0f} below gate {min_rays:.0f}"
print("DRESS REHEARSAL PASSED")
PY
