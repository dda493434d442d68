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
# --f32 runs the models at parallel.compute_dtype float32 (the float32
# kernels on the card) under the same gates.  --widths C F sets
# nerf.coarse_hidden_size / nerf.fine_hidden_size (the fused kernels up to
# 512, the wide plan above), --plain sets parallel.pallas_mlp off (the plain
# PyTorch MLP and autograd, no kernel); both keep the PSNR gate, and the run
# id carries them, so that runs of one scene keep their own logdirs.  The
# rays/s floor was read at the config's widths with the kernels and holds
# there only: with --widths or --plain the rate is printed, not gated.
#
# --mipnerf runs the mip-NeRF family (configs/blender_mipnerf.yml, with
# --llff configs/ff_mipnerf.yml: mip-NeRF under NDC); --real360 runs
# configs/real360_dd.yml (with --mipnerf configs/real360_mipnerf.yml) on a
# ring of cameras from scripts/make_synthetic_dataset_torch.py --format
# real360.  The JAX package calibrated no gate for those runs, so each
# gates a floor 2 dB under the first plain reading (--plain) on one NVIDIA
# H100 80GB HBM3 at 700 W, given beside it below; the rays/s floor does
# not apply to them.  Each flag goes into the run id.
#
# Usage:  scripts/dress_rehearsal_torch.sh [--full] [--llff] [--real360]
#             [--mipnerf] [--keep] [--f32] [--widths C F] [--plain]
#             [--device cuda|cpu]
set -euo pipefail
cd "$(dirname "$0")/.."

FULL=0; LLFF=0; REAL360=0; MIPNERF=0; KEEP=0; F32=0; PLAIN=0; WIDTHS=()
DEVICE=cuda
while [[ $# -gt 0 ]]; do
  case "$1" in
    --full) FULL=1 ;;
    --llff) LLFF=1 ;;
    --real360) REAL360=1 ;;
    --mipnerf) MIPNERF=1 ;;
    --keep) KEEP=1 ;;
    --f32) F32=1 ;;
    --plain) PLAIN=1 ;;
    --widths) WIDTHS=("$2" "$3"); shift 2 ;;
    --device) DEVICE=$2; shift ;;
    *) echo "unknown flag $1 (expected --full/--llff/--real360/--mipnerf/--keep/--f32/--widths C F/--plain/--device D)" >&2
       exit 2 ;;
  esac
  shift
done

SIZE=400; VIEWS=12; ITERS=3000; MIN_RAYS_S=50000
if [[ $FULL == 1 ]]; then SIZE=800; VIEWS=24; ITERS=20000; fi
if [[ $LLFF == 1 && $REAL360 == 1 ]]; then
  echo "--llff and --real360 are two scenes: take one" >&2; exit 2
fi
FAMILY=dd; [[ $MIPNERF == 1 ]] && FAMILY=mipnerf
if [[ $LLFF == 1 ]]; then
  FORMAT=llff
  if [[ $MIPNERF == 1 ]]; then
    CONFIG=configs/ff_mipnerf.yml
    MIN_PSNR=0.0  # set below from the plain reading on the card
  else
    CONFIG=configs/ff_dd.yml
    MIN_PSNR=27.0  # the JAX package's 30.12 at 400^2; the same gate at --full
  fi
  # The synthetic scene has no keypoint file.
  EXTRA_ARGS=(train_params.depth_analysis_rays False)
elif [[ $REAL360 == 1 ]]; then
  FORMAT=real360
  CONFIG=configs/real360_$FAMILY.yml
  MIN_PSNR=0.0  # set below from the plain reading on the card
  EXTRA_ARGS=()
else
  FORMAT=blender
  CONFIG=configs/blender_$FAMILY.yml
  MIN_PSNR=19.0  # the JAX package's 20.67 at 3k iterations
  [[ $FULL == 1 ]] && MIN_PSNR=28.0  # its 34.27 at 800^2 / 20k
  [[ $MIPNERF == 1 ]] && MIN_PSNR=0.0  # set below from the plain reading
  EXTRA_ARGS=(dataset.synthetic False)
fi
if [[ $MIPNERF == 1 || $REAL360 == 1 ]]; then
  MIN_RAYS_S=0
  # Plain readings (--plain) at the default shape on one NVIDIA H100 80GB
  # HBM3 at 700 W; the floor is 2 dB under each.  --full has none.
  case "$FORMAT/$FAMILY" in
    llff/mipnerf) PLAIN_PSNR=29.67 ;;
    real360/dd) PLAIN_PSNR=15.39 ;;
    real360/mipnerf) PLAIN_PSNR=15.23 ;;
    blender/mipnerf) PLAIN_PSNR=20.73 ;;
  esac
  [[ $FULL == 1 ]] && PLAIN_PSNR=0
  MIN_PSNR=$(python -c "print(max(0.0, $PLAIN_PSNR - 2.0))")
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

[[ $F32 == 1 ]] && MODEL_ARGS+=(parallel.compute_dtype float32)
if [[ ${#WIDTHS[@]} == 2 ]]; then
  MODEL_ARGS+=(nerf.coarse_hidden_size "${WIDTHS[0]}"
               nerf.fine_hidden_size "${WIDTHS[1]}")
  MIN_RAYS_S=0
fi
if [[ $PLAIN == 1 ]]; then
  MODEL_ARGS+=(parallel.pallas_mlp off)
  MIN_RAYS_S=0
fi

WORK=${DRESS_WORKDIR:-${TMPDIR:-/tmp}/ddnerf_dress_torch}
DS="$WORK/dataset_${FORMAT}_$SIZE"
LOGROOT="$WORK/logs"
RUN_ID="dress_${FORMAT}_$SIZE"
[[ $MIPNERF == 1 ]] && RUN_ID="${RUN_ID}_mipnerf"
[[ $F32 == 1 ]] && RUN_ID="${RUN_ID}_f32"
[[ ${#WIDTHS[@]} == 2 ]] && RUN_ID="${RUN_ID}_w${WIDTHS[0]}x${WIDTHS[1]}"
[[ $PLAIN == 1 ]] && RUN_ID="${RUN_ID}_plain"
LOGDIR="$LOGROOT/$RUN_ID"
[[ $KEEP == 1 ]] || rm -rf "$LOGDIR"

now() { date +%s.%N; }

echo "== dataset ($FORMAT, $SIZE x $SIZE, $VIEWS views) =="
# (A real-360 ring is written in the LLFF layout.)
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
