#!/usr/bin/env bash
# The segmenter and learned-mask protocol of scripts/tpu_queue_r5b.sh
# (stageC) on the PyTorch port, on one CUDA card: train the SlotSegmenter
# 600 steps at b16 on cluttered scenes; evaluate it on 32 held-out
# cluttered scenes of the testing catalog in three arms (base, depth
# noise 0.005 m, the perspective pipeline), each on the scenes of three
# seeds (123, eval_segmenter's default, then 124 and 125); then a b32
# training run of 160 episodes through its predicted masks
# (--segmentation learned, PE + OO, DenseNet-121 at 224), summarized by
# scripts/analyze_results.py.
#
# Usage: bash run_port_seg.sh [OUT] [STEPS] [EPISODES]
#
# The checkpoint and the run tree go under logs/port_seg; OUT (default
# logs/port_seg/summary) receives the stdout logs, one JSON line per arm
# and seed (eval_<arm>_seed<seed>.json), the run's info/ and transitions/
# and the analyze_results.py summary. Every command runs even if one
# before it failed; the script exits nonzero if any did.
set -u
cd "$(dirname "$0")"

OUT="${1:-logs/port_seg/summary}"
STEPS="${2:-600}"
EPISODES="${3:-160}"
RUNS=logs/port_seg
CKPT="$RUNS/segmenter.pt"
mkdir -p "$OUT" "$RUNS/learned"
rc=0
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"

echo "=== train the segmenter ($STEPS steps, b16, cluttered) ==="
python3 -m smg_tpu_torch.cli.train_segmenter --steps "$STEPS" --batch_size 16 \
  --is_cluttered --out "$CKPT" > "$OUT/train_segmenter.log" 2>&1 || rc=1
tail -3 "$OUT/train_segmenter.log"

for seed in 123 124 125; do
  for arm in base noise persp; do
    case $arm in
      base) extra="" ;;
      noise) extra="--depth_noise 0.005" ;;
      persp) extra="--perspective" ;;
    esac
    echo "=== eval_segmenter $arm, seed $seed ==="
    python3 -m smg_tpu_torch.cli.eval_segmenter --checkpoint "$CKPT" --scenes 32 \
      --cluttered --testing --seed "$seed" $extra \
      > "$OUT/eval_${arm}_seed$seed.json" 2> "$OUT/eval_${arm}_seed$seed.err" || rc=1
    cat "$OUT/eval_${arm}_seed$seed.json"
  done
done

echo "=== train through learned masks (b32, $EPISODES episodes) ==="
python3 -m smg_tpu_torch.cli.main --is_sim --method reinforcement --is_pe --is_oo \
  --batch_size 32 --trunk densenet121 --input_size 224 --imagery_every 0 \
  --segmentation learned --segmenter_checkpoint "$CKPT" \
  --training_episode "$EPISODES" --logging_directory "$RUNS/learned" \
  > "$OUT/learned.log" 2>&1 || rc=1
tail -6 "$OUT/learned.log"
run=$(ls -d "$RUNS"/learned/*/ | tail -1)
run=${run%/}
mkdir -p "$OUT/learned"
cp -r "$run/info" "$run/transitions" "$OUT/learned/"
python3 scripts/analyze_results.py "$run" --labels port_learned_seg_b32 \
  --out "$OUT/RESULTS.md" > "$OUT/analyze.log" 2>&1 || rc=1
cat "$OUT/analyze.log"
exit $rc
