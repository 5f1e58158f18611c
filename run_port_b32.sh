#!/usr/bin/env bash
# The held b32 eses_drl_lc protocol of scripts/run_bigbatch.sh (batch 32,
# 800 training episodes, then 300 testing episodes on the held-out
# catalog from the run's snapshot) on the PyTorch port, on one CUDA card;
# then the decision-parity check on the trained snapshot at 224 and 640
# for each eval backend, and the update's modes at the trained weights.
#
# Usage: bash run_port_b32.sh [OUT] [TRAIN_EP] [TEST_EP] [SEED]
#
# SEED (default 0) goes to cli.main's --seed, for training and testing.
# The run trees (with their checkpoints) go under logs/port_b32/seed<SEED>;
# OUT (default logs/port_b32/seed<SEED>/summary) receives the stdout logs,
# each run's info/ and transitions/, the analyze_results.py summary and the
# JSON lines of run_port_checks.sh (CHECKS=0 skips them). Every command
# runs even if one before it failed; the script exits nonzero if any did.
set -u
cd "$(dirname "$0")"

SEED="${4:-0}"
RUNS="logs/port_b32/seed$SEED"
OUT="${1:-$RUNS/summary}"
TRAIN_EP="${2:-800}"
TEST_EP="${3:-300}"
FLAGS="--is_sim --method reinforcement --is_ets --is_pe --is_oo"
COMMON="--batch_size 32 --imagery_every 0 --trunk densenet121 --input_size 224 --seed $SEED"
mkdir -p "$OUT" "$RUNS/train" "$RUNS/test"
rc=0
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"

echo "=== train eses_drl_lc (b32, $TRAIN_EP episodes, seed $SEED) ==="
python3 -m smg_tpu_torch.cli.main $FLAGS $COMMON --training_episode "$TRAIN_EP" \
  --logging_directory "$RUNS/train" > "$OUT/train.log" 2>&1 || rc=1
tail -8 "$OUT/train.log"
run=$(ls -d "$RUNS"/train/*/ | tail -1)
run=${run%/}
snap="$run/models/snapshot"

echo "=== test eses_drl_lc (b32, $TEST_EP episodes, held-out objects) ==="
python3 -m smg_tpu_torch.cli.main $FLAGS $COMMON --is_testing --load_snapshot \
  --snapshot_file "$snap" --obj_mesh_dir datasets/testing \
  --testing_episode "$TEST_EP" --logging_directory "$RUNS/test" \
  > "$OUT/test.log" 2>&1 || rc=1
tail -8 "$OUT/test.log"
test_run=$(ls -d "$RUNS"/test/*/ | tail -1)
test_run=${test_run%/}

for r in "$run" "$test_run"; do
  dst="$OUT/$(basename "$(dirname "$r")")"
  mkdir -p "$dst"
  cp -r "$r/info" "$r/transitions" "$dst/"
done
python3 scripts/analyze_results.py "$run" "$test_run" \
  --labels port_eses_drl_lc_b32_s$SEED-train,port_eses_drl_lc_b32_s$SEED-test \
  --out "$OUT/RESULTS.md" > "$OUT/analyze.log" 2>&1 || rc=1
cat "$OUT/analyze.log"

if [ "${CHECKS:-1}" = 1 ]; then
  bash run_port_checks.sh "$snap" "$OUT" "224 640" || rc=1
fi
exit $rc
