#!/usr/bin/env bash
# The warm arm of the warm-start A/B (scripts/run_warmstart_ab.sh) on the
# PyTorch port, on one CUDA card: pretrain the trunk on masked-depth
# reconstruction (1000 steps at b16), train eses_drl_lc at b32 from it
# (--pretrained_trunks, the held flags of run_port_b32.sh), test on the
# held-out catalog from the run's snapshot, summarize with
# scripts/analyze_results.py, then run_port_checks.sh on the snapshot at
# 224. The cold arm is run_port_b32.sh's run.
#
# Usage: bash run_port_warmstart.sh [OUT] [TRAIN_EP] [TEST_EP] [PRETRAIN_STEPS] [SEED]
#
# SEED (default 0) goes to --seed of cli.pretrain_trunks and of cli.main
# (training and testing). The run trees go under
# logs/port_warmstart/seed<SEED>; OUT (default
# logs/port_warmstart/seed<SEED>/summary) receives the stdout logs, each
# run's info/ and transitions/, the summary (RESULTS.md) and the JSON lines
# of run_port_checks.sh at 224 (CHECKS=0 skips them). Every command runs
# even if one before it failed; the script exits nonzero if any did.
set -u
cd "$(dirname "$0")"

SEED="${5:-0}"
RUNS="logs/port_warmstart/seed$SEED"
OUT="${1:-$RUNS/summary}"
TRAIN_EP="${2:-800}"
TEST_EP="${3:-300}"
STEPS="${4:-1000}"
PRE="$RUNS/trunk_pretrain.pt"
FLAGS="--is_sim --method reinforcement --is_ets --is_pe --is_oo"
COMMON="--batch_size 32 --imagery_every 0 --trunk densenet121 --input_size 224 --seed $SEED"
mkdir -p "$OUT" "$RUNS/train" "$RUNS/test"
rc=0
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"

echo "=== pretrain trunks ($STEPS steps, b16, seed $SEED) ==="
python3 -m smg_tpu_torch.cli.pretrain_trunks --steps "$STEPS" --batch_size 16 \
  --seed "$SEED" --out "$PRE" > "$OUT/pretrain.log" 2>&1 || rc=1
grep "^pretrain step" "$OUT/pretrain.log" | tail -3

echo "=== train eses_drl_lc, warm (b32, $TRAIN_EP episodes) ==="
python3 -m smg_tpu_torch.cli.main $FLAGS $COMMON --pretrained_trunks "$PRE" \
  --training_episode "$TRAIN_EP" --logging_directory "$RUNS/train" \
  > "$OUT/train.log" 2>&1 || rc=1
tail -8 "$OUT/train.log"
run=$(ls -d "$RUNS"/train/*/ | tail -1)
run=${run%/}

echo "=== test eses_drl_lc, warm (b32, $TEST_EP episodes, held-out objects) ==="
python3 -m smg_tpu_torch.cli.main $FLAGS $COMMON --is_testing --load_snapshot \
  --snapshot_file "$run/models/snapshot" --obj_mesh_dir datasets/testing \
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
  --labels port_eses_drl_lc_warm_s$SEED-train,port_eses_drl_lc_warm_s$SEED-test \
  --out "$OUT/RESULTS.md" > "$OUT/analyze.log" 2>&1 || rc=1
cat "$OUT/analyze.log"
if [ "${CHECKS:-1}" = 1 ]; then
  bash run_port_checks.sh "$run/models/snapshot" "$OUT" 224 || rc=1
fi
exit $rc
