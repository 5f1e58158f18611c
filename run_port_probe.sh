#!/usr/bin/env bash
# The eval path's probe on trained snapshots, on one CUDA card: for each
# run, all runs side by side once the CUDA kernels and native/ are built,
#   1. the held b32 protocol's training (run_port_b32.sh: 800 episodes,
#      DenseNet-121 at 224, double-DQN, E+S, PE+OO, batch 32);
#   2. then, side by side: three 300-episode test runs from its snapshot,
#      the held-out catalog with TrainConfig.fast_eval "auto" (the fast eval
#      trunk decides) and "off" (the bf16 module forward decides), and the
#      training catalog ("auto"); stage_parity.py on every style at 224
#      with 64 held-out arbitrations; run_port_checks.sh at 224;
#   3. scripts/analyze_results.py over the four run trees.
# Each run's stage_parity.py dumps its worst style's trunk and head
# (--dump, ~30 MB) beside its run trees; last, the dump of the run whose
# worst backend stands farthest above the bf16 module forward (a run that
# reproduces the strict rule's failure first) is copied to OUT/dump.
#
# Usage: bash run_port_probe.sh OUT [RUNS] [TRAIN_EP] [TEST_EP] [ARBITRATE]
#
# RUNS is a list of arm:seed words (default "cold:0 cold:1 pk:0"): "cold" is
# the protocol as run_port_b32.sh runs it (fast_train_conv2 "conv"), "pk"
# the same with fast_train_conv2 "pk" (the update's dense layers on K6).
# Each run writes OUT/<arm>_s<seed>/ (logs, JSON, each run tree's info/ and
# transitions/) and keeps its run trees under logs/port_probe/. The test
# runs and the checks stop at DEADLINE seconds after the start (default
# 3400) so that the script ends inside a one-hour call; a test run cut
# there keeps the episodes it logged. Exits nonzero if any step failed.
# The default three runs take ~57 min on one H100.
set -u
cd "$(dirname "$0")"

OUT="$1"
RUNS="${2:-cold:0 cold:1 pk:0}"
TRAIN_EP="${3:-800}"
TEST_EP="${4:-300}"
ARBITRATE="${5:-64}"
T0=$(date +%s)
DEADLINE=$((T0 + ${DEADLINE:-3400}))
FLAGS="--is_sim --method reinforcement --is_ets --is_pe --is_oo"
COMMON="--batch_size 32 --imagery_every 0 --trunk densenet121 --input_size 224"
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
python3 -c "
from smg_tpu_torch.ops import _build
from smg_tpu_torch.utils import native
_build.library()
assert native.load_library() is not None, 'native/ did not build'
" || exit 1

left() { echo $((DEADLINE - $(date +%s) > 60 ? DEADLINE - $(date +%s) : 60)); }

# python3 -c "$CLI" FAST_EVAL CONV2 FLAGS...: cli.main's run() on the parsed
# flags, with TrainConfig.fast_eval and fast_train_conv2 replaced (no flag
# reaches them).
CLI='
import dataclasses, sys
from smg_tpu_torch.cli import main
from smg_tpu_torch.utils import config
cfg = config.parse_args(sys.argv[3:])
train = dataclasses.replace(cfg.train, fast_eval=sys.argv[1], fast_train_conv2=sys.argv[2])
main.run(dataclasses.replace(cfg, train=train))
'

probe_run() {
  local arm=$1 seed=$2
  local dir="$OUT/${arm}_s$seed" runs="logs/port_probe/${arm}_s$seed" conv2=conv rc=0
  [ "$arm" = pk ] && conv2=pk
  mkdir -p "$dir"
  local seeded="$FLAGS $COMMON --seed $seed"
  echo "=== train ($arm, seed $seed, $TRAIN_EP episodes) ==="
  python3 -c "$CLI" auto "$conv2" $seeded --training_episode "$TRAIN_EP" \
    --logging_directory "$runs/train" > "$dir/train.log" 2>&1 || rc=1
  tail -4 "$dir/train.log"
  local run snap
  run=$(ls -d "$runs"/train/*/ | tail -1)
  run=${run%/}
  snap="$run/models/snapshot"
  [ -f "$snap" ] || { echo "no snapshot in $run"; return 1; }
  echo "$snap" > "$dir/snapshot.txt"

  local testing="$seeded --is_testing --load_snapshot --snapshot_file $snap --testing_episode $TEST_EP"
  local pids=()
  timeout "$(left)" python3 -c "$CLI" auto "$conv2" $testing --obj_mesh_dir datasets/testing \
    --logging_directory "$runs/test" > "$dir/test.log" 2>&1 &
  pids+=("$!")
  timeout "$(left)" python3 -c "$CLI" off "$conv2" $testing --obj_mesh_dir datasets/testing \
    --logging_directory "$runs/test_off" > "$dir/test_off.log" 2>&1 &
  pids+=("$!")
  timeout "$(left)" python3 -c "$CLI" auto "$conv2" $testing --obj_mesh_dir datasets/training \
    --logging_directory "$runs/test_train" > "$dir/test_train.log" 2>&1 &
  pids+=("$!")
  timeout "$(left)" python3 stage_parity.py --snapshot "$snap" --arbitrate "$ARBITRATE" \
    --dump "$runs/dump" --out "$dir/stages.json" > "$dir/stages.log" 2>&1 &
  pids+=("$!")
  timeout "$(left)" bash run_port_checks.sh "$snap" "$dir" 224 > "$dir/checks.log" 2>&1 &
  pids+=("$!")
  for p in "${pids[@]}"; do
    wait "$p" || rc=1
  done

  local trees=() labels=()
  for t in train test test_off test_train; do
    local r
    r=$(ls -d "$runs/$t"/*/ 2>/dev/null | tail -1)
    [ -n "$r" ] || continue
    r=${r%/}
    mkdir -p "$dir/$t"
    cp -r "$r/info" "$r/transitions" "$dir/$t/"
    trees+=("$r")
    labels+=("port_${arm}_b32_s$seed-$t")
  done
  python3 scripts/analyze_results.py "${trees[@]}" \
    --labels "$(IFS=,; echo "${labels[*]}")" --out "$dir/RESULTS.md" \
    > "$dir/analyze.log" 2>&1 || rc=1
  cat "$dir/analyze.log"
  return $rc
}

pids=()
for word in $RUNS; do
  arm=${word%%:*}
  seed=${word#*:}
  case "$arm" in
    cold|pk) probe_run "$arm" "$seed" > "$OUT/${arm}_s$seed.log" 2>&1 & ;;
    *) echo "unknown arm $arm" >&2; exit 2 ;;
  esac
  pids+=("$!")
  echo "started $arm seed $seed (pid $!)"
done
rc=0
for p in "${pids[@]}"; do
  wait "$p" || rc=1
done

echo "=== the dump ==="
pick=$(python3 - "$OUT" <<'EOF'
import glob, json, os, sys
best = None
for path in glob.glob(os.path.join(sys.argv[1], "*_s*", "stages.json")):
    res = json.load(open(path))
    for s, r in res["styles"].items():
        if int(s) != res.get("dump", {}).get("style"):
            continue
        key = (int(s) in res["reproduced"], max(r["ratio"].values()))
        if best is None or key > best[0]:
            best = (key, res["dump"]["path"], res["source"])
if best:
    print(best[1], best[2])
EOF
)
if [ -n "$pick" ]; then
  set -- $pick
  echo "the dump: $1 (of $2)"
  mkdir -p "$OUT/dump"
  cp "$1" "$OUT/dump/" || rc=1
  echo "$2" > "$OUT/dump/snapshot.txt"
else
  echo "no stages.json: nothing to dump"
  rc=1
fi
for f in "$OUT"/*_s*.log; do
  echo "=== $f ==="
  tail -12 "$f"
done
echo "command seconds: $(($(date +%s) - T0))"
exit $rc
