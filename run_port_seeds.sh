#!/usr/bin/env bash
# Seeds of the port's two b32 arms side by side on one CUDA card: for each
# SEED, run_port_b32.sh (the cold arm) and run_port_warmstart.sh (the warm
# arm), all started together once the CUDA kernels and native/ are built.
# Both arms are host-bound (eager physics), so runs that share the card take
# little longer than one alone; their step times measure a shared card and
# are not the port's speed.
#
# Usage: bash run_port_seeds.sh OUT [ARMS] [SEEDS] [TRAIN_EP] [TEST_EP] [PRETRAIN_STEPS]
#
# ARMS is a list of "cold" and "warm" (default both), each run for every
# seed of SEEDS (default "1 2"), or of "arm:seed" words, each one run
# (SEEDS is then ignored for it: "warm:0 warm:2 cold:0"); the episode and
# step counts default to the held protocol's 800 / 300 / 1000. CHECK_SEEDS
# (default: every seed) lists the seeds whose runs go on to
# run_port_checks.sh on their snapshots. Each run writes OUT/<arm>_s<seed>/
# and its stdout to OUT/<arm>_s<seed>.log. The script exits nonzero if any
# run did.
set -u
cd "$(dirname "$0")"

OUT="$1"
ARMS="${2:-cold warm}"
SEEDS="${3:-1 2}"
TRAIN_EP="${4:-800}"
TEST_EP="${5:-300}"
STEPS="${6:-1000}"
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
python3 -c "
from smg_tpu_torch.ops import _build
from smg_tpu_torch.utils import native
_build.library()
assert native.load_library() is not None, 'native/ did not build'
" || exit 1

pids=()
for word in $ARMS; do
  arm=${word%%:*}
  seeds=$SEEDS
  [ "$word" != "$arm" ] && seeds=${word#*:}
  for seed in $seeds; do
    checks=0
    for c in ${CHECK_SEEDS:-$seed}; do
      [ "$c" = "$seed" ] && checks=1
    done
    export CHECKS=$checks
    case "$arm" in
      cold) bash run_port_b32.sh "$OUT/cold_s$seed" "$TRAIN_EP" "$TEST_EP" "$seed" \
              > "$OUT/cold_s$seed.log" 2>&1 & ;;
      warm) bash run_port_warmstart.sh "$OUT/warm_s$seed" "$TRAIN_EP" "$TEST_EP" \
              "$STEPS" "$seed" > "$OUT/warm_s$seed.log" 2>&1 & ;;
      *) echo "unknown arm $arm" >&2; exit 2 ;;
    esac
    pids+=("$!")
    echo "started $arm seed $seed (pid $!, checks $CHECKS)"
  done
done
rc=0
for p in "${pids[@]}"; do
  wait "$p" || rc=1
done
for f in "$OUT"/*_s*.log; do
  echo "=== $f ==="
  tail -4 "$f"
done
exit $rc
