#!/usr/bin/env bash
# The port's checks on a trained snapshot, on one CUDA card: decision
# parity (cli.decision_parity: the bf16 eval backends against the float32
# module forward) at each input size for each backend, then the bf16
# update's 'pk' / 'conv' / float32 gradient gaps at the snapshot's weights
# (chip_smoke.py --update_snapshot).
#
# Usage: bash run_port_checks.sh SNAPSHOT OUT [SIZES]
#
# SIZES defaults to "224 640". OUT receives parity_<size>_<backend>.json
# (and .err) and update_modes.log. A failed parity rule prints its exit
# code and does not fail the script; a failed update check does.
set -u
cd "$(dirname "$0")"

SNAP="$1"
OUT="$2"
SIZES="${3:-224 640}"
mkdir -p "$OUT"
rc=0

echo "=== decision parity on the snapshot ==="
for size in $SIZES; do
  for backend in xla_fl xla_pk pallas; do
    python3 -m smg_tpu_torch.cli.decision_parity --snapshot "$SNAP" \
      --input_size "$size" --backend "$backend" \
      > "$OUT/parity_${size}_${backend}.json" 2> "$OUT/parity_${size}_${backend}.err"
    echo "parity $size $backend: exit $?"
  done
done

echo "=== the update's modes at the trained weights ==="
python3 chip_smoke.py --update_snapshot "$SNAP" > "$OUT/update_modes.log" 2>&1 || rc=1
tail -3 "$OUT/update_modes.log"
exit $rc
